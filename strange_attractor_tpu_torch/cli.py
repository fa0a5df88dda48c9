"""Command-line interface of the PyTorch port: single frames and rotation
sequences, with the JAX package's flag names (strange_attractor_tpu/cli.py:
31-207) for what is ported.

    python -m strange_attractor_tpu_torch -i 100000000 -8 -b -0.25 -o out/frame

    python -m strange_attractor_tpu_torch --depth -i 100000000 -8 -o out/depth

    python -m strange_attractor_tpu_torch -i 10000000 -8 --seed 1 -o out/rot \
        sequence -s 0 -e 360 -d 3 --frames-per-batch 60 --orbit shared

Path: render -> colorize -> convert on the device -> one host copy (per
frame, or per batch of a batched sequence) -> write, sequence frames on up
to four encoder threads. ``completion`` and ``doctor`` exit with a "not
yet ported" error; the JAX package (``python -m strange_attractor_tpu``)
has them.
"""

from __future__ import annotations

import argparse
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from pathlib import Path

import numpy as np

from .config import BinStrategy, BrightnessConstants, Colors, RenderKind
from .models import presets

_NOT_PORTED = ("completion", "doctor")
# encoder threads of a sequence (the reference spawns one per frame,
# src/bin/main.rs:507-511; a bound keeps the frames in flight few)
ENCODERS = 4


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m strange_attractor_tpu_torch",
        description="Strange-attractor renderer, PyTorch/CUDA port.",
        add_help=False,
    )
    p.add_argument("--help", action="help", help="Print help")
    p.add_argument("--depth", action="store_true", help="output depth information")
    p.add_argument("-8", "--8-bit", dest="eight_bit", action="store_true",
                   help="Write image in an 8-bit format")
    p.add_argument("-t", "--transparent", action="store_true",
                   help="Add transparency to the image")
    p.add_argument("-i", "--iterations", type=int, default=10_000_000,
                   help="Number of iterations")
    p.add_argument("-w", "--width", type=int, default=1920, help="Width of image")
    p.add_argument("-h", "--height", type=int, default=1080, help="Height of image")
    p.add_argument("-s", "--scale", type=float, default=None,
                   help="Image zoom (default: the preset's own scale)")
    p.add_argument("-p", "--preset", choices=list(presets.PRESET_NAMES),
                   default="poisson-saturne", help="Which built-in attractor to render")
    p.add_argument("--pam", "--pnm", "--pbm", dest="pam", action="store_true",
                   help="Use PAM format. 16-bit images are not supported.")
    p.add_argument("--bmp", "--bitmap", dest="bmp", action="store_true",
                   help="Use BMP format. 16-bit images are not supported.")
    p.add_argument("-o", "--file-name", dest="name", default="attractor",
                   help="Write to file name")
    p.add_argument("-q", "--silent", action="store_true", help="Decrease verbosity")
    p.add_argument("-a", "--angle", type=float, default=0.0,
                   help="Angle to view attractor from (degrees)")
    p.add_argument("-b", "--brightness-offset", dest="brightness_offset", type=float,
                   default=-0.15,
                   help="Offset the brightness. You generally want to decrease this if "
                        "you have > 1e8 iterations.")
    p.add_argument("--lanes", type=int, default=None,
                   help="Parallel trajectory lanes (default: auto from iterations)")
    p.add_argument("--chunk-steps", type=int, default=None,
                   help="Map steps per binning flush (default: auto)")
    p.add_argument("--bin-strategy", choices=[s.value for s in BinStrategy], default="auto",
                   help="Canvas accumulation strategy. 'auto' picks 'kernel' for Gas and "
                        "'depth-kernel' for --depth renders; kernel/packed quantize depth "
                        "to ~2^-11 relative and the palette position to 1/4096, "
                        "'exact-kernel' keeps full float32 with the reference's strict "
                        "z-test, 'exact16-kernel' the same discipline at 16-bit z "
                        "granularity. The *-kernel strategies run the CUDA kernels; "
                        "'packed', 'depth' and 'exact' their plain PyTorch twins.")
    p.add_argument("--exact16-ties", dest="exact16_ties", choices=["value", "earliest"],
                   default="value",
                   help="exact16-kernel bucket-tie rule: 'value' (smallest f16 value of "
                        "the top z bucket) or 'earliest' (first-emitted point)")
    p.add_argument("--seed", type=int, default=None, help="Deterministic RNG seed")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda; 'cpu' runs the "
                        "plain PyTorch twins of the kernels)")
    sub = p.add_subparsers(dest="subcommand")
    seq = sub.add_parser(
        "sequence",
        help="Render a sequence of frames rotating around the attractor.",
        description="Render a sequence of frames rotating around the attractor.\n"
        "All the arguments passed before this subcommand are used when creating the images.",
        add_help=False,
    )
    seq.add_argument("--help", action="help", help="Print help")
    seq.add_argument("-s", "--start", type=float, default=0.0,
                     help="The angle to start the animation from (degrees)")
    seq.add_argument("-e", "--end", type=float, default=360.0,
                     help="The angle to end the animation at (degrees)")
    seq.add_argument("-d", "--step", type=float, default=0.5,
                     help="Amount to change the angle for each frame (degrees)")
    seq.add_argument("--frames-per-batch", dest="frames_per_batch", type=int, default=0,
                     help="Render this many frames per batch before one copy to the host "
                          "(0 = one frame at a time)")
    seq.add_argument("--orbit", choices=["per-frame", "shared"], default="per-frame",
                     help="'per-frame' (default) draws fresh trajectory samples for every "
                          "frame like the reference; 'shared' bins one orbit per batch: "
                          "sampling noise moves with the camera instead of re-rolling per "
                          "frame, each frame is bit-identical to a single render of that "
                          "orbit, and the warm-up and map run once per batch instead of "
                          "once per frame. Needs --frames-per-batch > 0.")
    seq.add_argument("--apng", action="store_true",
                     help="Write the whole sequence as one animated PNG ('<name>.apng') "
                          "instead of per-frame files")
    seq.add_argument("--fps", type=float, default=30.0, help="Playback rate for --apng")
    for name in _NOT_PORTED:
        sub.add_parser(name, add_help=False)
    # the "-8" short flag makes argparse refuse bare negative values like
    # ``-b -0.25``; "-8" itself still wins by exact option match
    p._has_negative_number_optionals.clear()  # noqa: SLF001
    seq._has_negative_number_optionals.clear()  # noqa: SLF001
    return p


def _validate(args, parser):
    if args.subcommand in _NOT_PORTED:
        parser.error(f"'{args.subcommand}' is not yet ported to the PyTorch package; "
                     f"run it with python -m strange_attractor_tpu")
    if args.subcommand == "sequence":
        # the reference's InvalidValue errors (main.rs:375-378)
        if args.end <= args.start:
            parser.error("sequence end must be after start")
        if args.step <= 0:
            parser.error("step must be a positive")
        if args.orbit == "shared" and args.frames_per_batch <= 0:
            parser.error("--orbit shared renders whole batches from one orbit; "
                         "pass --frames-per-batch > 0")
    # a depth-only accumulation cannot be colorized as a Gas render, and a
    # PACKED one keeps no z-buffer plane for a depth render
    if args.bin_strategy in ("depth", "depth-kernel") and not args.depth:
        parser.error(f"--bin-strategy {args.bin_strategy} requires --depth "
                     "(it accumulates only the z-buffer)")
    if args.depth and args.bin_strategy in ("packed", "kernel"):
        parser.error(f"--bin-strategy {args.bin_strategy} cannot serve --depth (it "
                     "accumulates no z-buffer plane); use auto, depth, depth-kernel, or "
                     "a fidelity mode")
    if (args.pam or args.bmp) and not args.eight_bit:
        parser.error("--pam/--bmp require --8-bit (16-bit images are not supported)")
    if args.pam and args.bmp:
        parser.error("--pam conflicts with --bmp")


def config_from_args(args):
    """Build a Config from CLI flags over the preset (main.rs:417-442)."""
    config = presets.by_name(args.preset)
    config = config.replace(
        iterations=args.iterations,
        width=args.width,
        height=args.height,
        transparent=args.transparent,
        silent=args.silent,
        colors=Colors(palette=config.colors.palette,
                      brightness=BrightnessConstants(offset=args.brightness_offset)),
        angle=float(np.radians(args.angle)),
        lanes=args.lanes,
        chunk_steps=args.chunk_steps,
        seed=args.seed,
        render=RenderKind.DEPTH if args.depth else RenderKind.GAS,
        bin_strategy=BinStrategy(args.bin_strategy),
        exact16_ties=args.exact16_ties,
    )
    if args.scale is not None:
        config = config.replace(view=config.view.replace(scale=args.scale))
    return config


def _output_base(args) -> Path:
    """Output path stem handling (main.rs:445-457)."""
    path = Path(args.name)
    return path.parent / path.stem if path.stem else path.parent / "attractor"


def _write_frames(frames, write) -> None:
    """Encode ``(image, path)`` pairs on at most :data:`ENCODERS` threads,
    so the next frame renders while earlier ones encode; the frames waiting
    on an encoder stay few. A failed write raises after every encoder has
    finished (the JAX CLI's ``write_async``, strange_attractor_tpu/cli.py:
    407-430)."""
    futures, pending = [], set()
    with ThreadPoolExecutor(max_workers=ENCODERS) as pool:
        for image, path in frames:
            while len(pending) >= ENCODERS:
                pending = wait(pending, return_when=FIRST_COMPLETED).not_done
            fut = pool.submit(write, path, image)
            futures.append(fut)
            pending.add(fut)
    for fut in futures:
        fut.result()


def _strip_suffix(p: Path) -> Path:
    """Drop a filename extension so write_image's with_suffix can add the
    format's own (sequence frame names may carry one from -o)."""
    return p.parent / p.stem if p.suffix else p


def _sequence(args, config, fmt: str) -> None:
    """The ``sequence`` subcommand (strange_attractor_tpu/cli.py:432-511):
    frames named like the reference's (utils.sequencing), or one APNG."""
    from .render import render_sequence, render_sequence_batched, render_sequence_shared
    from .utils.export import convert_format, write_apng, write_image
    from .utils.sequencing import frame_sequence

    frames = list(frame_sequence(args.start, args.end, args.step, _output_base(args)))
    if args.frames_per_batch > 0:
        engine = render_sequence_shared if args.orbit == "shared" else render_sequence_batched
        images = engine(config, [a for a, _ in frames], args.frames_per_batch,
                        args.transparent, args.eight_bit, device=args.device)
    else:
        images = (img for _, img in render_sequence(config, args.start, args.end, args.step,
                                                     device=args.device))
    if args.apng:
        stack = np.stack([convert_format(im, args.transparent, args.eight_bit) for im in images])
        out = write_apng(_output_base(args).with_suffix(".apng"), stack, fps=args.fps)
        print(f"Wrote animation to '{out}'.")
        return

    def write(path, image):
        write_image(_strip_suffix(path), image, fmt=fmt, transparent=args.transparent,
                    eight_bit=args.eight_bit, silent=config.silent)

    _write_frames(zip(images, (path for _, path in frames)), write)


def main(argv=None) -> int:
    from .render import colorize, render
    from .utils.export import convert_format_device, to_host, write_image

    parser = build_parser()
    # an unported subcommand's own flags must not hide the "not yet ported" error
    args, extra = parser.parse_known_args(argv)
    if extra and args.subcommand not in _NOT_PORTED:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    _validate(args, parser)
    config = config_from_args(args)
    fmt = "pam" if args.pam else "bmp" if args.bmp else "png"
    if args.subcommand == "sequence":
        _sequence(args, config, fmt)
        return 0
    state = render(config, device=args.device)
    image = convert_format_device(colorize(config, state), args.transparent, args.eight_bit)
    write_image(_output_base(args), to_host(image), fmt=fmt, transparent=args.transparent,
                eight_bit=args.eight_bit, silent=config.silent)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
