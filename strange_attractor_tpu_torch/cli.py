"""Command-line interface of the PyTorch port: single frames and rotation
sequences, with the JAX package's flag names (strange_attractor_tpu/cli.py:
31-207) for what is ported.

    python -m strange_attractor_tpu_torch -i 100000000 -8 -b -0.25 -o out/frame

    python -m strange_attractor_tpu_torch --depth -i 100000000 -8 -o out/depth

    python -m strange_attractor_tpu_torch -i 10000000 -8 --seed 1 -o out/rot \
        sequence -s 0 -e 360 -d 3 --frames-per-batch 60 --orbit shared

Path: render -> colorize -> convert on the device -> one host copy (per
frame, or per batch of a batched sequence) -> write, sequence frames on up
to four encoder threads. A single frame can resume from and checkpoint its
accumulation (``--load-state``, ``--save-state``) and write previews while
it renders (``--preview-every``). ``completion`` and ``doctor`` exit with a "not
yet ported" error; the JAX package (``python -m strange_attractor_tpu``)
has them.
"""

from __future__ import annotations

import argparse
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from pathlib import Path

import numpy as np

from .config import BinStrategy, BrightnessConstants, Colors, Palette, RenderKind
from .models import presets
from .models.attractors import PolynomialSprott2Degree
from .ops.projection import EulerAxisRotation

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
    # a custom polynomial Sprott map: each row takes the 10 coefficients of
    # [1, x, x^2, xy, xz, y, y^2, yz, z, z^2]
    p.add_argument("--coeffs-x", dest="coeffs_x", type=float, nargs=10, default=None,
                   metavar="C", help="Custom attractor: 10 x-row coefficients")
    p.add_argument("--coeffs-y", dest="coeffs_y", type=float, nargs=10, default=None,
                   metavar="C", help="Custom attractor: 10 y-row coefficients")
    p.add_argument("--coeffs-z", dest="coeffs_z", type=float, nargs=10, default=None,
                   metavar="C", help="Custom attractor: 10 z-row coefficients")
    p.add_argument("--camera", type=float, nargs=3, default=None, metavar="V",
                   help="Custom attractor: center_camera x y z (default: preset's)")
    p.add_argument("--rotation-axis", dest="rotation_axis", type=float, nargs=4,
                   default=None, metavar="V",
                   help="Custom attractor: rotation axis x y z + angle (radians)")
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
    p.add_argument("--palette", default=None, metavar="STOPS",
                   help="Custom palette: semicolon-separated r,g,b stops in [0,1], "
                        "e.g. '1,1,.5;.5,1,.5;1,.5,.5' (default: the reference's "
                        "6-stop table; interpolation clamps + sqrt per channel)")
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
    p.add_argument("--save-state", default=None, metavar="PATH",
                   help="Checkpoint the accumulator state to PATH (.npz) after rendering")
    p.add_argument("--load-state", default=None, metavar="PATH",
                   help="Resume accumulation from a checkpointed state (.npz)")
    p.add_argument("--preview-every", dest="preview_every", type=float, default=0.0,
                   metavar="SECONDS",
                   help="During long renders, write a '<name>-preview' image at this "
                        "interval showing the ever-improving accumulation")
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
    args.palette_stops = None
    if args.palette:
        try:
            stops = [[float(c) for c in stop.split(",")]
                     for stop in args.palette.split(";") if stop.strip()]
            args.palette_stops = Palette(stops)  # checks the shape and that it is not empty
        except (ValueError, TypeError) as e:
            parser.error(f"--palette: {e}")
        if any(not 0.0 <= c <= 1.0 for stop in stops for c in stop):
            # out-of-range stops reach sqrt(negative) in the palette lerp
            parser.error("--palette: components must be in [0, 1]")


def config_from_args(args):
    """Build a Config from CLI flags over the preset (main.rs:417-442)."""
    config = presets.by_name(args.preset)
    config = config.replace(
        iterations=args.iterations,
        width=args.width,
        height=args.height,
        transparent=args.transparent,
        silent=args.silent,
        colors=Colors(palette=args.palette_stops or config.colors.palette,
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
    # a custom map: rows not given come from the preset's Sprott map, or are
    # zero over an RK4 preset
    rows = (args.coeffs_x, args.coeffs_y, args.coeffs_z)
    if any(r is not None for r in rows):
        base = config.attractor
        if not isinstance(base, PolynomialSprott2Degree):
            base = PolynomialSprott2Degree(x=(0,) * 10, y=(0,) * 10, z=(0,) * 10)
        config = config.replace(attractor=PolynomialSprott2Degree(
            *(tuple(r) if r else b for r, b in zip(rows, (base.x, base.y, base.z)))))
    if args.camera is not None:
        config = config.replace(view=config.view.replace(center_camera=tuple(args.camera)))
    if args.rotation_axis is not None:
        ax = args.rotation_axis
        config = config.replace(view=config.view.replace(
            rotation=EulerAxisRotation(axis=(ax[0], ax[1], ax[2]), rotation=ax[3])))
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


def _deliverable(args, config, state) -> np.ndarray:
    """colorize -> (transparent, 8-bit) conversion on the device -> one
    host copy."""
    from .render import colorize
    from .utils.export import convert_format_device, to_host

    return to_host(convert_format_device(colorize(config, state), args.transparent,
                                         args.eight_bit))


def _render_stateful(args, config, fmt: str):
    """One frame's render, resumed from ``--load-state`` and calling back
    for ``--preview-every`` (the JAX CLI's ``_render_stateful``,
    strange_attractor_tpu/cli.py:554-600): returns (host image, state)."""
    from .render import render
    from .runtime import load_state
    from .utils.export import write_image

    state = load_state(args.load_state, device=args.device) if args.load_state else None
    on_progress = None
    if args.preview_every > 0:
        base, last = _output_base(args), [time.perf_counter()]

        def on_progress(done, total, partial):
            now = time.perf_counter()
            if now - last[0] < args.preview_every:
                return
            last[0] = now
            # no dot in the stem: with_suffix would take ".preview" for an
            # extension and overwrite the final image
            write_image(base.parent / (base.name + "-preview"),
                        _deliverable(args, config, partial), fmt=fmt,
                        transparent=args.transparent, eight_bit=args.eight_bit, silent=True,
                        announce=False)

    state = render(config, state, on_progress=on_progress, device=args.device)
    return _deliverable(args, config, state), state


def main(argv=None) -> int:
    from .runtime import save_state
    from .utils.export import write_image

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
    image, state = _render_stateful(args, config, fmt)
    if args.save_state:
        save_state(args.save_state, state)
        if not config.silent:
            print(f"Saved render state to '{args.save_state}'.")
    write_image(_output_base(args), image, fmt=fmt, transparent=args.transparent,
                eight_bit=args.eight_bit, silent=config.silent)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
