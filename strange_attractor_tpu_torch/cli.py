"""Command-line interface of the PyTorch port: single frames and rotation
sequences, with the JAX package's flag names (strange_attractor_tpu/cli.py:
31-207) for what is ported.

    python -m strange_attractor_tpu_torch -i 100000000 -8 -b -0.25 -o out/frame

    python -m strange_attractor_tpu_torch --depth -i 100000000 -8 -o out/depth

    python -m strange_attractor_tpu_torch -i 10000000 -8 --seed 1 -o out/rot \
        sequence -s 0 -e 360 -d 3 --frames-per-batch 60 --orbit shared

    torchrun --nproc-per-node 2 -m strange_attractor_tpu_torch --distributed \
        -i 1000000000 -8 -o out/frame

Path: render -> colorize -> convert on the device -> one host copy (per
frame, or per batch of a batched sequence) -> write, sequence frames on up
to four encoder threads. A single frame can resume from and checkpoint its
accumulation (``--load-state``, ``--save-state``) and write previews while
it renders (``--preview-every``). Several devices: by default a frame's
lanes split over every visible card (``parallel.mesh``; ``--single-device``
or ``--device cuda:N`` keeps one), and ``--distributed`` (or
``--coordinator HOST:PORT --num-processes N --process-id I``) splits them
over processes (``parallel.distributed``), of which only the first writes
files. ``--profile DIR`` records a ``torch.profiler`` trace of the render
and its delivery into DIR, with the port's spans (``utils.profiling.span``)
on its clock, the encoder threads' among them.

    python -m strange_attractor_tpu_torch doctor            # the install, on the card
    python -m strange_attractor_tpu_torch completion --shell zsh --install

Installed (``pip install .``), the console script
``strange-attractor-renderer-torch`` runs the same CLI; completion scripts
are keyed on that name.
"""

from __future__ import annotations

import argparse
import contextlib
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from pathlib import Path

import numpy as np

from .config import BinStrategy, BrightnessConstants, Colors, Palette, RenderKind
from .models import presets
from .models.attractors import PolynomialSprott2Degree
from .ops.projection import EulerAxisRotation

# the console script (pyproject.toml [project.scripts]); completion
# scripts are keyed on it, so it must be one word
PROG = "strange-attractor-renderer-torch"
# encoder threads of a sequence (the reference spawns one per frame,
# src/bin/main.rs:507-511; a bound keeps the frames in flight few)
ENCODERS = 4


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
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
    p.add_argument("--single-device", "--single-thread", dest="single_device",
                   action="store_true", help="Run on a single device")
    p.add_argument("--distributed", action="store_true",
                   help="Multi-process rendering: bring up torch.distributed before "
                        "touching devices (torchrun's env:// variables; launch the same "
                        "command once per process). Only the primary process writes "
                        "output files.")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="Explicit torch.distributed coordinator address (implies "
                        "--distributed; also pass --num-processes/--process-id)")
    p.add_argument("--num-processes", dest="num_processes", type=int, default=None,
                   help="Total process count for --coordinator bring-up")
    p.add_argument("--process-id", dest="process_id", type=int, default=None,
                   help="This process's index for --coordinator bring-up")
    p.add_argument("-q", "--silent", action="store_true", help="Decrease verbosity")
    p.add_argument("-j", "--jobs-per-thread", dest="jobs_per_thread", type=int, default=None,
                   help="Accepted for reference-CLI compatibility; the lanes split evenly "
                        "over the devices, so this has no effect. Use "
                        "--lanes/--chunk-steps to tune instead. Conflicts with "
                        "--single-device, like the reference (main.rs:297-306). "
                        "(default: 12)")
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
    p.add_argument("--reseed-lanes", dest="reseed_lanes", action="store_true",
                   help="Resurrect trajectory lanes whose orbit escaped to infinity "
                        "(more samples/sec for escaping coefficient sets like "
                        "solar-sail; off replicates the reference's behavior)")
    p.add_argument("--save-state", default=None, metavar="PATH",
                   help="Checkpoint the accumulator state to PATH (.npz) after rendering")
    p.add_argument("--load-state", default=None, metavar="PATH",
                   help="Resume accumulation from a checkpointed state (.npz)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Write a torch.profiler trace (Chrome trace JSON) of the render "
                        "and its delivery to DIR")
    p.add_argument("--preview-every", dest="preview_every", type=float, default=0.0,
                   metavar="SECONDS",
                   help="During long renders, write a '<name>-preview' image at this "
                        "interval showing the ever-improving accumulation")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda, every visible card, "
                        "the lanes split over them; 'cuda:N' one card; 'cpu' runs the "
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
    doc = sub.add_parser("doctor", help="Run environment self-checks (torch, the card, the "
                         "kernel build, correctness vs the numpy oracle, throughput) on "
                         "--device", add_help=False)
    doc.add_argument("--help", action="help", help="Print help")
    comp = sub.add_parser("completion", help="Generate a shell completion script",
                          add_help=False)
    comp.add_argument("--help", action="help", help="Print help")
    comp.add_argument("--shell", choices=["bash", "zsh", "fish"], default="bash")
    comp.add_argument("--print", dest="print_only", action="store_true", default=True,
                      help="Print the script to stdout (default)")
    comp.add_argument("--install", action="store_true",
                      help="Write the script to the per-user completion dir "
                           "(no root needed, unlike the reference's system-dir "
                           "install)")
    # the "-8" short flag makes argparse refuse bare negative values like
    # ``-b -0.25``; "-8" itself still wins by exact option match
    p._has_negative_number_optionals.clear()  # noqa: SLF001
    seq._has_negative_number_optionals.clear()  # noqa: SLF001
    return p


def _validate(args, parser):
    # the reference's clap conflicts_with (main.rs:297-306): only an
    # explicitly passed -j conflicts, hence the None default for 12
    if args.jobs_per_thread is not None and args.single_device:
        parser.error("-j/--jobs-per-thread conflicts with --single-device")
    if args.jobs_per_thread is not None and args.jobs_per_thread < 1:
        parser.error("-j/--jobs-per-thread must be a positive integer "
                     "(the reference parses NonZeroUsize)")
    if args.jobs_per_thread is None:
        args.jobs_per_thread = 12
    if args.coordinator and (args.num_processes is None or args.process_id is None):
        parser.error("--coordinator requires --num-processes and --process-id")
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
        reseed_lanes=args.reseed_lanes,
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
    407-430). Under a profiler each write records its spans on its
    encoder thread, with the caller's innermost span as their parent
    (:func:`utils.profiling.carried`)."""
    from .utils.profiling import carried

    write = carried(write)
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


def render_devices(args) -> list:
    """The devices the CLI renders over: this rank's device under
    ``--distributed``; every visible card for ``--device cuda`` (the
    default); else the one device ``--device`` names, or with
    ``--single-device``. The JAX CLI renders over ``jax.devices()``."""
    import torch

    if args.distributed:
        from .parallel import distributed as dist

        return [dist.device()]
    device = torch.device(args.device)
    if args.single_device or device.type != "cuda" or device.index is not None:
        return [device]
    from .parallel.mesh import resolve_devices

    return resolve_devices()


def _is_primary(args) -> bool:
    """Under ``--distributed`` only process 0 writes files (the processes
    may share a filesystem; JAX CLI strange_attractor_tpu/cli.py:396-400)."""
    if not args.distributed:
        return True
    from .parallel import distributed as dist

    return dist.is_primary()


def _sharded_frames(args, config, devices, angles):
    """One-frame-at-a-time sequence frames over several devices or ranks:
    frame ``i`` renders with :func:`render.frame_generator` ``(config, i)``
    (the JAX CLI's ``_render_one`` over the mesh, cli.py:536-545)."""
    from .parallel import distributed as dist
    from .parallel.mesh import render_sharded
    from .render import _fetch, _sequence_base, colorize, frame_generator

    base = _sequence_base(config)
    for i, angle in enumerate(angles):
        cfg = config.replace(angle=float(np.radians(angle)))
        gen = frame_generator(config, i, base)
        state = dist.render_distributed(cfg, gen) if args.distributed else \
            render_sharded(cfg, devices, gen)
        yield _fetch(colorize(cfg, state))


def _sequence(args, config, fmt: str) -> None:
    """The ``sequence`` subcommand (strange_attractor_tpu/cli.py:432-511):
    frames named like the reference's (utils.sequencing), or one APNG.
    Several devices (or ranks) take the frames x lanes grid with
    ``--frames-per-batch`` and split each frame's lanes without it."""
    from .render import render_sequence, render_sequence_batched, render_sequence_shared
    from .utils.export import convert_format, write_apng, write_image
    from .utils.sequencing import frame_sequence

    frames = list(frame_sequence(args.start, args.end, args.step, _output_base(args)))
    angles = [a for a, _ in frames]
    devices = render_devices(args)
    sharded = args.distributed or len(devices) > 1
    if args.frames_per_batch > 0 and sharded:
        from .parallel.mesh import render_sequence_sharded

        group = None
        if args.distributed:
            import torch.distributed

            group = torch.distributed.group.WORLD
        images = render_sequence_sharded(config, angles, devices, transparent=args.transparent,
                                         eight_bit=args.eight_bit,
                                         frames_per_batch=args.frames_per_batch,
                                         orbit=args.orbit, group=group)
    elif args.frames_per_batch > 0:
        engine = render_sequence_shared if args.orbit == "shared" else render_sequence_batched
        images = engine(config, angles, frames_per_batch=args.frames_per_batch,
                        transparent=args.transparent, eight_bit=args.eight_bit,
                        device=devices[0])
    elif sharded:
        images = _sharded_frames(args, config, devices, angles)
    else:
        images = (img for _, img in render_sequence(config, args.start, args.end, args.step,
                                                     device=devices[0]))
    primary = _is_primary(args)
    if args.apng:
        stack = np.stack([convert_format(im, args.transparent, args.eight_bit) for im in images])
        if primary:
            out = write_apng(_output_base(args).with_suffix(".apng"), stack, fps=args.fps)
            print(f"Wrote animation to '{out}'.")
        return

    def write(path, image):
        if primary:
            write_image(_strip_suffix(path), image, fmt=fmt, transparent=args.transparent,
                        eight_bit=args.eight_bit, silent=config.silent)

    _write_frames(zip(images, (path for _, path in frames)), write)


def _render_stateful(args, config, fmt: str):
    """One frame's render, resumed from ``--load-state`` and calling back
    for ``--preview-every`` (the JAX CLI's ``_render_stateful``,
    strange_attractor_tpu/cli.py:554-600), over several devices or ranks
    when there are: returns (host image, state). Every rank runs the
    callback's merges; only the primary writes previews."""
    from .render import colorize_convert_fetch, render
    from .runtime import load_state
    from .utils.export import write_image

    devices = render_devices(args)
    state = load_state(args.load_state, device=devices[0]) if args.load_state else None
    on_progress = None
    if args.preview_every > 0:
        base, last, primary = _output_base(args), [time.perf_counter()], _is_primary(args)

        def on_progress(done, total, partial):
            now = time.perf_counter()
            if now - last[0] < args.preview_every or not primary:
                return
            last[0] = now
            # no dot in the stem: with_suffix would take ".preview" for an
            # extension and overwrite the final image
            write_image(base.parent / (base.name + "-preview"),
                        colorize_convert_fetch(config, partial,
                                               transparent=args.transparent,
                                               eight_bit=args.eight_bit), fmt=fmt,
                        transparent=args.transparent, eight_bit=args.eight_bit, silent=True,
                        announce=False)

    if args.distributed:
        from .parallel import distributed as dist

        state = dist.render_distributed(config, state=state, on_progress=on_progress)
    elif len(devices) > 1:
        from .parallel.mesh import render_sharded

        state = render_sharded(config, devices, state=state, on_progress=on_progress)
    else:
        state = render(config, state, on_progress=on_progress, device=devices[0])
    return colorize_convert_fetch(config, state, transparent=args.transparent,
                                  eight_bit=args.eight_bit), state


def _completion(args, parser) -> int:
    """The ``completion`` subcommand (strange_attractor_tpu/cli.py:348-358)."""
    import sys

    from .utils.completion import completion_script, install_completion

    if args.install:
        path = install_completion(args.shell, parser)
        print(f"Installed {args.shell} completion to '{path}'.")
        if args.shell == "zsh":
            print(f"Ensure '{path.parent}' is on your fpath before compinit.")
    else:
        sys.stdout.write(completion_script(args.shell, parser))
    return 0


def _single_frame(args, config, fmt: str) -> None:
    from .runtime import save_state
    from .utils.export import write_image

    image, state = _render_stateful(args, config, fmt)
    if not _is_primary(args):
        return
    if args.save_state:
        save_state(args.save_state, state)
        if not config.silent:
            print(f"Saved render state to '{args.save_state}'.")
    write_image(_output_base(args), image, fmt=fmt, transparent=args.transparent,
                eight_bit=args.eight_bit, silent=config.silent)


def doctor(device="cuda") -> int:
    """Environment self-check on ``device``: torch and CUDA, the card, nvcc
    and the kernel library, the PNG encoder, agreement with the numpy
    oracle, and throughput (the JAX CLI's ``doctor``,
    strange_attractor_tpu/cli.py:612-672). Returns 0 when every check
    passed, else 1.

    On a CUDA device the oracle check runs the kernels: kernel A in EXACT
    emission with the tile bin (EXACT_KERNEL), then in PACKED emission with
    ``bin_packed`` (KERNEL), each count plane held to
    :func:`oracle.oracle_render` of the same seeds on the visited pixels,
    with the JAX doctor's 98% bar (a smoke threshold; the bit-exactness
    gates are the CPU tests and ``chip_smoke.py``). Without CUDA, a CUDA
    ``device`` is a problem: nothing runs on the CPU instead. With
    ``device="cpu"`` the same checks run the plain twins, and the kernels
    are not checked.
    """
    import torch

    from .models import presets
    from .oracle import oracle_render
    from .render import colorize, plan_schedule, render, render_seeds, seed_generator, \
        seeds_and_key
    from .utils.export import to_host
    from .utils.native import encoder
    from .utils.profiling import RenderProfile, sync

    def problem(text: str) -> int:
        print(f"  PROBLEM: {text}")
        print("doctor: PROBLEMS FOUND")
        return 1

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda or 'none (CPU build)'}")
    device = torch.device(device)
    print(f"device: {device}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            return problem(f"--device {device} needs a CUDA card, and torch.cuda is not "
                           "available; pass --device cpu to check the plain twins")
        print(f"card: {torch.cuda.get_device_name(device)}, compute capability "
              f"{'.'.join(map(str, torch.cuda.get_device_capability(device)))}")
        from .ops import cuda_lib

        try:
            print(f"nvcc: {cuda_lib._nvcc()}")  # noqa: SLF001
            cuda_lib.library()
        except (RuntimeError, OSError) as e:
            return problem(f"the CUDA kernels did not build or load: {e}")
        print(f"kernel library: {cuda_lib.library_path()}")
    else:
        print("the plain twins run on the CPU; the CUDA kernels are not checked")
    print(f"PNG encoder: {encoder()}")

    ok = True
    for strategy in (BinStrategy.EXACT_KERNEL, BinStrategy.KERNEL):
        cfg = presets.poisson_saturne(width=64, height=36, lanes=4, chunk_steps=16,
                                      iterations=4 * 16 * 2, warmup=100, seed=7,
                                      bin_strategy=strategy)
        _, chunk, nchunks = plan_schedule(cfg)
        seeds, _ = seeds_and_key(cfg, seed_generator(cfg))
        count = render_seeds(cfg, seeds.to(device)).count.cpu().numpy().view(np.uint32)
        oc, _, _ = oracle_render(cfg, seeds.numpy(), steps_per_lane=chunk * nchunks)
        # agreement on *visited* pixels: on a mostly empty canvas the
        # all-pixel figure mostly says that zeros equal zeros
        visited = (count > 0) | (oc > 0)
        eq = count == oc
        agree = eq[visited].mean() if visited.any() else 1.0
        print(f"oracle agreement ({strategy.value}, short-horizon exact): {agree:.4%} on "
              f"{int(visited.sum())} visited px ({eq.mean():.4%} incl. empty)")
        if agree < 0.98:
            print("  PROBLEM: device arithmetic diverges from the oracle")
            ok = False

    bench = presets.poisson_saturne(iterations=2_000_000, width=192, height=108, seed=0)
    lanes, chunk, nchunks = plan_schedule(bench)
    sync(render(bench, device=device).count)  # warm
    prof = RenderProfile(iterations=lanes * chunk * nchunks)
    with prof.phase("render"):
        state = render(bench, device=device)
        sync(state.count)
    with prof.phase("colorize"):
        to_host(colorize(bench, state))
    print(f"throughput: {prof.summary()}")
    print("doctor: OK" if ok else "doctor: PROBLEMS FOUND")
    return 0 if ok else 1


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    _validate(args, parser)
    if args.subcommand == "completion":
        return _completion(args, parser)
    if args.subcommand == "doctor":
        return doctor(args.device)
    if args.distributed or args.coordinator:
        # the process group comes up before anything touches a device
        from .parallel import distributed as dist

        args.distributed = True
        dist.initialize(args.coordinator, args.num_processes, args.process_id,
                        device=None if args.device == "cuda" else args.device)
        if not dist.is_primary():
            # every rank runs the collectives; only the primary speaks and writes
            args.silent = True
    config = config_from_args(args)
    fmt = "pam" if args.pam else "bmp" if args.bmp else "png"
    profile = contextlib.nullcontext()
    if args.profile:
        from .utils.profiling import trace

        profile = trace(args.profile)
    # the trace covers the render and the delivery, encoders included, and
    # is written however the block ends
    with profile:
        if args.subcommand == "sequence":
            _sequence(args, config, fmt)
        else:
            _single_frame(args, config, fmt)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
