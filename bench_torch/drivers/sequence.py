"""Rotation sequences: one user in a closed loop renders whole camera
rotations back to back through the CLI's batched ``sequence`` path
(``cli._sequence`` with ``--frames-per-batch``): the engine of the mix's
``--orbit`` (``render.render_sequence_shared`` or
``render.render_sequence_batched``) returns every frame on the host, then
``cli._write_frames`` writes them with ``utils.export.write_image`` on the
CLI's encoder threads. Spans: ``engine`` (returns a host array, so the
device work is done) and ``write``. Sequence ``k`` renders with the CLI's
``--seed`` taken from the run's seed and ``k``. A sequence's files are
deleted once it is written, unless the check keeps it.

The check renders every frame of the kept sequences with the plain
reference at the timed sizes, the orbit shared by a batch's frames as the
engine shares it, and compares each delivered 8-bit image (kernel A's
orbit, kernel P's projection of it at the frame's angle, the bin, kernel T)
and each file read back (the encoder), pixel for pixel, limit 0.
"""

from __future__ import annotations

import contextlib
import dataclasses
import shutil
import time

import numpy as np
import torch

from bench_torch import images, reference
from bench_torch.harness import Sample, item_seed, output_format, program

SPANS = ("engine", "write")
LIMITS = {"image_px_off": 0, "file_px_off": 0}


@dataclasses.dataclass
class Session:
    ctx: object
    config: object
    args: object
    fmt: str
    angles: list  # degrees, as the CLI's frame_sequence gives them
    info: dict
    sample: Sample


def plan(ctx) -> Session:
    cli, render = program("cli"), program("render")
    from strange_attractor_tpu_torch.utils.sequencing import angle_iter

    args = ctx.parse_args()
    if args.subcommand != "sequence" or args.frames_per_batch <= 0:
        raise ValueError("the sequence driver runs `sequence --frames-per-batch N` (N > 0)")
    config = cli.config_from_args(args)
    angles = list(angle_iter(args.start, args.end, args.step))
    lanes, chunk_steps, nchunks = render.plan_schedule(config)
    info = {"lanes": lanes, "chunk_steps": chunk_steps, "nchunks": nchunks,
            "warmup": config.warmup, "iterations": lanes * chunk_steps * nchunks,
            "width": config.width, "height": config.height, "frames_per_item": len(angles),
            "channels": 4 if args.transparent else 3, "sample_bytes": 1 if args.eight_bit else 2}
    return Session(ctx, config, args, output_format(args), angles, info,
                   Sample(int(ctx.cell.traffic["checked_items"]), ctx.seed))


def _engine(s: Session):
    render = program("render")

    return render.render_sequence_shared if s.args.orbit == "shared" \
        else render.render_sequence_batched


def _sequence(s: Session, seed: int, angles, out_dir, rec=None, k: int = 0):
    """Render and write one sequence as ``cli._sequence`` does; returns the
    frames and their paths."""
    cli = program("cli")
    from strange_attractor_tpu_torch.utils.export import write_image
    from strange_attractor_tpu_torch.utils.sequencing import frame_sequence

    args = s.args
    paths = [p for _, p in frame_sequence(args.start, args.end, args.step, out_dir / "frame")]
    paths = paths[:len(angles)]
    out_dir.mkdir()

    def write(path, image):
        write_image(cli._strip_suffix(path), image, fmt=s.fmt, transparent=args.transparent,
                    eight_bit=args.eight_bit, silent=s.config.silent)

    config = s.config.replace(seed=seed)
    span = rec.span if rec is not None else (lambda name, item: contextlib.nullcontext())
    with span("engine", k):
        frames = _engine(s)(config, angles, frames_per_batch=args.frames_per_batch,
                            transparent=args.transparent, eight_bit=args.eight_bit,
                            device=s.ctx.device)
    with span("write", k):
        cli._write_frames(zip(frames, paths), write)
    suffix = "." + s.fmt
    return frames, [p.with_suffix(suffix) if p.suffix != suffix else p for p in paths]


def setup(ctx) -> Session:
    """Load (on a checkout's first run: build) the kernel library, warm the
    cell's kernels at its shapes with ``render.precompile``, then one short
    sequence of two frames through the engine and the writers."""
    render = program("render")

    s = plan(ctx)
    render.precompile(s.config, device=ctx.device)
    _sequence(s, 0, s.angles[:2], ctx.workdir / "warm")
    shutil.rmtree(ctx.workdir / "warm")
    return s


def window(s: Session, seconds: float, rec) -> None:
    deadline = time.perf_counter() + seconds
    k = 0
    while time.perf_counter() < deadline:
        out_dir = s.ctx.workdir / f"seq{k}"
        with rec.item(k):
            frames, paths = _sequence(s, item_seed(s.ctx.seed, k), s.angles, out_dir, rec, k)
        s.info["bytes_written"] = s.info.get("bytes_written", 0) + sum(
            p.stat().st_size for p in paths)
        let_go = s.sample.offer(k, (frames, paths, out_dir))
        if let_go is not None:
            shutil.rmtree(let_go[2])
        k += 1


def fold(seed: int, index: int) -> int:
    """Frame ``index``'s seed under a sequence's ``--seed``: the two folded
    by numpy's SeedSequence, the CLI's documented derivation (a batch that
    shares an orbit draws it from its first frame's seed)."""
    return int(np.random.SeedSequence([int(seed), int(index)]).generate_state(1, np.uint64)[0])


def reference_frames(s: Session, seed: int, dtype=torch.float32) -> torch.Tensor:
    """The plain reference's 8-bit images of one sequence, (F, H, W, 3)."""
    dep = reference.Deployment.from_config(s.ctx.cell.config)
    rad = np.radians(np.asarray(s.angles, np.float64))
    dev, per = s.ctx.device, s.args.frames_per_batch
    out = []
    for lo in range(0, len(rad), per):
        hi = min(lo + per, len(rad))
        if s.args.orbit == "shared":
            gen = torch.Generator().manual_seed(fold(seed, lo))
            frames = reference.render_shared(dep, gen, s.info, [float(a) for a in rad[lo:hi]],
                                             dtype=dtype, device=dev)
        else:
            frames = [reference.render(dep, torch.Generator().manual_seed(fold(seed, i)),
                                       s.info, angle=float(rad[i]), dtype=dtype, device=dev)
                      for i in range(lo, hi)]
        out.extend(reference.tonemap8(dep, p) for p in frames)
    return torch.stack(out)


def _off(a: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(F, H, W) pixels of ``a`` that differ from ``ref``; all of them when
    the shapes differ."""
    if a.shape != ref.shape:
        return torch.ones(ref.shape[:3], dtype=torch.bool, device=ref.device)
    return (a != ref).any(-1)


def compare(answer: dict, ref: torch.Tensor) -> dict:
    return {name: int(_off(answer[name.split("_")[0]], ref).sum()) for name in LIMITS}


def control(s: Session, index: int, dtype) -> dict:
    """The numbers of the reference computed in ``dtype`` put in the
    program's place for sequence ``index``; its images stand for the files."""
    seed = item_seed(s.ctx.seed, index)
    low = reference_frames(s, seed, dtype)
    return compare({"image": low, "file": low}, reference_frames(s, seed))


def check(s: Session) -> tuple:
    """(numbers compared with their limits, what the check learned, frames
    that failed) over the kept sequences."""
    totals = dict.fromkeys(LIMITS, 0)
    failed, dev = 0, s.ctx.device
    for k, (frames, paths, _) in sorted(s.sample.kept.items()):
        ref = reference_frames(s, item_seed(s.ctx.seed, k))
        answer = {"image": torch.from_numpy(frames).to(dev),
                  "file": images.read_images(paths, s.fmt, dev)}
        off = _off(answer["image"], ref) | _off(answer["file"], ref)
        failed += int(off.flatten(1).any(1).sum())
        for name, value in compare(answer, ref).items():
            totals[name] += value
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in totals.items()}
    checks["none_checked"] = {"value": int(not s.sample.kept), "limit": 0}
    return checks, {}, failed
