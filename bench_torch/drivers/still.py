"""Stills: one user in a closed loop renders frames back to back through the
CLI's single-frame path, each a fresh render whose seed points come from
the run's seed and the frame's index:

    render.render -> render.colorize_convert_fetch -> utils.export.write_image

(``cli._render_stateful`` and ``cli._single_frame``). Spans: ``render``
(ends in a synchronize), ``deliver`` (kernel T and the host copy),
``encode`` (the file written). A frame is deleted once written, unless the
check keeps it.

The check renders the kept frames with the plain reference at the timed
sizes and compares, pixel for pixel: the count plane and the key plane
that kernel A's emission and the bin produced, the delivered 8-bit image
(kernel T), and the file read back (the encoder). Every number is a count
of pixels that differ, limit 0: the program's kernels compute the
reference's arithmetic, one rounding an operation, so a sound run agrees
bit for bit and any departure is a fault.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from bench_torch import images, reference
from bench_torch.harness import Sample, item_seed, output_format, program

SPANS = ("render", "deliver", "encode")
LIMITS = {"count_px_off": 0, "key_px_off": 0, "image_px_off": 0, "file_px_off": 0}
U32 = 0xFFFFFFFF


@dataclasses.dataclass
class Session:
    ctx: object
    config: object  # the program's Config
    args: object  # its parsed CLI arguments
    fmt: str
    info: dict
    sample: Sample


def plan(ctx) -> Session:
    """The program's config and schedule of the cell, nothing run yet."""
    cli, render = program("cli"), program("render")

    args = ctx.parse_args()
    config = cli.config_from_args(args)
    lanes, chunk_steps, nchunks = render.plan_schedule(config)
    info = {"lanes": lanes, "chunk_steps": chunk_steps, "nchunks": nchunks,
            "warmup": config.warmup, "iterations": lanes * chunk_steps * nchunks,
            "width": config.width, "height": config.height, "frames_per_item": 1,
            "channels": 4 if args.transparent else 3, "sample_bytes": 1 if args.eight_bit else 2}
    return Session(ctx, config, args, output_format(args), info,
                   Sample(int(ctx.cell.traffic["checked_items"]), ctx.seed))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(ctx) -> Session:
    """Load (on a checkout's first run: build) the kernel library, warm the
    cell's render with ``render.precompile``, then one delivery and one
    encode of its state."""
    render = program("render")
    from strange_attractor_tpu_torch.utils.export import write_image

    s = plan(ctx)
    state = render.precompile(s.config, device=ctx.device)
    image = render.colorize_convert_fetch(s.config, state, transparent=s.args.transparent,
                                          eight_bit=s.args.eight_bit)
    write_image(ctx.workdir / "warm", image, fmt=s.fmt, transparent=s.args.transparent,
                eight_bit=s.args.eight_bit, silent=True).unlink()
    _sync(ctx.device)
    return s


def window(s: Session, seconds: float, rec) -> None:
    render = program("render")
    from strange_attractor_tpu_torch.utils.export import write_image

    ctx, args, dev = s.ctx, s.args, s.ctx.device
    deadline = time.perf_counter() + seconds
    i = 0
    while time.perf_counter() < deadline:
        gen = torch.Generator().manual_seed(item_seed(ctx.seed, i))
        with rec.item(i):
            with rec.span("render", i):
                state = render.render(s.config, None, gen, device=dev)
                _sync(dev)
            with rec.span("deliver", i):
                image = render.colorize_convert_fetch(s.config, state,
                                                      transparent=args.transparent,
                                                      eight_bit=args.eight_bit)
                _sync(dev)
            with rec.span("encode", i):
                path = write_image(ctx.workdir / f"frame{i}", image, fmt=s.fmt,
                                   transparent=args.transparent, eight_bit=args.eight_bit,
                                   silent=s.config.silent)
        s.info["bytes_written"] = s.info.get("bytes_written", 0) + path.stat().st_size
        let_go = s.sample.offer(i, (state, image, path))
        if let_go is not None:
            let_go[2].unlink()
        i += 1


def reference_answer(s: Session, index: int, dtype=torch.float32) -> dict:
    """The plain reference's planes and image of frame ``index``."""
    dep = reference.Deployment.from_config(s.ctx.cell.config)
    gen = torch.Generator().manual_seed(item_seed(s.ctx.seed, index))
    planes = reference.render(dep, gen, s.info, dtype=dtype, device=s.ctx.device)
    image = reference.tonemap8(dep, planes)
    return {"count": planes.count, "key": planes.key, "image": image, "file": image,
            "distinct": planes.distinct}


def program_answer(s: Session, payload) -> dict:
    state, image, path = payload
    dev = s.ctx.device
    return {"count": state.count.reshape(-1).to(torch.int64) & U32,
            "key": state.packed.reshape(-1).to(torch.int64) & U32,
            "image": torch.from_numpy(image).to(dev),
            "file": images.read_images([path], s.fmt, dev)[0]}


def _px_off(a: torch.Tensor, b: torch.Tensor) -> int:
    """Pixels (rows of the last axis for images) where ``a`` and ``b``
    differ; every pixel when their shapes differ."""
    if a.shape != b.shape:
        return int(max(a.numel(), b.numel()))
    diff = a != b
    return int((diff.any(-1) if diff.dim() == 3 else diff).sum())


def compare(answer: dict, ref: dict) -> dict:
    return {"count_px_off": _px_off(answer["count"], ref["count"]),
            "key_px_off": _px_off(answer["key"], ref["key"]),
            "image_px_off": _px_off(answer["image"], ref["image"]),
            "file_px_off": _px_off(answer["file"], ref["file"])}


def control(s: Session, index: int, dtype) -> dict:
    """The numbers of the reference computed in ``dtype`` put in the
    program's place for frame ``index``; its image stands for the file."""
    return compare(reference_answer(s, index, dtype), reference_answer(s, index))


def check(s: Session) -> tuple:
    """(numbers compared with their limits, what the check learned, frames
    that failed) over the kept frames."""
    totals = dict.fromkeys(LIMITS, 0)
    distinct, failed = [], 0
    for index, payload in sorted(s.sample.kept.items()):
        ref = reference_answer(s, index)
        numbers = compare(program_answer(s, payload), ref)
        distinct.extend(ref["distinct"])
        failed += any(numbers[k] > LIMITS[k] for k in LIMITS)
        for k in totals:
            totals[k] += numbers[k]
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in totals.items()}
    checks["none_checked"] = {"value": int(not s.sample.kept), "limit": 0}
    return checks, {"distinct_px_per_chunk": distinct}, failed
