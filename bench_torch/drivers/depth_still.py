"""Depth stills: the still loop of ``drivers/still.py`` (one user in a closed
loop, frames back to back through the CLI's single-frame path, each a fresh
render seeded from the run's seed and the frame's index)

    render.render -> render.colorize_convert_fetch -> utils.export.write_image

for a configuration with ``--depth``: kernel A in its DEPTH emission, the
DEPTH bin (``csrc/bin_depth.cu``), kernel T's depth branch and the file.
Spans ``render``, ``deliver`` and ``encode`` as in the still loop; a frame
is deleted once written, unless the check keeps it. The window also counts
the DEPTH bin's launches (``info["bin_depth_launches"]``), a counter the
harness does not read.

The check renders the kept frames with the plain depth reference
(``reference_depth.py``) at the timed sizes and compares, pixel for pixel:
the z-buffer's float32 bits (kernel A's depth stream and the bin), the
delivered 8-bit image (kernel T) and the file read back (the writer).
Every number is a count of pixels that differ, limit 0.
"""

from __future__ import annotations

from pathlib import Path

import torch

from bench_torch import images, reference, reference_depth
from bench_torch.harness import item_seed, load_module, program

still = load_module(Path(__file__).with_name("still.py"), "bench_torch_driver_still")

SPANS = still.SPANS
LIMITS = {"zbuf_px_off": 0, "image_px_off": 0, "file_px_off": 0}
Session = still.Session
_px_off = still._px_off


def _bin_launches():
    """``ops.kernel_binning.bin_chunk_kernel_depth``'s launches so far, or
    None where the program has no such counter."""
    try:
        return program("ops.kernel_binning").bin_chunk_kernel_depth.launches
    except (ImportError, AttributeError):
        return None


def _described(s: Session) -> Session:
    """``s`` with the render kind and the bin strategy the program resolves
    for the cell in its ``info``."""
    s.info.update(render=s.config.render.value, bin=s.config.resolved_bin_strategy().value)
    return s


def plan(ctx) -> Session:
    """The still loop's plan of the cell, nothing run yet."""
    return _described(still.plan(ctx))


def setup(ctx) -> Session:
    """The still loop's set-up: the kernel library, ``render.precompile`` at
    the cell's config, one delivery and one write."""
    return _described(still.setup(ctx))


def window(s: Session, seconds: float, rec) -> None:
    before = _bin_launches()
    still.window(s, seconds, rec)
    after = _bin_launches()
    s.info["bin_depth_launches"] = None if None in (before, after) else after - before


def reference_answer(s: Session, index: int, dtype=torch.float32) -> dict:
    """The plain reference's z-buffer and image of frame ``index``."""
    dep = reference.Deployment.from_config(s.ctx.cell.config)
    gen = torch.Generator().manual_seed(item_seed(s.ctx.seed, index))
    plane = reference_depth.render(dep, gen, s.info, dtype=dtype, device=s.ctx.device)
    zbuf = plane.zbuf
    image = reference_depth.tonemap8(dep, zbuf)
    return {"zbuf": zbuf.view(torch.int32), "image": image, "file": image,
            "distinct": plane.distinct}


def program_answer(s: Session, payload) -> dict:
    state, image, path = payload
    dev = s.ctx.device
    return {"zbuf": state.zbuf.reshape(-1).view(torch.int32),
            "image": torch.from_numpy(image).to(dev),
            "file": images.read_images([path], s.fmt, dev)[0]}


def compare(answer: dict, ref: dict) -> dict:
    return {f"{k}_px_off": _px_off(answer[k], ref[k]) for k in ("zbuf", "image", "file")}


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
