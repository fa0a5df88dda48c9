"""EXACT stills: the still loop of ``drivers/still.py`` (one user in a closed
loop, frames back to back through the CLI's single-frame path, each a fresh
render seeded from the run's seed and the frame's index)

    render.render -> render.colorize_convert_fetch -> utils.export.write_image

for a configuration with ``--bin-strategy exact-kernel``: kernel A in its
EXACT emission, the tile bin (``csrc/bin_exact.cu`` + ``csrc/bin_tile.cuh``),
kernel T on EXACT planes and the file. Spans ``render``, ``deliver`` and
``encode`` as in the still loop; a frame is deleted once written, unless
the check keeps it. The window also counts the EXACT bin's launches
(``info["bin_exact_launches"]``), a counter the harness does not read.

The check renders the kept frames with the plain EXACT reference
(``reference_exact.py``) at the timed sizes and compares, pixel for pixel:
the count plane, the ``steps`` and ``zbuf`` planes' float32 bits (kernel A's
EXACT stream and the bin), the delivered 8-bit image (kernel T) and the
file read back (the writer). Every number is a count of pixels that
differ, limit 0. It also reports what it learned: the pixels each chunk
touched, and the equal-depth ties a frame that the earliest-point rule
decided.
"""

from __future__ import annotations

from pathlib import Path

import torch

from bench_torch import images, reference, reference_exact
from bench_torch.harness import item_seed, load_module, program

still = load_module(Path(__file__).with_name("still.py"), "bench_torch_driver_still")

SPANS = still.SPANS
LIMITS = {"count_px_off": 0, "steps_px_off": 0, "zbuf_px_off": 0, "image_px_off": 0,
          "file_px_off": 0}
Session = still.Session
U32 = still.U32
_px_off = still._px_off


def _bin_launches():
    """``ops.kernel_binning.bin_chunk_kernel_exact``'s launches so far, or
    None where the program has no such counter."""
    try:
        return program("ops.kernel_binning").bin_chunk_kernel_exact.launches
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
    s.info["bin_exact_launches"] = None if None in (before, after) else after - before


def _answer(planes, image) -> dict:
    return {"count": planes.count, "steps": planes.steps.view(torch.int32),
            "zbuf": planes.zbuf.view(torch.int32), "image": image, "file": image,
            "distinct": planes.distinct, "ties": planes.ties}


def reference_planes(s: Session, index: int, dtype=torch.float32):
    """The plain reference's EXACT planes of frame ``index``."""
    dep = reference.Deployment.from_config(s.ctx.cell.config)
    gen = torch.Generator().manual_seed(item_seed(s.ctx.seed, index))
    return dep, reference_exact.render(dep, gen, s.info, dtype=dtype, device=s.ctx.device)


def reference_answer(s: Session, index: int, dtype=torch.float32) -> dict:
    """The plain reference's planes and image of frame ``index``."""
    dep, planes = reference_planes(s, index, dtype)
    return _answer(planes, reference_exact.tonemap8(dep, planes))


def program_answer(s: Session, payload) -> dict:
    state, image, path = payload
    dev = s.ctx.device
    return {"count": state.count.reshape(-1).to(torch.int64) & U32,
            "steps": state.steps.reshape(-1).view(torch.int32),
            "zbuf": state.zbuf.reshape(-1).view(torch.int32),
            "image": torch.from_numpy(image).to(dev),
            "file": images.read_images([path], s.fmt, dev)[0]}


def compare(answer: dict, ref: dict) -> dict:
    return {f"{k}_px_off": _px_off(answer[k], ref[k])
            for k in ("count", "steps", "zbuf", "image", "file")}


def control(s: Session, index: int, dtype) -> dict:
    """The numbers of the reference computed in ``dtype`` put in the
    program's place for frame ``index``; its image stands for the file."""
    return compare(reference_answer(s, index, dtype), reference_answer(s, index))


def quantized_control(s: Session, index: int) -> dict:
    """The numbers of the PACKED planes' colour value put in the program's
    place for frame ``index``: the float32 reference with ``steps`` cut to
    the 12-bit palette position (:func:`reference_exact.quantized`), its
    image tone-mapped from that. A comparison that holds ``steps`` at full
    precision has to fail it."""
    dep, planes = reference_planes(s, index)
    value = reference_exact.quantized(planes)
    ref = _answer(planes, reference_exact.tonemap8(dep, planes))
    cut = {**ref, "steps": value.view(torch.int32),
           "image": reference_exact.tonemap8(dep, planes, value=value)}
    cut["file"] = cut["image"]
    return compare(cut, ref)


def check(s: Session) -> tuple:
    """(numbers compared with their limits, what the check learned, frames
    that failed) over the kept frames."""
    totals = dict.fromkeys(LIMITS, 0)
    distinct, ties, failed = [], [], 0
    for index, payload in sorted(s.sample.kept.items()):
        ref = reference_answer(s, index)
        numbers = compare(program_answer(s, payload), ref)
        distinct.extend(ref["distinct"])
        ties.append(ref["ties"])
        failed += any(numbers[k] > LIMITS[k] for k in LIMITS)
        for k in totals:
            totals[k] += numbers[k]
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in totals.items()}
    checks["none_checked"] = {"value": int(not s.sample.kept), "limit": 0}
    return checks, {"distinct_px_per_chunk": distinct, "equal_z_ties_per_frame": ties}, failed
