"""Pixel parity of the port's 10^9 flagship render against a recorded render
(the counterpart of the JAX package's ``tools/compare_reference.py``).

``media/poisson-saturne-tpu.png`` is the JAX package's own render of the
reference workload: poisson-saturne, 10^9 iterations, brightness -0.25,
1920x1080, 8-bit RGB. This tool renders the same workload with the port
and reports three numbers over the 8-bit RGB pixels of both images: the
mean absolute difference as a fraction of full scale, the pixel
correlation, and the IoU of the lit support (pixels whose largest channel
is above 8). The two packages draw their seed points from different
generators, so the agreement is statistical; it passes when MAD < 0.01
and the correlation > 0.99, the JAX tool's own rule.

Usage, on a card::

    python -m strange_attractor_tpu_torch.tools.compare_reference \\
        [--reference PNG] [--out PNG] [--reuse] [--bin-strategy S] [--device cuda|cpu]

By default the workload is rendered anew on every run (the numbers must
reflect the current code); ``--reuse`` compares an existing ``--out`` file
instead. ``--device cpu`` renders with the plain twins: a 10^9 render
there takes hours, so on the CPU compare files with ``--reuse``, or call
:func:`workload` and :func:`render_workload` at a smaller size. Images are
read with :func:`utils.export.read_png` (the stdlib's zlib and numpy).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
DEFAULT_REFERENCE = REPO / "media" / "poisson-saturne-tpu.png"
DEFAULT_OUT = REPO / "build" / "parity_render.png"
# no depth strategies: the target is a Gas image, and a z-only state has
# no Gas tone map
STRATEGIES = ("auto", "exact", "packed", "kernel", "exact-kernel", "exact16-kernel")


def _rgb8(img: np.ndarray) -> np.ndarray:
    """The 8-bit RGB pixels of a decoded image as float64: alpha dropped,
    16-bit samples by their high byte (what PIL's ``convert("RGB")``
    gives, which the JAX tool reads through)."""
    rgb = img[..., :3]
    if rgb.dtype == np.uint16:
        rgb = rgb >> 8
    return rgb.astype(np.float64)


def compare(ref_path, our_path) -> dict:
    """MAD of full scale, pixel correlation and lit-support IoU of two PNG
    files of one size, by the JAX tool's formulas
    (tools/compare_reference.py:28-38)."""
    from ..utils.export import read_png

    ref, ours = _rgb8(read_png(ref_path)), _rgb8(read_png(our_path))
    if ref.shape != ours.shape:
        raise SystemExit(f"shape mismatch: {ref.shape} vs {ours.shape}")
    mad = float(np.abs(ref - ours).mean() / 255)
    corr = float(np.corrcoef(ref.ravel(), ours.ravel())[0, 1])
    rs, os_ = ref.max(-1) > 8, ours.max(-1) > 8
    iou = float((rs & os_).sum() / max(1, (rs | os_).sum()))
    return {"mad": mad, "correlation": corr, "support_iou": iou}


def passes(metrics: dict) -> bool:
    """The JAX tool's rule: MAD below 0.01 and correlation above 0.99."""
    return metrics["mad"] < 0.01 and metrics["correlation"] > 0.99


def workload(bin_strategy: str = "auto", iterations: int = 1_000_000_000, **overrides):
    """The reference workload's config (the JAX tool's, :73-88):
    poisson-saturne, brightness offset -0.25, seed 0, progress lines on,
    through ``bin_strategy``; ``overrides`` replace preset fields (the
    tests shrink the canvas, phase 30 of chip_smoke.py picks EXACT16's
    ties)."""
    from ..config import BinStrategy, BrightnessConstants, Colors
    from ..models import presets

    kw = {"colors": Colors(brightness=BrightnessConstants(offset=-0.25)), "seed": 0,
          "silent": False, **overrides}
    return presets.poisson_saturne(iterations=iterations,
                                   bin_strategy=BinStrategy(bin_strategy), **kw)


def render_workload(config, out, device="cuda") -> dict:
    """``precompile``, one timed render (synchronized), then the 8-bit
    opaque delivery (``colorize_convert_fetch``) written as a PNG at
    ``out``. Returns the path, the seconds of the render, its iterations
    per second and the iterations it ran."""
    import torch

    from ..render import colorize_convert_fetch, plan_schedule, precompile, render
    from ..runtime import resolve_device
    from ..utils.export import write_image

    device = resolve_device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    precompile(config, device=device)
    sync()
    t0 = time.perf_counter()
    state = render(config, device=device)
    sync()
    seconds = time.perf_counter() - t0
    lanes, chunk, nchunks = plan_schedule(config)
    executed = lanes * chunk * nchunks
    img = colorize_convert_fetch(config, state, transparent=False, eight_bit=True)
    path = write_image(Path(out).with_suffix(""), img, fmt="png", transparent=False,
                       eight_bit=True)
    return {"path": path, "seconds": seconds, "iters_per_s": executed / seconds,
            "executed": executed}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", default=str(DEFAULT_REFERENCE),
                    help="the recorded render (default: media/poisson-saturne-tpu.png)")
    ap.add_argument("--out", default=str(DEFAULT_OUT), help="where the port's render goes")
    ap.add_argument("--reuse", action="store_true",
                    help="compare an existing --out file instead of re-rendering")
    ap.add_argument("--bin-strategy", default="auto", choices=STRATEGIES,
                    help="accumulation strategy for the parity render "
                         "(records each strategy's own parity figure)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the render (default cuda; cpu runs the plain twins)")
    args = ap.parse_args(argv)
    out = Path(args.out)
    if not (args.reuse and out.exists()):
        out.parent.mkdir(parents=True, exist_ok=True)
        run = render_workload(workload(args.bin_strategy), out, args.device)
        out = run["path"]
        print(f"[{args.bin_strategy}] {run['iters_per_s']:.3e} iters/s ({run['seconds']:.2f}s)")
    metrics = compare(args.reference, out)
    print(metrics)
    ok = passes(metrics)
    print("PARITY: PASS" if ok else "PARITY: FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
