#!/usr/bin/env python3
"""Per-chunk times of the main path's two kernels and of the EXACT-plane
bins, and 10^9 render rates, of one version of the PyTorch/CUDA port, for
comparing two versions on one card.

    python3 perf_probe.py [--root DIR]

``--root DIR`` imports ``strange_attractor_tpu_torch`` from DIR instead of
this checkout, for example an older commit's package unpacked with
``git archive <commit> strange_attractor_tpu_torch | tar -x -C DIR``; its
kernels build under DIR's own ``build/``. Two runs may land on two cards, so
compare versions only inside one machine session, in turns: old, new, new,
old. Every measurement is chip_smoke.py's own, made on the imported package:

- ``map_emit_packed_ms``: kernel A, PACKED, 32768 lanes x 128 steps (the
  flagship chunk), CUDA events over 50 back-to-back chunks;
- ``map_emit_shared_ms``: kernel A, SHARED, 2048 lanes x 1628 steps (the
  rotation cell's chunk), over 20 chunks;
- ``bin_packed``: bin_packed and its twin on the flagship and on solar-sail
  1800x2000 (``chip_smoke._honest_bin``: 20 distinct consecutive chunks onto
  the state of the first 100);
- ``bin_exact``, ``bin_exact16_value``, ``bin_exact16_earliest``: the same
  for the EXACT_KERNEL and EXACT16_KERNEL bins, each on its own strategy's
  flagship and solar-sail renders. A package from before the tile bin takes
  its once-per-render scratch plane, a later one its work buffers;
- ``cuda_kernels_per_launch`` and ``cuda_kernels_us`` in each of those rows:
  how many CUDA kernels one wrapper call starts and the mean device time of
  each, by ``torch.profiler`` over the same 20 chunks
  (``chip_smoke._cuda_kernels``; the tile bin starts five);
- ``render``: a 10^9 render's launches and the synchronized rates of three
  warm 10^9 renders of the flagship and of solar-sail 1800x2000, through
  KERNEL, EXACT_KERNEL and EXACT16_KERNEL (ties value)
  (``chip_smoke._render_rates``).

It prints, as the last line of its output, one JSON object of these and the
card's name and power limit. It imports no JAX and needs one card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def _exact_bins(cs, sat, kb, binning, cfg, dev) -> dict:
    """name -> (kernel, twin) of the EXACT-plane bins for ``cfg``'s render:
    ``chip_smoke._exact_bins`` on the package's work buffers, or for a
    package from before the tile bin the same on its scratch key plane."""
    if hasattr(kb, "new_work"):
        lanes, chunk, _ = sat.plan_schedule(cfg)
        return cs._exact_bins(kb, binning, kb.new_work(lanes * chunk, dev))
    scratch = kb.new_scratch(cfg.width * cfg.height, dev)
    return {
        "bin_exact": (lambda *p: kb.bin_chunk_kernel_exact(*p, scratch=scratch),
                      binning.bin_chunk_exact),
        "bin_exact16_value": (
            lambda *p: kb.bin_chunk_kernel_exact16(*p, ties="value", scratch=scratch),
            lambda *p: binning.bin_chunk_exact16(*p, ties="value")),
        "bin_exact16_earliest": (
            lambda *p: kb.bin_chunk_kernel_exact16(*p, ties="earliest", scratch=scratch),
            lambda *p: binning.bin_chunk_exact16(*p, ties="earliest")),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="directory holding the strange_attractor_tpu_torch to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("perf_probe: torch.cuda is not available; this probe needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke as cs  # this checkout's measurements

    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    import strange_attractor_tpu_torch as sat
    from strange_attractor_tpu_torch.ops import emit
    from strange_attractor_tpu_torch.ops import kernel_binning as kb
    from strange_attractor_tpu_torch.ops import binning
    from strange_attractor_tpu_torch.ops.binning import bin_chunk_packed

    dev = torch.device("cuda", 0)
    card = cs._card_line()
    out = {"card": card, "package": str(Path(sat.__file__).resolve().parent)}
    print(f"card {card}; package {out['package']}")
    for key, cfg, fn, reps in (("map_emit_packed_ms", cs._flagship(sat, 10**9), emit.map_emit, 50),
                               ("map_emit_shared_ms", cs._flagship(sat, 10**7),
                                emit.map_emit_shared, 20)):
        spec = emit.emit_spec(cfg, 0.0)
        pts = cs._warm_lanes(sat, dev, cfg, spec)
        chunk = sat.plan_schedule(cfg)[1]
        out[key] = cs._time_ms(lambda: fn(spec, pts, chunk), reps=reps)
        print(f"{key} {pts.shape[1]} x {chunk}: {out[key]:.4f} ms")
    paths = {"flagship": cs._flagship(sat, 10**9), "solar_sail": cs._solar_sail(sat, 10**9)}
    out["bin_packed"] = {name: cs._public(cs._honest_bin(sat, dev, cfg, kb.bin_chunk_kernel,
                                                         bin_chunk_packed, f"bin_packed {name}"))
                         for name, cfg in paths.items()}
    strategies = cs._bin_strategies(sat)
    for name in ("bin_exact", "bin_exact16_value", "bin_exact16_earliest"):
        out[name] = {}
        for path, make in (("flagship", cs._flagship), ("solar_sail", cs._solar_sail)):
            cfg = make(sat, 10**9, **strategies[name])
            kernel, twin = _exact_bins(cs, sat, kb, binning, cfg, dev)[name]
            row = cs._honest_bin(sat, dev, cfg, kernel, twin, f"{name} {path}")
            out[name][path] = cs._public(row)
    B = sat.BinStrategy
    renders = {"": ({}, "bin_packed"), "_exact": (dict(bin_strategy=B.EXACT_KERNEL), "bin_exact"),
               "_exact16_value": (dict(bin_strategy=B.EXACT16_KERNEL), "bin_exact16")}
    out["render"] = {}
    for suffix, (kw, counter) in renders.items():
        for path, make in (("flagship", cs._flagship), ("solar_sail", cs._solar_sail)):
            out["render"][path + suffix] = cs._render_rates(
                sat, dev, make(sat, 10**9, **kw), f"render {path}{suffix}", card,
                ("map_emit", counter))
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
