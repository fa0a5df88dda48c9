#!/usr/bin/env python3
"""Per-chunk times of the main path's two kernels, of the depth bin and of
the EXACT-plane bins, and 10^9 render rates, of one version of the
PyTorch/CUDA port, for comparing two versions on one card.

    python3 perf_probe.py [--root DIR] [--only GROUP[,GROUP...]]

``--root DIR`` imports ``strange_attractor_tpu_torch`` from DIR instead of
this checkout, for example an older commit's package unpacked with
``git archive <commit> strange_attractor_tpu_torch | tar -x -C DIR``; its
kernels build under DIR's own ``build/``. ``--only`` runs the named groups
(``map_emit``, ``bin_packed``, ``bin_depth``, ``bin_exact``, ``render``,
``ptxas``) and skips the others. Two runs may land on two cards, so
compare versions only inside one machine session, in turns: old, new, new,
old. Every measurement is chip_smoke.py's own, made on the imported package:

- ``map_emit_packed_ms``: kernel A, PACKED, 32768 lanes x 128 steps (the
  flagship chunk), CUDA events over 50 back-to-back chunks;
- ``map_emit_shared_ms``: kernel A, SHARED, 2048 lanes x 1628 steps (the
  rotation cell's chunk), over 20 chunks;
- ``bin_packed``: bin_packed and its twin on the flagship and on solar-sail
  1800x2000 (``chip_smoke._honest_bin``: 20 distinct consecutive chunks onto
  the state of the first 100);
- ``bin_depth``: the same for the DEPTH_KERNEL bin on the ``--depth``
  flagship and solar-sail renders, with ``library_ms``, scatter_reduce_
  "amax" on the same chunks (``chip_smoke._library_bin_depth``), and one
  cold call on chip_smoke's 140M-point chunk over 37x23 (``long_chunk``);
- ``bin_exact``, ``bin_exact16_value``, ``bin_exact16_earliest`` (group
  ``bin_exact``): the same
  for the EXACT_KERNEL and EXACT16_KERNEL bins, each on its own strategy's
  flagship and solar-sail renders. A package from before the tile bin takes
  its once-per-render scratch plane, a later one its work buffers;
- ``cuda_kernels_per_launch`` and ``cuda_kernels_us`` in each of those rows:
  how many CUDA kernels one wrapper call starts and the mean device time of
  each, by ``torch.profiler`` over the same 20 chunks
  (``chip_smoke._cuda_kernels``; the tile bin starts five);
- ``render``: a 10^9 render's launches and the synchronized rates of three
  warm 10^9 renders of the flagship and of solar-sail 1800x2000, through
  KERNEL, DEPTH_KERNEL (``--depth``), EXACT_KERNEL and EXACT16_KERNEL (ties
  value) (``chip_smoke._render_rates``);
- ``ptxas``: per CUDA source of the package, its kernels' count, the most
  registers any of them uses, their spill bytes (``nvcc -Xptxas -v`` with
  the package's own flags) and the compile's seconds.

It prints, as the last line of its output, one JSON object of these and the
card's name and power limit. It imports no JAX and needs one card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch


GROUPS = ("map_emit", "bin_packed", "bin_depth", "bin_exact", "render", "ptxas")


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


def _ptxas(cuda_lib) -> dict:
    """source -> its kernels, most registers, spill bytes and compile
    seconds, by ``nvcc -Xptxas -v`` with the package's flags."""
    import re
    import subprocess
    import tempfile
    import time

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for src in cuda_lib.SOURCES:
            t0 = time.perf_counter()
            built = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                                    "-o", str(Path(tmp) / "k.o"), str(cuda_lib.CSRC / src)],
                                   capture_output=True, text=True, check=True)
            text = built.stdout + built.stderr
            regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
            spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", text)
            out[src] = {"kernels": len(regs), "max_registers": max(regs, default=0),
                        "spill_bytes": sum(int(a) + int(b) for a, b in spills),
                        "seconds": time.perf_counter() - t0}
            print(f"ptxas {src}: {out[src]}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="directory holding the strange_attractor_tpu_torch to time")
    ap.add_argument("--only", default=",".join(GROUPS),
                    help="comma-separated groups to run, of " + ", ".join(GROUPS))
    args = ap.parse_args()
    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        ap.error(f"--only takes groups of {', '.join(GROUPS)}, got {args.only}")
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
    emits = (("map_emit_packed_ms", cs._flagship(sat, 10**9), emit.map_emit, 50),
             ("map_emit_shared_ms", cs._flagship(sat, 10**7), emit.map_emit_shared, 20))
    for key, cfg, fn, reps in emits if "map_emit" in only else ():
        spec = emit.emit_spec(cfg, 0.0)
        pts = cs._warm_lanes(sat, dev, cfg, spec)
        chunk = sat.plan_schedule(cfg)[1]
        out[key] = cs._time_ms(lambda: fn(spec, pts, chunk), reps=reps)
        print(f"{key} {pts.shape[1]} x {chunk}: {out[key]:.4f} ms")
    makers = (("flagship", cs._flagship), ("solar_sail", cs._solar_sail))
    if "bin_packed" in only:
        out["bin_packed"] = {
            path: cs._public(cs._honest_bin(sat, dev, make(sat, 10**9), kb.bin_chunk_kernel,
                                            bin_chunk_packed, f"bin_packed {path}"))
            for path, make in makers}
    strategies = cs._bin_strategies(sat)
    if "bin_depth" in only:
        out["bin_depth"] = {}
        for path, make in makers:
            cfg = make(sat, 10**9, **strategies["bin_depth"])
            row = cs._honest_bin(sat, dev, cfg, kb.bin_chunk_kernel_depth, binning.bin_chunk_depth,
                                 f"bin_depth {path}")
            out["bin_depth"][path] = {**cs._public(row), "library_ms": cs._library_bin_depth(
                dev, cfg.width * cfg.height, row["planes"], row["chunks"], path)}
        # chip_smoke's long chunk on 37x23 onto a standing plane, one cold call
        small = 37 * 23
        plane = cs._standing(dev, small, np.random.default_rng(3), blank=False)[2]
        flat, z, _ = cs._long_chunk(dev, small)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        kb.bin_chunk_kernel_depth(plane, flat, z)
        end.record()
        torch.cuda.synchronize()
        out["bin_depth"]["long_chunk"] = {"points": flat.numel(), "ms": start.elapsed_time(end)}
        print(f"bin_depth long chunk of {flat.numel()} points on 37x23: "
              f"{out['bin_depth']['long_chunk']['ms']:.4f} ms, one cold call")
    exact = ("bin_exact", "bin_exact16_value", "bin_exact16_earliest")
    for name in exact if "bin_exact" in only else ():
        out[name] = {}
        for path, make in makers:
            cfg = make(sat, 10**9, **strategies[name])
            kernel, twin = _exact_bins(cs, sat, kb, binning, cfg, dev)[name]
            row = cs._honest_bin(sat, dev, cfg, kernel, twin, f"{name} {path}")
            out[name][path] = cs._public(row)
    B = sat.BinStrategy
    renders = {"": ({}, "bin_packed"), "_depth": (dict(render=sat.RenderKind.DEPTH), "bin_depth"),
               "_exact": (dict(bin_strategy=B.EXACT_KERNEL), "bin_exact"),
               "_exact16_value": (dict(bin_strategy=B.EXACT16_KERNEL), "bin_exact16")}
    out["render"] = {}
    for suffix, (kw, counter) in renders.items() if "render" in only else ():
        for path, make in makers:
            out["render"][path + suffix] = cs._render_rates(
                sat, dev, make(sat, 10**9, **kw), f"render {path}{suffix}", card,
                ("map_emit", counter))
    if "ptxas" in only:
        from strange_attractor_tpu_torch.ops import cuda_lib

        out["ptxas"] = _ptxas(cuda_lib)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
