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
``ptxas``, ``axes``, ``hashes``) and skips the others. Two runs may land on two cards, so
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
  the package's own flags) and the compile's seconds;
- ``axes`` (a package with lane reseeding and the float64 path): kernel A's
  gated float32 PACKED chunk in turns with the ungated one, its float64
  chunk in each emission mode (gated PACKED too) at the flagship shape,
  over 50 chunks each, and the 10^9 renders of that slice: solar-sail
  1800x2000 with reseeding in Gas and ``--depth``, the float64 flagship
  through KERNEL and EXACT_KERNEL (``chip_smoke._render_rates``);
- ``hashes``: a sha256 prefix of the planes of seeded 10^8 renders (the
  flagship in Gas, ``--depth``, exact-kernel and exact16-kernel,
  solar-sail 1800x2000, lorenz, thomas) and of the frames of a 4-frame
  10^7 shared-orbit sequence: two package versions that render alike
  print the same hashes.

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


GROUPS = ("map_emit", "bin_packed", "bin_depth", "bin_exact", "render", "ptxas", "axes",
          "hashes")


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
            built = subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c",
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


def _axes(cs, sat, emit, dev, card) -> dict:
    """The ``axes`` group: kernel A's gated and float64 chunks at the
    flagship shape, then the slice's four 10^9 renders."""
    out = {}
    cfg = cs._flagship(sat, 10**9)
    spec, chunk = emit.emit_spec(cfg, 0.0), sat.plan_schedule(cfg)[1]
    pts = cs._warm_lanes(sat, dev, cfg, spec)
    age = torch.ones(pts.shape[1], dtype=torch.int32, device=dev)
    reseed = emit.Reseed(age, 1, 0, cfg.warmup)
    for turn, r in (("ungated", None), ("gated", reseed), ("gated", reseed), ("ungated", None)):
        ms = cs._time_ms(lambda: emit.map_emit(spec, pts, chunk, reseed=r), reps=50)
        out.setdefault(f"map_emit_{turn}_ms", []).append(ms)
    pts = pts.double()
    B = sat.BinStrategy
    for name, kind, shared, r in (("packed", B.PACKED, False, None),
                                  ("depth", B.DEPTH, False, None),
                                  ("exact", B.EXACT, False, None),
                                  ("shared", B.PACKED, True, None),
                                  ("shared-depth", B.DEPTH, True, None),
                                  ("gated_packed", B.PACKED, False, reseed)):
        fn = emit.map_emit_shared if shared else emit.map_emit
        out[f"map_emit_f64_{name}_ms"] = cs._time_ms(
            lambda: fn(spec, pts, chunk, kind=kind, reseed=r), reps=50)
    for key, v in out.items():
        print(f"{key} {pts.shape[1]} x {chunk}: {v}")
    renders = {
        "reseed_solar_sail": (cs._solar_sail(sat, 10**9, reseed_lanes=True), "map_emit_gated",
                              "bin_packed"),
        "reseed_solar_sail_depth": (cs._solar_sail(sat, 10**9, reseed_lanes=True,
                                                   render=sat.RenderKind.DEPTH),
                                    "map_emit_gated", "bin_depth"),
        "f64_flagship": (cs._flagship(sat, 10**9, dtype="float64"), "map_emit_f64",
                         "bin_packed"),
        "f64_flagship_exact": (cs._flagship(sat, 10**9, dtype="float64",
                                            bin_strategy=B.EXACT_KERNEL), "map_emit_f64",
                               "bin_exact"),
    }
    out["render"] = {name: cs._render_rates(sat, dev, cfg, f"render {name}", card, kernels)
                     for name, (cfg, *kernels) in renders.items()}
    return out


def _hashes(cs, sat, dev) -> dict:
    """sha256 prefixes of seeded renders' planes and of a shared-orbit
    sequence's frames (the ``hashes`` group)."""
    import hashlib

    from strange_attractor_tpu_torch.runtime import state_to_numpy

    B = sat.BinStrategy
    configs = {"flagship": cs._flagship(sat, 10**8),
               "depth": cs._flagship(sat, 10**8, render=sat.RenderKind.DEPTH),
               "exact": cs._flagship(sat, 10**8, bin_strategy=B.EXACT_KERNEL),
               "exact16": cs._flagship(sat, 10**8, bin_strategy=B.EXACT16_KERNEL),
               "solar_sail": cs._solar_sail(sat, 10**8),
               "lorenz": sat.presets.by_name("lorenz", iterations=10**8, seed=1),
               "thomas": sat.presets.by_name("thomas", iterations=10**8, seed=1)}
    out = {}
    for name, cfg in configs.items():
        planes = state_to_numpy(sat.render(cfg.replace(silent=True), device=dev))
        digest = hashlib.sha256()
        for key in sorted(planes):
            digest.update(key.encode() + planes[key].tobytes())
        out[name] = digest.hexdigest()[:16]
    frames = sat.render_sequence_shared(cs._flagship(sat, 10**7), [0.0, 90.0, 180.0, 270.0],
                                        frames_per_batch=4,
                                        transparent=False, eight_bit=True, device=dev)
    out["sequence_shared"] = hashlib.sha256(frames.tobytes()).hexdigest()[:16]
    print("hashes " + " ".join(f"{k} {v}" for k, v in out.items()))
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
    if "axes" in only:
        out["axes"] = _axes(cs, sat, emit, dev, card)
    if "hashes" in only:
        out["hashes"] = _hashes(cs, sat, dev)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
