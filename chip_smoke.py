#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA Hopper card.

Run from the root of the repository, on a machine with one H100:

    python3 chip_smoke.py

Phases (each raises on failure; the last line is the JSON result only when
all passed):

1. card name and power limit, torch/CUDA versions, kernel build from csrc/;
2. kernel A (csrc/map_emit.cu) against its plain twin on the card at 32768
   lanes: warm-up + 4 chunks of 128 steps, streams and lane state
   bit-identical (poisson-saturne; solar-sail's escaping orbits too; a
   ragged 1000-lane batch at another angle);
3. kernel B (csrc/bin_packed.cu) against plain bin_chunk_packed on the card,
   bit-identical: random 4M-point stream over 1920x1080 with 5% out of
   bounds, heavy duplicates and ties, a 40% pixel-0 flood, all out of
   bounds, accumulation over 3 chunks, a ragged 1000003-point stream;
4. the flagship slice: poisson-saturne 1920x1080 Gas, 8-bit, seed 1, 1e8
   iterations, render -> colorize -> convert -> one host copy -> PNG, with
   both launch counters > 0 and a non-blank image; iters/s and wall time;
5. the same seeded render at 1e6 iterations through the kernels and through
   the plain twins on the card: identical planes and PNG bytes;
6. kernel A in DEPTH (flat, z) and EXACT (flat, z, val) emission against
   its plain twin at 32768 lanes, every float bit identical: warm-up + 2
   chunks, poisson-saturne and solar-sail; the time of each mode;
7. the bin kernels of the fidelity and depth modes (csrc/bin_depth.cu,
   csrc/bin_exact.cu, csrc/bin_exact16.cu in both tie modes) against their
   plain twins on the card, bit-identical, at the flagship chunk (4,194,304
   points over 1920x1080): phase 3's cases plus z ties with both zero
   signs, special floats (+-0, +-inf, NaN, -1.0), and three chunks onto a
   non-blank standing state holding -0.0 and exact z ties; each kernel and
   twin timed on a real emitted stream; and what torch's own float16 cast
   does with NaN payloads on the card, beside the kernels' bit conversion;
8. the paths of the other entry points, 1920x1080, seed 1, 1e8 iterations,
   each with every launch count set to 0 just before it and read after:
   the --depth flagship (AUTO -> DEPTH_KERNEL: kernel A in depth emission,
   bin_depth, the Depth tone map, PNG), and Gas frames through
   exact-kernel and exact16-kernel (ties value, then earliest); non-blank
   images, iters/s and wall time;
9. the same seeded 1e6 renders through the kernels and through the plain
   twins: DEPTH_KERNEL against DEPTH, EXACT_KERNEL against EXACT,
   EXACT16_KERNEL against its twin route in both tie modes; identical
   planes and PNG bytes;
10. kernel A's shared-orbit modes (csrc/map_emit.cu) and the per-frame
    projection (csrc/project_emit.cu) against their plain twins at 32768
    lanes, warm-up + 2 chunks of 128 steps, poisson-saturne and solar-sail,
    angles 0, 97.3 and 222.5 degrees, PACKED, DEPTH and EXACT kinds: the
    invariant streams, the lane state and every frame stream bit-identical,
    and every frame stream equal to the fused kernel A stream at its angle;
    then one chunk at the rotation cell's shape (2048 lanes x 1628 steps),
    and both kernels timed there against their twins;
11. seeded 1e6 sequences of 8 frames at 1920x1080 through the shared-orbit
    engine for KERNEL, DEPTH_KERNEL, EXACT_KERNEL and EXACT16_KERNEL (both
    tie modes): every frame's planes bit-identical to render_seeds of the
    batch's seeds at its angle, on the kernel route and on the plain-twin
    route, and every delivered 8-bit frame equal to that render's;
12. the rotation cell: poisson-saturne 1920x1080 Gas, 8-bit, seed 1, 120
    frames over 0-360 degrees at 1e7 iterations a frame, through
    render_sequence_shared (auto batch) and render_sequence_batched, each
    with every launch count set to 0 just before it and read after; frames
    per second of render + colorize + convert + host copy, the device idle
    share of one traced batch of each engine, two frames encoded to PNG.

It imports no JAX. It needs one card and exits non-zero without one.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

LANES, CHUNK = 32768, 128
W, H = 1920, 1080


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events.

    A spin kernel queued first keeps the card busy while the host enqueues
    the calls, so a kernel shorter than its own launch overhead is timed
    back to back on the device rather than at the host's launch rate. A
    plain twin of hundreds of launches outruns the spin and is timed as a
    user meets it."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _check_equal(name: str, a: torch.Tensor, b: torch.Tensor) -> float:
    """Raise unless ``a`` and ``b`` are bit-identical; return the max abs
    difference (0.0: NaN lanes of escaped orbits compare by their bits)."""
    bits = (lambda t: t.view(torch.int32)) if a.dtype == torch.float32 else (lambda t: t)
    if a.shape != b.shape or not torch.equal(bits(a), bits(b)):
        diff = (a.double() - b.double()).abs().nan_to_num(nan=float("inf"))
        raise AssertionError(f"{name}: kernel differs from its plain twin "
                             f"(max abs {float(diff.max()) if diff.numel() else 'shape'})")
    return 0.0


def phase_kernel_a(sat, dev) -> dict:
    from strange_attractor_tpu_torch.ops import emit

    err = 0.0
    rng = np.random.default_rng(0)
    # the flagship shape; solar-sail's escaping orbits; a ragged lane count
    # (a partial last block) at another camera angle
    for preset, chunks, lanes, angle in (("poisson-saturne", 4, LANES, 0.0),
                                         ("solar-sail", 2, LANES, 0.0),
                                         ("poisson-saturne", 1, 1000, 0.7)):
        cfg = sat.presets.by_name(preset, width=W, height=H)
        spec = emit.emit_spec(cfg, angle)
        seeds = torch.from_numpy((rng.random((3, lanes)) * 0.1).astype(np.float32)).to(dev)
        pk, pp = seeds.clone(), seeds.clone()
        emit.map_emit(spec, pk, cfg.warmup, emit=False)
        emit.map_emit_plain(spec, pp, cfg.warmup, emit=False)
        err = max(err, _check_equal(f"{preset} warm-up state", pk, pp))
        for c in range(chunks):
            fk, qk = emit.map_emit(spec, pk, CHUNK)
            fp, qp = emit.map_emit_plain(spec, pp, CHUNK)
            err = max(err, _check_equal(f"{preset} chunk {c} flat", fk, fp),
                      _check_equal(f"{preset} chunk {c} packed", qk, qp),
                      _check_equal(f"{preset} chunk {c} state", pk, pp))
        oob = float((fk == W * H).float().mean())
        print(f"[A] {preset}, angle {angle}: warm-up + {chunks} x {CHUNK} steps at "
              f"{lanes} lanes bit-identical (out of bounds {oob:.3f}, pixel-0 share "
              f"{float((fk == 0).float().mean()):.3f})")
    # timing at the flagship chunk shape
    cfg = sat.presets.poisson_saturne(width=W, height=H)
    spec = emit.emit_spec(cfg, 0.0)
    pts = torch.from_numpy((rng.random((3, LANES)) * 0.1).astype(np.float32)).to(dev)
    emit.map_emit(spec, pts, cfg.warmup, emit=False)
    ms = _time_ms(lambda: emit.map_emit(spec, pts, CHUNK), reps=20)
    plain_ms = _time_ms(lambda: emit.map_emit_plain(spec, pts, CHUNK), reps=3, warm=1)
    print(f"[A] {LANES} lanes x {CHUNK} steps: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "spec": spec, "pts": pts}


def phase_kernel_b(sat, dev, a: dict) -> dict:
    from strange_attractor_tpu_torch.ops import emit
    from strange_attractor_tpu_torch.ops.binning import bin_chunk_packed
    from strange_attractor_tpu_torch.ops.kernel_binning import bin_chunk_kernel

    npix, m = W * H, LANES * CHUNK
    rng = np.random.default_rng(1)

    def u32(n, hi=2**32):
        return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32).view(np.int32)

    def stream(flat, packed):
        return (torch.from_numpy(flat.astype(np.int32)).to(dev),
                torch.from_numpy(packed).to(dev))

    flat = rng.integers(0, npix, m)
    flat[rng.random(m) < 0.05] = npix
    cases = {"random 5% oob": [stream(flat, u32(m))],
             "heavy duplicates and ties": [stream(rng.integers(0, 50, m), u32(m, 8))]}
    flood = rng.integers(0, npix, m)
    flood[rng.random(m) < 0.40] = 0
    cases["40% pixel-0 flood"] = [stream(flood, u32(m))]
    cases["all out of bounds"] = [stream(np.full(m, npix), u32(m))]
    cases["3 chunks accumulated"] = [stream(rng.integers(0, npix + 1, m), u32(m))
                                     for _ in range(3)]
    cases["ragged 1000003 points"] = [stream(rng.integers(0, npix + 1, 1_000_003),
                                             u32(1_000_003))]
    err = 0.0
    for name, chunks in cases.items():
        start = (torch.from_numpy(u32(npix, 1000)).to(dev), torch.from_numpy(u32(npix)).to(dev))
        ck, qk = start[0].clone(), start[1].clone()
        cp, qp = start
        for f, p in chunks:
            ck, qk = bin_chunk_kernel(ck, qk, f, p)
            cp, qp = bin_chunk_packed(cp, qp, f, p)
        err = max(err, _check_equal(f"{name} count", ck, cp),
                  _check_equal(f"{name} packed", qk, qp))
        print(f"[B] {name}: {len(chunks)} x {chunks[0][0].numel()} points over {npix} px "
              f"bit-identical")
    # timing on a real flagship chunk stream
    f, p = emit.map_emit(a["spec"], a["pts"], CHUNK)
    count = torch.zeros(npix, dtype=torch.int32, device=dev)
    packed = torch.zeros_like(count)
    ms = _time_ms(lambda: bin_chunk_kernel(count, packed, f, p), reps=20)
    plain_ms = _time_ms(lambda: bin_chunk_packed(count, packed, f, p), reps=5, warm=1)
    print(f"[B] M={m} points, npix={npix}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"err": err, "ms": ms, "plain_ms": plain_ms}


def _flagship(sat, iterations: int, **kw):
    return sat.presets.poisson_saturne(
        iterations=iterations, width=W, height=H, seed=1, transparent=False,
        colors=sat.Colors(brightness=sat.BrightnessConstants(offset=-0.25)), **kw)


def _deliver(sat, cfg, state, out_base: Path):
    """colorize -> 8-bit conversion on the card -> one host copy -> PNG;
    returns (path, host image)."""
    from strange_attractor_tpu_torch.utils.export import convert_format_device, to_host, write_image

    image = to_host(convert_format_device(sat.colorize(cfg, state), False, True))
    return write_image(out_base, image, transparent=False, eight_bit=True), image


def _counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name."""
    from strange_attractor_tpu_torch.ops import emit, kernel_binning as kb

    return {"map_emit": emit.map_emit, "project_emit": emit.project_emit,
            "bin_packed": kb.bin_chunk_kernel, "bin_depth": kb.bin_chunk_kernel_depth,
            "bin_exact": kb.bin_chunk_kernel_exact, "bin_exact16": kb.bin_chunk_kernel_exact16}


def _zero_counters() -> dict:
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def _require_launches(tag: str, counters: dict, kernels: tuple) -> dict:
    launches = {name: counters[name].launches for name in kernels}
    if min(launches.values()) < 1:
        raise AssertionError(f"{tag}: the run did not go through every kernel: {launches}")
    return launches


def _drive(sat, dev, cfg, out_base: Path, card: str, tag: str, kernels: tuple) -> dict:
    """One frame through the user's entry points with every launch count at
    0 just before it: render -> colorize -> 8-bit convert -> one host copy
    -> PNG. Raises unless each of ``kernels`` launched and the image is lit."""
    from strange_attractor_tpu_torch.ops.binning import u32

    lanes, chunk, nchunks = sat.plan_schedule(cfg)
    executed = lanes * chunk * nchunks
    counters = _zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = sat.render(cfg, device=dev)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    path, img = _deliver(sat, cfg, state, out_base)
    wall = time.perf_counter() - t0
    launches = _require_launches(tag, counters, kernels)
    if state.count is not None:
        total = int(u32(state.count).sum())
        if not 0 < total <= executed:
            raise AssertionError(f"{tag}: count.sum() {total} outside (0, {executed}]")
    lit = float((img.max(axis=-1) > 0).mean())
    if not lit > 0.10:
        raise AssertionError(f"{tag}: image nearly blank: lit fraction {lit}")
    print(f"{tag} {W}x{H} {cfg.iterations:.0e}: {lanes} lanes x {chunk} steps x {nchunks} chunks = "
          f"{executed} iterations, lit {lit:.3f}, launches {launches}, "
          f"wrote {path.stat().st_size} bytes")
    print(f"{tag} render {t_render:.4f} s = {executed / t_render:.4e} iters/s; end-to-end wall "
          f"{wall:.4f} s (render + colorize + convert + host copy + PNG) on {card}")
    return {"launches": launches, "t_render": t_render, "wall": wall, "executed": executed}


def phase_slice(sat, dev, out_dir: Path, card: str) -> dict:
    return _drive(sat, dev, _flagship(sat, 100_000_000), out_dir / "frame", card, "[4] flagship",
                  ("map_emit", "bin_packed"))


def phase_twins(sat, dev, out_dir: Path) -> None:
    cfg = _flagship(sat, 1_000_000)
    lanes, chunk, _ = sat.plan_schedule(cfg)
    cfg = cfg.replace(lanes=lanes, chunk_steps=chunk, bin_strategy=sat.BinStrategy.KERNEL)
    kern = sat.render(cfg, device=dev)
    plain = sat.render(cfg.replace(bin_strategy=sat.BinStrategy.PACKED), device=dev)
    for name in ("count", "packed"):
        _check_equal(f"1e6 render {name} plane", getattr(kern, name), getattr(plain, name))
    pk = _deliver(sat, cfg, kern, out_dir / "kernel")[0].read_bytes()
    pp = _deliver(sat, cfg, plain, out_dir / "plain")[0].read_bytes()
    if pk != pp:
        raise AssertionError("kernel and plain renders wrote different PNG bytes")
    print(f"[5] 1e6 render: kernels and plain twins give identical planes and PNG "
          f"({len(pk)} bytes)")


def phase_emit_modes(sat, dev) -> dict:
    from strange_attractor_tpu_torch.ops import emit

    err, ms = 0.0, {}
    rng = np.random.default_rng(2)
    for preset in ("poisson-saturne", "solar-sail"):
        cfg = sat.presets.by_name(preset, width=W, height=H)
        spec = emit.emit_spec(cfg, 0.0)
        warm = torch.from_numpy((rng.random((3, LANES)) * 0.1).astype(np.float32)).to(dev)
        emit.map_emit(spec, warm, cfg.warmup, emit=False)
        for kind in (sat.BinStrategy.DEPTH, sat.BinStrategy.EXACT):
            pk, pp = warm.clone(), warm.clone()
            for c in range(2):
                got = emit.map_emit(spec, pk, CHUNK, kind=kind)
                want = emit.map_emit_plain(spec, pp, CHUNK, kind=kind)
                for name, g, w in zip(("flat", "z", "val"), got, want):
                    err = max(err, _check_equal(f"{preset} {kind.value} chunk {c} {name}", g, w))
                err = max(err, _check_equal(f"{preset} {kind.value} chunk {c} state", pk, pp))
            print(f"[6] {preset}: {kind.value} emission, 2 x {CHUNK} steps at {LANES} lanes "
                  f"bit-identical (z and val at full float32)")
            if preset == "poisson-saturne":
                ms[kind.value] = _time_ms(lambda: emit.map_emit(spec, pk, CHUNK, kind=kind), 20)
    print(f"[6] {LANES} lanes x {CHUNK} steps: kernel A depth {ms['depth']:.4f} ms, "
          f"exact {ms['exact']:.4f} ms")
    return {"err": err, "ms": ms}


def _f16_probe(dev) -> None:
    """What torch's own float16 cast does with NaN payloads on the card,
    beside the bit conversion the EXACT16 kernel and its twin use."""
    from strange_attractor_tpu_torch.ops.binning import f16_bits

    bits = np.array([0x7FC00001, 0xFFC12345, 0x7F800001, 0x7F802000, 0x477FF000, 0x33000001],
                    np.uint32)
    f = torch.from_numpy(bits.view(np.float32)).to(dev)
    hw = (f.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF).tolist()
    sw = f16_bits(f).tolist()
    pairs = ", ".join(f"{b:#010x}: cast {h:#06x} bits {w:#06x}" for b, h, w in zip(bits, hw, sw))
    print(f"[7] f32 -> f16 on the card ({pairs})")


def _bin_cases(dev, npix: int, m: int, rng) -> dict:
    """(flat, z, val) chunk lists on the card: phase 3's cases, z ties with
    both zero signs, special floats, and three chunks for a standing state."""
    special = np.array([0.0, -0.0, -1.0, 1.0, np.inf, -np.inf, np.nan, -1e-45, 1e-40,
                        -1.0000001, 3.4028235e38, 65520.0, 6e-8], np.float32)

    def chunk(flat, z=None, val=None):
        n = len(flat)
        z = rng.normal(0, 0.5, n).astype(np.float32) if z is None else z
        val = rng.random(n).astype(np.float32) if val is None else val
        return tuple(torch.from_numpy(a).to(dev) for a in (flat.astype(np.int32), z, val))

    def ties(n):
        z = (rng.integers(-2, 3, n) * 0.25).astype(np.float32)
        z[rng.random(n) < 0.2] = -0.0
        return chunk(rng.integers(0, 50, n), z, (rng.integers(0, 8, n) / 8).astype(np.float32))

    flat = rng.integers(0, npix, m)
    flat[rng.random(m) < 0.05] = npix
    flood = rng.integers(0, npix, m)
    flood[rng.random(m) < 0.40] = 0
    return {
        "random 5% oob": [chunk(flat)],
        "z ties and both zero signs on 50 px": [ties(m)],
        "special floats on 64 px": [chunk(rng.integers(0, 64, m), rng.choice(special, m),
                                          rng.choice(special, m))],
        "40% pixel-0 flood": [chunk(flood)],
        "all out of bounds": [chunk(np.full(m, npix))],
        "3 chunks onto a standing state": [ties(m), chunk(rng.integers(0, npix + 1, m)),
                                           chunk(rng.integers(0, 64, m), rng.choice(special, m))],
        "ragged 1000003 points": [chunk(rng.integers(0, npix + 1, 1_000_003))],
    }


def _standing(dev, npix: int, rng, blank: bool):
    """EXACT planes (count, steps, zbuf): blank, or random with sentinels,
    -0.0 and +0.0 bands and z values the ties case hits exactly."""
    if blank:
        return (torch.zeros(npix, dtype=torch.int32, device=dev),
                torch.zeros(npix, dtype=torch.float32, device=dev),
                torch.full((npix,), -1.0, dtype=torch.float32, device=dev))
    zbuf = rng.normal(0, 0.5, npix).astype(np.float32)
    zbuf[rng.random(npix) < 0.3] = -1.0
    zbuf[:50] = (rng.integers(-2, 3, 50) * 0.25).astype(np.float32)
    zbuf[50:80] = -0.0
    zbuf[80:100] = 0.0
    return tuple(torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 1000, npix).astype(np.int32), rng.random(npix).astype(np.float32), zbuf))


def phase_bins(sat, dev, a: dict) -> dict:
    from strange_attractor_tpu_torch.ops import binning, emit, kernel_binning as kb

    npix, m = W * H, LANES * CHUNK
    rng = np.random.default_rng(3)
    _f16_probe(dev)
    scratch = kb.new_scratch(npix, dev)
    # name -> (kernel, twin, planes: "depth" or "exact")
    bins = {
        "bin_depth": (kb.bin_chunk_kernel_depth, binning.bin_chunk_depth, "depth"),
        "bin_exact": (lambda *p: kb.bin_chunk_kernel_exact(*p, scratch=scratch),
                      binning.bin_chunk_exact, "exact"),
        "bin_exact16_value": (
            lambda *p: kb.bin_chunk_kernel_exact16(*p, ties="value", scratch=scratch),
            lambda *p: binning.bin_chunk_exact16(*p, ties="value"), "exact"),
        "bin_exact16_earliest": (
            lambda *p: kb.bin_chunk_kernel_exact16(*p, ties="earliest", scratch=scratch),
            lambda *p: binning.bin_chunk_exact16(*p, ties="earliest"), "exact"),
    }
    cases = _bin_cases(dev, npix, m, rng)
    out = {}
    for name, (kernel, twin, planes) in bins.items():
        for case, chunks in cases.items():
            start = _standing(dev, npix, rng, blank=not case.startswith("3 chunks"))
            if planes == "depth":
                start = start[2:]
            pk, pt = tuple(p.clone() for p in start), start
            for f, z, v in chunks:
                stream = (f, z) if planes == "depth" else (f, z, v)
                pk = kernel(*pk, *stream)
                pt = twin(*pt, *stream)
            for i, (g, w) in enumerate(zip(pk, pt)):
                _check_equal(f"{name} {case} plane {i}", g, w)
            if not bool((scratch == -1).all()):
                raise AssertionError(f"{name} {case}: the scratch plane was left dirty")
        print(f"[7] {name}: {len(cases)} cases over {npix} px bit-identical to its plain twin")
        # timing on a real flagship chunk stream of the matching emission
        pts = a["pts"].clone()
        kind = sat.BinStrategy.DEPTH if planes == "depth" else sat.BinStrategy.EXACT
        stream = emit.map_emit(a["spec"], pts, CHUNK, kind=kind)
        state = _standing(dev, npix, rng, blank=True)
        state = state[2:] if planes == "depth" else state
        ms = _time_ms(lambda: kernel(*state, *stream), reps=20)
        plain_ms = _time_ms(lambda: twin(*state, *stream), reps=5, warm=1)
        print(f"[7] {name}: M={m} points, npix={npix}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        out[name] = {"err": 0.0, "ms": ms, "plain_ms": plain_ms}
    return out


def phase_paths(sat, dev, out_dir: Path, card: str) -> dict:
    depth = _flagship(sat, 100_000_000, render=sat.RenderKind.DEPTH)
    if depth.resolved_bin_strategy() != sat.BinStrategy.DEPTH_KERNEL:
        raise AssertionError("AUTO did not resolve to DEPTH_KERNEL for a depth render")
    runs = {"bin_depth": _drive(sat, dev, depth, out_dir / "depth", card, "[8] depth flagship",
                                ("map_emit", "bin_depth"))}
    exact = _flagship(sat, 100_000_000, bin_strategy=sat.BinStrategy.EXACT_KERNEL)
    runs["bin_exact"] = _drive(sat, dev, exact, out_dir / "exact", card, "[8] exact-kernel",
                               ("map_emit", "bin_exact"))
    for ties in ("value", "earliest"):
        cfg = _flagship(sat, 100_000_000, bin_strategy=sat.BinStrategy.EXACT16_KERNEL,
                        exact16_ties=ties)
        runs[f"bin_exact16_{ties}"] = _drive(sat, dev, cfg, out_dir / f"exact16_{ties}", card,
                                             f"[8] exact16-kernel ties={ties}",
                                             ("map_emit", "bin_exact16"))
    return runs


def phase_path_twins(sat, dev, out_dir: Path) -> None:
    from strange_attractor_tpu_torch.ops import emit
    from strange_attractor_tpu_torch.render import seed_generator

    B = sat.BinStrategy
    pairs = [("DEPTH_KERNEL vs DEPTH", dict(render=sat.RenderKind.DEPTH),
              B.DEPTH_KERNEL, B.DEPTH),
             ("EXACT_KERNEL vs EXACT", {}, B.EXACT_KERNEL, B.EXACT),
             ("EXACT16_KERNEL value vs twins", dict(exact16_ties="value"),
              B.EXACT16_KERNEL, None),
             ("EXACT16_KERNEL earliest vs twins", dict(exact16_ties="earliest"),
              B.EXACT16_KERNEL, None)]
    for label, kw, kernel, plain in pairs:
        cfg = _flagship(sat, 1_000_000, bin_strategy=kernel, **kw)
        lanes, chunk, _ = sat.plan_schedule(cfg)
        cfg = cfg.replace(lanes=lanes, chunk_steps=chunk)
        seeds = emit.seed_points(lanes, seed_generator(cfg)).to(dev)
        kern = sat.render_seeds(cfg, seeds)
        twin = (sat.render_seeds(cfg, seeds, plain=True) if plain is None
                else sat.render_seeds(cfg.replace(bin_strategy=plain), seeds))
        for name, g in kern._asdict().items():
            if g is not None:
                _check_equal(f"[9] {label} {name} plane", g, getattr(twin, name))
        pk = _deliver(sat, cfg, kern, out_dir / "kernel")[0].read_bytes()
        pp = _deliver(sat, cfg, twin, out_dir / "plain")[0].read_bytes()
        if pk != pp:
            raise AssertionError(f"[9] {label}: kernel and plain renders wrote different PNGs")
        print(f"[9] 1e6 render {label}: identical planes and PNG ({len(pk)} bytes)")



def _check_streams(tag: str, got, want) -> float:
    if len(got) != len(want):
        raise AssertionError(f"{tag}: {len(got)} streams, want {len(want)}")
    return max(_check_equal(f"{tag} stream {i}", g, w) for i, (g, w) in enumerate(zip(got, want)))


# the rotation cell's schedule: 1e7 iterations a frame (plan_schedule)
SEQ_LANES, SEQ_CHUNK = 2048, 1628


def phase_shared_emit(sat, dev) -> dict:
    from strange_attractor_tpu_torch.ops import emit

    B = sat.BinStrategy
    err = 0.0
    rng = np.random.default_rng(4)
    angles = (0.0, math.radians(97.3), math.radians(222.5))
    for preset in ("poisson-saturne", "solar-sail"):
        cfg = sat.presets.by_name(preset, width=W, height=H)
        spec0 = emit.emit_spec(cfg, 0.0)
        specs = [emit.emit_spec(cfg, a) for a in angles]
        warm = torch.from_numpy((rng.random((3, LANES)) * 0.1).astype(np.float32)).to(dev)
        emit.map_emit(spec0, warm, cfg.warmup, emit=False)
        for kind in (B.PACKED, B.DEPTH, B.EXACT):
            pk, pp = warm.clone(), warm.clone()
            fused = [warm.clone() for _ in angles]
            for c in range(2):
                tag = f"[10] {preset} {kind.value} chunk {c}"
                sk = emit.map_emit_shared(spec0, pk, CHUNK, kind=kind)
                sp = emit.map_emit_shared_plain(spec0, pp, CHUNK, kind=kind)
                err = max(err, _check_streams(f"{tag} shared", sk, sp),
                          _check_equal(f"{tag} state", pk, pp))
                for a, spec, pf in zip(angles, specs, fused):
                    fk = emit.project_emit(spec, sk, kind=kind)
                    err = max(err, _check_streams(f"{tag} frame {a:.4f}", fk,
                                                  emit.project_emit_plain(spec, sp, kind=kind)),
                              _check_streams(f"{tag} frame {a:.4f} vs fused", fk,
                                             emit.map_emit(spec, pf, CHUNK, kind=kind)))
            print(f"[10] {preset}: {kind.value} shared emission + 3 frames, 2 x {CHUNK} steps "
                  f"at {LANES} lanes bit-identical to the twins and to the fused kernel")
    # the rotation cell's chunk: 2048 lanes x 1628 steps, 3,334,144 points
    cfg = sat.presets.poisson_saturne(width=W, height=H)
    spec0, spec = emit.emit_spec(cfg, 0.0), emit.emit_spec(cfg, angles[2])
    pts = torch.from_numpy((rng.random((3, SEQ_LANES)) * 0.1).astype(np.float32)).to(dev)
    emit.map_emit(spec0, pts, cfg.warmup, emit=False)
    pk, pp, pf = pts.clone(), pts.clone(), pts.clone()
    sk = emit.map_emit_shared(spec0, pk, SEQ_CHUNK)
    sp = emit.map_emit_shared_plain(spec0, pp, SEQ_CHUNK)
    fk = emit.project_emit(spec, sk)
    err = max(err, _check_streams("[10] cell chunk shared", sk, sp),
              _check_equal("[10] cell chunk state", pk, pp),
              _check_streams("[10] cell chunk frame", fk, emit.project_emit_plain(spec, sp)),
              _check_streams("[10] cell chunk frame vs fused", fk, emit.map_emit(spec, pf,
                                                                                  SEQ_CHUNK)))
    ms = {"shared": _time_ms(lambda: emit.map_emit_shared(spec0, pts, SEQ_CHUNK), reps=10),
          "shared_plain": _time_ms(lambda: emit.map_emit_shared_plain(spec0, pts, SEQ_CHUNK),
                                   reps=1, warm=0),
          "project": _time_ms(lambda: emit.project_emit(spec, sk), reps=50),
          "project_plain": _time_ms(lambda: emit.project_emit_plain(spec, sk), reps=10, warm=1)}
    print(f"[10] cell chunk {SEQ_LANES} lanes x {SEQ_CHUNK} steps bit-identical; kernel A shared "
          f"{ms['shared']:.4f} ms, plain {ms['shared_plain']:.4f} ms; project_emit "
          f"{ms['project']:.4f} ms, plain {ms['project_plain']:.4f} ms")
    return {"err": err, "ms": ms}


SEQ_ANGLES = (0.0, 45.0, 90.0, 135.0, 180.0, 222.5, 270.0, 315.0)


def phase_sequence_twins(sat, dev) -> None:
    from strange_attractor_tpu_torch.ops import emit
    from strange_attractor_tpu_torch.render import frame_generator
    from strange_attractor_tpu_torch.utils.export import convert_format_device, to_host

    B = sat.BinStrategy
    rad = np.radians(SEQ_ANGLES)
    for label, kw in (("KERNEL", {}), ("DEPTH_KERNEL", dict(render=sat.RenderKind.DEPTH)),
                      ("EXACT_KERNEL", dict(bin_strategy=B.EXACT_KERNEL)),
                      ("EXACT16_KERNEL value", dict(bin_strategy=B.EXACT16_KERNEL)),
                      ("EXACT16_KERNEL earliest", dict(bin_strategy=B.EXACT16_KERNEL,
                                                       exact16_ties="earliest"))):
        cfg = _flagship(sat, 1_000_000, **kw)
        seeds = emit.seed_points(sat.plan_schedule(cfg)[0], frame_generator(cfg, 0)).to(dev)
        kern = sat.render_seeds_shared(cfg, seeds, rad)
        plain = sat.render_seeds_shared(cfg, seeds, rad, plain=True)
        frames = sat.render_sequence_shared(cfg, SEQ_ANGLES, transparent=False, eight_bit=True,
                                            device=dev)
        for f, a in enumerate(rad):
            single = sat.render_seeds(cfg, seeds, angle=float(a))
            for name, w in single._asdict().items():
                if w is not None:
                    _check_equal(f"[11] {label} frame {f} {name} (kernels)",
                                 getattr(kern[f], name), w)
                    _check_equal(f"[11] {label} frame {f} {name} (plain twins)",
                                 getattr(plain[f], name), w)
            want = to_host(convert_format_device(sat.colorize(cfg, single), False, True))
            if not np.array_equal(frames[f], want):
                raise AssertionError(f"[11] {label}: delivered frame {f} differs from its render")
        print(f"[11] 1e6 shared sequence {label}: {len(rad)} frames bit-identical to render_seeds "
              f"on the kernel and the plain-twin route")


def _idle_share(fn) -> tuple:
    """(device busy ms, traced wall ms) of ``fn`` under torch.profiler: the
    union of the device's activity intervals against the host's
    synchronized wall. None when the trace holds no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return None, wall
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy, lo = busy + hi - lo, start
        hi = max(hi, end)
    return (busy + hi - lo) / 1e3, wall


def phase_sequence_cell(sat, dev, out_dir: Path, card: str) -> dict:
    from strange_attractor_tpu_torch.render import _auto_frames_per_batch
    from strange_attractor_tpu_torch.utils.export import write_image
    from strange_attractor_tpu_torch.utils.sequencing import angle_iter

    cfg = _flagship(sat, 10_000_000)
    angles = list(angle_iter(0.0, 360.0, 3.0))
    lanes, chunk, nchunks = sat.plan_schedule(cfg)
    if (lanes, chunk) != (SEQ_LANES, SEQ_CHUNK):
        raise AssertionError(f"[12] schedule {lanes} x {chunk}, phase 10 timed "
                             f"{SEQ_LANES} x {SEQ_CHUNK}")
    runs, out = {}, {}
    engines = (("shared", sat.render_sequence_shared, ("map_emit", "project_emit", "bin_packed")),
               ("per-frame", sat.render_sequence_batched, ("map_emit", "bin_packed")))
    for name, engine, kernels in engines:
        for rep in range(2):
            counters = _zero_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames = engine(cfg, angles, transparent=False, eight_bit=True, device=dev)
            wall = time.perf_counter() - t0
            launches = _require_launches(f"[12] {name}", counters, kernels)
            if frames.shape != (len(angles), H, W, 3) or frames.dtype != np.uint8:
                raise AssertionError(f"[12] {name}: frames {frames.shape} {frames.dtype}")
            print(f"[12] {name} orbit: {len(angles)} frames x {cfg.iterations:.0e} iterations "
                  f"({lanes} lanes x {chunk} steps x {nchunks} chunks) in {wall:.4f} s = "
                  f"{len(angles) / wall:.4f} frames/s (render + colorize + convert + host copy), "
                  f"launches {launches}, rep {rep} on {card}")
            runs.setdefault(name, []).append({"s": wall, "frames_per_s": len(angles) / wall,
                                              "launches": launches})
        out[name] = frames
    # the first frame of each shared batch draws the per-frame engine's seeds
    batch = _auto_frames_per_batch(cfg, cfg.resolved_bin_strategy())
    for f in range(0, len(angles), batch):
        if not np.array_equal(out["shared"][f], out["per-frame"][f]):
            raise AssertionError(f"[12] frame {f} differs between the shared and per-frame "
                                 f"engines")
    for name, engine, _ in engines:
        busy, wall = _idle_share(lambda: engine(cfg, angles[:batch], transparent=False,
                                                eight_bit=True, device=dev))
        idle = "not measured (no device activity in the trace)" if busy is None else \
            f"device busy {busy:.2f} ms, idle share {1 - busy / wall:.4f}"
        print(f"[12] {name} orbit, one traced batch of {batch} frames: wall {wall:.2f} ms, {idle}")
        runs[name + "_trace"] = {"busy_ms": busy, "wall_ms": wall}
    # two frames to PNG: encoding all 120 would take the host tens of seconds
    for f in (0, len(angles) // 2):
        img = out["shared"][f]
        lit = float((img.max(axis=-1) > 0).mean())
        if not lit > 0.10:
            raise AssertionError(f"[12] shared frame {f} nearly blank: lit fraction {lit}")
        path = write_image(out_dir / f"seq_{f}", img, transparent=False, eight_bit=True)
        print(f"[12] shared frame {f} at {angles[f]} degrees: lit {lit:.3f}, "
              f"{path.stat().st_size} bytes")
    return runs


_SOURCE = "strange_attractor_tpu_torch/csrc/"
_TPU = "strange_attractor_tpu/ops/kernel_binning.py:"
# kernel row -> (source, replaces, path run that reports its launches)
_NEW_ROWS = {
    "bin_depth": ("bin_depth.cu", _TPU + "735", "bin_depth"),
    "bin_exact": ("bin_exact.cu", _TPU + "542", "bin_exact"),
    "bin_exact16_value": ("bin_exact16.cu", _TPU + "584", "bin_exact16"),
    "bin_exact16_earliest": ("bin_exact16.cu", _TPU + "584", "bin_exact16"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this check needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import strange_attractor_tpu_torch as sat
    from strange_attractor_tpu_torch.ops import cuda_lib

    dev = torch.device("cuda", 0)
    card = _card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t = time.perf_counter()
    cuda_lib.library()
    print(f"[1] built and loaded {cuda_lib.library_path().name} in "
          f"{time.perf_counter() - t:.2f} s")
    a = phase_kernel_a(sat, dev)
    b = phase_kernel_b(sat, dev, a)
    with tempfile.TemporaryDirectory() as tmp:
        s = phase_slice(sat, dev, Path(tmp), card)
        phase_twins(sat, dev, Path(tmp))
        modes = phase_emit_modes(sat, dev)
        bins = phase_bins(sat, dev, a)
        runs = phase_paths(sat, dev, Path(tmp), card)
        phase_path_twins(sat, dev, Path(tmp))
        shared = phase_shared_emit(sat, dev)
        phase_sequence_twins(sat, dev)
        seq = phase_sequence_cell(sat, dev, Path(tmp), card)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    kernels = [
        {"name": "map_emit", "route": "cuda",
         "source": "strange_attractor_tpu_torch/csrc/map_emit.cu",
         "replaces": "strange_attractor_tpu/render.py:410",
         "launches": s["launches"]["map_emit"],
         "max_abs_err": max(a["err"], modes["err"], shared["err"]),
         "ms": a["ms"], "plain_ms": a["plain_ms"]},
        {"name": "bin_packed", "route": "cuda",
         "source": "strange_attractor_tpu_torch/csrc/bin_packed.cu",
         "replaces": "strange_attractor_tpu/ops/kernel_binning.py:475",
         "launches": s["launches"]["bin_packed"], "max_abs_err": b["err"],
         "ms": b["ms"], "plain_ms": b["plain_ms"]},
    ]
    for name, (source, replaces, counter) in _NEW_ROWS.items():
        kernels.append({"name": name, "route": "cuda", "source": _SOURCE + source,
                        "replaces": replaces, "launches": runs[name]["launches"][counter],
                        "max_abs_err": bins[name]["err"], "ms": bins[name]["ms"],
                        "plain_ms": bins[name]["plain_ms"]})
    kernels.append({"name": "project_emit", "route": "cuda", "source": _SOURCE + "project_emit.cu",
                    "replaces": "strange_attractor_tpu/render.py:246",
                    "launches": seq["shared"][-1]["launches"]["project_emit"],
                    "max_abs_err": shared["err"], "ms": shared["ms"]["project"],
                    "plain_ms": shared["ms"]["project_plain"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
