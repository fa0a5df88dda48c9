#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA Hopper card.

Run from the root of the repository, on a machine with one H100:

    python3 chip_smoke.py

Phases (each raises on failure; the last line is the JSON result only when
all passed):

1. card name and power limit, torch/CUDA versions, kernel build from csrc/;
2. kernel A (csrc/map_emit.cu) against its plain twin on the card, PACKED
   and SHARED emission, streams and lane state bit-identical after the
   warm-up and each chunk: 32768 lanes x 128 steps (poisson-saturne;
   solar-sail's escaping orbits too) and x 77 steps (a ragged tail), 16384
   lanes x 128 and x 77 steps, a ragged 1000-lane batch of 77-step chunks
   at another angle -- every kernel its launcher picks on a 132-SM card;
3. kernel B (csrc/bin_packed.cu) against plain bin_chunk_packed on the card,
   bit-identical: random 4M-point stream over 1920x1080 with 5% out of
   bounds, heavy duplicates and ties, a 40% pixel-0 flood, pixel 0 mixing
   escaped (packed 0) and winning points above and below chunk/64, all out
   of bounds, accumulation over 3 chunks, a ragged 1000003-point stream,
   three solar-sail 1800x2000 chunks from kernel A;
   then kernel and twin timed as a render meets them (see _honest_bin: 20
   distinct consecutive chunks onto the state of the first 100, after one
   discarded pass over them, CUDA events around each) on the flagship and
   on solar-sail 1800x2000, with the
   pixel-0 share, and torch.bincount / scatter_reduce_ "amax" timed on the
   same chunks of both as the library yardstick;
4. the flagship slice: poisson-saturne 1920x1080 Gas, 8-bit, seed 1, 1e8
   iterations, render -> colorize -> convert -> one host copy -> PNG, with
   both launch counters > 0 and a non-blank image; iters/s and wall time,
   split into render, colorize + convert, host copy and PNG encode, for
   the process's first frame and for a second, warm one; which
   PNG encoder ran (native or stdlib) and that frame's encode through the
   package's writer against the stdlib route;
5. the same seeded render at 1e6 iterations through the kernels and through
   the plain twins on the card: identical planes and PNG bytes;
6. kernel A in DEPTH (flat, z) and EXACT (flat, z, val) emission against
   its plain twin at 32768 lanes, every float bit identical: warm-up + 2
   chunks, poisson-saturne and solar-sail; the time of each mode;
7. the bin kernels of the fidelity and depth modes (csrc/bin_depth.cu,
   csrc/bin_exact.cu, csrc/bin_exact16.cu in both tie modes) against their
   plain twins on the card, bit-identical, at the flagship chunk (4,194,304
   points over 1920x1080): phase 3's cases plus z ties with both zero
   signs, special floats (+-0, +-inf, NaN, -1.0), three chunks onto a
   non-blank standing state holding -0.0 and exact z ties, and what a bin
   by canvas tiles must get right: pixel 0 mixing escaped and winning
   points above and below chunk/64, every point in one run and in one
   tile, ties on the edges of runs and tiles, a 37x23 canvas (smaller than
   a tile), 1800x2000 and 3840x2160 (more tiles than SMs), 7680x4320 (two
   bands of tiles), a 140M-point chunk with NaN depths (more spans than
   the partition's table has at least), three solar-sail
   1800x2000 chunks from kernel A in EXACT emission, and streams as a
   caller may hand them (a ragged 203-point stream, views one word past a
   16-byte boundary and at three offsets), NaN keys
   of both signs flooding pixel 0 above and below chunk/64, both zeros onto
   a standing -0.0 at pixel 0; the tile bins' control
   words all zero after every launch; each kernel and twin timed as phase
   3 times bin_packed, on its own strategy's flagship render and on
   solar-sail 1800x2000 with the pixel-0 share, and
   scatter_reduce_ "amax" of the depth stream timed the same
   way on both as bin_depth's library yardstick; and what torch's own float16 cast
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
    share of one traced batch of each engine, and all 120 frames encoded to
    PNG through the CLI's encoder threads, timed;
13. 10^9 iterations of each path: the flagship, solar-sail 1800x2000, the
    --depth flagship and solar-sail 1800x2000 through --depth, exact-kernel
    and exact16-kernel (both tie modes),
    solar-sail 1800x2000 through exact-kernel and exact16-kernel, each
    rendered once with every launch count at 0 just before it, then three
    warm synchronized renders for its rate; one more traced render of each
    --depth path for the device's busy time and idle share; and a rotation
    of 100 frames at 10^7 through the shared-orbit engine, its launches
    counted;
14. kernel A for each RK4 map (lorenz, rossler, halvorsen, thomas;
    csrc/map_emit_rk4.cu) and for the Sprott map again against its plain
    twin, streams and lane state bit-identical after the warm-up and each
    of 2 chunks in every mode (PACKED, DEPTH, EXACT, SHARED, SHARED_DEPTH):
    32768 lanes x 128 steps, 16384 x 77, a ragged 1000 x 77 at another
    angle; then each map's PACKED chunk timed at 32768 x 128;
15. each of the nine presets through the CLI entry point at 1920x1080, 1e8
    iterations, 8-bit PNG, seed 1, with every launch count at 0 just before
    it: launches > 0 and a lit image; then 1e6 renders of each of the seven
    the port gained (the RK4 four and the three discovered Sprott maps)
    through the kernels and the plain twins, identical planes, and 2e5 --depth,
    exact-kernel and two-frame shared-orbit renders of the RK4 presets the
    same way;
16. 10^9 iterations of each RK4 preset: launches counted, three warm
    synchronized renders for the rate.

The line before the card's is the ``kernels`` JSON: per kernel its mean
time (``ms``), its twin's (``plain_ms``), its bound from this run's shapes
(``bytes``, ``flops``, ``bound_ms``, ``bound_by``), its launches on the path
run (``launches``) and in phase 13's 10^9 iterations (``launches_per_1e9``; one
wrapper call is one launch; for a bin ``cuda_kernels_per_launch`` says how
many CUDA kernels it started, counted in a trace of the timed chunks, and
``cuda_kernels_us`` each one's mean time), and a PyTorch yardstick (``library_ms``, or null with
``library_note``); kernel A has a row per RK4 map beside the Sprott one.
The line before it holds the encoder that ran, the 1e8 frame's wall split
and the rotation's encode time.

It imports no JAX. It needs one card and exits non-zero without one.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

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
    # every kernel the launcher picks on a 132-SM H100, in PACKED and SHARED
    # emission: one thread per lane from 16896 lanes (the flagship shape,
    # solar-sail's escaping orbits, a ragged tail of 77 = 9 x 8 + 5 steps);
    # the 32-lane ring from 8448 lanes (128 and 77 steps: a partial last
    # tile of 24); the 16-lane ring below (ragged lanes, a partial last
    # block, and ragged steps at another camera angle)
    for preset, chunks, lanes, steps, angle in (("poisson-saturne", 4, LANES, CHUNK, 0.0),
                                                ("solar-sail", 2, LANES, CHUNK, 0.0),
                                                ("poisson-saturne", 2, LANES, 77, 0.0),
                                                ("poisson-saturne", 2, 16384, CHUNK, 0.3),
                                                ("poisson-saturne", 2, 16384, 77, 0.3),
                                                ("poisson-saturne", 2, 1000, 77, 0.7)):
        tag = f"{preset} {lanes} x {steps}"
        cfg = sat.presets.by_name(preset, width=W, height=H)
        spec = emit.emit_spec(cfg, angle)
        seeds = torch.from_numpy((rng.random((3, lanes)) * 0.1).astype(np.float32)).to(dev)
        pk, pp = seeds.clone(), seeds.clone()
        emit.map_emit(spec, pk, cfg.warmup, emit=False)
        emit.map_emit_plain(spec, pp, cfg.warmup, emit=False)
        err = max(err, _check_equal(f"{tag} warm-up state", pk, pp))
        sk, sp = pk.clone(), pp.clone()
        for c in range(chunks):
            fk, qk = emit.map_emit(spec, pk, steps)
            fp, qp = emit.map_emit_plain(spec, pp, steps)
            shared = emit.map_emit_shared(spec, sk, steps)
            err = max(err, _check_equal(f"{tag} chunk {c} flat", fk, fp),
                      _check_equal(f"{tag} chunk {c} packed", qk, qp),
                      _check_equal(f"{tag} chunk {c} state", pk, pp),
                      _check_streams(f"{tag} chunk {c} shared", shared,
                                     emit.map_emit_shared_plain(spec, sp, steps)),
                      _check_equal(f"{tag} chunk {c} shared state", sk, sp))
        oob = float((fk == W * H).float().mean())
        print(f"[A] {preset}, angle {angle}: warm-up + {chunks} x {steps} steps at "
              f"{lanes} lanes bit-identical, packed and shared (out of bounds {oob:.3f}, "
              f"pixel-0 share {float((fk == 0).float().mean()):.3f})")
    # timing at the flagship chunk shape
    cfg = sat.presets.poisson_saturne(width=W, height=H)
    spec = emit.emit_spec(cfg, 0.0)
    pts = torch.from_numpy((rng.random((3, LANES)) * 0.1).astype(np.float32)).to(dev)
    emit.map_emit(spec, pts, cfg.warmup, emit=False)
    ms = _time_ms(lambda: emit.map_emit(spec, pts, CHUNK), reps=20)
    plain_ms = _time_ms(lambda: emit.map_emit_plain(spec, pts, CHUNK), reps=3, warm=1)
    print(f"[A] {LANES} lanes x {CHUNK} steps: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"err": err, "ms": ms, "plain_ms": plain_ms}


# honest bin timing: the planes a render has built after HONEST_WARM chunks,
# then HONEST_TIMED distinct consecutive chunks binned onto them one by one
HONEST_WARM, HONEST_TIMED = 100, 20
# the card's peaks (NVIDIA H100 SXM data sheet): HBM bytes/s, float32 ops/s
PEAK_BYTES, PEAK_OPS = 3.35e12, 67e12
# bytes a bin moves: its stream per point, and per touched pixel each
# plane read once and written once
STREAM_BYTES = {"packed": 8, "depth": 8, "exact": 12}
PLANE_BYTES = {"packed": 16, "depth": 8, "exact": 24}
LIBRARY_NOTE = "no single PyTorch call computes it"


def _bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_OPS * 1e3
    return {"bytes": nbytes, "flops": ops, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def _solar_sail(sat, iterations: int, **kw):
    return sat.presets.solar_sail(iterations=iterations, width=1800, height=2000, seed=1,
                                  transparent=False, **kw)


def _warm_lanes(sat, dev, cfg, spec) -> torch.Tensor:
    """The (3, lanes) points of ``cfg``'s seeded render on the card, after
    its warm-up through kernel A."""
    from strange_attractor_tpu_torch.ops import emit
    from strange_attractor_tpu_torch.render import seed_generator

    lanes = sat.plan_schedule(cfg)[0]
    pts = emit.seed_points(lanes, seed_generator(cfg)).to(dev).t().contiguous()
    emit.map_emit(spec, pts, cfg.warmup, emit=False)
    return pts


def _render_chunks(sat, dev, cfg, bin_fn):
    """(standing planes, chunks): the flat planes of ``cfg``'s seeded render
    after its warm-up and HONEST_WARM chunks of kernel A and ``bin_fn``,
    and the streams of the next HONEST_TIMED chunks, made beforehand."""
    from strange_attractor_tpu_torch.ops import emit
    from strange_attractor_tpu_torch.render import _state_to_planes

    chunk = sat.plan_schedule(cfg)[1]
    kind = cfg.resolved_bin_strategy().planes_kind()
    spec = emit.emit_spec(cfg, cfg.angle)
    pts = _warm_lanes(sat, dev, cfg, spec)
    planes = _state_to_planes(sat.RenderState.create(cfg, device=dev))
    for _ in range(HONEST_WARM):
        planes = bin_fn(*planes, *emit.map_emit(spec, pts, chunk, kind=kind))
    return planes, [emit.map_emit(spec, pts, chunk, kind=kind) for _ in range(HONEST_TIMED)]


def _chunk_ms(fn, planes, chunks) -> list:
    """Device ms of ``fn(*planes, *chunk)`` for each chunk in turn, each
    onto the planes the one before left (a copy of ``planes``), by CUDA
    events around each call. One discarded pass over the same chunks, onto
    another copy, warms the code and the allocator first. A spin kernel
    queued before the timed pass lets the host enqueue it all, so each pair
    of events brackets its call's device work; a plain twin of many
    launches outruns the spin and is timed as a user meets it."""
    state = tuple(p.clone() for p in planes)
    for c in chunks:
        state = fn(*state, *c)
    state = tuple(p.clone() for p in planes)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in chunks]
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    for (start, end), c in zip(events, chunks):
        start.record()
        state = fn(*state, *c)
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def _cuda_kernels(fn, planes, chunks) -> dict:
    """The CUDA kernels that ``fn(*planes, *chunk)`` starts, from a
    torch.profiler trace of one pass over ``chunks`` onto a copy of
    ``planes``: how many a call (``cuda_kernels_per_launch``) and each one's
    mean device time in microseconds (``cuda_kernels_us``). None and empty
    when the trace holds no device activity.

    A trace can lose the first kernels after its start (in a process that
    has used the card for a minute, every other trace lost one to four), so
    a discarded pass over the same chunks comes first, and a spin kernel
    marks where the counted pass begins."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    lead = tuple(p.clone() for p in planes)
    state = tuple(p.clone() for p in planes)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c in chunks:
            lead = fn(*lead, *c)
        torch.cuda._sleep(1000)
        for c in chunks:
            state = fn(*state, *c)
        torch.cuda.synchronize()
    events = sorted((e.time_range.start, e.name, e.time_range.end - e.time_range.start)
                    for e in prof.events() if e.device_type == DeviceType.CUDA
                    and not e.name.startswith(("Memcpy", "Memset")))
    marks = [i for i, (_, name, _) in enumerate(events) if "spin_kernel" in name]
    if not marks:
        return {"cuda_kernels_per_launch": None, "cuda_kernels_us": {}}
    times = {}
    for _, name, us in events[marks[-1] + 1:]:
        times.setdefault(name.split("(")[0], []).append(us)
    return {"cuda_kernels_per_launch": sum(map(len, times.values())) / len(chunks),
            "cuda_kernels_us": {name: sum(us) / len(us) for name, us in times.items()}}


def _honest_bin(sat, dev, cfg, kernel, twin, tag: str) -> dict:
    """A bin kernel and its twin timed as a render meets them: distinct
    consecutive chunks onto a standing state (``_render_chunks``), with the
    row's bound from this run's chunks and the CUDA kernels a launch starts,
    counted in a trace of the same chunks."""
    kind = cfg.resolved_bin_strategy().planes_kind().value
    planes, chunks = _render_chunks(sat, dev, cfg, kernel)
    npix = cfg.width * cfg.height
    ms = _chunk_ms(kernel, planes, chunks)
    plain = _chunk_ms(twin, planes, chunks)
    m = chunks[0][0].numel()
    touched = sum(int(torch.unique(f[(f >= 0) & (f < npix)]).numel()) for f, *_ in chunks)
    touched /= len(chunks)
    share0 = sum(float((f == 0).float().mean()) for f, *_ in chunks) / len(chunks)
    out = {"ms": sum(ms) / len(ms), "ms_range": [min(ms), max(ms)],
           "plain_ms": sum(plain) / len(plain), "points": m, "touched_px": touched,
           "pixel0_share": share0, "planes": planes, "chunks": chunks,
           **_bound(STREAM_BYTES[kind] * m + PLANE_BYTES[kind] * touched, 2.0 * m),
           **_cuda_kernels(kernel, planes, chunks)}
    print(f"{tag} {cfg.width}x{cfg.height}, {len(chunks)} distinct chunks of {m} points onto "
          f"the state of {HONEST_WARM}: kernel {out['ms']:.4f} ms ({min(ms):.4f}-{max(ms):.4f}), "
          f"plain {out['plain_ms']:.4f} ms; bound {out['bound_ms']:.4f} ms by {out['bound_by']} "
          f"({touched:.0f} px touched a chunk), pixel-0 share {share0:.4f}")
    print(f"{tag}: {out['cuda_kernels_per_launch']} CUDA kernels a launch, traced (us each): "
          + ", ".join(f"{k} {v:.1f}" for k, v in out["cuda_kernels_us"].items()))
    return out


def _public(row: dict) -> dict:
    """A timing row without its tensors."""
    return {k: v for k, v in row.items() if k not in ("planes", "chunks")}


def _library_bin_packed(dev, npix: int, planes, chunks, tag: str = "flagship") -> dict:
    """One PyTorch call per half of bin_packed's function on the same
    chunks, timed the same way: torch.bincount of the int32 pixel stream
    (the count half) and scatter_reduce_ "amax" of the u32 updates (the max
    half; int64 carries u32 exactly, and scatter wants int64 indices). The
    port never calls them; they are a yardstick."""
    flats = [(f,) for f, _ in chunks]
    count = _chunk_ms(lambda c, f: (torch.bincount(f, minlength=npix + 1),), planes[:1], flats)
    idx = [(f.long(), (p.long() & 0xFFFFFFFF)) for f, p in chunks]
    plane = torch.zeros(npix + 1, dtype=torch.int64, device=dev)
    plane[:npix] = planes[1].long() & 0xFFFFFFFF
    amax = _chunk_ms(lambda p, i, u: (p.scatter_reduce_(0, i, u, "amax"),), (plane,), idx)
    parts = {"bincount": sum(count) / len(count), "scatter_reduce_amax": sum(amax) / len(amax)}
    print(f"[3] library yardstick, {tag}: torch.bincount {parts['bincount']:.4f} ms, "
          f"scatter_reduce_ amax {parts['scatter_reduce_amax']:.4f} ms a chunk")
    return parts


def _library_bin_depth(dev, npix: int, planes, chunks, tag: str = "flagship") -> float:
    """bin_depth's function as one PyTorch call on the same chunks, timed
    the same way: scatter_reduce_ "amax" of the float32 z stream into the
    zbuf plane with one more cell, which out-of-bounds points (flat = npix)
    land in. It differs from the kernel only in the sign of zero (the
    kernel takes +0.0 over a standing -0.0). The port never calls it."""
    zbuf = torch.full((npix + 1,), -1.0, dtype=torch.float32, device=dev)
    zbuf[:npix] = planes[0]
    idx = [(f.long(), z) for f, z in chunks]
    ms = _chunk_ms(lambda p, i, z: (p.scatter_reduce_(0, i, z, "amax"),), (zbuf,), idx)
    mean = sum(ms) / len(ms)
    print(f"[7] library yardstick, {tag}: scatter_reduce_ amax of float32 z {mean:.4f} ms a "
          f"chunk")
    return mean


def phase_kernel_b(sat, dev) -> dict:
    from strange_attractor_tpu_torch.ops import emit
    from strange_attractor_tpu_torch.ops import kernel_binning as kb
    from strange_attractor_tpu_torch.ops.binning import bin_chunk_packed

    npix, m = W * H, LANES * CHUNK
    rng = np.random.default_rng(1)

    def u32(n, hi=2**32):
        return rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32).view(np.int32)

    def stream(flat, packed):
        return (torch.from_numpy(flat.astype(np.int32)).to(dev),
                torch.from_numpy(packed).to(dev))

    def pixel0(share):
        # pixel 0 mixes escaped points (NaN z: packed 0) and real points
        # whose packed value must win
        flat = rng.integers(0, npix, m)
        at0 = rng.random(m) < share
        flat[at0] = 0
        packed = u32(m)
        packed[at0 & (rng.random(m) < 0.6)] = 0
        return [stream(flat, packed)]

    flat = rng.integers(0, npix, m)
    flat[rng.random(m) < 0.05] = npix
    cases = {"random 5% oob": [stream(flat, u32(m))],
             "heavy duplicates and ties": [stream(rng.integers(0, 50, m), u32(m, 8))]}
    flood = rng.integers(0, npix, m)
    flood[rng.random(m) < 0.40] = 0
    cases["40% pixel-0 flood"] = [stream(flood, u32(m))]
    cases["pixel 0 mixed, 30% (above chunk/64)"] = pixel0(0.30)
    cases["pixel 0 mixed, 1% (below chunk/64)"] = pixel0(0.01)
    cases["all out of bounds"] = [stream(np.full(m, npix), u32(m))]
    cases["3 chunks accumulated"] = [stream(rng.integers(0, npix + 1, m), u32(m))
                                     for _ in range(3)]
    cases["ragged 1000003 points"] = [stream(rng.integers(0, npix + 1, 1_000_003),
                                             u32(1_000_003))]
    # three real solar-sail 1800x2000 chunks from kernel A (its pixel-0 flood)
    sail = _solar_sail(sat, 1_000_000_000)
    spec = emit.emit_spec(sail, 0.0)
    pts = torch.from_numpy((rng.random((3, LANES)) * 0.1).astype(np.float32)).to(dev)
    emit.map_emit(spec, pts, sail.warmup, emit=False)
    cases["solar-sail 1800x2000 stream"] = [emit.map_emit(spec, pts, CHUNK) for _ in range(3)]
    err = 0.0
    for name, chunks in cases.items():
        size = npix if not name.startswith("solar") else sail.width * sail.height
        start = (torch.from_numpy(u32(size, 1000)).to(dev), torch.from_numpy(u32(size)).to(dev))
        ck, qk = start[0].clone(), start[1].clone()
        cp, qp = start
        for f, p in chunks:
            ck, qk = kb.bin_chunk_kernel(ck, qk, f, p)
            cp, qp = bin_chunk_packed(cp, qp, f, p)
        err = max(err, _check_equal(f"{name} count", ck, cp),
                  _check_equal(f"{name} packed", qk, qp))
        share0 = sum(float((f == 0).float().mean()) for f, _ in chunks) / len(chunks)
        print(f"[B] {name}: {len(chunks)} x {chunks[0][0].numel()} points over {size} px "
              f"bit-identical (pixel-0 share {share0:.3f})")
    flag = _honest_bin(sat, dev, _flagship(sat, 1_000_000_000), kb.bin_chunk_kernel,
                       bin_chunk_packed, "[3] bin_packed flagship")
    library = _library_bin_packed(dev, npix, flag["planes"], flag["chunks"])
    sail_row = _honest_bin(sat, dev, sail, kb.bin_chunk_kernel, bin_chunk_packed,
                           "[3] bin_packed solar-sail")
    sail_library = _library_bin_packed(dev, sail.width * sail.height, sail_row["planes"],
                                       sail_row["chunks"], "solar-sail")
    return {"err": err, **_public(flag), "library_ms": sum(library.values()),
            "library_parts": library,
            "solar_sail": {**_public(sail_row), "library_ms": sum(sail_library.values()),
                           "library_parts": sail_library}}


def _flagship(sat, iterations: int, **kw):
    return sat.presets.poisson_saturne(
        iterations=iterations, width=W, height=H, seed=1, transparent=False,
        colors=sat.Colors(brightness=sat.BrightnessConstants(offset=-0.25)), **kw)


def _deliver(sat, cfg, state, out_base: Path, times: Optional[dict] = None):
    """colorize -> 8-bit conversion on the card -> one host copy -> PNG;
    returns (path, host image). ``times`` gets the seconds of each stage."""
    from strange_attractor_tpu_torch.utils.export import convert_format_device, to_host, write_image

    t0 = time.perf_counter()
    image = convert_format_device(sat.colorize(cfg, state), False, True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host = to_host(image)
    t2 = time.perf_counter()
    path = write_image(out_base, host, transparent=False, eight_bit=True)
    if times is not None:
        times.update(colorize_convert=t1 - t0, host_copy=t2 - t1, png=time.perf_counter() - t2)
    return path, host


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
    split = {"render": t_render}
    path, img = _deliver(sat, cfg, state, out_base, split)
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
    print(f"{tag} wall split: render {split['render']:.4f} s, colorize + convert "
          f"{split['colorize_convert']:.4f} s, host copy {split['host_copy']:.4f} s, PNG encode "
          f"{split['png']:.4f} s ({_encoder()} encoder)")
    return {"launches": launches, "t_render": t_render, "wall": wall, "executed": executed,
            "split": split, "image": img}


def phase_slice(sat, dev, out_dir: Path, card: str) -> dict:
    """The flagship frame as the CLI's fresh process meets it (each torch
    op's first call on the card included), then once more, warm."""
    run = _drive(sat, dev, _flagship(sat, 100_000_000), out_dir / "frame", card, "[4] flagship",
                 ("map_emit", "bin_packed"))
    warm = _drive(sat, dev, _flagship(sat, 100_000_000), out_dir / "frame", card,
                  "[4] flagship, warm", ("map_emit", "bin_packed"))
    run["split"] = {"first": run["split"], "warm": warm["split"]}
    return run


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

    err, ms, plain_ms = 0.0, {}, {}
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
                plain_ms[kind.value] = _time_ms(
                    lambda: emit.map_emit_plain(spec, pp, CHUNK, kind=kind), reps=2, warm=1)
    print(f"[6] {LANES} lanes x {CHUNK} steps: kernel A depth {ms['depth']:.4f} ms (plain "
          f"{plain_ms['depth']:.4f}), exact {ms['exact']:.4f} ms (plain {plain_ms['exact']:.4f})")
    return {"err": err, "ms": ms, "plain_ms": plain_ms}


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


def _bin_cases(sat, dev, npix: int, m: int, rng) -> dict:
    """name -> (canvas pixels, [(flat, z, val) chunks on the card]): phase
    3's cases, z ties with both zero signs, special floats, three chunks
    for a standing state, and the streams that a bin by canvas tiles makes
    risky: pixel 0 mixing escaped and winning points, every point in one
    run or one tile, ties on the edges of runs and tiles, a canvas smaller
    than a tile, canvases of more tiles than the card has SMs and of more
    pixels than one band of tiles, a chunk of more spans than the
    partition's table has at least, and real solar-sail chunks; and streams
    as a caller may hand them: a ragged stream shorter than one block, views
    that start off a 16-byte boundary (both at one offset, and at two); NaN
    keys of both signs flooding pixel 0, and a standing -0.0 at pixel 0
    meeting a new +0.0."""
    from strange_attractor_tpu_torch.ops import cuda_lib, emit

    special = np.array([0.0, -0.0, -1.0, 1.0, np.inf, -np.inf, np.nan, -1e-45, 1e-40,
                        -1.0000001, 3.4028235e38, 65520.0, 6e-8], np.float32)
    tiles = cuda_lib.library().sat_bin_tiles(npix)  # as the kernels cut the canvas

    def chunk(flat, z=None, val=None):
        n = len(flat)
        z = rng.normal(0, 0.5, n).astype(np.float32) if z is None else z
        val = rng.random(n).astype(np.float32) if val is None else val
        return tuple(torch.from_numpy(a).to(dev) for a in (flat.astype(np.int32), z, val))

    def tie_z(n):
        z = (rng.integers(-2, 3, n) * 0.25).astype(np.float32)
        z[rng.random(n) < 0.2] = -0.0
        return z, (rng.integers(0, 8, n) / 8).astype(np.float32)

    def ties(n):
        return chunk(rng.integers(0, 50, n), *tie_z(n))

    def pixel0(share, escaped=(-np.inf,)):
        # pixel 0 mixes escaped points (z = -inf, as kernel A emits them, or
        # NaN keys of both signs), NaN and both zeros, and real points that
        # must win by the key
        flat = rng.integers(0, npix, m)
        at0 = rng.random(m) < share
        flat[at0] = 0
        z = rng.normal(0, 0.5, m).astype(np.float32)
        out = at0 & (rng.random(m) < 0.6)
        z[out] = rng.choice(np.array(escaped, np.float32), int(out.sum()))
        odd = at0 & (rng.random(m) < 0.01)
        z[odd] = rng.choice(special, int(odd.sum()))
        return [chunk(flat, z)]

    def shifted(c, words):
        # the chunk's streams as views starting words[k] words past the
        # allocator's 512-byte boundary
        out = []
        for t, w in zip(c, words):
            buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=dev)
            out.append(buf[w:w + t.numel()])
            out[-1].copy_(t)
        return tuple(out)

    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF, 0xFFC12345, 0x7FC00001],
                    np.uint32).view(np.float32)
    zero_flat = rng.integers(0, 100, m)
    zero_flat[rng.random(m) < 0.3] = 0

    flat = rng.integers(0, npix, m)
    flat[rng.random(m) < 0.05] = npix
    flood = rng.integers(0, npix, m)
    flood[rng.random(m) < 0.40] = 0
    # the pixels on both sides of every kind of edge: of a run, of the first
    # round of tiles, of the canvas
    edges = np.array([0, 1, 31, 32, 33, 63, 64, 32 * tiles - 1, 32 * tiles, 32 * tiles + 1,
                      32 * tiles + 31, 32 * tiles + 32, 64 * tiles - 1, 64 * tiles,
                      npix - 33, npix - 32, npix - 1])
    one_tile = 32 * (5 + tiles * rng.integers(0, npix // (32 * tiles), m)) + rng.integers(0, 32, m)
    sail = _solar_sail(sat, 1_000_000_000)
    spec = emit.emit_spec(sail, 0.0)
    pts = torch.from_numpy((rng.random((3, LANES)) * 0.1).astype(np.float32)).to(dev)
    emit.map_emit(spec, pts, sail.warmup, emit=False)
    small, wide, uhd = 37 * 23, sail.width * sail.height, 3840 * 2160
    cases = {
        "random 5% oob": [chunk(flat)],
        "z ties and both zero signs on 50 px": [ties(m)],
        "special floats on 64 px": [chunk(rng.integers(0, 64, m), rng.choice(special, m),
                                          rng.choice(special, m))],
        "40% pixel-0 flood": [chunk(flood)],
        "pixel 0 mixed, 30% (above chunk/64)": pixel0(0.30),
        "pixel 0 mixed, 1% (below chunk/64)": pixel0(0.01),
        "every point in one run of 32 px": [chunk(4096 + rng.integers(0, 32, m), *tie_z(m))],
        f"every point in one tile of {tiles}": [chunk(one_tile)],
        "ties on the edges of runs and tiles": [chunk(rng.choice(edges, m), *tie_z(m))],
        "all out of bounds": [chunk(np.full(m, npix))],
        "3 chunks onto a standing state": [ties(m), chunk(rng.integers(0, npix + 1, m)),
                                           chunk(rng.integers(0, 64, m), rng.choice(special, m))],
        "ragged 1000003 points": [chunk(rng.integers(0, npix + 1, 1_000_003))],
        "ragged 203 points, shorter than one block": [chunk(rng.integers(0, npix + 1, 203))],
        "streams one word past a 16-byte boundary": [
            shifted(chunk(rng.integers(0, npix + 1, m - 3)), (1, 1, 1))],
        "flat, z and val at three offsets": [
            shifted(chunk(rng.integers(0, npix + 1, m - 1)), (1, 2, 3))],
        "pixel 0 mixed, NaN keys of both signs, 30% (above chunk/64)": pixel0(0.30, nans),
        "pixel 0 mixed, NaN keys of both signs, 1% (below chunk/64)": pixel0(0.01, nans),
        "pixel 0 mixed, both zeros onto a standing -0.0": [chunk(zero_flat, rng.choice(
            np.array([0.0, -0.0, -0.0, -1.5], np.float32), m))],
    }
    cases = {name: (npix, chunks) for name, chunks in cases.items()}
    cases["37x23 canvas, smaller than a tile"] = (small, [
        chunk(rng.integers(0, small + 1, m)), chunk(rng.integers(0, small, 1000), *tie_z(1000))])
    cases["1800x2000 canvas"] = (wide, [chunk(rng.integers(0, wide + 1, m)) for _ in range(2)])
    cases["3840x2160 canvas"] = (uhd, [chunk(rng.integers(0, uhd + 1, m)) for _ in range(2)])
    # more pixels than one band of tiles holds (1024 tiles of 576 runs)
    cases["7680x4320 canvas, two bands"] = (4 * uhd, [chunk(rng.integers(0, 4 * uhd + 1, m))])
    cases["solar-sail 1800x2000 stream"] = (wide, [
        emit.map_emit(spec, pts, CHUNK, kind=sat.BinStrategy.EXACT) for _ in range(3)])
    cases[f"long chunk of {LONG_CHUNK} points on 37x23, with NaN depths"] = (
        small, [_long_chunk(dev, small)])
    return cases


def _long_chunk(dev, npix: int) -> tuple:
    """(flat, z, val) of LONG_CHUNK points over ``npix`` pixels, made on the
    card: more points than the table's 1024 spans of 2^17 hold for the EXACT
    and EXACT16-earliest kernels, z ties on every pixel, the earliest far
    apart, and on a third of the pixels one NaN depth, which takes EXACT's
    pixel and blocks the whole chunk there."""
    gen = torch.Generator(device=dev).manual_seed(5)
    n = LONG_CHUNK
    flat = torch.randint(0, npix + 1, (n,), generator=gen, device=dev, dtype=torch.int32)
    z = torch.randint(-2, 3, (n,), generator=gen, device=dev).float() * 0.25
    late = torch.randint(max(0, n - (1 << 20)), n, (300,), generator=gen, device=dev)
    z[late[flat[late] % 3 == 0]] = float("nan")
    return flat, z, torch.randint(0, 8, (n,), generator=gen, device=dev).float() / 8


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
    zbuf[0] = -0.0
    return tuple(torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 1000, npix).astype(np.int32), rng.random(npix).astype(np.float32), zbuf))


# points of phase 7's longest chunk: more than the 2^27 that the least
# width of the partition's table holds for the EXACT and EXACT16-earliest
# kernels, whose records keep a 17-bit offset in a span
LONG_CHUNK = 140_000_000
# the cases that land on a random standing state (the others on blank planes)
STANDING_CASES = ("3 chunks", "pixel 0 mixed", "ties on the edges", "37x23", "solar-sail",
                  "long chunk")


def _exact_bins(kb, binning, work) -> dict:
    """name -> (kernel, twin) of the three EXACT-plane bins, the kernels on
    one set of work buffers."""
    return {
        "bin_exact": (lambda *p: kb.bin_chunk_kernel_exact(*p, work=work),
                      binning.bin_chunk_exact),
        "bin_exact16_value": (
            lambda *p: kb.bin_chunk_kernel_exact16(*p, ties="value", work=work),
            lambda *p: binning.bin_chunk_exact16(*p, ties="value")),
        "bin_exact16_earliest": (
            lambda *p: kb.bin_chunk_kernel_exact16(*p, ties="earliest", work=work),
            lambda *p: binning.bin_chunk_exact16(*p, ties="earliest")),
    }


def _bin_strategies(sat) -> dict:
    """Bin name -> the config keywords of the render that runs it."""
    B = sat.BinStrategy
    return {"bin_depth": dict(render=sat.RenderKind.DEPTH),
            "bin_exact": dict(bin_strategy=B.EXACT_KERNEL),
            "bin_exact16_value": dict(bin_strategy=B.EXACT16_KERNEL),
            "bin_exact16_earliest": dict(bin_strategy=B.EXACT16_KERNEL, exact16_ties="earliest")}


def phase_bins(sat, dev) -> dict:
    from strange_attractor_tpu_torch.ops import binning, kernel_binning as kb

    npix, m = W * H, LANES * CHUNK
    rng = np.random.default_rng(3)
    _f16_probe(dev)
    work = kb.new_work(LONG_CHUNK, dev)
    bins = {"bin_depth": (kb.bin_chunk_kernel_depth, binning.bin_chunk_depth),
            **_exact_bins(kb, binning, work)}
    strategies = _bin_strategies(sat)
    cases = _bin_cases(sat, dev, npix, m, rng)
    out, long_ms = {}, {}
    for name, (kernel, twin) in bins.items():
        depth = name == "bin_depth"
        for case, (size, chunks) in cases.items():
            start = _standing(dev, size, rng, blank=not case.startswith(STANDING_CASES))
            if depth:
                start = start[2:]
            pk, pt = tuple(p.clone() for p in start), start
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            for f, z, v in chunks:
                stream = (f, z) if depth else (f, z, v)
                start.record()
                pk = kernel(*pk, *stream)
                end.record()
                pt = twin(*pt, *stream)
            for i, (g, w) in enumerate(zip(pk, pt)):
                _check_equal(f"{name} {case} plane {i}", g, w)
            if case.startswith("long chunk"):  # one call, not warmed
                long_ms[name] = start.elapsed_time(end)
                print(f"[7] {name}: {case}: {long_ms[name]:.4f} ms, one call")
            # every launch leaves the control words zero for the next one
            if not depth and bool(work.control.any()):
                raise AssertionError(f"{name} {case}: the control words were left dirty")
        print(f"[7] {name}: {len(cases)} cases bit-identical to its plain twin: "
              + "; ".join(cases))
        # timed as a render meets it, on the flagship of its strategy and on
        # solar-sail 1800x2000 (the pixel-0 flood)
        cfg = _flagship(sat, 1_000_000_000, **strategies[name])
        row = _honest_bin(sat, dev, cfg, kernel, twin, f"[7] {name} flagship")
        out[name] = {"err": 0.0, **_public(row),
                     "long_chunk": {"points": LONG_CHUNK, "ms": long_ms[name]}}
        sail_cfg = _solar_sail(sat, 1_000_000_000, **strategies[name])
        sail = _honest_bin(sat, dev, sail_cfg, kernel, twin, f"[7] {name} solar-sail")
        out[name]["solar_sail"] = _public(sail)
        if depth:
            out[name]["library_ms"] = _library_bin_depth(dev, npix, row["planes"], row["chunks"])
            out[name]["solar_sail"]["library_ms"] = _library_bin_depth(
                dev, sail_cfg.width * sail_cfg.height, sail["planes"], sail["chunks"],
                "solar-sail")
        else:
            out[name].update(library_ms=None, library_note=LIBRARY_NOTE)
            out[name]["solar_sail"].update(library_ms=None, library_note=LIBRARY_NOTE)
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
    # all 120 frames to PNG through the CLI's encoder threads
    from strange_attractor_tpu_torch import cli

    seq_dir = out_dir / "rotation"
    seq_dir.mkdir()
    paths = [seq_dir / f"frame{f}" for f in range(len(angles))]
    t0 = time.perf_counter()
    cli._write_frames(zip(out["shared"], paths), lambda path, image: write_image(
        path, image, transparent=False, eight_bit=True, announce=False))
    encode = time.perf_counter() - t0
    nbytes = sum(p.with_suffix(".png").stat().st_size for p in paths)
    print(f"[12] {len(angles)} rotation frames encoded to PNG on {cli.ENCODERS} encoder threads "
          f"({_encoder()} encoder) in {encode:.4f} s = {len(angles) / encode:.4f} frames/s, "
          f"{nbytes} bytes, host of {os.cpu_count()} cores")
    runs["encode"] = {"s": encode, "frames_per_s": len(angles) / encode, "encoder": _encoder()}
    for f in (0, len(angles) // 2):
        img = out["shared"][f]
        lit = float((img.max(axis=-1) > 0).mean())
        if not lit > 0.10:
            raise AssertionError(f"[12] shared frame {f} nearly blank: lit fraction {lit}")
        print(f"[12] shared frame {f} at {angles[f]} degrees: lit {lit:.3f}, "
              f"{paths[f].with_suffix('.png').stat().st_size} bytes")
    return runs


def _render_rates(sat, dev, cfg, tag: str, card: str, kernels: tuple, reps: int = 3) -> dict:
    """One render of ``cfg`` with every launch count at 0 just before it
    (raises unless each of ``kernels`` launched), then ``reps`` warm
    renders, each synchronized and timed on the host's clock."""
    lanes, chunk, nchunks = sat.plan_schedule(cfg)
    executed = lanes * chunk * nchunks
    counters = _zero_counters()
    sat.render(cfg, device=dev)
    torch.cuda.synchronize()
    launches = _require_launches(tag, counters, kernels)
    rates = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sat.render(cfg, device=dev)
        torch.cuda.synchronize()
        rates.append(executed / (time.perf_counter() - t0))
    print(f"{tag} {cfg.width}x{cfg.height} {cfg.iterations:.0e} ({lanes} lanes x {chunk} steps x "
          f"{nchunks} chunks): launches {launches}; render "
          + ", ".join(f"{r:.4e}" for r in rates) + f" iters/s on {card}")
    return {"launches": launches, "iters_per_s": rates}


def phase_renders(sat, dev, card: str) -> dict:
    """10^9 iterations of each path: a render's launches, counted, and its
    synchronized rate over three warm renders; then a rotation of 100
    frames at 10^7 through the shared-orbit engine, its launches counted."""
    B = sat.BinStrategy
    paths = {
        "flagship": (_flagship(sat, 10**9), ("map_emit", "bin_packed")),
        "solar_sail": (_solar_sail(sat, 10**9), ("map_emit", "bin_packed")),
        "depth": (_flagship(sat, 10**9, render=sat.RenderKind.DEPTH), ("map_emit", "bin_depth")),
        "solar_sail_depth": (_solar_sail(sat, 10**9, render=sat.RenderKind.DEPTH),
                             ("map_emit", "bin_depth")),
        "exact": (_flagship(sat, 10**9, bin_strategy=B.EXACT_KERNEL), ("map_emit", "bin_exact")),
        "exact16_value": (_flagship(sat, 10**9, bin_strategy=B.EXACT16_KERNEL),
                          ("map_emit", "bin_exact16")),
        "exact16_earliest": (_flagship(sat, 10**9, bin_strategy=B.EXACT16_KERNEL,
                                       exact16_ties="earliest"), ("map_emit", "bin_exact16")),
        "solar_sail_exact": (_solar_sail(sat, 10**9, bin_strategy=B.EXACT_KERNEL),
                             ("map_emit", "bin_exact")),
        "solar_sail_exact16_value": (_solar_sail(sat, 10**9, bin_strategy=B.EXACT16_KERNEL),
                                     ("map_emit", "bin_exact16")),
    }
    out = {name: _render_rates(sat, dev, cfg, f"[13] {name}", card, kernels)
           for name, (cfg, kernels) in paths.items()}
    # what the card does in a --depth render: its busy time traced, against
    # the traced wall and against the untraced renders' fastest wall
    for name in ("depth", "solar_sail_depth"):
        cfg = paths[name][0]
        busy, wall = _idle_share(lambda: sat.render(cfg, device=dev))
        lanes, chunk, nchunks = sat.plan_schedule(cfg)
        fastest = lanes * chunk * nchunks / max(out[name]["iters_per_s"]) * 1e3
        idle = "not measured (no device activity in the trace)" if busy is None else \
            (f"device busy {busy:.2f} ms, idle share {1 - busy / wall:.4f} of the traced wall, "
             f"{1 - busy / fastest:.4f} of the fastest untraced render ({fastest:.2f} ms)")
        print(f"[13] {name}, one traced render: wall {wall:.2f} ms, {idle}")
        out[name]["trace"] = {"busy_ms": busy, "wall_ms": wall, "fastest_untraced_ms": fastest}
    counters = _zero_counters()
    sat.render_sequence_shared(_flagship(sat, 10_000_000), [3.6 * f for f in range(100)],
                               transparent=False, eight_bit=True, device=dev)
    launches = _require_launches("[13] rotation", counters,
                                 ("map_emit", "project_emit", "bin_packed"))
    print(f"[13] rotation, 100 frames x 1e7 iterations: launches {launches}")
    out["rotation"] = {"launches": launches}
    return out


def _encoder() -> str:
    from strange_attractor_tpu_torch.utils import native

    return native.encoder()


def phase_encoder(img: np.ndarray) -> dict:
    """The 10^8 flagship frame's PNG encode through the package's writer
    (the native filter and parallel deflate when they built) and through
    the stdlib fallback's route (numpy filter, one zlib stream); the two
    must hold the same filtered scanlines."""
    import zlib

    from strange_attractor_tpu_torch.utils import export

    enc = _encoder()
    t0 = time.perf_counter()
    for _ in range(3):
        data = export.png_bytes(img)
    native_ms = (time.perf_counter() - t0) / 3 * 1e3
    rows = np.ascontiguousarray(img).reshape(img.shape[0], -1)
    t0 = time.perf_counter()
    for _ in range(2):
        filtered = export._filter_scanlines_numpy(rows, img.shape[-1])
        stdlib = zlib.compress(filtered, 6)
    stdlib_ms = (time.perf_counter() - t0) / 2 * 1e3
    idat = data[data.index(b"IDAT") + 4:data.rindex(b"IEND") - 8]
    if zlib.decompress(idat) != filtered or zlib.decompress(stdlib) != filtered:
        raise AssertionError("[4] the encoders' scanlines differ")
    print(f"[4] PNG encoder {enc}: the 1e8 flagship frame {img.shape} encodes in "
          f"{native_ms:.2f} ms through the package's writer, {stdlib_ms:.2f} ms through the "
          f"stdlib route (numpy filter + zlib.compress); {len(data)} bytes of PNG, {len(stdlib)} of "
          f"the stdlib's zlib stream; host of {os.cpu_count()} cores")
    return {"encoder": enc, "png_ms": native_ms, "stdlib_ms": stdlib_ms}


RK4_PRESETS = ("lorenz", "rossler", "halvorsen", "thomas")
# iterations of each new preset's frame through the CLI (phase 15)
PRESET_ITERS = 100_000_000
NEW_PRESETS = RK4_PRESETS + ("aurora-veil", "orchid-ribbon", "delta-kite")
# float32 operations of one map step, counted from csrc/map_emit.cuh: the
# Sprott map 60 (EMIT_OPS below); an RK4 step is four derivatives, three
# stage points (2 ops a component), the weighted sum (4 a component
# for k2 and k3, then k4, h/6 and x: 3) -- 39 ops -- plus the derivatives:
# Lorenz 8, Rossler 7, Halvorsen 22 (with the negated a), Thomas 108 (three
# sin_f32 of 34 ops: the reduction 13, the polynomials 16 and 1, the
# quadrant's selects and sign 4; and b x and the difference)
MAP_OPS = {"sprott": 60, "lorenz": 39 + 4 * 8, "rossler": 39 + 4 * 7,
           "halvorsen": 39 + 4 * 22, "thomas": 39 + 4 * 108}
# (lanes, steps, angle): the one-thread-per-lane kernel at the flagship
# chunk, the 32-lane ring with a partial last tile, and a ragged 1000 lanes
# on the 16-lane ring
RK4_SHAPES = ((LANES, CHUNK, 0.0), (16384, 77, 0.3), (1000, 77, 0.7))


def phase_rk4_kernel_a(sat, dev) -> dict:
    """Kernel A for each RK4 map, and the Sprott map again, against its
    plain twin in all six modes at every launcher shape; then the PACKED
    chunk of each map timed at the flagship shape."""
    from strange_attractor_tpu_torch.ops import emit

    B = sat.BinStrategy
    kinds = (("packed", B.PACKED, False), ("depth", B.DEPTH, False), ("exact", B.EXACT, False),
             ("shared", B.PACKED, True), ("shared-depth", B.DEPTH, True))
    err, rows = 0.0, {}
    rng = np.random.default_rng(14)
    for preset in ("poisson-saturne",) + RK4_PRESETS:
        cfg = sat.presets.by_name(preset, width=W, height=H)
        for lanes, steps, angle in RK4_SHAPES:
            spec = emit.emit_spec(cfg, angle)
            tag = f"[14] {preset} {lanes} x {steps}"
            seeds = torch.from_numpy((rng.random((3, lanes)) * 0.1).astype(np.float32)).to(dev)
            pk, pp = seeds.clone(), seeds.clone()
            emit.map_emit(spec, pk, cfg.warmup, emit=False)
            emit.map_emit_plain(spec, pp, cfg.warmup, emit=False)
            err = max(err, _check_equal(f"{tag} warm-up state", pk, pp))
            for name, kind, shared in kinds:
                k, q = pk.clone(), pp.clone()
                for c in range(2):
                    if shared:
                        got = emit.map_emit_shared(spec, k, steps, kind=kind)
                        want = emit.map_emit_shared_plain(spec, q, steps, kind=kind)
                    else:
                        got = emit.map_emit(spec, k, steps, kind=kind)
                        want = emit.map_emit_plain(spec, q, steps, kind=kind)
                    err = max(err, _check_streams(f"{tag} {name} chunk {c}", got, want),
                              _check_equal(f"{tag} {name} chunk {c} state", k, q))
                if name == "packed":
                    flat = got[0]
            print(f"{tag}, angle {angle}: warm-up + 2 chunks bit-identical in all six modes "
                  f"(on the canvas {float((flat < W * H).float().mean()):.3f}, pixel-0 share "
                  f"{float((flat == 0).float().mean()):.3f})")
        spec = emit.emit_spec(cfg, 0.0)
        pts = torch.from_numpy((rng.random((3, LANES)) * 0.1).astype(np.float32)).to(dev)
        emit.map_emit(spec, pts, cfg.warmup, emit=False)
        ms = _time_ms(lambda: emit.map_emit(spec, pts, CHUNK), reps=20)
        plain_ms = _time_ms(lambda: emit.map_emit_plain(spec, pts, CHUNK), reps=2, warm=1)
        rows[preset] = {"ms": ms, "plain_ms": plain_ms}
        print(f"[14] {preset} PACKED {LANES} lanes x {CHUNK} steps: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
    return {"err": err, "rows": rows}


def phase_presets(sat, dev, out_dir: Path, card: str) -> dict:
    """Each of the nine presets through the CLI entry point at 1920x1080,
    10^8 iterations, 8-bit PNG, seed 1, with every launch count at 0 just
    before it (the state checkpointed by --save-state, to read the image
    back); for each new preset, kernel against plain-twin renders: a 10^6
    Gas render, and for the RK4 presets 2x10^5 renders through --depth,
    exact-kernel and a two-frame shared-orbit sequence."""
    from strange_attractor_tpu_torch import cli
    from strange_attractor_tpu_torch.ops import emit
    from strange_attractor_tpu_torch.render import seed_generator

    B = sat.BinStrategy
    runs = {}
    for preset in sat.presets.PRESET_NAMES:
        out, npz = out_dir / preset, out_dir / f"{preset}.npz"
        counters = _zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cli.main(["-p", preset, "-i", str(PRESET_ITERS), "-w", str(W), "-h", str(H), "-8",
                  "--seed", "1", "-q", "-o", str(out), "--save-state", str(npz)])
        wall = time.perf_counter() - t0
        launches = _require_launches(f"[15] {preset}", counters, ("map_emit", "bin_packed"))
        cfg = sat.presets.by_name(preset, iterations=PRESET_ITERS, width=W, height=H, seed=1)
        state = sat.load_state(str(npz), device=dev)
        img = sat.colorize(cfg, state)[..., :3]
        lit = float((img.to(torch.int32).amax(dim=-1) > 0).float().mean())
        if not lit > 0.02:
            raise AssertionError(f"[15] {preset}: image nearly blank: lit fraction {lit}")
        size = out.with_suffix(".png").stat().st_size
        print(f"[15] {preset} through the CLI, {W}x{H} 1e8 8-bit seed 1: lit {lit:.3f}, "
              f"launches {launches}, {size} bytes of PNG, wall {wall:.4f} s (with the "
              f"checkpoint) on {card}")
        runs[preset] = {"launches": launches, "lit": lit, "wall": wall}
        if preset not in NEW_PRESETS:  # phases 5 and 9 hold these to their twins
            continue
        cfg = sat.presets.by_name(preset, iterations=1_000_000, width=W, height=H, seed=1)
        lanes, chunk, _ = sat.plan_schedule(cfg)
        cfg = cfg.replace(lanes=lanes, chunk_steps=chunk, bin_strategy=B.KERNEL)
        kern = sat.render(cfg, device=dev)
        plain = sat.render(cfg.replace(bin_strategy=B.PACKED), device=dev)
        for name in ("count", "packed"):
            _check_equal(f"[15] {preset} 1e6 {name} plane", getattr(kern, name),
                         getattr(plain, name))
        if preset not in RK4_PRESETS:
            continue
        small = cfg.replace(iterations=200_000, lanes=None, chunk_steps=None,
                            bin_strategy=B.AUTO)
        for label, kw, plain_kw in (("depth", dict(render=sat.RenderKind.DEPTH),
                                     dict(bin_strategy=B.DEPTH)),
                                    ("exact-kernel", dict(bin_strategy=B.EXACT_KERNEL),
                                     dict(bin_strategy=B.EXACT))):
            c = small.replace(**kw)
            seeds = emit.seed_points(sat.plan_schedule(c)[0], seed_generator(c)).to(dev)
            k, q = sat.render_seeds(c, seeds), sat.render_seeds(c.replace(**plain_kw), seeds)
            for name, g in k._asdict().items():
                if g is not None:
                    _check_equal(f"[15] {preset} 2e5 {label} {name}", g, getattr(q, name))
        seeds = emit.seed_points(sat.plan_schedule(small)[0], seed_generator(small)).to(dev)
        angles = (0.0, math.radians(140.0))
        for f, (k, q) in enumerate(zip(sat.render_seeds_shared(small, seeds, angles),
                                       sat.render_seeds_shared(small, seeds, angles, plain=True))):
            for name in ("count", "packed"):
                _check_equal(f"[15] {preset} shared frame {f} {name}", getattr(k, name),
                             getattr(q, name))
    print(f"[15] 1e6 renders of {', '.join(NEW_PRESETS)}: kernels and plain twins give "
          f"identical planes; 2e5 --depth, exact-kernel and shared-orbit renders of the RK4 "
          f"presets too")
    return runs


def phase_rk4_renders(sat, dev, card: str) -> dict:
    """10^9 iterations of each RK4 preset at 1920x1080, seed 1: launches
    counted, three warm synchronized renders for the rate."""
    return {preset: _render_rates(
        sat, dev, sat.presets.by_name(preset, iterations=10**9, width=W, height=H, seed=1,
                                      silent=True),
        f"[16] {preset}", card, ("map_emit", "bin_packed")) for preset in RK4_PRESETS}


_SOURCE = "strange_attractor_tpu_torch/csrc/"
_TPU = "strange_attractor_tpu/ops/kernel_binning.py:"
# kernel row -> (source, replaces, its counter, its 10^9 render in phase 13)
_NEW_ROWS = {
    "bin_depth": ("bin_depth.cu", _TPU + "735", "bin_depth", "depth"),
    "bin_exact": ("bin_exact.cu", _TPU + "542", "bin_exact", "exact"),
    "bin_exact16_value": ("bin_exact16.cu", _TPU + "584", "bin_exact16", "exact16_value"),
    "bin_exact16_earliest": ("bin_exact16.cu", _TPU + "584", "bin_exact16", "exact16_earliest"),
}
# float32 operations a point costs: the Sprott step 60 (6 monomials, 3 rows
# of 9 products and 9 sums), rotation and projection operands 20, the color
# transform 26 (delta, magnitude, sqrt, classifier, value), the frame's
# projection and packing 18
EMIT_OPS = {"packed": 124, "depth": 98, "exact": 124, "shared": 106, "project": 18}
# bytes written a point: fused PACKED/DEPTH 8, EXACT 12, shared 16 (xc, zc,
# fj, val); project_emit reads the 16 and writes 8
EMIT_BYTES = {"packed": 8, "depth": 8, "exact": 12, "shared": 16, "project": 24}


def _emit_bound(kind: str, lanes: int, steps: int) -> dict:
    """Kernel A's (or kernel P's) bound for one chunk: the streams, plus
    the lane state read and written once (none for kernel P)."""
    points = lanes * steps
    state = 0 if kind == "project" else 2 * 12 * lanes
    return _bound(EMIT_BYTES[kind] * points + state, EMIT_OPS[kind] * points)


def _map_bound(preset: str, lanes: int, steps: int) -> dict:
    """Kernel A's PACKED bound for one chunk of ``preset``'s map: the
    Sprott row's bytes, and its operations with the map's own."""
    points = lanes * steps
    ops = EMIT_OPS["packed"] - MAP_OPS["sprott"] + MAP_OPS[preset]
    return _bound(EMIT_BYTES["packed"] * points + 2 * 12 * lanes, ops * points)


def _kernel_rows(a, b, modes, bins, shared, s, runs, seq, renders, rk4, preset_runs,
                 rk4_renders) -> list:
    """The final ``kernels`` line: one row per kernel, with its time, its
    plain twin's, its bound from this run's shapes, its launches on its
    path run and in a 10^9-iteration render (phases 13 and 16)."""
    no_library = {"library_ms": None, "library_note": LIBRARY_NOTE}
    flag = renders["flagship"]["launches"]
    rows = [{
        "name": "map_emit", "route": "cuda", "source": _SOURCE + "map_emit.cu",
        "replaces": "strange_attractor_tpu/render.py:410",
        "launches": s["launches"]["map_emit"],
        "max_abs_err": max(a["err"], modes["err"], shared["err"]),
        "ms": a["ms"], "plain_ms": a["plain_ms"], **_emit_bound("packed", LANES, CHUNK),
        "launches_per_1e9": flag["map_emit"], **no_library,
        "modes": {kind: {"ms": modes["ms"][kind], "plain_ms": modes["plain_ms"][kind],
                         **_emit_bound(kind, LANES, CHUNK)} for kind in modes["ms"]},
        "shared_cell": {"ms": shared["ms"]["shared"], "plain_ms": shared["ms"]["shared_plain"],
                        **_emit_bound("shared", SEQ_LANES, SEQ_CHUNK)},
        "retimed_ms": rk4["rows"]["poisson-saturne"]["ms"],
    }, {
        "name": "bin_packed", "route": "cuda", "source": _SOURCE + "bin_packed.cu",
        "replaces": _TPU + "475", "launches": s["launches"]["bin_packed"],
        "max_abs_err": b["err"], "launches_per_1e9": flag["bin_packed"],
        **{k: v for k, v in b.items() if k != "err"},
    }]
    for name, (source, replaces, counter, render) in _NEW_ROWS.items():
        row = {k: v for k, v in bins[name].items() if k != "err"}
        rows.append({"name": name, "route": "cuda", "source": _SOURCE + source,
                     "replaces": replaces, "launches": runs[name]["launches"][counter],
                     "max_abs_err": bins[name]["err"], **row,
                     "launches_per_1e9": renders[render]["launches"][counter]})
    rows.append({"name": "project_emit", "route": "cuda", "source": _SOURCE + "project_emit.cu",
                 "replaces": "strange_attractor_tpu/render.py:246",
                 "launches": seq["shared"][-1]["launches"]["project_emit"],
                 "max_abs_err": shared["err"], "ms": shared["ms"]["project"],
                 "plain_ms": shared["ms"]["project_plain"],
                 **_emit_bound("project", SEQ_LANES, SEQ_CHUNK),
                 "launches_per_1e9": renders["rotation"]["launches"]["project_emit"],
                 **no_library})
    for preset in RK4_PRESETS:
        rows.append({"name": f"map_emit_{preset}", "route": "cuda",
                     "source": _SOURCE + "map_emit_rk4.cu",
                     "replaces": "strange_attractor_tpu/render.py:410",
                     "map": "strange_attractor_tpu/models/attractors.py:113",
                     "launches": preset_runs[preset]["launches"]["map_emit"],
                     "max_abs_err": rk4["err"], "ms": rk4["rows"][preset]["ms"],
                     "plain_ms": rk4["rows"][preset]["plain_ms"],
                     **_map_bound(preset, LANES, CHUNK),
                     "launches_per_1e9": rk4_renders[preset]["launches"]["map_emit"],
                     **no_library})
    return rows


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
    b = phase_kernel_b(sat, dev)
    with tempfile.TemporaryDirectory() as tmp:
        s = phase_slice(sat, dev, Path(tmp), card)
        encoder = phase_encoder(s.pop("image"))
        phase_twins(sat, dev, Path(tmp))
        modes = phase_emit_modes(sat, dev)
        bins = phase_bins(sat, dev)
        runs = phase_paths(sat, dev, Path(tmp), card)
        phase_path_twins(sat, dev, Path(tmp))
        shared = phase_shared_emit(sat, dev)
        phase_sequence_twins(sat, dev)
        seq = phase_sequence_cell(sat, dev, Path(tmp), card)
        rk4 = phase_rk4_kernel_a(sat, dev)
        preset_runs = phase_presets(sat, dev, Path(tmp), card)
    renders = phase_renders(sat, dev, card)
    rk4_renders = phase_rk4_renders(sat, dev, card)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    kernels = _kernel_rows(a, b, modes, bins, shared, s, runs, seq, renders, rk4, preset_runs,
                           rk4_renders)
    print(json.dumps({"encoder": encoder, "frame_split_s": s["split"],
                      "rotation_encode": seq["encode"]}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
