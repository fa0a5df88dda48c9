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
   iterations, render -> colorize + convert (kernel T) -> one host copy ->
   PNG, with every launch counter of the path > 0 (kernel A, bin_packed,
   kernel T's reduction and pass) and a non-blank image; iters/s and wall time,
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
    synchronized renders for the rate;
17. kernel A's float64 instantiations (the Sprott map and Lorenz at every
    launcher shape of phase 2, Thomas at one a kernel, all six modes) and
    its gated (reseeding) ones (solar-sail and Lorenz, float32 and
    float64, each kernel at ragged steps, dead lanes of every kind
    planted, lane ages from -warm-up to 1, chunk indices 0 and 1), and
    kernel P on each of their shared chunks at two
    angles, against their plain twins on the card: streams, lane state and
    ages bit-identical, and each projected frame equal to the fused
    kernel's stream at that angle; then each float64 mode timed at the
    flagship shape (poisson-saturne and Lorenz), the gated float32 PACKED
    chunk in turns with the ungated one, and kernel P on a float64 and on
    a gated stream at the rotation cell's shape;
18. 10^6 renders through the kernels and the plain twins, identical
    planes, launches counted: reseeded solar-sail 1800x2000 in Gas,
    --depth and a two-frame shared sequence; the float64 flagship through
    KERNEL, EXACT_KERNEL and a two-frame shared sequence; then a reseeded
    float64 rotation through the three sequence engines, frames agreeing;
19. the slice's 10^9 paths at full width: reseeded solar-sail 1800x2000
    in Gas and --depth, the float64 flagship through KERNEL and
    EXACT_KERNEL (and solar-sail unreseeded beside them): launches
    counted, three warm synchronized renders for the rate, and the Gas
    solar-sail renders' pixel-0 share and useful rate (in-bounds points
    off pixel (0, 0) a second);
20. the CLI with ``-p solar-sail --reseed-lanes -i 1e9 -w 1800 -h 2000
    -8``, launches counted, a lit image;
21. parallel.mesh.merge_collective of 4 shards of 1920x1080 on the card,
    per planes kind: equal to merge_all's fold on planes as renders leave
    them (packed values from 2^31 up, counts that wrap, z ties, both
    zeros, the sentinel) and to the same merge on the CPU on planes with
    NaN depths and -0.0 everywhere; each kind's merge timed;
22. render_sharded over [cuda:0] x 4 (lanes split four ways, 8192 lanes
    a shard at 10^9: kernel A's 16-lane ring, which phase 2 also holds to
    its twin at 8192 x 128): the flagship at 10^9, the --depth flagship
    and exact-kernel at 10^8, launches counted, each bit-identical to
    merge_all of its four shard renders and timed in turns with the
    unsharded render; 4-chunk sharded renders through the kernels and the
    plain twins, identical planes;
23. two torch.distributed ranks sharing the card over gloo
    (render_distributed, flagship at 10^8): both ranks' planes equal to
    render_sharded over two shards here, launches counted in each rank,
    planted PACKED and EXACT planes merged over the group equal to
    merge_all here, the PACKED canvas's all_reduce merge timed; one NCCL
    rank the same against one shard;
24. in the same two ranks, cli.main --coordinator: rank 0 alone writes the
    PNG and says so;
25. render_sequence_sharded on a 2 x 2 grid of [cuda:0] x 4, 8 frames at
    10^7, both orbits, launches counted, equal to their compositions of
    render_sharded over a row's devices, frames/s;
26. the 1e8 flagship frame in a fresh process, without precompile and
    after precompile (with the delivery warmed on its state): wall and
    split of each; then precompile of DEPTH_KERNEL, EXACT_KERNEL,
    EXACT16_KERNEL (both ties), reseeded solar-sail and the float64
    flagship at 10^9, each a state of its planes and canvas on the card,
    its kernels launched;
27. ``python -m strange_attractor_tpu_torch doctor`` in a fresh process:
    rc 0, ``doctor: OK``, both oracle agreements and the throughput line;
28. a 1e8 CLI frame with ``--profile DIR``: the trace parses as JSON and
    names kernel A's and bin_packed's CUDA kernels;
29. the flagship at 3840x2160 and 10^9 through the CLI: the PNG decodes
    to 3840x2160, kernel A and bin_packed launched; the same frame through
    the package's calls for its rate, wall split and lit share, and the
    same PNG bytes; bin_packed timed at 4K as in phase 3;
30. reference parity through tools.compare_reference: poisson-saturne at
    10^9, brightness -0.25, seed 0, 1920x1080, 8-bit, under AUTO (KERNEL),
    exact-kernel and exact16-kernel (ties value, then earliest), each with
    the launch counts at 0 just before it, held to the JAX package's
    recorded render media/poisson-saturne-tpu.png by the JAX tool's rule
    (MAD < 0.01, correlation > 0.99); MAD, correlation, lit-support IoU,
    iters/s and wall of each; and the thomas preset at 10^9 against
    media/thomas.png at the preset's brightness and at offset -0.2,
    recorded with no bound;
31. tools.check_kernels.certify_kernels at 2^20 points over 1920x1080 and
    over 3840x2160: KERNEL, EXACT_KERNEL, EXACT16_KERNEL (both ties) and
    DEPTH_KERNEL bit-identical to the sequential reference on a stream
    with a 35% pixel-0 flood, each launched once; each kernel's ms on that
    chunk onto fresh planes;
32. kernel T (csrc/tonemap.cu, the tone map's reduction and its pass fused
    with the (transparent, 8-bit) conversion) at 1920x1080 and 3840x2160:
    22 cases (the flagship's PACKED, EXACT and DEPTH states and
    solar-sail's at 1e8, blank planes, and planted ones: counts from 2^31
    up, NaN and >= 1.0 steps, special and NaN depths, all-negative and flat
    depth planes; the default and a 64-stop palette, brightness saturating
    both ways) in 8 output modes, each image bit-identical to the plain
    chain on the card and on the CPU on the same planes copied to the host
    (the largest channel difference is the row's max_abs_err), the stats to
    colorize_stats and the log1p of the max count; then kernel T's and the plain
    chain's ms a frame by CUDA events (Gas to 8-bit RGB and to u16 RGBA,
    Depth to 8-bit RGB) with their bounds, and kernel T's launches in one
    delivery (one reduction, one pass). Every delivery of phases 4, 8, 12,
    15, 20, 26, 29 and 30 goes through kernel T, its launches counted (two
    a frame in phase 12).
33. kernel F (csrc/png_filter.cu, the adaptive PNG scanline filter at write
    time) on the 10^9 hero frame (1920x1080) and a 10^9 solar-sail frame
    (1800x2000), in all four layouts (8- and 16-bit, RGB and RGBA): bit for
    bit against its plain twin on the card, against
    utils.export._filter_scanlines_numpy and against the host's native
    filter; each delivered image (colorize_convert_fetch) written as a PNG
    through the card path (one launch, the record used) with the sha256 of
    the same image's PNG through the host filter; a 4-frame shared rotation
    written by the CLI's encoder threads, every frame filtered on the card
    and its file's sha256 the host path's; the same rotation written as PAMs,
    which launch nothing and drop every record, the device bytes the
    records held back to where they were; the rotation again under a budget
    of one batch's bytes, where only the last batch keeps its records, so
    two of four PNGs are filtered on the card and all four files' sha256
    are the host path's; then kernel F's ms against its
    bound and its plain twin's, the card path's whole ms (launch, kernel and
    the copy into pinned memory) and the host's native filter's, by layout.

The line before the card's is the ``kernels`` JSON: per kernel its mean
time (``ms``), its twin's (``plain_ms``), its bound from this run's shapes
(``bytes``, ``flops``, ``bound_ms``, ``bound_by``), its launches on the path
run (``launches``) and in phase 13's 10^9 iterations (``launches_per_1e9``; one
wrapper call is one launch; for a bin ``cuda_kernels_per_launch`` says how
many CUDA kernels it started, counted in a trace of the timed chunks, and
``cuda_kernels_us`` each one's mean time), and a PyTorch yardstick (``library_ms``, or null with
``library_note``); kernel A has a row per RK4 map beside the Sprott one,
and rows for its gated and float64 instantiations (the latter's bound at
the card's float64 peak, with a row per mode), kernel P rows for float64
and gated streams. The line before it holds the encoder that ran, the 1e8
frame's wall split, the rotation's encode time, phase 19's rates and
pixel-0 shares, phases 21-25's merge times, sharded rates
and launches, ranks' walls and all_reduce times and sharded sequence rates,
phases 26-29's first frames, precompile seconds, doctor's figures, the
profiled frame and the 4K frame, phase 30's parity metrics and phase 31's
certification seconds and chunk times, phase 32's images compared and
times, and each phase's seconds. The kernel A
and bin_packed rows carry the 4K frame's launches (``launches_4k_1e9``);
the ``tonemap`` row counts kernel T's two wrappers' launches in phase 4's
first frame, and carries the other modes and the 4K canvas of phase 32;
the ``png_filter`` row is phase 33's hero frame in 8-bit RGB, with the other
layouts, the solar-sail frame and the rotation's launches beside it.

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
# the sharded flagship's lane shards on the one card (phases 21-25)
SHARDS = 4
SHARD_LANES = LANES // SHARDS


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
    views = {torch.float32: torch.int32, torch.float64: torch.int64}
    bits = (lambda t: t.view(views[a.dtype])) if a.dtype in views else (lambda t: t)
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
    # tile of 24); the 16-lane ring below (a lane shard of the flagship
    # split four ways, ragged lanes, a partial last block, and ragged steps
    # at another camera angle)
    for preset, chunks, lanes, steps, angle in (("poisson-saturne", 4, LANES, CHUNK, 0.0),
                                                ("solar-sail", 2, LANES, CHUNK, 0.0),
                                                ("poisson-saturne", 2, LANES, 77, 0.0),
                                                ("poisson-saturne", 2, 16384, CHUNK, 0.3),
                                                ("poisson-saturne", 2, 16384, 77, 0.3),
                                                ("poisson-saturne", 2, SHARD_LANES, CHUNK, 0.0),
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


def _bound(nbytes: float, ops: float, peak_ops: float = PEAK_OPS) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the rate of their type
    (float32 unless ``peak_ops`` says otherwise)."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
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
    """colorize + 8-bit conversion on the card (kernel T, as
    ``colorize_convert_fetch`` delivers) -> one host copy -> PNG; returns
    (path, host image). ``times`` gets the seconds of each stage."""
    from strange_attractor_tpu_torch.ops.colorize import tonemap
    from strange_attractor_tpu_torch.utils.export import to_host, write_image

    t0 = time.perf_counter()
    image = tonemap(cfg, state, transparent=False, eight_bit=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host = to_host(image)
    t2 = time.perf_counter()
    path = write_image(out_base, host, transparent=False, eight_bit=True)
    if times is not None:
        times.update(colorize_convert=t1 - t0, host_copy=t2 - t1, png=time.perf_counter() - t2)
    return path, host


def _counters() -> dict:
    """Every kernel wrapper's launch counter, by kernel name: (wrapper,
    counter attribute). Kernel A's wrapper also counts the launches of its
    float64 and of its gated instantiations, kernel P's those on a float64
    stream."""
    from strange_attractor_tpu_torch.ops import colorize, emit, kernel_binning as kb, png_filter

    return {"map_emit": (emit.map_emit, "launches"),
            "map_emit_f64": (emit.map_emit, "f64_launches"),
            "map_emit_gated": (emit.map_emit, "gated_launches"),
            "project_emit": (emit.project_emit, "launches"),
            "project_emit_f64": (emit.project_emit, "f64_launches"),
            "bin_packed": (kb.bin_chunk_kernel, "launches"),
            "bin_depth": (kb.bin_chunk_kernel_depth, "launches"),
            "bin_exact": (kb.bin_chunk_kernel_exact, "launches"),
            "bin_exact16": (kb.bin_chunk_kernel_exact16, "launches"),
            "tonemap_stats": (colorize._tonemap_stats, "launches"),
            "tonemap": (colorize.tonemap, "launches"),
            "png_filter": (png_filter.png_filter, "launches")}


# kernel T's two wrappers: every delivery on the card launches both
TONEMAP = ("tonemap_stats", "tonemap")


def _zero_counters() -> dict:
    counters = _counters()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    return counters


def _require_launches(tag: str, counters: dict, kernels: tuple) -> dict:
    launches = {name: getattr(*counters[name]) for name in kernels}
    if min(launches.values()) < 1:
        raise AssertionError(f"{tag}: the run did not go through every kernel: {launches}")
    return launches


def _drive(sat, dev, cfg, out_base: Path, card: str, tag: str, kernels: tuple) -> dict:
    """One frame through the user's entry points with every launch count at
    0 just before it: render -> colorize + 8-bit convert -> one host copy
    -> PNG. Raises unless each of ``kernels`` and kernel T launched and the
    image is lit."""
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
    launches = _require_launches(tag, counters, kernels + TONEMAP)
    if state.count is not None:
        total = int(u32(state.count).sum())
        if not 0 < total <= executed:
            raise AssertionError(f"{tag}: count.sum() {total} outside (0, {executed}]")
    lit = float((img.max(axis=-1) > 0).mean())
    if not lit > 0.10:
        raise AssertionError(f"{tag}: image nearly blank: lit fraction {lit}")
    print(f"{tag} {cfg.width}x{cfg.height} {cfg.iterations:.0e}: {lanes} lanes x {chunk} steps x "
          f"{nchunks} chunks = "
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
    engines = (("shared", sat.render_sequence_shared,
                ("map_emit", "project_emit", "bin_packed") + TONEMAP),
               ("per-frame", sat.render_sequence_batched, ("map_emit", "bin_packed") + TONEMAP))
    for name, engine, kernels in engines:
        for rep in range(2):
            counters = _zero_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames = engine(cfg, angles, transparent=False, eight_bit=True, device=dev)
            wall = time.perf_counter() - t0
            launches = _require_launches(f"[12] {name}", counters, kernels)
            if launches["tonemap"] != len(angles) or launches["tonemap_stats"] != len(angles):
                raise AssertionError(f"[12] {name}: kernel T launched {launches}, not twice a "
                                     f"frame for {len(angles)} frames")
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
# the warm-up steps held kernel against twin before the kernel alone carries
# the orbits on to the config's warm-up (a twin's step is hundreds of eager
# launches, milliseconds on the card)
CHECKED_WARMUP = 100
# the warm-up of phase 15's kernel-vs-twin renders: their depth is cut, not
# their path
TWIN_WARMUP = 100


def phase_rk4_kernel_a(sat, dev) -> dict:
    """Kernel A for each RK4 map, and the Sprott map again, against its
    plain twin in all six modes at every launcher shape (the first
    CHECKED_WARMUP steps of the warm-up, then two PACKED chunks and one of
    every other mode: the lane state is the same in every mode); then the
    PACKED chunk of each map timed at the flagship shape."""
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
            emit.map_emit(spec, pk, CHECKED_WARMUP, emit=False)
            emit.map_emit_plain(spec, pp, CHECKED_WARMUP, emit=False)
            err = max(err, _check_equal(f"{tag} warm-up state", pk, pp))
            emit.map_emit(spec, pk, cfg.warmup - CHECKED_WARMUP, emit=False)
            pp.copy_(pk)
            for name, kind, shared in kinds:
                k, q = pk.clone(), pp.clone()
                for c in range(2 if name == "packed" else 1):
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
            print(f"{tag}, angle {angle}: warm-up, 2 PACKED chunks and one of each other mode "
                  f"bit-identical "
                  f"(on the canvas {float((flat < W * H).float().mean()):.3f}, pixel-0 share "
                  f"{float((flat == 0).float().mean()):.3f})")
        spec = emit.emit_spec(cfg, 0.0)
        pts = torch.from_numpy((rng.random((3, LANES)) * 0.1).astype(np.float32)).to(dev)
        emit.map_emit(spec, pts, cfg.warmup, emit=False)
        ms = _time_ms(lambda: emit.map_emit(spec, pts, CHUNK), reps=20)
        plain_ms = _time_ms(lambda: emit.map_emit_plain(spec, pts, CHUNK), reps=1, warm=0)
        rows[preset] = {"ms": ms, "plain_ms": plain_ms}
        print(f"[14] {preset} PACKED {LANES} lanes x {CHUNK} steps: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
    return {"err": err, "rows": rows}


def phase_presets(sat, dev, out_dir: Path, card: str) -> dict:
    """Each of the nine presets through the CLI entry point at 1920x1080,
    10^8 iterations, 8-bit PNG, seed 1, with every launch count at 0 just
    before it (the state checkpointed by --save-state, to read the image
    back); for each new preset, kernel against plain-twin renders with a
    TWIN_WARMUP-step warm-up: a 10^6 Gas render, and for the RK4 presets
    2x10^5 renders through --depth, exact-kernel and a two-frame
    shared-orbit sequence."""
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
        launches = _require_launches(f"[15] {preset}", counters,
                                     ("map_emit", "bin_packed") + TONEMAP)
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
        cfg = sat.presets.by_name(preset, iterations=1_000_000, width=W, height=H, seed=1,
                                  warmup=TWIN_WARMUP)
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
    print(f"[15] 1e6 renders of {', '.join(NEW_PRESETS)} ({TWIN_WARMUP}-step warm-up): kernels "
          f"and plain twins give identical planes; 2e5 --depth, exact-kernel and shared-orbit "
          f"renders of the RK4 presets too")
    return runs


def phase_rk4_renders(sat, dev, card: str) -> dict:
    """10^9 iterations of each RK4 preset at 1920x1080, seed 1: launches
    counted, three warm synchronized renders for the rate."""
    return {preset: _render_rates(
        sat, dev, sat.presets.by_name(preset, iterations=10**9, width=W, height=H, seed=1,
                                      silent=True),
        f"[16] {preset}", card, ("map_emit", "bin_packed")) for preset in RK4_PRESETS}


# Lane reseeding and the float64 compute path (phases 17-20)

# the card's float64 peak outside the tensor cores (NVIDIA H100 SXM data
# sheet: 33.5 TFLOP/s, half the float32 rate)
PEAK_OPS_F64 = 33.5e12
# phase 2's launcher shapes: the ILP kernel (and a ragged tail of its 8-step
# batches), the 32-lane ring (and a partial 24-step tile), the 16-lane ring
# on a ragged 1000 lanes at another angle
AXES_SHAPES = ((LANES, CHUNK, 0.0), (LANES, 77, 0.0), (16384, CHUNK, 0.3), (16384, 77, 0.3),
               (1000, 77, 0.7))
# the kernel-vs-twin cases' warm-up, and a re-warm short enough that a lane
# reseeded in a chunk emits again within it (a render's are 1000)
AXES_WARMUP, AXES_REWARM = 200, 60
AXES_KEY = 0x0123456789ABCDEF
# phase 18's 10^6 kernel-vs-twin renders: the main path's 32768 lanes, a
# 16-step warm-up and four pinned chunks of 8 steps, so that a lane reseeded
# in chunk 1 emits again in chunk 3 (the auto schedule is one chunk of 1953
# steps at 512 lanes after 1000, and a twin's step costs milliseconds)
AXES_RENDER_WARMUP, AXES_RENDER_CHUNK = 16, 8
EMIT_KINDS = (("packed", "PACKED", False), ("depth", "DEPTH", False), ("exact", "EXACT", False),
              ("shared", "PACKED", True), ("shared-depth", "DEPTH", True))


def _plant_dead(points: tuple, rng) -> torch.Tensor:
    """Plant dead lanes of every kind (NaN, +-inf, just above 1e3; 1e3
    itself lives) in each of ``points``' (3, lanes) tensors alike, one lane
    in 50; return lane ages from -AXES_REWARM - 20 to 1 on their device."""
    pts = points[0]
    lanes = pts.shape[1]
    big = float(np.nextafter(np.float32(1e3), np.float32(np.inf))
                if pts.dtype == torch.float32 else np.nextafter(1e3, np.inf))
    values = (math.nan, math.inf, -math.inf, big, -big, 1e3)
    for i, lane in enumerate(rng.choice(lanes, max(6, lanes // 50), replace=False)):
        for p in points:
            p[i % 3, int(lane)] = values[i % len(values)]
    ages = rng.integers(-AXES_REWARM - 20, 2, lanes).astype(np.int32)
    return torch.from_numpy(ages).to(pts.device)


def _axes_case(sat, dev, cfg, lanes: int, steps: int, angle: float, rng, gated: bool,
               tag: str) -> dict:
    """Kernel A against its twin on the card at one launcher shape in
    ``cfg``'s compute dtype: the warm-up, then in every emitting mode two
    chunks (with ``gated``: dead lanes planted, random ages, chunk indices
    0 and 1, a lane dying between them; ungated, one chunk of each mode but
    PACKED: the lane state is the same in every mode), streams, lane state
    and ages bit-identical after each; kernel P against its twin on each shared
    chunk at two angles, and its frame against the fused kernel's stream
    of the same lanes at that angle."""
    from strange_attractor_tpu_torch.ops import emit

    B = sat.BinStrategy
    dtype = emit.DTYPES[cfg.dtype]
    spec, other = emit.emit_spec(cfg, angle), emit.emit_spec(cfg, angle + 1.9)
    seeds = torch.from_numpy(rng.random((3, lanes)) * 0.1).to(dev, dtype)
    pk, pp = seeds.clone(), seeds.clone()
    emit.map_emit(spec, pk, AXES_WARMUP, emit=False)
    emit.map_emit_plain(spec, pp, AXES_WARMUP, emit=False)
    err = _check_equal(f"{tag} warm-up state", pk, pp)
    ages = _plant_dead((pk, pp), rng) if gated else None
    stats = {}
    for name, kind_name, shared in EMIT_KINDS:
        kind = getattr(B, kind_name)
        k, q, f = pk.clone(), pp.clone(), pp.clone()
        ak, aq, af = ((ages.clone(), ages.clone(), ages.clone()) if gated else (None,) * 3)
        for c in range(2 if gated or name == "packed" else 1):
            rk, rq, rf = [emit.Reseed(a, AXES_KEY, c, AXES_REWARM) if gated else None
                          for a in (ak, aq, af)]
            if shared:
                got = emit.map_emit_shared(spec, k, steps, kind=kind, reseed=rk)
                want = emit.map_emit_shared_plain(spec, q, steps, kind=kind, reseed=rq)
            else:
                got = emit.map_emit(spec, k, steps, kind=kind, reseed=rk)
                want = emit.map_emit_plain(spec, q, steps, kind=kind, reseed=rq)
            t = f"{tag} {name} chunk {c}"
            err = max(err, _check_streams(t, got, want), _check_equal(f"{t} state", k, q))
            if gated:
                err = max(err, _check_equal(f"{t} ages", ak, aq))
            if shared:  # kernel P on this chunk, and against the fused stream
                for sp in (spec, other):
                    frame = emit.project_emit(sp, got, kind=kind)
                    err = max(err, _check_streams(f"{t} frame", frame,
                                                  emit.project_emit_plain(sp, want, kind=kind)))
                fused = emit.map_emit(other, f, steps, kind=kind, reseed=rf)
                err = max(err, _check_streams(f"{t} frame vs fused", frame, fused))
                stats["gated_fj"] = stats.get("gated_fj", 0) + int(torch.isinf(got[2]).sum())
            elif name == "packed":
                stats["pixel0"] = float((got[0] == 0).float().mean())
                stats["on_canvas"] = float((got[0] < cfg.width * cfg.height).float().mean())
            if gated and c == 0:  # a lane that dies in a later chunk
                for p in (k, q, f):
                    p[0, 3] = math.nan
    return {"err": err, **stats}


def phase_axes_kernels(sat, dev) -> dict:
    """Kernel A's gated and float64 instantiations and kernel P's against
    their twins on the card (_axes_case): float64 for the Sprott map and
    Lorenz at every launcher shape of phase 2, Thomas (whose costly twin
    differs from Lorenz' in the map step alone) at the flagship shape;
    gated for the escaping solar-sail in float32 at every launcher shape
    and in float64 at one a kernel, and for Lorenz in both at the flagship
    shape: the reseeded 10^9 render's 32768 x 128 chunk is among them.
    Then the times: each float64 emission mode at the flagship shape
    (poisson-saturne and Lorenz), the gated float32 PACKED chunk in turns
    with the ungated one, and kernel P on float64 and gated streams at the
    rotation cell's shape."""
    from strange_attractor_tpu_torch.ops import emit

    B = sat.BinStrategy
    rng = np.random.default_rng(17)
    err = 0.0
    flagship = AXES_SHAPES[:1]
    cases = (("poisson-saturne", "float64", False, AXES_SHAPES),
             ("lorenz", "float64", False, AXES_SHAPES), ("thomas", "float64", False, flagship),
             ("solar-sail", "float32", True, AXES_SHAPES),
             ("solar-sail", "float64", True, AXES_SHAPES[::2]),
             ("lorenz", "float32", True, flagship), ("lorenz", "float64", True, flagship))
    for preset, dtype, gated, shapes in cases:
        cfg = sat.presets.by_name(preset, width=W, height=H, dtype=dtype)
        for lanes, steps, angle in shapes:
            tag = f"[17] {preset} {dtype}{' gated' if gated else ''} {lanes} x {steps}"
            row = _axes_case(sat, dev, cfg, lanes, steps, angle, rng, gated, tag)
            err = max(err, row.pop("err"))
            print(f"{tag}, angle {angle}: warm-up and every mode's chunks bit-identical, "
                  f"kernel P too ({row})")
    # times at the flagship chunk shape
    ms, plain_ms = {}, {}
    for preset in ("poisson-saturne", "lorenz"):
        cfg = sat.presets.by_name(preset, width=W, height=H, dtype="float64")
        spec = emit.emit_spec(cfg, 0.0)
        pts = torch.from_numpy(rng.random((3, LANES)) * 0.1).to(dev)
        emit.map_emit(spec, pts, cfg.warmup, emit=False)
        for name, kind_name, shared in EMIT_KINDS:
            fn = emit.map_emit_shared if shared else emit.map_emit
            kind = getattr(B, kind_name)
            ms[f"{preset} {name}"] = _time_ms(lambda: fn(spec, pts, CHUNK, kind=kind), reps=20)
        plain_ms[preset] = _time_ms(lambda: emit.map_emit_plain(spec, pts, CHUNK), reps=1, warm=0)
        print(f"[17] {preset} float64 {LANES} x {CHUNK}: " + ", ".join(
            f"{k.split(' ', 1)[1]} {v:.4f} ms" for k, v in ms.items() if k.startswith(preset))
            + f"; plain PACKED {plain_ms[preset]:.4f} ms")
    cfg = sat.presets.poisson_saturne(width=W, height=H)
    spec = emit.emit_spec(cfg, 0.0)
    pts = torch.from_numpy((rng.random((3, LANES)) * 0.1).astype(np.float32)).to(dev)
    emit.map_emit(spec, pts, cfg.warmup, emit=False)
    age = torch.ones(LANES, dtype=torch.int32, device=dev)
    reseed = emit.Reseed(age, AXES_KEY, 0, cfg.warmup)
    turns = {"ungated": [], "gated": []}
    for name in ("ungated", "gated", "gated", "ungated"):
        r = reseed if name == "gated" else None
        turns[name].append(_time_ms(lambda: emit.map_emit(spec, pts, CHUNK, reseed=r), reps=50))
    gated_plain = _time_ms(lambda: emit.map_emit_plain(spec, pts, CHUNK, reseed=reseed), reps=1,
                           warm=0)
    print(f"[17] float32 PACKED {LANES} x {CHUNK} in turns: ungated "
          + ", ".join(f"{v:.4f}" for v in turns["ungated"]) + " ms, gated "
          + ", ".join(f"{v:.4f}" for v in turns["gated"])
          + f" ms; gated plain {gated_plain:.4f} ms")
    # kernel P at the rotation cell's shape, on a float64 and on a gated stream
    proj = {}
    for label, dtype, gated in (("f64", "float64", False), ("gated", "float32", True)):
        cfg = sat.presets.solar_sail(width=W, height=H, dtype=dtype)
        spec0, spec = emit.emit_spec(cfg, 0.0), emit.emit_spec(cfg, 1.1)
        pts = torch.from_numpy(rng.random((3, SEQ_LANES)) * 0.1).to(dev, emit.DTYPES[dtype])
        emit.map_emit(spec0, pts, cfg.warmup, emit=False)
        r = None
        if gated:
            r = emit.Reseed(_plant_dead((pts,), rng), AXES_KEY, 0, cfg.warmup)
        stream = emit.map_emit_shared(spec0, pts, SEQ_CHUNK, reseed=r)
        proj[label] = {"ms": _time_ms(lambda: emit.project_emit(spec, stream), reps=50),
                       "plain_ms": _time_ms(lambda: emit.project_emit_plain(spec, stream),
                                            reps=10, warm=1),
                       "gated_share": float(torch.isinf(stream[2]).float().mean())}
        print(f"[17] project_emit {label} {SEQ_LANES} x {SEQ_CHUNK}: {proj[label]['ms']:.4f} ms, "
              f"plain {proj[label]['plain_ms']:.4f} ms (gated share "
              f"{proj[label]['gated_share']:.4f})")
    return {"err": err, "f64_ms": ms, "f64_plain_ms": plain_ms, "turns": turns,
            "gated_plain_ms": gated_plain, "project": proj}


def _reseeded(sat, iterations: int, **kw):
    return _solar_sail(sat, iterations, reseed_lanes=True, **kw)


def _same_states(tag: str, a, b) -> None:
    for name, g in a._asdict().items():
        if g is not None:
            _check_equal(f"{tag} {name}", g, getattr(b, name))


def phase_axes_twins(sat, dev) -> dict:
    """10^6 renders through the kernels and through the plain twins in
    four chunks (_twin_pair), identical planes, each kernel run with the
    launch counts at 0 just before it: the reseeded solar-sail 1800x2000
    in Gas (KERNEL against
    PACKED), --depth (DEPTH_KERNEL against DEPTH) and a two-frame shared
    sequence; the float64 flagship through KERNEL, EXACT_KERNEL and a
    two-frame shared sequence."""
    from strange_attractor_tpu_torch.render import frame_generator, seeds_and_key

    B = sat.BinStrategy
    launches = {}
    depth = sat.RenderKind.DEPTH
    pairs = (("reseed gas", _reseed_pair(sat, B.KERNEL, B.PACKED),
              ("map_emit_gated", "bin_packed")),
             ("reseed depth", _reseed_pair(sat, B.DEPTH_KERNEL, B.DEPTH, render=depth),
              ("map_emit_gated", "bin_depth")),
             ("f64 kernel", _f64_pair(sat, B.KERNEL, B.PACKED), ("map_emit_f64", "bin_packed")),
             ("f64 exact-kernel", _f64_pair(sat, B.EXACT_KERNEL, B.EXACT),
              ("map_emit_f64", "bin_exact")))
    for label, (kern, plain), kernels in pairs:
        counters = _zero_counters()
        k = sat.render(kern, device=dev)
        torch.cuda.synchronize()
        launches[label] = _require_launches(f"[18] {label}", counters, kernels)
        _same_states(f"[18] 1e6 {label}", k, sat.render(plain, device=dev))
        print(f"[18] 1e6 {label}, {LANES} lanes, {AXES_RENDER_WARMUP}-step warm-up and chunks "
              f"of {AXES_RENDER_CHUNK}: kernels and plain twins give identical planes "
              f"(launches {launches[label]})")
    for label, cfg, kernels in (
            ("reseed shared", _reseed_pair(sat, B.KERNEL, B.PACKED)[0],
             ("map_emit_gated", "project_emit", "bin_packed")),
            ("f64 shared", _f64_pair(sat, B.KERNEL, B.PACKED)[0],
             ("map_emit_f64", "project_emit_f64", "bin_packed"))):
        seeds, key = seeds_and_key(cfg, frame_generator(cfg, 0))
        seeds = seeds.to(dev)
        angles = (0.0, math.radians(140.0))
        counters = _zero_counters()
        frames = sat.render_seeds_shared(cfg, seeds, angles, reseed_key=key)
        torch.cuda.synchronize()
        launches[label] = _require_launches(f"[18] {label}", counters, kernels)
        for f, (k, q) in enumerate(zip(frames, sat.render_seeds_shared(
                cfg, seeds, angles, plain=True, reseed_key=key))):
            _same_states(f"[18] {label} frame {f}", k, q)
        print(f"[18] 1e6 {label} sequence, 2 frames: kernels and twins give identical planes "
              f"(launches {launches[label]})")
    # the three sequence engines with both axes at once, at 10^6 a frame:
    # the per-frame engines frame for frame alike, a shared batch's first
    # frame theirs
    cfg = _flagship(sat, 1_000_000, dtype="float64", reseed_lanes=True)
    counters = _zero_counters()
    shared = sat.render_sequence_shared(cfg, [0.0, 90.0], frames_per_batch=2, device=dev)
    batched = sat.render_sequence_batched(cfg, [0.0, 90.0], frames_per_batch=2, device=dev)
    single = [img for _, img in sat.render_sequence(cfg, 0.0, 180.0, 90.0, device=dev)]
    launches["sequence engines"] = _require_launches(
        "[18] sequence engines", counters,
        ("map_emit_f64", "map_emit_gated", "project_emit_f64", "bin_packed"))
    if not (np.array_equal(shared[0], batched[0])
            and all(np.array_equal(batched[f], single[f]) for f in range(2))):
        raise AssertionError("[18] the sequence engines' float64 reseeded frames differ")
    print(f"[18] 1e6 float64 reseeded rotation through render_sequence_shared, "
          f"render_sequence_batched and render_sequence: frames agree (launches "
          f"{launches['sequence engines']})")
    return launches


def _twin_pair(cfg, kernel, plain) -> tuple:
    """``cfg`` with phase 18's warm-up and chunks, through ``kernel`` and
    through ``plain``."""
    cfg = cfg.replace(lanes=LANES, warmup=AXES_RENDER_WARMUP, chunk_steps=AXES_RENDER_CHUNK)
    return cfg.replace(bin_strategy=kernel), cfg.replace(bin_strategy=plain)


def _reseed_pair(sat, kernel, plain, **kw) -> tuple:
    return _twin_pair(_reseeded(sat, 1_000_000, **kw), kernel, plain)


def _f64_pair(sat, kernel, plain) -> tuple:
    return _twin_pair(_flagship(sat, 1_000_000, dtype="float64"), kernel, plain)


def _pixel0(sat, dev, cfg, rate: float) -> dict:
    """One more render of the Gas ``cfg``: the share of its emitted points
    at pixel (0, 0) (count[0] over the points emitted) and the in-bounds
    points off pixel (0, 0) a second at ``rate`` iterations a second."""
    from strange_attractor_tpu_torch.ops.binning import u32

    lanes, chunk, nchunks = sat.plan_schedule(cfg)
    executed = lanes * chunk * nchunks
    count = u32(sat.render(cfg, device=dev).count.reshape(-1))
    total, flood = int(count.sum()), int(count[0])
    return {"pixel0_share": flood / executed, "on_canvas_share": total / executed,
            "useful_per_s": (total - flood) / executed * rate}


def phase_axes_renders(sat, dev, card: str) -> dict:
    """The slice's four paths at 10^9 and full width (solar-sail 1800x2000
    with reseeding in Gas and --depth, the float64 flagship through KERNEL
    and EXACT_KERNEL), each with the launch counts at 0 just before its
    first render, then three warm synchronized renders for the rate; the
    Gas solar-sail's pixel-0 share and useful rate, with and without
    reseeding."""
    B = sat.BinStrategy
    paths = {
        "solar_sail": (_solar_sail(sat, 10**9), ("map_emit", "bin_packed")),
        "reseed_solar_sail": (_reseeded(sat, 10**9), ("map_emit_gated", "bin_packed")),
        "reseed_solar_sail_depth": (_reseeded(sat, 10**9, render=sat.RenderKind.DEPTH),
                                    ("map_emit_gated", "bin_depth")),
        "f64_flagship": (_flagship(sat, 10**9, dtype="float64"), ("map_emit_f64", "bin_packed")),
        "f64_flagship_exact": (_flagship(sat, 10**9, dtype="float64",
                                         bin_strategy=B.EXACT_KERNEL),
                               ("map_emit_f64", "bin_exact")),
    }
    out = {name: _render_rates(sat, dev, cfg, f"[19] {name}", card, kernels)
           for name, (cfg, kernels) in paths.items()}
    for name in ("solar_sail", "reseed_solar_sail"):
        rate = max(out[name]["iters_per_s"])
        out[name]["flood"] = _pixel0(sat, dev, paths[name][0], rate)
        print(f"[19] {name} 10^9: pixel-0 share {out[name]['flood']['pixel0_share']:.6f} of the "
              f"points emitted, on the canvas {out[name]['flood']['on_canvas_share']:.4f}, "
              f"useful {out[name]['flood']['useful_per_s']:.4e} points/s on {card}")
    return out


def phase_axes_cli(sat, dev, out_dir: Path, card: str) -> dict:
    """The slice's CLI path: ``-p solar-sail --reseed-lanes -i 1e9 -w 1800
    -h 2000 -8`` through ``cli.main``, with the launch counts at 0 just
    before it; the state checkpointed by --save-state to read the image
    back: lit, with the gated kernel and the bin launched."""
    from strange_attractor_tpu_torch import cli

    out, npz = out_dir / "reseed", out_dir / "reseed.npz"
    counters = _zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(["-p", "solar-sail", "--reseed-lanes", "-i", "1000000000", "-w", "1800", "-h",
              "2000", "-8", "-q", "--seed", "1", "-o", str(out), "--save-state", str(npz)])
    wall = time.perf_counter() - t0
    launches = _require_launches("[20] cli", counters, ("map_emit", "map_emit_gated",
                                                        "bin_packed") + TONEMAP)
    cfg = _reseeded(sat, 10**9)
    img = sat.colorize(cfg, sat.load_state(str(npz), device=dev))[..., :3]
    lit = float((img.to(torch.int32).amax(dim=-1) > 0).float().mean())
    if not lit > 0.02:
        raise AssertionError(f"[20] reseeded solar-sail: image nearly blank: lit fraction {lit}")
    size = out.with_suffix(".png").stat().st_size
    print(f"[20] cli -p solar-sail --reseed-lanes 1800x2000 1e9 8-bit: lit {lit:.3f}, launches "
          f"{launches}, {size} bytes of PNG, wall {wall:.4f} s (with the checkpoint) on {card}")
    return {"launches": launches, "lit": lit, "wall": wall}


# ---------------------------------------------------------------------------
# Several devices on the one card (phases 21-25): lanes split over a device
# list that repeats the card, and torch.distributed ranks sharing it


def _planted(kind: str, npix: int, rng, special: bool) -> tuple:
    """One shard's flat planes of ``kind`` on the host: counts near 2^32,
    packed values over the whole u32 range with ties at 2^31 and 2^31 - 1,
    z ties across shards, both zeros (in EXACT, whose fold keeps the first
    of equal depths), the -1 sentinel and values below it. ``special``
    adds NaN depths of both signs, -0.0 in every float plane and steps where
    no point won: where merge_all's fold and the JAX merge part."""
    zvals = np.float32([-1.0, 0.0, 0.25, 0.5, 0.5, 2.0, -2.5] + [-0.0] * (kind == "exact"))
    zbuf = np.where(rng.random(npix) < 0.5, rng.normal(0, 1, npix),
                    zvals[rng.integers(0, len(zvals), npix)]).astype(np.float32)
    steps = rng.random(npix).astype(np.float32)
    if special:
        zbuf[rng.random(npix) < 0.05] = np.float32(np.nan)
        zbuf[rng.random(npix) < 0.05] = -np.float32(np.nan)
        zbuf[rng.random(npix) < 0.05] = -0.0
        steps[rng.random(npix) < 0.2] = -0.0
    else:
        steps[zbuf <= -1.0] = 0.0
    count = (2**32 - rng.integers(1, 2**10, npix)).astype(np.uint32)
    small = rng.random(npix) < 0.5
    count[small] = rng.integers(0, 9, int(small.sum()))
    packed = rng.integers(0, 2**32, npix, dtype=np.uint64).astype(np.uint32)
    packed[rng.random(npix) < 0.2] = np.uint32(0x80000000)
    packed[rng.random(npix) < 0.2] = np.uint32(0x7FFFFFFF)
    planes = {"packed": (count, packed), "depth": (zbuf,), "exact": (count, steps, zbuf)}[kind]
    return tuple(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)
                 for a in planes)


def _kinds() -> dict:
    from strange_attractor_tpu_torch.config import BinStrategy

    return {"packed": BinStrategy.PACKED, "depth": BinStrategy.DEPTH,
            "exact": BinStrategy.EXACT}


def phase_merge(sat, dev) -> dict:
    """merge_collective of 4 shards of 1920x1080 on the card: equal to
    merge_all's fold on planes as renders leave them (top-bit packed
    values, counts that wrap, z ties, both zeros, the sentinel), and to the
    same merge on the CPU (which the tests pin to the JAX merge) on planes
    with NaN depths and -0.0 everywhere; then each kind's merge timed."""
    from strange_attractor_tpu_torch.parallel import mesh

    rng = np.random.default_rng(21)
    ms = {}
    for kind, strategy in _kinds().items():
        shards = [tuple(p.to(dev) for p in _planted(kind, W * H, rng, False))
                  for _ in range(SHARDS)]
        got = mesh.merge_collective(shards, strategy)
        want = sat.merge_all([mesh.planes_to_state(p, strategy, (H, W)) for p in shards])
        _same_states(f"[21] {kind} merge against merge_all",
                     mesh.planes_to_state(got, strategy, (H, W)), want)
        special = [_planted(kind, W * H, rng, True) for _ in range(SHARDS)]
        got = mesh.merge_collective([tuple(p.to(dev) for p in s) for s in special], strategy)
        for i, (g, w) in enumerate(zip(got, mesh.merge_collective(special, strategy))):
            _check_equal(f"[21] {kind} merge of special planes, plane {i}, card against CPU",
                         g.cpu(), w)
        ms[kind] = _time_ms(lambda: mesh.merge_collective(shards, strategy), reps=20)
        print(f"[21] merge_collective of {SHARDS} shards of {W}x{H} {kind} planes: equal to "
              f"merge_all and to the CPU merge; {ms[kind]:.4f} ms")
    return ms


def _shard_reference(sat, dev, cfg, nshards: int, **kw):
    """merge_all of the ``nshards`` shards' render_seeds at the shard
    schedule with the shard generators' seeds: what render_sharded must
    equal bit for bit."""
    from strange_attractor_tpu_torch.parallel import mesh
    from strange_attractor_tpu_torch.render import seeds_and_key

    local = mesh.shard_config(cfg, nshards)
    states = []
    for s in range(nshards):
        seeds, key = seeds_and_key(local, mesh.shard_generator(cfg, s, nshards))
        states.append(sat.render_seeds(local, seeds.to(dev), reseed_key=key, **kw))
    return sat.merge_all(states)


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_sharded(sat, dev, card: str) -> dict:
    """The sharded renders on [cuda:0] x 4 through render_sharded, each
    with every launch count at 0 just before it: the flagship at 10^9, the
    --depth flagship and exact-kernel at 10^8, each bit-identical to
    merge_all of its four shard renders; its rate in turns with the
    unsharded render; then 4-chunk sharded renders through the kernels and
    through the plain twins, identical planes."""
    from strange_attractor_tpu_torch.ops.binning import u32
    from strange_attractor_tpu_torch.parallel import mesh

    B, devs = sat.BinStrategy, [dev] * SHARDS
    paths = {"flagship": (_flagship(sat, 10**9), ("map_emit", "bin_packed")),
             "depth": (_flagship(sat, 10**8, render=sat.RenderKind.DEPTH),
                       ("map_emit", "bin_depth")),
             "exact": (_flagship(sat, 10**8, bin_strategy=B.EXACT_KERNEL),
                       ("map_emit", "bin_exact"))}
    out = {}
    for name, (cfg, kernels) in paths.items():
        cfg = cfg.replace(silent=True)
        counters = _zero_counters()
        torch.cuda.synchronize()
        state = mesh.render_sharded(cfg, devs)
        torch.cuda.synchronize()
        launches = _require_launches(f"[22] sharded {name}", counters, kernels)
        _same_states(f"[22] sharded {name} against merge_all of its shards", state,
                     _shard_reference(sat, dev, cfg, SHARDS))
        lanes, chunk, nchunks = sat.plan_schedule(cfg)
        executed = lanes * chunk * nchunks
        unsharded = lambda: sat.render(cfg, device=dev)  # noqa: E731
        sharded = lambda: mesh.render_sharded(cfg, devs)  # noqa: E731
        turns = [_timed(fn) for fn in (unsharded, sharded, sharded, unsharded)]
        rates = {"unsharded": [executed / turns[0], executed / turns[3]],
                 "sharded": [executed / turns[1], executed / turns[2]]}
        counters = _zero_counters()
        unsharded()
        flat = {k: getattr(*counters[k]) for k in kernels}
        if state.count is not None:
            total = int(u32(state.count).sum())
            if not 0 < total <= executed:
                raise AssertionError(f"[22] sharded {name}: count sum {total}")
        print(f"[22] sharded {name} {W}x{H} {cfg.iterations:.0e} over {SHARDS} shards of "
              f"{lanes // SHARDS} lanes x {chunk} steps x {nchunks} chunks: equal to merge_all "
              f"of its shard renders; launches {launches} (unsharded {flat}); iters/s in turns "
              f"unsharded {rates['unsharded'][0]:.4e}, sharded {rates['sharded'][0]:.4e}, "
              f"{rates['sharded'][1]:.4e}, unsharded {rates['unsharded'][1]:.4e} on {card}")
        out[name] = {"launches": launches, "unsharded_launches": flat, "iters_per_s": rates}
    # the plain twins: four chunks of 8 steps per shard after a 16-step warm-up
    for name, kernel, plain in (("packed", B.KERNEL, B.PACKED),
                                ("depth", B.DEPTH_KERNEL, B.DEPTH),
                                ("exact", B.EXACT_KERNEL, B.EXACT)):
        cfg = _flagship(sat, LANES * 8 * 4, lanes=LANES, chunk_steps=8, warmup=16, silent=True,
                        render=sat.RenderKind.DEPTH if name == "depth" else sat.RenderKind.GAS)
        _same_states(f"[22] sharded {name}: kernels against plain twins",
                     mesh.render_sharded(cfg.replace(bin_strategy=kernel), devs),
                     mesh.render_sharded(cfg.replace(bin_strategy=plain), devs))
    print(f"[22] sharded 4-chunk renders through the kernels and the plain twins: identical "
          f"planes (Gas, --depth, exact)")
    return out


_RANK_WORKER = r'''
import json, sys, time
root, pid, nproc, port, out, backend = sys.argv[1:7]
sys.path.insert(0, root)
import numpy as np, torch
import chip_smoke as cs
import strange_attractor_tpu_torch as sat
from strange_attractor_tpu_torch.parallel import distributed as dist, mesh
from strange_attractor_tpu_torch.runtime import state_to_numpy

pid, nproc = int(pid), int(nproc)
addr = f"127.0.0.1:{port}"
dist.initialize(addr, nproc, pid, backend=backend, device="cuda:0")
cfg = cs._flagship(sat, 10**8).replace(silent=True)
counters = cs._zero_counters()
torch.cuda.synchronize()
t0 = time.perf_counter()
state = dist.render_distributed(cfg)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
launches = cs._require_launches("[23] render_distributed", counters, ("map_emit", "bin_packed"))
group = torch.distributed.group.WORLD
arrays = state_to_numpy(state)
for kind in ("packed", "exact"):
    mine = cs._planted(kind, cs.W * cs.H, np.random.default_rng(30 + pid), False)
    merged = mesh.merge_collective(tuple(p.to(dist.device()) for p in mine), cs._kinds()[kind],
                                    group)
    arrays.update({f"{kind}_{i}": p.cpu().numpy() for i, p in enumerate(merged)})
np.savez(f"{out}/rank{pid}.npz", **arrays)
planes = (state.count.reshape(-1), state.packed.reshape(-1))
mesh.merge_collective(planes, sat.BinStrategy.PACKED, group)
merge_s = [cs._timed(lambda: mesh.merge_collective(planes, sat.BinStrategy.PACKED, group))
           for _ in range(3)]
result = {"rank": pid, "backend": backend, "wall": wall, "launches": launches,
          "merge_s": merge_s}
if nproc == 2:
    from pathlib import Path
    from strange_attractor_tpu_torch import cli

    Path(f"{out}/cli{pid}").mkdir()
    rc = cli.main(["--coordinator", addr, "--num-processes", "2", "--process-id", str(pid),
                   "-i", "100000000", "-8", "--seed", "1", "-b", "-0.25",
                   "-o", f"{out}/cli{pid}/frame"])
    result["cli_rc"] = rc
torch.distributed.destroy_process_group()
print("RESULT " + json.dumps(result))
'''


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _ranks(out: Path, nproc: int, backend: str) -> list:
    """Run ``nproc`` ranks of _RANK_WORKER on the card, each with a time
    limit; returns their outputs and result lines."""
    root = str(Path(__file__).resolve().parent)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_WORKER, root, str(i), str(nproc),
                               port, str(out), backend], cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    results = []
    for i, (p, text) in enumerate(zip(procs, outs)):
        lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            raise AssertionError(f"[23] {backend} rank {i} of {nproc} failed "
                                 f"({p.returncode}):\n{text[-4000:]}")
        results.append(json.loads(lines[-1][len("RESULT "):]))
    return list(zip(outs, results))


def phase_distributed(sat, dev, out_dir: Path, card: str) -> dict:
    """Two torch.distributed ranks sharing the card over gloo render the
    flagship at 10^8 through render_distributed: both ranks hold the same
    planes, equal to render_sharded over two shards here; the PACKED
    canvas's all_reduce merge timed; then cli.main --coordinator in the
    same two ranks writes one PNG, on rank 0. One NCCL rank renders the
    same way and equals render_sharded over one shard."""
    from strange_attractor_tpu_torch.parallel import mesh

    cfg = _flagship(sat, 10**8).replace(silent=True)
    out = {}
    for backend, nproc in (("gloo", 2), ("nccl", 1)):
        work = out_dir / f"ranks_{backend}"
        work.mkdir()
        t0 = time.perf_counter()
        ranks = _ranks(work, nproc, backend)
        wall = time.perf_counter() - t0
        want = mesh.render_sharded(cfg, [dev] * nproc)
        # each rank also merged planted planes over the group: merge_all here
        planted = {kind: sat.merge_all(
            [mesh.planes_to_state(tuple(p.to(dev) for p in _planted(
                kind, W * H, np.random.default_rng(30 + i), False)), strategy, (W * H,))
             for i in range(nproc)]) for kind, strategy in _kinds().items() if kind != "depth"}
        for i in range(nproc):
            with np.load(work / f"rank{i}.npz") as got:
                for name in ("count", "packed"):
                    _check_equal(f"[23] {backend} rank {i} {name} against render_sharded",
                                 torch.from_numpy(got[name].view(np.int32)),
                                 getattr(want, name).cpu())
                for kind, fold in planted.items():
                    for j, plane in enumerate(p for p in fold if p is not None):
                        _check_equal(f"[23] {backend} rank {i} {kind} merge of planted planes "
                                     f"over the group, plane {j}, against merge_all",
                                     torch.from_numpy(got[f"{kind}_{j}"]), plane.cpu())
        res = [r for _, r in ranks]
        print(f"[23] {nproc} {backend} rank(s) on one card, flagship {W}x{H} 1e8: planes equal "
              f"to render_sharded over {nproc} shard(s), planted PACKED and EXACT planes merged "
              f"over the group equal to merge_all; render wall "
              + ", ".join(f"{r['wall']:.4f}" for r in res) + " s; launches "
              + ", ".join(str(r["launches"]) for r in res) + "; PACKED all_reduce merge "
              + ", ".join("/".join(f"{1e3 * t:.2f}" for t in r["merge_s"]) for r in res)
              + f" ms; {wall:.1f} s with the processes' start on {card}")
        out[backend] = {"wall": [r["wall"] for r in res], "merge_s": [r["merge_s"] for r in res],
                        "launches": [r["launches"] for r in res], "processes_s": wall}
        if nproc == 2:
            texts = [t for t, _ in ranks]
            if [r.get("cli_rc") for r in res] != [0, 0]:
                raise AssertionError(f"[24] cli ranks returned {[r.get('cli_rc') for r in res]}")
            written = [(work / f"cli{i}" / "frame.png").exists() for i in range(2)]
            said = ["Wrote image to" in t for t in texts]
            if written != [True, False] or said != [True, False]:
                raise AssertionError(f"[24] cli --coordinator: written {written}, said {said}")
            print(f"[24] cli.main --coordinator, 2 gloo ranks on one card, 1e8 8-bit: rank 0 "
                  f"wrote {(work / 'cli0' / 'frame.png').stat().st_size} bytes of PNG, rank 1 "
                  f"nothing")
    return out


def phase_sequence_sharded(sat, dev, card: str) -> dict:
    """render_sequence_sharded on a 2 x 2 grid of [cuda:0] x 4: 8 frames
    at 10^7, both orbits, each with every launch count at 0 just before
    it, equal to their compositions of render_sharded over a row's two
    devices; then each timed again, frames/s."""
    from strange_attractor_tpu_torch.parallel import mesh
    from strange_attractor_tpu_torch.render import _deliver, _host_frames, frame_generator

    cfg = _flagship(sat, 10**7).replace(silent=True)
    angles, devs = list(SEQ_ANGLES), [dev] * 4
    rad = np.radians(angles)
    out = {}
    for orbit, kernels in (("per-frame", ("map_emit", "bin_packed")),
                           ("shared", ("map_emit", "project_emit", "bin_packed"))):
        run = lambda: mesh.render_sequence_sharded(  # noqa: E731
            cfg, angles, devs, frame_axis=2, transparent=False, eight_bit=True, orbit=orbit)
        counters = _zero_counters()
        frames = run()
        launches = _require_launches(f"[25] {orbit}", counters, kernels)
        # rows of four frames: frames 0-3 and 4-7
        states = [mesh.render_sharded(cfg.replace(angle=float(rad[i])), devs[:2],
                                      frame_generator(cfg, i if orbit == "per-frame"
                                                      else i - i % 4))
                  for i in range(len(angles))]
        want = _host_frames(cfg, len(angles), False, True)
        _deliver(cfg, states, want, False, True)
        if not np.array_equal(frames, want):
            raise AssertionError(f"[25] {orbit}: frames differ from their composition")
        seconds = [_timed(run) for _ in range(2)]
        lit = float((frames[0].max(axis=-1) > 0).mean())
        print(f"[25] render_sequence_sharded {orbit}, 2 x 2 grid of one card, {len(angles)} "
              f"frames x 1e7: equal to render_sharded compositions, lit {lit:.3f}, launches "
              f"{launches}; " + ", ".join(f"{len(angles) / t:.4f}" for t in seconds)
              + f" frames/s on {card}")
        out[orbit] = {"launches": launches, "frames_per_s": [len(angles) / t for t in seconds]}
    return out


# ---------------------------------------------------------------------------
# The last modules (phases 26-29): precompile, doctor, --profile, and a
# whole 3840x2160 render through the CLI


_FIRST_FRAME_WORKER = r"""
import json, sys, time
t_process = time.perf_counter()
from pathlib import Path
root, out, card, warm = sys.argv[1:5]
sys.path.insert(0, root)
import torch
import chip_smoke as cs
import strange_attractor_tpu_torch as sat

dev = torch.device("cuda", 0)
cfg = cs._flagship(sat, 10**8)
result = {"warm": warm}
if warm == "precompile":
    t0 = time.perf_counter()
    state = sat.precompile(cfg, device=dev)
    result["precompile_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sat.colorize_convert_fetch(cfg, state, transparent=False, eight_bit=True)
    result["delivery_warm_s"] = time.perf_counter() - t0
run = cs._drive(sat, dev, cfg, Path(out) / "frame", card, f"[26] first frame ({warm})",
                ("map_emit", "bin_packed"))
result.update(wall=run["wall"], split=run["split"], launches=run["launches"],
              since_start=time.perf_counter() - t_process)
print("RESULT " + json.dumps(result))
"""


def _subprocess(tag: str, argv: list, timeout: int = 300) -> str:
    """Run ``argv`` from the repository's root with a time limit; return
    its output, or raise with its end if it failed."""
    root = Path(__file__).resolve().parent
    proc = subprocess.run(argv, cwd=root, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{tag} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    return proc.stdout


def _first_frame(out: Path, card: str, warm: str) -> dict:
    out.mkdir()
    text = _subprocess(f"[26] first frame ({warm})",
                       [sys.executable, "-c", _FIRST_FRAME_WORKER,
                        str(Path(__file__).resolve().parent), str(out), card, warm])
    print("\n".join(ln for ln in text.splitlines() if ln.startswith("[26]")))
    return json.loads([ln for ln in text.splitlines() if ln.startswith("RESULT ")][-1][7:])


def _precompiled(sat) -> dict:
    """precompile's other paths at 10^9: (config, pinned strategy or None,
    the kernels it must launch: kernel A's instantiation and the bin)."""
    pin = sat.BinStrategy
    return {
        "depth": (_flagship(sat, 10**9, render=sat.RenderKind.DEPTH), None,
                  ("map_emit", "bin_depth")),
        "exact": (_flagship(sat, 10**9), pin.EXACT_KERNEL, ("map_emit", "bin_exact")),
        "exact16_value": (_flagship(sat, 10**9), pin.EXACT16_KERNEL,
                          ("map_emit", "bin_exact16")),
        "exact16_earliest": (_flagship(sat, 10**9, exact16_ties="earliest"),
                             pin.EXACT16_KERNEL, ("map_emit", "bin_exact16")),
        "reseeded": (_reseeded(sat, 10**9), None, ("map_emit_gated", "bin_packed")),
        "float64": (_flagship(sat, 10**9, dtype="float64"), None,
                    ("map_emit_f64", "bin_packed")),
    }


def phase_precompile(sat, dev, out_dir: Path, card: str) -> dict:
    """The 10^8 flagship frame in a fresh process, first without
    ``precompile`` and then after ``precompile`` (and the delivery warmed
    with its state, as its docstring says): wall and split of each; then
    ``precompile`` of each other path at 10^9 (DEPTH_KERNEL, EXACT_KERNEL,
    EXACT16_KERNEL in both tie modes, reseeded solar-sail, the float64
    flagship), each with the launch counts at 0 just before it: a state of
    the strategy's planes and the config's canvas on the card, the path's
    kernels launched."""
    out = {warm: _first_frame(out_dir / f"first_{warm}", card, warm)
           for warm in ("cold", "precompile")}
    for warm, r in out.items():
        extra = "" if warm == "cold" else (f"; precompile {r['precompile_s']:.4f} s, delivery "
                                           f"warmed in {r['delivery_warm_s']:.4f} s before it")
        print(f"[26] first 1e8 frame of a fresh process ({warm}): wall {r['wall']:.4f} s "
              f"(render {r['split']['render']:.4f}, colorize + convert "
              f"{r['split']['colorize_convert']:.4f}, copy {r['split']['host_copy']:.4f}, PNG "
              f"{r['split']['png']:.4f}); {r['since_start']:.3f} s from the process's start"
              f"{extra} on {card}")
    for name, (cfg, pin, kernels) in _precompiled(sat).items():
        counters = _zero_counters()
        t0 = time.perf_counter()
        state = sat.precompile(cfg, pin, device=dev)
        seconds = time.perf_counter() - t0
        launches = _require_launches(f"[26] precompile {name}", counters, kernels)
        want = (pin or cfg.resolved_bin_strategy()).planes_kind()
        if state.strategy != want or state.shape != (cfg.height, cfg.width) \
                or state.device != dev:
            raise AssertionError(f"[26] precompile {name}: {state.strategy} {state.shape} on "
                                 f"{state.device}, wanted {want} {(cfg.height, cfg.width)} on "
                                 f"{dev}")
        print(f"[26] precompile {name}: {state.strategy.value} planes {state.shape} on "
              f"{state.device} in {seconds:.4f} s, launches {launches}")
        out[name] = {"s": seconds, "launches": launches}
    return out


def phase_doctor(card: str) -> dict:
    """``python -m strange_attractor_tpu_torch doctor`` in a fresh process:
    exit code 0, ``doctor: OK``, both agreement figures and the throughput
    line."""
    t0 = time.perf_counter()
    text = _subprocess("[27] doctor", [sys.executable, "-m", "strange_attractor_tpu_torch",
                                       "doctor"])
    seconds = time.perf_counter() - t0
    lines = text.splitlines()
    agree = {ln.split("(")[1].split(",")[0]: float(ln.split(": ")[1].split("%")[0])
             for ln in lines if ln.startswith("oracle agreement (")}
    throughput = [ln for ln in lines if ln.startswith("throughput: ")]
    if set(agree) != {"exact-kernel", "kernel"} or not throughput \
            or lines[-1] != "doctor: OK":
        raise AssertionError(f"[27] doctor's report is incomplete:\n{text}")
    for ln in lines:
        print(f"[27] {ln}")
    print(f"[27] doctor took {seconds:.2f} s with the process's start on {card}")
    return {"agreement_pct": agree, "throughput": throughput[0][len("throughput: "):],
            "s": seconds}


def phase_profile(sat, dev, out_dir: Path, card: str) -> dict:
    """A 10^8 CLI frame with ``--profile DIR``, the launch counts at 0 just
    before it: the trace file parses as JSON and names kernel A's and
    ``bin_packed``'s CUDA kernels (names, not counts: a trace may lose its
    first kernels)."""
    from strange_attractor_tpu_torch import cli

    trace_dir = out_dir / "profile"
    counters = _zero_counters()
    t0 = time.perf_counter()
    cli.main(["-i", "100000000", "-8", "--seed", "1", "-b", "-0.25", "-q", "--profile",
              str(trace_dir), "-o", str(out_dir / "profiled")])
    wall = time.perf_counter() - t0
    launches = _require_launches("[28] --profile", counters, ("map_emit", "bin_packed"))
    files = list(trace_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"[28] --profile wrote {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = {e["name"].split("(")[0] for e in events if e.get("cat") == "kernel"}
    named = {want: sorted(k for k in kernels if want in k)
             for want in ("map_emit", "bin_packed_kernel")}
    if not all(named.values()):
        raise AssertionError(f"[28] the trace names no {named}: {sorted(kernels)}")
    print(f"[28] cli --profile, flagship 1e8: wall {wall:.4f} s with the trace, launches "
          f"{launches}; {files[0].stat().st_size} bytes of trace, {len(events)} events, "
          f"CUDA kernels {sorted(kernels)} on {card}")
    return {"wall": wall, "launches": launches, "kernels": sorted(kernels)}


def _png_size(path: Path) -> tuple:
    """(width, height) of an 8-bit RGB PNG from its IHDR, after checking
    that its IDAT inflates to a filter byte and a row of pixels a row."""
    import struct
    import zlib

    data = path.read_bytes()
    width, height, depth, color = struct.unpack(">IIBB", data[16:26])
    idat, pos = b"", 8
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if kind == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    if (depth, color) != (8, 2) or len(zlib.decompress(idat)) != height * (1 + 3 * width):
        raise AssertionError(f"[29] {path.name}: not a whole 8-bit RGB image")
    return width, height


def _uhd_twins(sat, dev, cfg, row: dict) -> float:
    """Kernel A and ``bin_packed`` held against their plain twins at the 4K
    frame's own shapes: the seeded lanes' warm-up and two chunks through
    ``map_emit`` and ``map_emit_plain`` (streams and lane state), and the
    timing row's chunks binned onto two clones of its standing planes
    through ``bin_packed`` and ``bin_chunk_packed``."""
    from strange_attractor_tpu_torch.ops import binning, emit, kernel_binning as kb
    from strange_attractor_tpu_torch.render import seed_generator

    lanes, chunk, _ = sat.plan_schedule(cfg)
    kind = cfg.resolved_bin_strategy().planes_kind()
    spec = emit.emit_spec(cfg, cfg.angle)
    pk = emit.seed_points(lanes, seed_generator(cfg)).to(dev).t().contiguous()
    pp = pk.clone()
    emit.map_emit(spec, pk, cfg.warmup, emit=False)
    emit.map_emit_plain(spec, pp, cfg.warmup, emit=False)
    err = _check_equal("[29] 4K warm-up state", pk, pp)
    for c in range(2):
        fk, qk = emit.map_emit(spec, pk, chunk, kind=kind)
        fp, qp = emit.map_emit_plain(spec, pp, chunk, kind=kind)
        err = max(err, _check_equal(f"[29] 4K chunk {c} flat", fk, fp),
                  _check_equal(f"[29] 4K chunk {c} packed", qk, qp),
                  _check_equal(f"[29] 4K chunk {c} state", pk, pp))
    size, npix = f"{cfg.width}x{cfg.height}", cfg.width * cfg.height
    print(f"[29] kernel A at {size}: warm-up + 2 x {chunk} steps at {lanes} lanes bit-identical "
          f"(out of bounds {float((fk == npix).float().mean()):.3f}, pixel-0 share "
          f"{float((fk == 0).float().mean()):.3f})")
    ck, qk = (p.clone() for p in row["planes"])
    cp, qp = (p.clone() for p in row["planes"])
    for f, p in row["chunks"]:
        ck, qk = kb.bin_chunk_kernel(ck, qk, f, p)
        cp, qp = binning.bin_chunk_packed(cp, qp, f, p)
    err = max(err, _check_equal("[29] 4K bin_packed count", ck, cp),
              _check_equal("[29] 4K bin_packed packed", qk, qp))
    print(f"[29] bin_packed at {size}: {len(row['chunks'])} render chunks onto the state of "
          f"{HONEST_WARM} bit-identical, count and packed")
    return err


def phase_4k(sat, dev, out_dir: Path, card: str) -> dict:
    """The flagship at 3840x2160 and 10^9 through the CLI (``-w 3840 -h
    2160 -i 1000000000 -8``), the launch counts at 0 just before it: the
    PNG decodes to 3840x2160 and kernel A and ``bin_packed`` launched. Then
    the same frame through the package's calls for its split (render,
    colorize + convert, copy, PNG) and lit share; the two PNGs are the same
    bytes. Last, ``bin_packed`` timed at 4K as phase 3 times it at 1080p,
    with its library yardstick, and kernel A and ``bin_packed`` held
    against their twins at 4K (:func:`_uhd_twins`)."""
    from strange_attractor_tpu_torch import cli
    from strange_attractor_tpu_torch.ops import binning, kernel_binning as kb

    cfg = _flagship(sat, 10**9).replace(width=3840, height=2160)
    counters = _zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(["-w", "3840", "-h", "2160", "-i", "1000000000", "-8", "--seed", "1", "-b",
              "-0.25", "-q", "-o", str(out_dir / "uhd_cli")])
    wall = time.perf_counter() - t0
    launches = _require_launches("[29] 4K cli", counters, ("map_emit", "bin_packed") + TONEMAP)
    size = _png_size(out_dir / "uhd_cli.png")
    if size != (3840, 2160):
        raise AssertionError(f"[29] the CLI's PNG is {size}")
    run = _drive(sat, dev, cfg, out_dir / "uhd", card, "[29] 4K", ("map_emit", "bin_packed"))
    if (out_dir / "uhd.png").read_bytes() != (out_dir / "uhd_cli.png").read_bytes():
        raise AssertionError("[29] the CLI's 4K PNG differs from the package's")
    lit = float((run["image"].max(axis=-1) > 0).mean())
    rate = run["executed"] / run["t_render"]
    print(f"[29] cli -w 3840 -h 2160 -i 1e9 -8: PNG {size[0]}x{size[1]}, lit {lit:.4f}, "
          f"launches {launches}, wall {wall:.4f} s end to end; the package's frame "
          f"{rate:.4e} iters/s, wall {run['wall']:.4f} s on {card}")
    row = _honest_bin(sat, dev, cfg, kb.bin_chunk_kernel, binning.bin_chunk_packed,
                      "[29] bin_packed 4K")
    library = _library_bin_packed(dev, cfg.width * cfg.height, row["planes"], row["chunks"], "4K")
    err = _uhd_twins(sat, dev, cfg, row)
    return {"cli_wall": wall, "launches": launches, "lit": lit, "iters_per_s": rate,
            "wall": run["wall"], "split": run["split"], "err": err,
            "bin_packed": {**_public(row), "library_ms": sum(library.values()),
                           "library_parts": library}}


# phase 30's renders of the reference workload: (bin strategy, EXACT16
# ties) and the kernels each must launch
PARITY_RUNS = (("auto", "value"), ("exact-kernel", "value"), ("exact16-kernel", "value"),
               ("exact16-kernel", "earliest"))
PARITY_KERNELS = {"auto": ("map_emit", "bin_packed"), "exact-kernel": ("map_emit", "bin_exact"),
                  "exact16-kernel": ("map_emit", "bin_exact16")}


def _parity_run(cr, cfg, out: Path, reference: Path, dev, kernels: tuple, tag: str,
                card: str) -> dict:
    """One render of the reference workload through the tool
    (``precompile``, the timed render, the 8-bit delivery, the PNG), the
    launch counts at 0 just before it, then its metrics against
    ``reference``."""
    counters = _zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = cr.render_workload(cfg, out, dev)
    wall = time.perf_counter() - t0
    launches = _require_launches(tag, counters, kernels + TONEMAP)
    metrics = cr.compare(reference, run["path"])
    print(f"{tag}: MAD {metrics['mad']:.6f}, correlation {metrics['correlation']:.6f}, "
          f"support IoU {metrics['support_iou']:.6f} against {reference.name}; render "
          f"{run['iters_per_s']:.4e} iters/s ({run['seconds']:.4f} s), wall {wall:.4f} s "
          f"(precompile + render + delivery + PNG), launches {launches} on {card}")
    return {**metrics, "iters_per_s": run["iters_per_s"], "render_s": run["seconds"],
            "wall_s": wall, "launches": launches}


def phase_reference_parity(sat, dev, out_dir: Path, card: str) -> dict:
    """The reference workload (poisson-saturne, 10^9, brightness -0.25, seed
    0, 1920x1080, 8-bit) through ``tools.compare_reference`` under AUTO
    (KERNEL), exact-kernel and exact16-kernel in both tie modes, each held
    to media/poisson-saturne-tpu.png by the JAX tool's rule (MAD < 0.01,
    correlation > 0.99); raises after all four if any failed. Then, a
    finding with no bound, the thomas preset at 10^9 and 1920x1080 (seed
    0) against media/thomas.png, at the preset's brightness and at offset
    -0.2."""
    from strange_attractor_tpu_torch.tools import compare_reference as cr

    out, failed = {}, []
    for strategy, ties in PARITY_RUNS:
        name = strategy if strategy != "exact16-kernel" else f"{strategy}[{ties}]"
        cfg = cr.workload(strategy, exact16_ties=ties, silent=True)
        run = _parity_run(cr, cfg, out_dir / f"parity_{name}", cr.DEFAULT_REFERENCE, dev,
                          PARITY_KERNELS[strategy], f"[30] {name}", card)
        ok = cr.passes(run)
        print(f"[30] {name}: PARITY: {'PASS' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
        out[name] = run
    # media/thomas.png's settings were not recorded; its lit pixels read as
    # a brightness offset near -0.2, where the preset's default is -0.15
    for name, offset in (("thomas", -0.15), ("thomas_b-0.2", -0.2)):
        thomas = sat.presets.thomas(
            iterations=10**9, width=W, height=H, seed=0, silent=True,
            colors=sat.Colors(brightness=sat.BrightnessConstants(offset=offset)))
        out[name] = _parity_run(cr, thomas, out_dir / f"parity_{name}",
                                cr.REPO / "media" / "thomas.png", dev, ("map_emit", "bin_packed"),
                                f"[30] {name} (finding, no bound)", card)
    if failed:
        raise AssertionError(f"[30] PARITY: FAIL under {failed} (the JAX tool's rule: MAD < 0.01 "
                             f"and correlation > 0.99)")
    return out


CERTIFY_CANVASES = ((1920, 1080), (3840, 2160))


def phase_certify(card: str) -> dict:
    """``tools.check_kernels.certify_kernels`` on the card at 2^20 points
    over 1920x1080 and over 3840x2160: the four bin entry points, five
    disciplines, each bit-identical to the sequential reference, each
    launched once (counted); then each kernel's ms for the planted chunk
    onto fresh planes (``chunk_ms``)."""
    from strange_attractor_tpu_torch.tools import check_kernels as ck

    want = {"bin_packed": 1, "bin_exact": 1, "bin_exact16": 2, "bin_depth": 1}
    out = {}
    for w, h in CERTIFY_CANVASES:
        tag = f"[31] {w}x{h}"
        counters = _zero_counters()
        t0 = time.perf_counter()
        ck.certify_kernels(1 << 20, w * h, device="cuda", log=lambda line: print(f"{tag} {line}"))
        seconds = time.perf_counter() - t0
        launches = {name: getattr(*counters[name]) for name in want}
        if launches != want:
            raise AssertionError(f"{tag}: launches {launches}, expected {want}")
        ms = ck.chunk_ms(1 << 20, w * h, device="cuda")
        print(f"{tag}: certified in {seconds:.2f} s, launches {launches}; ms a 2^20-point "
              f"chunk onto fresh planes " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
              + f" on {card}")
        out[f"{w}x{h}"] = {"seconds": seconds, "launches": launches, "chunk_ms": ms}
    return out


# phase 32: kernel T's canvases, its states' iterations, and its output
# modes: (config transparent, output transparent, eight_bit), the CLI's
# four deliveries (the two flags equal), colorize()'s RGBA of an opaque
# config and a transparent config delivered without alpha
TONEMAP_CANVASES = ((1920, 1080), (3840, 2160))
TONEMAP_ITERS = 100_000_000
TONEMAP_MODES = ((True, True, False), (True, True, True), (False, False, False),
                 (False, False, True), (False, True, False), (False, True, True),
                 (True, False, False), (True, False, True))
# float32 and float64 operations a pixel: the Gas pass (unpacking 3, the
# palette lerp and its square roots 20, the brightness 16, the saturating
# casts and the 8-bit conversion 11; one log1p in double, ~20 operations)
# and the Depth pass (the reverse lerp and its cast)
TONEMAP_OPS = {"gas": (50, 20), "depth": (8, 0)}


def _tonemap_bound(npix: int, in_bytes: int, out_bytes: int, kind: str) -> dict:
    """Kernel T's bound for one frame: each plane it reads once, the image
    written once, and its operations at the float32 and float64 rates."""
    f32_ops, f64_ops = (n * npix for n in TONEMAP_OPS[kind])
    row = _bound(npix * (in_bytes + out_bytes), f32_ops)
    by_ops = (f32_ops / PEAK_OPS + f64_ops / PEAK_OPS_F64) * 1e3
    row.update(flops=f32_ops + f64_ops, f64_flops=f64_ops)
    if by_ops > row["bound_ms"]:
        row.update(bound_ms=by_ops, bound_by="operations")
    return row


def _tonemap_cases(sat, dev, w: int, h: int) -> list:
    """Phase 32's cases at ``w`` x ``h``: (name, state, render kind,
    colors). The states are the flagship's (PACKED by AUTO, EXACT by
    exact-kernel, DEPTH by --depth) and solar-sail's (PACKED), rendered at
    TONEMAP_ITERS on the card, blank ones, and planted ones made from them
    with a seeded generator on the card: counts from 2^31 up (2^32 - 1
    among them), NaN, infinite and >= 1.0 steps, special and NaN depths
    (a NaN at the flood pixel (0, 0)), an all-negative plane and a flat
    one. Gas cases under the default palette, a 64-stop one, and
    brightness that saturates up and down."""
    B, K = sat.BinStrategy, sat.RenderKind
    flag = _flagship(sat, TONEMAP_ITERS).replace(width=w, height=h)
    packed = sat.render(flag, device=dev)
    exact = sat.render(flag.replace(bin_strategy=B.EXACT_KERNEL), device=dev)
    depth = sat.render(flag.replace(render=K.DEPTH), device=dev)
    sail = sat.render(_solar_sail(sat, TONEMAP_ITERS).replace(width=w, height=h), device=dev)
    gen = torch.Generator(device=dev).manual_seed(32)

    def mask(p: float) -> torch.Tensor:
        return torch.rand((h, w), generator=gen, device=dev) < p

    big = torch.where(mask(0.5), packed.count | torch.iinfo(torch.int32).min, packed.count)
    big.view(-1)[7] = -1
    special = torch.tensor([np.nan, 1.0, 1.5, np.inf, -np.inf, -0.5, -0.0, 0.999999,
                            np.nextafter(np.float32(1.0), np.float32(0.0)), 1e-30],
                           dtype=torch.float32, device=dev)
    steps = torch.where(mask(0.01), special[0], exact.steps)
    steps.view(-1)[:400] = special.repeat(40)
    zbuf = depth.zbuf
    valid = zbuf != -1.0
    nan_z = zbuf.clone()
    nan_z[0, 0] = float("nan")
    nan_z.view(-1)[w * h // 2] = float("nan")
    special_z = zbuf.clone()
    special_z.view(-1)[:90] = torch.tensor([np.inf, -np.inf, -0.0, 0.0, 3.4e38, -3.4e38, 1e-40,
                                            -1.0, 5.0], dtype=torch.float32,
                                           device=dev).repeat(10)
    blank = sat.RenderState.create(flag, device=dev)
    state = sat.RenderState
    pal64 = sat.Colors(palette=sat.Palette(
        np.random.default_rng(64).random((64, 3)).round(6).tolist()))
    bright = sat.Colors(brightness=sat.BrightnessConstants(offset=0.6, factor=2.5))
    dark = sat.Colors(brightness=sat.BrightnessConstants(offset=-1.5, factor=1.0))
    plain = flag.colors
    gas = [("flagship", packed, plain), ("flagship 64-stop", packed, pal64),
           ("flagship bright", packed, bright), ("flagship dark", packed, dark),
           ("exact", exact, plain), ("exact 64-stop", exact, pal64),
           ("exact bright", exact, bright), ("solar-sail dark", sail, dark),
           ("exact special steps", exact._replace(steps=steps), plain),
           ("counts from 2^31", packed._replace(count=big), plain),
           ("empty", blank, plain), ("solar-sail", sail, plain),
           ("solar-sail 64-stop", sail, pal64)]
    cases = [(name, st, K.GAS, colors) for name, st, colors in gas]
    depths = [("flagship packed", packed), ("exact", exact), ("depth", depth),
              ("solar-sail", sail), ("NaN z", state(zbuf=nan_z)),
              ("all-negative", state(zbuf=-zbuf.abs() - 0.5)),
              ("flat", state(zbuf=torch.where(valid, 0.25, zbuf))),
              ("all-sentinel", sat.RenderState.create(flag.replace(render=K.DEPTH), device=dev)),
              ("special z", state(zbuf=special_z))]
    return cases + [(name, st, K.DEPTH, plain) for name, st in depths]


def _tonemap_check(tag: str, got: torch.Tensor, want: torch.Tensor, state) -> float:
    """The largest channel difference of ``got`` and ``want`` (0.0 when
    they are equal); raises unless they hold the same bytes, the message
    counting the channels that differ, those by one step, and giving the
    planes' values at the first of them."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tag}: {tuple(got.shape)} {got.dtype} against {tuple(want.shape)} "
                             f"{want.dtype}")
    if torch.equal(got, want):
        return 0.0
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    bad = diff.nonzero()[:4].tolist()
    inputs = {name: [plane[y, x].item() for y, x, _ in bad]
              for name, plane in state._asdict().items() if plane is not None}
    raise AssertionError(f"{tag}: {int((diff > 0).sum())} channels differ by up to "
                         f"{int(diff.max())} "
                         f"({int((diff == 1).sum())} by one step), first at {bad}: kernel "
                         f"{[got[tuple(b)].item() for b in bad]}, twin "
                         f"{[want[tuple(b)].item() for b in bad]}, planes {inputs}")


def _same_stats(tag: str, got: tuple, want: tuple) -> None:
    for g, w in zip(got, want):
        g, w = float(g), float(w)
        if not (g == w or (math.isnan(g) and math.isnan(w))):
            raise AssertionError(f"{tag}: stats {[float(x) for x in got]}, twin "
                                 f"{[float(x) for x in want]}")


def _twin_stats(cfg, planes) -> tuple:
    """What kernel T's reduction must leave for ``planes``: ``colorize_stats``,
    for Gas beside the log1p of the max count that the pass divides by."""
    from strange_attractor_tpu_torch.ops.colorize import _log1p_f32, colorize_stats

    stats = colorize_stats(cfg, *planes)
    return stats if len(stats) == 2 else (stats[0], _log1p_f32(stats[0]))  # Depth, Gas


def _tonemap_canvas(sat, dev, w: int, h: int) -> tuple:
    """Every case of :func:`_tonemap_cases` in every mode of TONEMAP_MODES:
    kernel T against the plain chain on the card and against the plain
    chain on the CPU on the same planes copied to the host, byte for byte;
    the reduction's stats against the plain chain's on both. Returns the
    number of images compared and the largest channel difference seen."""
    from strange_attractor_tpu_torch.ops.colorize import (_tonemap_stats, colorize_planes,
                                                          state_planes, tonemap)
    from strange_attractor_tpu_torch.utils.export import convert_format_device

    base = _flagship(sat, TONEMAP_ITERS).replace(width=w, height=h)
    compared, err = 0, 0.0
    for name, state, kind, colors in _tonemap_cases(sat, dev, w, h):
        host = sat.RenderState(*(None if p is None else p.cpu() for p in state))
        for cfg_t in (False, True):
            cfg = base.replace(render=kind, colors=colors, transparent=cfg_t)
            tag = f"[32] {w}x{h} {name} ({kind.value}, transparent config {cfg_t})"
            _same_stats(tag + " stats, card twin", _tonemap_stats(cfg, state),
                        _twin_stats(cfg, state_planes(state)))
            _same_stats(tag + " stats, CPU twin", _tonemap_stats(cfg, state),
                        _twin_stats(cfg, state_planes(host)))
            card = colorize_planes(cfg, *state_planes(state))
            cpu = colorize_planes(cfg, *state_planes(host))
            for _, transparent, eight_bit in (m for m in TONEMAP_MODES if m[0] == cfg_t):
                got = tonemap(cfg, state, transparent=transparent, eight_bit=eight_bit)
                mode = f"{tag} -> {'RGBA' if transparent else 'RGB'} {8 if eight_bit else 16}-bit"
                err = max(err, _tonemap_check(mode + " against the card twin", got,
                                              convert_format_device(card, transparent, eight_bit),
                                              state),
                          _tonemap_check(mode + " against the CPU twin", got.cpu(),
                                         convert_format_device(cpu, transparent, eight_bit),
                                         host))
                compared += 1
    torch.cuda.synchronize()
    return compared, err


def _tonemap_timing(sat, dev, w: int, h: int) -> dict:
    """ms a frame of kernel T (its reduction and pass) and of the plain
    chain on the card, by CUDA events, for the flagship's PACKED state to
    8-bit RGB (the CLI's delivery) and to u16 RGBA, and for its DEPTH state
    to 8-bit RGB; each with its bound. Then kernel T's launches for one
    ``colorize_convert_fetch``, counted."""
    from strange_attractor_tpu_torch.ops.colorize import (_tonemap_stats, colorize_planes,
                                                          state_planes, tonemap)
    from strange_attractor_tpu_torch.utils.export import convert_format_device

    npix = w * h
    flag = _flagship(sat, TONEMAP_ITERS).replace(width=w, height=h)
    rgba = flag.replace(transparent=True)
    depth_cfg = flag.replace(render=sat.RenderKind.DEPTH)
    packed = sat.render(flag, device=dev)
    depth = sat.render(depth_cfg, device=dev)
    rows = {}
    for name, cfg, state, transparent, eight_bit, in_bytes, kind in (
            ("gas_rgb8", flag, packed, False, True, 8, "gas"),
            ("gas_rgba16", rgba, packed, True, False, 8, "gas"),
            ("depth_rgb8", depth_cfg, depth, False, True, 4, "depth")):
        out_bytes = (4 if transparent else 3) * (1 if eight_bit else 2)
        ms = _time_ms(lambda: tonemap(cfg, state, transparent=transparent, eight_bit=eight_bit),
                      reps=50)
        plain_ms = _time_ms(lambda: convert_format_device(
            colorize_planes(cfg, *state_planes(state)), transparent, eight_bit), reps=10)
        rows[name] = {"ms": ms, "plain_ms": plain_ms,
                      **_tonemap_bound(npix, in_bytes, out_bytes, kind)}
    rows["gas_rgb8"]["stats_ms"] = _time_ms(lambda: _tonemap_stats(flag, packed), reps=50)
    counters = _zero_counters()
    sat.colorize_convert_fetch(flag, packed, transparent=False, eight_bit=True)
    rows["launches_per_frame"] = {k: getattr(*counters[k]) for k in TONEMAP}
    if rows["launches_per_frame"] != {"tonemap_stats": 1, "tonemap": 1}:
        raise AssertionError(f"[32] a delivery launched {rows['launches_per_frame']}, not one "
                             f"reduction and one pass")
    return rows


PNG_LAYOUTS = ((False, True), (True, True), (False, False), (True, False))


def _sha256(path: Path) -> str:
    import hashlib

    return hashlib.sha256(path.read_bytes()).hexdigest()


def _host_filter_rows(host: np.ndarray):
    """(rows, bpp) of a host image's PNG scanlines (16-bit big-endian)."""
    from strange_attractor_tpu_torch.utils import export

    raw = np.ascontiguousarray(export._png_geometry(host)[4])
    return raw.reshape(host.shape[0], -1).view(np.uint8), host.shape[-1] * host.itemsize


def _png_filter_frame(sat, dev, cfg, out_dir: Path, tag: str, card: str) -> dict:
    """Kernel F on one 10^9 frame of ``cfg`` in the four layouts (see
    phase 33 in the module docstring); returns each layout's times."""
    from strange_attractor_tpu_torch.ops import png_filter as pf
    from strange_attractor_tpu_torch.ops.colorize import tonemap
    from strange_attractor_tpu_torch.utils import export, native

    state = sat.render(cfg, device=dev)
    out = {}
    for transparent, eight_bit in PNG_LAYOUTS:
        name = f"{'rgba' if transparent else 'rgb'}{8 if eight_bit else 16}"
        img = tonemap(cfg, state, transparent=transparent, eight_bit=eight_bit)
        before = pf.png_filter.launches
        got = pf.png_filter(img)
        if pf.png_filter.launches != before + 1:
            raise AssertionError(f"[33] {tag} {name}: png_filter did not launch kernel F")
        _check_equal(f"[33] {tag} {name} kernel F", got, pf.png_filter_plain(img))
        host = img.cpu().numpy()
        rows, bpp = _host_filter_rows(host)
        want = export._filter_scanlines_numpy(rows, bpp)
        kernel_bytes = got.cpu().numpy().tobytes()
        if kernel_bytes != want:
            raise AssertionError(f"[33] {tag} {name}: kernel F differs from "
                                 f"_filter_scanlines_numpy")
        if native.png_filter_adaptive(rows, bpp) not in (None, want):
            raise AssertionError(f"[33] {tag} {name}: the native filter differs")
        picks = np.bincount(got[:, 0].cpu().numpy(), minlength=5).tolist()
        # the delivery's array, written through the card and through the host
        image = sat.colorize_convert_fetch(cfg, state, transparent=transparent,
                                           eight_bit=eight_bit)
        before = pf.png_filter.launches
        via_card = export.write_image(out_dir / f"{tag}-{name}-card", image,
                                      transparent=transparent, eight_bit=eight_bit, announce=False)
        if pf.png_filter.launches != before + 1 or export._take_device_copy(image) is not None:
            raise AssertionError(f"[33] {tag} {name}: the PNG did not take the card path")
        via_host = export.write_image(out_dir / f"{tag}-{name}-host", np.array(image),
                                      transparent=transparent, eight_bit=eight_bit, announce=False)
        if pf.png_filter.launches != before + 1:
            raise AssertionError(f"[33] {tag} {name}: a fresh array took the card path")
        sha = _sha256(via_card)
        if sha != _sha256(via_host):
            raise AssertionError(f"[33] {tag} {name}: the card path's PNG differs from the "
                                 f"host filter's")
        nbytes = host.nbytes + len(want)
        row = {"ms": _time_ms(lambda: pf.png_filter(img), 50),
               "plain_ms": _time_ms(lambda: pf.png_filter_plain(img), 5), "bytes": nbytes,
               "bound_ms": nbytes / PEAK_BYTES * 1e3, "picks": picks, "sha256": sha,
               "library_ms": None, "library_note": "no single PyTorch call filters scanlines"}
        row["card_path_ms"] = _wall_ms(lambda: export._filter_on_device(img), 20)
        row["host_native_ms"] = _wall_ms(lambda: native.png_filter_adaptive(rows, bpp), 5)
        print(f"[33] {tag} {cfg.width}x{cfg.height} {name}: kernel F bit-identical to its twin, "
              f"to _filter_scanlines_numpy and to the native filter (filter types {picks}); "
              f"the card path's PNG sha256 {sha[:16]} = the host filter's; kernel "
              f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB; "
              f"bytes), plain twin {row['plain_ms']:.3f} ms, card path {row['card_path_ms']:.3f} ms, host native filter "
              f"{row['host_native_ms']:.3f} ms on {card}")
        out[name] = row
    return out


def _wall_ms(fn, reps: int) -> float:
    """Median host wall ms of ``fn`` (which ends synchronized) over ``reps``
    calls after one discarded."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_png_filter(sat, dev, out_dir: Path, card: str) -> dict:
    """Kernel F (phase 33 in the module docstring)."""
    from strange_attractor_tpu_torch import cli
    from strange_attractor_tpu_torch.ops import png_filter as pf
    from strange_attractor_tpu_torch.utils import export

    out = {"hero": _png_filter_frame(sat, dev, _flagship(sat, 1_000_000_000), out_dir, "hero",
                                     card),
           "solar_sail": _png_filter_frame(sat, dev, _solar_sail(sat, 1_000_000_000), out_dir,
                                           "solar-sail", card)}
    frames = sat.render_sequence_shared(_flagship(sat, 10_000_000), [0.0, 3.0, 6.0, 9.0],
                                        frames_per_batch=2, transparent=False, eight_bit=True,
                                        device=dev)
    if frames.flags.writeable:
        raise AssertionError("[33] a sequence delivered from the card is writable")
    paths = [out_dir / f"rot{f}" for f in range(len(frames))]
    before = pf.png_filter.launches
    cli._write_frames(zip(frames, paths), lambda path, image: export.write_image(
        path, image, transparent=False, eight_bit=True, announce=False))
    launches = pf.png_filter.launches - before
    if launches != len(frames):
        raise AssertionError(f"[33] rotation: {launches} card filters for {len(frames)} frames")
    for f, path in enumerate(paths):
        host = export.write_image(out_dir / f"rot{f}-host", np.array(frames[f]),
                                  transparent=False, eight_bit=True, announce=False)
        if _sha256(path.with_suffix(".png")) != _sha256(host):
            raise AssertionError(f"[33] rotation frame {f}: the card path's PNG differs")
    print(f"[33] rotation: {len(frames)} frames written on the encoder threads, each filtered "
          f"on the card ({launches} launches), every file's sha256 the host filter's")
    out["rotation_launches"] = launches
    out["rotation_pam"] = _png_filter_pam(sat, dev, out_dir)
    out["rotation_budget_launches"] = _png_filter_budget(sat, dev, out_dir)
    return out


def _rotation_8bit(sat, dev, angles=(0.0, 3.0, 6.0, 9.0)) -> np.ndarray:
    return sat.render_sequence_shared(_flagship(sat, 10_000_000), list(angles),
                                      frames_per_batch=2, transparent=False, eight_bit=True,
                                      device=dev)


def _held_bytes() -> int:
    from strange_attractor_tpu_torch.utils import export

    return sum(b for _, b in export._HELD.values())


def _png_filter_pam(sat, dev, out_dir: Path) -> dict:
    """A rotation written as PAMs: no launch, every record dropped, the
    device bytes the records held back to where they were."""
    from strange_attractor_tpu_torch import cli
    from strange_attractor_tpu_torch.ops import png_filter as pf
    from strange_attractor_tpu_torch.utils import export

    before_bytes = _held_bytes()
    frames = _rotation_8bit(sat, dev)
    held = _held_bytes() - before_bytes
    before = pf.png_filter.launches
    cli._write_frames(zip(frames, [out_dir / f"pam{f}" for f in range(len(frames))]),
                      lambda path, image: export.write_image(
                          path, image, fmt="pam", transparent=False, eight_bit=True,
                          announce=False))
    if pf.png_filter.launches != before or _held_bytes() != before_bytes or any(
            export._take_device_copy(frame) is not None for frame in frames):
        raise AssertionError(f"[33] rotation to PAM: {pf.png_filter.launches - before} "
                             f"launches, {_held_bytes() - before_bytes} bytes still held")
    print(f"[33] rotation to PAM: the records held {held} device bytes, all dropped by the "
          f"writes, no launch")
    return {"held_bytes": held}


def _png_filter_budget(sat, dev, out_dir: Path) -> int:
    """The rotation under a budget of one batch's bytes: the first batch's
    records go when the second's come, its frames take the host filter."""
    from strange_attractor_tpu_torch import cli
    from strange_attractor_tpu_torch.ops import png_filter as pf
    from strange_attractor_tpu_torch.utils import export

    cfg = _flagship(sat, 10_000_000)
    old = export._DEVICE_COPY_BUDGET
    export._DEVICE_COPY_BUDGET = 2 * cfg.width * cfg.height * 3
    try:
        frames = _rotation_8bit(sat, dev)
        paths = [out_dir / f"budget{f}" for f in range(len(frames))]
        before = pf.png_filter.launches
        cli._write_frames(zip(frames, paths), lambda path, image: export.write_image(
            path, image, transparent=False, eight_bit=True, announce=False))
        launches = pf.png_filter.launches - before
    finally:
        export._DEVICE_COPY_BUDGET = old
    if launches != 2:
        raise AssertionError(f"[33] rotation under a one-batch budget: {launches} card "
                             f"filters, not 2")
    for f, path in enumerate(paths):
        host = export.write_image(out_dir / f"budget{f}-host", np.array(frames[f]),
                                  transparent=False, eight_bit=True, announce=False)
        if _sha256(path.with_suffix(".png")) != _sha256(host):
            raise AssertionError(f"[33] rotation under a budget, frame {f}: the PNG differs")
    print(f"[33] rotation under a one-batch budget: {launches} of {len(frames)} frames "
          f"filtered on the card, every file's sha256 the host filter's")
    return launches


def phase_tonemap(sat, dev, card: str) -> dict:
    """Kernel T (csrc/tonemap.cu) at 1920x1080 and 3840x2160: every case
    and mode against its plain twin on the card and on the CPU, bit for
    bit (:func:`_tonemap_canvas`); then timed (:func:`_tonemap_timing`)."""
    out = {}
    for w, h in TONEMAP_CANVASES:
        t0 = time.perf_counter()
        compared, err = _tonemap_canvas(sat, dev, w, h)
        print(f"[32] kernel T at {w}x{h}: {compared} images bit-identical to the plain chain on "
              f"the card and on the CPU, largest channel difference {err} "
              f"({time.perf_counter() - t0:.2f} s)")
        rows = _tonemap_timing(sat, dev, w, h)
        for name, row in rows.items():
            if name != "launches_per_frame":
                print(f"[32] {w}x{h} {name}: kernel T {row['ms']:.4f} ms a frame, plain chain "
                      f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                      f"({row['bytes'] / 1e6:.1f} MB; {row['bound_by']}) on {card}")
        print(f"[32] {w}x{h}: the reduction {rows['gas_rgb8']['stats_ms']:.4f} ms; launches a "
              f"delivery {rows['launches_per_frame']}")
        out[f"{w}x{h}"] = {"compared": compared, "max_abs_err": err, **rows}
    return out


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


# per point of each emission mode: operations (EMIT_OPS; SHARED_DEPTH
# skips the color transform's 26) and bytes written in float64 (the fused
# modes' z and val stay float32; the shared stream is xc, zc, fj[, val] in
# float64)
AXES_OPS = {"packed": 124, "depth": 98, "exact": 124, "shared": 106, "shared-depth": 80}
AXES_F64_BYTES = {"packed": 8, "depth": 8, "exact": 12, "shared": 32, "shared-depth": 24}
# the gate's two operations a point (the age's add and compare) and a
# launch's dead-lane test and age a lane (six compares, 8 bytes)
GATE_OPS, GATE_LANE_OPS, GATE_LANE_BYTES = 2, 6, 8


def _axes_bound(kind: str, lanes: int, steps: int, f64: bool = False, gated: bool = False,
                preset: str = "sprott") -> dict:
    """Kernel A's bound for one chunk in float64 (at the FP64 peak) or
    gated: its streams and its lane state once, and its operations."""
    points = lanes * steps
    ops = (AXES_OPS[kind] - MAP_OPS["sprott"] + MAP_OPS[preset]) * points
    nbytes = (AXES_F64_BYTES if f64 else {**EMIT_BYTES, "shared-depth": 12})[kind] * points
    nbytes += 2 * (24 if f64 else 12) * lanes
    if gated:
        ops += GATE_OPS * points + GATE_LANE_OPS * lanes
        nbytes += GATE_LANE_BYTES * lanes
    return _bound(nbytes, ops, PEAK_OPS_F64 if f64 else PEAK_OPS)


def _axes_rows(axes, axes_twins, axes_renders, axes_cli) -> list:
    """The ``kernels`` rows of kernel A's gated and float64 instantiations
    and kernel P's float64 and gated streams."""
    no_library = {"library_ms": None, "library_note": LIBRARY_NOTE}
    turns = axes["turns"]
    f64_ms = axes["f64_ms"]
    proj = axes["project"]
    points = SEQ_LANES * SEQ_CHUNK
    return [{
        "name": "map_emit_gated", "route": "cuda", "source": _SOURCE + "map_emit.cu",
        "replaces": "strange_attractor_tpu/render.py:421",
        "launches": axes_cli["launches"]["map_emit_gated"], "max_abs_err": axes["err"],
        "ms": sum(turns["gated"]) / len(turns["gated"]), "plain_ms": axes["gated_plain_ms"],
        **_axes_bound("packed", LANES, CHUNK, gated=True),
        "ungated_ms_in_turns": turns["ungated"], "gated_ms_in_turns": turns["gated"],
        "launches_per_1e9": axes_renders["reseed_solar_sail"]["launches"]["map_emit_gated"],
        **no_library,
    }, {
        "name": "map_emit_f64", "route": "cuda", "source": _SOURCE + "map_emit_f64.cu",
        "replaces": "strange_attractor_tpu/render.py:410",
        "launches": axes_renders["f64_flagship"]["launches"]["map_emit_f64"],
        "max_abs_err": axes["err"], "ms": f64_ms["poisson-saturne packed"],
        "plain_ms": axes["f64_plain_ms"]["poisson-saturne"],
        **_axes_bound("packed", LANES, CHUNK, f64=True), "ops_peak": "FP64 33.5 TFLOP/s",
        "modes": {kind: {"ms": f64_ms[f"poisson-saturne {kind}"],
                         **_axes_bound(kind, LANES, CHUNK, f64=True)} for kind in AXES_OPS},
        "lorenz": {"ms": f64_ms["lorenz packed"], "plain_ms": axes["f64_plain_ms"]["lorenz"],
                   **_axes_bound("packed", LANES, CHUNK, f64=True, preset="lorenz")},
        "launches_per_1e9": axes_renders["f64_flagship"]["launches"]["map_emit_f64"],
        **no_library,
    }, {
        "name": "project_emit_f64", "route": "cuda", "source": _SOURCE + "project_emit.cu",
        "replaces": "strange_attractor_tpu/render.py:246",
        "launches": axes_twins["f64 shared"]["project_emit_f64"], "max_abs_err": axes["err"],
        "ms": proj["f64"]["ms"], "plain_ms": proj["f64"]["plain_ms"],
        **_bound(40 * points, EMIT_OPS["project"] * points, PEAK_OPS_F64),
        "ops_peak": "FP64 33.5 TFLOP/s", "launches_per_1e9": None, **no_library,
    }, {
        "name": "project_emit_gated", "route": "cuda", "source": _SOURCE + "project_emit.cu",
        "replaces": "strange_attractor_tpu/render.py:261",
        "launches": axes_twins["reseed shared"]["project_emit"], "max_abs_err": axes["err"],
        "ms": proj["gated"]["ms"], "plain_ms": proj["gated"]["plain_ms"],
        **_emit_bound("project", SEQ_LANES, SEQ_CHUNK), "launches_per_1e9": None, **no_library,
    }]


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


def _tonemap_row(s: dict, t: dict) -> dict:
    """Kernel T's ``kernels`` row: its launches in the flagship frame of
    phase 4 (the reduction and the pass), its 1080p Gas 8-bit RGB frame's
    time beside the plain chain's and its bound, the other modes and the
    4K canvas beside them."""
    hd, uhd = (t[f"{w}x{h}"] for w, h in TONEMAP_CANVASES)
    launches = {k: s["launches"][k] for k in TONEMAP}
    return {"name": "tonemap", "route": "cuda", "source": _SOURCE + "tonemap.cu",
            "replaces": "strange_attractor_tpu/render.py:646", "launches": sum(launches.values()),
            "launches_parts": launches, "launches_per_frame": hd["launches_per_frame"],
            "max_abs_err": max(hd["max_abs_err"], uhd["max_abs_err"]), **hd["gas_rgb8"],
            "library_ms": None,
            "library_note": LIBRARY_NOTE,
            "modes": {"gas_rgba16": hd["gas_rgba16"], "depth_rgb8": hd["depth_rgb8"]},
            "uhd": {k: uhd[k] for k in ("gas_rgb8", "gas_rgba16", "depth_rgb8")},
            "images_compared": hd["compared"] + uhd["compared"]}


def _png_filter_row(p: dict) -> dict:
    """Kernel F's ``kernels`` row: the hero frame's 8-bit RGB filter (the
    stills' layout) with its bound and twin, the other layouts and the
    solar-sail frame beside it, and the rotation's launches (one a frame)."""
    hero = p["hero"]
    return {"name": "png_filter", "route": "cuda", "source": _SOURCE + "png_filter.cu",
            "replaces": "strange_attractor_tpu_torch/utils/export.py _filter_scanlines (host)",
            "launches": p["rotation_launches"], "max_abs_err": 0, **hero["rgb8"],
            "modes": {k: v for k, v in hero.items() if k != "rgb8"},
            "solar_sail": p["solar_sail"]}


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
    laps, clock = {}, [time.perf_counter()]

    def lap(phase: str, result=None):
        """``result``, after noting the seconds since the last lap under
        ``phase`` (the line before the card's prints them)."""
        now = time.perf_counter()
        laps[phase], clock[0] = round(now - clock[0], 2), now
        return result

    a = lap("2", phase_kernel_a(sat, dev))
    b = lap("3", phase_kernel_b(sat, dev))
    with tempfile.TemporaryDirectory() as tmp:
        s = phase_slice(sat, dev, Path(tmp), card)
        encoder = lap("4", phase_encoder(s.pop("image")))
        lap("5", phase_twins(sat, dev, Path(tmp)))
        modes = lap("6", phase_emit_modes(sat, dev))
        bins = lap("7", phase_bins(sat, dev))
        runs = lap("8", phase_paths(sat, dev, Path(tmp), card))
        lap("9", phase_path_twins(sat, dev, Path(tmp)))
        shared = lap("10", phase_shared_emit(sat, dev))
        lap("11", phase_sequence_twins(sat, dev))
        seq = lap("12", phase_sequence_cell(sat, dev, Path(tmp), card))
        rk4 = lap("14", phase_rk4_kernel_a(sat, dev))
        preset_runs = lap("15", phase_presets(sat, dev, Path(tmp), card))
        axes = lap("17", phase_axes_kernels(sat, dev))
        axes_twins = lap("18", phase_axes_twins(sat, dev))
        axes_cli = lap("20", phase_axes_cli(sat, dev, Path(tmp), card))
        merge_ms = lap("21", phase_merge(sat, dev))
        sharded = lap("22", phase_sharded(sat, dev, card))
        ranks = lap("23-24", phase_distributed(sat, dev, Path(tmp), card))
        seq_sharded = lap("25", phase_sequence_sharded(sat, dev, card))
        precompiled = lap("26", phase_precompile(sat, dev, Path(tmp), card))
        doctor = lap("27", phase_doctor(card))
        profiled = lap("28", phase_profile(sat, dev, Path(tmp), card))
        uhd = lap("29", phase_4k(sat, dev, Path(tmp), card))
        parity = lap("30", phase_reference_parity(sat, dev, Path(tmp), card))
        certified = lap("31", phase_certify(card))
        tonemapped = lap("32", phase_tonemap(sat, dev, card))
        png_filtered = lap("33", phase_png_filter(sat, dev, Path(tmp), card))
    renders = lap("13", phase_renders(sat, dev, card))
    rk4_renders = lap("16", phase_rk4_renders(sat, dev, card))
    axes_renders = lap("19", phase_axes_renders(sat, dev, card))
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    kernels = _kernel_rows(a, b, modes, bins, shared, s, runs, seq, renders, rk4, preset_runs,
                           rk4_renders) + _axes_rows(axes, axes_twins, axes_renders, axes_cli)
    kernels.append(_tonemap_row(s, tonemapped))
    kernels.append(_png_filter_row(png_filtered))
    for row in kernels[:2]:  # map_emit and bin_packed: the 4K frame's launches and check
        row["launches_4k_1e9"] = uhd["launches"][row["name"]]
        row["max_abs_err"] = max(row["max_abs_err"], uhd["err"])
    kernels[1]["uhd"] = {k: uhd["bin_packed"][k] for k in ("ms", "ms_range", "plain_ms", "bytes",
                                                            "bound_ms", "bound_by", "touched_px",
                                                            "library_ms", "library_parts")}
    print(json.dumps({"encoder": encoder, "frame_split_s": s["split"],
                      "rotation_encode": seq["encode"], "phase_s": laps,
                      "axes_renders": {k: {"iters_per_s": v["iters_per_s"], **v.get("flood", {})}
                                       for k, v in axes_renders.items()},
                      "merge_ms": merge_ms, "sharded": sharded, "ranks": ranks,
                      "sequence_sharded": seq_sharded, "precompile": precompiled,
                      "doctor": doctor, "profile": profiled, "uhd": uhd, "parity": parity,
                      "certify": certified, "tonemap": tonemapped}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
