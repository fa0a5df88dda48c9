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
   the plain twins on the card: identical planes and PNG bytes.

It imports no JAX. It needs one card and exits non-zero without one.
"""

from __future__ import annotations

import json
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


def phase_slice(sat, dev, out_dir: Path, card: str) -> dict:
    from strange_attractor_tpu_torch.ops import emit, kernel_binning
    from strange_attractor_tpu_torch.ops.binning import u32

    cfg = _flagship(sat, 100_000_000)
    lanes, chunk, nchunks = sat.plan_schedule(cfg)
    executed = lanes * chunk * nchunks
    emit.map_emit.launches = 0
    kernel_binning.bin_chunk_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = sat.render(cfg, device=dev)
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    path, img = _deliver(sat, cfg, state, out_dir / "frame")
    wall = time.perf_counter() - t0
    launches = {"map_emit": emit.map_emit.launches,
                "bin_packed": kernel_binning.bin_chunk_kernel.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"the render did not go through every kernel: {launches}")
    total = int(u32(state.count).sum())
    if not 0 < total <= executed:
        raise AssertionError(f"count.sum() {total} outside (0, {executed}]")
    lit = float((img.max(axis=-1) > 0).mean())
    if not lit > 0.10:
        raise AssertionError(f"image nearly blank: lit fraction {lit}")
    print(f"[4] flagship {W}x{H} 1e8: {lanes} lanes x {chunk} steps x {nchunks} chunks = "
          f"{executed} iterations, count.sum() {total}, lit {lit:.3f}, "
          f"launches {launches}, wrote {path.stat().st_size} bytes")
    print(f"[4] render {t_render:.4f} s = {executed / t_render:.4e} iters/s; end-to-end wall "
          f"{wall:.4f} s (render + colorize + convert + host copy + PNG) on {card}")
    return {"launches": launches, "t_render": t_render, "wall": wall, "executed": executed}


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
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    kernels = [
        {"name": "map_emit", "route": "cuda",
         "source": "strange_attractor_tpu_torch/csrc/map_emit.cu",
         "replaces": "strange_attractor_tpu/render.py:410",
         "launches": s["launches"]["map_emit"], "max_abs_err": a["err"],
         "ms": a["ms"], "plain_ms": a["plain_ms"]},
        {"name": "bin_packed", "route": "cuda",
         "source": "strange_attractor_tpu_torch/csrc/bin_packed.cu",
         "replaces": "strange_attractor_tpu/ops/kernel_binning.py:475",
         "launches": s["launches"]["bin_packed"], "max_abs_err": b["err"],
         "ms": b["ms"], "plain_ms": b["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
