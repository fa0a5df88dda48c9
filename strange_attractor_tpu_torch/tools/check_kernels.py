"""Certify the port's bin kernels bit for bit against a sequential numpy
reference (the counterpart of the JAX package's
``tools/check_kernels.py::certify_kernels``).

Every public bin entry point of :mod:`ops.kernel_binning` takes one planted
chunk onto a fresh state, and its planes must equal, bit for bit, what a
plain Python loop over the points in stream order leaves:

- ``bin_chunk_kernel`` (KERNEL, ``csrc/bin_packed.cu``): count and the
  packed u32 max;
- ``bin_chunk_kernel_exact`` (EXACT_KERNEL, ``csrc/bin_exact.cu``): the
  strict float32 z-test, the earliest point winning ties;
- ``bin_chunk_kernel_exact16`` (EXACT16_KERNEL, ``csrc/bin_exact16.cu``)
  with ties ``value`` and ``earliest``: the z-test on 16-bit buckets
  (each bucket's lower edge), the value through float16;
- ``bin_chunk_kernel_depth`` (DEPTH_KERNEL, ``csrc/bin_depth.cu``): the
  per-pixel max depth.

The stream is the JAX tool's, drawn in its order from one seed: 2% of the
points out of bounds (``flat = npix``), 35% flooded onto pixel (0, 0) (an
escaping preset's NaN quirk), random u32 packed values, and depths
quantized to 1/64 so that ties occur, 2% of them -2.0 (counted, never
winning), half the flood's -inf. The references take both zeros as +0.0,
the kernels' contract (their keys canonicalize -0.0), so the planes are
compared by their bits. u32 planes ride int32 carriers in the port and are
compared as uint32. The JAX tool's ``flood_gate=False`` variant has no
counterpart: the port's kernels have one flood discipline.

On a card the wrappers launch the CUDA kernels; with ``device="cpu"`` they
run their plain twins, which is what the CPU tests certify. Run::

    python -m strange_attractor_tpu_torch.tools.check_kernels [n] [--device cuda|cpu]

It logs one pass line per entry point and, on a card, each kernel's
milliseconds for the planted chunk onto fresh planes by CUDA events (the
render-like times are chip_smoke.py's). It exits non-zero on a mismatch.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

ENTRY_POINTS = ("bin_packed", "bin_exact", "bin_exact16[value]", "bin_exact16[earliest]",
                "bin_depth")


def plant_stream(n: int, npix: int, seed: int = 0) -> dict:
    """The certification stream of ``n`` points over ``npix`` pixels (the
    JAX tool's, :40-46 and :77-90, in its order of draws)."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, npix, n).astype(np.int32)
    flat[rng.random(n) < 0.02] = npix  # out of bounds
    flat[rng.random(n) < 0.35] = 0  # the pixel-0 flood
    packed = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    z = rng.normal(0, 0.5, n).astype(np.float32)
    z[rng.random(n) < 0.02] = -2.0  # below the sentinel: counted, never wins
    z = np.round(z * 64) / 64  # exact ties
    p0 = np.nonzero(flat == 0)[0]
    z[p0[: len(p0) // 2]] = -np.inf  # half the flood never wins
    val = rng.random(n).astype(np.float32)
    return {"flat": flat, "packed": packed, "z": z, "val": val}


def _canonical(z: np.ndarray) -> np.ndarray:
    return np.where(z == 0.0, np.float32(0.0), z)


def reference_packed(s: dict, npix: int) -> dict:
    """KERNEL in stream order: ``count += 1``, ``packed = max(packed, p)``."""
    count, packed = [0] * (npix + 1), [0] * (npix + 1)
    for f, p in zip(s["flat"].tolist(), s["packed"].tolist()):
        count[f] += 1
        packed[f] = max(packed[f], p)
    return {"count": np.array(count[:npix], np.uint32),
            "packed": np.array(packed[:npix], np.uint32)}


def reference_exact(s: dict, npix: int) -> dict:
    """EXACT_KERNEL in stream order: every point counts; a point replaces
    its pixel's depth and value if strictly nearer (earliest wins ties)."""
    count, steps, zbuf = [0] * (npix + 1), [0.0] * (npix + 1), [-1.0] * (npix + 1)
    for f, zz, vv in zip(s["flat"].tolist(), _canonical(s["z"]).tolist(), s["val"].tolist()):
        count[f] += 1
        if zz > zbuf[f]:
            zbuf[f] = zz
            steps[f] = vv
    return {"count": np.array(count[:npix], np.uint32),
            "steps": np.array(steps[:npix], np.float32),
            "zbuf": np.array(zbuf[:npix], np.float32)}


def reference_exact16(s: dict, npix: int, ties: str) -> dict:
    """EXACT16_KERNEL in stream order: the z-test on each depth's 16-bit
    mono bucket, decoded to the bucket's lower edge, the value through
    float16; points at or below -1 count but never win. ``earliest``: the
    first point of the nearest bucket wins; ``value``: the smallest float16
    bit pattern of the nearest bucket, the first of those on a tie."""
    u = _canonical(s["z"].astype(np.float32))
    ub = u.view(np.uint32)
    mono = np.where(ub >> 31 == 1, ~ub, ub | np.uint32(0x80000000))
    edge = ((mono >> 16) << 16).astype(np.uint32)
    z_q = np.where(edge < 0x80000000, ~edge,
                   edge & np.uint32(0x7FFFFFFF)).astype(np.uint32).view(np.float32)
    v16 = s["val"].astype(np.float16)
    flat, live = s["flat"].tolist(), (u > -1.0).tolist()
    zq, vals = z_q.tolist(), v16.astype(np.float32).tolist()
    count, steps, zbuf = [0] * (npix + 1), [0.0] * (npix + 1), [-1.0] * (npix + 1)
    if ties == "earliest":
        for f, ok, zz, vv in zip(flat, live, zq, vals):
            count[f] += 1
            if ok and zz > zbuf[f]:
                zbuf[f] = zz
                steps[f] = vv
    else:
        best = {}
        keys = zip(flat, live, (mono >> 16).tolist(), v16.view(np.uint16).tolist())
        for i, (f, ok, kk, vb) in enumerate(keys):
            count[f] += 1
            if not ok:
                continue
            key = (-kk, vb)
            if f not in best or key < best[f][0]:
                best[f] = (key, i)
        for f, (_, i) in best.items():
            zbuf[f] = zq[i]
            steps[f] = vals[i]
    return {"count": np.array(count[:npix], np.uint32),
            "steps": np.array(steps[:npix], np.float32),
            "zbuf": np.array(zbuf[:npix], np.float32)}


def reference_depth(s: dict, npix: int) -> dict:
    """DEPTH_KERNEL in stream order: the per-pixel max depth from -1.0."""
    zbuf = [-1.0] * (npix + 1)
    for f, zz in zip(s["flat"].tolist(), _canonical(s["z"]).tolist()):
        zbuf[f] = max(zbuf[f], zz)
    return {"zbuf": np.array(zbuf[:npix], np.float32)}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32)


def _streams(s: dict, device) -> dict:
    """The stream's tensors on ``device``, u32 packed values as int32 bits."""
    import torch

    return {k: torch.from_numpy(s[k].view(np.int32) if k == "packed" else s[k]).to(device)
            for k in ("flat", "packed", "z", "val")}


def _fresh(name: str, npix: int, device) -> tuple:
    """Blank planes of entry point ``name``: zeros, and -1.0 depths."""
    import torch

    def zeros(dtype):
        return torch.zeros(npix, dtype=dtype, device=device)

    def sentinel():
        return torch.full((npix,), -1.0, device=device)

    if name == "bin_packed":
        return zeros(torch.int32), zeros(torch.int32)
    if name == "bin_depth":
        return (sentinel(),)
    return zeros(torch.int32), zeros(torch.float32), sentinel()


def _launch(name: str, planes: tuple, t: dict, work=None) -> dict:
    """One call of entry point ``name`` on ``planes`` with the streams
    ``t``: its planes by name."""
    from ..ops import kernel_binning as kb

    if name == "bin_packed":
        return dict(zip(("count", "packed"),
                        kb.bin_chunk_kernel(*planes, t["flat"], t["packed"])))
    if name == "bin_depth":
        return {"zbuf": kb.bin_chunk_kernel_depth(*planes, t["flat"], t["z"])[0]}
    if name == "bin_exact":
        out = kb.bin_chunk_kernel_exact(*planes, t["flat"], t["z"], t["val"], work=work)
    else:
        out = kb.bin_chunk_kernel_exact16(*planes, t["flat"], t["z"], t["val"],
                                          ties=name[len("bin_exact16["):-1], work=work)
    return dict(zip(("count", "steps", "zbuf"), out))


def _reference(name: str, s: dict, npix: int) -> dict:
    if name == "bin_packed":
        return reference_packed(s, npix)
    if name == "bin_exact":
        return reference_exact(s, npix)
    if name == "bin_depth":
        return reference_depth(s, npix)
    return reference_exact16(s, npix, name[len("bin_exact16["):-1])


def certify_kernels(n: int = 1 << 20, npix: int = 1920 * 1080, seed: int = 0, device="cuda",
                    log=print) -> None:
    """Assert that KERNEL, EXACT_KERNEL, EXACT16_KERNEL (both ties) and
    DEPTH_KERNEL leave, from one chunk of ``n`` planted points over
    ``npix`` pixels onto fresh planes, the planes of the sequential
    reference bit for bit (see the module docstring). Raises
    AssertionError naming the entry point, the plane and its first
    mismatches."""
    from ..runtime import resolve_device

    device = resolve_device(device)
    s = plant_stream(n, npix, seed)
    t = _streams(s, device)
    for name in ENTRY_POINTS:
        t0 = time.perf_counter()
        got = {k: v.cpu().numpy().view(np.uint32)
               for k, v in _launch(name, _fresh(name, npix, device), t).items()}
        want = _reference(name, s, npix)
        for plane, w in want.items():
            bad = np.nonzero(got[plane] != _bits(w))[0]
            if bad.size:
                first = bad[:5]
                raise AssertionError(
                    f"{name}: {plane} differs from the sequential reference at {bad.size} "
                    f"pixels; first {first.tolist()}: got bits "
                    f"{[hex(v) for v in got[plane][first]]}, want "
                    f"{[hex(v) for v in _bits(w)[first]]}")
        log(f"{name}: {' '.join(want)} bit-identical to the sequential reference "
            f"({n} points, {npix} pixels, {device.type}; {time.perf_counter() - t0:.1f} s)")


def chunk_ms(n: int = 1 << 20, npix: int = 1920 * 1080, seed: int = 0, reps: int = 5,
             device="cuda") -> dict:
    """Milliseconds of each entry point's launch on the planted chunk onto
    fresh planes, by CUDA events (the median of ``reps``), a spin kernel
    queued first so the launch is timed on the device, not at the host's
    launch rate."""
    import torch

    from ..ops import kernel_binning as kb

    device = torch.device(device)
    t = _streams(plant_stream(n, npix, seed), device)
    work = kb.new_work(n, device)
    out = {}
    for name in ENTRY_POINTS:
        times = []
        for _ in range(reps + 1):  # the first is discarded
            planes = _fresh(name, npix, device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(device)
            torch.cuda._sleep(2_000_000)
            start.record()
            _launch(name, planes, t, work)
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        out[name] = float(np.median(times[1:]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=1 << 20, help="points (default 2^20)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu certifies the plain twins)")
    args = ap.parse_args(argv)
    try:
        certify_kernels(args.n, device=args.device)
    except AssertionError as e:
        print(f"FAIL: {e}")
        return 1
    if args.device != "cpu":
        for name, ms in chunk_ms(args.n, device=args.device).items():
            print(f"{name}: {ms:.4f} ms a chunk of {args.n} points onto fresh 1920x1080 planes")
    print("check_kernels: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
