"""PyTorch port, binning: bit-level ops and the PACKED/KERNEL bin against
the JAX package on the CPU.

The port carries u32 planes as int32 bit patterns; every comparison here
views them as uint32 and demands bit equality. The KERNEL wrapper runs its
plain twin for CPU tensors, so these tests pin the plain twin; the CUDA
kernel is held against that twin on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from strange_attractor_tpu.ops import binning as jb
from strange_attractor_tpu.ops import kernel_binning as kb
from strange_attractor_tpu_torch.ops import binning as tb
from strange_attractor_tpu_torch.ops import cuda_lib
from strange_attractor_tpu_torch.ops.kernel_binning import bin_chunk_kernel
from test_kernel_binning import _reference


def _t(a_u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a_u32, np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


_SPECIAL = np.array([0.0, -0.0, -1.0, 1.0, np.inf, -np.inf, np.nan, -np.nan,
                     1e-45, -1e-45, 1e-40, -1e-40, 1.17549435e-38, -0.99999994,
                     -1.0000001, 3.4028235e38, -3.4028235e38], np.float32)


def _floats(seed: int, n: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([_SPECIAL, rng.normal(0, 2, n).astype(np.float32),
                           bits.view(np.float32)])


def test_mono_u32_and_inverse_bit_exact():
    z = _floats(0)
    want = np.asarray(jb._mono_u32(jnp.asarray(z)))
    got = tb.mono_u32(torch.from_numpy(z)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)
    mono = np.random.default_rng(1).integers(0, 2**32, 8192, dtype=np.uint64).astype(np.uint32)
    want_f = np.asarray(jb._inv_mono_u32(jnp.asarray(mono))).view(np.uint32)
    got_f = tb.inv_mono_u32(torch.from_numpy(mono.astype(np.int64))).numpy().view(np.uint32)
    np.testing.assert_array_equal(got_f, want_f)


def test_pack_zv_bit_exact_including_specials():
    """Every (z, val) pair of specials crossed, plus random pairs. A NaN
    value packs palette position 0 -- JAX-on-CPU's answer (XLA converts
    NaN to u32 0), reachable on escaping orbits."""
    zs, vs = np.meshgrid(_SPECIAL, np.concatenate([_SPECIAL, [0.5, 0.999999, 1.0, 0.25]]))
    z = np.concatenate([zs.ravel(), _floats(2)[: 4096 + 17]]).astype(np.float32)
    v = np.concatenate([vs.ravel().astype(np.float32),
                        np.random.default_rng(3).random(4096 + 17).astype(np.float32) * 1.2 - 0.1])
    want = np.asarray(jb.pack_zv(jnp.asarray(z), jnp.asarray(v)))
    got = _u32(tb.pack_zv(torch.from_numpy(z), torch.from_numpy(v)))
    np.testing.assert_array_equal(got, want)
    nan_val = _u32(tb.pack_zv(torch.tensor([0.5], dtype=torch.float32),
                              torch.tensor([np.nan], dtype=torch.float32)))
    assert nan_val[0] & 0xFFF == 0 and nan_val[0] != 0


def test_unpack_zv_bit_exact():
    packed = np.random.default_rng(4).integers(0, 2**32, 8192, dtype=np.uint64).astype(np.uint32)
    packed[:3] = [0, 0xFFFFFFFF, 0x407FF000]
    wz, wv = (np.asarray(a) for a in jb.unpack_zv(jnp.asarray(packed)))
    gz, gv = tb.unpack_zv(_t(packed))
    np.testing.assert_array_equal(gz.numpy().view(np.uint32), wz.view(np.uint32))
    np.testing.assert_array_equal(gv.numpy().view(np.uint32), wv.view(np.uint32))


def _stream(case: str, npix: int, n: int, rng):
    if case == "random":
        flat = rng.integers(0, npix, n)
        flat[rng.random(n) < 0.05] = npix
        return flat, rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if case == "ties":  # 50 hot pixels, tiny value space
        return rng.integers(0, 50, n), rng.integers(0, 8, n, dtype=np.uint64).astype(np.uint32)
    if case == "flood":  # pixel 0 far above chunk/64: the JAX path evicts it
        flat = rng.integers(0, npix, n)
        flat[rng.random(n) < 0.4] = 0
        return flat, rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    if case.startswith("pixel0"):
        # pixel 0 mixes escaped points (NaN z packs to 0) with real points
        # whose packed value must win; above or below the JAX path's
        # eviction gate of chunk/64 hits
        flat = rng.integers(0, npix, n)
        at0 = rng.random(n) < (0.3 if case == "pixel0-above-gate" else 0.01)
        flat[at0] = 0
        packed = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        packed[at0 & (rng.random(n) < 0.7)] = 0
        return flat, packed
    assert case == "all-oob"
    return np.full(n, npix), rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("case", ["random", "ties", "flood", "all-oob", "pixel0-above-gate",
                                  "pixel0-below-gate"])
def test_bin_chunk_packed_matches_jax_kernel_and_reference(case):
    npix, n = 128 * 128, 1 << 12
    flat, packed = _stream(case, npix, n, np.random.default_rng(5))
    flat = flat.astype(np.int32)
    if case.startswith("pixel0"):
        hits0 = flat == 0
        assert (hits0.sum() > n // 64) == (case == "pixel0-above-gate")
        assert (packed[hits0] == 0).any() and (packed[hits0] != 0).any()
    jc, jp = kb.bin_chunk_kernel(jnp.zeros((npix,), jnp.uint32), jnp.zeros((npix,), jnp.uint32),
                                 jnp.asarray(flat), jnp.asarray(packed), npix=npix,
                                 section=1 << 10, interpret=True)
    zeros = torch.zeros(npix, dtype=torch.int32)
    tc, tp = tb.bin_chunk_packed(zeros, zeros.clone(), torch.from_numpy(flat), _t(packed))
    np.testing.assert_array_equal(_u32(tc), np.asarray(jc))
    np.testing.assert_array_equal(_u32(tp), np.asarray(jp))
    rc, rp = _reference(npix, flat, packed)
    np.testing.assert_array_equal(_u32(tc), rc)
    np.testing.assert_array_equal(_u32(tp), rp)


def test_bin_chunk_packed_accumulates_across_chunks():
    npix = 128 * 128
    rng = np.random.default_rng(6)
    chunks = [(rng.integers(0, npix + 1, 600).astype(np.int32),
               rng.integers(0, 2**32, 600, dtype=np.uint64).astype(np.uint32)) for _ in range(3)]
    jstate = (jnp.zeros((npix,), jnp.uint32), jnp.zeros((npix,), jnp.uint32))
    tstate = (torch.zeros(npix, dtype=torch.int32), torch.zeros(npix, dtype=torch.int32))
    for flat, packed in chunks:
        jstate = kb.bin_chunk_kernel(*jstate, jnp.asarray(flat), jnp.asarray(packed),
                                     npix=npix, section=1 << 10, interpret=True)
        tstate = tb.bin_chunk_packed(*tstate, torch.from_numpy(flat), _t(packed))
    np.testing.assert_array_equal(_u32(tstate[0]), np.asarray(jstate[0]))
    np.testing.assert_array_equal(_u32(tstate[1]), np.asarray(jstate[1]))
    rc, rp = _reference(npix, np.concatenate([c[0] for c in chunks]),
                        np.concatenate([c[1] for c in chunks]))
    np.testing.assert_array_equal(_u32(tstate[0]), rc)
    np.testing.assert_array_equal(_u32(tstate[1]), rp)


def test_count_wraps_like_u32():
    count = _t(np.array([0xFFFFFFFF, 0x7FFFFFFF, 5], np.uint32))
    c, _ = tb.bin_chunk_packed(count, torch.zeros(3, dtype=torch.int32),
                               torch.tensor([0, 1, 3], dtype=torch.int32),
                               torch.zeros(3, dtype=torch.int32))
    np.testing.assert_array_equal(_u32(c), [0, 0x80000000, 5])


def test_kernel_wrapper_runs_plain_twin_on_cpu_without_launching():
    npix = 64 * 36
    flat, packed = _stream("random", npix, 3000, np.random.default_rng(7))
    flat = torch.from_numpy(flat.astype(np.int32))
    before = bin_chunk_kernel.launches
    zeros = torch.zeros(npix, dtype=torch.int32)
    got = bin_chunk_kernel(zeros, zeros.clone(), flat, _t(packed))
    want = tb.bin_chunk_packed(zeros, zeros.clone(), flat, _t(packed))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bin_chunk_kernel.launches == before


def test_kernel_checks_refuse_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_lib.check_tensor(torch.zeros(4, dtype=torch.int32), torch.int32, "count")
