"""Point-stream binning (PyTorch port of ``strange_attractor_tpu.ops.binning``
and of the binning contracts of ``strange_attractor_tpu.ops.kernel_binning``).

u32 carriers: torch lacks most uint32 arithmetic (ROADMAP C1), so every
u32 plane and stream here is a ``torch.int32`` tensor holding the u32 bit
pattern. Arithmetic widens to int64 (:func:`u32`), and results return to
int32 bits through :func:`to_u32_bits`. At the numpy boundary use
``t.numpy().view(np.uint32)``. The CUDA kernels read the same buffers as
``unsigned int``.

(z, value) packing (src/lib.rs:807-834 collapsed into one max): the 20 high
bits are an order-preserving map of the float32 depth shifted so that the
-1.0 sentinel maps to 0, the 12 low bits the quantized palette position.

The four bin functions are the plain twins of the CUDA bin kernels (see
:mod:`ops.kernel_binning`), one per TPU entry point: PACKED
(:func:`bin_chunk_packed`), DEPTH (:func:`bin_chunk_depth`), EXACT
(:func:`bin_chunk_exact`) and EXACT16 (:func:`bin_chunk_exact16`). Each is
a handful of scatters with integer keys that fit torch's signed int64.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF
# order-preserving uint32 image of f32(-1.0): bits(-1.0) = 0xBF80_0000 is
# negative, so mono = ~bits = 0x407F_FFFF
_MONO_NEG1 = 0x407FFFFF
_VAL_BITS = 12
_VAL_SCALE = float(1 << _VAL_BITS)
_VAL_MASK = (1 << _VAL_BITS) - 1
_ZKEY_MASK = _U32 ^ _VAL_MASK
# largest palette position below 1.0 the reference clamps to (src/lib.rs:443)
_VAL_MAX = 0.999999


def u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> its uint32 value as int64."""
    return t.to(torch.int64) & _U32


def to_u32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 value (taken mod 2^32) -> int32 tensor holding its u32 bits."""
    v = v & _U32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def mono_u32(z: torch.Tensor) -> torch.Tensor:
    """Monotone f32 -> uint32 map (int64 values): negative floats flip all
    bits, positive floats flip the sign bit. Preserves the total order of
    non-NaN floats."""
    u = u32(z.to(torch.float32).view(torch.int32))
    neg = (u >> 31) == 1
    return torch.where(neg, u ^ _U32, u | 0x80000000)


def inv_mono_u32(mono: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`mono_u32`: int64 u32 values -> float32."""
    neg = mono < 0x80000000
    bits = torch.where(neg, mono ^ _U32, mono & 0x7FFFFFFF)
    return to_u32_bits(bits).view(torch.float32)


def pack_zv(z: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Pack float32 (depth, palette value) into u32 bits (int32 tensor);
    0 means 'unset or z <= -1'.

    Points at or below the z sentinel never win the reference's strict
    z-test (src/lib.rs:818-821), so mapping them to 0 keeps its semantics.
    A NaN ``val`` packs a palette position of 0: XLA's clip keeps the NaN
    and its float-to-u32 conversion maps NaN to 0 (the JAX package's
    answer on the CPU, pinned in tests). The int cast here only ever sees
    finite values in [0, 4096).
    """
    d = (mono_u32(z) - _MONO_NEG1) & _U32
    q = torch.clamp(torch.nan_to_num(val, nan=0.0), 0.0, _VAL_MAX)
    q = (q * _VAL_SCALE).to(torch.int64)
    packed = (d & _ZKEY_MASK) | q
    return to_u32_bits(torch.where(z > -1.0, packed, 0))


def unpack_zv(packed: torch.Tensor):
    """Decode a packed plane (int32 bits) to float32 (zbuf, steps) planes.

    Unset pixels decode to exactly (-1.0, 0.0), the reference's reset
    values (src/lib.rs:688-693)."""
    p = u32(packed)
    val = (p & _VAL_MASK).to(torch.float32) / _VAL_SCALE
    mono = ((p & _ZKEY_MASK) + _MONO_NEG1) & _U32
    return inv_mono_u32(mono), val


def canonical_zero(z: torch.Tensor) -> torch.Tensor:
    """-0.0 -> +0.0. The monotone map splits the two zeros into adjacent
    keys while the reference's float compare ties them, so every z key is
    taken after this (the JAX kernels' canonicalization, ROADMAP C3)."""
    return torch.where(z == 0.0, 0.0, z)


def f16_bits(v: torch.Tensor) -> torch.Tensor:
    """float32 -> float16 bit patterns (int64), rounded to nearest even, by
    integer ops only, so every device gives the same bits.

    A NaN keeps its sign and the top ten payload bits and gets the quiet
    bit, as JAX's ``astype(float16)`` gives on the CPU (``0x7f800001 ->
    0x7e00``, ``0xffc12345 -> 0xfe09``); a hardware conversion may return
    one canonical NaN instead, which would change the EXACT16 value-ties
    winner. Values from 65520 up round to infinity; below 2^-14 to the
    subnormals, 2^-25 and less to zero."""
    u = u32(v.to(torch.float32).contiguous().view(torch.int32))
    sign = (u >> 16) & 0x8000
    a = u & 0x7FFFFFFF
    normal = (a - 0x38000000 + 0xFFF + ((a >> 13) & 1)) >> 13
    # subnormal: mantissa * 2^(e - 126), rounded to nearest even
    mant = (a & 0x7FFFFF) | 0x800000
    shift = torch.clamp(126 - (a >> 23), 14, 25)
    sub = (mant + (torch.ones_like(shift) << (shift - 1)) - 1 + ((mant >> shift) & 1)) >> shift
    h = torch.where(a < 0x38800000, sub, normal)
    h = torch.where(a >= 0x477FF000, 0x7C00, h)
    h = torch.where(a > 0x7F800000, 0x7E00 | ((a >> 13) & 0x3FF), h)
    return sign | h


def f16_to_f32(h: torch.Tensor) -> torch.Tensor:
    """float16 bit patterns (int64) -> float32, exactly, by integer ops (a
    NaN gets the quiet bit, as JAX's ``astype(float32)`` gives)."""
    sign = (h & 0x8000) << 16
    e = (h >> 10) & 0x1F
    m = h & 0x3FF
    normal = ((e + 112) << 23) | (m << 13)
    special = 0x7F800000 | (m << 13) | torch.where(m != 0, 0x400000, 0)
    # m * 2^-24 is exact in float32
    sub = u32((m.to(torch.float32) * 2.0**-24).view(torch.int32))
    bits = sign | torch.where(e == 31, special, torch.where(e == 0, sub, normal))
    return to_u32_bits(bits).view(torch.float32)


def _in_bounds(flat: torch.Tensor, npix: int) -> torch.Tensor:
    """Points that bin: ``npix`` marks an out-of-bounds point (dropped,
    src/lib.rs:789-795), as is any index outside [0, npix)."""
    return (flat >= 0) & (flat < npix)


def _add_hits(count, f):
    return to_u32_bits(u32(count) + torch.bincount(f, minlength=count.shape[0]))


def bin_chunk_packed(count, packed, flat, packed_update):
    """PACKED accumulation of one point chunk: ``count += hits`` and
    ``packed = max(packed, update)`` per pixel, as plain torch scatters.

    ``count``/``packed`` are flattened (npix,) int32 planes of u32 bits;
    ``flat`` is int32 with ``npix`` marking out-of-bounds points;
    ``packed_update`` is :func:`pack_zv`'s output.
    Returns new planes. The plain twin of the CUDA kernel behind
    :func:`ops.kernel_binning.bin_chunk_kernel`.
    """
    keep = _in_bounds(flat, count.shape[0])
    f = flat[keep].to(torch.int64)
    new_packed = u32(packed).scatter_reduce(0, f, u32(packed_update[keep]), reduce="amax")
    return _add_hits(count, f), to_u32_bits(new_packed)


def bin_chunk_depth(zbuf, flat, z):
    """DEPTH accumulation of one chunk: the per-pixel max depth, as
    ``bin_chunk_kernel_depth`` computes it (kernel_binning.py:735-787).

    ``zbuf`` is the flattened (npix,) float32 plane with the -1.0 sentinel;
    ``z`` the float32 depth stream. The stream's zeros are canonicalized to
    +0.0, then the max is taken in mono-u32 space against the standing
    plane, which is not canonicalized: a standing -0.0 loses to a new +0.0,
    unlike a float ``max``. Returns ``(zbuf,)``, a new plane. The plain twin
    of :func:`ops.kernel_binning.bin_chunk_kernel_depth`.
    """
    keep = _in_bounds(flat, zbuf.shape[0])
    zm = mono_u32(canonical_zero(z[keep]))
    best = mono_u32(zbuf).scatter_reduce(0, flat[keep].to(torch.int64), zm, reduce="amax")
    return (inv_mono_u32(best),)


# largest 31-bit stream index: a chunk holds fewer than 2^31 points
_IDX = (1 << 31) - 1
_NO_KEY = (1 << 63) - 1


def bin_chunk_exact(count, steps, zbuf, flat, z, val):
    """EXACT accumulation of one chunk with EXACT_KERNEL's semantics
    (``bin_chunk_kernel_exact``, kernel_binning.py:542-579).

    ``count`` (u32 bits in int32), ``steps`` and ``zbuf`` (float32) are the
    flattened (npix,) EXACT planes; ``flat``/``z``/``val`` the point stream.
    Every in-bounds point counts. Within the chunk each pixel's candidate is
    its greatest z (zeros canonicalized to +0.0), the earliest-emitted point
    on equal z; it replaces the standing plane only if strictly greater
    (the reference's ``z2 > zbuf``, src/lib.rs:818-833), and ``steps`` takes
    its value's float32 bits.

    Deterministic: an equal (pixel, z) pair inside one chunk goes to the
    earliest-emitted point. The JAX package's scatter EXACT
    (ops/binning.py:86-110) leaves that case undefined and agrees
    everywhere else. Key: ``mono(z) << 31 | (2^31 - 1 - index)``, whose
    per-pixel max is that candidate. Returns new planes. The plain twin of
    :func:`ops.kernel_binning.bin_chunk_kernel_exact`.
    """
    npix = count.shape[0]
    keep = _in_bounds(flat, npix)
    f = flat[keep].to(torch.int64)
    count = _add_hits(count, f)
    if f.numel() == 0:
        return count, steps, zbuf
    idx = torch.arange(flat.shape[0], device=flat.device)[keep]
    key = (mono_u32(canonical_zero(z[keep])) << 31) | (_IDX - idx)
    best = torch.full((npix,), -1, dtype=torch.int64, device=flat.device)
    best = best.scatter_reduce(0, f, key, reduce="amax")
    hit = best >= 0
    z_new = inv_mono_u32(torch.clamp(best, min=0) >> 31)
    take = hit & (z_new > zbuf)
    winner = torch.where(hit, _IDX - (best & _IDX), 0)
    return (count, torch.where(take, val[winner], steps), torch.where(take, z_new, zbuf))


def bin_chunk_exact16(count, steps, zbuf, flat, z, val, ties: str = "value"):
    """EXACT16 accumulation of one chunk, the contract of
    ``bin_chunk_kernel_exact16`` (kernel_binning.py:584-730).

    EXACT's planes and strict z-test at 16-bit z granularity: a point's
    bucket key is ``sk = ~(mono(z) >> 16) & 0xFFFF`` (smaller is nearer);
    points with ``z <= -1`` (NaN included) count but never win. Within the
    chunk each pixel's winner has the smallest ``sk``; on a bucket tie
    ``ties="value"`` takes the smallest float16 bit pattern of the value
    (the per-pixel min of ``sk << 16 | f16``, ``_flush_exact16_val``) and
    ``ties="earliest"`` the earliest-emitted point (the min of
    ``sk << 47 | index << 16 | f16``, ``_flush_exact16``). The winner's
    bucket decodes to its lower edge, which replaces ``zbuf`` if strictly
    greater; ``steps`` takes the float16 value back in float32. The float16
    conversion is done in bits (:func:`f16_bits`). Returns new planes. The
    plain twin of :func:`ops.kernel_binning.bin_chunk_kernel_exact16`.
    """
    if ties not in ("value", "earliest"):
        raise ValueError(f"ties must be 'value' or 'earliest', got {ties!r}")
    npix = count.shape[0]
    keep = _in_bounds(flat, npix)
    count = _add_hits(count, flat[keep].to(torch.int64))
    z = canonical_zero(z.to(torch.float32))
    live = keep & (z > -1.0)
    sk = ~(mono_u32(z[live]) >> 16) & 0xFFFF
    v16 = f16_bits(val[live])
    if ties == "value":
        key, shift = (sk << 16) | v16, 16
    else:
        idx = torch.arange(flat.shape[0], device=flat.device)[live]
        key, shift = (sk << 47) | (idx << 16) | v16, 47
    best = torch.full((npix,), _NO_KEY, dtype=torch.int64, device=flat.device)
    best = best.scatter_reduce(0, flat[live].to(torch.int64), key, reduce="amin")
    z_q = inv_mono_u32((~(best >> shift) & 0xFFFF) << 16)
    take = (best != _NO_KEY) & (z_q > zbuf)
    return (count, torch.where(take, f16_to_f32(best & 0xFFFF), steps),
            torch.where(take, z_q, zbuf))
