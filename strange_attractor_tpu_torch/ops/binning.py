"""Point-stream binning, PACKED strategy (PyTorch port of
``strange_attractor_tpu.ops.binning``).

u32 carriers: torch lacks most uint32 arithmetic (ROADMAP C1), so every
u32 plane and stream here is a ``torch.int32`` tensor holding the u32 bit
pattern. Arithmetic widens to int64 (:func:`u32`), and results return to
int32 bits through :func:`to_u32_bits`. At the numpy boundary use
``t.numpy().view(np.uint32)``. The CUDA kernels read the same buffers as
``unsigned int``.

(z, value) packing (src/lib.rs:807-834 collapsed into one max): the 20 high
bits are an order-preserving map of the float32 depth shifted so that the
-1.0 sentinel maps to 0, the 12 low bits the quantized palette position.
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


def _mono_u32(z: torch.Tensor) -> torch.Tensor:
    """Monotone f32 -> uint32 map (int64 values): negative floats flip all
    bits, positive floats flip the sign bit. Preserves the total order of
    non-NaN floats."""
    u = u32(z.to(torch.float32).view(torch.int32))
    neg = (u >> 31) == 1
    return torch.where(neg, u ^ _U32, u | 0x80000000)


def _inv_mono_u32(mono: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_mono_u32`: int64 u32 values -> float32."""
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
    d = (_mono_u32(z) - _MONO_NEG1) & _U32
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
    return _inv_mono_u32(mono), val


def bin_chunk_packed(count, packed, flat, packed_update):
    """PACKED accumulation of one point chunk: ``count += hits`` and
    ``packed = max(packed, update)`` per pixel, as plain torch scatters.

    ``count``/``packed`` are flattened (npix,) int32 planes of u32 bits;
    ``flat`` is int32 with ``npix`` marking out-of-bounds points (dropped,
    src/lib.rs:789-795, as is any index outside [0, npix));
    ``packed_update`` is :func:`pack_zv`'s output.
    Returns new planes. The plain twin of the CUDA kernel behind
    :func:`ops.kernel_binning.bin_chunk_kernel`.
    """
    npix = count.shape[0]
    keep = (flat >= 0) & (flat < npix)
    f = flat[keep].to(torch.int64)
    hits = torch.bincount(f, minlength=npix)
    new_count = to_u32_bits(u32(count) + hits)
    new_packed = u32(packed).scatter_reduce(0, f, u32(packed_update[keep]), reduce="amax")
    return new_count, to_u32_bits(new_packed)
