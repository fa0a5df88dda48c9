"""Tone mapping (PyTorch port of ``strange_attractor_tpu.ops.colorize``): the
reference's ``colorize`` (src/lib.rs:841-904) as elementwise torch ops.

Gas mode: palette-interpolate the stored color value, scale brightness by
``log(count+1) / log(max+1)``, apply the brightness constants, and cast with
Rust ``as u16`` saturation semantics. Depth mode: reverse-lerp the z-buffer
between its (sentinel-excluded) min and max into 16-bit gray. Plain torch:
neither is a Pallas kernel in the JAX package.

Rounding: every op is the JAX package's float32 op in the same order, with
two functions taken correctly rounded on every device: the square root
(:func:`models.transforms.sqrt_ieee`) and ``log1p``, computed in float64
and rounded once. XLA's CPU ``log1p`` is faithful but not correctly rounded
(one ulp off on about 0.8% of integer counts), so the brightness factor can
sit one ulp from the JAX package's, which the tests bound.

The JAX package runs the tone map and the (transparent, 8-bit) conversion
as one XLA fusion. Here they are kernel T, ``csrc/tonemap.cu``, behind
:func:`tonemap`: two wrapper launches a frame, the global reduction and the
elementwise pass fused with the conversion, four operations on the card's
stream (a 16-byte memset, the reduction, its one-thread finalize, the
pass; the palette goes to the card once), where the plain chain
(:func:`colorize_stats`, :func:`colorize_planes`, then
:func:`convert_format_device`) launches some 150 eager ops.
:func:`tonemap` runs the plain chain for a state on the CPU; for a state on
a card it launches the kernel, adds one to each wrapper's ``launches``
count and raises when it cannot launch, never falling back to the plain
chain there.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from ..config import Config, RenderKind
from ..models.transforms import sqrt_ieee
from ..runtime import RenderState
from . import cuda_lib
from .binning import u32, unpack_zv
from .projection import f32


def _saturate_u16(x: torch.Tensor) -> torch.Tensor:
    """Rust ``<f32> as u16``: NaN -> 0, clamp [0, 65535], truncate."""
    x = torch.nan_to_num(x, nan=0.0, posinf=65535.0, neginf=0.0)
    return torch.clamp(x, 0.0, 65535.0).to(torch.int32).to(torch.uint16)


# beyond this stop count the select chain loses to one table gather
PALETTE_SELECT_MAX_STOPS = 8


def palette_lookup(stops: np.ndarray, value: torch.Tensor, *, gather: bool | None = None):
    """Palette interpolation (src/lib.rs:442-472) over a float32 canvas.

    ``stops`` is the (K+1, 3) host table (last stop duplicated). Up to
    ``PALETTE_SELECT_MAX_STOPS`` stops the rows are picked by K selects,
    past it by a table gather; both compute the same lerp from the same
    rows, so they agree bit for bit. Returns (..., 3): the lerp between
    neighboring stops, square-rooted per channel.
    """
    k = stops.shape[0] - 1
    # only v >= 1.0 clamps (to 0.999999); [0.999999, 1.0) passes unchanged
    v = torch.where(value >= 1.0, f32(0.999999), torch.clamp(value, min=0.0)) * float(k)
    # f32 can round v up to exactly k within half an ulp of 1.0; clamp. A
    # NaN value casts to a negative index, which the lower bound keeps in
    # the table (its lerp is NaN whatever the rows, as in the JAX package)
    n = torch.clamp(torch.floor(v).to(torch.int64), 0, k - 1)
    frac = torch.fmod(v, 1.0)
    if gather is None:
        gather = k > PALETTE_SELECT_MAX_STOPS
    if gather:
        tbl = torch.from_numpy(stops.astype(np.float32)).to(value.device)
        lo, hi, fr = tbl[n], tbl[n + 1], frac[..., None]
        return sqrt_ieee(hi * fr + lo * (1.0 - fr))
    lo = [torch.zeros_like(v) for _ in range(3)]
    hi = [torch.zeros_like(v) for _ in range(3)]
    for idx in range(k):
        sel = n == idx
        for c in range(3):
            lo[c] = torch.where(sel, f32(stops[idx][c]), lo[c])
            hi[c] = torch.where(sel, f32(stops[idx + 1][c]), hi[c])
    return torch.stack([sqrt_ieee(h * frac + lo_ * (1.0 - frac)) for lo_, h in zip(lo, hi)],
                       dim=-1)


def state_planes(state: RenderState):
    """(count, steps, zbuf) planes regardless of storage strategy."""
    if state.packed is not None:
        zbuf, steps = unpack_zv(state.packed)
        return state.count, steps, zbuf
    return state.count, state.steps, state.zbuf


def _log1p_f32(x: torch.Tensor) -> torch.Tensor:
    return torch.log1p(x.double()).float()


def colorize_stats(config: Config, count, steps, zbuf):
    """The global reductions of the tone map, each a 0-d device tensor: Gas
    mode the max count as float32 (the reference tracks it as a running
    max, src/lib.rs:813-815); Depth mode the sentinel-excluded (zmax, zmin)
    fold, which starts at (0.0, f32::MAX) (src/lib.rs:875-899), so an
    all-valid, all-negative plane still normalizes against zmax = 0.0."""
    del steps
    if config.render == RenderKind.DEPTH:
        valid = zbuf != -1.0
        zero = torch.zeros((), dtype=torch.float32, device=zbuf.device)
        zmax = torch.maximum(zero, torch.where(valid, zbuf, zero).max())
        return zmax, torch.where(valid, zbuf, f32(np.finfo(np.float32).max)).min()
    _check_gas(count)
    return (u32(count).to(torch.float32).max(),)


def _check_gas(count) -> None:
    if count is None:
        raise ValueError("this state was accumulated with BinStrategy.DEPTH (z-buffer "
                         "only) and cannot be colorized as a Gas render; use "
                         "BinStrategy.PACKED/EXACT if you need both render kinds")


def colorize_planes(config: Config, count, steps, zbuf, stats=None):
    """Tone-map planes to an (H, W, 4) uint16 RGBA tensor."""
    if config.render == RenderKind.DEPTH:
        # src/lib.rs:875-899; the divisor is a device tensor, so the quotient
        # is IEEE on every device (models.transforms.div_ieee)
        zmax, zmin = stats if stats is not None else colorize_stats(config, count, steps, zbuf)
        z = torch.where(zbuf != -1.0, (zbuf - zmin) / (zmax - zmin), 0.0)
        gray = _saturate_u16(z * f32(65535.0))
        alpha = torch.full(tuple(zbuf.shape), 65535, dtype=torch.uint16, device=zbuf.device)
        return torch.stack([gray, gray, gray, alpha], dim=-1)
    _check_gas(count)
    bk = config.colors.brightness
    rgb = palette_lookup(config.colors.palette.stops, steps)
    cf = u32(count).to(torch.float32)
    (maxc,) = stats if stats is not None else colorize_stats(config, count, steps, zbuf)
    # log base (max+1) brightness (src/lib.rs:860); NaN when max == 0, which
    # the saturating cast maps to 0 like the reference's empty render
    factor = _log1p_f32(cf) / _log1p_f32(maxc)
    channels = (rgb * factor[..., None] + f32(bk.offset)) * f32(bk.factor)
    rgb16 = _saturate_u16(channels * 65535.0)
    if config.transparent:
        alpha = _saturate_u16(factor * 65535.0)
    else:
        alpha = torch.full(tuple(count.shape), 65535, dtype=torch.uint16, device=count.device)
    return torch.cat([rgb16, alpha[..., None]], dim=-1)


def _kernel_planes(state: RenderState) -> list:
    """The state's planes as kernel T reads them, each a pointer or 0:
    (count, steps, zbuf, packed); raises unless every plane is a
    contiguous plane of its dtype on one Hopper card."""
    shape, ptrs = state.shape, []
    for name in ("count", "steps", "zbuf", "packed"):
        t = getattr(state, name)
        if t is None:
            ptrs.append(0)
            continue
        cuda_lib.check_tensor(t, torch.float32 if name in ("steps", "zbuf") else torch.int32,
                              name)
        if tuple(t.shape) != shape or t.device != state.device:
            raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, the state "
                             f"{shape} on {state.device}")
        ptrs.append(t.data_ptr())
    return ptrs


def _tonemap_stats(config: Config, state: RenderState) -> torch.Tensor:
    """Kernel T's reduction (``csrc/tonemap.cu`` ``sat_tonemap_stats``) of a
    state on a card into a (2,) float32 tensor there: Gas (max count, its
    ``_log1p_f32``), Depth (zmax, zmin), as :func:`colorize_stats` gives
    them. Raises when it cannot launch."""
    count, _, zbuf, packed = _kernel_planes(state)
    # 4 words of the reduction's scratch, then the 2 float32 stats
    buf = torch.empty(6, dtype=torch.int32, device=state.device)
    stats = buf[4:].view(torch.float32)
    cuda_lib.launch("sat_tonemap_stats", state.device, count, zbuf, packed,
                    math.prod(state.shape), int(config.render == RenderKind.DEPTH),
                    buf.data_ptr(), stats.data_ptr())
    _tonemap_stats.launches += 1
    return stats


@functools.lru_cache(maxsize=8)
def _card_palette(stops: bytes, device: torch.device) -> torch.Tensor:
    """A palette's float32 stops on a card, copied there once a palette."""
    return torch.frombuffer(bytearray(stops), dtype=torch.float32).to(device)


def convert_format_device(image_u16: torch.Tensor, transparent: bool, eight_bit: bool):
    """The (transparent, 8-bit) conversion on the device, the torch twin of
    :func:`utils.export.convert_format`: the plain chain's last step. For v
    in [0, 65535], ``(v*255 + 32767) // 65535 == ((v + 128) * 65281) >>
    24`` exactly (the JAX package's strength reduction, derived at
    strange_attractor_tpu/utils/export.py:42-51); the product needs more
    than 31 bits, so it runs in int64."""
    img = image_u16 if transparent else image_u16[..., :3]
    if eight_bit:
        img = (((img.to(torch.int64) + 128) * 65281) >> 24).to(torch.uint8)
    return img


def _out_tensor(out: Optional[torch.Tensor], shape: tuple, dtype, device) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if tuple(out.shape) != shape or out.dtype != dtype or out.device != device:
        raise ValueError(f"out must be a {shape} {dtype} tensor on {device}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")
    return out


def tonemap(config: Config, state: RenderState, *, transparent: bool = True,
            eight_bit: bool = False, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A state's image: the tone map (:func:`colorize_planes`, alpha as
    ``config.transparent`` says) and the conversion
    (:func:`convert_format_device`: alpha kept when
    ``transparent``, 8-bit when ``eight_bit``), an (H, W, 4 or 3) uint16
    or uint8 tensor on the state's device. ``out`` optionally takes the
    image (a contiguous tensor of its shape and dtype on the device).

    On the CPU it runs the plain chain. On a card it launches kernel T
    (``csrc/tonemap.cu``): its reduction, then ``sat_tonemap``, the
    elementwise pass and the conversion in one."""
    depth = config.render == RenderKind.DEPTH
    if not depth:
        _check_gas(state.count)
    shape = (*state.shape, 4 if transparent else 3)
    dtype = torch.uint8 if eight_bit else torch.uint16
    if state.device.type == "cpu":
        img = convert_format_device(colorize_planes(config, *state_planes(state)), transparent,
                                    eight_bit)
        return img if out is None else _out_tensor(out, shape, dtype, state.device).copy_(img)
    dev = state.device
    planes = _kernel_planes(state)
    out = _out_tensor(out, shape, dtype, dev)
    cuda_lib.check_tensor(out, dtype, "out")
    stats = _tonemap_stats(config, state)
    palette, k = 0, 0
    if not depth:
        stops = config.colors.palette.stops
        k = stops.shape[0] - 1
        palette = _card_palette(stops.astype(np.float32).tobytes(), dev).data_ptr()
    bk = config.colors.brightness
    cuda_lib.launch("sat_tonemap", dev, *planes, stats.data_ptr(), palette, k, bk.offset,
                    bk.factor, math.prod(state.shape), int(depth), int(config.transparent),
                    shape[-1], int(eight_bit), out.data_ptr())
    tonemap.launches += 1
    return out


_tonemap_stats.launches = 0
tonemap.launches = 0
