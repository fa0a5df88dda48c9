"""Fused map + emit: the lane recurrence that feeds the binning.

Per map step and lane: the map step (the Sprott map or an RK4 step), view
rotation, camera projection, color transform, bounds check and (z, value)
packing -- the body of the JAX package's ``_step_fn`` + ``_finish_emit``
(strange_attractor_tpu/render.py:130-196), which XLA fused into one
``lax.scan`` program on the TPU.

Two implementations with one contract:

- :func:`map_emit_plain`, plain torch ops in a Python loop over steps (about
  fifty small ops per step);
- :func:`map_emit`, the wrapper of the CUDA kernel ``csrc/map_emit.cu``: one
  thread per lane carries the point in registers through all steps. For a
  CPU tensor it runs :func:`map_emit_plain`.

The stream depends on the planes kind of the bin strategy, as in
``_finish_emit`` (render.py:192-196): PACKED emits ``(flat, packed)``, DEPTH
``(flat, z)`` and EXACT ``(flat, z, val)``, with full float32 ``z`` and
``val``; a NaN ``z`` becomes -inf in every kind.

A rotation sequence that bins one orbit at every frame splits the step in
two (the JAX package's ``_step_fn_shared`` + ``_project_emit``,
render.py:199-266): :func:`map_emit_shared` (``csrc/map_emit.cu``'s shared
modes) advances the lanes and emits the frame-invariant stream ``(xc, zc,
fj, val)`` -- ``(xc, zc, fj)`` for DEPTH -- once per chunk, and
:func:`project_emit` (``csrc/project_emit.cu``) turns it into one frame's
``(flat, payload...)`` stream; both have plain twins
(:func:`map_emit_shared_plain`, :func:`project_emit_plain`). The two halves
are :func:`ops.projection.project`'s own, so a frame's stream is
bit-identical to :func:`map_emit`'s at that angle.

Two axes run through every function here, as through the JAX package's
``_chunk_update`` (render.py:410-429):

- the compute dtype: the lane state is float32 or float64 (``Config.dtype``;
  the JAX package's ``_dtype``, render.py:48-57), and the map, rotation,
  projection, color transform and bounds check run in it; z and the value
  are cast to float32 at emission, where ``_finish_emit`` casts them
  (render.py:192-196), so the bins and planes are float32 in both. The
  shared stream is in the compute dtype;
- lane reseeding (``Config.reseed_lanes``): a :class:`Reseed` (the lane
  ages, the render key, the chunk index, the warm-up) makes an emitting call
  first restart every dead lane from a fresh point (:func:`reseed_plain`,
  the JAX package's ``_reseed_dead_lanes``, render.py:278-298), then emit a
  step only while its lane's age is above 0 (``age = min(age + 1, 1)``,
  render.py:150-157). A gated point bins nowhere (``flat = npix``), even
  with NaN coordinates; in the shared stream it carries ``fj = +inf``, which
  :func:`project_emit` drops by the same bounds check. Fresh points come
  from a counter-based generator (:func:`philox4x32`) that the kernel
  computes bit for bit, not from ``jax.random``: renders with reseeding
  agree with the JAX package's in distribution.

Lane state is a (3, lanes) float32 or float64 tensor of the current
points, updated in place. The JAX package also carries the previous point,
but at every chunk boundary it equals the current one (the carry sets both
to the new point, and a render starts with ``prev = cur``), so the delta of
a step is simply ``new - old``. The emitted streams are step-major, index ``s * lanes +
lane`` -- JAX's ``emitted.reshape(-1)`` order.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from ..config import BinStrategy, Config
from ..models.attractors import Halvorsen, Lorenz, PolynomialSprott2Degree, Rossler, Thomas
from ..models.transforms import AdjustedVelocity, PoissonSaturneTransform
from . import cuda_lib
from .binning import pack_zv
from .projection import (CameraParams, angle_half, camera_params, f32, project, rotate_xyz,
                         rounded, shared_operands)

# the compute dtypes of Config.dtype
DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class EmitSpec:
    """Everything one map+emit launch reads besides the lane state."""

    attractor: object  # a models.attractors map
    transform: object
    view: object
    cam: CameraParams  # carries the camera angle's cos/sin

    @property
    def npix(self) -> int:
        return self.cam.width * self.cam.height

    @functools.cached_property
    def params(self) -> cuda_lib.EmitParams:
        """The kernels' float32 launch constants, built once per spec: a
        render launches with one spec per chunk, a sequence with one per
        frame."""
        return _kernel_params(self, cuda_lib.EmitParams, f32)

    @functools.cached_property
    def params64(self) -> cuda_lib.EmitParams64:
        """The float64 compute path's launch constants, each the host's
        float64 value itself."""
        return _kernel_params(self, cuda_lib.EmitParams64, float)


def emit_spec(config: Config, angle: float) -> EmitSpec:
    """The map+emit constants of ``config`` viewed at ``angle`` radians."""
    cam = camera_params(config.view, angle, config.width, config.height)
    return EmitSpec(config.attractor, config.color_transform, config.view, cam)


def finish_emit(npix: int, width: int, height: int, fi, fj, z2, val,
                kind: BinStrategy = BinStrategy.PACKED, gate=None):
    """Bounds check and the stream of one point batch for the planes kind of
    ``kind``: ``(flat, packed)``, ``(flat, z)`` or ``(flat, z, val)``.

    The reference skips a point iff i >= W or j >= H or i < 0 or j < 0
    (src/lib.rs:789). NaN coordinates of escaped orbits fail all four tests,
    pass, and bin at pixel (0, 0) through the saturating cast
    (src/lib.rs:799-812). Only in-bounds, non-NaN coordinates reach the int
    cast here, so the cast never sees inf or NaN. A point whose ``gate``
    (the emission gate of reseeded lanes; None: every point) is False goes
    to ``npix`` like an out-of-bounds one. NaN z becomes -inf, which never
    wins the z-test (src/lib.rs:821). The test and the cast run in the
    compute dtype; z and the value are cast to float32 last.
    """
    oob = (fi >= width) | (fj >= height) | (fi < 0.0) | (fj < 0.0)
    inb = ~oob if gate is None else ~oob & gate
    ii = torch.where(inb & ~torch.isnan(fi), fi, 0.0).to(torch.int32)
    jj = torch.where(inb & ~torch.isnan(fj), fj, 0.0).to(torch.int32)
    flat = torch.where(inb, jj * width + ii, npix).to(torch.int32)
    z2 = torch.where(torch.isnan(z2), -math.inf, z2).float()
    val = None if val is None else val.float()
    kind = kind.planes_kind()
    if kind == BinStrategy.PACKED:
        return flat, pack_zv(z2, val)
    if kind == BinStrategy.DEPTH:
        return flat, z2
    return flat, z2, val


def _stream_dtypes(kind: BinStrategy) -> tuple:
    kind = kind.planes_kind()
    if kind == BinStrategy.PACKED:
        return torch.int32, torch.int32
    if kind == BinStrategy.DEPTH:
        return torch.int32, torch.float32
    return torch.int32, torch.float32, torch.float32


@dataclasses.dataclass(frozen=True)
class Reseed:
    """Lane reseeding for one emitting call (chunk) of a render.

    ``age`` is the (lanes,) int32 lane age on the lanes' device, which the
    call updates in place (a render starts it at 0, the JAX package's
    render.py:589); ``key`` the render's 64-bit key, ``chunk`` the chunk's
    index in the render and ``warmup`` the steps a reseeded lane re-warms
    before it emits again."""

    age: torch.Tensor
    key: int
    chunk: int
    warmup: int


# Philox4x32-10 (Salmon, Moraes, Dror, Shaw, SC'11): multipliers and the
# Weyl key increments
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF
_MASK64 = (1 << 64) - 1


def _mulhilo(m: int, b: torch.Tensor) -> tuple:
    """(high, low) 32-bit words of ``m * b`` for a u32 constant ``m`` and
    u32 values ``b`` in an int64 tensor, from 16-bit halves: no partial
    product or sum leaves int64 (torch has no uint32 arithmetic)."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    b_hi, b_lo = b >> 16, b & 0xFFFF
    mid = b_hi * m_lo + b_lo * m_hi  # < 2^33
    low = b_lo * m_lo + ((mid & 0xFFFF) << 16)  # < 2^33
    return (b_hi * m_hi + (mid >> 16) + (low >> 32)) & _MASK32, low & _MASK32


def philox4x32(counter: tuple, key: int) -> tuple:
    """Philox4x32-10 of the four u32 counter words ``counter`` (int64
    tensors or ints broadcast against them) under the 64-bit ``key``: four
    int64 tensors of u32 words. ``csrc/emit_common.cuh`` philox4x32 is the
    kernel's."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = key & _MASK32, (key >> 32) & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + PHILOX_W[0]) & _MASK32, (k1 + PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def fresh_points(lanes: int, key: int, chunk: int, dtype: torch.dtype,
                 device=None) -> torch.Tensor:
    """The (3, lanes) fresh points U[0,1)^3 * 0.1 of chunk ``chunk`` under
    the render key ``key``: component ``c`` of lane ``l`` is Philox of the
    counter ``(l, chunk, c, 0)``, its first word's top 24 bits the float32
    uniform, or 27 bits of the first and 26 of the second the float64 one;
    then times 0.1 in the compute dtype."""
    lane = torch.arange(lanes, dtype=torch.int64, device=device)
    rows = []
    for comp in range(3):
        w0, w1, _, _ = philox4x32((lane, chunk & _MASK32, comp, 0), key)
        if dtype == torch.float64:
            u = ((w0 >> 5) * 67108864 + (w1 >> 6)).to(torch.float64) * 2.0 ** -53
        else:
            u = (w0 >> 8).to(torch.float32) * 2.0 ** -24
        rows.append(u * rounded(0.1, u))
    return torch.stack(rows)


def reseed_plain(points: torch.Tensor, reseed: Reseed) -> None:
    """Restart the dead lanes of ``points`` (3, lanes) in place: the JAX
    package's ``_reseed_dead_lanes`` (render.py:278-298). A lane is dead
    when a component is not finite or its magnitude exceeds 1e3; it takes
    its :func:`fresh_points` point and the age ``-warmup``."""
    bad = ~(points.abs() <= 1e3).all(dim=0)
    fresh = fresh_points(points.shape[1], reseed.key, reseed.chunk, points.dtype, points.device)
    points.copy_(torch.where(bad, fresh, points))
    reseed.age.copy_(torch.where(bad, -reseed.warmup, reseed.age))


def _gates(reseed: Optional[Reseed], steps: int):
    """Each step's emission gate (None without reseeding), advancing the
    ages: ``age = min(age + 1, 1)``, emit while ``age > 0``."""
    age = None if reseed is None else reseed.age
    for _ in range(steps):
        if age is None:
            yield None
            continue
        age = torch.clamp(age + 1, max=1)
        yield age > 0
    if age is not None:
        reseed.age.copy_(age)


def map_emit_plain(spec: EmitSpec, points: torch.Tensor, steps: int, *, emit: bool = True,
                   kind: BinStrategy = BinStrategy.PACKED, reseed: Optional[Reseed] = None):
    """Advance ``points`` (3, lanes) float32 or float64 by ``steps`` map
    steps, in place.

    With ``emit`` returns the step-major streams of ``steps * lanes``
    points for the planes kind of ``kind`` (:func:`finish_emit`); without it
    (the warm-up) returns None. A DEPTH stream skips the color transform.
    ``reseed`` (emitting calls only) restarts the dead lanes first
    (:func:`reseed_plain`) and gates each step's emission by its lane's age.
    """
    if reseed is not None:
        if not emit:
            raise ValueError("the warm-up does not reseed")
        reseed_plain(points, reseed)
    cam = spec.cam
    depth = kind.planes_kind() == BinStrategy.DEPTH
    x, y, z = points[0], points[1], points[2]
    rows = []
    for gate in _gates(reseed, steps):
        nx, ny, nz = spec.attractor.step_xyz(x, y, z)
        if emit:
            sx, sy, sz = rotate_xyz(cam, nx, ny, nz)
            fi, fj, z2 = project(cam, sx, sy, sz, cam.cos_angle, cam.sin_angle)
            val = None if depth else spec.transform.xyz(nx - x, ny - y, nz - z,
                                                        sx, sy, sz, spec.view)
            rows.append(finish_emit(spec.npix, cam.width, cam.height, fi, fj, z2, val, kind,
                                    gate))
        x, y, z = nx, ny, nz
    points.copy_(torch.stack([x, y, z]))
    if not emit:
        return None
    if not rows:
        return tuple(torch.empty(0, dtype=dt, device=points.device)
                     for dt in _stream_dtypes(kind))
    return tuple(torch.cat(s) for s in zip(*rows))


def _shared_dtypes(kind: BinStrategy, dtype: torch.dtype = torch.float32) -> tuple:
    return (dtype,) * (3 if kind.planes_kind() == BinStrategy.DEPTH else 4)


def map_emit_shared_plain(spec: EmitSpec, points: torch.Tensor, steps: int, *,
                          kind: BinStrategy = BinStrategy.PACKED,
                          reseed: Optional[Reseed] = None):
    """Advance ``points`` (3, lanes) float32 or float64 by ``steps`` map
    steps, in place, and return the step-major frame-invariant streams of
    ``steps * lanes`` points in the compute dtype: ``(xc, zc, fj, val)``, or
    ``(xc, zc, fj)`` for a DEPTH planes kind
    (:func:`ops.projection.shared_operands`; ``val`` is the color
    transform). The counterpart of the JAX package's ``_step_fn_shared``
    (render.py:199-243). The camera angle of ``spec`` is not read. With
    ``reseed`` (:func:`map_emit_plain`) a gated point's ``fj`` is +inf,
    where the JAX package emits a separate gate (render.py:239-240): any
    frame's bounds check drops it.
    """
    if reseed is not None:
        reseed_plain(points, reseed)
    cam = spec.cam
    depth = kind.planes_kind() == BinStrategy.DEPTH
    x, y, z = points[0], points[1], points[2]
    rows = []
    for gate in _gates(reseed, steps):
        nx, ny, nz = spec.attractor.step_xyz(x, y, z)
        sx, sy, sz = rotate_xyz(cam, nx, ny, nz)
        row = list(shared_operands(cam, sx, sy, sz))
        if gate is not None:
            row[2] = torch.where(gate, row[2], math.inf)
        if not depth:
            row.append(spec.transform.xyz(nx - x, ny - y, nz - z, sx, sy, sz, spec.view))
        rows.append(row)
        x, y, z = nx, ny, nz
    points.copy_(torch.stack([x, y, z]))
    if not rows:
        return tuple(torch.empty(0, dtype=dt, device=points.device)
                     for dt in _shared_dtypes(kind, points.dtype))
    return tuple(torch.cat(s) for s in zip(*rows))


def _check_shared_stream(stream, kind: BinStrategy) -> None:
    want = len(_shared_dtypes(kind))
    if len(stream) != want:
        raise ValueError(f"{kind.planes_kind().value} planes take {want} shared streams "
                         f"(xc, zc, fj[, val]), got {len(stream)}")


def project_emit_plain(spec: EmitSpec, stream, *, kind: BinStrategy = BinStrategy.PACKED):
    """One frame's stream from the shared stream ``(xc, zc, fj[, val])`` of
    :func:`map_emit_shared_plain`, at ``spec``'s camera angle: the
    angle-dependent math (:func:`ops.projection.angle_half`), then
    :func:`finish_emit`. Returns ``(flat, packed)``, ``(flat, z)`` or
    ``(flat, z, val)`` for the planes kind of ``kind``, bit-identical to
    :func:`map_emit_plain`'s stream of the same orbit at that angle. The
    counterpart of the JAX package's ``_project_emit`` (render.py:246-266).
    A float64 shared stream gives float32 z and val, as the fused stream.
    """
    _check_shared_stream(stream, kind)
    cam = spec.cam
    xc, zc, fj = stream[:3]
    val = stream[3] if len(stream) == 4 else None
    fi, z2 = angle_half(cam, xc, zc, cam.cos_angle, cam.sin_angle)
    return finish_emit(spec.npix, cam.width, cam.height, fi, fj, z2, val, kind)


# the kernel's maps (csrc/map_emit.cuh MAP_*)
_MAPS = {PolynomialSprott2Degree: 0, Lorenz: 1, Rossler: 2, Halvorsen: 3, Thomas: 4}


def _kernel_params(spec: EmitSpec, struct, real):
    """Host-side constants in the compute dtype, each taken from float64
    exactly as the plain twin takes it: ``real`` is :func:`f32` for the
    float32 ``struct``, ``float`` for the float64 one."""
    att = spec.attractor
    if type(att) not in _MAPS:
        raise NotImplementedError(f"the map+emit kernel has no map {type(att).__name__}")
    wide = real is float
    cam = spec.cam
    p = struct()
    p.map = _MAPS[type(att)]
    if p.map == 0:
        p.coef[:] = [real(c) for c in att.x + att.y + att.z]
    else:
        consts = att.constants(wide)
        p.mc[:len(consts)] = consts
        p.h, p.hh, p.h6 = att.rk4_constants(wide)
    p.rot[:] = [real(v) for row in cam.rotation_matrix for v in row]
    p.cos_v, p.sin_v = real(cam.cos_angle), real(cam.sin_angle)
    p.ccx, p.ccy, p.ccz = (real(v) for v in cam.center_camera)
    p.mid, p.wscaled = real(cam.scale_adjusted_mid), real(cam.width_scaled)
    p.half_h = real(cam.height / 2.0)
    p.width, p.height = cam.width, cam.height
    if isinstance(spec.transform, PoissonSaturneTransform):
        p.transform = 0
    elif isinstance(spec.transform, AdjustedVelocity):
        p.transform = 1
        p.t_offset, p.t_factor = real(spec.transform.offset), real(spec.transform.factor)
    else:
        raise NotImplementedError(
            f"the map+emit kernel has no color transform {type(spec.transform).__name__}")
    return p


# the kernel's emission modes (csrc/map_emit.cu); 0 is the warm-up. The
# fused modes' numbers are project_emit.cu's too.
_MODES = {BinStrategy.PACKED: 1, BinStrategy.DEPTH: 2, BinStrategy.EXACT: 3}
_SHARED_MODES = {BinStrategy.PACKED: 4, BinStrategy.EXACT: 4, BinStrategy.DEPTH: 5}


_REAL = (torch.float32, torch.float64)


def _reseed_args(reseed: Optional[Reseed], lanes: int, device) -> cuda_lib.ReseedArgs:
    args = cuda_lib.ReseedArgs()
    if reseed is not None:
        cuda_lib.check_tensor(reseed.age, torch.int32, "age")
        if tuple(reseed.age.shape) != (lanes,) or reseed.age.device != device:
            raise ValueError(f"age must be ({lanes},) on {device}, got "
                             f"{tuple(reseed.age.shape)} on {reseed.age.device}")
        args.age, args.key = reseed.age.data_ptr(), reseed.key & _MASK64
        args.chunk, args.warmup = reseed.chunk & _MASK32, reseed.warmup
    return args


def _launch_map_emit(spec: EmitSpec, points: torch.Tensor, steps: int, mode: int,
                     dtypes: tuple, reseed: Optional[Reseed] = None) -> tuple:
    """Check ``points``, allocate the ``steps * lanes`` streams of
    ``dtypes`` and launch ``csrc/map_emit.cu`` in ``mode`` (counted in
    ``map_emit.launches``): ``sat_map_emit`` for float32 points,
    ``sat_map_emit_f64`` for float64 ones."""
    cuda_lib.check_tensor(points, _REAL, "points")
    if points.dim() != 2 or points.shape[0] != 3:
        raise ValueError(f"points must be (3, lanes), got {tuple(points.shape)}")
    lanes = points.shape[1]
    n = steps * lanes
    if n >= 1 << 31:
        raise ValueError(f"{steps} steps x {lanes} lanes overflow the int32 stream index")
    args = _reseed_args(reseed, lanes, points.device)
    out = tuple(torch.empty(n, dtype=dt, device=points.device) for dt in dtypes)
    if n:
        ptrs = [t.data_ptr() for t in out] + [0] * (4 - len(out))
        wide = points.dtype == torch.float64
        cuda_lib.launch("sat_map_emit_f64" if wide else "sat_map_emit", points.device,
                        points.data_ptr(), lanes, steps, mode,
                        spec.params64 if wide else spec.params, args, *ptrs)
        map_emit.launches += 1
        map_emit.f64_launches += wide
        map_emit.gated_launches += reseed is not None
    return out


def map_emit(spec: EmitSpec, points: torch.Tensor, steps: int, *, emit: bool = True,
             kind: BinStrategy = BinStrategy.PACKED, reseed: Optional[Reseed] = None):
    """:func:`map_emit_plain`'s contract, through ``csrc/map_emit.cu`` for a
    CUDA tensor (one launch, counted in ``map_emit.launches``; with
    ``reseed`` the gated kernels, which reseed the lanes first) and through
    :func:`map_emit_plain` for a CPU tensor."""
    if points.device.type == "cpu":
        return map_emit_plain(spec, points, steps, emit=emit, kind=kind, reseed=reseed)
    if not emit:
        if reseed is not None:
            raise ValueError("the warm-up does not reseed")
        _launch_map_emit(spec, points, steps, 0, ())
        return None
    return _launch_map_emit(spec, points, steps, _MODES[kind.planes_kind()],
                            _stream_dtypes(kind), reseed)


# launches of kernel A; of them, of its float64 and of its gated
# (reseeding) instantiations
map_emit.launches = map_emit.f64_launches = map_emit.gated_launches = 0


def map_emit_shared(spec: EmitSpec, points: torch.Tensor, steps: int, *,
                    kind: BinStrategy = BinStrategy.PACKED, reseed: Optional[Reseed] = None):
    """:func:`map_emit_shared_plain`'s contract, through the shared modes of
    ``csrc/map_emit.cu`` for a CUDA tensor (one launch, counted in
    ``map_emit.launches``) and through the twin for a CPU tensor."""
    if points.device.type == "cpu":
        return map_emit_shared_plain(spec, points, steps, kind=kind, reseed=reseed)
    return _launch_map_emit(spec, points, steps, _SHARED_MODES[kind.planes_kind()],
                            _shared_dtypes(kind, points.dtype), reseed)


def project_emit(spec: EmitSpec, stream, *, kind: BinStrategy = BinStrategy.PACKED):
    """:func:`project_emit_plain`'s contract, through
    ``csrc/project_emit.cu`` for CUDA tensors (one launch, counted in
    ``project_emit.launches``) and through the twin for CPU tensors. A
    float32 EXACT frame hands the shared ``val`` tensor on as its value
    stream; a float64 one gets the kernel's float32 cast of it."""
    if stream[0].device.type == "cpu":
        return project_emit_plain(spec, stream, kind=kind)
    _check_shared_stream(stream, kind)
    kind = kind.planes_kind()
    n, dev, dtype = stream[0].shape[0], stream[0].device, stream[0].dtype
    for t, name in zip(stream, ("xc", "zc", "fj", "val")):
        cuda_lib.check_tensor(t, _REAL, name)
        if tuple(t.shape) != (n,) or t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name} must be ({n},) {dtype} on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    wide = dtype == torch.float64
    out = tuple(torch.empty(n, dtype=dt, device=dev)
                for dt in _stream_dtypes(kind)[:3 if wide else 2])
    if not wide and kind == BinStrategy.EXACT:
        out = (*out, stream[3])
    if n:
        val = stream[3].data_ptr() if len(stream) == 4 else 0
        ptrs = [t.data_ptr() for t in stream[:3]] + [val] + [t.data_ptr() for t in out[:2]]
        if wide:
            cuda_lib.launch("sat_project_emit_f64", dev, n, _MODES[kind], spec.params64, *ptrs,
                            out[2].data_ptr() if kind == BinStrategy.EXACT else 0)
        else:
            cuda_lib.launch("sat_project_emit", dev, n, _MODES[kind], spec.params, *ptrs)
        project_emit.launches += 1
        project_emit.f64_launches += wide
    return out


# launches of kernel P; of them, on a float64 shared stream
project_emit.launches = project_emit.f64_launches = 0


def seed_points(lanes: int, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Seed points U[0,1)^3 * 0.1 (src/lib.rs:748) as a (lanes, 3) CPU
    tensor of the compute dtype: drawn on the CPU so a seed gives the same
    points on every device."""
    u = torch.rand((lanes, 3), generator=generator, dtype=dtype)
    return u * rounded(0.1, u)


def render_key(generator: torch.Generator) -> int:
    """A render's 64-bit reseeding key, two 32-bit draws of ``generator``
    after its seed points (:func:`seed_points`): a render without reseeding
    draws the same seeds either way."""
    hi, lo = torch.randint(0, 1 << 32, (2,), generator=generator, dtype=torch.int64).tolist()
    return (hi << 32) | lo
