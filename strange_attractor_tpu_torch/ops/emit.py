"""Fused map + emit: the lane recurrence that feeds the binning.

Per map step and lane: Sprott step, view rotation, camera projection, color
transform, bounds check and (z, value) packing -- the body of the JAX
package's ``_step_fn`` + ``_finish_emit`` (strange_attractor_tpu/render.py:
130-196), which XLA fused into one ``lax.scan`` program on the TPU.

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

Lane state is a (3, lanes) float32 tensor of the current points, updated in
place. The JAX package also carries the previous point, but at every chunk
boundary it equals the current one (the carry sets both to the new point,
and a render starts with ``prev = cur``), so the delta of a step is simply
``new - old``. The emitted streams are step-major, index ``s * lanes +
lane`` -- JAX's ``emitted.reshape(-1)`` order.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..config import BinStrategy, Config
from ..models.attractors import PolynomialSprott2Degree
from ..models.transforms import AdjustedVelocity, PoissonSaturneTransform
from . import cuda_lib
from .binning import pack_zv
from .projection import (CameraParams, angle_half, camera_params, f32, project, rotate_xyz,
                         shared_operands)


@dataclasses.dataclass(frozen=True)
class EmitSpec:
    """Everything one map+emit launch reads besides the lane state."""

    attractor: PolynomialSprott2Degree
    transform: object
    view: object
    cam: CameraParams  # carries the camera angle's cos/sin

    @property
    def npix(self) -> int:
        return self.cam.width * self.cam.height

    @functools.cached_property
    def params(self) -> cuda_lib.EmitParams:
        """The kernels' launch constants, built once per spec: a render
        launches with one spec per chunk, a sequence with one per frame."""
        return _kernel_params(self)


def emit_spec(config: Config, angle: float) -> EmitSpec:
    """The map+emit constants of ``config`` viewed at ``angle`` radians."""
    cam = camera_params(config.view, angle, config.width, config.height)
    return EmitSpec(config.attractor, config.color_transform, config.view, cam)


def finish_emit(npix: int, width: int, height: int, fi, fj, z2, val,
                kind: BinStrategy = BinStrategy.PACKED):
    """Bounds check and the stream of one point batch for the planes kind of
    ``kind``: ``(flat, packed)``, ``(flat, z)`` or ``(flat, z, val)``.

    The reference skips a point iff i >= W or j >= H or i < 0 or j < 0
    (src/lib.rs:789). NaN coordinates of escaped orbits fail all four tests,
    pass, and bin at pixel (0, 0) through the saturating cast
    (src/lib.rs:799-812). Only in-bounds, non-NaN coordinates reach the int
    cast here, so the cast never sees inf or NaN. NaN z becomes -inf, which
    never wins the z-test (src/lib.rs:821).
    """
    oob = (fi >= width) | (fj >= height) | (fi < 0.0) | (fj < 0.0)
    inb = ~oob
    ii = torch.where(inb & ~torch.isnan(fi), fi, 0.0).to(torch.int32)
    jj = torch.where(inb & ~torch.isnan(fj), fj, 0.0).to(torch.int32)
    flat = torch.where(inb, jj * width + ii, npix).to(torch.int32)
    z2 = torch.where(torch.isnan(z2), -math.inf, z2)
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


def map_emit_plain(spec: EmitSpec, points: torch.Tensor, steps: int, *, emit: bool = True,
                   kind: BinStrategy = BinStrategy.PACKED):
    """Advance ``points`` (3, lanes) float32 by ``steps`` map steps, in place.

    With ``emit`` returns the step-major streams of ``steps * lanes``
    points for the planes kind of ``kind`` (:func:`finish_emit`); without it
    (the warm-up) returns None. A DEPTH stream skips the color transform.
    """
    cam = spec.cam
    depth = kind.planes_kind() == BinStrategy.DEPTH
    x, y, z = points[0], points[1], points[2]
    rows = []
    for _ in range(steps):
        nx, ny, nz = spec.attractor.step_xyz(x, y, z)
        if emit:
            sx, sy, sz = rotate_xyz(cam, nx, ny, nz)
            fi, fj, z2 = project(cam, sx, sy, sz, cam.cos_angle, cam.sin_angle)
            val = None if depth else spec.transform.xyz(nx - x, ny - y, nz - z,
                                                        sx, sy, sz, spec.view)
            rows.append(finish_emit(spec.npix, cam.width, cam.height, fi, fj, z2, val, kind))
        x, y, z = nx, ny, nz
    points.copy_(torch.stack([x, y, z]))
    if not emit:
        return None
    if not rows:
        return tuple(torch.empty(0, dtype=dt, device=points.device)
                     for dt in _stream_dtypes(kind))
    return tuple(torch.cat(s) for s in zip(*rows))


def _shared_dtypes(kind: BinStrategy) -> tuple:
    return (torch.float32,) * (3 if kind.planes_kind() == BinStrategy.DEPTH else 4)


def map_emit_shared_plain(spec: EmitSpec, points: torch.Tensor, steps: int, *,
                          kind: BinStrategy = BinStrategy.PACKED):
    """Advance ``points`` (3, lanes) float32 by ``steps`` map steps, in
    place, and return the step-major frame-invariant streams of ``steps *
    lanes`` points: ``(xc, zc, fj, val)``, or ``(xc, zc, fj)`` for a DEPTH
    planes kind (:func:`ops.projection.shared_operands`; ``val`` is the
    color transform). The counterpart of the JAX package's
    ``_step_fn_shared`` (render.py:199-243). The camera angle of ``spec``
    is not read.
    """
    cam = spec.cam
    depth = kind.planes_kind() == BinStrategy.DEPTH
    x, y, z = points[0], points[1], points[2]
    rows = []
    for _ in range(steps):
        nx, ny, nz = spec.attractor.step_xyz(x, y, z)
        sx, sy, sz = rotate_xyz(cam, nx, ny, nz)
        row = list(shared_operands(cam, sx, sy, sz))
        if not depth:
            row.append(spec.transform.xyz(nx - x, ny - y, nz - z, sx, sy, sz, spec.view))
        rows.append(row)
        x, y, z = nx, ny, nz
    points.copy_(torch.stack([x, y, z]))
    if not rows:
        return tuple(torch.empty(0, dtype=dt, device=points.device)
                     for dt in _shared_dtypes(kind))
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
    """
    _check_shared_stream(stream, kind)
    cam = spec.cam
    xc, zc, fj = stream[:3]
    val = stream[3] if len(stream) == 4 else None
    fi, z2 = angle_half(cam, xc, zc, cam.cos_angle, cam.sin_angle)
    return finish_emit(spec.npix, cam.width, cam.height, fi, fj, z2, val, kind)


def _kernel_params(spec: EmitSpec) -> cuda_lib.EmitParams:
    """Host-side float32 constants, each rounded once from float64 exactly
    as the plain twin rounds them."""
    if type(spec.attractor) is not PolynomialSprott2Degree:
        raise NotImplementedError("the map+emit kernel runs PolynomialSprott2Degree only, "
                                  f"got {type(spec.attractor).__name__}")
    cam = spec.cam
    p = cuda_lib.EmitParams()
    p.coef[:] = [float(c) for c in spec.attractor.coefficients_f32().reshape(-1)]
    p.rot[:] = [f32(v) for row in cam.rotation_matrix for v in row]
    p.cos_v, p.sin_v = f32(cam.cos_angle), f32(cam.sin_angle)
    p.ccx, p.ccy, p.ccz = (f32(v) for v in cam.center_camera)
    p.mid, p.wscaled = f32(cam.scale_adjusted_mid), f32(cam.width_scaled)
    p.half_h = f32(cam.height / 2.0)
    p.width, p.height = cam.width, cam.height
    if isinstance(spec.transform, PoissonSaturneTransform):
        p.transform = 0
    elif isinstance(spec.transform, AdjustedVelocity):
        p.transform = 1
        p.t_offset, p.t_factor = f32(spec.transform.offset), f32(spec.transform.factor)
    else:
        raise NotImplementedError(
            f"the map+emit kernel has no color transform {type(spec.transform).__name__}")
    return p


# the kernel's emission modes (csrc/map_emit.cu); 0 is the warm-up. The
# fused modes' numbers are project_emit.cu's too.
_MODES = {BinStrategy.PACKED: 1, BinStrategy.DEPTH: 2, BinStrategy.EXACT: 3}
_SHARED_MODES = {BinStrategy.PACKED: 4, BinStrategy.EXACT: 4, BinStrategy.DEPTH: 5}


def _launch_map_emit(spec: EmitSpec, points: torch.Tensor, steps: int, mode: int,
                     dtypes: tuple) -> tuple:
    """Check ``points``, allocate the ``steps * lanes`` streams of
    ``dtypes`` and launch ``csrc/map_emit.cu`` in ``mode`` (counted in
    ``map_emit.launches``)."""
    cuda_lib.check_tensor(points, torch.float32, "points")
    if points.dim() != 2 or points.shape[0] != 3:
        raise ValueError(f"points must be (3, lanes), got {tuple(points.shape)}")
    lanes = points.shape[1]
    n = steps * lanes
    if n >= 1 << 31:
        raise ValueError(f"{steps} steps x {lanes} lanes overflow the int32 stream index")
    out = tuple(torch.empty(n, dtype=dt, device=points.device) for dt in dtypes)
    if n:
        ptrs = [t.data_ptr() for t in out] + [0] * (4 - len(out))
        cuda_lib.launch("sat_map_emit", points.device, points.data_ptr(), lanes, steps, mode,
                        spec.params, *ptrs)
        map_emit.launches += 1
    return out


def map_emit(spec: EmitSpec, points: torch.Tensor, steps: int, *, emit: bool = True,
             kind: BinStrategy = BinStrategy.PACKED):
    """:func:`map_emit_plain`'s contract, through ``csrc/map_emit.cu`` for a
    CUDA tensor (one launch, counted in ``map_emit.launches``) and through
    :func:`map_emit_plain` for a CPU tensor."""
    if points.device.type == "cpu":
        return map_emit_plain(spec, points, steps, emit=emit, kind=kind)
    if not emit:
        _launch_map_emit(spec, points, steps, 0, ())
        return None
    return _launch_map_emit(spec, points, steps, _MODES[kind.planes_kind()],
                            _stream_dtypes(kind))


map_emit.launches = 0


def map_emit_shared(spec: EmitSpec, points: torch.Tensor, steps: int, *,
                    kind: BinStrategy = BinStrategy.PACKED):
    """:func:`map_emit_shared_plain`'s contract, through the shared modes of
    ``csrc/map_emit.cu`` for a CUDA tensor (one launch, counted in
    ``map_emit.launches``) and through the twin for a CPU tensor."""
    if points.device.type == "cpu":
        return map_emit_shared_plain(spec, points, steps, kind=kind)
    return _launch_map_emit(spec, points, steps, _SHARED_MODES[kind.planes_kind()],
                            _shared_dtypes(kind))


def project_emit(spec: EmitSpec, stream, *, kind: BinStrategy = BinStrategy.PACKED):
    """:func:`project_emit_plain`'s contract, through
    ``csrc/project_emit.cu`` for CUDA tensors (one launch, counted in
    ``project_emit.launches``) and through the twin for CPU tensors. An
    EXACT frame hands the shared ``val`` tensor on as its value stream."""
    if stream[0].device.type == "cpu":
        return project_emit_plain(spec, stream, kind=kind)
    _check_shared_stream(stream, kind)
    kind = kind.planes_kind()
    n = stream[0].shape[0]
    for t, name in zip(stream, ("xc", "zc", "fj", "val")):
        cuda_lib.check_tensor(t, torch.float32, name)
        if tuple(t.shape) != (n,) or t.device != stream[0].device:
            raise ValueError(f"{name} must be ({n},) on {stream[0].device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    flat, out1 = (torch.empty(n, dtype=dt, device=stream[0].device)
                  for dt in _stream_dtypes(kind)[:2])
    if n:
        val = stream[3].data_ptr() if len(stream) == 4 else 0
        cuda_lib.launch("sat_project_emit", stream[0].device, n, _MODES[kind], spec.params,
                        stream[0].data_ptr(), stream[1].data_ptr(), stream[2].data_ptr(), val,
                        flat.data_ptr(), out1.data_ptr())
        project_emit.launches += 1
    return (flat, out1, stream[3]) if kind == BinStrategy.EXACT else (flat, out1)


project_emit.launches = 0


def seed_points(lanes: int, generator: torch.Generator) -> torch.Tensor:
    """Seed points U[0,1)^3 * 0.1 (src/lib.rs:748) as a (lanes, 3) float32
    CPU tensor: drawn on the CPU so a seed gives the same points on every
    device."""
    return torch.rand((lanes, 3), generator=generator, dtype=torch.float32) * f32(0.1)
