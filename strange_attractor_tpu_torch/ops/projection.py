"""Rotation and camera projection math (PyTorch port).

Host-side (numpy, float64) precomputation of the Euler-axis rotation matrix
and the per-frame camera constants, plus the per-point camera rotation and
projection on torch tensors (reference: src/lib.rs:755-786).

Every device constant is the float64 host value as the compute dtype sees
it (:func:`rounded`): rounded once to float32 -- the rounding
``jnp.asarray(v, float32)`` applies -- or exact in float64, so the torch
twins and the CUDA map+emit kernel see bit-identical operands.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class EulerAxisRotation:
    """Euler axis + angle rotation (reference: src/lib.rs:169-196).

    ``axis`` is a 3-tuple; ``rotation`` is the angle around it in radians.
    The reference normalizes the axis only in debug builds
    (src/lib.rs:181-183), so ``normalize`` defaults to False: release-build
    output, which is what the solar-sail preset's non-unit axis was tuned on.
    """

    axis: tuple[float, float, float]
    rotation: float
    normalize: bool = False

    def __post_init__(self):
        if self.normalize and not math.sqrt(sum(v * v for v in self.axis)) > 0.0:
            raise ValueError(
                f"normalize=True requires a nonzero rotation axis, got {self.axis}"
            )

    def to_rotation_matrix(self) -> np.ndarray:
        """Rodrigues-form 3x3 row-major matrix, float64 (src/lib.rs:179-215)."""
        x, y, z = self.axis
        if self.normalize:
            n = math.sqrt(x * x + y * y + z * z)
            x, y, z = x / n, y / n, z / n
        c = math.cos(self.rotation)
        c1 = 1.0 - c
        s = math.sin(self.rotation)
        return np.array(
            [
                [c + x * x * c1, x * y * c1 - z * s, x * z * c1 + y * s],
                [y * x * c1 + z * s, c + y * y * c1, y * z * c1 - x * s],
                [z * x * c1 - y * s, z * y * c1 + x * s, c + z * z * c1],
            ],
            dtype=np.float64,
        )


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Per-frame scalar constants hoisted out of the hot loop (float64 host
    values; src/lib.rs:754-764)."""

    rotation_matrix: tuple  # 3x3 nested tuple, row-major
    cos_angle: float
    sin_angle: float
    center_camera: tuple[float, float, float]
    width: int
    height: int
    width_scaled: float  # width * scale            (src/lib.rs:763)
    scale_adjusted_mid: float  # 0.5 / scale        (src/lib.rs:764)


def camera_params(view, angle: float, width: int, height: int) -> CameraParams:
    """Build :class:`CameraParams` from a view + camera angle (radians)."""
    rot = view.rotation.to_rotation_matrix()
    return CameraParams(
        rotation_matrix=tuple(tuple(r) for r in rot.tolist()),
        cos_angle=math.cos(angle),
        sin_angle=math.sin(angle),
        center_camera=tuple(float(v) for v in view.center_camera),
        width=width,
        height=height,
        width_scaled=float(width) * view.scale,
        scale_adjusted_mid=0.5 / view.scale,
    )


def f32(v: float) -> float:
    """The float32 rounding of a host float64, as a Python float."""
    return float(np.float32(v))


def rounded(v: float, like) -> float:
    """The host float64 ``v`` in the compute dtype of the tensor ``like``:
    exact for float64, else rounded once to float32 (:func:`f32`). A
    Python float meets a tensor of either dtype exactly this way."""
    return float(v) if like.dtype.itemsize == 8 else f32(v)


def rotate_point(cam: CameraParams, p, jnp=None):
    """screen = R @ p of points ``p`` (..., 3), a torch tensor or a numpy
    array of float32 or float64 (reference: src/lib.rs:773, 208-215);
    returns (sx, sy, sz), each (...,), as :func:`rotate_xyz` computes them.
    ``jnp`` is accepted for the JAX package's signature
    (strange_attractor_tpu/ops/projection.py:102) and ignored: the
    operands' own type picks the arithmetic."""
    del jnp
    return rotate_xyz(cam, p[..., 0], p[..., 1], p[..., 2])


def rotate_xyz(cam: CameraParams, x, y, z):
    """screen = R @ p in component form, each row as
    ``(m0*x + m1*y) + m2*z`` -- the JAX package's term order
    (strange_attractor_tpu/ops/projection.py:112-121)."""
    m = [[rounded(v, x) for v in row] for row in cam.rotation_matrix]
    sx = m[0][0] * x + m[0][1] * y + m[0][2] * z
    sy = m[1][0] * x + m[1][1] * y + m[1][2] * z
    sz = m[2][0] * x + m[2][1] * y + m[2][2] * z
    return sx, sy, sz


def shared_operands(cam: CameraParams, sx, sy, sz):
    """The camera-angle-independent half of :func:`project`: the rotation
    operands and the vertical pixel coordinate (the angle turns about the
    vertical screen axis)::

        xc = sx + cc.x
        zc = sz + cc.y        (the reference's cc.y <-> z pairing quirk)
        fj = height/2 - (sy + cc.z) * width * scale

    A rotation sequence that bins one orbit at every frame emits these once
    per point (the JAX package's ``_step_fn_shared``, render.py:199-243).
    Returns (xc, zc, fj).
    """
    cc = [rounded(v, sx) for v in cam.center_camera]
    xc = sx + cc[0]
    zc = sz + cc[1]  # quirk: camera .y pairs with z
    fj = rounded(cam.height / 2.0, sx) - (sy + cc[2]) * rounded(cam.width_scaled, sx)
    return xc, zc, fj


def angle_half(cam: CameraParams, xc, zc, cos_v: float, sin_v: float):
    """The camera-angle-dependent half of :func:`project` (the JAX
    package's ``_project_emit``, render.py:246-266)::

        x2 = xc * cos + zc * sin
        z2 = xc * sin - zc * cos
        fi = (0.5/scale - x2) * width * scale

    ``cos_v``/``sin_v`` are host floats, in the compute dtype here.
    Returns (fi, z2).
    """
    cos_t, sin_t = rounded(cos_v, xc), rounded(sin_v, xc)
    x2 = xc * cos_t + zc * sin_t
    z2 = xc * sin_t - zc * cos_t
    fi = (rounded(cam.scale_adjusted_mid, xc) - x2) * rounded(cam.width_scaled, xc)
    return fi, z2


def project(cam: CameraParams, sx, sy, sz, cos_v: float, sin_v: float):
    """Camera-angle rotate + project to pixel coordinates, including the
    reference's cc.y <-> z pairing quirk (src/lib.rs:776-786)::

        x2 = (sx + cc.x) * cos + (sz + cc.y) * sin
        z2 = (sx + cc.x) * sin - (sz + cc.y) * cos
        i  = (0.5/scale - x2) * width * scale
        j  = height/2 - (sy + cc.z) * width * scale

    The composition of :func:`shared_operands` and :func:`angle_half`, so a
    frame finished from the shared operands rounds exactly as this does.
    ``cos_v``/``sin_v`` are host floats, in the compute dtype here.
    Returns (fi, fj, z2).
    """
    xc, zc, fj = shared_operands(cam, sx, sy, sz)
    fi, z2 = angle_half(cam, xc, zc, cos_v, sin_v)
    return fi, fj, z2
