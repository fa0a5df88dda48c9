"""Color transforms (PyTorch port of ``strange_attractor_tpu.models.transforms``):
map (delta, screen-space point, view) -> palette position
(reference: src/lib.rs:498-559).

Constants follow JAX's weak typing: each Python float, and each constant
expression the JAX package writes such as ``0.46 - 1.0941``, is folded in
float64 and then taken in the compute dtype -- rounded once to float32, or
exact in float64 (:func:`ops.projection.rounded`). The CUDA map+emit kernel
writes the same values as ``(T)(0.46 - 1.0941)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.projection import rounded

# cos/sin of 45.5 degrees = 91*pi/360 rad, the reference's constants
# (src/lib.rs:524-536)
_COS_45_5 = 0.7009092642998509
_SIN_45_5 = 0.7132504491541816


def sqrt_ieee(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root of a float32 or float64 tensor on any
    device.

    torch's CPU ``sqrt`` is not correctly rounded, in float32 or float64
    (it differs from IEEE in about 0.7% of random inputs of either), while
    XLA's, numpy's and CUDA's ``sqrtf`` and ``sqrt`` are. The float64 root
    of a float32 value rounds to the IEEE float32 root exactly, so the
    float32 form agrees with all three; a float64 root on the CPU is
    numpy's."""
    if x.dtype != torch.float64:
        return torch.sqrt(x.double()).float()
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def div_ieee(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` with ``b`` in ``a``'s dtype, correctly rounded on every
    device.

    torch's CUDA division by a host scalar multiplies by the scalar's
    reciprocal instead, which can round differently; a divisor tensor on
    ``a``'s device keeps the IEEE quotient that XLA and the CUDA kernel
    compute."""
    return a / torch.full((), rounded(b, a), dtype=a.dtype, device=a.device)


def _magnitude(dx, dy, dz):
    return sqrt_ieee(dx * dx + dy * dy + dz * dz)


def _numpy(transform, delta: np.ndarray, screen: np.ndarray, view) -> np.ndarray:
    """The JAX package's ``numpy`` of a transform on (..., 3) arrays: the
    numpy oracle's own transcription (:func:`oracle.color_value`)."""
    from ..oracle import color_value

    def parts(v):
        return v[..., 0], v[..., 1], v[..., 2]

    return color_value(transform, parts(delta), parts(screen), view)


@dataclasses.dataclass(frozen=True)
class AdjustedVelocity:
    """``(|delta| + offset) * factor`` (reference: src/lib.rs:506-516)."""

    offset: float
    factor: float

    def xyz(self, dx, dy, dz, sx, sy, sz, view):
        return (_magnitude(dx, dy, dz) + rounded(self.offset, dx)) * rounded(self.factor, dx)

    numpy = _numpy


@dataclasses.dataclass(frozen=True)
class PoissonSaturneTransform:
    """The poisson-saturne classifier transform (reference: src/lib.rs:520-558).

    Classifies the screen-space point into one of two attractor "parts" via
    four half-plane tests (src/lib.rs:542-551), keeping the reference's
    quirk of adding ``center_camera.y`` to the z coordinate, then blends
    the part index with |delta|: ``((part + |delta|) / 2 - 0.1) / 0.9``.
    """

    def xyz(self, dx, dy, dz, sx, sy, sz, view):
        def c(v):
            return rounded(v, sx)

        x2 = (sx + c(view.center_camera[0])) * c(_COS_45_5) + (
            sz + c(view.center_camera[1])
        ) * c(_SIN_45_5)
        outside = (
            (x2 < c(-0.0839))
            | (c(10.55) * x2 + sy < c(0.46 - 1.0941))
            | (c(1.0426) * x2 + sy < c(0.179 - 0.1576))
            | (c(0.5139) * x2 - sy > c(-0.04 - 0.04092))
        )
        part = torch.where(outside, 0.0, 1.0).to(sx.dtype)
        color = div_ieee(part + _magnitude(dx, dy, dz), 2.0)
        return div_ieee(color - c(0.1), 0.9)

    numpy = _numpy


#: Singleton matching the reference's free function ``color_transforms::poisson_saturne``.
poisson_saturne_transform = PoissonSaturneTransform()
