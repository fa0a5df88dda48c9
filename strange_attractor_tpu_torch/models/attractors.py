"""Attractor maps (PyTorch port of ``strange_attractor_tpu.models.attractors``).

Only the reference's own map, the second-degree polynomial Sprott attractor
(src/lib.rs:575-621), is ported; the RK4 family waits (ROADMAP).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.projection import f32


@dataclasses.dataclass(frozen=True)
class PolynomialSprott2Degree:
    """Second-degree polynomial Sprott map (reference: src/lib.rs:575-621).

    The next point is three dot products of the monomial vector
    ``[1, x, x^2, xy, xz, y, y^2, yz, z, z^2]`` (src/lib.rs:602-613) with the
    coefficient rows ``x``, ``y``, ``z``, summed left to right in the
    reference's term order (src/lib.rs:588-600) as separate float32
    multiplies and adds. The CUDA map+emit kernel evaluates the same chain
    without FMA contraction, so both round identically.
    """

    x: tuple[float, ...]
    y: tuple[float, ...]
    z: tuple[float, ...]

    def __post_init__(self):
        for name in ("x", "y", "z"):
            v = getattr(self, name)
            if len(v) != 10:
                raise ValueError(f"coefficient row {name!r} must have 10 entries, got {len(v)}")
            object.__setattr__(self, name, tuple(float(c) for c in v))

    def coefficients_f32(self) -> np.ndarray:
        """(3, 10) float32 coefficient rows, each rounded once from f64."""
        return np.asarray([self.x, self.y, self.z], np.float64).astype(np.float32)

    def step_xyz(self, x, y, z):
        """One map step on float32 tensors, component form."""
        monoms = (None, x, x * x, x * y, x * z, y, y * y, y * z, z, z * z)

        def dot(coeffs):
            # c0 * 1 is exactly c0: the JAX package's ones_like product
            acc = f32(coeffs[0]) + f32(coeffs[1]) * monoms[1]
            for c, m in zip(coeffs[2:], monoms[2:]):
                acc = acc + f32(c) * m
            return acc

        return dot(self.x), dot(self.y), dot(self.z)
