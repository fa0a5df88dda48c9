"""Attractor maps (PyTorch port of ``strange_attractor_tpu.models.attractors``).

The reference's own map, the second-degree polynomial Sprott attractor
(src/lib.rs:575-621), and the JAX package's fixed-step RK4 family:
:class:`Lorenz`, :class:`Rossler`, :class:`Halvorsen` and :class:`Thomas`.
Each ``step_xyz`` is the plain float32 twin of the map that the map+emit
kernel (``csrc/map_emit.cuh``) runs: the same operations in the same order,
each rounded once, so that the kernel (built without FMA contraction)
matches it bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

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


class _RK4Ode:
    """One fixed-step RK4 step of size ``dt`` over the component-form
    derivative ``_deriv_xyz`` (the JAX package's ``_RK4Ode._rk4_xyz``,
    strange_attractor_tpu/models/attractors.py:113-125), in its order of
    operations: ``h`` is ``dt`` rounded to float32, a stage point is
    ``x + (0.5*h)*k``, the last stage's ``x + h*k``, and the step
    ``v + (h/6)*(((a + 2b) + 2c) + d)`` with ``0.5*h`` and ``h/6`` taken in
    float32. Each derivative constant is rounded once to float32, as JAX
    rounds a weakly typed Python scalar (``8/3`` included)."""

    def rk4_constants(self) -> tuple[float, float, float]:
        """(h, 0.5*h, h/6) in float32, as Python floats."""
        h = np.float32(self.dt)
        return float(h), float(np.float32(0.5) * h), float(h / np.float32(6.0))

    def constants_f32(self) -> tuple[float, ...]:
        """The derivative's constants, each rounded once to float32, in the
        order the kernel reads them (``EmitParams.mc``)."""
        return tuple(f32(getattr(self, name)) for name in self._CONSTANTS)

    def step_xyz(self, x, y, z):
        """One RK4 step on float32 tensors, component form."""
        h, hh, h6 = self.rk4_constants()
        k1 = self._deriv_xyz(x, y, z)
        k2 = self._deriv_xyz(x + hh * k1[0], y + hh * k1[1], z + hh * k1[2])
        k3 = self._deriv_xyz(x + hh * k2[0], y + hh * k2[1], z + hh * k2[2])
        k4 = self._deriv_xyz(x + h * k3[0], y + h * k3[1], z + h * k3[2])
        return tuple(v + h6 * (((a + 2.0 * b) + 2.0 * c) + d)
                     for v, a, b, c, d in zip((x, y, z), k1, k2, k3, k4))


@dataclasses.dataclass(frozen=True)
class Lorenz(_RK4Ode):
    """Lorenz system: dx = sigma(y - x), dy = x(rho - z) - y,
    dz = xy - beta z (not in the reference)."""

    sigma: float = 10.0
    rho: float = 28.0
    beta: float = 8.0 / 3.0
    dt: float = 0.005
    _CONSTANTS = ("sigma", "rho", "beta")

    def _deriv_xyz(self, x, y, z):
        sigma, rho, beta = self.constants_f32()
        return sigma * (y - x), x * (rho - z) - y, x * y - beta * z


@dataclasses.dataclass(frozen=True)
class Rossler(_RK4Ode):
    """Roessler system: dx = -y - z, dy = x + a y, dz = b + z(x - c)."""

    a: float = 0.2
    b: float = 0.2
    c: float = 5.7
    dt: float = 0.02
    _CONSTANTS = ("a", "b", "c")

    def _deriv_xyz(self, x, y, z):
        a, b, c = self.constants_f32()
        return -y - z, x + a * y, b + z * (x - c)


@dataclasses.dataclass(frozen=True)
class Halvorsen(_RK4Ode):
    """Halvorsen's cyclic attractor: dx = -a x - 4y - 4z - y^2 (and cyclic
    permutations)."""

    a: float = 1.4
    dt: float = 0.005
    _CONSTANTS = ("a",)

    def _deriv_xyz(self, x, y, z):
        (a,) = self.constants_f32()
        na = -a
        return (na * x - 4.0 * y - 4.0 * z - y * y,
                na * y - 4.0 * z - 4.0 * x - z * z,
                na * z - 4.0 * x - 4.0 * y - x * x)


@dataclasses.dataclass(frozen=True)
class Thomas(_RK4Ode):
    """Thomas' cyclically symmetric attractor: dx = sin(y) - b x (and cyclic
    permutations), with the port's own float32 sine :func:`sin_f32`, which
    the kernel computes identically (the JAX package's ``jnp.sin`` and
    ``np.sin`` are other implementations)."""

    b: float = 0.208186
    dt: float = 0.1
    _CONSTANTS = ("b",)

    def _deriv_xyz(self, x, y, z):
        (b,) = self.constants_f32()
        return sin_f32(y) - b * x, sin_f32(z) - b * y, sin_f32(x) - b * z


# the float32 sine: a Cody-Waite reduction by pi/2 with pi/2 split into
# three parts (the first two with 8 and 11 significant bits, so that k * C1
# and k * C2 are exact for |k| < 2^13), then the Cephes sinf/cosf minimax
# polynomials on [-pi/4, pi/4]. csrc/map_emit.cuh sin_f32 is the same
# sequence of single-rounded operations.
SIN_TWO_OVER_PI = f32(2.0 / math.pi)
SIN_PIO2 = (1.5703125, 4.837512969970703125e-4, f32(math.pi / 2 - 1.5703125
                                                    - 4.837512969970703125e-4))
SIN_S = (f32(-1.6666654611e-1), f32(8.3321608736e-3), f32(-1.9515295891e-4))
SIN_C = (f32(4.166664568298827e-2), f32(-1.388731625493765e-3), f32(2.443315711809948e-5))


def sin_f32(x: torch.Tensor) -> torch.Tensor:
    """sin of a float32 tensor from single-rounded ``*``, ``+``, ``-`` and
    ``floor``: k = floor(x * 2/pi + 0.5), r = ((x - k C1) - k C2) - k C3,
    then sin(r), cos(r), -sin(r) or -cos(r) by k mod 4. Within 2 ulp of
    the sine for |x| <= 8 and 1e-7 absolute for |x| <= 1e4
    (tests/test_torch_attractors.py); inf and NaN give NaN. Beyond 1e4 the
    reduction loses accuracy (far beyond, it overflows), the same way in the
    kernel."""
    k = torch.floor(x * SIN_TWO_OVER_PI + 0.5)
    r = ((x - k * SIN_PIO2[0]) - k * SIN_PIO2[1]) - k * SIN_PIO2[2]
    q = k - 4.0 * torch.floor(k * 0.25)  # k mod 4, exact; NaN for infinite k
    z = r * r
    s = ((SIN_S[2] * z + SIN_S[1]) * z + SIN_S[0]) * z * r + r
    c = (((SIN_C[2] * z + SIN_C[1]) * z + SIN_C[0]) * z * z - 0.5 * z) + 1.0
    odd = (q == 1.0) | (q == 3.0)
    v = torch.where(odd, c, s)
    return torch.where(q >= 2.0, -v, v)
