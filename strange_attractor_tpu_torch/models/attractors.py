"""Attractor maps (PyTorch port of ``strange_attractor_tpu.models.attractors``).

The reference's own map, the second-degree polynomial Sprott attractor
(src/lib.rs:575-621), and the JAX package's fixed-step RK4 family:
:class:`Lorenz`, :class:`Rossler`, :class:`Halvorsen` and :class:`Thomas`.
Each ``step_xyz`` is the plain twin of the map that the map+emit kernel
(``csrc/map_emit.cuh``) runs, in the dtype of its input (float32 or
float64): the same operations in the same order, each rounded once, so that
the kernel (built without FMA contraction) matches it bit for bit. Each
constant is the Python float taken once in the compute dtype
(:func:`ops.projection.rounded`), never through float32 for float64.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from ..ops.projection import f32, rounded


@runtime_checkable
class Attractor(Protocol):
    """A chaotic map (reference trait: src/lib.rs:71-77; the JAX package's
    ``Attractor``, strange_attractor_tpu/models/attractors.py:20-31). The
    render engines and the map+emit kernel run the classes of this module;
    the protocol names what their plain twins call."""

    def step_xyz(self, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> tuple:
        """Advance the points ``(x, y, z)`` (float32 or float64 tensors of
        one shape) one map iteration; returns the next ``(x, y, z)``."""
        ...


class _PointSteps:
    """The JAX package's ``step`` and ``step_numpy`` of a map, on (..., 3)
    points, from the class's ``step_xyz`` and the numpy oracle."""

    def step(self, p: torch.Tensor) -> torch.Tensor:
        """Advance the points ``p`` (..., 3), a float32 or float64 tensor,
        one map iteration (:meth:`step_xyz`)."""
        return torch.stack(self.step_xyz(p[..., 0], p[..., 1], p[..., 2]), dim=-1)

    def step_numpy(self, p: np.ndarray) -> np.ndarray:
        """Numpy twin of :meth:`step` for the CPU oracle: the oracle's own
        transcription of the map (:func:`oracle.step`)."""
        from ..oracle import step

        return np.stack(step(self, p[..., 0], p[..., 1], p[..., 2]), axis=-1)


@dataclasses.dataclass(frozen=True)
class PolynomialSprott2Degree(_PointSteps):
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

    def step_xyz(self, x, y, z):
        """One map step on float32 or float64 tensors, component form."""
        monoms = (None, x, x * x, x * y, x * z, y, y * y, y * z, z, z * z)

        def dot(coeffs):
            # c0 * 1 is exactly c0: the JAX package's ones_like product
            acc = rounded(coeffs[0], x) + rounded(coeffs[1], x) * monoms[1]
            for c, m in zip(coeffs[2:], monoms[2:]):
                acc = acc + rounded(c, x) * m
            return acc

        return dot(self.x), dot(self.y), dot(self.z)


class _RK4Ode(_PointSteps):
    """One fixed-step RK4 step of size ``dt`` over the component-form
    derivative ``_deriv_xyz`` (the JAX package's ``_RK4Ode._rk4_xyz``,
    strange_attractor_tpu/models/attractors.py:113-125), in its order of
    operations: ``h`` is ``dt`` rounded to float32, a stage point is
    ``x + (0.5*h)*k``, the last stage's ``x + h*k``, and the step
    ``v + (h/6)*(((a + 2b) + 2c) + d)`` with ``0.5*h`` and ``h/6`` taken in
    float32. Each derivative constant is rounded once to float32, as JAX
    rounds a weakly typed Python scalar (``8/3`` included). In float64
    (``wide``) each is the Python float itself, and ``h``, ``0.5*h`` and
    ``h/6`` are taken in float64, as the JAX package takes them under
    ``jax_enable_x64``."""

    def rk4_constants(self, wide: bool = False) -> tuple[float, float, float]:
        """(h, 0.5*h, h/6) in float32, or with ``wide`` in float64, as
        Python floats."""
        if wide:
            h = float(self.dt)
            return h, 0.5 * h, h / 6.0
        h = np.float32(self.dt)
        return float(h), float(np.float32(0.5) * h), float(h / np.float32(6.0))

    def constants(self, wide: bool = False) -> tuple[float, ...]:
        """The derivative's constants in the order the kernel reads them
        (``EmitParams.mc``): each rounded once to float32, or with ``wide``
        the float64 values."""
        return tuple(float(getattr(self, name)) if wide else f32(getattr(self, name))
                     for name in self._CONSTANTS)

    def step_xyz(self, x, y, z):
        """One RK4 step on float32 or float64 tensors, component form."""
        wide = x.dtype == torch.float64
        h, hh, h6 = self.rk4_constants(wide)
        k1 = self._deriv_xyz(x, y, z, wide)
        k2 = self._deriv_xyz(x + hh * k1[0], y + hh * k1[1], z + hh * k1[2], wide)
        k3 = self._deriv_xyz(x + hh * k2[0], y + hh * k2[1], z + hh * k2[2], wide)
        k4 = self._deriv_xyz(x + h * k3[0], y + h * k3[1], z + h * k3[2], wide)
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

    def _deriv_xyz(self, x, y, z, wide):
        sigma, rho, beta = self.constants(wide)
        return sigma * (y - x), x * (rho - z) - y, x * y - beta * z


@dataclasses.dataclass(frozen=True)
class Rossler(_RK4Ode):
    """Roessler system: dx = -y - z, dy = x + a y, dz = b + z(x - c)."""

    a: float = 0.2
    b: float = 0.2
    c: float = 5.7
    dt: float = 0.02
    _CONSTANTS = ("a", "b", "c")

    def _deriv_xyz(self, x, y, z, wide):
        a, b, c = self.constants(wide)
        return -y - z, x + a * y, b + z * (x - c)


@dataclasses.dataclass(frozen=True)
class Halvorsen(_RK4Ode):
    """Halvorsen's cyclic attractor: dx = -a x - 4y - 4z - y^2 (and cyclic
    permutations)."""

    a: float = 1.4
    dt: float = 0.005
    _CONSTANTS = ("a",)

    def _deriv_xyz(self, x, y, z, wide):
        (a,) = self.constants(wide)
        na = -a
        return (na * x - 4.0 * y - 4.0 * z - y * y,
                na * y - 4.0 * z - 4.0 * x - z * z,
                na * z - 4.0 * x - 4.0 * y - x * x)


@dataclasses.dataclass(frozen=True)
class Thomas(_RK4Ode):
    """Thomas' cyclically symmetric attractor: dx = sin(y) - b x (and cyclic
    permutations), with the port's own sines :func:`sin_f32` and
    :func:`sin_f64`, which the kernel computes identically (the JAX
    package's ``jnp.sin`` and ``np.sin`` are other implementations)."""

    b: float = 0.208186
    dt: float = 0.1
    _CONSTANTS = ("b",)

    def _deriv_xyz(self, x, y, z, wide):
        (b,) = self.constants(wide)
        sin = sin_f64 if wide else sin_f32
        return sin(y) - b * x, sin(z) - b * y, sin(x) - b * z


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


# the float64 sine: the same scheme with pi/2 in three parts of 33, 33 and
# 53 significant bits (fdlibm's pio2_1, pio2_2, pio2_2t: k * C1 and k * C2
# are exact for |k| < 2^20), then Cephes' double sin/cos polynomials on
# [-pi/4, pi/4] (sin.c: y = r + r z P(z), y = 1 - z/2 + z^2 Q(z)).
# csrc/map_emit.cuh sin_f64 is the same sequence of double operations.
SIN64_TWO_OVER_PI = 2.0 / math.pi
SIN64_PIO2 = (1.57079632673412561417e+00, 6.07710050630396597660e-11,
              2.02226624879595063154e-21)
SIN64_S = (1.58962301576546568060e-10, -2.50507477628578072866e-8, 2.75573136213857245213e-6,
           -1.98412698295895385996e-4, 8.33333333332211858878e-3, -1.66666666666666307295e-1)
SIN64_C = (-1.13585365213876817300e-11, 2.08757008419747316778e-9, -2.75573141792967388112e-7,
           2.48015872888517045348e-5, -1.38888888888730564116e-3, 4.16666666666665929218e-2)


def _horner(coefs, z):
    acc = coefs[0] * z + coefs[1]
    for c in coefs[2:]:
        acc = acc * z + c
    return acc


def sin_f64(x: torch.Tensor) -> torch.Tensor:
    """sin of a float64 tensor from single-rounded ``*``, ``+``, ``-`` and
    ``floor``: k = floor(x * 2/pi + 0.5), r = ((x - k C1) - k C2) - k C3,
    then sin(r) = r + r z P(z) or cos(r) = (1 - z/2) + z^2 Q(z) (z = r^2,
    Horner from the highest coefficient) with the sign and choice of k mod
    4. Within 2 ulp of ``np.sin`` for |x| <= 8
    (tests/test_torch_f64.py); inf and NaN give NaN."""
    k = torch.floor(x * SIN64_TWO_OVER_PI + 0.5)
    r = ((x - k * SIN64_PIO2[0]) - k * SIN64_PIO2[1]) - k * SIN64_PIO2[2]
    q = k - 4.0 * torch.floor(k * 0.25)
    z = r * r
    s = r + (r * z) * _horner(SIN64_S, z)
    c = (1.0 - 0.5 * z) + (z * z) * _horner(SIN64_C, z)
    odd = (q == 1.0) | (q == 3.0)
    v = torch.where(odd, c, s)
    return torch.where(q >= 2.0, -v, v)
