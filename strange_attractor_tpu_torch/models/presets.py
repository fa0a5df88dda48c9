"""Built-in presets, with the JAX package's nine names and constants
(strange_attractor_tpu/models/presets.py:17-286): the reference's
poisson-saturne (src/lib.rs:310-353) and solar-sail (src/lib.rs:355-387),
the RK4 family (lorenz, rossler, halvorsen, thomas) and three discovered
Sprott maps (aurora-veil, orchid-ribbon, delta-kite).
"""

from __future__ import annotations

import math

from ..config import Config, View
from ..ops.projection import EulerAxisRotation
from .attractors import Halvorsen, Lorenz, PolynomialSprott2Degree, Rossler, Thomas
from .transforms import AdjustedVelocity, poisson_saturne_transform

PRESET_NAMES = (
    "poisson-saturne",
    "solar-sail",
    "lorenz",
    "rossler",
    "halvorsen",
    "thomas",
    "aurora-veil",
    "orchid-ribbon",
    "delta-kite",
)


def _config(attractor, view, color_transform, overrides) -> Config:
    """Build a preset Config; ``overrides`` may replace any field."""
    kw = dict(attractor=attractor, view=view, color_transform=color_transform)
    kw.update(overrides)
    return Config(**kw)


def poisson_saturne(**overrides) -> Config:
    """The poisson-saturne preset (reference: src/lib.rs:310-353)."""
    attractor = PolynomialSprott2Degree(
        x=(0.021, 1.182, -1.183, 0.128, -1.12, -0.641, -1.152, -0.834, -0.97, 0.722),
        y=(0.243_038, -0.825, -1.2, -0.835_443, -0.835_443, -0.364_557, 0.458,
           0.622_785, -0.394_937, -1.032_911),
        z=(-0.455_696, 0.673, 0.915, -0.258_228, -0.495, -0.264, -0.432, -0.416,
           -0.877, -0.3),
    )
    view = View(
        # mid point between z[min,max] plus the author's empirical +0.12
        # (src/lib.rs:335-340)
        center_camera=(-0.005, 0.262, -0.366 + 0.12),
        rotation=EulerAxisRotation(
            axis=(0.304_289_493_528_802, 0.760_492_682_863_655, 0.573_636_455_813_981),
            rotation=1.782_681_918_874_46,
        ),
        scale=1.0,
    )
    return _config(attractor, view, poisson_saturne_transform, overrides)


def solar_sail(**overrides) -> Config:
    """The solar-sail preset (reference: src/lib.rs:355-387). Its rotation
    axis is deliberately not unit length: the reference's release build
    never normalizes it (src/lib.rs:181-183)."""
    attractor = PolynomialSprott2Degree(
        x=(0.744_304, -0.546_835, 0.121_519, -0.653_165, 0.399, 0.379, 0.44, 1.014,
           -0.805_063, 0.377),
        y=(-0.683, 0.531_646, -0.04557, -1.2, -0.546_835, 0.091_139, 0.744_304,
           -0.273_418, -0.349_367, -0.531_646),
        z=(0.712, 0.744_304, -0.577_215, 0.966, 0.04557, 1.063_291, 0.01519,
           -0.425_316, 0.212_658, -0.01519),
    )
    view = View(
        center_camera=(0.28, -0.12, 0.22),
        rotation=EulerAxisRotation(axis=(0.02466, 0.4618, -0.54789), rotation=2.2195),
        scale=1.7,
    )
    return _config(attractor, view, AdjustedVelocity(factor=-0.2, offset=0.8), overrides)


def lorenz(**overrides) -> Config:
    """The Lorenz butterfly (continuous-time, not in the reference): the
    view rotates about x by -90 degrees so that z maps to screen-up."""
    view = View(
        center_camera=(0.0, 0.0, -24.0),
        rotation=EulerAxisRotation(axis=(1.0, 0.0, 0.0), rotation=-math.pi / 2),
        scale=0.02,
    )
    return _config(Lorenz(), view, AdjustedVelocity(offset=-0.05, factor=3.0), overrides)


def rossler(**overrides) -> Config:
    """The Roessler funnel band (continuous-time, not in the reference),
    viewed top-down."""
    view = View(
        center_camera=(-1.0, -12.0, 2.5),  # (pairs: x->screen-x, y->depth, z->screen-y)
        rotation=EulerAxisRotation(axis=(1.0, 0.0, 0.0), rotation=0.0),
        scale=1.0 / 42.0,
    )
    return _config(Rossler(), view, AdjustedVelocity(offset=-0.05, factor=1.6), overrides)


def halvorsen(**overrides) -> Config:
    """Halvorsen's cyclic attractor (continuous-time, not in the
    reference), viewed slightly off its symmetry axis."""
    view = View(
        center_camera=(6.0, 2.5, 2.5),
        rotation=EulerAxisRotation(axis=(1.0, 1.0, 0.0), rotation=0.6, normalize=True),
        scale=1.0 / 44.0,
    )
    return _config(Halvorsen(), view, AdjustedVelocity(offset=-0.1, factor=0.25), overrides)


def thomas(**overrides) -> Config:
    """Thomas' cyclically symmetric knot (continuous-time, transcendental;
    not in the reference), at b=0.18, which the JAX package chose as
    robustly chaotic (strange_attractor_tpu/models/presets.py:179-200)."""
    view = View(
        center_camera=(0.0, 0.0, 0.0),
        rotation=EulerAxisRotation(axis=(1.0, 1.0, 0.0), rotation=0.6, normalize=True),
        scale=0.07159,
    )
    return _config(Thomas(b=0.18), view, AdjustedVelocity(offset=-0.005, factor=5.5), overrides)


# The discovered second-degree Sprott maps (found by the JAX package's
# tools/find_attractors.py). Their unit axis is written out
# (= normalize((0.35, 0.8, 0.49))), so that --rotation-axis, which never
# normalizes, can express the view.
_DISCOVERY_TILT = EulerAxisRotation(
    axis=(0.34954588533198816, 0.7989620236159731, 0.48936423946478347),
    rotation=1.1,
)


def aurora_veil(**overrides) -> Config:
    """Dense folded curtain (search hit seed=1/index=515)."""
    attractor = PolynomialSprott2Degree(
        x=(0.4, -0.8, 0.6, 0.7, 0.8, 0.6, -0.8, 1.0, -0.2, -1.2),
        y=(0.9, 0.3, 0.8, 0.0, 0.2, -0.5, -0.1, 0.6, -0.5, 0.1),
        z=(0.8, -0.7, -1.0, 0.2, -0.3, 0.5, -1.2, 1.1, -0.5, -0.3),
    )
    view = View(
        center_camera=(-0.14371, -0.23678, -0.72624),
        rotation=_DISCOVERY_TILT,
        scale=0.757,
    )
    return _config(attractor, view, AdjustedVelocity(offset=-0.05, factor=1.5), overrides)


def orchid_ribbon(**overrides) -> Config:
    """Looping ribbon bundle (search hit seed=1/index=1278)."""
    attractor = PolynomialSprott2Degree(
        x=(-0.2, -0.5, -0.9, -0.5, 0.3, 0.4, -1.2, 1.1, 0.1, 0.4),
        y=(0.4, 1.1, 1.2, 0.7, 1.0, -0.6, -0.1, 0.2, 0.4, -0.4),
        z=(0.4, 0.9, -0.3, -0.6, 0.1, -0.6, -0.4, -1.1, 0.7, 0.3),
    )
    view = View(
        center_camera=(0.32924, -0.04543, 0.15375),
        rotation=_DISCOVERY_TILT,
        scale=0.5046,
    )
    return _config(attractor, view, AdjustedVelocity(offset=-0.05, factor=1.5), overrides)


def delta_kite(**overrides) -> Config:
    """Swept triangular sheet (search hit seed=1/index=2999)."""
    attractor = PolynomialSprott2Degree(
        x=(0.0, -0.7, -1.0, -1.2, 0.5, -1.1, -0.1, 0.2, 0.0, 1.1),
        y=(-0.4, 0.7, 1.1, -1.1, 0.4, 0.4, 0.4, -0.1, -0.1, -0.2),
        z=(-0.1, -0.9, -0.9, -0.2, -1.0, -0.5, -0.9, 0.5, 0.1, 0.7),
    )
    view = View(
        center_camera=(0.11734, 0.21605, -0.06813),
        rotation=_DISCOVERY_TILT,
        scale=0.7519,
    )
    return _config(attractor, view, AdjustedVelocity(offset=-0.05, factor=1.5), overrides)


_BY_NAME = {
    "poisson-saturne": poisson_saturne,
    "solar-sail": solar_sail,
    "lorenz": lorenz,
    "rossler": rossler,
    "halvorsen": halvorsen,
    "thomas": thomas,
    "aurora-veil": aurora_veil,
    "orchid-ribbon": orchid_ribbon,
    "delta-kite": delta_kite,
}


def by_name(name: str, **overrides) -> Config:
    """Look up a preset by CLI name (reference: src/bin/main.rs:400-408)."""
    fn = _BY_NAME.get(name)
    if fn is None:
        raise KeyError(f"unknown preset {name!r}; choose from {PRESET_NAMES}")
    return fn(**overrides)
