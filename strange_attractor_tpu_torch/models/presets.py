"""Built-in presets with the reference's exact constants: poisson-saturne
(src/lib.rs:310-353) and solar-sail (src/lib.rs:355-387).

The JAX package's other presets (the RK4 family and the discovered Sprott
maps) are not ported yet (ROADMAP).
"""

from __future__ import annotations

from ..config import Config, View
from ..ops.projection import EulerAxisRotation
from .attractors import PolynomialSprott2Degree
from .transforms import AdjustedVelocity, poisson_saturne_transform

PRESET_NAMES = ("poisson-saturne", "solar-sail")


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


_BY_NAME = {"poisson-saturne": poisson_saturne, "solar-sail": solar_sail}


def by_name(name: str, **overrides) -> Config:
    """Look up a preset by CLI name (reference: src/bin/main.rs:400-408)."""
    fn = _BY_NAME.get(name)
    if fn is None:
        raise KeyError(f"unknown preset {name!r}; choose from {PRESET_NAMES}")
    return fn(**overrides)
