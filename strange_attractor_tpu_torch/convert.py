"""Carry configurations and states between the JAX package and this one.

:func:`config_from_reference` reads a ``strange_attractor_tpu.Config`` by
duck typing -- attribute names only, so this module imports no JAX. States
cross as host numpy planes in the shared ``.npz`` layout
(:func:`state_to_numpy` / :func:`state_from_numpy`).
"""

from __future__ import annotations

import dataclasses

from .config import BinStrategy, BrightnessConstants, Colors, Config, Palette, RenderKind, View
from .models.attractors import Halvorsen, Lorenz, PolynomialSprott2Degree, Rossler, Thomas
from .models.transforms import AdjustedVelocity, poisson_saturne_transform
from .ops.projection import EulerAxisRotation
from .runtime import state_from_numpy, state_to_numpy

__all__ = ["config_from_reference", "state_from_numpy", "state_to_numpy"]


def _transform(ref):
    name = type(ref).__name__
    if name == "PoissonSaturneTransform":
        return poisson_saturne_transform
    if name == "AdjustedVelocity":
        return AdjustedVelocity(offset=float(ref.offset), factor=float(ref.factor))
    raise NotImplementedError(f"color transform {name} is not ported yet")


# the JAX package's attractor classes by name -> the port's, built from the
# same dataclass fields
_ATTRACTORS = {cls.__name__: cls for cls in (PolynomialSprott2Degree, Lorenz, Rossler,
                                             Halvorsen, Thomas)}


def _attractor(ref):
    cls = _ATTRACTORS.get(type(ref).__name__)
    if cls is None:
        raise NotImplementedError(f"attractor {type(ref).__name__} is not ported")
    return cls(**{f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)})


def config_from_reference(ref) -> Config:
    """The port's Config for a JAX-package Config ``ref``: coefficients,
    view, color transform, palette stops, brightness, sizes, schedule knobs,
    bin strategy, ``exact16_ties``, ``dtype`` and ``reseed_lanes``.
    ``kernel_section`` and ``kernel_window`` are not carried: they size the
    TPU's sort sections and apply windows, which the Hopper kernels do not
    have. The attractor
    (the Sprott map or an RK4 class) is carried by class name and fields.
    Raises NotImplementedError for what the port does not run (other
    attractors and transforms)."""
    attractor = _attractor(ref.attractor)
    rot = ref.view.rotation
    view = View(
        center_camera=tuple(float(v) for v in ref.view.center_camera),
        rotation=EulerAxisRotation(axis=tuple(float(v) for v in rot.axis),
                                   rotation=float(rot.rotation), normalize=bool(rot.normalize)),
        scale=float(ref.view.scale),
    )
    bk = ref.colors.brightness
    return Config(
        attractor=attractor,
        view=view,
        color_transform=_transform(ref.color_transform),
        iterations=int(ref.iterations),
        width=int(ref.width),
        height=int(ref.height),
        render=RenderKind(ref.render.value),
        transparent=bool(ref.transparent),
        angle=float(ref.angle),
        silent=bool(ref.silent),
        colors=Colors(palette=Palette(ref.colors.palette.stops[:-1]),
                      brightness=BrightnessConstants(offset=float(bk.offset),
                                                     factor=float(bk.factor))),
        lanes=ref.lanes,
        chunk_steps=ref.chunk_steps,
        warmup=int(ref.warmup),
        bin_strategy=BinStrategy(ref.bin_strategy.value),
        exact16_ties=str(ref.exact16_ties),
        dtype=str(getattr(ref, "dtype", "float32")),
        seed=ref.seed,
        reseed_lanes=bool(ref.reseed_lanes),
    )
