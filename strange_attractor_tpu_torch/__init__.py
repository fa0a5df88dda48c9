"""Strange-attractor renderer: the PyTorch/CUDA port of ``strange_attractor_tpu``.

Renders run on one NVIDIA Hopper card through hand-written CUDA kernels
(``csrc/``): a fused map+emit chunk kernel and one bin kernel per kernel
strategy (KERNEL, DEPTH_KERNEL, EXACT_KERNEL, EXACT16_KERNEL). Every kernel
has a plain PyTorch twin beside it; the wrappers run the twin for CPU
tensors only. This package imports no JAX::

    import numpy as np
    from strange_attractor_tpu_torch import (RenderKind, colorize, presets, render,
                                             render_sequence_shared)

    config = presets.poisson_saturne(iterations=100_000_000, seed=1)
    state = render(config, device="cuda")   # accumulates; call again to refine
    image = colorize(config, state)         # (H, W, 4) uint16 RGBA on the card
    depth = presets.poisson_saturne(iterations=100_000_000, render=RenderKind.DEPTH)
    gray = colorize(depth, render(depth, device="cuda"))
    # a 120-frame rotation, one shared orbit per batch: (120, H, W, 3) uint8
    frames = render_sequence_shared(config.replace(iterations=10_000_000),
                                    np.arange(0, 360, 3), transparent=False, eight_bit=True)

``render_sequence_batched`` draws an orbit per frame instead, and
``render_sequence`` yields the frames of a start/end/step rotation one by
one.
"""

from .config import BinStrategy, BrightnessConstants, Colors, Config, Palette, RenderKind, View
from .models import presets
from .models.attractors import PolynomialSprott2Degree
from .models.transforms import AdjustedVelocity, poisson_saturne_transform
from .ops.projection import EulerAxisRotation
from .render import (colorize, plan_schedule, render, render_frame, render_seeds,
                     render_seeds_shared, render_sequence, render_sequence_batched,
                     render_sequence_shared)
from .runtime import RenderState, load_state, merge, merge_all, save_state

__version__ = "0.1.0"

__all__ = [
    "AdjustedVelocity",
    "BinStrategy",
    "BrightnessConstants",
    "Colors",
    "Config",
    "EulerAxisRotation",
    "Palette",
    "PolynomialSprott2Degree",
    "RenderKind",
    "RenderState",
    "View",
    "colorize",
    "load_state",
    "merge",
    "merge_all",
    "plan_schedule",
    "poisson_saturne_transform",
    "presets",
    "render",
    "render_frame",
    "render_seeds",
    "render_seeds_shared",
    "render_sequence",
    "render_sequence_batched",
    "render_sequence_shared",
    "save_state",
]
