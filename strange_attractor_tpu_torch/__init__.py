"""Strange-attractor renderer: the PyTorch/CUDA port of ``strange_attractor_tpu``.

Renders run on NVIDIA Hopper cards through hand-written CUDA kernels
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

Several cards: ``render_parallel`` splits a frame's lanes over every
visible card and merges the canvases; the ``parallel`` package holds the
pieces: ``parallel.mesh`` (``render_sharded``, ``merge_collective``,
``render_sequence_sharded`` over a frames x lanes grid of devices) and
``parallel.distributed`` (``initialize``, ``render_distributed`` over
``torch.distributed`` processes)::

    frame = render_parallel(config)   # (H, W, 4) uint16, lanes over every card

``precompile(config)`` loads (or builds) the kernels and warms a render's
before a timed one; ``colorize_convert_fetch`` delivers a state as the CLI
writes it. ``oracle`` transcribes the reference's hot loop in numpy: ``python
-m strange_attractor_tpu_torch doctor`` holds the kernels to it.
"""

from .config import BinStrategy, BrightnessConstants, Colors, Config, Palette, RenderKind, View
from .models import presets
from .models.attractors import Attractor, PolynomialSprott2Degree
from .models.transforms import AdjustedVelocity, poisson_saturne_transform
from .ops.projection import EulerAxisRotation
from .render import (colorize, colorize_convert_fetch, plan_schedule, precompile, render,
                     render_frame, render_parallel, render_seeds, render_seeds_shared,
                     render_sequence, render_sequence_batched, render_sequence_shared)
from .runtime import RenderState, load_state, merge, merge_all, save_state

__version__ = "0.1.0"

__all__ = [
    "AdjustedVelocity",
    "Attractor",
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
    "colorize_convert_fetch",
    "load_state",
    "merge",
    "merge_all",
    "plan_schedule",
    "poisson_saturne_transform",
    "precompile",
    "presets",
    "render",
    "render_frame",
    "render_parallel",
    "render_seeds",
    "render_seeds_shared",
    "render_sequence",
    "render_sequence_batched",
    "render_sequence_shared",
    "save_state",
]
