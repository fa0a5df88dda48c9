"""Render configuration: palette, colors, view, and the main Config.

Numpy-only twin of ``strange_attractor_tpu.config`` (reference:
src/lib.rs:228-560). Defaults match the reference exactly
(src/lib.rs:288-308, 397-404, 483-487), and the schedule rules
(``resolved_lanes``, ``resolved_chunk_steps``) are the JAX package's, so a
render of the same config runs the same lanes x chunk_steps x nchunks.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional, Sequence

import numpy as np

from .ops.projection import EulerAxisRotation


class RenderKind(enum.Enum):
    """How to render the internal data (reference: src/lib.rs:234-239)."""

    GAS = "gas"
    DEPTH = "depth"


@dataclasses.dataclass(frozen=True)
class View:
    """Camera placement (reference: src/lib.rs:253-261)."""

    center_camera: tuple[float, float, float]
    rotation: EulerAxisRotation
    scale: float = 1.0

    def replace(self, **kw) -> "View":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class BrightnessConstants:
    """Tone-map constants: ``(c + offset) * factor`` (src/lib.rs:389-404)."""

    offset: float = -0.15
    factor: float = 5.0 / 3.0


class Palette:
    """A list of RGB stops interpolated over [0, 1) (src/lib.rs:406-473).

    Stored as a (K+1, 3) float64 table with the last stop duplicated, the
    reference's layout (src/lib.rs:416-424), so the ``n + 1`` read of the
    interpolation never needs a clamp.
    """

    def __init__(self, colors: Sequence[Sequence[float]]):
        colors = np.asarray(colors, dtype=np.float64)
        if colors.ndim != 2 or colors.shape[1] != 3 or colors.shape[0] == 0:
            raise ValueError("palette needs a non-empty (K, 3) list of RGB stops")
        self._stops = np.concatenate([colors, colors[-1:]], axis=0)  # (K+1, 3)

    @classmethod
    def from_rgb(cls, r: Sequence[float], g: Sequence[float], b: Sequence[float]) -> "Palette":
        """Construct from per-channel stop lists (src/lib.rs:425-431)."""
        if not (len(r) == len(g) == len(b)):
            raise ValueError("r, g, b must have equal length")
        return cls(np.stack([r, g, b], axis=1))

    @property
    def count(self) -> int:
        """Number of colors (src/lib.rs:435-437)."""
        return self._stops.shape[0] - 1

    @property
    def stops(self) -> np.ndarray:
        """(K+1, 3) float64 stop table, last stop duplicated."""
        return self._stops

    def __eq__(self, other):
        return isinstance(other, Palette) and np.array_equal(self._stops, other._stops)

    def __repr__(self):
        return f"Palette({self._stops[:-1].tolist()!r})"


def default_palette() -> Palette:
    """The reference's default 6-stop palette (src/lib.rs:483-487)."""
    return Palette.from_rgb(
        [1.0, 0.5, 1.0, 0.5, 0.5, 1.0],
        [1.0, 1.0, 0.5, 1.0, 0.5, 0.5],
        [0.5, 0.5, 0.5, 1.0, 1.0, 1.0],
    )


@dataclasses.dataclass(frozen=True)
class Colors:
    """Palette + brightness (reference: src/lib.rs:474-492)."""

    palette: Palette = dataclasses.field(default_factory=default_palette)
    brightness: BrightnessConstants = dataclasses.field(default_factory=BrightnessConstants)


class BinStrategy(enum.Enum):
    """How points are accumulated into the canvas.

    The values are the JAX package's, so configs and checkpoints name the
    same strategies in both. Three plane layouts (:meth:`planes_kind`):
    PACKED (count u32, packed u32), DEPTH (zbuf f32) and EXACT (count u32,
    steps f32, zbuf f32).

    The kernel strategies run the hand-written CUDA kernels on a CUDA device
    (``csrc/map_emit.cu`` and one bin kernel each); on a CPU tensor the
    wrappers run the plain twins:

    - KERNEL: PACKED planes, ``csrc/bin_packed.cu``;
    - DEPTH_KERNEL: the DEPTH plane, ``csrc/bin_depth.cu``;
    - EXACT_KERNEL: EXACT planes at full float32, strict z-test, earliest
      point on an equal (pixel, z) pair, ``csrc/bin_exact.cu``;
    - EXACT16_KERNEL: EXACT planes with z at 16-bit bucket granularity and
      the value through float16, bucket ties by ``Config.exact16_ties``,
      ``csrc/bin_exact16.cu``.

    The scatter strategies PACKED, DEPTH and EXACT run the plain torch twins
    of KERNEL, DEPTH_KERNEL and EXACT_KERNEL (:mod:`ops.binning`) on any
    device and give the same planes bit for bit. (The JAX package's scatter
    EXACT leaves an equal (pixel, z) pair inside one chunk undefined; the
    port's takes the earliest point, as EXACT_KERNEL does.)
    """

    EXACT = "exact"
    PACKED = "packed"
    DEPTH = "depth"
    KERNEL = "kernel"
    EXACT_KERNEL = "exact-kernel"
    EXACT16_KERNEL = "exact16-kernel"
    DEPTH_KERNEL = "depth-kernel"
    AUTO = "auto"

    def planes_kind(self) -> "BinStrategy":
        """The state-plane layout this strategy accumulates into."""
        if self == BinStrategy.KERNEL:
            return BinStrategy.PACKED
        if self in (BinStrategy.EXACT_KERNEL, BinStrategy.EXACT16_KERNEL):
            return BinStrategy.EXACT
        if self == BinStrategy.DEPTH_KERNEL:
            return BinStrategy.DEPTH
        return self


@dataclasses.dataclass(frozen=True)
class Config:
    """All render parameters (reference: src/lib.rs:263-308).

    Defaults match ``Config::new`` (src/lib.rs:288-308): 10^7 iterations,
    1920x1080, gas render, transparent, angle 0, silent. ``lanes``,
    ``chunk_steps``, ``warmup``, ``bin_strategy``, ``seed`` and
    ``reseed_lanes`` mean what they mean in ``strange_attractor_tpu.Config``.
    ``dtype`` is the compute type of the map, rotation, projection and color
    transform, ``"float32"`` or ``"float64"``; the emitted depth and value,
    and so the planes, are float32 in both.
    """

    attractor: Any
    view: View
    color_transform: Callable
    iterations: int = 10_000_000
    width: int = 1920
    height: int = 1080
    render: RenderKind = RenderKind.GAS
    transparent: bool = True
    angle: float = 0.0
    silent: bool = True
    colors: Colors = dataclasses.field(default_factory=Colors)

    lanes: Optional[int] = None
    chunk_steps: Optional[int] = None
    warmup: int = 1000
    bin_strategy: BinStrategy = BinStrategy.AUTO
    # EXACT16_KERNEL bucket ties: "value" (smallest float16 value of the top
    # z bucket) or "earliest" (first-emitted point of the top bucket)
    exact16_ties: str = "value"
    dtype: str = "float32"
    seed: Optional[int] = None
    reseed_lanes: bool = False

    def __post_init__(self):
        if self.width < 1 or self.height < 1:
            raise ValueError(f"image dimensions must be positive, got {self.width}x{self.height}")
        if self.iterations < 0:
            raise ValueError(f"iterations must be non-negative, got {self.iterations}")
        if self.warmup < 0:
            raise ValueError(f"warmup must be non-negative, got {self.warmup}")
        if self.exact16_ties not in ("value", "earliest"):
            raise ValueError(
                f"exact16_ties must be 'value' or 'earliest', got {self.exact16_ties!r}")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be 'float32' or 'float64', got {self.dtype!r}")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def resolved_lanes(self) -> int:
        """Lane count: the JAX package's rule (power of two nearest to
        iterations/4000, clamped to [512, 32768]; micro renders round down
        to a power of two <= iterations)."""
        if self.lanes is not None:
            return max(1, int(self.lanes))
        target = max(512, min(32_768, self.iterations // 4_000))
        if self.iterations < 512:
            return max(1, 1 << max(0, self.iterations.bit_length() - 1))
        pow2 = 1 << (target.bit_length() - 1)
        if target - pow2 > 2 * pow2 - target:  # round to nearest power of 2
            pow2 <<= 1
        return pow2

    def resolved_chunk_steps(self) -> int:
        """Map steps per binning flush: the JAX package's rule, a per-chunk
        point buffer of 2^20 points for the scatter strategies and 2^22 for
        the kernel ones, capped at 16384 steps."""
        if self.chunk_steps is not None:
            return max(1, int(self.chunk_steps))
        scatter = (BinStrategy.PACKED, BinStrategy.EXACT, BinStrategy.DEPTH)
        buf = 1 << 20 if self.resolved_bin_strategy() in scatter else 1 << 22
        return max(1, min(16_384, buf // self.resolved_lanes()))

    def resolved_bin_strategy(self) -> BinStrategy:
        """AUTO -> KERNEL for Gas renders, DEPTH_KERNEL for Depth.

        The JAX package resolves AUTO to the kernel strategies only on a
        TPU (EXACT elsewhere). The port resolves it so on every device: the
        kernel wrappers run the CUDA kernels on a CUDA device and their
        plain twins on the CPU."""
        if self.bin_strategy != BinStrategy.AUTO:
            return self.bin_strategy
        return BinStrategy.DEPTH_KERNEL if self.render == RenderKind.DEPTH else BinStrategy.KERNEL
