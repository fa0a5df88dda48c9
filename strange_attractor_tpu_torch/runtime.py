"""Accumulator state (PyTorch port of ``strange_attractor_tpu.runtime``).

The reference keeps three textures plus a running max (src/lib.rs:631-646).
A :class:`RenderState` holds the same information as torch planes, with the
JAX package's layouts: EXACT (count, steps, zbuf), PACKED (count, packed),
DEPTH (zbuf). u32 planes are ``torch.int32`` tensors holding the u32 bits
(see :mod:`ops.binning`). Checkpoints use the JAX package's ``.npz`` keys and
uint32/float32 contents, so a checkpoint written by either package loads in
the other.

Every entry point that makes planes puts them on the card unless the caller
passes ``device="cpu"``; on a machine without CUDA the card default raises
(:func:`resolve_device`) instead of quietly running the plain twins.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import BinStrategy, Config
from .ops.binning import to_u32_bits, u32


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raise if it is a CUDA device and
    torch.cuda is not available: the port has no CPU fallback."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested, but torch.cuda is not available; "
                           "pass device='cpu' to run the plain twins")
    return device


class RenderState(NamedTuple):
    """Accumulated render data for one canvas; all planes (H, W)."""

    count: Optional[torch.Tensor] = None  # u32 bits in int32
    steps: Optional[torch.Tensor] = None  # float32 (EXACT)
    zbuf: Optional[torch.Tensor] = None  # float32, -1.0 sentinel (EXACT/DEPTH)
    packed: Optional[torch.Tensor] = None  # u32 bits in int32 (PACKED)

    @property
    def strategy(self) -> BinStrategy:
        if self.packed is not None:
            return BinStrategy.PACKED
        if self.count is None:
            return BinStrategy.DEPTH
        return BinStrategy.EXACT

    @property
    def shape(self) -> tuple:
        for plane in self:
            if plane is not None:
                return tuple(plane.shape)
        raise ValueError("empty RenderState")

    @property
    def device(self) -> torch.device:
        for plane in self:
            if plane is not None:
                return plane.device
        raise ValueError("empty RenderState")

    @classmethod
    def blank(cls, shape: tuple, strategy: BinStrategy, device="cuda") -> "RenderState":
        """Zeroed planes of a given (H, W) shape and strategy (count 0,
        steps 0.0, zbuf -1.0: the reference's reset, src/lib.rs:682-699)."""
        device = resolve_device(device)
        kind = strategy.planes_kind()
        if kind == BinStrategy.DEPTH:
            return cls(zbuf=torch.full(shape, -1.0, dtype=torch.float32, device=device))
        count = torch.zeros(shape, dtype=torch.int32, device=device)
        if kind == BinStrategy.PACKED:
            return cls(count=count, packed=torch.zeros_like(count))
        return cls(
            count=count,
            steps=torch.zeros(shape, dtype=torch.float32, device=device),
            zbuf=torch.full(shape, -1.0, dtype=torch.float32, device=device),
        )

    @classmethod
    def create(cls, config: Config, strategy: Optional[BinStrategy] = None,
               device="cuda") -> "RenderState":
        """Fresh zeroed state for ``config`` (AUTO resolves as in render)."""
        if strategy is None or strategy == BinStrategy.AUTO:
            strategy = config.resolved_bin_strategy()
        return cls.blank((config.height, config.width), strategy, device)

    def set_width_height(self, width: int, height: int) -> "RenderState":
        """Fit this state to a canvas of ``width`` x ``height`` (reference
        ``Runtime::set_width_height``, src/lib.rs:666-675): the same object
        when the size already matches (accumulation continues), otherwise a
        blank state of the new size with the same strategy, on this state's
        device -- a resize discards the accumulation, as in the reference."""
        if self.shape == (height, width):
            return self
        return RenderState.blank((height, width), self.strategy, self.device)

    def reset(self) -> "RenderState":
        """Zeroed state with the same shape, strategy and device."""
        return RenderState.blank(self.shape, self.strategy, self.device)


def merge(a: RenderState, b: RenderState) -> RenderState:
    """Combine two renders of the same scene (reference ``Runtime::merge``,
    src/lib.rs:708-738): counts add (mod 2^32); where ``b`` is nearer its
    value wins (PACKED: u32 max; EXACT: strictly greater z)."""
    if a.strategy != b.strategy:
        raise ValueError("cannot merge states with different bin strategies")
    if a.shape != b.shape:
        raise ValueError(f"state shapes differ: {a.shape} vs {b.shape}")
    if a.strategy == BinStrategy.DEPTH:
        return RenderState(zbuf=torch.maximum(a.zbuf, b.zbuf))
    count = to_u32_bits(u32(a.count) + u32(b.count))
    if a.packed is not None:
        return RenderState(count=count,
                           packed=to_u32_bits(torch.maximum(u32(a.packed), u32(b.packed))))
    take_b = b.zbuf > a.zbuf
    return RenderState(count=count, steps=torch.where(take_b, b.steps, a.steps),
                       zbuf=torch.where(take_b, b.zbuf, a.zbuf))


def merge_all(states) -> RenderState:
    """Fold :func:`merge` over a sequence of states (reference
    src/lib.rs:1068-1076; the JAX package's ``merge_all``)."""
    states = list(states)
    if not states:
        raise ValueError("no states to merge")
    acc = states[0]
    for s in states[1:]:
        acc = merge(acc, s)
    return acc


_U32_PLANES = ("count", "packed")


def state_to_numpy(state: RenderState) -> dict:
    """Planes as host numpy arrays in the ``.npz`` layout: uint32 count and
    packed, float32 steps and zbuf; absent planes are left out."""
    out = {}
    for name, plane in state._asdict().items():
        if plane is not None:
            arr = plane.detach().cpu().numpy()
            out[name] = arr.view(np.uint32) if name in _U32_PLANES else arr
    return out


def state_from_numpy(arrays, device="cuda") -> RenderState:
    """Inverse of :func:`state_to_numpy` (accepts any mapping of planes,
    such as an open ``np.load`` file or a JAX state's ``device_get``)."""
    device = resolve_device(device)
    kw = {}
    for name in arrays:
        arr = np.ascontiguousarray(arrays[name])
        if name in _U32_PLANES:
            if arr.dtype != np.uint32:
                raise TypeError(f"plane {name!r} must be uint32, got {arr.dtype}")
            kw[name] = torch.from_numpy(arr.view(np.int32).copy()).to(device)
        else:
            kw[name] = torch.from_numpy(arr.astype(np.float32)).to(device)
    return RenderState(**kw)


def save_state(path: str, state: RenderState) -> None:
    """Checkpoint a render state to ``.npz`` (progressive-resume support)."""
    np.savez_compressed(path, **state_to_numpy(state))


def load_state(path: str, device="cuda") -> RenderState:
    """Load a checkpoint written by either package onto ``device``."""
    with np.load(path) as data:
        return state_from_numpy({k: data[k] for k in data.files}, device)
