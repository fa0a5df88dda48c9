"""Multi-process rendering over ``torch.distributed`` (PyTorch port of
``strange_attractor_tpu.parallel.distributed``).

Every process runs the same program on one device of its own (or on a
card it shares with other ranks, see ``backend``): rank ``r`` of ``n``
renders lane shard ``r`` of ``n`` with the seeds of
:func:`mesh.shard_generator`, and :func:`mesh.merge_collective` reduces the
canvases with ``all_reduce``, so every rank ends with the merged canvas
(write files on :func:`is_primary` only). A two-rank render equals
:func:`mesh.render_sharded` over two shards in one process bit for bit.

Usage (the same script launched once per process)::

    from strange_attractor_tpu_torch.parallel import distributed as dist

    dist.initialize("10.0.0.1:29500", num_processes=2, process_id=rank)
    state = dist.render_distributed(config)
    if dist.is_primary():
        image = colorize(config, state)

Without a coordinator address, :func:`initialize` reads torchrun's
variables (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..runtime import RenderState, resolve_device

# the rank's device, once initialize() has run
_RANK: dict = {}


def _rank_device(device, local_device_ids, process_id) -> torch.device:
    """The device this rank renders on: ``device``, else the card of
    ``local_device_ids[0]``, else card ``LOCAL_RANK`` (or the process id)
    modulo the visible cards. Raises without CUDA unless ``device`` names
    the CPU."""
    if device is not None:
        return resolve_device(device)
    resolve_device("cuda")
    if local_device_ids:
        return torch.device("cuda", int(local_device_ids[0]))
    local = os.environ.get("LOCAL_RANK", os.environ.get("RANK", process_id or 0))
    return torch.device("cuda", int(local) % torch.cuda.device_count())


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None, *,
               backend: Optional[str] = None, device=None) -> None:
    """Bring up the default process group (idempotent: later calls return
    at once).

    ``coordinator_address`` ``HOST:PORT`` (rank 0 listens there) with
    ``num_processes`` and ``process_id``; without it, torchrun's ``env://``
    variables. The rank's device is ``device``, else the card of
    ``local_device_ids[0]``, else the card of the local rank; a card
    becomes the current device before the group comes up. ``backend``
    follows the device unless given: NCCL for a card, gloo for the CPU.
    NCCL needs a card of its own for every rank; ranks that share a card
    pass ``backend="gloo"``, which reduces CUDA tensors too. A failing
    backend raises: nothing switches to another."""
    if dist.is_initialized():
        if "device" not in _RANK:  # a group the caller brought up
            _RANK["device"] = _rank_device(device, local_device_ids, dist.get_rank())
        return
    device = _rank_device(device, local_device_ids, process_id)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if coordinator_address is not None:
        address = coordinator_address
        if "://" not in address:
            address = f"tcp://{address}"
        dist.init_process_group(backend, init_method=address, world_size=num_processes,
                                rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://")
    _RANK["device"] = device


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that should write output files."""
    return process_index() == 0


def device() -> torch.device:
    """The device :func:`initialize` chose for this rank."""
    if "device" not in _RANK:
        raise RuntimeError("call initialize() first")
    return _RANK["device"]


def render_distributed(config, generator: Optional[torch.Generator] = None, *,
                       state: Optional[RenderState] = None, on_progress=None) -> RenderState:
    """Render ``config`` with its lanes split over every rank: rank ``r``
    renders shard ``r`` on its device, and the merge runs over the default
    group. Must be called by ALL ranks (it is a collective). Returns the
    merged state on every rank.

    ``state`` and ``on_progress`` are :func:`mesh.render_sharded`'s, on
    every rank: each rank holds the standing state, and every group of
    chunks merges on all ranks before ``on_progress`` runs."""
    from .mesh import Lanes, render_lanes

    lanes = Lanes([device()], [process_index()], process_count(), dist.group.WORLD)
    return render_lanes(config, lanes, generator, state, on_progress)

