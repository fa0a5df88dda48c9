"""Lane-sharded rendering over several devices (PyTorch port of
``strange_attractor_tpu.parallel.mesh``).

The reference renders on a thread pool and folds the per-thread canvases
with ``Runtime::merge`` (src/lib.rs:906-1082); the JAX package shards the
trajectory lanes over a device mesh and merges with collectives. Here:

- **lanes**: a frame's planned lanes split evenly over a list of devices,
  repeats allowed (four shards on one card). Every shard renders a private
  canvas at the per-shard schedule (:func:`shard_config`) through
  :class:`render.Stepper`; the shards advance chunk by chunk in turn, and
  every launch is asynchronous on its device, so the cards work at once.
- **merge**: :func:`merge_collective` combines the shards' planes with the
  semantics of the JAX package's ``merge_collective`` (mesh.py:69-88),
  either from a list of shards in one process or over a
  ``torch.distributed`` process group (:mod:`.distributed`).
- **frames x lanes**: :func:`render_sequence_sharded` renders an
  animation over a grid of devices: each row a contiguous slice of the
  angles, each frame's lanes split over the row's devices.

Seeding, the one place it is defined: shard ``s`` of ``n`` draws its seed
points and render key (:func:`render.seeds_and_key`) from
:func:`shard_generator`, which seeds a ``torch.Generator`` with the words
``(base, n, s)`` through numpy's ``SeedSequence``. ``base`` is
``config.seed``; with a ``generator`` argument it is the generator's first
draw, and a seeded resume folds the standing state's content nonce into the
seed first (:func:`render._progressive_nonce`, the JAX package's
``progressive_key``). An unseeded config draws OS entropy for every shard.
Rank ``r`` of a ``torch.distributed`` group of ``n`` renders shard ``r`` of
``n`` by the same rule, so a two-rank render equals :func:`render_sharded`
over two devices bit for bit.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import BinStrategy, Config
from ..ops.binning import _inv_mono_u32, _mono_u32, canonical_zero, to_u32_bits, u32
from ..render import (PROGRESS_EVERY, Stepper, _auto_frames_per_batch, _check_state, _deliver,
                      _draw_base, _host_frames, _planes_to_state, _progressive_nonce,
                      _same_device, _sealed, _sequence_base, _state_to_planes, _strategy,
                      frame_generator, plan_schedule, render_seeds_shared,
                      render_sequence_batched, seeds_and_key)
from ..runtime import RenderState, merge, resolve_device


def resolve_devices(devices=None) -> list:
    """``devices`` as a list of ``torch.device``s, repeats kept; the
    default is every visible card (raises without CUDA: no CPU
    fallback)."""
    if devices is None:
        resolve_device("cuda")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("no devices to render on")
    return devices


def _split_lanes(config: Config, lanes_total: int, ndev: int) -> int:
    """Lanes a shard. A pinned ``Config.lanes`` that the shard count does
    not divide loses the remainder (100 lanes on 8 shards run 96): warn so
    the cut shows (the JAX package's warning, mesh.py:44-61)."""
    lanes_local = max(1, lanes_total // ndev)
    if config.lanes is not None and lanes_local * ndev != lanes_total:
        warnings.warn(
            f"lanes={lanes_total} does not divide the {ndev}-device mesh; "
            f"executing {lanes_local * ndev} lanes ({lanes_local}/device). "
            "Pin a multiple of the device count for the exact budget.",
            stacklevel=3,
        )
    return lanes_local


def shard_config(config: Config, nshards: int) -> Config:
    """The config each of ``nshards`` lane shards renders: the planned
    schedule's lanes split over the shards, its chunk length pinned, and
    the iterations of its chunk count, so that every shard runs the
    schedule's chunks (the JAX package pins the per-device schedule the
    same way, mesh.py:91-116)."""
    lanes, chunk_steps, nchunks = plan_schedule(config)
    local = _split_lanes(config, lanes, nshards)
    return config.replace(lanes=local, chunk_steps=chunk_steps,
                          iterations=local * chunk_steps * nchunks)


def shard_generator(config: Config, shard: int, nshards: int,
                    base: Optional[int] = None) -> torch.Generator:
    """The generator of lane shard ``shard`` of ``nshards``: ``(base,
    nshards, shard)`` through ``SeedSequence``, ``base`` defaulting to
    ``config.seed``; OS entropy when both are None (see the module
    docstring)."""
    base = config.seed if base is None else base
    g = torch.Generator()
    if base is None:
        g.seed()
    else:
        words = [int(base) & (2**64 - 1), int(nshards), int(shard)]
        g.manual_seed(int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]))
    return g


def _shard_base(config: Config, generator: Optional[torch.Generator],
                nonce: Optional[int]) -> Optional[int]:
    """The ``base`` of :func:`shard_generator` for a render: the
    generator's first draw, else the seed with a resume's nonce folded in,
    else None (OS entropy)."""
    if generator is not None:
        return _draw_base(generator)
    if config.seed is None or nonce is None:
        return config.seed
    return int(np.random.SeedSequence([int(config.seed), int(nonce)])
               .generate_state(1, np.uint64)[0])


# ------------------------------------------------------------------ merge --

def _float_max(parts: list, ids: list, n: int, reduce) -> tuple:
    """The JAX package's ``pmax`` of float32 planes over ``n`` shards, as
    XLA computes it on the CPU: a fold from -inf in shard order that takes
    a value only if strictly greater, so NaN never wins (all NaN gives
    -inf) and of equal values (+0.0 and -0.0 among them) the lowest shard's
    is kept. Returns (max, winning shard index).

    Reduced as one int64 key a pixel, so that every backend's integer max
    gives the same bits: the order-preserving u32 of the value with its
    zero's sign dropped (NaN 0, below -inf's key), the shard index reversed
    (the lowest wins a tie), and a bit for a -0.0."""
    ib = max(1, (n - 1).bit_length())

    def key(z, i):
        rank = torch.where(torch.isnan(z), 0, _mono_u32(canonical_zero(z)))
        neg0 = ((z == 0.0) & torch.signbit(z)).to(torch.int64)
        return (rank << (ib + 1)) | ((n - 1 - i) << 1) | neg0

    best = reduce([key(z, i) for z, i in zip(parts, ids)], torch.amax)
    rank = best >> (ib + 1)
    z = torch.where(rank == 0, float("-inf"), _inv_mono_u32(rank))
    z = torch.where((best & 1) == 1, -0.0, z)
    return z, n - 1 - ((best >> 1) & ((1 << ib) - 1))


def _merge(kind: BinStrategy, shards: list, ids: list, n: int, reduce) -> tuple:
    """:func:`merge_collective` on the shards this process holds:
    ``reduce(parts, op)`` combines one tensor a shard over all ``n``
    shards (``op`` ``torch.sum`` or ``torch.amax`` on int64)."""
    if kind == BinStrategy.DEPTH:
        return (_float_max([s[0] for s in shards], ids, n, reduce)[0],)
    # counts add mod 2^32 and the packed u32 max, on their int64 values
    # (the int32 carriers order every u32 from 2^31 up below the small ones)
    count = to_u32_bits(reduce([u32(s[0]) for s in shards], torch.sum))
    if kind == BinStrategy.PACKED:
        return count, to_u32_bits(reduce([u32(s[1]) for s in shards], torch.amax))
    zmax, widx = _float_max([s[2] for s in shards], ids, n, reduce)
    won = zmax > -1.0
    # the winner's steps bits, summed as the JAX package's psum sums zeros
    # and one value: bit for bit, but v + 0.0 when there are other shards
    bits = reduce([torch.where((won & (widx == i)).to(s[1].device),
                               u32(s[1].contiguous().view(torch.int32)), 0)
                   for s, i in zip(shards, ids)], torch.sum)
    steps = to_u32_bits(bits).view(torch.float32)
    return count, steps + 0.0 if n > 1 else steps, zmax


def merge_collective(planes, strategy: BinStrategy, group=None) -> tuple:
    """Merge per-shard canvases with the semantics of the JAX package's
    ``merge_collective`` (``Runtime::merge``, src/lib.rs:708-738, as
    collectives; strange_attractor_tpu/parallel/mesh.py:69-88):

    - PACKED (and KERNEL): counts add mod 2^32, ``packed`` takes the u32
      max;
    - DEPTH: the z-buffer takes the max;
    - EXACT: counts add, ``zbuf`` takes the max, and ``steps`` is the
      winner's: the lowest shard index where ``zbuf == zmax`` and ``zbuf >
      -1``, else 0.0.

    Float maxima follow XLA's CPU ``pmax`` bit for bit (:func:`_float_max`:
    NaN never wins, the lowest shard keeps its zero's sign). Where
    :func:`runtime.merge_all`'s fold differs (a NaN or a -0.0 plane, steps
    where no shard wins) this function follows the JAX one.

    ``planes`` is either a list of per-shard plane tuples (flattened or
    not, of the strategy's planes kind) that may lie on different devices,
    merged onto the first one's; or, with a ``torch.distributed`` process
    ``group``, this rank's plane tuple, reduced by ``all_reduce`` (SUM and
    MAX on int64 keys) and returned on every rank. Returns new planes."""
    kind = strategy.planes_kind()
    if group is None:
        shards = [tuple(p) for p in planes]
        if not shards:
            raise ValueError("no shards to merge")
        dev = shards[0][0].device

        def reduce(parts, op):
            return op(torch.stack([p.to(dev) for p in parts]), 0)

        return _merge(kind, shards, list(range(len(shards))), len(shards), reduce)
    import torch.distributed as dist

    ops = {torch.sum: dist.ReduceOp.SUM, torch.amax: dist.ReduceOp.MAX}

    def reduce(parts, op):
        (t,) = parts
        dist.all_reduce(t, op=ops[op], group=group)
        return t

    return _merge(kind, [tuple(planes)], [dist.get_rank(group)], dist.get_world_size(group),
                  reduce)


def planes_to_state(planes, strategy: BinStrategy, shape) -> RenderState:
    """Reassemble a RenderState of ``shape`` from flat planes."""
    return _planes_to_state(tuple(planes), strategy.planes_kind(), tuple(shape))


# ----------------------------------------------------------------- render --

class _Lanes(NamedTuple):
    """How one canvas's lanes split: the shards this process renders
    (their devices and indices), the shard count, and the process group
    that merges them (None: every shard is in this process)."""

    devices: list
    shards: list
    count: int
    group: object = None


def _lanes_on(devices: list) -> _Lanes:
    return _Lanes(list(devices), list(range(len(devices))), len(devices))


def _merged(shards: list, lanes: _Lanes, strategy: BinStrategy, shape) -> RenderState:
    """The merge of this process's shards' planes over ``lanes``."""
    if lanes.group is not None:
        (planes,) = shards
        return planes_to_state(merge_collective(planes, strategy, lanes.group), strategy, shape)
    return planes_to_state(merge_collective(shards, strategy), strategy, shape)


def _render_lanes(config: Config, lanes: _Lanes, generator, state, on_progress) -> RenderState:
    """One frame with its lanes split as ``lanes`` says, merged, and
    folded into a standing ``state`` with :func:`runtime.merge`."""
    home = lanes.devices[0]
    nonce = None
    if state is not None:
        _check_state(config, state)
        if not _same_device(home, state.device):
            raise ValueError(f"the state lies on {state.device}, but the merge runs on {home}")
        if generator is None and config.seed is not None:
            nonce = _progressive_nonce(state)
    if config.iterations < 1:
        return state if state is not None else RenderState.create(config, device=home)
    strategy = _strategy(config, state)
    local = shard_config(config, lanes.count)
    base = _shard_base(config, generator, nonce)
    draws = [seeds_and_key(local, shard_generator(config, s, lanes.count, base))
             for s in lanes.shards]
    # every seed copy first: a copy from pageable memory waits for its
    # device's queue, which the warm-ups below fill
    steppers = [Stepper(local, seeds.to(dev), RenderState.create(local, strategy, device=dev),
                        reseed_key=key) for (seeds, key), dev in zip(draws, lanes.devices)]
    for st in steppers:
        st.init()
    nchunks = steppers[0].nchunks
    # progress after each full group of min(nchunks, PROGRESS_EVERY) chunks
    # and after the last one, as render_seeds reports
    group = min(nchunks, PROGRESS_EVERY)
    for done in range(1, nchunks + 1):
        for st in steppers:
            st.run(1)
        if on_progress is not None and done % group == 0 and done < nchunks:
            partial = _merged([st.planes for st in steppers], lanes, strategy, steppers[0].shape)
            on_progress(done, nchunks, partial if state is None else merge(state, partial))
    fresh = _merged([st.planes for st in steppers], lanes, strategy, steppers[0].shape)
    result = fresh if state is None else merge(state, fresh)
    if on_progress is not None:
        on_progress(nchunks, nchunks, result)
    return result


def render_sharded(config: Config, devices=None, generator: Optional[torch.Generator] = None,
                   *, state: Optional[RenderState] = None, on_progress=None) -> RenderState:
    """Render ``config`` with its lanes split over ``devices`` (a list of
    ``torch.device``s, repeats allowed; default every visible card) and
    return the merged state on the first device: the counterpart of the
    JAX package's ``render_sharded`` (mesh.py:133-213) and of the
    reference's ``render_parallel`` (src/lib.rs:1051-1082).

    Shard ``s`` renders at :func:`shard_config` with the seeds of
    :func:`shard_generator`, so the result is bit for bit
    :func:`merge_collective` of the shards' :func:`render.render_seeds`.
    ``state`` resumes a standing accumulation, which must lie on the first
    device: the fresh render folds into it with :func:`runtime.merge`, and
    a seeded config draws its seeds from the state's content as
    :func:`render.render` does. ``on_progress(done, total, partial_state)``
    gets the merged (and resumed) copy after each group of ``min(nchunks,
    64)`` chunks and after the last one; every shard then stands at the
    same chunk. ``iterations < 1`` renders nothing, as :func:`render.render`
    does: the standing state, or a blank one."""
    return _render_lanes(config, _lanes_on(resolve_devices(devices)), generator, state,
                         on_progress)


def render_sequence_sharded(config: Config, angles_deg: Sequence[float], devices=None,
                            generator: Optional[torch.Generator] = None, frame_axis: int = 0,
                            transparent: bool = True, eight_bit: bool = False,
                            frames_per_batch: int = 0, orbit: str = "per-frame", *,
                            group=None) -> np.ndarray:
    """Render an animation over a (frames, lanes) grid of ``devices``
    (default every visible card; the JAX package's
    ``render_sequence_sharded``, mesh.py:342-539): a host array of
    (F, H, W, C) frames in the order of ``angles_deg`` (degrees), converted
    by (``transparent``, ``eight_bit``) as the single-device engines do.

    The grid has ``frame_axis`` rows (0: as many as the angles or the
    devices allow, lowered until it divides the device count), each row a
    contiguous run of the devices. The angles fall into groups of
    ``frames_per_batch * frame_axis`` (``frames_per_batch`` frames a row, 0:
    the ~2 GB canvas rule of the single-device engines), a group padded to
    a multiple of the rows; row ``r`` takes the ``r``-th slice of its
    group, and the padding is never rendered. A frame's lanes split over
    its row's devices and its canvas is merged across them. With
    ``orbit="per-frame"`` frame ``i`` is :func:`render_sharded` over the
    row's devices with :func:`render.frame_generator` ``(config, i, base)``
    (``base``: the ``generator``'s first draw when one is given, else
    ``config.seed``, else one OS-entropy draw for the sequence) at its
    angle; with ``orbit="shared"``
    every frame of a row's slice bins one orbit through
    :func:`render.render_seeds_shared`, seeded by the slice's first frame's
    generator, and equals that :func:`render_sharded` at its angle.

    ``group``: a ``torch.distributed`` process group; every rank then
    renders its lane shard of every frame on its one device (``devices``,
    one entry) and merges over the group, and every rank gets the frames.
    """
    devices = resolve_devices(devices)
    shape = (0, config.height, config.width, 4 if transparent else 3)
    if len(angles_deg) == 0:
        return np.zeros(shape, np.uint8 if eight_bit else np.uint16)
    if config.iterations < 1:
        # blank frames, as the single-device engines give
        return render_sequence_batched(config, angles_deg, transparent=transparent,
                                       eight_bit=eight_bit, device=devices[0])
    if group is not None:
        import torch.distributed as dist

        if len(devices) != 1:
            raise ValueError("a rank of a process group renders on one device")
        frame_axis = 1
        rows = [_Lanes(devices, [dist.get_rank(group)], dist.get_world_size(group), group)]
    else:
        ndev = len(devices)
        if frame_axis <= 0:
            frame_axis = max(1, min(len(angles_deg), ndev))
        while ndev % frame_axis:
            frame_axis -= 1
        width = ndev // frame_axis
        rows = [_lanes_on(devices[r * width:(r + 1) * width]) for r in range(frame_axis)]
    strategy = config.resolved_bin_strategy()
    angles = np.asarray(list(angles_deg), np.float64)
    nang = len(angles)
    full_len = nang + (-nang) % frame_axis
    if frames_per_batch <= 0:
        frames_per_batch = _auto_frames_per_batch(config, strategy)
    per_batch = frames_per_batch * frame_axis
    group_len = full_len if per_batch >= full_len else per_batch
    if orbit not in ("per-frame", "shared"):
        raise ValueError(f"orbit must be 'per-frame' or 'shared', got {orbit!r}")
    base = _sequence_base(config, generator)
    rad = np.radians(angles)
    out = _host_frames(config, nang, transparent, eight_bit)
    per_row = group_len // frame_axis
    for start in range(0, nang, group_len):
        slices = [(lo, min(lo + per_row, nang)) for lo in
                  (start + r * per_row for r in range(frame_axis))]
        if orbit == "shared":
            states = [_shared_row(config, lanes, lo, hi, rad, base)
                      for lanes, (lo, hi) in zip(rows, slices) if lo < hi]
        else:
            # frame by frame across the rows, so that every row's devices
            # have work queued before a row waits on its own
            states = [[] for _ in rows]
            for k in range(per_row):
                for r, (lo, hi) in enumerate(slices):
                    if lo + k < hi:
                        i = lo + k
                        states[r].append(_render_lanes(
                            config.replace(angle=float(rad[i])), rows[r],
                            frame_generator(config, i, base), None, None))
        for row_states, (lo, hi) in zip(states, slices):
            if lo < hi:
                _deliver(config, row_states, out[lo:hi], transparent, eight_bit)
    return _sealed(out, devices[0])


def _shared_row(config: Config, lanes: _Lanes, lo: int, hi: int, rad, base: int) -> list:
    """Frames ``lo:hi`` of a shared-orbit row: every shard bins its lanes
    of the row's orbit at each angle (:func:`render.render_seeds_shared`),
    and each frame merges across the shards."""
    strategy = config.resolved_bin_strategy()
    local = shard_config(config, lanes.count)
    row_base = _draw_base(frame_generator(config, lo, base))
    per_shard = []
    for s, dev in zip(lanes.shards, lanes.devices):
        seeds, key = seeds_and_key(local, shard_generator(config, s, lanes.count, row_base))
        per_shard.append(render_seeds_shared(local, seeds.to(dev), rad[lo:hi], reseed_key=key))
    return [_merged([_state_to_planes(st) for st in frame], lanes, strategy, frame[0].shape)
            for frame in zip(*per_shard)]
