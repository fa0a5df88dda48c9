"""The render engine (PyTorch port of ``strange_attractor_tpu.render``):
seed, warm up, then per chunk a fused map+emit and a bin; colorize at the end.

Per chunk of ``lanes x chunk_steps`` points (schedule: :func:`plan_schedule`,
the JAX package's rule):

1. :func:`ops.emit.map_emit` advances every lane ``chunk_steps`` map steps
   and emits the step-major point stream of the strategy's planes kind
   (``csrc/map_emit.cu`` on a CUDA device);
2. the strategy's bin accumulates it into the state's planes.

The kernel strategies launch a hand-written CUDA bin on a CUDA device
(:mod:`ops.kernel_binning`): KERNEL (what AUTO resolves to for a Gas
render) ``csrc/bin_packed.cu`` on PACKED planes, DEPTH_KERNEL (AUTO for a
Depth render) ``csrc/bin_depth.cu`` on the DEPTH plane, EXACT_KERNEL
``csrc/bin_exact.cu`` and EXACT16_KERNEL ``csrc/bin_exact16.cu`` on EXACT
planes. The scatter strategies PACKED, DEPTH and EXACT run the same chain
through the plain torch twins (:func:`ops.emit.map_emit_plain` and
:mod:`ops.binning`) on any device and give bit-identical planes to KERNEL,
DEPTH_KERNEL and EXACT_KERNEL; ``render_seeds(..., plain=True)`` takes the
twins of any strategy, EXACT16_KERNEL's included. That is how the kernels
are held against their twins on the card.

Rotation sequences (:func:`render_sequence_shared`,
:func:`render_sequence_batched`, :func:`render_sequence`) run the same
table. The shared-orbit engine renders one orbit per batch of frames: per
chunk one :func:`ops.emit.map_emit_shared` (``csrc/map_emit.cu``'s shared
modes) and per frame one :func:`ops.emit.project_emit`
(``csrc/project_emit.cu``) and that frame's bin, so every frame equals a
:func:`render_seeds` of the batch's seeds at its angle bit for bit.

Every engine runs both of kernel A's axes (:mod:`ops.emit`): the compute
dtype of ``Config.dtype`` (the lanes, seeds and shared streams in float32 or
float64; planes float32 in both) and lane reseeding (``Config.reseed_lanes``:
the (lanes,) int32 lane ages ride the render on the lanes' device from 0,
and each chunk's emission reseeds the dead lanes first, with the render key
drawn from the seed generator after the seed points and the chunk's index,
as the JAX package's ``_chunk_update`` does at the start of every chunk,
render.py:410-429; never in the warm-up).

Several devices: :func:`render_parallel` splits a frame's lanes over a
device list through :mod:`parallel.mesh`, whose shards run
:class:`Stepper`, the two halves of :func:`render_seeds`. A frame or a
batch reaches the host through :mod:`deliver`: the tone map and the
conversion (kernel T on a card, ``csrc/tonemap.cu``), then one host copy
(:func:`deliver.colorize_convert_fetch`, re-exported here,
:func:`deliver.fetch`, :func:`deliver.deliver_batch`), whose host arrays
from a card are read-only and keep their device copy for a PNG's filter.
:func:`precompile` warms a render's kernels before a timed one.

Spans (:func:`utils.profiling.span`, recorded under a profiler only):
``render.launch`` (:func:`render`, entry to return, no wait on the card),
``render.seeds`` (the seed points drawn and copied to their device),
``render.warmup`` (:meth:`Stepper.init`), ``render.chunks``
(:func:`render_seeds`' chunk loop, with the kernel wrappers' launches, the
bin strategy it ran and its emission mode) and ``engine.batch`` (one
batch of a sequence engine); the delivery's ``deliver.tonemap`` and
``deliver.copy`` are :mod:`deliver`'s.
"""

from __future__ import annotations

import functools
import time
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from . import deliver
from .config import BinStrategy, Config
# colorize_convert_fetch is re-exported: callers look it up here at call time
from .deliver import colorize_convert_fetch, deliver_batch, fetch, host_frames, sealed
from .ops import binning, emit, kernel_binning
from .ops.colorize import tonemap
from .runtime import RenderState, planes_to_state, progressive_nonce, resolve_device, \
    state_to_planes
from .utils.profiling import span
from .utils.sequencing import angle_iter

# chunks between progress lines of a non-silent render
PROGRESS_EVERY = 64


def plan_schedule(config: Config) -> tuple[int, int, int]:
    """(lanes, chunk_steps, nchunks) with lanes * chunk_steps * nchunks ~=
    iterations: the JAX package's planner (strange_attractor_tpu/render.py:
    96-127). A pinned ``chunk_steps`` runs exactly; an auto chunk length is
    evened over the chunk count."""
    lanes = config.resolved_lanes()
    target_steps = max(1, round(config.iterations / lanes))
    pinned = config.chunk_steps is not None
    chunk = config.resolved_chunk_steps()
    if not pinned:
        chunk = min(chunk, target_steps)
    nchunks = max(1, -(-target_steps // chunk))
    if not pinned:
        chunk = max(1, round(target_steps / nchunks))
    return lanes, chunk, nchunks


def _fold(seed: int, nonce: int) -> int:
    return int(np.random.SeedSequence([int(seed), int(nonce)]).generate_state(1, np.uint64)[0])


def seed_generator(config: Config, nonce: Optional[int] = None) -> torch.Generator:
    """CPU generator for the seed points: ``config.seed`` (with a
    progressive render's content nonce folded in), else OS entropy like the
    reference's SmallRng (src/lib.rs:656). Draws differ from jax.random's
    for the same seed; renders agree in distribution."""
    g = torch.Generator()
    if config.seed is None:
        g.seed()
    elif nonce is None:
        g.manual_seed(int(config.seed))
    else:
        g.manual_seed(_fold(config.seed, nonce))
    return g


def draw_base(generator: torch.Generator) -> int:
    """A base of :func:`frame_generator` drawn from ``generator``."""
    return int(torch.randint(0, 1 << 62, (1,), generator=generator))


def sequence_base(config: Config, generator: Optional[torch.Generator] = None) -> int:
    """The base a sequence folds its frame indices into: the
    ``generator``'s first draw when one is given (as a JAX ``key``
    overrides ``config.seed``), else ``config.seed``, else for an unseeded
    config one OS-entropy draw that the whole sequence shares (the JAX
    package's ``seed_key``, render.py:60-67)."""
    if generator is not None:
        return draw_base(generator)
    if config.seed is not None:
        return int(config.seed)
    return np.random.SeedSequence().entropy % (1 << 63)


def frame_generator(config: Config, index: int, base: Optional[int] = None) -> torch.Generator:
    """Generator of sequence frame ``index``'s seed points: ``index``
    folded into ``base`` (default ``config.seed``) as :func:`seed_generator`
    folds a progressive nonce -- the JAX package's ``fold_in(seed_key, i)``
    (render.py:1266, :1484-1486). A shared-orbit batch draws its orbit from
    its first frame's generator (:1448), so that frame equals the per-frame
    sequence's. With neither ``base`` nor a seed it draws OS entropy."""
    base = config.seed if base is None else base
    g = torch.Generator()
    if base is None:
        g.seed()
    else:
        g.manual_seed(_fold(base, index))
    return g


# each scatter strategy runs the plain twins of its kernel strategy
_KERNEL_OF = {BinStrategy.PACKED: BinStrategy.KERNEL, BinStrategy.DEPTH: BinStrategy.DEPTH_KERNEL,
              BinStrategy.EXACT: BinStrategy.EXACT_KERNEL}
# kernel strategy -> (kernel bin, plain twin)
_BINS = {
    BinStrategy.KERNEL: (kernel_binning.bin_chunk_kernel, binning.bin_chunk_packed),
    BinStrategy.DEPTH_KERNEL: (kernel_binning.bin_chunk_kernel_depth, binning.bin_chunk_depth),
    BinStrategy.EXACT_KERNEL: (kernel_binning.bin_chunk_kernel_exact, binning.bin_chunk_exact),
    BinStrategy.EXACT16_KERNEL: (kernel_binning.bin_chunk_kernel_exact16,
                                 binning.bin_chunk_exact16),
}


class _ChunkFns(NamedTuple):
    """The per-chunk functions of one strategy's route: kernels or twins."""

    map_emit: object
    map_emit_shared: object
    project_emit: object
    bin: object


_KERNEL_EMIT = (emit.map_emit, emit.map_emit_shared, emit.project_emit)
_PLAIN_EMIT = (emit.map_emit_plain, emit.map_emit_shared_plain, emit.project_emit_plain)


def _launches() -> int:
    """Launches the kernel wrappers of a chunk have counted so far: kernel
    A, kernel P and the four bins (the plain twins count none)."""
    return (emit.map_emit.launches + emit.project_emit.launches
            + sum(kernel.launches for kernel, _ in _BINS.values()))


def _chunk_fns(config: Config, strategy: BinStrategy, points: int, device: torch.device,
               plain: bool) -> _ChunkFns:
    """The emission and bin functions of ``strategy`` for chunks of
    ``points`` points: the kernels, or with ``plain`` (and for the scatter
    strategies) their plain twins. The EXACT kernels get one set of work
    buffers for the whole render: each launch leaves them ready for the
    next, so every frame of a sequence may share them too."""
    if strategy in _KERNEL_OF:
        strategy, plain = _KERNEL_OF[strategy], True
    kernel, twin = _BINS[strategy]
    kw = {"ties": config.exact16_ties} if strategy is BinStrategy.EXACT16_KERNEL else {}
    if plain:
        return _ChunkFns(*_PLAIN_EMIT, functools.partial(twin, **kw))
    if strategy in (BinStrategy.EXACT_KERNEL, BinStrategy.EXACT16_KERNEL) \
            and device.type == "cuda":
        kw["work"] = kernel_binning.new_work(points, device)
    return _ChunkFns(*_KERNEL_EMIT, functools.partial(kernel, **kw))


def render_strategy(config: Config, state: Optional[RenderState]) -> BinStrategy:
    """The strategy a render of ``config`` onto ``state`` runs: the resolved
    one, or the state's own planes kind when they differ (a plane-compatible
    state, e.g. PACKED planes under KERNEL, resumes through the resolved
    kernel strategy; JAX render.py:565-567)."""
    resolved = config.resolved_bin_strategy()
    if state is None or resolved.planes_kind() == state.strategy:
        return resolved
    return state.strategy


def same_device(want: torch.device, have: torch.device) -> bool:
    """Whether ``have`` is ``want``; a CUDA device without an index
    (``"cuda"``) stands for whichever card ``have`` names."""
    return want.type == have.type and (want.index is None or want.index == have.index)


def check_state(config: Config, state: RenderState) -> None:
    """Raise unless ``state`` lies on a usable device and has ``config``'s
    canvas."""
    resolve_device(state.device)
    if state.shape != (config.height, config.width):
        raise ValueError(f"state canvas {state.shape} does not match config "
                         f"{(config.height, config.width)}; use state.set_width_height() "
                         "for a reset state of the new size (the reference's resize "
                         "likewise discards the accumulation, src/lib.rs:666-675)")


def render(config: Config, state: Optional[RenderState] = None,
           generator: Optional[torch.Generator] = None, *, angle: Optional[float] = None,
           on_progress=None, device="cuda") -> RenderState:
    """Accumulate ``config.iterations`` map iterations into ``state``.

    Like the reference's ``render`` (src/lib.rs:747), call it again on the
    returned state to refine progressively; the input ``state`` is not
    modified. ``generator`` draws the seed points (default:
    :func:`seed_generator`, content-keyed for a seeded progressive call).
    ``angle`` (radians) overrides ``config.angle``. ``device`` is where the
    render runs: a given state must lie there (a ``ValueError`` names both
    devices otherwise), so a state loaded onto the CPU renders on the CPU
    only when ``device="cpu"`` says so. A CUDA device must be available:
    there is no CPU fallback. ``on_progress(done_chunks, total_chunks,
    partial_state)`` is called after each group of chunks, with a copy of
    the state (:func:`render_seeds`). With ``config.reseed_lanes`` the
    render key is the generator's next draw after the seed points.
    """
    with span("render.launch", iterations=config.iterations):
        progressive = state is not None
        device = torch.device(device)
        if state is None:
            state = RenderState.create(config, device=device)
        elif not same_device(device, state.device):
            raise ValueError(f"the state lies on {state.device}, but render was asked to run "
                             f"on {device}; pass device={str(state.device)!r} or move the state")
        check_state(config, state)
        if config.iterations < 1:
            return state
        if generator is None:
            # a seeded progressive call continues with a key derived from the
            # accumulated content, like the JAX package's progressive_key
            nonce = progressive_nonce(state) if progressive and config.seed is not None \
                else None
            generator = seed_generator(config, nonce)
        lanes, _, _ = plan_schedule(config)
        with span("render.seeds", lanes=lanes):
            seeds, key = seeds_and_key(config, generator, lanes)
            seeds = seeds.to(state.device)
        return render_seeds(config, seeds, state, angle=angle, on_progress=on_progress,
                            reseed_key=key)


def seeds_and_key(config: Config, generator: torch.Generator,
                  lanes: Optional[int] = None) -> tuple:
    """The seed points of ``lanes`` lanes (default: the planned schedule's)
    in the compute dtype, then the render key (0 without reseeding), both
    drawn from ``generator`` in that order: what :func:`render` hands
    :func:`render_seeds`."""
    if lanes is None:
        lanes = plan_schedule(config)[0]
    seeds = emit.seed_points(lanes, generator, emit.DTYPES[config.dtype])
    return seeds, emit.render_key(generator) if config.reseed_lanes else 0


def _check_seeds(config: Config, seeds: torch.Tensor, lanes: int) -> torch.device:
    dtype = emit.DTYPES[config.dtype]
    if tuple(seeds.shape) != (lanes, 3) or seeds.dtype != dtype:
        raise ValueError(f"seeds must be ({lanes}, 3) {dtype}, got "
                         f"{tuple(seeds.shape)} {seeds.dtype}")
    return resolve_device(seeds.device)


def _reseeds(config: Config, lanes: int, key: int, device) -> Iterator:
    """Each chunk's :class:`ops.emit.Reseed` (None without reseeding); the
    lane ages start at 0 and are carried from chunk to chunk."""
    age = torch.zeros(lanes, dtype=torch.int32, device=device) if config.reseed_lanes else None
    chunk = 0
    while True:
        yield None if age is None else emit.Reseed(age, key, chunk, config.warmup)
        chunk += 1


class Stepper:
    """:func:`render_seeds` in two halves, for callers that run several
    renders chunk by chunk side by side (the lane shards of
    :mod:`parallel.mesh`): the counterpart of the JAX package's
    ``_canvas_stepper`` (render.py:1060-1103).

    Construction checks the seeds and the state, copies the seeds to their
    device and makes the planes; :meth:`init` runs the warm-up and
    :meth:`run` advances the planes, the lanes and the lane ages by ``n``
    chunks, so any split of the planned chunks into calls of :meth:`run`
    gives the planes of one :func:`render_seeds`. :meth:`state` returns the
    planes as a RenderState. The arguments are :func:`render_seeds`'s.
    """

    def __init__(self, config: Config, seeds: torch.Tensor,
                 state: Optional[RenderState] = None, *, angle: Optional[float] = None,
                 plain: bool = False, reseed_key: int = 0):
        self.lanes, self.chunk_steps, self.nchunks = plan_schedule(config)
        self.device = _check_seeds(config, seeds, self.lanes)
        if state is None:
            state = RenderState.create(config, device=self.device)
        check_state(config, state)
        if state.device != self.device:
            raise ValueError(f"seeds are on {self.device}, the state on {state.device}")
        self.config, self.done = config, 0
        self.kind, self.shape = state.strategy, state.shape
        self.strategy = render_strategy(config, state)
        self._fns = _chunk_fns(config, self.strategy, self.lanes * self.chunk_steps,
                               self.device, plain)
        self._spec = emit.emit_spec(config, config.angle if angle is None else angle)
        self._points = seeds.t().contiguous()  # (3, lanes), one lane per column
        self._reseeds = _reseeds(config, self.lanes, reseed_key, self.device)
        self.planes = state_to_planes(state)

    def init(self) -> None:
        """The warm-up: ``config.warmup`` map steps of every lane, no
        emission and no reseeding."""
        if self.config.warmup:
            with span("render.warmup", steps=self.config.warmup):
                self._fns.map_emit(self._spec, self._points, self.config.warmup, emit=False)

    def run(self, n: int) -> None:
        """Advance ``n`` chunks: per chunk one map+emit and one bin."""
        fns = self._fns
        for _ in range(n):
            self.planes = fns.bin(*self.planes, *fns.map_emit(
                self._spec, self._points, self.chunk_steps, kind=self.kind,
                reseed=next(self._reseeds)))
        self.done += n

    def state(self, copy: bool = False) -> RenderState:
        """The planes as a RenderState; ``copy`` for a snapshot that later
        chunks leave alone (the kernels bin in place)."""
        planes = tuple(p.clone() for p in self.planes) if copy else self.planes
        return planes_to_state(planes, self.kind, self.shape)


def render_seeds(config: Config, seeds: torch.Tensor, state: Optional[RenderState] = None,
                 *, angle: Optional[float] = None, plain: bool = False,
                 on_progress=None, reseed_key: int = 0) -> RenderState:
    """Render from explicit pre-warm-up seed points ``seeds`` (lanes, 3) in
    the compute dtype, one lane each, on their device: warm-up, then the
    planned chunks (a :class:`Stepper`'s ``init`` and ``run``). The
    counterpart of ``oracle.oracle_render``'s explicit seeds. ``plain``
    runs the plain twins of the strategy's kernels (the route the scatter
    strategies always take) on any device. With ``config.reseed_lanes``
    dead lanes restart from the fresh points of ``reseed_key``
    (:func:`ops.emit.fresh_points`). ``on_progress(done, total,
    partial_state)`` is called with a copy of the planes after each group
    of chunks that ends with a progress line, and after the last chunk: the
    JAX package's points, after each dispatch group (render.py:533,
    :547-551, :618-627)."""
    stepper = Stepper(config, seeds, state, angle=angle, plain=plain, reseed_key=reseed_key)
    lanes, chunk_steps, nchunks = stepper.lanes, stepper.chunk_steps, stepper.nchunks
    if not config.silent:
        print(f"Rendering started on device ({lanes} lanes).")
    t0 = time.perf_counter()
    stepper.init()
    # a line after each full group of min(nchunks, PROGRESS_EVERY) chunks,
    # the last one included, none after the remainder: the JAX package's
    # lines, one a dispatch group (render.py:574-578, :613-617)
    group = min(nchunks, PROGRESS_EVERY)
    with span("render.chunks", chunks=nchunks) as sp:
        launched = 0
        if sp:
            launched = _launches()
            sp.set(bin=stepper.strategy.value, emit=stepper.kind.value)
        for done in range(1, nchunks + 1):
            stepper.run(1)
            full = done % group == 0 and done <= nchunks - nchunks % group
            if not config.silent and full:
                print(f"Iteration complete, {nchunks - done} left to go.")
            if on_progress is not None and (full or done == nchunks):
                on_progress(done, nchunks, stepper.state(copy=True))
        if sp:
            sp.set(launches=_launches() - launched)
    if not config.silent:
        if stepper.device.type == "cuda":
            torch.cuda.synchronize(stepper.device)
        executed = lanes * chunk_steps * nchunks
        dtime = time.perf_counter() - t0
        print(f"Rendered {executed:.3e} iterations in {dtime:.2f}s "
              f"({executed / max(dtime, 1e-9):.3e} iters/s).")
    return stepper.state()


def colorize(config: Config, state: RenderState) -> torch.Tensor:
    """Tone-map an accumulated state to an (H, W, 4) uint16 RGBA tensor on
    the state's device (reference: src/lib.rs:841-904): kernel T on a card
    (:func:`ops.colorize.tonemap`), the plain chain on the CPU."""
    return tonemap(config, state)


def precompile(config: Config, strategy: Optional[BinStrategy] = None, *,
               device="cuda") -> RenderState:
    """Warm what a :func:`render` of ``config`` on ``device`` runs, so that
    timed renders measure execution only (the JAX package's ``precompile``,
    render.py:486-524). Returns the warm-up's final state (the config's
    canvas and strategy, on ``device``, synchronized): warm the delivery
    (:func:`colorize_convert_fetch`) with it.

    On a card it loads the kernel library, building it from ``csrc/`` if
    no build of these sources exists (:func:`ops.cuda_lib.library`), then
    renders two chunks (one if the render has one) at the config's own
    resolved lanes x chunk steps: kernel A's launcher then takes the branch
    the render takes (chosen by lanes per SM), the same instantiation runs
    (gated with ``reseed_lanes``, float64 with ``dtype="float64"``), and
    the strategy's bin runs on work buffers of the render's size. XLA compiles a
    program per shape, so the JAX package warms its full dispatch group and
    the remainder; here every kernel is compiled ahead, and a chunk is the
    same launches whatever the chunk count, so two chunks suffice.

    An explicit ``strategy`` pins ``config.bin_strategy`` for the warm-up
    (and helps only if the real renders use the same pinned config);
    without one, ``config.resolved_bin_strategy()`` decides.
    """
    if strategy is not None and config.bin_strategy is not strategy:
        config = config.replace(bin_strategy=strategy)
    else:
        strategy = config.resolved_bin_strategy()
    device = resolve_device(device)
    if device.type == "cuda":
        from .ops import cuda_lib

        cuda_lib.library()
    lanes, chunk_steps, nchunks = plan_schedule(config)
    warm = config.replace(iterations=lanes * chunk_steps * min(nchunks, 2), lanes=lanes,
                          chunk_steps=chunk_steps, silent=True)
    state = render(warm, RenderState.create(config, strategy, device),
                   torch.Generator().manual_seed(0), device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return state


def render_frame(config: Config, generator: Optional[torch.Generator] = None, *,
                 angle: Optional[float] = None, device="cuda") -> np.ndarray:
    """One-shot: fresh state -> render -> colorize -> one host copy, an
    (H, W, 4) uint16 RGBA numpy frame (the JAX package's ``render_frame``,
    render.py:1025-1034). ``angle`` in radians."""
    return fetch(colorize(config, render(config, None, generator, angle=angle, device=device)))


def render_parallel(config: Config, generator: Optional[torch.Generator] = None, *,
                    devices=None, jobs_per_thread: int = 12) -> np.ndarray:
    """Render one frame with its lanes split over ``devices`` (default:
    every visible card; the reference's ``render_parallel``,
    src/lib.rs:1051-1082, and the JAX package's, render.py:1036-1057): an
    (H, W, 4) uint16 RGBA numpy frame. With one device it is
    :func:`render_frame`; with more, :func:`parallel.mesh.render_sharded`
    followed by :func:`render_frame`'s delivery. ``jobs_per_thread`` is
    accepted for the reference's signature and ignored: the lanes split
    evenly, so there is no work stealing to tune."""
    del jobs_per_thread
    from .parallel.mesh import render_sharded, resolve_devices

    devices = resolve_devices(devices)
    if len(devices) == 1:
        return render_frame(config, generator, device=devices[0])
    return fetch(colorize(config, render_sharded(config, devices, generator)))


def render_sequence(config: Config, start_deg: float, end_deg: float, step_deg: float,
                    generator: Optional[torch.Generator] = None, *,
                    device="cuda") -> Iterator[tuple[float, np.ndarray]]:
    """Frames of a camera rotation (the reference's ``sequence``
    subcommand, src/bin/main.rs:327-367, angles by its AngleIter), one
    :func:`render_frame` each: yields ``(angle_degrees, image)``. Frame
    ``i`` draws its seeds from :func:`frame_generator` ``(config, i,
    base)``, ``base`` the ``generator``'s first draw if one is given (it
    stands where the JAX ``key`` does and overrides ``config.seed`` as
    that does), else ``config.seed``; so a sequence is frame-identical to
    :func:`render_sequence_batched` with the same generator or seed (the
    JAX package's ``render_sequence``, render.py:1461-1488)."""
    base = sequence_base(config, generator)
    for i, angle_deg in enumerate(angle_iter(start_deg, end_deg, step_deg)):
        gen = frame_generator(config, i, base)
        yield angle_deg, render_frame(config, gen, angle=float(np.radians(angle_deg)),
                                      device=device)


def auto_frames_per_batch(config: Config, strategy: BinStrategy) -> int:
    """Frames per batch for :data:`deliver.DEVICE_BUDGET` (2 GB) of live canvases: the planes of the
    strategy's kind plus the 8 B/px of the u16 RGBA frame (the JAX
    package's canvas-only rule, render.py:1161-1173). Both sequence engines
    take it: the card renders a batch's frames one after another, so the
    JAX per-frame rule's lock-step working-set term (:1127-1158) has no
    counterpart here. The float32 rule's slack holds one chunk's shared
    stream (16 B a point); the float64 stream is twice as wide, and its
    extra bytes (and the float32 value stream an EXACT frame adds) come
    off the budget."""
    kind = strategy.planes_kind()
    plane_bytes = {BinStrategy.EXACT: 12, BinStrategy.PACKED: 8, BinStrategy.DEPTH: 4}[kind]
    budget = deliver.DEVICE_BUDGET
    if config.dtype == "float64":
        lanes, chunk, _ = plan_schedule(config)
        streams = (3 if kind == BinStrategy.DEPTH else 4) + (kind == BinStrategy.EXACT)
        budget -= lanes * chunk * 4 * streams
    return max(1, int(budget / max(1, config.width * config.height * (plane_bytes + 8))))


def _sequence_setup(config: Config, angles_deg, frames_per_batch: Optional[int], device):
    """(angles in degrees as float64, frames per batch, device) of a
    sequence call; ``frames_per_batch`` None or <= 0 means auto."""
    angles = np.asarray(list(angles_deg), np.float64)
    if frames_per_batch is None or frames_per_batch <= 0:
        frames_per_batch = auto_frames_per_batch(config, config.resolved_bin_strategy())
    return angles, frames_per_batch, resolve_device(device)


def render_sequence_batched(config: Config, angles_deg,
                            generator: Optional[torch.Generator] = None,
                            frames_per_batch: Optional[int] = None, transparent: bool = True,
                            eight_bit: bool = False, *, device="cuda") -> np.ndarray:
    """Render a camera rotation with an orbit of its own per frame: frame
    ``i`` is :func:`render` with :func:`frame_generator` ``(config, i,
    base)`` at ``angles_deg[i]`` (degrees), as the reference draws fresh
    samples per frame; ``base`` is the ``generator``'s first draw if one is
    given (the JAX ``key``'s place, overriding ``config.seed``), else
    ``config.seed``. Returns (F, H, W, C) frames (read-only when ``device``
    is a card) in the order of ``angles_deg``, converted on the device by
    (``transparent``, ``eight_bit``) (the JAX defaults keep the (F, H, W,
    4) uint16 contract).

    The counterpart of the JAX package's ``render_sequence_batched``
    (render.py:1176-1278), which vmaps a batch's frames into one program.
    Here the frames render one after another; ``frames_per_batch`` (None
    or <= 0: auto, ~2 GB) bounds how many converted frames stay on the
    device before one host copy. A seeded config gives the frames of
    :func:`render_sequence`. ``iterations < 1`` gives blank frames.
    """
    angles, per_batch, device = _sequence_setup(config, angles_deg, frames_per_batch, device)
    out = host_frames(config, len(angles), transparent, eight_bit, device)
    if config.iterations < 1:
        blank = host_frames(config, 1, transparent, eight_bit, device)
        deliver_batch(config, [RenderState.create(config, device=device)], blank, transparent,
                      eight_bit)
        out[:] = blank
        return sealed(out, device)
    base = sequence_base(config, generator)
    rad = np.radians(angles)
    nchunks = plan_schedule(config)[2]
    for lo in range(0, len(angles), per_batch):
        hi = min(lo + per_batch, len(angles))
        with span("engine.batch", frames=hi - lo, chunks=(hi - lo) * nchunks):
            states = (render(config, generator=frame_generator(config, i, base),
                             angle=float(rad[i]), device=device) for i in range(lo, hi))
            deliver_batch(config, states, out[lo:hi], transparent, eight_bit)
    return sealed(out, device)


def render_seeds_shared(config: Config, seeds: torch.Tensor, angles,
                        *, plain: bool = False, reseed_key: int = 0) -> list:
    """One orbit from explicit pre-warm-up ``seeds`` (lanes, 3) in the
    compute dtype, binned at every camera angle of ``angles`` (radians): a
    list of one RenderState per angle, frame ``f`` bit-identical to
    ``render_seeds(config, seeds, angle=angles[f], plain=plain,
    reseed_key=reseed_key)``.

    The counterpart of the JAX package's ``_canvas_body_shared``
    (render.py:1281-1353): seed and warm-up once, then per chunk one
    :func:`ops.emit.map_emit_shared` of the frame-invariant stream and per
    frame one :func:`ops.emit.project_emit` and that frame's bin. The
    frames' planes start as the rows of one (F, npix) tensor per plane,
    which the bin kernels update in place. ``plain`` runs the twins.
    """
    lanes, chunk_steps, nchunks = plan_schedule(config)
    device = _check_seeds(config, seeds, lanes)
    strategy = config.resolved_bin_strategy()
    kind, shape = strategy.planes_kind(), (config.height, config.width)
    fns = _chunk_fns(config, strategy, lanes * chunk_steps, device, plain)
    specs = [emit.emit_spec(config, float(a)) for a in angles]
    blank = state_to_planes(RenderState.create(config, device=device))
    rows = tuple(p.expand(len(specs), -1).clone() for p in blank)
    frames = [tuple(r[f] for r in rows) for f in range(len(specs))]
    # the camera angle does not enter the warm-up or the shared stream
    spec0 = emit.emit_spec(config, 0.0)
    points = seeds.t().contiguous()
    if config.warmup:
        fns.map_emit(spec0, points, config.warmup, emit=False)
    reseeds = _reseeds(config, lanes, reseed_key, device)
    for _ in range(nchunks if specs else 0):
        shared = fns.map_emit_shared(spec0, points, chunk_steps, kind=kind,
                                     reseed=next(reseeds))
        for f, spec in enumerate(specs):
            frames[f] = fns.bin(*frames[f], *fns.project_emit(spec, shared, kind=kind))
    return [planes_to_state(p, kind, shape) for p in frames]


def render_sequence_shared(config: Config, angles_deg,
                           generator: Optional[torch.Generator] = None,
                           frames_per_batch: Optional[int] = None, transparent: bool = True,
                           eight_bit: bool = False, *, device="cuda") -> np.ndarray:
    """Render a camera rotation from one shared orbit per batch of frames.

    The contract of :func:`render_sequence_batched`, ``generator``
    included, but the frames of a batch all bin the orbit seeded by the
    batch's first frame's generator
    (:func:`frame_generator` ``(config, lo, base)``): each frame is
    bit-identical to :func:`render_seeds` of those seeds at its angle (a
    normal render's fidelity), and the sampling noise moves with the
    camera instead of being drawn anew. The warm-up and the map run once
    per batch instead of once per frame. ``frames_per_batch`` (None or
    <= 0: auto, ~2 GB of canvases) bounds the frames whose planes live on
    the device at once. The counterpart of the JAX package's
    ``render_sequence_shared`` (render.py:1356-1458).
    """
    angles, per_batch, device = _sequence_setup(config, angles_deg, frames_per_batch, device)
    if config.iterations < 1:
        # blank frames carry no orbit: the per-frame engine's result
        return render_sequence_batched(config, angles, frames_per_batch=per_batch,
                                       transparent=transparent, eight_bit=eight_bit,
                                       device=device)
    lanes, _, nchunks = plan_schedule(config)
    base = sequence_base(config, generator)
    rad = np.radians(angles)
    out = host_frames(config, len(angles), transparent, eight_bit, device)
    for lo in range(0, len(angles), per_batch):
        hi = min(lo + per_batch, len(angles))
        with span("engine.batch", frames=hi - lo, chunks=nchunks):
            with span("render.seeds", lanes=lanes):
                seeds, key = seeds_and_key(config, frame_generator(config, lo, base), lanes)
                seeds = seeds.to(device)
            states = render_seeds_shared(config, seeds, rad[lo:hi], reseed_key=key)
            deliver_batch(config, states, out[lo:hi], transparent, eight_bit)
    return sealed(out, device)
