"""Profiling helpers (port of ``strange_attractor_tpu.utils.profiling``).

A render can be wrapped in :class:`RenderProfile` for phase wall times and
an iterations/s figure, and :func:`trace` records a ``torch.profiler``
trace (host ops and, on a card, its CUDA kernels) as a Chrome trace file.
:func:`sync` waits for a tensor's device, so that a phase's wall time
covers the device work it queued.

:func:`span` is the port's own record of where a frame's time goes: a
named interval on ``time.perf_counter_ns`` with its thread, its parent
span and counts taken at that boundary (bytes, launches, frames). Spans
are recorded only while a ``torch.profiler`` session is active on the
calling thread (``--profile DIR``, a benchmark's traced run); otherwise a
span costs one check of the profiler's state and records nothing. No span
synchronizes the card or changes what is launched. Worker threads see no
profiler, so a caller that hands work to them carries its decision over
with :func:`carried`. Recorded spans wait in a bounded buffer
(:data:`SPAN_CAPACITY`, later ones counted in :func:`dropped_spans`) for
:func:`spans`; :func:`trace` writes them into its Chrome trace, one track
a thread, on the trace's clock. The spans, by layer:

- render driver (``render.py``): ``render.launch`` (``render``, entry to
  return, no wait on the card; ``iterations``), ``render.seeds`` (the
  seed points drawn and copied to the device; ``lanes``),
  ``render.warmup`` (``Stepper.init``; ``steps``), ``render.chunks``
  (``render_seeds``' chunk loop; ``chunks``, ``launches`` counted by the
  kernel wrappers, ``bin`` the bin strategy's value, e.g. ``kernel`` or
  ``depth-kernel``, ``emit`` kernel A's emission mode, the planes kind:
  ``packed``, ``depth`` or ``exact``);
- sequence engine: ``engine.batch`` (one batch of
  ``render_sequence_shared`` or ``render_sequence_batched``; ``frames``,
  ``chunks``);
- delivery: ``deliver.tonemap`` (kernel T's launches, or the plain
  chain; ``frames``, ``render`` the render kind, ``gas`` or ``depth``),
  ``deliver.copy`` (the device-to-host copy:
  ``utils.export.to_host`` and ``render._deliver``'s; ``bytes``);
- encoder (``utils/export.py``): ``image.write`` (``write_image``;
  ``fmt``, ``bytes`` of the file), ``png.filter`` (``bytes_in``,
  ``bytes_out``, ``native`` 0 or 1, ``card`` 1 where kernel F filtered a
  delivered image's device copy), ``png.deflate`` (``bytes_in``,
  ``bytes_out``, ``threads``, ``stripes``), ``file.write`` (``bytes``).

The JAX package's ``force_cpu_if_requested`` and
``enable_compilation_cache`` are not carried: they work around the TPU
plugin's start-up and XLA's compile times. Here every entry point takes
an explicit ``device`` (nothing falls back to the CPU), and the CUDA
kernels are compiled once into ``build/torch_kernels/``
(:mod:`ops.cuda_lib`), where a later process loads them.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import socket
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple, Optional

import torch
from torch._C._autograd import _profiler_enabled

# the most spans the buffer keeps until it is cleared; later ones are
# counted in dropped_spans(); a traced 51-second window of a rotation or a
# still records some 5,000-7,000
SPAN_CAPACITY = 1 << 16
# the range trace() opens to put its spans on the Chrome trace's clock
ANCHOR = "program_spans.anchor"


@dataclass
class RenderProfile:
    """Collects phase wall-times and derived rates for one render.

    Usage::

        prof = RenderProfile(iterations=executed)
        with prof.phase("render"):
            state = render(config, device="cuda")
            sync(state.count)
        with prof.phase("colorize"):
            image = to_host(colorize(config, state))
        print(prof.summary())
    """

    iterations: int = 0
    phases: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    @property
    def total_seconds(self) -> float:
        return sum(self.phases.values())

    @property
    def iters_per_sec(self) -> Optional[float]:
        t = self.phases.get("render", self.total_seconds)
        if not self.iterations or t <= 0:
            return None
        return self.iterations / t

    def summary(self) -> str:
        parts = [f"{k}={v:.3f}s" for k, v in self.phases.items()]
        rate = self.iters_per_sec
        if rate is not None:
            parts.append(f"rate={rate:.3e} iters/s/chip")
        return " ".join(parts)


class SpanRecord(NamedTuple):
    """One finished span: times from ``time.perf_counter_ns``, the native
    id of the thread it ran on, its id and its parent's (None at the top),
    and the counts taken at its boundary."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    span_id: int
    parent: Optional[int]
    attrs: dict


class SpanBuffer:
    """Finished spans, at most ``capacity`` of them; a span that finds the
    buffer full is counted in ``dropped``. Threads share it."""

    def __init__(self, capacity: int = SPAN_CAPACITY):
        self.capacity, self.dropped = capacity, 0
        self._records: list = []
        self._lock = threading.Lock()

    def add(self, record: SpanRecord) -> None:
        with self._lock:
            if len(self._records) < self.capacity:
                self._records.append(record)
            else:
                self.dropped += 1

    def records(self) -> list:
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records, self.dropped = [], 0


BUFFER = SpanBuffer()
_IDS = itertools.count(1)


class _ThreadState(threading.local):
    """A thread's open spans (innermost last), and whether it records for a
    caller that carried its decision to it (:func:`carried`)."""

    carried = False

    def __init__(self):
        self.stack: list = []


_THREAD = _ThreadState()


class _Off:
    """The span of a thread that is not recording: nothing at all."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "span_id", "parent", "start_ns")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        """Counts known only when the span ends (launches, bytes out)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _THREAD.stack
        self.parent = stack[-1] if stack else None
        self.span_id = next(_IDS)
        stack.append(self.span_id)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        _THREAD.stack.pop()
        BUFFER.add(SpanRecord(self.name, self.start_ns, end, threading.get_native_id(),
                              self.span_id, self.parent, self.attrs))
        return False


def recording() -> bool:
    """Whether spans on this thread are recorded: a ``torch.profiler``
    session is active on it, or a caller carried one over (:func:`carried`)."""
    return _profiler_enabled() or _THREAD.carried


def span(name: str, **attrs):
    """A context manager that records ``name`` with the counts ``attrs``
    while :func:`recording`; entered, it gives an object whose ``set``
    adds counts known only at the end, or None when nothing is recorded::

        with span("png.deflate", bytes_in=len(data)) as sp:
            out = deflate(data)
            if sp:
                sp.set(bytes_out=len(out))

    Its parent is the innermost span open on the same thread, or the span
    a caller carried to this thread. Names are dotted (``layer.step``)."""
    # recording(), inline: off, this check is all a span costs
    if _profiler_enabled() or _THREAD.carried:
        return _Span(name, attrs)
    return _OFF


def carried(fn):
    """``fn`` for another thread to run, under the recording decision of
    the calling thread, taken once here: ``fn`` itself when it is not
    recording, else ``fn`` wrapped to record its spans with the caller's
    innermost open span as their parent."""
    if not recording():
        return fn
    base = _THREAD.stack[-1:]

    @functools.wraps(fn)
    def run(*args, **kwargs):
        state = _THREAD
        saved = state.carried, state.stack
        state.carried, state.stack = True, list(base)
        try:
            return fn(*args, **kwargs)
        finally:
            state.carried, state.stack = saved

    return run


def spans() -> list:
    """The recorded spans (:class:`SpanRecord`), in the order they ended."""
    return BUFFER.records()


def dropped_spans() -> int:
    """Spans that found the buffer full since it was last cleared."""
    return BUFFER.dropped


def clear_spans() -> None:
    """Empty the buffer and zero its dropped count."""
    BUFFER.clear()


def _append_spans(path: Path, records: list, anchor_end_ns: int) -> None:
    """Add ``records`` to the Chrome trace at ``path``, one track a thread
    under a process of their own, placed on the trace's clock by the end
    of the :data:`ANCHOR` range, whose ``perf_counter_ns`` end is
    ``anchor_end_ns``."""
    doc = json.loads(path.read_text())
    events = doc["traceEvents"]
    ends = [e["ts"] + e["dur"] for e in events if e.get("name") == ANCHOR and "dur" in e]
    if not ends:
        return
    offset_us = ends[0] - anchor_end_ns * 1e-3
    pid = "Program spans"
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "strange_attractor_tpu_torch spans"}})
    for thread in sorted({r.thread for r in records}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": thread,
                       "args": {"name": f"thread {thread}"}})
    for r in records:
        events.append({"ph": "X", "cat": "program_span", "name": r.name, "pid": pid,
                       "tid": r.thread, "ts": r.start_ns * 1e-3 + offset_us,
                       "dur": (r.end_ns - r.start_ns) * 1e-3,
                       "args": {**r.attrs, "span_id": r.span_id, "parent": r.parent}})
    path.write_text(json.dumps(doc))


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block: host ops, and the
    CUDA kernels when a card is in use. On exit, normal or not, it writes
    one Chrome trace file, ``<host>_<pid>.<timestamp>.pt.trace.json``, into
    ``log_dir`` (made if missing; open it in Perfetto or chrome://tracing),
    with the port's spans of the block (:func:`span`, encoder threads
    included) as a process of their own; the buffer is cleared after."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    start_ns = time.perf_counter_ns()
    anchor_end_ns = None

    def ready(prof) -> None:
        directory = Path(log_dir)
        directory.mkdir(parents=True, exist_ok=True)
        path = directory / f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
        prof.export_chrome_trace(str(path))
        records = [r for r in spans() if r.start_ns >= start_ns]
        clear_spans()
        if records and anchor_end_ns is not None:
            _append_spans(path, records, anchor_end_ns)

    with torch.profiler.profile(activities=activities, on_trace_ready=ready):
        # the anchor's end, read on both clocks, puts the spans on the trace's clock
        with torch.profiler.record_function(ANCHOR):
            pass
        anchor_end_ns = time.perf_counter_ns()
        yield


def sync(x) -> None:
    """Wait until the work queued on ``x``'s device is done: a CUDA
    tensor's device is synchronized; a CPU tensor is already computed."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
