"""The program's own spans (``strange_attractor_tpu_torch.utils.profiling``)
for the per-layer readers: fetched from the program, kept where they fall
inside the measured window, each assigned to the harness item that holds it,
and put on the device trace's clock.

The program records spans only under an active ``torch.profiler`` session,
so only a traced run (``--trace 1``) has any; a program without spans (an
older commit) gives None here, and so do the readers. Program spans are
timed with ``time.perf_counter_ns``, the harness's with
``time.perf_counter``, one clock. The trace's clock differs by an offset,
taken where both clocks see the same instant: the end of each harness span,
which the profiler records as the end of its range (:func:`trace_offset`).
"""

from __future__ import annotations

import bisect
import statistics
import threading
from dataclasses import dataclass
from typing import Optional

from bench_torch.harness import program


@dataclass
class ProgramSpan:
    """A program span on the harness's clock, in seconds."""

    name: str
    start: float
    end: float
    thread: int
    span_id: int
    parent: Optional[int]
    attrs: dict
    item: Optional[int] = None  # the harness item whose interval holds it

    @property
    def seconds(self) -> float:
        return self.end - self.start


def fetch(run) -> Optional[list]:
    """The program's spans inside the window of ``run`` (between the start of
    its first item and the end of its last), each with its item; None when
    the program records no spans or dropped some."""
    try:
        profiling = program("utils.profiling")
    except ImportError:
        return None
    if not hasattr(profiling, "spans") or not run.rec.items:
        return None
    if profiling.dropped_spans():
        return None
    items = sorted(run.rec.items, key=lambda it: it.start)
    starts = [it.start for it in items]
    lo, hi = items[0].start, items[-1].end
    out = []
    for r in profiling.spans():
        start, end = r.start_ns * 1e-9, r.end_ns * 1e-9
        if start < lo or end > hi:
            continue
        holder = items[bisect.bisect_right(starts, start) - 1]
        item = holder.item if end <= holder.end else None
        out.append(ProgramSpan(r.name, start, end, r.thread, r.span_id, r.parent,
                               dict(r.attrs), item))
    return out


def named(spans: Optional[list], name: str, *, off_thread: bool = False) -> Optional[list]:
    """The spans called ``name``; with ``off_thread`` only those recorded on
    another thread than the caller's (the window's own: the encoder threads)."""
    if spans is None:
        return None
    me = threading.get_native_id()
    return [s for s in spans if s.name == name and (not off_thread or s.thread != me)]


def per_frame_ms(run, name: str, *, off_thread: bool = False) -> Optional[float]:
    """Mean milliseconds of ``name`` a frame, where the window recorded one
    such span for each of its frames; else None."""
    spans = named(fetch(run), name, off_thread=off_thread)
    if not spans or len(spans) != run.frames:
        return None
    return 1e3 * sum(s.seconds for s in spans) / len(spans)


def trace_offset(run) -> Optional[float]:
    """Seconds to add to a harness-clock time to place it on the trace's
    clock: the median, over the harness spans of each name paired in order
    with their ranges in the trace, of the range's end less the span's end;
    None without a trace or a pair."""
    if run.trace is None:
        return None
    diffs = []
    for name in {s.name for s in run.rec.spans}:
        host = sorted((s for s in run.rec.spans if s.name == name), key=lambda s: s.start)
        traced = sorted((s for s in run.trace.spans if s[0] == name), key=lambda s: s[1])
        if len(host) == len(traced):
            diffs.extend(t[2] - h.end for h, t in zip(host, traced))
    return statistics.median(diffs) if diffs else None


def on_trace(spans: list, offset: float) -> list:
    """(start, end) of each span on the trace's clock."""
    return [(s.start + offset, s.end + offset) for s in spans]


def covered_s(intervals: list, windows: list) -> list:
    """Seconds of each (start, end) window that the sorted, disjoint
    ``intervals`` cover."""
    ends = [e for _, e in intervals]
    out = []
    for lo, hi in windows:
        total, i = 0.0, bisect.bisect_right(ends, lo)
        while i < len(intervals) and intervals[i][0] < hi:
            total += min(intervals[i][1], hi) - max(intervals[i][0], lo)
            i += 1
        out.append(total)
    return out
