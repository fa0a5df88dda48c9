"""The reduction of a traced window's ``torch.profiler`` events to what the
per-layer readers and the result's ``device`` and ``breakdown`` need.

Device time is the union of the card's activity intervals (kernels, copies,
memsets) over the traced window, as the port's ``chip_smoke._idle_share``
takes it; the harness's spans ride the trace as user annotations, which
are not device work and are left out of it. Every time here is on the
profiler's one clock, in seconds.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

# a kernel's function name without its return type, anonymous namespace,
# template arguments and signature
_BASE = re.compile(r"^(?:void\s+)?(?:\(anonymous namespace\)::)?([A-Za-z_][\w:]*)")
# entries of each breakdown list
BREAKDOWN_ENTRIES = 10


def base_name(name: str) -> str:
    """``void map_kernel<float, 0>(float*, int)`` -> ``map_kernel``;
    ``void (anonymous namespace)::tonemap_kernel<...>(...)`` ->
    ``tonemap_kernel``."""
    m = _BASE.match(name)
    return m.group(1) if m else name


def union_intervals(intervals) -> list:
    """Merged, sorted ``(start, end)`` intervals."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


@dataclass
class Trace:
    """``device``: (name, start, end) of every device activity; ``spans``:
    (name, start, end) of the harness's spans on the same clock."""

    device: list
    spans: list
    window: tuple  # (start, end) of the traced window
    _busy: list = field(default=None, repr=False)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_intervals(self) -> list:
        if self._busy is None:
            lo, hi = self.window
            self._busy = union_intervals((max(s, lo), min(e, hi)) for _, s, e in self.device
                                         if e > lo and s < hi)
        return self._busy

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the card."""
        return sum(e - s for s, e in self.busy_intervals)

    def kernel_s(self, names) -> tuple:
        """(device seconds, launches) of the kernels whose function is one
        of ``names``."""
        names = set(names)
        hits = [e - s for n, s, e in self.device if base_name(n) in names]
        return sum(hits), len(hits)

    def top_ops(self) -> list:
        """The device operations that took most time: [[name, seconds]]."""
        total: dict = {}
        for n, s, e in self.device:
            key = base_name(n)
            total[key] = total.get(key, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
                [:BREAKDOWN_ENTRIES]]

    def idle_gaps(self) -> list:
        """The longest idle gaps of the card, each named by the harness
        span the host was in at the gap's middle: [[span, seconds]]."""
        busy, (lo, hi) = self.busy_intervals, self.window
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        spans = sorted(self.spans, key=lambda sp: sp[1])
        out = []
        for start, end in gaps[:BREAKDOWN_ENTRIES]:
            mid = (start + end) / 2
            inside = [n for n, s, e in spans if s <= mid <= e]
            out.append([inside[-1] if inside else "between spans", end - start])
        return out


def reduce_profile(prof, span_names) -> Trace:
    """A :class:`Trace` of a finished ``torch.profiler.profile``."""
    device, spans = [], []
    span_names = set(span_names)
    results = prof.profiler.kineto_results
    # times from the trace's start, in integer nanoseconds until here, so
    # that a microsecond kernel keeps its digits
    base = results.trace_start_ns()
    for ev in results.events():
        start = (ev.start_ns() - base) * 1e-9
        end = (ev.start_ns() - base + ev.duration_ns()) * 1e-9
        annotation = ev.is_user_annotation() or ev.name() in span_names
        if ev.device_type().name == "CUDA":
            if not annotation:
                device.append((ev.name(), start, end))
        elif annotation and ev.name() in span_names:
            spans.append((ev.name(), start, end))
    window = (min(s for _, s, _ in spans), max(e for _, _, e in spans)) if spans else (0.0, 0.0)
    return Trace(device, spans, window)
