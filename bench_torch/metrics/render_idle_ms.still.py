"""render_idle_ms.still: milliseconds a frame in which the card is idle
while the host is inside ``render.launch``: each span put on the device
trace's clock (``program_spans.trace_offset``), less the part of it that the
card's busy intervals cover, summed over the window's frames. Time the card
waits on the host's seeding and launches. None without a device trace, or
unless the window recorded one span a frame."""

from bench_torch import program_spans as ps


def read(run):
    spans = ps.named(ps.fetch(run), "render.launch")
    offset = ps.trace_offset(run)
    if not spans or len(spans) != run.frames or offset is None or not run.trace.device:
        return None
    windows = ps.on_trace(spans, offset)
    busy = ps.covered_s(run.trace.busy_intervals, windows)
    return 1e3 * sum(e - s - b for (s, e), b in zip(windows, busy)) / run.frames
