"""host_copy_gbps.rotation: gigabytes a second of the sequence engine's
device-to-host copies: the bytes of the program's ``deliver.copy`` spans
over the device time of the trace's ``Memcpy DtoH`` operations that overlap
those spans on the trace's clock (``program_spans.trace_offset``). None
without a device trace, a span or such a copy."""

from bench_torch import program_spans as ps


def read(run):
    spans = ps.named(ps.fetch(run), "deliver.copy")
    offset = ps.trace_offset(run)
    if not spans or offset is None:
        return None
    windows = sorted(ps.on_trace(spans, offset))
    copies = [(s, e) for name, s, e in run.trace.device if name.startswith("Memcpy DtoH")]
    copy_s = sum(e - s for (s, e), inside in zip(copies, ps.covered_s(windows, copies))
                 if inside > 0)
    if copy_s <= 0:
        return None
    return sum(s.attrs.get("bytes", 0) for s in spans) / copy_s / 1e9
