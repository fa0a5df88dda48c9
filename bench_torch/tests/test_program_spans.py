"""The program's own spans in the benchmark, on the CPU: the clock conversion
on a canned run, each reader of ``program_spans`` on canned spans with its
None cases, and tiny traced runs of every cell, whose program spans land
inside the harness's spans on the trace's clock."""

from __future__ import annotations

import threading

import pytest

from bench_torch import harness, program_spans
from bench_torch.trace import Trace
from strange_attractor_tpu_torch.utils import profiling

from .conftest import measure

# the trace's clock runs this far ahead of the harness's in the canned runs
OFFSET = 100.0
ENCODER = threading.get_native_id() + 1  # a thread that is not the reader's


def _metric(name, run):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py", f"m_{name}").read(run)


def _record(name, start, end, *, thread=None, parent=None, span_id=[0], **attrs):
    span_id[0] += 1
    return profiling.SpanRecord(name, round(start * 1e9), round(end * 1e9),
                                thread or threading.get_native_id(), span_id[0], parent, attrs)


@pytest.fixture
def buffer(monkeypatch):
    """The program's span buffer, empty, for a test to fill."""
    buf = profiling.SpanBuffer()
    monkeypatch.setattr(profiling, "BUFFER", buf)
    return buf


def _run(cell_name, rec, frames_per_item, trace):
    cell = harness.find_cell(harness.load_bench(), cell_name)
    info = {"frames_per_item": frames_per_item, "width": 4, "height": 2}
    return harness.Run(cell, 1.0, rec, info, {}, trace, {})


def _traced(rec, device, jitter=()):
    """A trace of ``rec``'s spans, each end ``OFFSET`` (plus its jitter)
    later on the trace's clock; starts a little later still (the range's
    enter cost)."""
    jitter = list(jitter) + [0.0] * len(rec.spans)
    spans = [(s.name, s.start + OFFSET + 5e-5, s.end + OFFSET + j)
             for s, j in zip(rec.spans, jitter)]
    return Trace(device, spans, (min(s for _, s, _ in spans), max(e for _, _, e in spans)))


def _still(buffer, *, device=(), drop=None):
    """Two still frames at [0, 4] and [10, 14] s: render [0, 1], deliver
    [1, 2], encode [2, 4] of each, and the program's spans inside them."""
    rec = harness.Recorder(False)
    for i in range(2):
        t = 10.0 * i
        rec.items.append(harness.Span("item", i, t, t + 4.0))
        rec.spans += [harness.Span("render", i, t, t + 1.0),
                      harness.Span("deliver", i, t + 1.0, t + 2.0),
                      harness.Span("encode", i, t + 2.0, t + 4.0)]
        launch = _record("render.launch", t + 0.1, t + 0.6, iterations=96)
        records = [_record("render.seeds", t + 0.1, t + 0.2, parent=launch.span_id),
                   launch, _record("deliver.copy", t + 1.5, t + 1.9, bytes=24),
                   _record("png.filter", t + 2.1, t + 2.4, bytes_in=24),
                   _record("png.deflate", t + 2.4, t + 3.4, bytes_in=26),
                   _record("image.write", t + 2.0, t + 3.9, fmt="png")]
        for r in records:
            if r.name != drop or i == 0:
                buffer.add(r)
    # a span from before the window is left out
    buffer.add(_record("png.filter", -5.0, -4.0))
    return _run("poisson-saturne.still", rec, 1, _traced(rec, list(device)))


def test_the_clock_offset_is_the_median_at_span_ends(buffer):
    run = _still(buffer, device=[("k", 100.0, 100.1)])
    assert program_spans.trace_offset(run) == pytest.approx(OFFSET)
    rec = run.rec
    jittered = _run("poisson-saturne.still", rec, 1,
                    _traced(rec, [], jitter=[3e-6, -2e-6, 1e-6, 9e-3, 0, 0]))
    # one far-off end moves the median by nothing
    assert program_spans.trace_offset(jittered) == pytest.approx(OFFSET, abs=1e-6)
    assert program_spans.trace_offset(_run("poisson-saturne.still", rec, 1, None)) is None
    spans = program_spans.fetch(run)
    assert {s.item for s in spans} == {0, 1}
    assert len(spans) == 12  # the span before the window is not among them
    on = program_spans.on_trace([s for s in spans if s.name == "render.launch"], OFFSET)
    assert on[0] == pytest.approx((100.1, 100.6))


def test_the_still_readers_on_canned_spans(buffer):
    # the card busy over [0.3, 0.5] of the first launch and all of the second
    run = _still(buffer, device=[("bin_packed_kernel", 100.3, 100.5),
                                 ("map_emit_ilp_kernel", 110.0, 110.7)])
    assert _metric("png_filter_ms.still", run) == pytest.approx(300.0)
    assert _metric("png_deflate_ms.still", run) == pytest.approx(1000.0)
    assert _metric("render_launch_ms.still", run) == pytest.approx(500.0)
    # idle 0.3 s in the first launch, none in the second, over two frames
    assert _metric("render_idle_ms.still", run) == pytest.approx(150.0)


@pytest.mark.parametrize("metric", ["png_filter_ms.still", "png_deflate_ms.still",
                                    "render_launch_ms.still", "render_idle_ms.still"])
def test_the_still_readers_read_nothing_where_spans_are_missing(metric, buffer, monkeypatch):
    dropped = {"png_filter_ms.still": "png.filter", "png_deflate_ms.still": "png.deflate"}
    # a span short of one a frame
    run = _still(buffer, device=[("k", 100.0, 100.1)],
                 drop=dropped.get(metric, "render.launch"))
    assert _metric(metric, run) is None
    # a buffer that dropped spans
    buffer.clear()
    run = _still(buffer, device=[("k", 100.0, 100.1)])
    assert _metric(metric, run) is not None
    buffer.dropped = 1
    assert _metric(metric, run) is None
    buffer.dropped = 0
    # an untraced run
    untraced = _run("poisson-saturne.still", run.rec, 1, None)
    assert (_metric(metric, untraced) is None) == (metric == "render_idle_ms.still")
    # a program that records no spans (an older commit)
    monkeypatch.delattr(profiling, "spans")
    assert _metric(metric, run) is None


def _rotation(buffer, *, device=(), frames=4, writes=None):
    """One sequence of ``frames`` frames: engine [0, 2], write [2, 10] s; two
    host copies in the engine, each frame written on an encoder thread."""
    rec = harness.Recorder(False)
    rec.items.append(harness.Span("item", 0, 0.0, 10.0))
    rec.spans += [harness.Span("engine", 0, 0.0, 2.0), harness.Span("write", 0, 2.0, 10.0)]
    buffer.add(_record("deliver.copy", 1.0, 1.5, bytes=600_000_000))
    buffer.add(_record("deliver.copy", 1.6, 1.9, bytes=400_000_000))
    for f in range(frames if writes is None else writes):
        start = 2.0 + 2.0 * (f // 4)
        buffer.add(_record("image.write", start, start + 2.0, thread=ENCODER + f % 4))
    # a write on the reader's own thread is no encoder's
    buffer.add(_record("image.write", 9.0, 9.5))
    return _run("poisson-saturne.rotation-png", rec, frames, _traced(rec, list(device)))


def test_the_rotation_readers_on_canned_spans(buffer):
    copies = [("Memcpy DtoH (Device -> Pageable)", 101.1, 101.4),
              ("Memcpy DtoH (Device -> Pageable)", 101.6, 101.8),
              # a copy outside the engine's copies is not theirs
              ("Memcpy DtoH (Device -> Pageable)", 105.0, 105.5),
              ("Memcpy HtoD (Pageable -> Device)", 101.2, 101.3)]
    run = _rotation(buffer, device=copies)
    assert _metric("frame_encode_ms.rotation", run) == pytest.approx(2000.0)
    # 4 writes of 2 s over 4 encoders x 8 s of the write span
    assert _metric("encoder_busy_share.rotation", run) == pytest.approx(25.0)
    assert _metric("host_copy_gbps.rotation", run) == pytest.approx(1e9 / 0.5 / 1e9)


@pytest.mark.parametrize("metric", ["frame_encode_ms.rotation", "encoder_busy_share.rotation",
                                    "host_copy_gbps.rotation"])
def test_the_rotation_readers_read_nothing_where_spans_are_missing(metric, buffer):
    copy = [("Memcpy DtoH (Device -> Pageable)", 101.1, 101.4)]
    short = _rotation(buffer, device=copy, writes=3)
    assert (_metric(metric, short) is None) == (metric != "host_copy_gbps.rotation")
    buffer.clear()
    run = _rotation(buffer, device=[("k", 100.0, 100.1)])
    # no device-to-host copy in the trace, or no trace
    assert (_metric(metric, run) is None) == (metric == "host_copy_gbps.rotation")
    untraced = _run("poisson-saturne.rotation-png", run.rec, 4, None)
    assert (_metric(metric, untraced) is None) == (metric == "host_copy_gbps.rotation")


def test_covered_seconds():
    busy = [[0.0, 1.0], [2.0, 3.0], [5.0, 6.0]]
    assert program_spans.covered_s(busy, [(0.5, 2.5), (3.0, 5.0), (-1.0, 7.0), (7.0, 8.0)]) \
        == pytest.approx([1.0, 0.0, 3.0, 0.0])


READABLE = {"poisson-saturne.still": ["png_filter_ms.still", "png_deflate_ms.still",
                                      "render_launch_ms.still"],
            "solar-sail.still": ["png_filter_ms.still", "png_deflate_ms.still",
                                 "render_launch_ms.still"],
            "poisson-saturne.rotation-png": ["frame_encode_ms.rotation",
                                             "encoder_busy_share.rotation"]}


@pytest.mark.parametrize("workload", sorted(READABLE))
def test_a_tiny_traced_run_reads_the_program_spans(workload, tiny, monkeypatch):
    """The CPU-readable metrics read values, the device-trace ones nothing
    (no card), and every program span of the window lies inside a harness
    span once on the trace's clock, to 0.1 ms."""
    bench, root = tiny
    runs = []
    make = harness.Run

    def keep(*args, **kwargs):
        runs.append(make(*args, **kwargs))
        return runs[-1]

    monkeypatch.setattr(harness, "Run", keep)
    profiling.clear_spans()
    try:
        res = measure(bench, root, workload, trace=True)
        assert res["correct"] is True
        for name in READABLE[workload]:
            assert res["metrics"][name]["value"] > 0, name
        assert "render_idle_ms.still" not in res["metrics"]
        assert "host_copy_gbps.rotation" not in res["metrics"]
        if workload.endswith("rotation-png"):
            assert res["metrics"]["encoder_busy_share.rotation"]["value"] <= 100.0
        run = runs[0]
        spans = program_spans.fetch(run)
        offset = program_spans.trace_offset(run)
        assert spans and offset is not None
        harness_spans = run.trace.spans
        for s, (start, end) in zip(spans, program_spans.on_trace(spans, offset)):
            assert any(hs - 1e-4 <= start and end <= he + 1e-4 for _, hs, he in harness_spans), \
                s.name
            assert s.item is not None
    finally:
        profiling.clear_spans()
