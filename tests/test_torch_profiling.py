"""The port's profiling helpers (``utils/profiling.py``) and the CLI's
``--profile`` on the CPU: ``RenderProfile`` against the JAX package's class,
the trace files ``--profile DIR`` writes, and the port's own spans: none
without a profiler, every span of a frame with its counts under one, the
encoder threads' spans carried from their submitter, the buffer's bound."""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from strange_attractor_tpu.utils.profiling import RenderProfile as JProfile
from strange_attractor_tpu_torch import cli
from strange_attractor_tpu_torch.utils import profiling
from strange_attractor_tpu_torch.utils.profiling import RenderProfile

TINY = ["-i", "4000", "-w", "32", "-h", "18", "--lanes", "32", "--chunk-steps", "16",
        "--seed", "1", "-q", "-8", "--device", "cpu"]


@pytest.mark.parametrize("phases,iterations", [
    ({"render": 0.25, "colorize": 0.0125}, 2_000_000),
    ({"render": 1.0}, 0),
    ({"colorize": 0.5, "copy": 0.125}, 1000),
    ({"render": 0.0}, 10),
    ({}, 5),
])
def test_summary_equals_the_jax_class(phases, iterations):
    got, want = RenderProfile(iterations, dict(phases)), JProfile(iterations, dict(phases))
    assert got.summary() == want.summary()
    assert got.total_seconds == want.total_seconds
    assert got.iters_per_sec == want.iters_per_sec


def test_phase_accumulates_and_survives_an_error():
    prof = RenderProfile(iterations=100)
    for _ in range(2):
        with prof.phase("render"):
            pass
    with pytest.raises(ValueError):
        with prof.phase("colorize"):
            raise ValueError("boom")
    assert list(prof.phases) == ["render", "colorize"]
    assert prof.iters_per_sec == 100 / prof.phases["render"]


def _trace(directory: Path) -> dict:
    files = list(directory.glob("*.pt.trace.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())


def test_trace_writes_chrome_json_even_on_error(tmp_path):
    with pytest.raises(RuntimeError):
        with profiling.trace(tmp_path / "t"):
            torch.ones(8).add_(1)
            raise RuntimeError("stop")
    events = _trace(tmp_path / "t")["traceEvents"]
    assert any(e.get("name") == "aten::add_" for e in events)
    profiling.sync(torch.ones(2))  # a CPU tensor: nothing to wait for


@pytest.mark.parametrize("argv", [[], ["sequence", "-s", "0", "-e", "2", "-d", "1"]])
def test_cli_profile_writes_a_trace(argv, tmp_path):
    """--profile DIR around a single frame and a sequence: one trace file
    that parses as JSON and holds the render's ops, beside the images."""
    out = tmp_path / "f"
    assert cli.main(TINY + ["--profile", str(tmp_path / "prof"), "-o", str(out)] + argv) == 0
    events = _trace(tmp_path / "prof")["traceEvents"]
    names = {e.get("name") for e in events}
    # bin_chunk_packed's count and packed updates (the KERNEL bin's twin)
    assert {"aten::bincount", "aten::scatter_reduce"} <= names
    # the port's spans, encoder threads' included, on the trace's clock: the
    # bins' ops lie inside the chunk loops' spans
    assert len([e for e in events if e.get("name") == "png.deflate"]) == (1 if not argv else 2)
    loops = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("name") == "render.chunks"]
    bins = [e for e in events if e.get("name") == "aten::bincount"]
    assert len(loops) == (1 if not argv else 2) and bins
    assert all(any(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for lo, hi in loops)
               for e in bins)
    assert profiling.spans() == []
    written = sorted(p.name for p in tmp_path.glob("*.png"))
    assert written == (["f.png"] if not argv else ["f0.png", "f1.png"])


# ---------------------------------------------------------------- spans ----

# the render module (the package's ``render`` is the function)
rmod = importlib.import_module("strange_attractor_tpu_torch.render")
# every span of the port
SPANS = {"render.launch", "render.seeds", "render.warmup", "render.chunks", "engine.batch",
         "deliver.tonemap", "deliver.copy", "image.write", "png.filter", "png.deflate",
         "file.write"}


@pytest.fixture
def spans_cleared():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _tiny_config(**kw):
    parser = cli.build_parser()
    args = parser.parse_args(TINY)
    cli._validate(args, parser)
    return cli.config_from_args(args).replace(warmup=16, **kw)


def _by_name(records) -> dict:
    out = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def _idat_length(path: Path) -> int:
    data = path.read_bytes()
    # the signature, IHDR (4 + 4 + 13 + 4 bytes), then the one IDAT chunk
    assert data[37:41] == b"IDAT"
    return int.from_bytes(data[33:37], "big")


@pytest.mark.parametrize("argv", [[], ["sequence", "-s", "0", "-e", "3", "-d", "1",
                                       "--frames-per-batch", "2"]])
def test_no_span_is_recorded_without_a_profiler(argv, tmp_path, monkeypatch, spans_cleared):
    """Off, a whole tiny CLI render records nothing and opens no profiler
    range: a span is the check of the profiler's state alone."""
    def no_range(*args, **kwargs):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert not profiling.recording()
    assert cli.main(TINY + ["-o", str(tmp_path / "f")] + argv) == 0
    assert profiling.spans() == [] and profiling.dropped_spans() == 0
    with profiling.span("test.off", bytes=1) as sp:
        assert sp is None
    assert profiling.spans() == []


def test_a_frame_records_every_span_with_its_counts(tmp_path, spans_cleared):
    """Under a profiler a render, its delivery and its PNG record the spans
    of the table, nested, with the counts taken at each boundary."""
    from strange_attractor_tpu_torch.utils.export import write_image

    config = _tiny_config()
    lanes, chunk_steps, nchunks = rmod.plan_schedule(config)
    with _profiled():
        state = rmod.render(config, None, torch.Generator().manual_seed(3), device="cpu")
        image = rmod.colorize_convert_fetch(config, state, transparent=False, eight_bit=True)
        path = write_image(tmp_path / "f", image, transparent=False, eight_bit=True)
    got = _by_name(profiling.spans())
    assert set(got) == SPANS - {"engine.batch"}
    assert all(len(v) == 1 for v in got.values())
    one = {name: v[0] for name, v in got.items()}
    h, w = config.height, config.width
    assert one["render.launch"].attrs == {"iterations": config.iterations}
    assert one["render.seeds"].attrs == {"lanes": lanes}
    assert one["render.warmup"].attrs == {"steps": 16}
    # the plain twins on the CPU count no launch
    assert one["render.chunks"].attrs == {"chunks": nchunks, "launches": 0}
    assert one["deliver.tonemap"].attrs == {"frames": 1}
    assert one["deliver.copy"].attrs == {"bytes": h * w * 3}
    size = path.stat().st_size
    assert one["image.write"].attrs == {"fmt": "png", "bytes": size}
    assert one["file.write"].attrs == {"bytes": size}
    assert one["png.filter"].attrs["bytes_in"] == h * w * 3
    assert one["png.filter"].attrs["bytes_out"] == h * (1 + w * 3)
    assert one["png.filter"].attrs["native"] in (0, 1)
    assert one["png.deflate"].attrs["bytes_in"] == h * (1 + w * 3)
    assert one["png.deflate"].attrs["bytes_out"] == _idat_length(path)
    assert one["png.deflate"].attrs["threads"] == 1  # under 2 MB: the stdlib's deflate
    parents = {name: r.parent for name, r in one.items()}
    for child in ("render.seeds", "render.warmup", "render.chunks"):
        assert parents[child] == one["render.launch"].span_id
    for child in ("png.filter", "png.deflate", "file.write"):
        assert parents[child] == one["image.write"].span_id
    for top in ("render.launch", "deliver.tonemap", "deliver.copy", "image.write"):
        assert parents[top] is None
    for r in one.values():
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = next(q for q in one.values() if q.span_id == r.parent)
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    assert len({r.span_id for r in one.values()}) == len(one)


@pytest.mark.parametrize("engine,chunks_per_batch", [("render_sequence_shared", 1),
                                                     ("render_sequence_batched", 2)])
def test_a_sequence_batch_records_its_engine_spans(engine, chunks_per_batch, spans_cleared):
    """Each batch of a sequence engine is one ``engine.batch`` holding its
    tone maps and its one host copy; the per-frame engine's renders nest in
    ``deliver.tonemap``, drawn as the loop asks for them."""

    config = _tiny_config(iterations=32 * 16 * 2, seed=5)
    nchunks = rmod.plan_schedule(config)[2]
    with _profiled():
        frames = getattr(rmod, engine)(config, [0.0, 30.0, 60.0], frames_per_batch=2,
                                       transparent=False, eight_bit=True, device="cpu")
    got = _by_name(profiling.spans())
    batches = got["engine.batch"]
    # a shared orbit renders its chunks once a batch, the per-frame engine once a frame
    assert [b.attrs for b in batches] == [{"frames": 2, "chunks": chunks_per_batch * nchunks},
                                          {"frames": 1, "chunks": nchunks}]
    if engine == "render_sequence_shared":
        assert len(got["render.seeds"]) == 2
        assert "render.launch" not in got
    else:
        tonemaps = {t.span_id for t in got["deliver.tonemap"]}
        assert len(got["render.launch"]) == 3
        assert all(r.parent in tonemaps for r in got["render.launch"])
    ids = [b.span_id for b in batches]
    assert [t.attrs for t in got["deliver.tonemap"]] == [{"frames": 2}, {"frames": 1}]
    assert [c.attrs for c in got["deliver.copy"]] == [
        {"bytes": 2 * frames[0].nbytes}, {"bytes": frames[0].nbytes}]
    assert [r.parent for r in got["deliver.copy"]] == ids
    assert [r.parent for r in got["deliver.tonemap"]] == ids


def test_write_frames_records_each_write_on_its_encoder_thread(tmp_path, spans_cleared):
    """``cli._write_frames`` carries the submitting thread's decision to the
    encoder threads: one ``image.write`` a frame, off the submitting
    thread, each with the submitting span as its parent."""
    import threading

    from strange_attractor_tpu_torch.utils.export import write_image

    images = [np.full((6, 5, 3), i, np.uint8) for i in range(7)]
    paths = [tmp_path / f"f{i}" for i in range(7)]

    def write(path, image):
        write_image(path, image, transparent=False, eight_bit=True, announce=False)

    with _profiled():
        with profiling.span("test.submit") as submit:
            cli._write_frames(zip(images, paths), write)
    got = _by_name(profiling.spans())
    writes = got["image.write"]
    assert len(writes) == len(images)
    me = threading.get_native_id()
    assert all(r.thread != me for r in writes)
    assert {r.parent for r in writes} == {submit.span_id}
    assert len(got["png.deflate"]) == len(images)
    assert sorted(p.name for p in tmp_path.glob("*.png")) == sorted(f"f{i}.png" for i in range(7))


def test_the_buffer_keeps_its_bound_under_many_threads(monkeypatch):
    """More recording threads than cores, switching often: the buffer keeps
    exactly its bound and counts every span beyond it as dropped."""
    import sys
    import threading

    buffer = profiling.SpanBuffer(capacity=500)
    monkeypatch.setattr(profiling, "BUFFER", buffer)
    threads, per_thread = 32, 100

    def record():
        for _ in range(per_thread):
            with profiling.span("test.stress", bytes=1):
                pass

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiled():
            work = profiling.carried(record)
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in pool)
    assert len(profiling.spans()) == 500
    assert profiling.dropped_spans() == threads * per_thread - 500
    assert len({r.span_id for r in profiling.spans()}) == 500
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.dropped_spans() == 0
