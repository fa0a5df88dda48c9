"""The EXACT still driver and the two cells of the reference-faithful still
and the per-frame rotation on the CPU at tiny sizes: the new cells found by
name, the driver's plan and its counter, sound runs correct and broken ones
not, the controls failing the comparison, and each new reader on canned runs
with its None cases."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from bench_torch import control, harness
from bench_torch.trace import Trace

from .conftest import _swap, make_tree, measure
from .test_faults import _alter_answer, _half_left_out, _patch_bin, _unchanged
from .test_program_spans import _record, _traced, buffer  # noqa: F401  (a fixture)

EXACT, PERFRAME = "poisson-saturne.exact-pam", "poisson-saturne.rotation-perframe"
NEW_METRICS = ("bin_exact_roofline.exact", "map_emit_roofline.exact", "render_launch_ms.exact",
               "map_emit_roofline.perframe")


def make_exact_tree(root: Path) -> dict:
    """The tiny tree of ``conftest.make_tree`` with the EXACT configuration
    and both new mixes cut to its sizes."""
    bench = make_tree(root)
    bt = root / "bench_torch"
    c = json.loads((harness.HERE / "configs" / "poisson-saturne-exact-1080p.json").read_text())
    _swap(c["cli"], "-w", "48")
    _swap(c["cli"], "-h", "27")
    c["cli"] += ["--lanes", "64", "--chunk-steps", "32"]
    c["reference"]["width"], c["reference"]["height"] = 48, 27
    (bt / "configs" / "poisson-saturne-exact-1080p.json").write_text(json.dumps(c))
    for name, iterations in {"still-1e9-pam-exact": "20000",
                             "rotation-perframe-pam": "8000"}.items():
        t = json.loads((harness.HERE / "traffic" / f"{name}.json").read_text())
        _swap(t["cli_options"], "-i", iterations)
        if "cli_subcommand" in t:
            _swap(t["cli_subcommand"], "-e", "12")
            _swap(t["cli_subcommand"], "--frames-per-batch", "2")
        (bt / "traffic" / f"{name}.json").write_text(json.dumps(t))
    return bench


@pytest.fixture
def tiny_exact(tmp_path):
    return make_exact_tree(tmp_path), tmp_path


def _metric(name, run):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               f"m_{name.replace('.', '_')}").read(run)


def test_the_new_cells_are_found_by_name():
    bench = harness.load_bench()
    exact = harness.find_cell(bench, EXACT)
    assert exact.config["name"] == "poisson-saturne-exact-1080p"
    assert exact.traffic["driver"] == "exact_still"
    assert exact.traffic["cli_options"] == harness.find_cell(
        bench, "poisson-saturne.depth-pam").traffic["cli_options"]
    assert exact.config["cli"][exact.config["cli"].index("--bin-strategy") + 1] \
        == "exact-kernel"
    perframe = harness.find_cell(bench, PERFRAME)
    assert perframe.config["name"] == "poisson-saturne-1080p"
    assert perframe.traffic["driver"] == "perframe_sequence"
    pam = harness.find_cell(bench, "poisson-saturne.rotation-pam").traffic
    assert perframe.traffic["cli_options"] == pam["cli_options"]
    assert perframe.traffic["cli_subcommand"] == pam["cli_subcommand"][:-1] + ["per-frame"]
    assert {c.chips for c in (exact, perframe)} == {1}
    assert {m["name"] for m in exact.metrics(bench, False)} == {"setup_s", "frame_s"}
    assert {m["name"] for m in exact.metrics(bench, True)} == {
        "bin_exact_roofline.exact", "map_emit_roofline.exact", "render_launch_ms.exact",
        "render_iters_per_s.still", "idle_share.still"}
    assert {m["name"] for m in perframe.metrics(bench, False)} == {"setup_s",
                                                                    "seq_frames_per_s"}
    assert {m["name"] for m in perframe.metrics(bench, True)} == {
        "engine_frames_per_s.rotation", "write_frames_per_s.rotation",
        "frame_encode_ms.rotation", "host_copy_gbps.rotation",
        "host_copy_pinned_share.rotation", "tonemap_roofline.rotation",
        "idle_share.rotation", "map_emit_roofline.perframe"}


def test_the_exact_plan(tiny_exact, tmp_path):
    bench, root = tiny_exact
    cell = harness.find_cell(bench, EXACT, root / "bench_torch")
    s = cell.driver().plan(harness.Context(cell, torch.device("cpu"), 5, tmp_path))
    assert s.fmt == "pam"
    assert s.info["render"] == "gas" and s.info["bin"] == "exact-kernel"
    assert (s.info["lanes"], s.info["chunk_steps"], s.info["width"], s.info["height"]) == (
        64, 32, 48, 27)
    assert s.info["iterations"] == 64 * 32 * s.info["nchunks"] >= 20000
    assert (s.info["channels"], s.info["sample_bytes"]) == (3, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_perframe_reference_is_the_sequence_drivers(tiny_exact, tmp_path, dtype):
    """The per-frame driver's reference, a batch's frames side by side, gives
    ``drivers/sequence.py``'s frame-by-frame images bit for bit."""
    bench, root = tiny_exact
    cell = harness.find_cell(bench, PERFRAME, root / "bench_torch")
    driver = cell.driver()
    s = driver.plan(harness.Context(cell, torch.device("cpu"), 2**31 + 7, tmp_path))
    assert s.args.orbit == "per-frame" and len(s.angles) == 4
    seed = harness.item_seed(s.ctx.seed, 0)
    got = driver.reference_frames(s, seed, dtype)
    assert torch.equal(got, driver.seq.reference_frames(s, seed, dtype))
    assert len({bytes(f.numpy()) for f in got}) == len(got)  # an image of its own a frame


def test_the_perframe_driver_refuses_a_shared_orbit(tiny_exact, tmp_path):
    bench, root = tiny_exact
    cell = harness.find_cell(bench, PERFRAME, root / "bench_torch")
    shared = harness.Cell(cell.name, 1, cell.config, harness.find_cell(
        bench, "poisson-saturne.rotation-png", root / "bench_torch").traffic, cell.root)
    shared.traffic["driver"] = "perframe_sequence"
    with pytest.raises(ValueError, match="per-frame"):
        shared.driver().plan(harness.Context(shared, torch.device("cpu"), 1, tmp_path))


def test_the_driver_counts_the_exact_bin_launches(tiny_exact, tmp_path, monkeypatch):
    """The window's count of ``bin_chunk_kernel_exact`` wrapper launches, or
    None where the program has no such counter."""
    bench, root = tiny_exact
    cell = harness.find_cell(bench, EXACT, root / "bench_torch")
    driver = cell.driver()
    kb = harness.program("ops.kernel_binning")
    s = driver.plan(harness.Context(cell, torch.device("cpu"), 5, tmp_path))
    calls = iter([10, 16])
    monkeypatch.setattr(driver, "_bin_launches", lambda: next(calls))
    monkeypatch.setattr(driver.still, "window", lambda *a: None)
    driver.window(s, 0.0, harness.Recorder(False))
    assert s.info["bin_exact_launches"] == 6
    monkeypatch.setattr(driver, "_bin_launches", lambda: None)
    driver.window(s, 0.0, harness.Recorder(False))
    assert s.info["bin_exact_launches"] is None
    monkeypatch.undo()
    assert isinstance(driver._bin_launches(), int)
    monkeypatch.delattr(kb.bin_chunk_kernel_exact, "launches")
    assert driver._bin_launches() is None


@pytest.mark.parametrize("workload", [EXACT, PERFRAME])
def test_a_sound_run_is_correct(tiny_exact, workload):
    bench, root = tiny_exact
    res = measure(bench, root, workload)
    assert res["correct"] is True and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())


def test_a_tiny_traced_exact_run_reads_its_cpu_metrics(tiny_exact):
    """On the CPU the span readers read values; the device-trace ones
    nothing (no card)."""
    bench, root = tiny_exact
    res = measure(bench, root, EXACT, trace=True)
    assert res["correct"] is True
    for name in ("render_launch_ms.exact", "render_iters_per_s.still"):
        assert res["metrics"][name]["value"] > 0, name
    for name in ("bin_exact_roofline.exact", "map_emit_roofline.exact", "idle_share.still"):
        assert name not in res["metrics"]


def _patch_exact_bin(monkeypatch, fn):
    render, config = harness.program("render"), harness.program("config")
    kernel, twin = render._BINS[config.BinStrategy.EXACT_KERNEL]
    monkeypatch.setitem(render._BINS, config.BinStrategy.EXACT_KERNEL,
                        (lambda *a, **k: fn(kernel, *a, **k), twin))


def _exact_half(bin_, count, steps, zbuf, flat, z, val, **kw):
    n = flat.shape[0] // 2
    return bin_(count, steps, zbuf, flat[:n], z[:n], val[:n], **kw)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered"])
@pytest.mark.parametrize("workload", [EXACT, PERFRAME])
def test_a_broken_path_is_not_correct(tiny_exact, monkeypatch, workload, fault):
    bench, root = tiny_exact
    if fault == "answer_altered":
        _alter_answer(monkeypatch)
        if workload == PERFRAME:
            render = harness.program("render")
            batched = render.render_sequence_batched

            def altered(*a, **k):
                frames = batched(*a, **k).copy()
                frames[..., 0, 0, 0] ^= 0x80
                return frames

            monkeypatch.setattr(render, "render_sequence_batched", altered)
    elif workload == PERFRAME:
        _patch_bin(monkeypatch, _unchanged if fault == "state_unchanged" else _half_left_out)
    elif fault == "state_unchanged":
        _patch_exact_bin(monkeypatch, lambda bin_, count, steps, zbuf, *a, **k: (count, steps,
                                                                                 zbuf))
    else:
        _patch_exact_bin(monkeypatch, _exact_half)
    res = measure(bench, root, workload)
    assert res["correct"] is False and res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values()), res["checks"]


@pytest.mark.parametrize("workload", [EXACT, PERFRAME])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_the_control_fails_the_comparison(tiny_exact, workload, seed):
    bench, root = tiny_exact
    cell = harness.find_cell(bench, workload, root / "bench_torch")
    numbers = control.control_numbers(cell, seed, "cpu", torch.bfloat16)
    assert control.fails(cell, numbers), numbers
    assert control.control_numbers(cell, seed, "cpu", torch.float32) == dict.fromkeys(numbers, 0)


def test_the_quantized_control_fails_the_comparison(tiny_exact, tmp_path):
    """The PACKED planes' 12-bit colour value in the program's place fails
    in ``steps``, and leaves the count and the depths alone."""
    bench, root = tiny_exact
    cell = harness.find_cell(bench, EXACT, root / "bench_torch")
    driver = cell.driver()
    s = driver.plan(harness.Context(cell, torch.device("cpu"), 2**31 + 5, tmp_path))
    numbers = driver.quantized_control(s, 0)
    assert control.fails(cell, numbers), numbers
    assert numbers["steps_px_off"] > 0
    assert numbers["count_px_off"] == numbers["zbuf_px_off"] == 0


# --- the readers on canned runs ---------------------------------------------

INFO = {"lanes": 4, "chunk_steps": 8, "nchunks": 3, "warmup": 10, "iterations": 96,
        "width": 4, "height": 2, "frames_per_item": 1, "channels": 3, "sample_bytes": 1,
        "render": "gas", "bin": "exact-kernel", "bin_exact_launches": 6}


def _exact_run(trace, counters=None, extras=None, **info):
    """Two EXACT frames at [0, 4] and [10, 14] s: render [0, 1], deliver
    [1, 2], encode [2, 4] of each."""
    rec = harness.Recorder(False)
    for i in range(2):
        t = 10.0 * i
        rec.items.append(harness.Span("item", i, t, t + 4.0))
        rec.spans += [harness.Span("render", i, t, t + 1.0),
                      harness.Span("deliver", i, t + 1.0, t + 2.0),
                      harness.Span("encode", i, t + 2.0, t + 4.0)]
    cell = harness.find_cell(harness.load_bench(), EXACT)
    counters = {"map_emit": 8, "tonemap": 2, "tonemap_stats": 2} if counters is None \
        else counters
    return harness.Run(cell, 1.0, rec, {**INFO, **info}, counters, trace,
                       {"distinct_px_per_chunk": [3, 5]} if extras is None else extras)


def _exact_spans(buffer, *, bin_="exact-kernel", frames=2):
    for i in range(frames):
        t = 10.0 * i
        launch = _record("render.launch", t + 0.1, t + 0.6, iterations=96)
        buffer.add(_record("render.chunks", t + 0.3, t + 0.6, parent=launch.span_id, chunks=3,
                           launches=6, bin=bin_, emit="exact"))
        buffer.add(launch)


DEVICE = [("void map_kernel<float, 0>(float*, int, int, EmitParamsT<float>)", 0.0, 0.5),
          ("void map_emit_ilp_kernel<float, 3, 1, false>(float*)", 0.5, 1.5),
          ("void bin_tile::tile_hist_kernel(unsigned int*, int const*, long long, bin_tile::Band)",
           1.0, 1.1),
          ("void bin_tile::tile_column_kernel(bin_tile::Tables, int, int)", 1.1, 1.2),
          ("void bin_tile::tile_scan_kernel(bin_tile::Tables, int)", 1.2, 1.3),
          ("void bin_tile::tile_scatter_kernel<ExactMode>(bin_tile::Control*)", 1.3, 1.7),
          ("void bin_tile::tile_merge_kernel<ExactMode>(unsigned int*)", 1.7, 2.0),
          ("void (anonymous namespace)::tonemap_kernel<unsigned char, 3>(Frame, uchar*)",
           2.5, 3.0)]


def test_the_exact_readers_on_canned_runs(buffer):
    _exact_spans(buffer)
    rec = _exact_run(None).rec
    run = _exact_run(_traced(rec, DEVICE))
    assert _metric("render_launch_ms.exact", run) == pytest.approx(500.0)
    # kernel A: 2 frames x (1 warm-up + 3 chunks); 12 B and 121 operations a point
    chunk = max((12 * 32 + 24 * 4) / 3.35e12, 121 * 32 / 67e12)
    warm = max(24 * 4 / 3.35e12, 60 * 4 * 10 / 67e12)
    assert _metric("map_emit_roofline.exact", run) == pytest.approx(
        100 * 2 * (warm + 3 * chunk) / 1.5)
    # the tile bin's five kernels, 1.0 s in all: 12 B a point and 24 B a
    # touched pixel, the mean of the checked chunks
    assert _metric("bin_exact_roofline.exact", run) == pytest.approx(
        100 * 6 * (12 * 32 + 24 * 4) / 3.35e12 / 1.0)


def _perframe_run(trace, frames=6, map_emit=None):
    """One per-frame sequence of ``frames`` frames: engine [0, 2], write [2,
    10] s."""
    rec = harness.Recorder(False)
    rec.items.append(harness.Span("item", 0, 0.0, 10.0))
    rec.spans += [harness.Span("engine", 0, 0.0, 2.0), harness.Span("write", 0, 2.0, 10.0)]
    cell = harness.find_cell(harness.load_bench(), PERFRAME)
    info = {**INFO, "frames_per_item": frames}
    counters = {"map_emit": frames * 4 if map_emit is None else map_emit}
    return harness.Run(cell, 1.0, rec, info, counters, trace, {})


def test_the_perframe_reader_on_a_canned_run():
    rec = _perframe_run(None).rec
    run = _perframe_run(_traced(rec, DEVICE[:2]))
    # 6 frames x (1 warm-up + 3 chunks); 8 B and 124 operations a point
    chunk = max((8 * 32 + 24 * 4) / 3.35e12, 124 * 32 / 67e12)
    warm = max(24 * 4 / 3.35e12, 60 * 4 * 10 / 67e12)
    assert _metric("map_emit_roofline.perframe", run) == pytest.approx(
        100 * 6 * (warm + 3 * chunk) / 1.5)


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_the_new_readers_read_nothing_where_their_bound_does_not_hold(metric, buffer):
    if metric == "map_emit_roofline.perframe":
        rec = _perframe_run(None).rec
        trace = _traced(rec, [(n, s + 100.0, e + 100.0) for n, s, e in DEVICE])
        assert _metric(metric, _perframe_run(trace)) is not None
        assert _metric(metric, _perframe_run(None)) is None
        # a shared orbit: one warm-up and the chunks a batch, not a frame
        assert _metric(metric, _perframe_run(trace, map_emit=2 * 4)) is None
        assert _metric(metric, _perframe_run(Trace([("k", 100.0, 100.1)], trace.spans,
                                                   trace.window))) is None
        return
    _exact_spans(buffer)
    rec = _exact_run(None).rec
    trace = _traced(rec, [(n, s + 100.0, e + 100.0) for n, s, e in DEVICE])
    assert _metric(metric, _exact_run(trace)) is not None
    untraced = _exact_run(None)
    assert (_metric(metric, untraced) is None) == (metric != "render_launch_ms.exact")
    if metric == "render_launch_ms.exact":
        buffer.clear()
        _exact_spans(buffer, bin_="kernel")
        assert _metric(metric, _exact_run(trace)) is None
        buffer.clear()
        _exact_spans(buffer, frames=1)
        assert _metric(metric, _exact_run(trace)) is None
        return
    # a launch count other than the bound's, another bin, no such kernel
    other = {"map_emit_roofline.exact": {"counters": {"map_emit": 7}},
             "bin_exact_roofline.exact": {"bin_exact_launches": 5}}[metric]
    assert _metric(metric, _exact_run(trace, **other)) is None
    if metric == "bin_exact_roofline.exact":
        assert _metric(metric, _exact_run(trace, extras={})) is None
        assert _metric(metric, _exact_run(trace, bin_exact_launches=None)) is None
    else:
        assert _metric(metric, _exact_run(trace, bin="kernel")) is None
    assert _metric(metric, _exact_run(Trace([("k", 100.0, 100.1)], trace.spans,
                                            trace.window))) is None
