"""The depth still driver and the two PAM cells on the CPU at tiny sizes:
the new cells found by name, the driver's plan, sound runs correct and
broken ones not, the control failing the comparison, and each new reader on
canned runs with its None cases."""

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

DEPTH, ROTATION = "poisson-saturne.depth-pam", "poisson-saturne.rotation-pam"
NEW_METRICS = ("render_launch_ms.depth", "render_idle_ms.depth", "map_emit_roofline.depth",
               "bin_depth_roofline.depth", "tonemap_roofline.depth", "image_write_ms.depth")


def make_depth_tree(root: Path) -> dict:
    """The tiny tree of ``conftest.make_tree`` with the depth configuration
    and both PAM mixes cut to its sizes."""
    bench = make_tree(root)
    bt = root / "bench_torch"
    c = json.loads((harness.HERE / "configs" / "poisson-saturne-depth-1080p.json").read_text())
    _swap(c["cli"], "-w", "48")
    _swap(c["cli"], "-h", "27")
    c["cli"] += ["--lanes", "64", "--chunk-steps", "32"]
    c["reference"]["width"], c["reference"]["height"] = 48, 27
    (bt / "configs" / "poisson-saturne-depth-1080p.json").write_text(json.dumps(c))
    for name, iterations in {"still-1e9-pam": "20000", "rotation-pam": "8000"}.items():
        t = json.loads((harness.HERE / "traffic" / f"{name}.json").read_text())
        _swap(t["cli_options"], "-i", iterations)
        if "cli_subcommand" in t:
            _swap(t["cli_subcommand"], "-e", "12")
            _swap(t["cli_subcommand"], "--frames-per-batch", "2")
        (bt / "traffic" / f"{name}.json").write_text(json.dumps(t))
    return bench


@pytest.fixture
def tiny_depth(tmp_path):
    return make_depth_tree(tmp_path), tmp_path


def _metric(name, run):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                               f"m_{name.replace('.', '_')}").read(run)


def test_the_new_cells_are_found_by_name():
    bench = harness.load_bench()
    depth = harness.find_cell(bench, DEPTH)
    assert depth.config["name"] == "poisson-saturne-depth-1080p"
    assert depth.traffic["driver"] == "depth_still" and "--pam" in depth.traffic["cli_options"]
    assert "--depth" in depth.config["cli"]
    rotation = harness.find_cell(bench, ROTATION)
    assert rotation.config["name"] == "poisson-saturne-1080p"
    assert rotation.traffic["driver"] == "sequence"
    assert rotation.traffic["cli_subcommand"] == harness.find_cell(
        bench, "poisson-saturne.rotation-png").traffic["cli_subcommand"]
    assert {c.chips for c in (depth, rotation)} == {1}
    traced = {m["name"] for m in depth.metrics(bench, True)}
    assert traced == set(NEW_METRICS) | {"render_iters_per_s.still", "idle_share.still"}
    assert {m["name"] for m in depth.metrics(bench, False)} == {"setup_s", "frame_s"}
    assert {m["name"] for m in rotation.metrics(bench, False)} == {"setup_s", "seq_frames_per_s"}
    assert {m["name"] for m in rotation.metrics(bench, True)} == {
        "engine_frames_per_s.rotation", "write_frames_per_s.rotation",
        "frame_encode_ms.rotation", "host_copy_gbps.rotation",
        "project_emit_roofline.rotation", "tonemap_roofline.rotation", "idle_share.rotation"}


def test_the_depth_plan(tiny_depth, tmp_path):
    bench, root = tiny_depth
    cell = harness.find_cell(bench, DEPTH, root / "bench_torch")
    s = cell.driver().plan(harness.Context(cell, torch.device("cpu"), 5, tmp_path))
    assert s.fmt == "pam"
    assert s.info["render"] == "depth" and s.info["bin"] == "depth-kernel"
    assert (s.info["lanes"], s.info["chunk_steps"], s.info["width"], s.info["height"]) == (
        64, 32, 48, 27)
    assert s.info["iterations"] == 64 * 32 * s.info["nchunks"] >= 20000
    assert (s.info["channels"], s.info["sample_bytes"]) == (3, 1)


@pytest.mark.parametrize("workload", [DEPTH, ROTATION])
def test_a_sound_run_is_correct(tiny_depth, workload):
    bench, root = tiny_depth
    res = measure(bench, root, workload)
    assert res["correct"] is True and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())


def test_a_tiny_traced_depth_run_reads_its_cpu_metrics(tiny_depth):
    """On the CPU the span readers read values; the device-trace ones
    nothing (no card)."""
    bench, root = tiny_depth
    res = measure(bench, root, DEPTH, trace=True)
    assert res["correct"] is True
    for name in ("render_launch_ms.depth", "image_write_ms.depth", "render_iters_per_s.still"):
        assert res["metrics"][name]["value"] > 0, name
    for name in ("render_idle_ms.depth", "map_emit_roofline.depth", "bin_depth_roofline.depth",
                 "tonemap_roofline.depth", "idle_share.still"):
        assert name not in res["metrics"]


def _patch_depth_bin(monkeypatch, fn):
    render, config = harness.program("render"), harness.program("config")
    kernel, twin = render._BINS[config.BinStrategy.DEPTH_KERNEL]
    monkeypatch.setitem(render._BINS, config.BinStrategy.DEPTH_KERNEL,
                        (lambda *a, **k: fn(kernel, *a, **k), twin))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "answer_altered"])
@pytest.mark.parametrize("workload", [DEPTH, ROTATION])
def test_a_broken_path_is_not_correct(tiny_depth, monkeypatch, workload, fault):
    bench, root = tiny_depth
    if fault == "answer_altered":
        _alter_answer(monkeypatch)
    elif workload == ROTATION:
        _patch_bin(monkeypatch, _unchanged if fault == "state_unchanged" else _half_left_out)
    elif fault == "state_unchanged":
        _patch_depth_bin(monkeypatch, lambda bin_, zbuf, flat, z: (zbuf,))
    else:
        _patch_depth_bin(monkeypatch, lambda bin_, zbuf, flat, z: bin_(
            zbuf, flat[:flat.shape[0] // 2], z[:flat.shape[0] // 2]))
    res = measure(bench, root, workload)
    assert res["correct"] is False and res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values()), res["checks"]


@pytest.mark.parametrize("workload", [DEPTH, ROTATION])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_the_control_fails_the_comparison(tiny_depth, workload, seed):
    bench, root = tiny_depth
    cell = harness.find_cell(bench, workload, root / "bench_torch")
    numbers = control.control_numbers(cell, seed, "cpu", torch.bfloat16)
    assert control.fails(cell, numbers), numbers
    assert control.control_numbers(cell, seed, "cpu", torch.float32) == dict.fromkeys(numbers, 0)


# --- the readers on canned runs ---------------------------------------------

INFO = {"lanes": 4, "chunk_steps": 8, "nchunks": 3, "warmup": 10, "iterations": 96,
        "width": 4, "height": 2, "frames_per_item": 1, "channels": 3, "sample_bytes": 1,
        "render": "depth", "bin": "depth-kernel", "bin_depth_launches": 6}


def _depth_run(trace, counters=None, extras=None, **info):
    """Two depth frames at [0, 4] and [10, 14] s: render [0, 1], deliver
    [1, 2], encode [2, 4] of each."""
    rec = harness.Recorder(False)
    for i in range(2):
        t = 10.0 * i
        rec.items.append(harness.Span("item", i, t, t + 4.0))
        rec.spans += [harness.Span("render", i, t, t + 1.0),
                      harness.Span("deliver", i, t + 1.0, t + 2.0),
                      harness.Span("encode", i, t + 2.0, t + 4.0)]
    cell = harness.find_cell(harness.load_bench(), DEPTH)
    counters = {"map_emit": 8, "tonemap": 2, "tonemap_stats": 2} if counters is None \
        else counters
    return harness.Run(cell, 1.0, rec, {**INFO, **info}, counters, trace,
                       {"distinct_px_per_chunk": [3, 5]} if extras is None else extras)


def _depth_spans(buffer, *, bin_="depth-kernel", fmt="pam", frames=2):
    for i in range(frames):
        t = 10.0 * i
        launch = _record("render.launch", t + 0.1, t + 0.6, iterations=96)
        buffer.add(_record("render.chunks", t + 0.3, t + 0.6, parent=launch.span_id, chunks=3,
                           launches=6, bin=bin_, emit="depth"))
        buffer.add(launch)
        buffer.add(_record("image.write", t + 2.0, t + 2.5, fmt=fmt))


DEVICE = [("void map_kernel<float, 0>(float*, int, int, EmitParamsT<float>)", 0.0, 0.5),
          ("void map_emit_ilp_kernel<float, 2, 1, false>(float*)", 0.5, 1.5),
          ("bin_depth_kernel(unsigned*, int const*, unsigned const*, long long, unsigned)",
           1.0, 2.0),
          ("void (anonymous namespace)::tonemap_kernel<unsigned char, 3>(Frame, uchar*)",
           2.5, 3.0)]


def test_the_depth_readers_on_canned_runs(buffer):
    _depth_spans(buffer)
    rec = _depth_run(None).rec
    run = _depth_run(_traced(rec, DEVICE))
    assert _metric("render_launch_ms.depth", run) == pytest.approx(500.0)
    assert _metric("image_write_ms.depth", run) == pytest.approx(500.0)
    # kernel A: 2 frames x (1 warm-up + 3 chunks); 97 operations a depth point
    chunk = max((8 * 32 + 24 * 4) / 3.35e12, 97 * 32 / 67e12)
    warm = max(24 * 4 / 3.35e12, 60 * 4 * 10 / 67e12)
    assert _metric("map_emit_roofline.depth", run) == pytest.approx(
        100 * 2 * (warm + 3 * chunk) / 1.5)
    # the bin: 8 B a point and 8 B a touched pixel, the mean of the checked chunks
    assert _metric("bin_depth_roofline.depth", run) == pytest.approx(
        100 * 6 * (8 * 32 + 8 * 4) / 3.35e12 / 1.0)
    # kernel T: 4 B read and 3 B written a pixel, 11 float32 operations
    assert _metric("tonemap_roofline.depth", run) == pytest.approx(
        100 * 2 * max(8 * 7 / 3.35e12, 8 * 11 / 67e12) / 0.5)
    # on the trace's clock the card is busy over all of the first launch and
    # none of the second: 0.5 s idle over two frames
    device = [(n, s + 100.0, e + 100.0) for n, s, e in DEVICE]
    assert _metric("render_idle_ms.depth", _depth_run(_traced(rec, device))) == pytest.approx(
        250.0)


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_the_depth_readers_read_nothing_where_their_bound_does_not_hold(metric, buffer):
    _depth_spans(buffer)
    rec = _depth_run(None).rec
    trace = _traced(rec, [(n, s + 100.0, e + 100.0) for n, s, e in DEVICE])
    assert _metric(metric, _depth_run(trace)) is not None
    untraced = _depth_run(None)
    assert (_metric(metric, untraced) is None) == (metric not in (
        "render_launch_ms.depth", "image_write_ms.depth"))
    broken = {
        "render_launch_ms.depth": lambda: (buffer.clear(), _depth_spans(buffer, bin_="kernel")),
        "render_idle_ms.depth": lambda: (buffer.clear(), _depth_spans(buffer, frames=1)),
        "image_write_ms.depth": lambda: (buffer.clear(), _depth_spans(buffer, fmt="png")),
    }
    if metric in broken:
        broken[metric]()
        assert _metric(metric, _depth_run(trace)) is None
        return
    # a launch count other than the bound's, another render kind, no such kernel
    other = {"map_emit_roofline.depth": {"counters": {"map_emit": 7}},
             "bin_depth_roofline.depth": {"bin_depth_launches": 5},
             "tonemap_roofline.depth": {"counters": {"tonemap": 2, "tonemap_stats": 1}}}[metric]
    assert _metric(metric, _depth_run(trace, **other)) is None
    if metric == "bin_depth_roofline.depth":
        assert _metric(metric, _depth_run(trace, extras={})) is None
        assert _metric(metric, _depth_run(trace, bin_depth_launches=None)) is None
    else:
        assert _metric(metric, _depth_run(trace, render="gas")) is None
    assert _metric(metric, _depth_run(Trace([("k", 100.0, 100.1)], trace.spans,
                                            trace.window))) is None
