"""The harness's pieces on the CPU: files found by name, a cell added by new
files alone, the metric arithmetic on a canned trace, the result line's
shape, and the refusal to run without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from bench_torch import harness
from bench_torch.trace import Trace, base_name

from .conftest import measure


def test_every_name_resolves_to_its_file():
    bench = harness.load_bench()
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        assert cell.config["name"] == w["config"]
        assert (harness.HERE / "drivers" / f"{cell.traffic['driver']}.py").is_file()
        assert hasattr(cell.driver(), "window")
        for trace in (False, True):
            for m in cell.metrics(bench, trace):
                assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for c in bench["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    with pytest.raises(KeyError):
        harness.find_cell(bench, "no-such.cell")


def test_a_cell_added_by_new_files_alone(tiny):
    bench, root = tiny
    bt = root / "bench_torch"
    # a new configuration, traffic mix and metric, and their entries
    config = json.loads((bt / "configs" / "solar-sail-1800x2000.json").read_text())
    config["cli"][config["cli"].index("-b") + 1] = "-0.3"
    config["reference"]["brightness"]["offset"] = -0.3
    config["name"] = "solar-sail-dim"
    (bt / "configs" / "solar-sail-dim.json").write_text(json.dumps(config))
    traffic = json.loads((bt / "traffic" / "still-1e9.json").read_text())
    traffic["checked_items"] = 1
    (bt / "traffic" / "still-one-check.json").write_text(json.dumps(traffic))
    (bt / "metrics" / "frames_done.still.py").write_text(
        "def read(run):\n    return len(run.rec.items)\n")
    bench["configs"].append({"name": "solar-sail-dim", "source": "test", "reduced": [],
                             "file": "bench_torch/configs/solar-sail-dim.json", "why": "test"})
    bench["workloads"].append({"name": "solar-sail.dim", "config": "solar-sail-dim",
                               "traffic": "still-one-check", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "frames_done.still", "unit": "frames",
                               "better": "higher", "source": "host_clock", "layer": "test",
                               "moves": "frame_s", "workloads": ["solar-sail.dim"]})
    res = measure(bench, root, "solar-sail.dim", trace=True)
    assert res["correct"] is True
    assert res["metrics"]["frames_done.still"]["value"] == res["attempted"] >= 1


def _canned_run(cell, trace, counters, extras=None):
    rec = harness.Recorder(False)
    for i in range(2):
        rec.items.append(harness.Span("item", i, 10.0 * i, 10.0 * i + 4.0))
        rec.spans += [harness.Span("render", i, 10.0 * i, 10.0 * i + 1.0),
                      harness.Span("encode", i, 10.0 * i + 1.0, 10.0 * i + 4.0)]
    info = {"lanes": 4, "chunk_steps": 8, "nchunks": 3, "warmup": 10, "iterations": 96,
            "width": 4, "height": 2, "frames_per_item": 1, "channels": 3, "sample_bytes": 1}
    return harness.Run(cell, 1.5, rec, info, counters, trace, extras or {})


def _metric(name, run):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py", f"m_{name}").read(run)


def test_metric_arithmetic_on_a_canned_trace():
    bench = harness.load_bench()
    cell = harness.find_cell(bench, "poisson-saturne.still")
    device = [("void map_kernel<float, 0>(float*, int, int, EmitParamsT<float>)", 0.0, 0.5),
              ("void map_emit_ilp_kernel<float, 0, 1, false>(float*)", 0.5, 1.5),
              ("bin_packed_kernel(unsigned*, unsigned*, int const*)", 1.0, 2.0),
              ("void tonemap_kernel<unsigned char, 3>(Frame, unsigned char*)", 2.5, 3.0),
              ("Memcpy DtoH (Device -> Pageable)", 3.0, 3.5)]
    spans = [("render", 0.0, 2.0), ("deliver", 2.0, 4.0), ("encode", 4.0, 10.0)]
    trace = Trace(device, spans, (0.0, 10.0))
    assert base_name(device[0][0]) == "map_kernel"
    assert base_name(device[2][0]) == "bin_packed_kernel"
    assert trace.busy_s == pytest.approx(3.0)  # [0, 2] and [2.5, 3.5]
    assert trace.kernel_s(["map_kernel", "map_emit_ilp_kernel"]) == (1.5, 2)
    assert trace.top_ops()[0] == ["map_emit_ilp_kernel", 1.0]
    assert trace.idle_gaps() == [["encode", 6.5], ["deliver", 0.5]]
    run = _canned_run(cell, trace, {"map_emit": 8, "bin_packed": 6},
                      {"distinct_px_per_chunk": [3, 5]})
    assert _metric("idle_share.still", run) == pytest.approx(70.0)
    assert _metric("frame_s", run) == pytest.approx(4.0)
    assert _metric("frame_p95_s", run) == pytest.approx(4.0)
    assert _metric("frame_p95_s.still", run) == pytest.approx(4.0)
    assert _metric("render_iters_per_s.still", run) == pytest.approx(2 * 96 / 2.0)
    assert _metric("png_encode_ms.still", run) == pytest.approx(3000.0)
    # kernel A: 2 frames x (1 warm-up + 3 chunks); bytes and operations at the peaks
    chunk = max((8 * 32 + 24 * 4) / 3.35e12, 124 * 32 / 67e12)
    warm = max(24 * 4 / 3.35e12, 60 * 4 * 10 / 67e12)
    assert _metric("map_emit_roofline.still", run) == pytest.approx(
        100 * 2 * (warm + 3 * chunk) / 1.5)
    # the bin: 8 B a point and 16 B a touched pixel, the mean of the checked chunks
    assert _metric("bin_packed_roofline.still", run) == pytest.approx(
        100 * 6 * (8 * 32 + 16 * 4) / 3.35e12 / 1.0)
    # a launch count other than the bound's: no reading
    assert _metric("map_emit_roofline.still", _canned_run(cell, trace, {"map_emit": 7})) is None
    assert _metric("bin_packed_roofline.still", _canned_run(cell, trace, {"bin_packed": 6})) \
        is None
    assert _metric("idle_share.still", _canned_run(cell, None, {})) is None
    report = harness.host_report(run.rec, {"proc_cpu_s": 1.0}, {"proc_cpu_s": 3.5})
    assert report.splitlines()[:2] == [
        "span render: n 2 mean 1000.00 median 1000.00 p95 1000.00 max 1000.00 ms",
        "span encode: n 2 mean 3000.00 median 3000.00 p95 3000.00 max 3000.00 ms"]
    assert report.splitlines()[2] == "host over the window: proc_cpu_s 2.5"


def test_result_line_shape(tiny, monkeypatch, capsys):
    bench, root = tiny
    monkeypatch.setattr(harness, "require_cards", lambda chips: torch.device("cpu"))
    monkeypatch.setattr(harness, "cache_environment", lambda root: None)
    monkeypatch.setattr(harness, "power_limit", lambda: None)
    rc = harness.main(["--workload", "poisson-saturne.still", "--seed", "4294967311",
                       "--seconds", "0.3", "--trace", "0"], t0=0.0, root=root)
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"setup_s", "frame_s", "frame_p95_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    names = list(line["checks"])
    assert err.strip().splitlines()[-len(names):] == [
        f"check {n} {line['checks'][n]['value']} limit {line['checks'][n]['limit']}"
        for n in names]


def test_traced_line_carries_the_per_layer_metrics(tiny):
    bench, root = tiny
    res = measure(bench, root, "poisson-saturne.rotation-png", trace=True)
    assert res["correct"] is True
    assert {"engine_frames_per_s.rotation", "write_frames_per_s.rotation"} <= set(
        res["metrics"])
    assert set(res["device"]) >= {"busy_s", "window_s"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_frame_tail_is_per_layer_where_it_spreads_too_widely(tiny):
    bench, root = tiny
    plain = measure(bench, root, "solar-sail.still")
    assert set(plain["metrics"]) == {"setup_s", "frame_s"}
    traced = measure(bench, root, "solar-sail.still", trace=True)
    assert "frame_p95_s.still" in traced["metrics"]
    assert "frame_p95_s.still" not in measure(bench, root, "poisson-saturne.still",
                                              trace=True)["metrics"]


def test_the_run_refuses_to_start_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the run would start")
    env = dict(os.environ, PYTHONPATH=str(harness.ROOT))
    proc = subprocess.run([sys.executable, "-m", "bench_torch.run", "--workload",
                           "poisson-saturne.still", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=harness.ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_sample_is_uniform_and_seeded():
    counts = [0] * 10
    for seed in range(2000):
        sample = harness.Sample(2, seed)
        for i in range(10):
            sample.offer(i, i)
        for i in sample.kept:
            counts[i] += 1
    assert all(abs(c - 400) < 80 for c in counts), counts
    a, b = harness.Sample(2, 7), harness.Sample(2, 7)
    for i in range(10):
        a.offer(i, i)
        b.offer(i, i)
    assert a.kept == b.kept
    assert len(a.kept) == 2
