"""A benchmark tree at test size: BENCHMARK.json's cells with their
configurations and traffic cut to tiny canvases and iteration counts, the
drivers and metric readers copied as they are. Runs on the CPU, where the
program runs its plain twins."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from bench_torch import harness

# (width, height) of each configuration at test size
CANVASES = {"poisson-saturne-1080p": (48, 27), "solar-sail-1800x2000": (36, 40)}
ITERATIONS = {"still-1e9": "20000", "rotation-png": "8000"}


def _swap(args: list, flag: str, value: str) -> None:
    args[args.index(flag) + 1] = value


def make_tree(root: Path) -> dict:
    """Write the tiny tree under ``root``; returns its BENCHMARK.json."""
    bench = harness.load_bench()
    bt = root / "bench_torch"
    for d in ("drivers", "metrics"):
        shutil.copytree(harness.HERE / d, bt / d)
    (bt / "configs").mkdir()
    (bt / "traffic").mkdir()
    for name, (w, h) in CANVASES.items():
        c = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())
        _swap(c["cli"], "-w", str(w))
        _swap(c["cli"], "-h", str(h))
        c["cli"] += ["--lanes", "64", "--chunk-steps", "32"]
        c["reference"]["width"], c["reference"]["height"] = w, h
        (bt / "configs" / f"{name}.json").write_text(json.dumps(c))
    for name, iterations in ITERATIONS.items():
        t = json.loads((harness.HERE / "traffic" / f"{name}.json").read_text())
        _swap(t["cli_options"], "-i", iterations)
        if "cli_subcommand" in t:
            _swap(t["cli_subcommand"], "-e", "12")
            _swap(t["cli_subcommand"], "--frames-per-batch", "2")
        (bt / "traffic" / f"{name}.json").write_text(json.dumps(t))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


@pytest.fixture
def tiny(tmp_path):
    """(BENCHMARK.json, the tree's root) of a tiny tree in ``tmp_path``."""
    return make_tree(tmp_path), tmp_path


def measure(bench, root: Path, workload: str, *, seed: int = 2**31 + 977, trace=False,
            seconds: float = 0.3) -> dict:
    """One run of ``workload`` of the tiny tree on the CPU."""
    import time

    cell = harness.find_cell(bench, workload, root / "bench_torch")
    return harness.measure(cell, seed=seed, seconds=seconds, trace=trace, device="cpu",
                           t0=time.perf_counter(), bench=bench)
