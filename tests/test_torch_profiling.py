"""The port's profiling helpers (``utils/profiling.py``) and the CLI's
``--profile`` on the CPU: ``RenderProfile`` against the JAX package's class,
and the trace files ``--profile DIR`` writes."""

import json
from pathlib import Path

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
    names = {e.get("name") for e in _trace(tmp_path / "prof")["traceEvents"]}
    # bin_chunk_packed's count and packed updates (the KERNEL bin's twin)
    assert {"aten::bincount", "aten::scatter_reduce"} <= names
    written = sorted(p.name for p in tmp_path.glob("*.png"))
    assert written == (["f.png"] if not argv else ["f0.png", "f1.png"])
