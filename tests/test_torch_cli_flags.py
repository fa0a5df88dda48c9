"""PyTorch port, the single-frame CLI's custom-map, palette, checkpoint and
preview flags and the render hooks behind them, against the JAX package on
the CPU: the Config each set of flags builds, the parse errors,
``--save-state`` / ``--load-state``, ``render(on_progress=...)`` and
``merge_all``.
"""

import numpy as np
import pytest
import torch

import jax

from strange_attractor_tpu import (cli as jcli, colorize as jcolorize, presets as jpresets,
                                   render as jrender)
from strange_attractor_tpu.config import BinStrategy as JBin
from strange_attractor_tpu.render import plan_schedule as jplan, seed_key
from strange_attractor_tpu.runtime import load_state as jload
import strange_attractor_tpu_torch as sat
from strange_attractor_tpu_torch import cli
from strange_attractor_tpu_torch.convert import config_from_reference, state_to_numpy

ROW = [f"{v:.2f}" for v in np.linspace(-1.1, 0.9, 10)]
ROW2 = [f"{v:.3f}" for v in np.linspace(0.7, -0.4, 10)]
SMALL = ["-i", "6000", "-w", "24", "-h", "16", "--lanes", "32", "--chunk-steps", "25",
         "--seed", "4", "-q", "-8"]


def _parse(module, argv):
    parser = module.build_parser()
    args = parser.parse_args(argv)
    module._validate(args, parser)
    return module.config_from_args(args)


@pytest.mark.parametrize("argv", [
    ["--coeffs-x", *ROW],
    ["--coeffs-y", *ROW, "--coeffs-z", *ROW2, "-p", "solar-sail"],
    ["-p", "lorenz", "--coeffs-y", *ROW],  # over an RK4 preset the other rows are zero
    ["-p", "delta-kite", "--coeffs-x", *ROW2, "--coeffs-y", *ROW, "--coeffs-z", *ROW],
    ["--camera", "0.1", "-0.2", "0.3"],
    ["-p", "halvorsen", "--rotation-axis", "0.1", "0.2", "-0.3", "1.5"],
    ["--palette", "1,1,.5;.5,1,.5;1,.5,.5"],
    ["-p", "thomas", "--palette", "0,0,0; 1,1,1;", "--camera", "1", "2", "3", "-s", "0.5"],
    ["-p", "rossler", "--depth", "-a", "30", "--rotation-axis", "1", "0", "0", "-0.7",
     "--coeffs-z", *ROW2],
])
def test_flags_build_the_jax_cli_config(argv):
    want = config_from_reference(_parse(jcli, argv))
    assert _parse(cli, argv) == want


@pytest.mark.parametrize("argv", [
    ["--palette", "1,1,2"],
    ["--palette", "1,1,-0.5;0,0,0"],
    ["--palette", "1,1"],
    ["--palette", "1,x,1"],
    ["--palette", "1,1,1;1,1"],
    ["--palette", ";"],
    ["--coeffs-x", "1", "2"],
    ["--camera", "1", "2"],
])
def test_flag_errors_match_jax_cli(argv, capsys):
    errors = []
    for module in (jcli, cli):
        with pytest.raises(SystemExit) as e:
            _parse(module, argv)
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.split("error: ", 1)[1])
    assert errors[1] == errors[0]


def test_save_then_load_state_resumes_like_jax_cli(tmp_path):
    """Two CLI runs, the second resuming the first's checkpoint, give the
    planes of render(cfg, render(cfg)) -- the seeded resume folds the
    accumulated content into its seed, as the JAX package does -- and the
    JAX CLI's two runs give the same kind of state with as many points,
    whose image agrees within the oracle tolerance (the generators differ).
    PACKED planes in both: the JAX package's AUTO picks EXACT off a TPU."""
    argv = [*SMALL, "--bin-strategy", "packed"]
    for module, tag in ((cli, "port"), (jcli, "jax")):
        extra = ["--device", "cpu"] if module is cli else []
        assert module.main([*argv, *extra, "--save-state", str(tmp_path / f"{tag}1.npz"),
                            "-o", str(tmp_path / f"{tag}1")]) == 0
        assert module.main([*argv, *extra, "--load-state", str(tmp_path / f"{tag}1.npz"),
                            "--save-state", str(tmp_path / f"{tag}2.npz"),
                            "-o", str(tmp_path / f"{tag}2")]) == 0
        assert (tmp_path / f"{tag}2.png").exists()
    cfg = _parse(cli, argv)
    first = sat.render(cfg, device="cpu")
    resumed = sat.render(cfg, first, device="cpu")
    for name, want in (("port1", first), ("port2", resumed)):
        got = sat.load_state(str(tmp_path / f"{name}.npz"), device="cpu")
        for k, v in state_to_numpy(want).items():
            np.testing.assert_array_equal(state_to_numpy(got)[k], v, err_msg=f"{name} {k}")
    lanes, chunk, n = sat.plan_schedule(cfg)
    jstate = jload(str(tmp_path / "jax2.npz"))
    port = state_to_numpy(resumed)
    assert set(port) == {k for k, v in jstate._asdict().items() if v is not None}
    executed = 2 * lanes * chunk * n
    assert 0.9 * executed < int(port["count"].sum()) <= executed
    assert 0.9 * executed < int(np.asarray(jstate.count).sum()) <= executed
    assert int(port["count"].sum()) > int(state_to_numpy(first)["count"].sum())
    got = sat.colorize(cfg, resumed).numpy()[..., :3].astype(np.float64)
    want = np.asarray(jax.device_get(jcolorize(_parse(jcli, argv), jstate)))[..., :3]
    assert np.abs(got - want).mean() / 65535.0 < 0.035


def test_preview_every_writes_a_preview(tmp_path, monkeypatch, capsys):
    """A preview image '<name>-preview' beside the frame, written from the
    partial state once the interval has passed, and not announced."""
    clock = iter(range(0, 10**6, 100))
    monkeypatch.setattr(cli.time, "perf_counter", lambda: float(next(clock)))
    out = tmp_path / "frame"
    assert cli.main([*SMALL, "--device", "cpu", "--preview-every", "50", "-o", str(out)]) == 0
    assert (tmp_path / "frame-preview.png").exists() and (tmp_path / "frame.png").exists()
    printed = capsys.readouterr().out
    assert "frame.png" in printed and "frame-preview" not in printed


@pytest.mark.parametrize("nchunks", [10, 128, 239])
def test_on_progress_fires_at_jax_chunk_counts(nchunks):
    """After every dispatch group of min(nchunks, 64) chunks and after the
    remainder, with (done, total) as the JAX render reports them; each
    partial state is a copy that later chunks leave alone, and the last
    equals the returned state."""
    jcfg = jpresets.by_name("poisson-saturne", width=16, height=9, lanes=4, chunk_steps=1,
                            iterations=4 * nchunks, warmup=10, seed=2,
                            bin_strategy=JBin.PACKED)
    assert jplan(jcfg)[2] == nchunks
    want = []
    jrender(jcfg, key=seed_key(jcfg), on_progress=lambda d, t, s: want.append((d, t)))
    got, states = [], []

    def hook(done, total, partial):
        got.append((done, total))
        states.append((partial, partial.count.clone()))

    final = sat.render(config_from_reference(jcfg), on_progress=hook, device="cpu")
    assert got == want
    assert got[-1] == (nchunks, nchunks)
    for partial, snapshot in states:
        assert torch.equal(partial.count, snapshot)
    assert torch.equal(states[-1][0].count, final.count)
    assert torch.equal(states[-1][0].packed, final.packed)
    sums = [int(s.count.sum()) for s, _ in states]
    assert sums == sorted(sums)


def test_merge_all_folds_merge():
    rng = np.random.default_rng(6)
    states = []
    for _ in range(4):
        zbuf = rng.normal(0, 1, (5, 6)).astype(np.float32)
        zbuf[rng.random((5, 6)) < 0.3] = -1.0
        states.append(sat.convert.state_from_numpy(
            dict(count=rng.integers(0, 2**32, (5, 6), dtype=np.uint64).astype(np.uint32),
                 steps=rng.random((5, 6)).astype(np.float32), zbuf=zbuf), device="cpu"))
    want = sat.merge(sat.merge(sat.merge(states[0], states[1]), states[2]), states[3])
    got = sat.merge_all(iter(states))
    for k, v in state_to_numpy(want).items():
        np.testing.assert_array_equal(state_to_numpy(got)[k], v, err_msg=k)
    assert sat.merge_all([states[2]]) is states[2]
    with pytest.raises(ValueError, match="no states"):
        sat.merge_all([])
