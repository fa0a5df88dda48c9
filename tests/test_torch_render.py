"""PyTorch port, the whole slice (seed -> warm-up -> map+emit -> bin ->
colorize) against the JAX package on the CPU, plus state/config carry-over
and the package's import hygiene.

Short horizon: with injected seeds the port's planes equal the numpy oracle
(the reference's own arithmetic) bit for bit -- no float op of the chain is
contracted or approximated on either side. Long horizon: the two packages
draw different seed points (torch.Generator vs jax.random), so renders are
compared statistically, at the tolerances of tests/test_render_oracle.py.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from strange_attractor_tpu import colorize as jcolorize, presets as jpresets, render as jrender
from strange_attractor_tpu.config import BinStrategy as JBin
from strange_attractor_tpu.ops.binning import pack_zv as jpack
from strange_attractor_tpu.oracle import oracle_points, oracle_render
from strange_attractor_tpu.render import plan_schedule as jplan, seed_key
from strange_attractor_tpu.runtime import (RenderState as JState, load_state as jload,
                                           save_state as jsave)
import strange_attractor_tpu_torch as sat
from strange_attractor_tpu_torch import cli
from strange_attractor_tpu_torch.convert import (config_from_reference, state_from_numpy,
                                                 state_to_numpy)

REPO = Path(__file__).resolve().parents[1]


# every preset whose map the numpy oracle computes as the port does: all but
# thomas, whose sine is the port's own (test_torch_attractors.py bounds it)
BIT_EXACT_PRESETS = [p for p in sat.presets.PRESET_NAMES if p != "thomas"]


@pytest.mark.parametrize("strategy", [sat.BinStrategy.KERNEL, sat.BinStrategy.PACKED])
@pytest.mark.parametrize("preset", BIT_EXACT_PRESETS)
def test_short_horizon_bit_exact_vs_oracle(preset, strategy):
    """solar-sail's escaping lanes reach NaN within the warm-up and bin at
    pixel (0, 0) through the whole emission, as in the reference."""
    jcfg = jpresets.by_name(preset, width=64, height=36, lanes=4, chunk_steps=16,
                            iterations=4 * 16 * 2, warmup=100)
    cfg = config_from_reference(jcfg).replace(bin_strategy=strategy)
    seeds = (np.random.default_rng(17).random((4, 3)) * 0.1).astype(np.float32)
    state = sat.render_seeds(cfg, torch.from_numpy(seeds))
    oc, _, _ = oracle_render(jcfg, seeds, steps_per_lane=32)
    want_pk = np.zeros(64 * 36 + 1, np.uint32)
    for s in seeds:
        pts = oracle_points(jcfg, s, 32)
        z2 = np.where(np.isnan(pts["z2"]), -np.inf, pts["z2"]).astype(np.float32)
        pk = np.asarray(jpack(z2, pts["value"]))
        np.maximum.at(want_pk, np.where(pts["flat"] < 0, 64 * 36, pts["flat"]), pk)
    count = state.count.numpy().view(np.uint32)
    assert count.sum() == oc.sum() > 0
    # >= 0.999 is the bar of test_render_oracle.py; the port meets it exactly
    assert (count == oc).mean() >= 0.999
    np.testing.assert_array_equal(count, oc)
    assert preset != "solar-sail" or count[0, 0] > 0
    np.testing.assert_array_equal(state.packed.numpy().view(np.uint32).ravel(), want_pk[:-1])


# XLA's CPU compile of the jitted Halvorsen chunk takes over six minutes, so
# its JAX render runs eagerly, as many points over more lanes and fewer steps
EAGER_JAX = {"halvorsen": dict(lanes=2048, chunk_steps=98, warmup=200)}


@pytest.mark.parametrize("preset", sat.presets.PRESET_NAMES)
def test_long_horizon_statistical_vs_jax_render(preset):
    kw = dict(lanes=128, chunk_steps=125, warmup=1000)
    kw.update(EAGER_JAX.get(preset, {}))
    jcfg = jpresets.by_name(preset, width=96, height=54, iterations=400_000, seed=3,
                            transparent=False, bin_strategy=JBin.PACKED, **kw)
    if preset in EAGER_JAX:
        with jax.disable_jit():
            jstate = jrender(jcfg, key=seed_key(jcfg))
    else:
        jstate = jrender(jcfg, key=seed_key(jcfg))
    want = np.asarray(jax.device_get(jcolorize(jcfg, jstate)))
    cfg = config_from_reference(jcfg).replace(bin_strategy=sat.BinStrategy.KERNEL)
    state = sat.render(cfg, device="cpu")
    got = sat.colorize(cfg, state).numpy()
    mad = np.abs(got[..., :3].astype(np.float64) - want[..., :3]).mean() / 65535.0
    assert mad < 0.035, f"mean abs tone-mapped diff {mad}"
    va, vb = state.count.numpy() != 0, np.asarray(jstate.count) > 0
    overlap = (va & vb).sum() / max(1, (va | vb).sum())
    assert overlap > 0.80, f"support overlap {overlap}"


def test_progressive_render_accumulates_and_keeps_input():
    cfg = sat.presets.poisson_saturne(width=48, height=27, iterations=20_000, lanes=64,
                                      warmup=50, seed=5)
    first = sat.render(cfg, device="cpu")
    snapshot = first.count.clone()
    second = sat.render(cfg, first, device="cpu")
    assert torch.equal(first.count, snapshot)
    lanes, chunk, n = sat.plan_schedule(cfg)
    assert int(second.count.sum()) <= 2 * lanes * chunk * n
    assert int(second.count.sum()) > int(first.count.sum())
    assert not torch.equal(sat.render(cfg, device="cpu").count, second.count)


def test_merge_and_reset_match_jax_on_exact_states():
    """EXACT checkpoints of the JAX package load and merge in the port
    (strict z-test: the nearer value wins, ties keep the first)."""
    from strange_attractor_tpu.runtime import merge as jmerge

    rng = np.random.default_rng(19)
    planes = []
    for _ in range(2):
        zbuf = rng.normal(0, 1, (6, 7)).astype(np.float32)
        zbuf[rng.random((6, 7)) < 0.3] = -1.0
        planes.append(dict(count=rng.integers(0, 2**32, (6, 7), dtype=np.uint64).astype(np.uint32),
                           steps=rng.random((6, 7)).astype(np.float32), zbuf=zbuf))
    planes[1]["zbuf"][0, :3] = planes[0]["zbuf"][0, :3]  # z ties
    want = jmerge(*(JState(**{k: jax.numpy.asarray(v) for k, v in p.items()}) for p in planes))
    got = sat.merge(*(state_from_numpy(p, device="cpu") for p in planes))
    assert got.strategy == sat.BinStrategy.EXACT
    for k, v in state_to_numpy(got).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(want, k)))
    blank = state_to_numpy(got.reset())
    assert not blank["count"].any() and not blank["steps"].any()
    assert (blank["zbuf"] == -1.0).all()


def test_npz_checkpoints_cross_both_ways(tmp_path):
    rng = np.random.default_rng(18)
    count = rng.integers(0, 2**32, (9, 16), dtype=np.uint64).astype(np.uint32)
    packed = rng.integers(0, 2**32, (9, 16), dtype=np.uint64).astype(np.uint32)
    jsave(str(tmp_path / "jax.npz"), JState(count=jax.numpy.asarray(count),
                                            packed=jax.numpy.asarray(packed)))
    st = sat.load_state(str(tmp_path / "jax.npz"), device="cpu")
    assert st.strategy == sat.BinStrategy.PACKED
    np.testing.assert_array_equal(st.count.numpy().view(np.uint32), count)
    np.testing.assert_array_equal(st.packed.numpy().view(np.uint32), packed)
    sat.save_state(str(tmp_path / "torch.npz"), sat.merge(st, st))
    back = jload(str(tmp_path / "torch.npz"))
    assert back.strategy == JBin.PACKED and back.count.dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(back.count), count * np.uint32(2))
    np.testing.assert_array_equal(np.asarray(back.packed), packed)
    arrays = state_to_numpy(st)
    assert set(arrays) == {"count", "packed"} and arrays["count"].dtype == np.uint32
    assert torch.equal(state_from_numpy(arrays, device="cpu").packed, st.packed)


@pytest.mark.parametrize("preset", sat.presets.PRESET_NAMES)
def test_config_from_reference_reproduces_presets(preset):
    ref = jpresets.by_name(preset)
    got, want = config_from_reference(ref), sat.presets.by_name(preset)
    assert got == want
    for it in (1_000, 1_000_000, 10_000_000, 100_000_000, 1_000_000_000):
        # the port's AUTO resolves to KERNEL on every device; JAX does on a TPU
        j = jplan(ref.replace(iterations=it, bin_strategy=JBin.KERNEL))
        assert sat.plan_schedule(want.replace(iterations=it)) == j


def test_import_pulls_in_no_jax():
    code = ("import sys, strange_attractor_tpu_torch, strange_attractor_tpu_torch.cli, "
            "strange_attractor_tpu_torch.convert, strange_attractor_tpu_torch.utils.native; "
            "strange_attractor_tpu_torch.utils.native.get_lib(); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'strange_attractor_tpu.')) or m == 'strange_attractor_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No card, or no package beside it: a non-zero exit and no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py would run for real")
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes((REPO / "chip_smoke.py").read_bytes())
    for script, cwd in ((REPO / "chip_smoke.py", REPO), (alone, tmp_path)):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout


def test_cuda_render_refuses_to_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-fallback error cannot occur")
    cfg = sat.presets.poisson_saturne(width=8, height=8, iterations=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        sat.render(cfg)


@pytest.mark.parametrize("kw", [{"render": sat.RenderKind.DEPTH}, {"reseed_lanes": True},
                                {"bin_strategy": sat.BinStrategy.EXACT}])
def test_unported_options_raise(kw):
    """reseed_lanes is still unported and raises. The Depth render and the
    EXACT strategy, ported since, render on the CPU into their own planes."""
    cfg = sat.presets.poisson_saturne(width=8, height=8, iterations=64, warmup=10, seed=1,
                                      **kw)
    if cfg.reseed_lanes:
        with pytest.raises(NotImplementedError):
            sat.render(cfg, device="cpu")
        return
    state = sat.render(cfg, device="cpu")
    assert state.strategy == cfg.resolved_bin_strategy().planes_kind() != sat.BinStrategy.PACKED
    assert sat.colorize(cfg, state).shape == (8, 8, 4)


def test_cli_single_frame_on_cpu(tmp_path, capsys):
    out = tmp_path / "frame"
    assert cli.main(["-i", "4000", "-w", "32", "-h", "18", "--lanes", "32", "--chunk-steps",
                     "16", "--seed", "1", "-q", "-8", "-b", "-0.25", "--device", "cpu",
                     "-o", str(out)]) == 0
    data = (tmp_path / "frame.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and b"IHDR" in data
    assert "Wrote image" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [["sequence", "-s", "3", "-e", "0"], ["completion"],
                                  ["doctor"], ["--bmp"]])
def test_cli_unported_paths_exit_with_error(argv, capsys):
    """``completion`` and ``doctor`` are not ported; ``sequence`` is, with
    the JAX CLI's parse errors, and BMP needs --8-bit."""
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "not yet ported" in err or "--8-bit" in err or "end must be after start" in err
