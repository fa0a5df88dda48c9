"""The port's numpy oracle (``strange_attractor_tpu_torch/oracle.py``)
against the JAX package's (``strange_attractor_tpu/oracle.py``) on the same
seeds, and against the port's plain twins.

Tolerance 0 (bit-identical planes, streams and tone maps) for every preset
whose map both oracles compute alike; Thomas' sine is the port's own
(ROADMAP C13), so one Thomas step is held to the JAX oracle's within 1 ulp
of max(|v|, 1), and its renders bit for bit to the port's twins instead.
"""

import numpy as np
import pytest
import torch

from strange_attractor_tpu import presets as jpresets
from strange_attractor_tpu.config import RenderKind as JKind
from strange_attractor_tpu.oracle import (oracle_colorize as j_colorize,
                                          oracle_points as j_points,
                                          oracle_render as j_render,
                                          oracle_trajectory as j_trajectory)
import strange_attractor_tpu_torch as sat
from strange_attractor_tpu_torch import oracle
from strange_attractor_tpu_torch.convert import config_from_reference

BIT_EXACT = [p for p in sat.presets.PRESET_NAMES if p != "thomas"]


def _configs(preset: str, kind=JKind.GAS, **kw):
    jcfg = jpresets.by_name(preset, width=64, height=36, lanes=4, chunk_steps=16,
                            iterations=4 * 16 * 2, warmup=100, render=kind, **kw)
    return jcfg, config_from_reference(jcfg)


def _seeds(n: int = 4, dtype=np.float32) -> np.ndarray:
    return (np.random.default_rng(17).random((n, 3)) * 0.1).astype(dtype)


def _same(a: np.ndarray, b: np.ndarray) -> None:
    """Bit-identical arrays (NaN payloads included)."""
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}"))


@pytest.mark.parametrize("kind", [JKind.GAS, JKind.DEPTH])
@pytest.mark.parametrize("preset", BIT_EXACT)
def test_render_and_colorize_bit_identical_to_jax_oracle(preset, kind):
    jcfg, cfg = _configs(preset, kind)
    seeds = _seeds()
    want = j_render(jcfg, seeds, steps_per_lane=32)
    got = oracle.oracle_render(cfg, seeds, steps_per_lane=32)
    for g, w in zip(got, want):
        _same(g, w)
    assert want[0].sum() > 0
    _same(oracle.oracle_colorize(cfg, *got), j_colorize(jcfg, *want))


@pytest.mark.parametrize("preset", ["poisson-saturne", "solar-sail", "lorenz"])
def test_points_and_trajectory_bit_identical_to_jax_oracle(preset):
    """Every stream field of one lane, escaped (NaN) points included, and
    the raw trajectory."""
    jcfg, cfg = _configs(preset)
    seed = _seeds(1)[0]
    want, got = j_points(jcfg, seed, 40), oracle.oracle_points(cfg, seed, 40)
    assert want.keys() == got.keys()
    for key in want:
        _same(np.asarray(got[key]), np.asarray(want[key]))
    _same(oracle.oracle_trajectory(cfg, seed, 50), j_trajectory(jcfg, seed, 50))


def test_float64_render_bit_identical_to_jax_oracle():
    jcfg, cfg = _configs("poisson-saturne", transparent=False)
    seeds = _seeds(dtype=np.float64)
    want = j_render(jcfg, seeds, steps_per_lane=32, dtype=np.float64)
    got = oracle.oracle_render(cfg, seeds, steps_per_lane=32, dtype=np.float64)
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_thomas_step_within_one_ulp_of_jax_oracle(dtype):
    """np.sin and the port's sine differ by an ulp here and there; one step
    from the same points stays within 1 ulp of max(|v|, 1) (ROADMAP C13;
    the float64 sine within 2 ulp of np.sin, test_torch_f64.py)."""
    jcfg, cfg = _configs("thomas")
    rng = np.random.default_rng(5)
    for p in (rng.random((64, 3)) * 8.0 - 4.0).astype(dtype):
        want = j_trajectory(jcfg, p, 1, dtype)[1]
        got = oracle.oracle_trajectory(cfg, p, 1, dtype)[1]
        ulp = np.spacing(np.maximum(np.abs(want), dtype(1.0)))
        assert np.all(np.abs(got.astype(np.float64) - want) <= (2 if dtype is np.float64 else 1)
                      * ulp), (p, got, want)


@pytest.mark.parametrize("preset", sat.presets.PRESET_NAMES)
def test_oracle_equals_the_port_twins(preset):
    """The count planes ``doctor`` compares, at its own short horizon:
    the twins of KERNEL and EXACT_KERNEL equal the oracle bit for bit,
    Thomas included (both run the port's sine)."""
    _, cfg = _configs(preset)
    seeds = _seeds()
    oc, os_, oz = oracle.oracle_render(cfg, seeds, steps_per_lane=32)
    exact = sat.render_seeds(cfg.replace(bin_strategy=sat.BinStrategy.EXACT_KERNEL),
                             torch.from_numpy(seeds))
    packed = sat.render_seeds(cfg, torch.from_numpy(seeds))
    for state in (exact, packed):
        np.testing.assert_array_equal(state.count.numpy().view(np.uint32), oc)
    _same(exact.steps.numpy(), os_)
    _same(exact.zbuf.numpy(), oz)
