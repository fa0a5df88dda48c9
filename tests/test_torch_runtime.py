"""PyTorch port, what a user sees of a render's run and of its state beside
the JAX package on the CPU: the progress lines of a non-silent render and
``RenderState.set_width_height`` with the shape error that names it."""

import re

import numpy as np
import pytest
import torch

from strange_attractor_tpu import presets as jpresets, render as jrender
from strange_attractor_tpu.config import BinStrategy as JBin
from strange_attractor_tpu.render import plan_schedule as jplan, seed_key
from strange_attractor_tpu.runtime import RenderState as JState
import strange_attractor_tpu_torch as sat
from strange_attractor_tpu_torch.convert import config_from_reference, state_to_numpy

LANES = 4


def _progress(out: str) -> list:
    return re.findall(r"Iteration complete, (\d+) left to go\.", out)


@pytest.mark.parametrize("nchunks,lines", [(10, ["0"]), (128, ["64", "0"]),
                                           (239, ["175", "111", "47"])])
def test_progress_lines_match_jax_render(nchunks, lines, capsys):
    """A line after every full group of min(nchunks, 64) chunks, the last
    one included, and none after the remainder: what the JAX render prints
    after each of its dispatch groups."""
    jcfg = jpresets.by_name("poisson-saturne", width=16, height=9, lanes=LANES, chunk_steps=1,
                            iterations=LANES * nchunks, warmup=10, seed=2, silent=False,
                            bin_strategy=JBin.PACKED)
    assert jplan(jcfg)[2] == nchunks
    jrender(jcfg, key=seed_key(jcfg))
    want = _progress(capsys.readouterr().out)
    cfg = config_from_reference(jcfg)
    assert sat.plan_schedule(cfg) == (LANES, 1, nchunks) and not cfg.silent
    sat.render(cfg, device="cpu")
    got = _progress(capsys.readouterr().out)
    assert want == lines
    assert got == want


@pytest.mark.parametrize("strategy", [sat.BinStrategy.KERNEL, sat.BinStrategy.DEPTH_KERNEL,
                                      sat.BinStrategy.EXACT])
def test_set_width_height_matches_jax(strategy):
    """The same object when the size matches; otherwise a blank state of the
    new size and the same strategy, on the state's own device, as the JAX
    package's ``set_width_height`` (runtime.py:85-94)."""
    state = sat.RenderState.blank((9, 16), strategy, device="cpu")
    for plane in state:
        if plane is not None:
            plane.view(torch.int32).fill_(7)
    assert state.set_width_height(16, 9) is state
    resized = state.set_width_height(20, 6)
    assert resized.shape == (6, 20)
    assert resized.strategy == state.strategy and resized.device == state.device
    jstate = JState.blank((9, 16), JBin(strategy.value)).set_width_height(20, 6)
    assert jstate.strategy.value == resized.strategy.value
    want = {k: np.asarray(v) for k, v in jstate._asdict().items() if v is not None}
    got = state_to_numpy(resized)
    assert got.keys() == want.keys()
    for name, plane in got.items():
        np.testing.assert_array_equal(plane, want[name], err_msg=name)


def test_shape_error_names_set_width_height():
    cfg = sat.presets.poisson_saturne(width=16, height=9, iterations=1000, lanes=LANES,
                                      warmup=10, seed=2)
    state = sat.RenderState.create(cfg.replace(width=20), device="cpu")
    with pytest.raises(ValueError, match=r"set_width_height\(\)"):
        sat.render(cfg, state, device="cpu")
    # the state it names renders
    fitted = state.set_width_height(cfg.width, cfg.height)
    assert fitted.shape == (9, 16)
    assert int(sat.render(cfg, fitted, device="cpu").count.sum()) > 0
