"""PyTorch port, device defaults: every entry point that makes planes puts
them on the card unless the caller asks for the CPU, and a render refuses a
state that lies elsewhere than where it was asked to run. On a machine
without CUDA the card default raises instead of running the plain twins.
"""

import numpy as np
import pytest
import torch

import strange_attractor_tpu_torch as sat
from strange_attractor_tpu_torch.runtime import resolve_device, state_from_numpy


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the card default does not raise")


def _cfg(**kw):
    return sat.presets.poisson_saturne(width=24, height=16, iterations=2_000, lanes=32,
                                       chunk_steps=16, warmup=20, seed=4, **kw)


def _planes():
    rng = np.random.default_rng(23)
    return {"count": rng.integers(0, 50, (16, 24), dtype=np.uint64).astype(np.uint32),
            "packed": rng.integers(0, 2**32, (16, 24), dtype=np.uint64).astype(np.uint32)}


@pytest.mark.parametrize("make", ["load_state", "state_from_numpy", "create", "blank"])
def test_state_makers_default_to_the_card(make, tmp_path):
    """Without ``device`` each maker asks for the card, and raises here."""
    _no_card()
    cfg = _cfg()
    path = tmp_path / "state.npz"
    sat.save_state(str(path), state_from_numpy(_planes(), device="cpu"))
    calls = {"load_state": lambda: sat.load_state(str(path)),
             "state_from_numpy": lambda: state_from_numpy(_planes()),
             "create": lambda: sat.RenderState.create(cfg),
             "blank": lambda: sat.RenderState.blank((16, 24), sat.BinStrategy.KERNEL)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[make]()


@pytest.mark.parametrize("make", ["load_state", "state_from_numpy", "create", "blank"])
def test_state_makers_put_planes_on_the_cpu_when_asked(make, tmp_path):
    cfg = _cfg()
    path = tmp_path / "state.npz"
    sat.save_state(str(path), state_from_numpy(_planes(), device="cpu"))
    state = {"load_state": lambda: sat.load_state(str(path), device="cpu"),
             "state_from_numpy": lambda: state_from_numpy(_planes(), device="cpu"),
             "create": lambda: sat.RenderState.create(cfg, device="cpu"),
             "blank": lambda: sat.RenderState.blank((16, 24), sat.BinStrategy.KERNEL,
                                                    device="cpu")}[make]()
    assert state.device == torch.device("cpu") and state.strategy == sat.BinStrategy.PACKED
    assert state.shape == (16, 24)


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_render_refuses_a_state_on_another_device(device, tmp_path):
    """A resumed checkpoint on the CPU does not quietly render there: the
    ValueError names both devices."""
    cfg = _cfg()
    sat.save_state(str(tmp_path / "state.npz"), sat.render(cfg, device="cpu"))
    state = sat.load_state(str(tmp_path / "state.npz"), device="cpu")
    kw = {} if device is None else {"device": device}
    with pytest.raises(ValueError, match=r"cpu.*cuda"):
        sat.render(cfg, state, **kw)


def test_render_resumes_a_cpu_checkpoint_when_asked(tmp_path):
    cfg = _cfg()
    first = sat.render(cfg, device="cpu")
    sat.save_state(str(tmp_path / "state.npz"), first)
    resumed = sat.render(cfg, sat.load_state(str(tmp_path / "state.npz"), device="cpu"),
                         device="cpu")
    again = sat.render(cfg, first, device="cpu")
    assert resumed.device == torch.device("cpu")
    assert torch.equal(resumed.count, again.count) and torch.equal(resumed.packed, again.packed)
    assert int(resumed.count.sum()) > int(first.count.sum())


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")
