"""PyTorch port, the sequence engines' call signature against the JAX
package's, on the CPU.

The JAX engines take a ``key`` after ``angles_deg`` (after ``step_deg`` in
``render_sequence``); the port takes a ``torch.Generator`` in that place.
A positional call must mean the same in both packages; without a
generator the frames stay what they were (pinned by hash); a generator
replaces ``config.seed`` as the base of the frames' seeds, its first draw,
as ``parallel.mesh`` takes a base from a generator.
"""

import hashlib
import math

import numpy as np
import pytest
import torch

import strange_attractor_tpu as jsat
import strange_attractor_tpu_torch as sat
from strange_attractor_tpu_torch.render import draw_base, frame_generator
from strange_attractor_tpu_torch.utils.export import convert_format

ENGINES = ("render_sequence_batched", "render_sequence_shared")
# frames of the config below without a generator, before the generator
# slot existed: the first 16 digits of the sha256 of the three frames of
# :func:`_frames`
PINNED = {"render_sequence_batched": "62cd0cf4f4aef76d",
          "render_sequence_shared": "056e4d13a7dc7962",
          "render_sequence": "af08864377d3a872"}


def _cfg(**kw):
    return sat.presets.poisson_saturne(width=32, height=18, iterations=20_000, seed=3, **kw)


def _digest(frames: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(frames).tobytes()).hexdigest()[:16]


def _frames(name: str, cfg, generator=None) -> np.ndarray:
    """Three frames at 0, 10 and 20 degrees from engine ``name``: 8-bit
    opaque, two a batch, or ``render_sequence``'s uint16 RGBA."""
    if name == "render_sequence":
        return np.stack([img for _, img in sat.render_sequence(cfg, 0.0, 30.0, 10.0, generator,
                                                               device="cpu")])
    return getattr(sat, name)(cfg, [0.0, 10.0, 20.0], generator, frames_per_batch=2,
                              transparent=False, eight_bit=True, device="cpu")


def _seeded(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("name", ENGINES + ("render_sequence",))
def test_positional_call_matches_jax(name):
    """``(cfg, angles, None, 2, False)`` reads 2 as frames a batch and False
    as ``transparent`` in both packages: (2, 18, 32, 3) uint16."""
    jcfg = jsat.presets.poisson_saturne(width=32, height=18, iterations=20_000, seed=3)
    if name == "render_sequence":
        want = [img for _, img in jsat.render_sequence(jcfg, 0, 20, 10, None)]
        got = [img for _, img in sat.render_sequence(_cfg(), 0, 20, 10, None, device="cpu")]
        assert [(g.shape, g.dtype) for g in got] == [(w.shape, w.dtype) for w in want]
        assert len(got) == 2 and got[0].shape == (18, 32, 4)
        return
    want = getattr(jsat, name)(jcfg, [0, 10], None, 2, False)
    got = getattr(sat, name)(_cfg(), [0, 10], None, 2, False, device="cpu")
    assert got.shape == want.shape == (2, 18, 32, 3)
    assert got.dtype == want.dtype == np.uint16


@pytest.mark.parametrize("name", ENGINES + ("render_sequence",))
def test_no_generator_keeps_the_seeded_frames(name):
    assert _digest(_frames(name, _cfg())) == PINNED[name]


@pytest.mark.parametrize("name", ENGINES + ("render_sequence",))
def test_equal_generators_give_equal_frames(name):
    a = _frames(name, _cfg(), _seeded(11))
    np.testing.assert_array_equal(a, _frames(name, _cfg(), _seeded(11)))
    assert not np.array_equal(a, _frames(name, _cfg(), _seeded(12)))


@pytest.mark.parametrize("name", ENGINES + ("render_sequence",))
def test_generator_wins_over_the_seed(name):
    """With a generator, ``config.seed`` (set, other, or None) plays no
    part: frame ``i`` draws from ``frame_generator(config, i, base)``,
    ``base`` the generator's first draw."""
    got = _frames(name, _cfg(), _seeded(11))
    for seed in (9, None):
        np.testing.assert_array_equal(_frames(name, _cfg().replace(seed=seed), _seeded(11)), got)
    assert not np.array_equal(got, _frames(name, _cfg()))
    base = draw_base(_seeded(11))
    cfg = _cfg()
    # a shared batch's first frame is the per-frame engine's
    for i in ((0, 2) if name == "render_sequence_shared" else (0, 1, 2)):
        frame = sat.render_frame(cfg, frame_generator(cfg, i, base),
                                 angle=math.radians(10.0 * i), device="cpu")
        if name != "render_sequence":
            frame = convert_format(frame, False, True)
        np.testing.assert_array_equal(got[i], frame)
