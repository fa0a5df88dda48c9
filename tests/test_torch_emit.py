"""PyTorch port, map + emit: the plain twin of the CUDA map+emit kernel
against the JAX package on the CPU.

JAX runs eagerly here (``jax.disable_jit()``): XLA's CPU ``jit`` fuses the
Sprott multiply-add chain into FMAs, so a jitted step rounds differently
from numpy, eager torch and the no-FMA CUDA kernel, while the eager step
agrees with them bit for bit. The port's twin is held to that eager step,
bit for bit.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strange_attractor_tpu import presets as jpresets
from strange_attractor_tpu.config import BinStrategy
from strange_attractor_tpu.oracle import oracle_trajectory
from strange_attractor_tpu.ops.projection import camera_params as jcamera_params
from strange_attractor_tpu.render import _step_fn
from strange_attractor_tpu_torch.convert import config_from_reference
from strange_attractor_tpu_torch.ops import emit


def _lanes(seed: int, n: int = 2048) -> np.ndarray:
    """(3, n) lane states: points near the attractor, a wide random spread,
    and escaped lanes (NaN, +-inf, huge) that exercise the NaN-at-(0, 0)
    and out-of-bounds paths."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 0.6, (3, n)).astype(np.float32)
    pts[:, : n // 8] = rng.normal(0, 30, (3, n // 8))
    special = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, 0.0], np.float32)
    m = max(1, n // 32)
    for k in range(3):
        pts[k, -m:] = rng.choice(special, m)
    return pts


def _assert_same_floats(got: np.ndarray, want: np.ndarray):
    """Bit-equal floats, except that a NaN's sign and payload are free (XLA
    and torch propagate different NaN bits; nothing downstream reads them)."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.uint32)[~nan], want.view(np.uint32)[~nan])


def _jax_steps(jcfg, pts: np.ndarray, steps: int, angle: float,
               strategy: BinStrategy = BinStrategy.PACKED):
    """``steps`` chained eager JAX ``_step_fn`` steps -> (*streams, pts):
    (flat, packed) for PACKED, (flat, z) for DEPTH, (flat, z, val) for
    EXACT planes."""
    cam = jcamera_params(jcfg.view, 0.0, jcfg.width, jcfg.height)
    step = _step_fn(jcfg, cam, strategy)
    x, y, z = (jnp.asarray(pts[k]) for k in range(3))
    carry = (x, y, z, x, y, z, jnp.zeros(pts.shape[1], jnp.int32),
             jnp.float32(np.cos(angle)), jnp.float32(np.sin(angle)))
    rows = []
    with jax.disable_jit():
        for _ in range(steps):
            carry, emitted = step(carry, None)
            rows.append([np.asarray(e) for e in emitted])
    out = np.stack([np.asarray(c) for c in carry[:3]])
    return (*(np.concatenate(s) for s in zip(*rows)), out)


@pytest.mark.parametrize("preset,size,angle", [
    ("poisson-saturne", (1920, 1080), 0.0),
    ("poisson-saturne", (320, 180), 0.7),
    ("solar-sail", (640, 360), 0.0),
    ("lorenz", (320, 180), 0.0),
    ("rossler", (640, 360), 0.4),
    ("halvorsen", (320, 180), 0.0),
    ("aurora-veil", (640, 360), 0.0),
    ("orchid-ribbon", (320, 180), 1.1),
    ("delta-kite", (1920, 1080), 0.0),
])
def test_steps_bit_exact_vs_eager_jax(preset, size, angle):
    """Every preset but thomas, whose sine is the port's own
    (test_torch_attractors.py bounds its step)."""
    jcfg = jpresets.by_name(preset, width=size[0], height=size[1])
    pts = _lanes(size[0])
    want_f, want_p, want_pts = _jax_steps(jcfg, pts, 3, angle)
    spec = emit.emit_spec(config_from_reference(jcfg), angle)
    got_pts = torch.from_numpy(pts.copy())
    got_f, got_p = emit.map_emit_plain(spec, got_pts, 3)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    np.testing.assert_array_equal(got_p.numpy().view(np.uint32), want_p)
    _assert_same_floats(got_pts.numpy(), want_pts)
    # the escaped lanes really reached the NaN-at-(0, 0) bin
    assert (got_f.numpy() == 0).any()


def test_warmup_bit_exact_vs_oracle_trajectory():
    jcfg = jpresets.poisson_saturne()
    seeds = (np.random.default_rng(8).random((16, 3)) * 0.1).astype(np.float32)
    want = np.stack([oracle_trajectory(jcfg, s, 100)[-1] for s in seeds])
    pts = torch.from_numpy(np.ascontiguousarray(seeds.T))
    assert emit.map_emit_plain(emit.emit_spec(config_from_reference(jcfg), 0.0),
                               pts, 100, emit=False) is None
    np.testing.assert_array_equal(pts.numpy().T.view(np.uint32), want.view(np.uint32))


def test_stream_is_step_major():
    cfg = config_from_reference(jpresets.poisson_saturne(width=64, height=36))
    spec = emit.emit_spec(cfg, 0.0)
    pts = torch.from_numpy(_lanes(9, 8))
    one_by_one = pts.clone()
    flat, packed = emit.map_emit_plain(spec, pts, 4)
    for s in range(4):
        f, p = emit.map_emit_plain(spec, one_by_one, 1)
        assert torch.equal(flat[s * 8:(s + 1) * 8], f)
        assert torch.equal(packed[s * 8:(s + 1) * 8], p)


def test_wrapper_runs_plain_twin_on_cpu_without_launching():
    spec = emit.emit_spec(config_from_reference(jpresets.solar_sail(width=96, height=54)),
                          math.radians(30))
    a, b = torch.from_numpy(_lanes(10, 64)), torch.from_numpy(_lanes(10, 64))
    before = emit.map_emit.launches
    got = emit.map_emit(spec, a, 5)
    want = emit.map_emit_plain(spec, b, 5)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert emit.map_emit.launches == before
