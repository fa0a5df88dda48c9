"""PyTorch port, lane reseeding (``Config.reseed_lanes``) against the JAX
package on the CPU.

Bit for bit where both packages are deterministic: the dead-lane test and
the new ages equal ``_reseed_dead_lanes``' (tolerance 0), and with the same
lane ages the emission gate's streams equal eager JAX's ``_step_fn`` /
``_finish_emit`` and ``_step_fn_shared`` / ``_project_emit`` streams
(tolerance 0; a NaN's sign and payload are free). The fresh points come
from different generators (the port's counter-based Philox4x32-10, JAX's
``jax.random``), so whole renders compare statistically, at the tone-map
tolerances of ``test_torch_render.py``, with the share of points at pixel
(0, 0) of both within a stated bound.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strange_attractor_tpu import (cli as jcli, colorize as jcolorize, presets as jpresets,
                                   render as jrender)
from strange_attractor_tpu.config import BinStrategy as JBin
from strange_attractor_tpu.ops.projection import camera_params as jcamera_params
from strange_attractor_tpu.render import (_project_emit, _reseed_dead_lanes, _step_fn,
                                          _step_fn_shared, seed_key)
import strange_attractor_tpu_torch as sat
from strange_attractor_tpu_torch import cli
from strange_attractor_tpu_torch.convert import config_from_reference
from strange_attractor_tpu_torch.ops import emit
from strange_attractor_tpu_torch.render import frame_generator, seed_generator, seeds_and_key
from test_torch_cli_flags import _parse
from test_torch_emit import _assert_same_floats

B = sat.BinStrategy
KEY = 0x5EED_0000_CAFE_F00D
WARMUP = 50


def _special_lanes(dtype) -> np.ndarray:
    """(lanes, 3) points on both sides of the dead-lane test: +-inf, NaN,
    |x| = 1e3 (alive) and the next float above it (dead), in each
    component, between ordinary finite points."""
    big = np.nextafter(dtype(1e3), dtype(np.inf))
    special = [np.inf, -np.inf, np.nan, 1e3, -1e3, big, -big, 999.5, 0.0, -0.0]
    rng = np.random.default_rng(4)
    pts = rng.normal(0, 2, (64, 3)).astype(dtype)
    for i, v in enumerate(special):
        for k in range(3):
            pts[3 * i + k, k] = v
    return pts


def test_dead_lanes_and_ages_equal_jax():
    """The mask and the new ages of ``reseed_plain`` equal
    ``_reseed_dead_lanes``' bit for bit; live lanes keep their points in
    both, dead ones take fresh points in [0, 0.1)."""
    jcfg = jpresets.solar_sail(warmup=WARMUP, reseed_lanes=True)
    cur = _special_lanes(np.float32)
    age = np.random.default_rng(5).integers(-WARMUP + 1, 2, cur.shape[0]).astype(np.int32)
    with jax.disable_jit():
        _, jcur, _, jage = _reseed_dead_lanes(jcfg, jax.random.PRNGKey(0), jnp.asarray(cur),
                                              jnp.asarray(cur), jnp.asarray(age), jnp.float32)
    jcur, jage = np.asarray(jcur), np.asarray(jage)
    pts, got_age = torch.from_numpy(np.ascontiguousarray(cur.T)), torch.from_numpy(age.copy())
    emit.reseed_plain(pts, emit.Reseed(got_age, KEY, 3, WARMUP))
    np.testing.assert_array_equal(got_age.numpy(), jage)
    dead = jage == -WARMUP
    assert dead.sum() == 3 * 5  # inf, -inf, NaN and the two floats past 1e3, each component
    _assert_same_floats(pts.numpy().T[~dead], cur[~dead])
    _assert_same_floats(jcur[~dead], cur[~dead])
    for fresh in (pts.numpy().T[dead], jcur[dead]):
        assert ((fresh >= 0) & (fresh < np.float32(0.1))).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dead_lane_test_is_the_jax_rule(dtype):
    """In both compute dtypes: dead iff a component is not finite or
    max |component| > 1e3 (the JAX package's expression, in numpy)."""
    cur = _special_lanes(dtype)
    want = ~np.isfinite(cur).all(axis=-1) | (np.abs(cur).max(axis=-1) > dtype(1e3))
    age = torch.zeros(cur.shape[0], dtype=torch.int32)
    emit.reseed_plain(torch.from_numpy(np.ascontiguousarray(cur.T)),
                      emit.Reseed(age, KEY, 0, WARMUP))
    np.testing.assert_array_equal(age.numpy() == -WARMUP, want)


def _escaping_lanes(n: int = 256) -> tuple:
    """(3, n) live lanes (finite, |x| <= 1e3, so the reseed keeps them)
    of which about a third escape to inf and NaN within a few steps, and
    ages from -WARMUP to 1."""
    rng = np.random.default_rng(11)
    pts = rng.normal(0, 0.6, (3, n)).astype(np.float32)
    far = rng.random(n) < 0.35
    pts[:, far] = (rng.choice([-1, 1], (3, far.sum())) * rng.uniform(50, 999, (3, far.sum())))
    age = np.where(rng.random(n) < 0.5, rng.integers(-WARMUP, -3, n),
                   rng.integers(-3, 2, n)).astype(np.int32)
    return pts.astype(np.float32), age


def _jax_fused(jcfg, pts, age, steps, angle, strategy):
    cam = jcamera_params(jcfg.view, 0.0, jcfg.width, jcfg.height)
    step = _step_fn(jcfg, cam, strategy)
    x, y, z = (jnp.asarray(pts[k]) for k in range(3))
    carry = (x, y, z, x, y, z, jnp.asarray(age), jnp.float32(np.cos(angle)),
             jnp.float32(np.sin(angle)))
    rows = []
    with jax.disable_jit():
        for _ in range(steps):
            carry, emitted = step(carry, None)
            rows.append([np.asarray(e) for e in emitted])
    return [np.concatenate(s) for s in zip(*rows)], np.asarray(carry[6])


@pytest.mark.parametrize("kind", [B.PACKED, B.DEPTH, B.EXACT])
def test_gated_streams_equal_eager_jax(kind):
    """The fused stream of gated lanes equals eager JAX ``_step_fn`` with
    the same ages, bit for bit, and so do the ages after; gated NaN points
    go to npix, live ones flood pixel (0, 0)."""
    jcfg = jpresets.solar_sail(width=320, height=180, warmup=WARMUP, reseed_lanes=True)
    pts, age = _escaping_lanes()
    angle, steps = 0.3, 6
    want, want_age = _jax_fused(jcfg, pts, age, steps, angle, JBin(kind.value))
    spec = emit.emit_spec(config_from_reference(jcfg), angle)
    got_age = torch.from_numpy(age.copy())
    got = emit.map_emit_plain(spec, torch.from_numpy(pts.copy()), steps, kind=kind,
                              reseed=emit.Reseed(got_age, KEY, 0, WARMUP))
    np.testing.assert_array_equal(got_age.numpy(), want_age)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    for g, w in zip(got[1:], want[1:]):
        _assert_same_floats(g.numpy().view(np.float32), w.view(np.float32))
    # escaped points flood pixel (0, 0) ungated; gated, they bin nowhere
    gate = (np.minimum(age[None, :] + np.arange(1, steps + 1)[:, None], 1) > 0).reshape(-1)
    ungated = emit.map_emit_plain(spec, torch.from_numpy(pts.copy()), steps, kind=kind)[0]
    flood = ungated.numpy() == 0
    assert (~gate & flood).any() and (gate & flood).any()
    assert (got[0].numpy()[~gate] == 320 * 180).all()
    assert (got[0].numpy()[gate & flood] == 0).all()


def _jax_shared(jcfg, pts, age, steps, strategy):
    cam = jcamera_params(jcfg.view, 0.0, jcfg.width, jcfg.height)
    step = _step_fn_shared(jcfg, cam, strategy)
    x, y, z = (jnp.asarray(pts[k]) for k in range(3))
    carry = (x, y, z, x, y, z, jnp.asarray(age))
    rows = []
    with jax.disable_jit():
        for _ in range(steps):
            carry, emitted = step(carry, None)
            rows.append(emitted)
    return tuple(jnp.concatenate(s) for s in zip(*rows)), np.asarray(carry[6])


@pytest.mark.parametrize("kind", [B.PACKED, B.DEPTH, B.EXACT])
def test_gated_shared_streams_equal_eager_jax(kind):
    """The shared stream of gated lanes carries JAX's gate as fj = +inf:
    xc, zc, val and every live fj equal eager ``_step_fn_shared``'s, and
    each frame's stream equals ``_project_emit``'s with the gate, bit for
    bit, at three angles."""
    jcfg = jpresets.solar_sail(width=320, height=180, warmup=WARMUP, reseed_lanes=True)
    pts, age = _escaping_lanes()
    steps = 6
    jstreams, jage = _jax_shared(jcfg, pts, age, steps, JBin(kind.value))
    cfg = config_from_reference(jcfg)
    got_age = torch.from_numpy(age.copy())
    shared = emit.map_emit_shared_plain(emit.emit_spec(cfg, 0.0), torch.from_numpy(pts.copy()),
                                        steps, kind=kind,
                                        reseed=emit.Reseed(got_age, KEY, 0, WARMUP))
    np.testing.assert_array_equal(got_age.numpy(), jage)
    gate = np.asarray(jstreams[-1])
    assert len(shared) == len(jstreams) - 1 and (~gate).any()
    for i, (g, w) in enumerate(zip(shared, jstreams[:-1])):
        g, w = g.numpy(), np.asarray(w)
        if i == 2:  # fj
            assert np.isposinf(g[~gate]).all()
            g, w = g[gate], w[gate]
        _assert_same_floats(g, w)
    cam = jcamera_params(jcfg.view, 0.0, jcfg.width, jcfg.height)
    for deg in (0.0, 97.3, 222.5):
        rad = math.radians(deg)
        got = emit.project_emit_plain(emit.emit_spec(cfg, rad), shared, kind=kind)
        with jax.disable_jit():
            want = _project_emit(jcfg, cam, JBin(kind.value), jnp.float32(np.cos(rad)),
                                 jnp.float32(np.sin(rad)), jstreams)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            _assert_same_floats(g.numpy().view(np.float32), np.asarray(w).view(np.float32))
        assert (got[0].numpy()[~gate] == 320 * 180).all()


def _pixel0_share(count) -> float:
    count = np.asarray(count).astype(np.float64)
    return float(count.ravel()[0] / count.sum())


def test_reseeded_solar_sail_statistical_vs_jax_render():
    """solar-sail 96x54 with reseeding against the JAX render: tone-mapped
    MAD < 0.035 and support overlap > 0.80 (test_torch_render.py's bounds),
    and the pixel-0 share of both under 0.01 and within 0.005 of each other
    (without reseeding it is ~0.38 of every chunk)."""
    jcfg = jpresets.solar_sail(width=96, height=54, iterations=400_000, seed=3,
                               transparent=False, bin_strategy=JBin.PACKED, lanes=128,
                               chunk_steps=125, warmup=1000, reseed_lanes=True)
    jstate = jrender(jcfg, key=seed_key(jcfg))
    want = np.asarray(jax.device_get(jcolorize(jcfg, jstate)))
    cfg = config_from_reference(jcfg).replace(bin_strategy=B.KERNEL)
    state = sat.render(cfg, device="cpu")
    got = sat.colorize(cfg, state).numpy()
    mad = np.abs(got[..., :3].astype(np.float64) - want[..., :3]).mean() / 65535.0
    assert mad < 0.035, f"mean abs tone-mapped diff {mad}"
    va, vb = state.count.numpy() != 0, np.asarray(jstate.count) > 0
    overlap = (va & vb).sum() / max(1, (va | vb).sum())
    assert overlap > 0.80, f"support overlap {overlap}"
    ours, theirs = _pixel0_share(state.count.numpy().view(np.uint32)), _pixel0_share(
        jstate.count)
    assert ours < 0.01 and theirs < 0.01 and abs(ours - theirs) < 0.005, (ours, theirs)
    # and a seeded rerun is bit-identical
    again = sat.render(cfg, device="cpu")
    assert torch.equal(again.count, state.count) and torch.equal(again.packed, state.packed)


def test_reseeding_changes_only_escaping_renders():
    """Reseeding a preset whose lanes never escape draws the render key
    but renders the same planes; solar-sail's pixel-0 flood goes (a lane
    is reseeded at a chunk's start, so one that escapes within a chunk
    floods pixel (0, 0) until the chunk ends: short chunks here)."""
    cfg = sat.presets.poisson_saturne(width=48, height=27, iterations=20_000, lanes=64,
                                      warmup=100, seed=5)
    plain, reseeded = (sat.render(cfg.replace(reseed_lanes=r), device="cpu")
                       for r in (False, True))
    assert torch.equal(plain.count, reseeded.count)
    assert torch.equal(plain.packed, reseeded.packed)
    ss = sat.presets.solar_sail(width=48, height=27, iterations=40_000, lanes=64, warmup=100,
                                chunk_steps=25, seed=5)
    off, on = (_pixel0_share(sat.render(ss.replace(reseed_lanes=r), device="cpu")
                             .count.numpy().view(np.uint32)) for r in (False, True))
    assert off > 0.2 and on < 0.05, (off, on)


def test_progressive_reseeded_render_draws_a_new_key():
    """A seeded progressive call continues with its content-keyed
    generator, so the second call's render key differs from the first."""
    cfg = sat.presets.solar_sail(width=48, height=27, iterations=20_000, lanes=64, warmup=100,
                                 seed=5, reseed_lanes=True)
    first = sat.render(cfg, device="cpu")
    second = sat.render(cfg, first, device="cpu")
    assert int(second.count.sum()) > int(first.count.sum())
    key0 = seeds_and_key(cfg, seed_generator(cfg))[1]
    assert seeds_and_key(cfg, seed_generator(cfg, 12345))[1] != key0


def test_cli_reseed_flag_builds_the_jax_cli_config(tmp_path):
    """--reseed-lanes sets Config.reseed_lanes as the JAX CLI's does, and
    the single-frame and sequence paths render with it on the CPU."""
    argv = ["-p", "solar-sail", "--reseed-lanes"]
    assert _parse(cli, argv) == config_from_reference(_parse(jcli, argv))
    assert _parse(cli, argv).reseed_lanes and not _parse(cli, argv[:2]).reseed_lanes
    small = ["-i", "4000", "-w", "32", "-h", "18", "--lanes", "32", "--chunk-steps", "16",
             "--seed", "1", "-q", "-8", "--device", "cpu", *argv]
    assert cli.main([*small, "-o", str(tmp_path / "f")]) == 0
    assert cli.main([*small, "-o", str(tmp_path / "s"), "sequence", "-s", "0", "-e", "2", "-d",
                     "1", "--frames-per-batch", "2", "--orbit", "shared"]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["f.png", "s0.png", "s1.png"]


def test_render_key_follows_the_seed_points():
    """The key is the generator's draw after the seed points: the seeds of
    a reseeded render are a plain render's, and seeds_and_key draws them
    in that order (the key 0 without reseeding)."""
    cfg = sat.presets.solar_sail(width=32, height=18, iterations=4000, lanes=32, seed=9)
    gen = frame_generator(cfg, 4)
    seeds = emit.seed_points(32, gen)
    key = emit.render_key(gen)
    assert torch.equal(seeds, emit.seed_points(32, frame_generator(cfg, 4)))
    assert 0 <= key < 1 << 64 and key != emit.render_key(gen)
    got_seeds, got_key = seeds_and_key(cfg.replace(reseed_lanes=True), frame_generator(cfg, 4))
    assert torch.equal(got_seeds, seeds) and got_key == key
    got_seeds, got_key = seeds_and_key(cfg, frame_generator(cfg, 4))
    assert torch.equal(got_seeds, seeds) and got_key == 0
