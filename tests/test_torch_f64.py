"""PyTorch port, the float64 compute path (``Config.dtype="float64"``)
against the JAX package's numpy oracle and its x64 render on the CPU.

Short horizon: with injected float64 seeds the port's planes equal
``oracle_render(..., dtype=np.float64)`` bit for bit (tolerance 0): the
map, rotation, projection, color transform and bounds check run in float64
on both sides, and z and the value are cast to float32 where the JAX
package's ``_finish_emit`` casts them. Thomas' sine is the port's own
``sin_f64``, held within 2 ulp of ``np.sin``, so its step is held within a
stated ulp bound instead. The JAX package's float64 render needs
``jax_enable_x64``, which must not leak into this process (the rest of the
suite runs float32 JAX), so that comparison runs in a subprocess, at the
bar of ``tests/test_f64.py`` (agreement >= 0.999 on visited pixels).
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from strange_attractor_tpu import presets as jpresets
from strange_attractor_tpu.ops.binning import pack_zv as jpack
from strange_attractor_tpu.oracle import oracle_points, oracle_render
import strange_attractor_tpu_torch as sat
from strange_attractor_tpu_torch.convert import config_from_reference
from strange_attractor_tpu_torch.models import attractors as ta
from strange_attractor_tpu_torch.models.transforms import sqrt_ieee
from strange_attractor_tpu_torch.ops import emit
from strange_attractor_tpu_torch.render import auto_frames_per_batch, frame_generator

REPO = Path(__file__).resolve().parents[1]
B = sat.BinStrategy


def _short(preset: str):
    jcfg = jpresets.by_name(preset, width=64, height=36, lanes=4, chunk_steps=16,
                            iterations=4 * 16 * 2, warmup=100, dtype="float64")
    seeds = np.random.default_rng(17).random((4, 3)) * 0.1
    return jcfg, seeds


@pytest.mark.parametrize("strategy", [B.KERNEL, B.PACKED])
@pytest.mark.parametrize("preset", ["poisson-saturne", "solar-sail", "lorenz"])
def test_short_horizon_packed_bit_exact_vs_f64_oracle(preset, strategy):
    jcfg, seeds = _short(preset)
    cfg = config_from_reference(jcfg).replace(bin_strategy=strategy)
    assert cfg.dtype == "float64"
    state = sat.render_seeds(cfg, torch.from_numpy(seeds))
    oc, _, _ = oracle_render(jcfg, seeds, steps_per_lane=32, dtype=np.float64)
    want_pk = np.zeros(64 * 36 + 1, np.uint32)
    for s in seeds:
        pts = oracle_points(jcfg, s, 32, np.float64)
        z2 = np.where(np.isnan(pts["z2"]), -np.inf, pts["z2"]).astype(np.float32)
        pk = np.asarray(jpack(z2, pts["value"].astype(np.float32)))
        np.maximum.at(want_pk, np.where(pts["flat"] < 0, 64 * 36, pts["flat"]), pk)
    count = state.count.numpy().view(np.uint32)
    assert count.sum() == oc.sum() > 0
    np.testing.assert_array_equal(count, oc)
    assert preset != "solar-sail" or count[0, 0] > 0
    np.testing.assert_array_equal(state.packed.numpy().view(np.uint32).ravel(), want_pk[:-1])


@pytest.mark.parametrize("strategy", [B.EXACT_KERNEL, B.EXACT])
@pytest.mark.parametrize("preset", ["poisson-saturne", "solar-sail", "lorenz"])
def test_short_horizon_exact_bit_exact_vs_f64_oracle(preset, strategy):
    """count, steps and zbuf equal the float64 oracle's; the planes are
    float32, as in the JAX package (tests/test_f64.py)."""
    jcfg, seeds = _short(preset)
    cfg = config_from_reference(jcfg).replace(bin_strategy=strategy)
    state = sat.render_seeds(cfg, torch.from_numpy(seeds))
    oc, os_, oz = oracle_render(jcfg, seeds, steps_per_lane=32, dtype=np.float64)
    assert state.steps.dtype == state.zbuf.dtype == torch.float32
    np.testing.assert_array_equal(state.count.numpy().view(np.uint32), oc.astype(np.uint32))
    np.testing.assert_array_equal(state.steps.numpy(), os_)
    np.testing.assert_array_equal(state.zbuf.numpy(), oz)
    assert oc.sum() > 0 and (oz > -1.0).any()


@pytest.mark.parametrize("preset", ["poisson-saturne", "solar-sail", "lorenz", "rossler",
                                    "halvorsen", "delta-kite"])
def test_f64_step_bit_exact_vs_step_numpy(preset):
    """One float64 step of each map equals the JAX package's numpy step."""
    jatt = jpresets.by_name(preset).attractor
    att = config_from_reference(jpresets.by_name(preset)).attractor
    p = np.random.default_rng(3).normal(0, 1.5, (512, 3))
    want = jatt.step_numpy(p)
    got = np.stack([t.numpy() for t in att.step_xyz(*torch.from_numpy(p.T.copy()))], 1)
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def _ulp64(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.abs(got - want) / np.spacing(np.maximum(np.abs(want), 1.0))


def test_thomas_f64_step_within_ulp_of_step_numpy():
    """Thomas in float64 through sin_f64: a step within 2 ulp of
    max(|v|, 1) of the JAX package's numpy step (np.sin)."""
    jatt = jpresets.thomas().attractor
    att = config_from_reference(jpresets.thomas()).attractor
    p = np.random.default_rng(5).uniform(-4, 4, (4096, 3))
    want = jatt.step_numpy(p)
    got = np.stack([t.numpy() for t in att.step_xyz(*torch.from_numpy(p.T.copy()))], 1)
    assert _ulp64(got, want).max() <= 2.0


def test_sin_f64_against_numpy_sine():
    """Within 2 ulp of np.sin for |x| <= 8 (a dense grid, both zero signs
    and the quarter periods); NaN for inf and NaN."""
    x = np.concatenate([np.linspace(-8.0, 8.0, 400_001),
                        np.arange(-5, 6) * (np.pi / 2), [0.0, -0.0, 1e-300]])
    got = ta.sin_f64(torch.from_numpy(x)).numpy()
    want = np.sin(x)
    err = np.abs(got - want) / np.spacing(np.abs(want))
    assert err[want != 0].max() <= 2.0
    assert (got[want == 0] == 0).all()
    special = ta.sin_f64(torch.tensor([np.inf, -np.inf, np.nan], dtype=torch.float64))
    assert torch.isnan(special).all()


def test_sqrt_ieee_f64_is_correctly_rounded():
    """torch's CPU float64 sqrt is not correctly rounded (it differs from
    numpy's on ~0.7% of these inputs); sqrt_ieee equals numpy's on all."""
    x = np.random.default_rng(0).random(200_000) * 4.0
    assert (sqrt_ieee(torch.from_numpy(x)).numpy() == np.sqrt(x)).all()
    assert sqrt_ieee(torch.from_numpy(x)).dtype == torch.float64


def test_f64_seeds_and_constants():
    """Seed points are drawn in float64 (53-bit uniforms times 0.1); the
    kernel's float64 launch constants are the host's float64 values."""
    cfg = sat.presets.lorenz(dtype="float64", width=64, height=36)
    seeds = emit.seed_points(8, frame_generator(cfg.replace(seed=2), 0), torch.float64)
    assert seeds.dtype == torch.float64 and ((seeds >= 0) & (seeds < 0.1)).all()
    assert (seeds.numpy() != seeds.numpy().astype(np.float32)).any()
    spec = emit.emit_spec(cfg, 0.3)
    p64, p32 = spec.params64, spec.params
    assert p64.mc[2] == 8.0 / 3.0 != p32.mc[2]
    assert (p64.h, p64.hh, p64.h6) == (0.005, 0.0025, 0.005 / 6.0)
    assert p64.cos_v == math.cos(0.3) and p32.cos_v == float(np.float32(math.cos(0.3)))


def test_config_dtype_is_checked_and_carried():
    with pytest.raises(ValueError, match="dtype"):
        sat.presets.poisson_saturne(dtype="float16")
    jcfg = jpresets.solar_sail(dtype="float64", reseed_lanes=True)
    cfg = config_from_reference(jcfg)
    assert cfg.dtype == "float64" and cfg.reseed_lanes
    assert config_from_reference(jpresets.solar_sail()).dtype == "float32"
    with pytest.raises(ValueError, match="float64"):
        sat.render_seeds(cfg.replace(width=8, height=8, lanes=4, iterations=64),
                         torch.zeros(4, 3))


@pytest.mark.parametrize("strategy", [B.KERNEL, B.DEPTH_KERNEL, B.EXACT_KERNEL])
def test_f64_shared_frames_equal_render_seeds(strategy):
    """The float64 shared stream's frames equal render_seeds of the same
    seeds at each angle, bit for bit, with and without reseeding."""
    for reseed in (False, True):
        cfg = sat.presets.solar_sail(width=48, height=27, iterations=6000, lanes=32,
                                     chunk_steps=40, warmup=60, seed=8, dtype="float64",
                                     bin_strategy=strategy, reseed_lanes=reseed,
                                     render=(sat.RenderKind.DEPTH
                                             if strategy == B.DEPTH_KERNEL else sat.RenderKind.GAS))
        seeds = emit.seed_points(32, frame_generator(cfg, 0), torch.float64)
        angles = np.radians([0.0, 131.0])
        frames = sat.render_seeds_shared(cfg, seeds, angles, reseed_key=77)
        for f, a in enumerate(angles):
            want = sat.render_seeds(cfg, seeds, angle=float(a), reseed_key=77)
            for name, g in frames[f]._asdict().items():
                if g is not None:
                    assert torch.equal(g, getattr(want, name)), (reseed, f, name)


@pytest.mark.parametrize("reseed", [False, True])
def test_f64_sequence_engines_run_on_cpu(reseed):
    """The three sequence engines render float64 frames, with and without
    reseeding: the per-frame engines frame for frame alike, the shared
    batch's first frame equal to theirs; the batch rule counts the wider
    shared stream."""
    cfg = sat.presets.solar_sail(width=32, height=18, iterations=4000, lanes=32,
                                 chunk_steps=25, warmup=50, seed=1, dtype="float64",
                                 reseed_lanes=reseed)
    a = sat.render_sequence_shared(cfg, [0.0, 40.0], frames_per_batch=2, device="cpu")
    b = sat.render_sequence_batched(cfg, [0.0, 40.0], frames_per_batch=2, device="cpu")
    c = [img for _, img in sat.render_sequence(cfg, 0.0, 80.0, 40.0, device="cpu")]
    assert a.shape == b.shape == (2, 18, 32, 4)
    np.testing.assert_array_equal(a[0], b[0])  # frame 0 of a batch draws the same seeds
    for f in range(2):
        np.testing.assert_array_equal(b[f], c[f])
    big = sat.presets.poisson_saturne(iterations=10**9)
    assert auto_frames_per_batch(big.replace(dtype="float64"), B.KERNEL) < \
        auto_frames_per_batch(big, B.KERNEL)


_WORKER = r'''
import jax

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")

import json
import numpy as np
import torch

from strange_attractor_tpu import presets
from strange_attractor_tpu.config import BinStrategy
from strange_attractor_tpu.render import plan_schedule, render, seed_key
import strange_attractor_tpu_torch as sat
from strange_attractor_tpu_torch.convert import config_from_reference

jcfg = presets.poisson_saturne(
    width=64, height=36, lanes=8, chunk_steps=24, iterations=8 * 24 * 2,
    warmup=100, seed=3, bin_strategy=BinStrategy.EXACT, dtype="float64",
)
key = seed_key(jcfg)
lanes, chunk, nchunks = plan_schedule(jcfg)
seeds = np.asarray(jax.random.uniform(key, (lanes, 3), dtype="float64") * 0.1)
st = render(jcfg, key=key)
cfg = config_from_reference(jcfg).replace(bin_strategy=sat.BinStrategy.EXACT_KERNEL)
ours = sat.render_seeds(cfg, torch.from_numpy(seeds))
count, want = ours.count.numpy().view(np.uint32), np.asarray(st.count)
visited = (count > 0) | (want > 0)
print("RESULT " + json.dumps({
    "agree": float((count == want)[visited].mean()),
    "visited": int(visited.sum()),
    "zbuf_close": bool(np.allclose(ours.zbuf.numpy(), np.asarray(st.zbuf), atol=1e-5)),
    "planes": [str(ours.steps.dtype), str(ours.zbuf.dtype)],
}))
'''


def test_f64_exact_render_matches_jax_x64_render():
    """The port's EXACT_KERNEL float64 render of the JAX render's own
    seeds against that render (JAX under x64, in a subprocess)."""
    proc = subprocess.run([sys.executable, "-c", _WORKER], capture_output=True, text=True,
                          timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert line, proc.stdout[-2000:]
    res = json.loads(line[-1][len("RESULT "):])
    assert res["visited"] > 50, res
    assert res["agree"] >= 0.999, res
    assert res["zbuf_close"], res
    assert res["planes"] == ["torch.float32", "torch.float32"], res
