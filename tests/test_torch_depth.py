"""PyTorch port, the Depth render: the DEPTH_KERNEL bin, kernel A's DEPTH
emission, the Depth tone map and the ``--depth`` slice, against the JAX
package on the CPU.

The bin is held bit for bit to ``bin_chunk_kernel_depth`` in Pallas
interpret mode (both sides of its pixel-0 flood gate), the tone map to the
eager ``colorize_planes``; the short-horizon render equals the numpy
oracle's z-buffer after the kernel strategies' +-0 canonicalization.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strange_attractor_tpu import colorize as jcolorize, presets as jpresets, render as jrender
from strange_attractor_tpu.config import BinStrategy as JBin, RenderKind as JKind
from strange_attractor_tpu.ops import colorize as jc, kernel_binning as kb
from strange_attractor_tpu.oracle import oracle_render
from strange_attractor_tpu.render import seed_key
from strange_attractor_tpu.runtime import (RenderState as JState, load_state as jload,
                                           save_state as jsave)
import strange_attractor_tpu_torch as sat
from strange_attractor_tpu_torch import cli
from strange_attractor_tpu_torch.convert import config_from_reference
from strange_attractor_tpu_torch.ops import (binning as tb, colorize as tc, emit,
                                             kernel_binning as tk)
from strange_attractor_tpu_torch.runtime import progressive_nonce
from test_torch_emit import _jax_steps, _lanes
from test_torch_exact import CASES, NPIX, _stream


def _standing_zbuf(rng, npix: int = NPIX) -> np.ndarray:
    """A non-blank plane: sentinels, -0.0 and +0.0 bands, and exact ties
    with the 'ties' stream's z values on its 50 hot pixels."""
    zbuf = rng.normal(0, 0.5, npix).astype(np.float32)
    zbuf[rng.random(npix) < 0.3] = -1.0
    zbuf[:50] = (rng.integers(-2, 3, 50) * 0.25).astype(np.float32)
    zbuf[50:80] = -0.0
    zbuf[80:100] = 0.0
    return zbuf


def _jax_depth(zbuf, chunk, section=1 << 10):
    flat, z, _ = chunk
    (out,) = kb.bin_chunk_kernel_depth(jnp.asarray(zbuf), jnp.asarray(flat), jnp.asarray(z),
                                       npix=zbuf.shape[0], section=section, interpret=True)
    return np.asarray(out)


def _port_depth(fn, zbuf, chunk):
    flat, z, _ = chunk
    (out,) = fn(torch.from_numpy(zbuf.copy()), torch.from_numpy(flat), torch.from_numpy(z))
    return out.numpy()


def _bits(a):
    return a.view(np.uint32)


@pytest.mark.parametrize("case", CASES)
def test_bin_chunk_depth_matches_jax_kernel(case):
    chunk = _stream(case, np.random.default_rng(40))
    blank = np.full(NPIX, -1.0, np.float32)
    want = _jax_depth(blank, chunk)
    np.testing.assert_array_equal(_bits(_port_depth(tb.bin_chunk_depth, blank, chunk)),
                                  _bits(want))


def test_three_depth_chunks_onto_a_standing_plane():
    """A standing -0.0 loses to a new +0.0 (mono-u32 max), a standing +0.0
    keeps against a new -0.0, exact ties keep the value."""
    rng = np.random.default_rng(41)
    zbuf = _standing_zbuf(rng)
    chunks = [_stream(c, rng) for c in ("ties", "special", "flood")]
    want, got = zbuf, zbuf
    for chunk in chunks:
        want = _jax_depth(want, chunk)
        got = _port_depth(tb.bin_chunk_depth, got, chunk)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    flat = np.array([50, 80], np.int32)
    z = np.array([0.0, -0.0], np.float32)
    out = _port_depth(tb.bin_chunk_depth, zbuf, (flat, z, None))
    assert _bits(out)[50] == 0 and _bits(out)[80] == 0


def test_depth_wrapper_runs_the_plain_twin_on_cpu_without_launching():
    chunk = _stream("random", np.random.default_rng(42))
    blank = np.full(NPIX, -1.0, np.float32)
    before = tk.bin_chunk_kernel_depth.launches
    np.testing.assert_array_equal(_bits(_port_depth(tk.bin_chunk_kernel_depth, blank, chunk)),
                                  _bits(_port_depth(tb.bin_chunk_depth, blank, chunk)))
    assert tk.bin_chunk_kernel_depth.launches == before


@pytest.mark.parametrize("preset,size", [("poisson-saturne", (1920, 1080)),
                                         ("solar-sail", (640, 360))])
def test_depth_emission_full_float_bits_vs_eager_jax(preset, size):
    """Kernel A's DEPTH mode emits (flat, z): every float32 bit of z equals
    JAX's eager ``_step_fn`` stream, NaN z as -inf."""
    jcfg = jpresets.by_name(preset, width=size[0], height=size[1])
    pts = _lanes(size[1] + 1)
    want_f, want_z, _ = _jax_steps(jcfg, pts, 3, 0.0, JBin.DEPTH)
    spec = emit.emit_spec(config_from_reference(jcfg), 0.0)
    flat, z = emit.map_emit_plain(spec, torch.from_numpy(pts.copy()), 3,
                                  kind=sat.BinStrategy.DEPTH_KERNEL)
    np.testing.assert_array_equal(flat.numpy(), want_f)
    np.testing.assert_array_equal(_bits(z.numpy()), _bits(want_z))
    assert np.isneginf(z.numpy()).any()


# ------------------------------------------------------------- tone map ---


def _depth_planes(name: str) -> np.ndarray:
    rng = np.random.default_rng(43)
    if name == "random with sentinels":
        zbuf = rng.normal(0.2, 0.5, (54, 96)).astype(np.float32)
        zbuf[rng.random((54, 96)) < 0.4] = -1.0
        zbuf[0, :4] = [-0.0, 0.0, -1.5, 3.0]
    elif name == "all valid, all negative":  # the 0.0 fold start sets zmax
        zbuf = -rng.random((54, 96)).astype(np.float32) * 0.9 - 0.05
    else:
        assert name == "all sentinel"
        zbuf = np.full((54, 96), -1.0, np.float32)
    return zbuf


@pytest.mark.parametrize("name", ["random with sentinels", "all valid, all negative",
                                  "all sentinel"])
def test_depth_tone_map_bit_exact_vs_eager_jax(name):
    jcfg = jpresets.poisson_saturne(render=JKind.DEPTH)
    zbuf = _depth_planes(name)
    with jax.disable_jit():
        want = np.asarray(jc.colorize_planes(jcfg, None, None, jnp.asarray(zbuf)))
    got = tc.colorize_planes(config_from_reference(jcfg), None, None,
                             torch.from_numpy(zbuf)).numpy()
    assert got.dtype == np.uint16 and got.shape == (54, 96, 4)
    np.testing.assert_array_equal(got, want)
    assert (got[..., 3] == 65535).all()
    assert name == "all sentinel" or got[..., 0].max() > 0


def test_depth_state_colorized_as_gas_raises():
    cfg = sat.presets.poisson_saturne(width=8, height=8)
    state = sat.RenderState.create(cfg, sat.BinStrategy.DEPTH, device="cpu")
    with pytest.raises(ValueError, match="DEPTH"):
        sat.colorize(cfg, state)


# ---------------------------------------------------------------- slice ---


@pytest.mark.parametrize("strategy", [sat.BinStrategy.DEPTH_KERNEL, sat.BinStrategy.DEPTH])
@pytest.mark.parametrize("preset", ["poisson-saturne", "solar-sail", "lorenz", "rossler"])
def test_short_horizon_depth_render_equals_oracle(preset, strategy):
    """zbuf equals the oracle's after +-0 canonicalization (the reference's
    float test keeps a first -0.0; the kernel strategies store +0.0)."""
    jcfg = jpresets.by_name(preset, width=64, height=36, lanes=4, chunk_steps=16,
                            iterations=4 * 16 * 2, warmup=100)
    seeds = (np.random.default_rng(44).random((4, 3)) * 0.1).astype(np.float32)
    cfg = config_from_reference(jcfg).replace(render=sat.RenderKind.DEPTH, bin_strategy=strategy)
    state = sat.render_seeds(cfg, torch.from_numpy(seeds))
    assert state.strategy == sat.BinStrategy.DEPTH and state.count is None
    _, _, oz = oracle_render(jcfg, seeds, steps_per_lane=32)
    np.testing.assert_array_equal(_bits(state.zbuf.numpy()), _bits(oz + np.float32(0.0)))
    assert (oz > -1.0).any()


@pytest.mark.parametrize("preset", ["poisson-saturne", "solar-sail"])
def test_long_horizon_depth_statistical_vs_jax_render(preset):
    jcfg = jpresets.by_name(preset, width=96, height=54, iterations=400_000, lanes=128,
                            chunk_steps=125, warmup=1000, seed=3, transparent=False,
                            render=JKind.DEPTH, bin_strategy=JBin.DEPTH)
    jstate = jrender(jcfg, key=seed_key(jcfg))
    want = np.asarray(jax.device_get(jcolorize(jcfg, jstate)))
    cfg = config_from_reference(jcfg).replace(bin_strategy=sat.BinStrategy.AUTO)
    assert cfg.resolved_bin_strategy() == sat.BinStrategy.DEPTH_KERNEL
    state = sat.render(cfg, device="cpu")
    got = sat.colorize(cfg, state).numpy()
    mad = np.abs(got[..., :3].astype(np.float64) - want[..., :3]).mean() / 65535.0
    assert mad < 0.035, f"mean abs tone-mapped diff {mad}"
    va, vb = state.zbuf.numpy() != -1.0, np.asarray(jstate.zbuf) != -1.0
    overlap = (va & vb).sum() / max(1, (va | vb).sum())
    assert overlap > 0.80, f"support overlap {overlap}"


def test_progressive_depth_render_continues_from_the_zbuf_bits():
    """A DEPTH state has no count: the progressive nonce is the u32 sum of
    its zbuf bits, and the second call adds new samples."""
    cfg = sat.presets.poisson_saturne(width=48, height=27, iterations=20_000, lanes=64,
                                      warmup=50, seed=5, render=sat.RenderKind.DEPTH)
    first = sat.render(cfg, device="cpu")
    second = sat.render(cfg, first, device="cpu")
    lit = lambda s: int((s.zbuf != -1.0).sum())  # noqa: E731
    assert lit(second) > lit(first) and (second.zbuf >= first.zbuf).all()
    bits = first.zbuf.numpy().view(np.uint32).astype(np.uint64).sum() & 0xFFFFFFFF
    assert progressive_nonce(first) == int(bits)


# ------------------------------------------------------- carry-over, CLI ---


def test_depth_npz_states_cross_both_ways(tmp_path):
    zbuf = _standing_zbuf(np.random.default_rng(45)).reshape(36, 64)
    jsave(str(tmp_path / "jax.npz"), JState(zbuf=jnp.asarray(zbuf)))
    st = sat.load_state(str(tmp_path / "jax.npz"), device="cpu")
    assert st.strategy == sat.BinStrategy.DEPTH
    np.testing.assert_array_equal(_bits(st.zbuf.numpy()), _bits(zbuf))
    sat.save_state(str(tmp_path / "torch.npz"), st)
    back = jload(str(tmp_path / "torch.npz"))
    assert back.strategy == JBin.DEPTH and back.count is None
    np.testing.assert_array_equal(_bits(np.asarray(back.zbuf)), _bits(zbuf))


@pytest.mark.parametrize("strategy", ["auto", "depth", "exact-kernel", "exact16-kernel"])
def test_cli_depth_writes_a_png(strategy, tmp_path):
    out = tmp_path / "depth"
    assert cli.main(["--depth", "-i", "4000", "-w", "32", "-h", "18", "--lanes", "32",
                     "--chunk-steps", "16", "--seed", "1", "-q", "-8", "--device", "cpu",
                     "--bin-strategy", strategy, "-o", str(out)]) == 0
    data = (tmp_path / "depth.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and b"IHDR" in data


@pytest.mark.parametrize("argv", [["--bin-strategy", "depth-kernel"], ["--bin-strategy", "depth"],
                                  ["--depth", "--bin-strategy", "kernel"],
                                  ["--depth", "--bin-strategy", "packed"]])
def test_cli_strategy_depth_mismatch_exits_2(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    assert "--bin-strategy" in capsys.readouterr().err
