"""PyTorch port, the EXACT planes: the EXACT_KERNEL and EXACT16_KERNEL bins,
kernel A's EXACT emission and the exact-kernel / exact16-kernel renders,
against the JAX package on the CPU.

The bins are held bit for bit to the JAX entry points in Pallas interpret
mode (``bin_chunk_kernel_exact``, ``bin_chunk_kernel_exact16``) and, where
the reference's sequential loop has the same semantics, to
``oracle.oracle_bin``. The kernel wrappers run their plain twins for CPU
tensors, so these tests pin the twins; the CUDA kernels are held against
the twins on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strange_attractor_tpu import colorize as jcolorize, presets as jpresets, render as jrender
from strange_attractor_tpu.config import BinStrategy as JBin
from strange_attractor_tpu.ops import kernel_binning as kb
from strange_attractor_tpu.oracle import oracle_bin, oracle_points, oracle_render
from strange_attractor_tpu.render import seed_key
import strange_attractor_tpu_torch as sat
from strange_attractor_tpu_torch import cli
from strange_attractor_tpu_torch.convert import config_from_reference
from strange_attractor_tpu_torch.ops import binning as tb, emit, kernel_binning as tk
from test_torch_binning import _SPECIAL
from test_torch_emit import _jax_steps, _lanes

NPIX, N = 64 * 36, 4096


def _stream(case: str, rng, npix: int = NPIX, n: int = N):
    """(flat int32, z float32, val float32): the bin test streams."""
    flat = rng.integers(0, npix, n)
    z = rng.normal(0, 0.5, n).astype(np.float32)
    val = rng.random(n).astype(np.float32)
    if case == "random":
        flat[rng.random(n) < 0.05] = npix
    elif case == "ties":  # 50 hot pixels, a tiny z space, both zero signs
        flat = rng.integers(0, 50, n)
        z = (rng.integers(-2, 3, n) * 0.25).astype(np.float32)
        z[rng.random(n) < 0.2] = -0.0
        val = (rng.integers(0, 8, n) / 8).astype(np.float32)
    elif case == "special":  # +-0, +-inf, NaN, -1.0, subnormals on 64 pixels
        flat = rng.integers(0, 64, n)
        z = rng.choice(_SPECIAL, n)
        val = rng.choice(np.concatenate([_SPECIAL, [65520.0, 6e-8, 0.5]]).astype(np.float32), n)
    elif case.startswith("flood"):
        # "flood": 40% on pixel 0, far past the JAX flood gate (n // 64);
        # "flood-at-gate": exactly n // 64 points there, not evicted
        flat[flat == 0] = 1
        if case == "flood":
            flat[rng.random(n) < 0.4] = 0
        else:
            flat[rng.choice(n, n // 64, replace=False)] = 0
    else:
        assert case == "all-oob"
        flat[:] = npix
    return flat.astype(np.int32), z, val


CASES = ["random", "ties", "special", "flood", "flood-at-gate", "all-oob"]


def _blank(npix: int = NPIX):
    return (np.zeros(npix, np.uint32), np.zeros(npix, np.float32),
            np.full(npix, -1.0, np.float32))


def _standing(rng, npix: int = NPIX):
    """A non-blank EXACT state: random counts and depths, a band of -0.0,
    +0.0 and z values that the 'ties' stream hits exactly."""
    count = rng.integers(0, 1000, npix).astype(np.uint32)
    steps = rng.random(npix).astype(np.float32)
    zbuf = rng.normal(0, 0.5, npix).astype(np.float32)
    zbuf[rng.random(npix) < 0.3] = -1.0
    zbuf[:50] = (rng.integers(-2, 3, 50) * 0.25).astype(np.float32)
    zbuf[50:80] = -0.0
    zbuf[80:100] = 0.0
    return count, steps, zbuf


def _jax_bin(fn, state, chunk, section, **kw):
    flat, z, val = chunk
    out = fn(*(jnp.asarray(p) for p in state), jnp.asarray(flat), jnp.asarray(z),
             jnp.asarray(val), npix=state[0].shape[0], section=section, interpret=True, **kw)
    return tuple(np.asarray(p) for p in out)


def _port_bin(fn, state, chunk, **kw):
    count, steps, zbuf = state
    flat, z, val = chunk
    out = fn(torch.from_numpy(count.view(np.int32).copy()), torch.from_numpy(steps.copy()),
             torch.from_numpy(zbuf.copy()), torch.from_numpy(flat), torch.from_numpy(z),
             torch.from_numpy(val), **kw)
    return out[0].numpy().view(np.uint32), out[1].numpy(), out[2].numpy()


def _assert_planes_bits(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


@pytest.mark.parametrize("case", CASES)
def test_bin_chunk_exact_matches_jax_kernel_and_oracle(case):
    chunk = _stream(case, np.random.default_rng(30))
    want = _jax_bin(kb.bin_chunk_kernel_exact, _blank(), chunk, 1 << 10)
    got = _port_bin(tb.bin_chunk_exact, _blank(), chunk)
    _assert_planes_bits(got, want)
    if case != "special":  # NaN and signed-zero z: the reference's float compare
        flat, z, val = chunk
        oc, os_, oz = oracle_bin(64, 36, np.where(flat == NPIX, -1, flat), z, val)
        np.testing.assert_array_equal(got[0], oc.astype(np.uint32))
        np.testing.assert_array_equal(got[1], os_)
        np.testing.assert_array_equal(got[2], oz)


@pytest.mark.parametrize("ties", ["value", "earliest"])
@pytest.mark.parametrize("case", CASES)
def test_bin_chunk_exact16_matches_jax_kernel(case, ties):
    """Sections of 2^9 points: the 'ties' stream's bucket ties span all
    eight JAX sections of the chunk, and the winner is the min over the
    whole chunk."""
    chunk = _stream(case, np.random.default_rng(31))
    want = _jax_bin(kb.bin_chunk_kernel_exact16, _blank(), chunk, 1 << 9, ties=ties)
    got = _port_bin(tb.bin_chunk_exact16, _blank(), chunk, ties=ties)
    _assert_planes_bits(got, want)


def test_exact16_bucket_tie_across_sections_resolves_over_the_chunk():
    """One pixel, two points of one z bucket 2000 points apart (different
    JAX sections): 'value' keeps the smaller float16 value whichever comes
    first, 'earliest' the first one."""
    z_hi, z_lo = np.float32(0.5 * (1 + 3 / 256)), np.float32(0.5 * (1 + 2.5 / 256))
    flat = np.full(2048, 17, np.int32)
    z = np.full(2048, -2.0, np.float32)
    val = np.zeros(2048, np.float32)
    z[10], val[10] = z_hi, 22.0
    z[2000], val[2000] = z_lo, 11.0
    for ties, want_val in (("value", 11.0), ("earliest", 22.0)):
        want = _jax_bin(kb.bin_chunk_kernel_exact16, _blank(), (flat, z, val), 1 << 10, ties=ties)
        got = _port_bin(tb.bin_chunk_exact16, _blank(), (flat, z, val), ties=ties)
        _assert_planes_bits(got, want)
        assert got[1][17] == want_val and got[0][17] == 2048


@pytest.mark.parametrize("mode", ["exact", "exact16-value", "exact16-earliest"])
def test_three_chunks_onto_a_standing_state(mode):
    """A non-blank standing state with -0.0, +0.0 and exact z ties against
    the stream: the strict merge keeps the standing value on a tie."""
    rng = np.random.default_rng(32)
    state = _standing(rng)
    chunks = [_stream(c, rng) for c in ("ties", "random", "special")]
    if mode == "exact":
        jfn, tfn, kw = kb.bin_chunk_kernel_exact, tb.bin_chunk_exact, {}
    else:
        jfn, tfn, kw = kb.bin_chunk_kernel_exact16, tb.bin_chunk_exact16, {"ties": mode[8:]}
    want, got = state, state
    for chunk in chunks:
        want = _jax_bin(jfn, want, chunk, 1 << 10, **kw)
        got = _port_bin(tfn, got, chunk, **kw)
    _assert_planes_bits(got, want)
    assert (got[2][50:80].view(np.uint32) == 0x80000000).any()  # standing -0.0 kept


def test_exact_tie_keeps_the_earliest_point_and_the_standing_value():
    flat = np.array([3, 3, 3, 5, 5], np.int32)
    z = np.array([0.25, 0.5, 0.5, -0.0, 0.0], np.float32)
    val = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    count, steps, zbuf = _port_bin(tb.bin_chunk_exact, _blank(), (flat, z, val))
    assert count[3] == 3 and steps[3] == 2.0 and zbuf[3] == 0.5
    assert steps[5] == 4.0 and zbuf[5].view(np.uint32) == 0  # canonical +0.0
    state = (count, steps, zbuf)
    # equal z in a later chunk (-0.0 against the standing +0.0 too) loses
    later = (np.array([5, 3], np.int32), np.array([-0.0, 0.5], np.float32),
             np.array([7.0, 8.0], np.float32))
    _, steps2, _ = _port_bin(tb.bin_chunk_exact, state, later)
    assert steps2[5] == 4.0 and steps2[3] == 2.0
    nearer = (np.array([3], np.int32), np.array([0.75], np.float32), np.array([9.0], np.float32))
    assert _port_bin(tb.bin_chunk_exact, state, nearer)[1][3] == 9.0


def test_f16_bits_match_jax_on_every_class():
    """Random bit patterns, the rounding edges (subnormal, overflow at
    65520) and every NaN payload class, both signs: JAX's conversion on
    the CPU, bit for bit, and back."""
    rng = np.random.default_rng(33)
    bits = np.concatenate([
        rng.integers(0, 2**32, 1 << 16, dtype=np.uint64).astype(np.uint32),
        np.arange(0x32FFFF00, 0x33000100, dtype=np.uint32),
        np.arange(0x387FE000, 0x38801000, 7, dtype=np.uint32),
        np.arange(0x477FE000, 0x47800100, dtype=np.uint32),
        np.array([0x7F800000, 0x7F800001, 0x7F801FFF, 0x7F802000, 0x7FC00001, 0x7FFFFFFF,
                  0xFFC12345], np.uint32)])
    f = np.concatenate([bits, bits | np.uint32(0x80000000)]).view(np.float32)
    want = np.asarray(jax.lax.bitcast_convert_type(jnp.asarray(f).astype(jnp.float16),
                                                   jnp.uint16))
    got = tb.f16_bits(torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got[-1] == 0xFE09
    h = np.arange(65536, dtype=np.uint16)
    back = np.asarray(jax.lax.bitcast_convert_type(
        jax.lax.bitcast_convert_type(jnp.asarray(h), jnp.float16).astype(jnp.float32),
        jnp.uint32))
    np.testing.assert_array_equal(
        tb.f16_to_f32(torch.from_numpy(h.astype(np.int64))).numpy().view(np.uint32), back)


@pytest.mark.parametrize("fn", ["exact", "exact16"])
def test_kernel_wrappers_run_the_plain_twins_on_cpu_without_launching(fn):
    chunk = _stream("random", np.random.default_rng(34))
    wrapper = tk.bin_chunk_kernel_exact if fn == "exact" else tk.bin_chunk_kernel_exact16
    twin = tb.bin_chunk_exact if fn == "exact" else tb.bin_chunk_exact16
    before = wrapper.launches
    _assert_planes_bits(_port_bin(wrapper, _blank(), chunk), _port_bin(twin, _blank(), chunk))
    assert wrapper.launches == before


# ------------------------------------------------------------- emission ---


@pytest.mark.parametrize("preset,size", [("poisson-saturne", (320, 180)),
                                         ("solar-sail", (640, 360))])
def test_exact_emission_full_float_bits_vs_eager_jax(preset, size):
    """Kernel A's EXACT mode emits (flat, z, val): every float32 bit of z
    and val equals JAX's eager ``_step_fn`` stream, NaN z as -inf."""
    jcfg = jpresets.by_name(preset, width=size[0], height=size[1])
    pts = _lanes(size[1])
    want = _jax_steps(jcfg, pts, 3, 0.3, JBin.EXACT)
    got_pts = torch.from_numpy(pts.copy())
    spec = emit.emit_spec(config_from_reference(jcfg), 0.3)
    flat, z, val = emit.map_emit_plain(spec, got_pts, 3, kind=sat.BinStrategy.EXACT)
    np.testing.assert_array_equal(flat.numpy(), want[0])
    np.testing.assert_array_equal(z.numpy().view(np.uint32), want[1].view(np.uint32))
    nan = np.isnan(want[2])  # a NaN value's payload is free (test_torch_emit)
    np.testing.assert_array_equal(np.isnan(val.numpy()), nan)
    np.testing.assert_array_equal(val.numpy().view(np.uint32)[~nan], want[2].view(np.uint32)[~nan])
    assert np.isneginf(z.numpy()).any()


# ---------------------------------------------------------------- slice ---


def _short(preset):
    jcfg = jpresets.by_name(preset, width=64, height=36, lanes=4, chunk_steps=16,
                            iterations=4 * 16 * 2, warmup=100)
    seeds = (np.random.default_rng(35).random((4, 3)) * 0.1).astype(np.float32)
    return jcfg, seeds


@pytest.mark.parametrize("strategy", [sat.BinStrategy.EXACT_KERNEL, sat.BinStrategy.EXACT])
@pytest.mark.parametrize("preset", ["poisson-saturne", "solar-sail", "lorenz", "rossler"])
def test_short_horizon_exact_render_equals_oracle(preset, strategy):
    """count, steps and zbuf equal ``oracle_render`` exactly."""
    jcfg, seeds = _short(preset)
    cfg = config_from_reference(jcfg).replace(bin_strategy=strategy)
    state = sat.render_seeds(cfg, torch.from_numpy(seeds))
    assert state.strategy == sat.BinStrategy.EXACT
    oc, os_, oz = oracle_render(jcfg, seeds, steps_per_lane=32)
    np.testing.assert_array_equal(state.count.numpy().view(np.uint32), oc.astype(np.uint32))
    np.testing.assert_array_equal(state.steps.numpy(), os_)
    np.testing.assert_array_equal(state.zbuf.numpy(), oz)
    assert oc.sum() > 0 and (oz > -1.0).any()


@pytest.mark.parametrize("ties", ["value", "earliest"])
def test_short_horizon_exact16_render_equals_jax_kernel_on_the_oracle_stream(ties):
    """The EXACT16 render equals JAX's ``bin_chunk_kernel_exact16``
    (interpret mode) run over the oracle's point stream, chunk by chunk in
    the render's step-major order."""
    jcfg, seeds = _short("poisson-saturne")
    cfg = config_from_reference(jcfg).replace(bin_strategy=sat.BinStrategy.EXACT16_KERNEL,
                                              exact16_ties=ties)
    state = sat.render_seeds(cfg, torch.from_numpy(seeds))
    pts = [oracle_points(jcfg, s, 32) for s in seeds]
    flat = np.stack([np.where(p["flat"] < 0, 64 * 36, p["flat"]) for p in pts], 1).astype(np.int32)
    z = np.stack([np.where(np.isnan(p["z2"]), -np.inf, p["z2"]) for p in pts], 1).astype(np.float32)
    val = np.stack([p["value"] for p in pts], 1).astype(np.float32)
    want = _blank()
    for c in range(2):  # two chunks of 16 steps x 4 lanes, step-major
        rows = slice(16 * c, 16 * (c + 1))
        chunk = (flat[rows].ravel(), z[rows].ravel(), val[rows].ravel())
        want = _jax_bin(kb.bin_chunk_kernel_exact16, want, chunk, 1 << 9, ties=ties)
    got = (state.count.numpy().ravel().view(np.uint32), state.steps.numpy().ravel(),
           state.zbuf.numpy().ravel())
    _assert_planes_bits(got, want)


@pytest.mark.parametrize("preset", ["poisson-saturne", "solar-sail"])
def test_long_horizon_exact_kernel_statistical_vs_jax_render(preset):
    jcfg = jpresets.by_name(preset, width=96, height=54, iterations=400_000, lanes=128,
                            chunk_steps=125, warmup=1000, seed=3, transparent=False,
                            bin_strategy=JBin.EXACT)
    jstate = jrender(jcfg, key=seed_key(jcfg))
    want = np.asarray(jax.device_get(jcolorize(jcfg, jstate)))
    cfg = config_from_reference(jcfg).replace(bin_strategy=sat.BinStrategy.EXACT_KERNEL)
    state = sat.render(cfg, device="cpu")
    got = sat.colorize(cfg, state).numpy()
    mad = np.abs(got[..., :3].astype(np.float64) - want[..., :3]).mean() / 65535.0
    assert mad < 0.035, f"mean abs tone-mapped diff {mad}"
    va, vb = state.count.numpy() != 0, np.asarray(jstate.count) > 0
    overlap = (va & vb).sum() / max(1, (va | vb).sum())
    assert overlap > 0.80, f"support overlap {overlap}"


def test_gas_tone_map_on_exact_planes_vs_eager_jax():
    """The Gas tone map on EXACT planes (full-float steps with NaN and
    out-of-range values) holds to test_torch_colorize's one-step bound."""
    from strange_attractor_tpu.ops import colorize as jc
    from strange_attractor_tpu_torch.ops import colorize as tc

    jcfg = jpresets.poisson_saturne(transparent=True)
    rng = np.random.default_rng(36)
    count = (rng.pareto(1.2, (54, 96)) * 20).astype(np.uint32)
    count[rng.random((54, 96)) < 0.3] = 0
    steps = rng.normal(0.5, 0.4, (54, 96)).astype(np.float32)
    steps[rng.random((54, 96)) < 0.01] = np.nan
    zbuf = np.where(count > 0, rng.normal(0, 0.5, (54, 96)), -1.0).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jc.colorize_planes(jcfg, jnp.asarray(count), jnp.asarray(steps),
                                             jnp.asarray(zbuf)))
    got = tc.colorize_planes(config_from_reference(jcfg), torch.from_numpy(count.view(np.int32)),
                             torch.from_numpy(steps), torch.from_numpy(zbuf)).numpy()
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


# ------------------------------------------------------- carry-over, CLI ---


def test_exact16_ties_validated_and_carried_from_the_reference():
    with pytest.raises(ValueError, match="exact16_ties"):
        sat.presets.poisson_saturne(exact16_ties="latest")
    ref = jpresets.poisson_saturne(bin_strategy=JBin.EXACT16_KERNEL, exact16_ties="earliest")
    cfg = config_from_reference(ref)
    assert cfg.exact16_ties == "earliest"
    assert cfg.bin_strategy == sat.BinStrategy.EXACT16_KERNEL


def test_exact_npz_states_cross_both_ways(tmp_path):
    from strange_attractor_tpu.runtime import (RenderState as JState, load_state as jload,
                                               save_state as jsave)

    count, steps, zbuf = _standing(np.random.default_rng(37))
    jsave(str(tmp_path / "jax.npz"), JState(count=jnp.asarray(count), steps=jnp.asarray(steps),
                                            zbuf=jnp.asarray(zbuf)))
    st = sat.load_state(str(tmp_path / "jax.npz"), device="cpu")
    assert st.strategy == sat.BinStrategy.EXACT
    np.testing.assert_array_equal(st.zbuf.numpy().view(np.uint32), zbuf.view(np.uint32))
    sat.save_state(str(tmp_path / "torch.npz"), st)
    back = jload(str(tmp_path / "torch.npz"))
    assert back.strategy == JBin.EXACT
    for name, want in (("count", count), ("steps", steps), ("zbuf", zbuf)):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)).view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("argv", [["--bin-strategy", "exact-kernel"],
                                  ["--bin-strategy", "exact16-kernel", "--exact16-ties",
                                   "earliest"]])
def test_cli_exact_strategies_write_a_png(argv, tmp_path):
    out = tmp_path / "frame"
    assert cli.main(["-i", "4000", "-w", "32", "-h", "18", "--lanes", "32", "--chunk-steps",
                     "16", "--seed", "1", "-q", "-8", "--device", "cpu", "-o", str(out),
                     *argv]) == 0
    assert (tmp_path / "frame.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
