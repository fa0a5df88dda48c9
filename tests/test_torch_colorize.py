"""PyTorch port, tone map and deliverable conversion against the JAX package
on the CPU.

JAX's ``colorize_planes`` runs eagerly (``render.colorize`` wraps it in a
``jit``, which may contract the lerp and brightness multiply-adds). Every op
of the port's tone map is the same float32 op in the same order, so the
palette lookup, the saturating casts and the 8-bit conversion are bit-exact.
One function is not: the port takes ``log1p`` correctly rounded (float64,
rounded once) on every device, while XLA's CPU ``log1p`` is faithful but one
ulp off on some counts. A one-ulp brightness factor moves a u16 channel by
at most one step, and only where the product lands next to an integer:
19 of 1,658,880 channels (1.1e-5) over twenty random 192x108 planes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strange_attractor_tpu import presets as jpresets
from strange_attractor_tpu.config import Colors as JColors, Palette as JPalette
from strange_attractor_tpu.ops import colorize as jc
from strange_attractor_tpu.ops.binning import pack_zv as jpack
from strange_attractor_tpu.runtime import RenderState as JState
from strange_attractor_tpu.utils import export as jexport
from strange_attractor_tpu_torch.convert import config_from_reference
from strange_attractor_tpu_torch.deliver import fetch
from strange_attractor_tpu_torch.ops import colorize as tc
from strange_attractor_tpu_torch.runtime import RenderState
from strange_attractor_tpu_torch.utils import export as texport

_PALETTE_12 = [[(i * 37 % 11) / 10, (i * 53 % 7) / 6, (i * 29 % 5) / 4] for i in range(12)]


def _planes(seed: int, shape=(54, 96), empty=False):
    """Random PACKED planes: skewed counts with many empty pixels, packed
    values from pack_zv of random (z, value)."""
    rng = np.random.default_rng(seed)
    if empty:
        count = np.zeros(shape, np.uint32)
    else:
        count = (rng.pareto(1.2, shape) * 20).astype(np.uint32)
        count[rng.random(shape) < 0.3] = 0
    z = rng.normal(0, 0.5, shape).astype(np.float32)
    val = rng.random(shape).astype(np.float32)
    packed = np.array(jpack(jnp.asarray(z), jnp.asarray(val)))
    packed[count == 0] = 0
    return count, packed


def _jax_colorize(jcfg, count, packed):
    with jax.disable_jit():
        st = JState(count=jnp.asarray(count), packed=jnp.asarray(packed))
        return np.asarray(jc.colorize_planes(jcfg, *jc.state_planes(st)))


def _port_colorize(jcfg, count, packed):
    cfg = config_from_reference(jcfg)
    st = RenderState(count=torch.from_numpy(count.view(np.int32)),
                     packed=torch.from_numpy(packed.view(np.int32)))
    return tc.colorize_planes(cfg, *tc.state_planes(st)).numpy()


@pytest.mark.parametrize("transparent", [False, True])
@pytest.mark.parametrize("palette", ["default", "12-stop"])
def test_colorize_planes_vs_eager_jax(transparent, palette):
    jcfg = jpresets.poisson_saturne(transparent=transparent)
    if palette == "12-stop":  # past PALETTE_SELECT_MAX_STOPS: the gather path
        jcfg = jcfg.replace(colors=JColors(palette=JPalette(_PALETTE_12)))
    count, packed = _planes(11 + transparent)
    want = _jax_colorize(jcfg, count, packed)
    got = _port_colorize(jcfg, count, packed)
    assert got.dtype == want.dtype == np.uint16 and got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    # log1p rounding (module docstring): at most one u16 step, on few channels
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 1e-3, (diff > 0).mean()
    # pixels whose factor is exact in both (empty: NaN -> 0; max count: 1.0)
    exact = (count == 0) | (count == count.max())
    np.testing.assert_array_equal(got[exact], want[exact])


def test_colorize_empty_canvas_bit_exact():
    jcfg = jpresets.poisson_saturne(transparent=True)
    count, packed = _planes(13, empty=True)
    np.testing.assert_array_equal(_port_colorize(jcfg, count, packed),
                                  _jax_colorize(jcfg, count, packed))


@pytest.mark.parametrize("stops", ["default", "12-stop"])
def test_palette_lookup_bit_exact_both_paths(stops):
    table = (jpresets.poisson_saturne().colors.palette.stops if stops == "default"
             else JPalette(_PALETTE_12).stops)
    rng = np.random.default_rng(14)
    value = np.concatenate([rng.random(8192), [0.0, -0.0, 0.999999, 0.9999995, 1.0, 1.5, -0.2],
                            np.arange(4096) / 4096.0]).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jc.palette_lookup(table, jnp.asarray(value)))
    for gather in (False, True):
        got = tc.palette_lookup(table, torch.from_numpy(value), gather=gather).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_saturate_u16_bit_exact():
    x = np.concatenate([np.array([np.nan, np.inf, -np.inf, -1.0, -0.5, 0.0, 0.999, 65534.99,
                                  65535.0, 65535.5, 1e9], np.float32),
                        np.random.default_rng(15).normal(30000, 30000, 4096).astype(np.float32)])
    want = np.asarray(jc._saturate_u16(jnp.asarray(x)))
    np.testing.assert_array_equal(tc._saturate_u16(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("transparent", [False, True])
@pytest.mark.parametrize("eight_bit", [False, True])
def test_convert_format_device_all_u16_values(transparent, eight_bit):
    v = np.arange(65536, dtype=np.uint16)
    img = np.stack([v, v[::-1], np.roll(v, 7), np.roll(v, 1000)], axis=-1).reshape(256, 256, 4)
    want = np.asarray(jexport.convert_format_device(jnp.asarray(img), transparent, eight_bit))
    got = fetch(tc.convert_format_device(torch.from_numpy(img), transparent, eight_bit))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(texport.convert_format(img, transparent, eight_bit),
                                  jexport.convert_format(img, transparent, eight_bit))


@pytest.mark.parametrize("dtype,channels", [(np.uint8, 3), (np.uint8, 4), (np.uint16, 4)])
def test_png_filter_and_writers_match(dtype, channels):
    rng = np.random.default_rng(16)
    img = rng.integers(0, np.iinfo(dtype).max, (37, 53, channels), dtype=np.uint64).astype(dtype)
    img[10:20] = 0  # flat rows pick other filters
    _, _, _, _, raw = texport._png_geometry(img)
    rows = np.ascontiguousarray(raw).reshape(37, -1).view(np.uint8).reshape(37, -1)
    assert texport._filter_scanlines(raw, 37) == jexport._filter_scanlines_numpy(
        rows, channels * img.itemsize)
    if dtype == np.uint8:
        assert texport.bmp_bytes(img) == jexport.bmp_bytes(img)
    assert texport.pam_bytes(img) == jexport.pam_bytes(img)


def _depth_plane(seed: int, shape=(54, 96)):
    """A DEPTH plane: normal z with the -1.0 sentinel on empty pixels and
    both zeros."""
    rng = np.random.default_rng(seed)
    zbuf = rng.normal(0, 0.5, shape).astype(np.float32)
    zbuf[rng.random(shape) < 0.3] = -1.0
    zbuf[0, :2] = (0.0, -0.0)
    return zbuf


@pytest.mark.parametrize("eight_bit", [False, True])
@pytest.mark.parametrize("transparent", [False, True])
@pytest.mark.parametrize("kind", ["gas", "depth"])
def test_colorize_convert_fetch_vs_jax(kind, transparent, eight_bit):
    """The deliverable of a state carried across by convert.py equals the
    JAX package's ``colorize_convert_fetch`` (banded, cropped, jitted) for
    the same planes, within the log1p bound of the module docstring."""
    from strange_attractor_tpu.config import RenderKind as JKind
    from strange_attractor_tpu.render import colorize_convert_fetch as jfetch
    from strange_attractor_tpu_torch.convert import state_from_numpy
    from strange_attractor_tpu_torch.render import colorize_convert_fetch

    jcfg = jpresets.poisson_saturne(transparent=transparent,
                                    render=JKind.GAS if kind == "gas" else JKind.DEPTH)
    if kind == "gas":
        count, packed = _planes(21 + transparent)
        planes = {"count": count, "packed": packed}
    else:
        planes = {"zbuf": _depth_plane(23 + transparent)}
    want = jfetch(jcfg, JState(**{k: jnp.asarray(v) for k, v in planes.items()}),
                  transparent=transparent, eight_bit=eight_bit)
    got = colorize_convert_fetch(config_from_reference(jcfg),
                                 state_from_numpy(planes, device="cpu"),
                                 transparent=transparent, eight_bit=eight_bit)
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape
    assert got.dtype == (np.uint8 if eight_bit else np.uint16)
    assert got.shape == (54, 96, 4 if transparent else 3)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 1e-3, (diff > 0).mean()
    if kind == "depth":  # no log1p in the Depth tone map
        np.testing.assert_array_equal(got, want)
    else:
        exact = (count == 0) | (count == count.max())
        np.testing.assert_array_equal(got[exact], want[exact])
