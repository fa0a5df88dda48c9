"""PyTorch port, the module-level helpers the JAX package has beside its
render path, against the JAX package's, on the CPU: the file writers
``write_png``, ``write_bmp`` and ``write_pam``, ``rotate_point``, the maps'
``step`` and ``step_numpy`` and the color transforms' ``numpy``.

Tolerance 0 (byte and bit equality) everywhere but Thomas, whose port runs
its own sine (``models.attractors.sin_f32``/``sin_f64``) where the JAX
package's ``step_numpy`` calls ``np.sin``: there a step may differ from
the JAX one by 2 machine epsilons of the point's scale,
``|port - jax| <= 2 eps max(1, |p|)`` (measured: 1.0 eps in float32 and
float64 over 10^5 points of scale 3).
"""

import numpy as np
import pytest
import torch

from strange_attractor_tpu.models import presets as jpresets
from strange_attractor_tpu.ops import projection as jprojection
from strange_attractor_tpu.utils import export as jexport
from strange_attractor_tpu_torch.models import presets
from strange_attractor_tpu_torch.ops import projection
from strange_attractor_tpu_torch.utils import export

MAPS = ("poisson-saturne", "lorenz", "rossler", "halvorsen", "thomas")
DTYPES = (np.float32, np.float64)


def _image(dtype, ch: int) -> np.ndarray:
    rng = np.random.default_rng(ch * 3 + np.dtype(dtype).itemsize)
    img = rng.integers(0, np.iinfo(dtype).max + 1, (23, 37, ch), dtype=np.uint64)
    img[5:9] = 0  # flat rows
    return img.astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("ch", [3, 4])
@pytest.mark.parametrize("fmt", ["png", "bmp", "pam"])
def test_writers_write_the_jax_bytes(tmp_path, fmt, dtype, ch):
    img = _image(dtype, ch)
    ours, theirs = getattr(export, f"write_{fmt}"), getattr(jexport, f"write_{fmt}")
    if fmt == "bmp" and dtype == np.uint16:
        for fn in (ours, theirs):
            with pytest.raises(ValueError, match="8-bit"):
                fn(tmp_path / "x.bmp", img)
        return
    assert ours(tmp_path / f"port.{fmt}", img) is None
    theirs(tmp_path / f"jax.{fmt}", img)
    got = (tmp_path / f"port.{fmt}").read_bytes()
    assert got == (tmp_path / f"jax.{fmt}").read_bytes()
    assert got == getattr(export, f"{fmt}_bytes")(img)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("transparent", [False, True])
def test_write_image_pam_is_pam_bytes(tmp_path, dtype, transparent):
    """``write_image`` writes a PAM's header and samples one after the
    other; the file is ``pam_bytes`` of the converted image, also where
    dropping alpha leaves a strided view."""
    img = _image(dtype, 4)
    path = export.write_image(tmp_path / "frame", img, fmt="pam", transparent=transparent,
                              announce=False)
    assert path.read_bytes() == export.pam_bytes(export.convert_format(img, transparent, False))


def test_pam_samples_of_an_8bit_image_are_its_own_buffer():
    img = _image(np.uint8, 3)
    header, data = export._pam_parts(img)
    assert data.obj is img
    assert header + data == export.pam_bytes(img)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("preset", ["poisson-saturne", "solar-sail", "thomas"])
def test_rotate_point_matches_jax(preset, dtype):
    jcfg, cfg = jpresets.by_name(preset), presets.by_name(preset)
    p = np.random.default_rng(5).normal(0, 2, (4, 50, 3)).astype(dtype)
    want = jprojection.rotate_point(
        jprojection.camera_params(jcfg.view, 0.7, jcfg.width, jcfg.height), p, np)
    cam = projection.camera_params(cfg.view, 0.7, cfg.width, cfg.height)
    for got in (projection.rotate_point(cam, p),
                [t.numpy() for t in projection.rotate_point(cam, torch.from_numpy(p))],
                projection.rotate_point(cam, p, np)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == (4, 50)
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


def _points(dtype) -> np.ndarray:
    return np.random.default_rng(7).normal(0, 3, (2, 500, 3)).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("preset", MAPS)
def test_steps_match_jax_step_numpy(preset, dtype):
    p = _points(dtype)
    want = jpresets.by_name(preset).attractor.step_numpy(p)
    attractor = presets.by_name(preset).attractor
    for got in (attractor.step_numpy(p), attractor.step(torch.from_numpy(p)).numpy()):
        assert got.dtype == want.dtype and got.shape == want.shape
        if preset == "thomas":
            scale = np.maximum(1.0, np.abs(p).max(axis=-1, keepdims=True))
            err = np.abs(got.astype(np.float64) - want) / scale
            assert err.max() <= 2 * np.finfo(dtype).eps, err.max()
        else:
            np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("preset", ["poisson-saturne", "solar-sail", "lorenz"])
def test_transform_numpy_matches_jax(preset, dtype):
    """``PoissonSaturneTransform`` (poisson-saturne) and
    ``AdjustedVelocity`` (the others) on seeded deltas and screen points."""
    rng = np.random.default_rng(9)
    delta, screen = (rng.normal(0, s, (3, 200, 3)).astype(dtype) for s in (0.3, 0.5))
    jcfg, cfg = jpresets.by_name(preset), presets.by_name(preset)
    assert type(cfg.color_transform).__name__ == type(jcfg.color_transform).__name__
    want = jcfg.color_transform.numpy(delta, screen, jcfg.view)
    got = cfg.color_transform.numpy(delta, screen, cfg.view)
    assert got.dtype == want.dtype and got.shape == (3, 200)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
