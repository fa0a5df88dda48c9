"""PyTorch port, the RK4 family and the port's float32 sine against the JAX
package on the CPU.

Lorenz, Rossler and Halvorsen are held bit for bit (tolerance 0; a NaN's
payload bits are free) to the JAX classes' ``step_numpy`` and to their
eager ``step_xyz`` (``jax.disable_jit()``: XLA's CPU ``jit`` contracts
multiply-adds into FMAs, ROADMAP C5) over 1, 10 and 100 steps. Thomas
computes its sine with the port's own ``sin_f32``, which the kernel
reproduces, while the JAX package calls ``np.sin`` or ``jnp.sin``: one step
is held within 1 ulp of max(|v|, 1), and its renders statistically
(``test_torch_render.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strange_attractor_tpu.models import attractors as ja
from strange_attractor_tpu_torch.models import attractors as ta


def _points(seed: int, n: int = 4096) -> np.ndarray:
    """(n, 3) float32: points near the attractors' scale, a wide spread
    whose orbits overflow to inf and NaN, and exact zeros."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 5, (n, 3)).astype(np.float32)
    p[: n // 8] = rng.normal(0, 200, (n // 8, 3))
    p[-4:] = 0.0
    return p


def _assert_same(tag: str, got: np.ndarray, want: np.ndarray) -> None:
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=tag)
    np.testing.assert_array_equal(got.view(np.uint32)[~nan], want.view(np.uint32)[~nan],
                                  err_msg=tag)


def _port_steps(model, p: np.ndarray, steps: int) -> np.ndarray:
    x, y, z = (torch.from_numpy(np.ascontiguousarray(p[:, k])) for k in range(3))
    for _ in range(steps):
        x, y, z = model.step_xyz(x, y, z)
    return np.stack([x.numpy(), y.numpy(), z.numpy()], axis=1)


@pytest.mark.parametrize("steps", [1, 10, 100])
@pytest.mark.parametrize("name", ["Lorenz", "Rossler", "Halvorsen"])
def test_rk4_bit_exact_vs_jax(name, steps):
    jmodel, tmodel = getattr(ja, name)(), getattr(ta, name)()
    p = _points(steps)
    want = p
    jx = [jnp.asarray(p[:, k]) for k in range(3)]
    with np.errstate(all="ignore"), jax.disable_jit():
        for _ in range(steps):
            want = jmodel.step_numpy(want)
            jx = jmodel.step_xyz(*jx)
        got = _port_steps(tmodel, p, steps)
    _assert_same(f"{name} vs step_numpy", got, want)
    _assert_same(f"{name} vs eager step_xyz", got, np.stack([np.asarray(v) for v in jx], 1))
    assert np.isfinite(got).mean() > 0.5


def test_rk4_fields_and_constants_match_jax():
    """Defaults, the float32 h, 0.5 h and h/6, and each derivative constant
    rounded once to float32 (8/3 included)."""
    for name in ("Lorenz", "Rossler", "Halvorsen", "Thomas"):
        j, t = getattr(ja, name)(), getattr(ta, name)()
        fields = [f for f in vars(type(j))["__dataclass_fields__"]]
        assert fields == [f for f in vars(type(t))["__dataclass_fields__"]]
        assert all(getattr(j, f) == getattr(t, f) for f in fields)
        h, hh, h6 = t.rk4_constants()
        assert h == np.float32(j.dt) and hh == np.float32(0.5) * np.float32(j.dt)
        assert h6 == np.float32(j.dt) / np.float32(6.0)
    assert ta.Lorenz().constants()[2] == float(np.float32(8.0 / 3.0))


@pytest.mark.parametrize("b", [0.208186, 0.18])
def test_thomas_one_step_within_one_ulp(b):
    """One step differs from ``step_numpy`` and eager ``jnp.sin`` only by
    the sine's rounding: at most 1 ulp of max(|v|, 1) (measured: 1 ulp on
    0.3% of components against numpy, 0.7% against eager JAX)."""
    jmodel, tmodel = ja.Thomas(b=b), ta.Thomas(b=b)
    p = np.random.default_rng(5).uniform(-5, 5, (100_000, 3)).astype(np.float32)
    got = _port_steps(tmodel, p, 1).astype(np.float64)
    with jax.disable_jit():
        eager = np.stack([np.asarray(v) for v in
                          jmodel.step_xyz(*[jnp.asarray(p[:, k]) for k in range(3)])], 1)
    for tag, want in (("step_numpy", jmodel.step_numpy(p)), ("eager", eager)):
        ulp = np.spacing(np.maximum(np.abs(want), np.float32(1.0))).astype(np.float64)
        err = np.abs(got - want) / ulp
        assert err.max() <= 1.0, f"{tag}: {err.max()} ulp"


def _ulps(got: np.ndarray, x: np.ndarray) -> np.ndarray:
    want = np.sin(x.astype(np.float64))
    return np.abs(got.astype(np.float64) - want) / np.spacing(
        np.abs(want).astype(np.float32)).astype(np.float64)


def test_sin_f32_against_float64_sine():
    """Within 2 ulp of the float64 sine for |x| <= 8 (every 1009th float32 bit
    pattern in [0, 8], and the negatives), absolute error under 1e-7 up to
    |x| = 1e4 (the reduction's k * C3 term), NaN for NaN and +-inf, 0 for
    both zeros."""
    bits = np.arange(0, np.float32(8.0).view(np.uint32) + 1, 1009, dtype=np.uint32)
    x = bits.view(np.float32)
    x = np.concatenate([x, -x])
    got = ta.sin_f32(torch.from_numpy(x)).numpy()
    assert _ulps(got, x).max() <= 2.0
    wide = np.random.default_rng(3).uniform(-1e4, 1e4, 200_000).astype(np.float32)
    err = np.abs(ta.sin_f32(torch.from_numpy(wide)).numpy() - np.sin(wide.astype(np.float64)))
    assert err.max() < 1e-7
    special = torch.tensor([np.nan, np.inf, -np.inf, 0.0, -0.0], dtype=torch.float32)
    out = ta.sin_f32(special).numpy()
    assert np.isnan(out[:3]).all()
    assert (out[3:] == 0.0).all()
