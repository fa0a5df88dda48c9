"""CPU numpy oracle: a direct transcription of the reference's hot loop, on
the port's Config (a copy of ``strange_attractor_tpu.oracle``, which the
port cannot import: it would import JAX).

It is the ground truth ``doctor`` holds the card's kernels to, so it shares
no code with the torch twins it checks: each map, color transform and the
palette lookup is its own numpy float64/float32 transcription here -- the
JAX package's ``step_numpy`` of ``PolynomialSprott2Degree`` and
``_RK4Ode`` (strange_attractor_tpu/models/attractors.py:85, :134), its
transforms' ``numpy`` and ``Palette.interpolate_numpy``, with two
exceptions taken from the port: Thomas' sine is the port's own
(:func:`models.attractors.sin_f32` and ``sin_f64``, transcribed here op for
op from their constants: ``np.sin`` rounds differently), and the camera
constants come from :func:`ops.projection.camera_params`. The model classes'
``step_numpy`` and the transforms' ``numpy`` are these transcriptions
(:func:`step`, :func:`color_value`) on (..., 3) arrays. Every constant is
taken in the compute dtype explicitly, so numpy's scalar promotion rules
(which differ between numpy 1 and 2) cannot widen a step.

It replicates the semantics of ``render`` (src/lib.rs:747-838),
``Runtime::merge`` (src/lib.rs:708-738) and ``colorize``
(src/lib.rs:841-904) point for point, including:

- the warm-up discarded before binning (src/lib.rs:749-752),
- out-of-bounds points still updating ``previous_point`` (src/lib.rs:789-795),
- the strict ``z2 > zbuf`` test with the -1.0 sentinel (src/lib.rs:818-833),
- saturating float->u16 casts in the tone map (Rust ``as`` semantics).

The lanes of :func:`oracle_render` advance together as numpy vectors (each
lane's arithmetic is elementwise, so a lane computes what it would alone),
then bin lane by lane in the JAX oracle's order. Use small configs.
"""

from __future__ import annotations

import numpy as np

from .config import Config, RenderKind
from .models.attractors import (SIN64_C, SIN64_PIO2, SIN64_S, SIN64_TWO_OVER_PI, SIN_C,
                                SIN_PIO2, SIN_S, SIN_TWO_OVER_PI, Halvorsen, Lorenz,
                                PolynomialSprott2Degree, Rossler, Thomas)
from .models.transforms import AdjustedVelocity, PoissonSaturneTransform
from .ops.projection import camera_params

# cos/sin of 45.5 degrees, the poisson-saturne classifier's constants
# (src/lib.rs:524-536)
_COS_45_5 = 0.7009092642998509
_SIN_45_5 = 0.7132504491541816


def _sin(v: np.ndarray) -> np.ndarray:
    """The port's sine in numpy, float32 or float64 by ``v``'s dtype: k =
    floor(v * 2/pi + 0.5), r = ((v - k C1) - k C2) - k C3, then sin(r) or
    cos(r) with the sign of k mod 4."""
    dt = v.dtype.type
    wide = v.dtype == np.float64
    two_over_pi, pio2 = (SIN64_TWO_OVER_PI, SIN64_PIO2) if wide else (SIN_TWO_OVER_PI, SIN_PIO2)
    k = np.floor(v * dt(two_over_pi) + dt(0.5))
    r = ((v - k * dt(pio2[0])) - k * dt(pio2[1])) - k * dt(pio2[2])
    q = k - dt(4.0) * np.floor(k * dt(0.25))
    z = r * r
    if wide:
        def horner(coefs):
            acc = dt(coefs[0]) * z + dt(coefs[1])
            for c in coefs[2:]:
                acc = acc * z + dt(c)
            return acc

        s = r + (r * z) * horner(SIN64_S)
        c = (dt(1.0) - dt(0.5) * z) + (z * z) * horner(SIN64_C)
    else:
        s = ((dt(SIN_S[2]) * z + dt(SIN_S[1])) * z + dt(SIN_S[0])) * z * r + r
        c = (((dt(SIN_C[2]) * z + dt(SIN_C[1])) * z + dt(SIN_C[0])) * z * z
             - dt(0.5) * z) + dt(1.0)
    odd = (q == dt(1.0)) | (q == dt(3.0))
    out = np.where(odd, c, s)
    return np.where(q >= dt(2.0), -out, out)


def _deriv(attractor, x, y, z):
    """The RK4 family's derivative, the JAX package's ``_deriv_xyz``."""
    dt = x.dtype.type
    if isinstance(attractor, Lorenz):
        sigma, rho, beta = dt(attractor.sigma), dt(attractor.rho), dt(attractor.beta)
        return sigma * (y - x), x * (rho - z) - y, x * y - beta * z
    if isinstance(attractor, Rossler):
        a, b, c = dt(attractor.a), dt(attractor.b), dt(attractor.c)
        return -y - z, x + a * y, b + z * (x - c)
    if isinstance(attractor, Halvorsen):
        a, four = dt(attractor.a), dt(4.0)
        return (-a * x - four * y - four * z - y * y,
                -a * y - four * z - four * x - z * z,
                -a * z - four * x - four * y - x * x)
    if isinstance(attractor, Thomas):
        b = dt(attractor.b)
        return _sin(y) - b * x, _sin(z) - b * y, _sin(x) - b * z
    raise NotImplementedError(f"the oracle has no map for {type(attractor).__name__}")


def step(attractor, x: np.ndarray, y: np.ndarray, z: np.ndarray) -> tuple:
    """One map step of ``attractor`` on numpy arrays of one dtype."""
    dt = x.dtype.type
    if isinstance(attractor, PolynomialSprott2Degree):
        monoms = (np.ones_like(x), x, x * x, x * y, x * z, y, y * y, y * z, z, z * z)

        def dot(coeffs):
            acc = dt(coeffs[0]) * monoms[0]
            for c, m in zip(coeffs[1:], monoms[1:]):
                acc = acc + dt(c) * m
            return acc

        return dot(attractor.x), dot(attractor.y), dot(attractor.z)
    # one fixed RK4 step of size dt: stage points v + (0.5 h) k, v + h k,
    # then v + (h / 6) (((k1 + 2 k2) + 2 k3) + k4)
    h = dt(attractor.dt)
    hh, h6, two = dt(0.5) * h, h / dt(6.0), dt(2.0)
    k1 = _deriv(attractor, x, y, z)
    k2 = _deriv(attractor, x + hh * k1[0], y + hh * k1[1], z + hh * k1[2])
    k3 = _deriv(attractor, x + hh * k2[0], y + hh * k2[1], z + hh * k2[2])
    k4 = _deriv(attractor, x + h * k3[0], y + h * k3[1], z + h * k3[2])
    return tuple(v + h6 * (((a + two * b) + two * c) + d)
                 for v, a, b, c, d in zip((x, y, z), k1, k2, k3, k4))


def _magnitude(dx, dy, dz):
    return np.sqrt(dx * dx + dy * dy + dz * dz)


def color_value(transform, delta: tuple, screen: tuple, view) -> np.ndarray:
    """The palette position of each point (src/lib.rs:498-559) from the
    components of ``delta`` and ``screen`` as numpy arrays of one dtype."""
    dt = delta[0].dtype.type
    if isinstance(transform, AdjustedVelocity):
        return (_magnitude(*delta) + dt(transform.offset)) * dt(transform.factor)
    if isinstance(transform, PoissonSaturneTransform):
        sx, sy, sz = screen
        # the reference adds center_camera.y to z (src/lib.rs:538-539)
        x2 = ((sx + dt(view.center_camera[0])) * dt(_COS_45_5)
              + (sz + dt(view.center_camera[1])) * dt(_SIN_45_5))
        outside = ((x2 < dt(-0.0839))
                   | (dt(10.55) * x2 + sy < dt(0.46 - 1.0941))
                   | (dt(1.0426) * x2 + sy < dt(0.179 - 0.1576))
                   | (dt(0.5139) * x2 - sy > dt(-0.04 - 0.04092)))
        part = np.where(outside, dt(0.0), dt(1.0))
        color = (part + _magnitude(*delta)) / dt(2.0)
        return (color - dt(0.1)) / dt(0.9)
    raise NotImplementedError(f"the oracle has no color transform {type(transform).__name__}")


def oracle_trajectory(config: Config, p0: np.ndarray, steps: int, dtype=np.float32) -> np.ndarray:
    """Iterate the raw map ``steps`` times from ``p0``; returns (steps+1, 3)."""
    p = [np.asarray(p0, dtype)[..., i:i + 1] for i in range(3)]
    out = np.empty((steps + 1, 3), dtype)
    out[0] = np.asarray(p0, dtype)
    for k in range(steps):
        p = step(config.attractor, *p)
        out[k + 1] = np.concatenate(p)
    return out


def _lanes_points(config: Config, seeds: np.ndarray, steps: int, dtype) -> dict:
    """:func:`oracle_points` of every lane of ``seeds`` (L, 3) at once:
    arrays (L, steps)."""
    dt = np.dtype(dtype).type
    cam = camera_params(config.view, config.angle, config.width, config.height)
    m = np.asarray(cam.rotation_matrix, dtype)
    cos_v, sin_v = dt(cam.cos_angle), dt(cam.sin_angle)
    ccx, ccy, ccz = (dt(v) for v in cam.center_camera)
    width, height = dt(config.width), dt(config.height)
    width_scaled, mid = dt(cam.width_scaled), dt(cam.scale_adjusted_mid)

    seeds = np.atleast_2d(np.asarray(seeds, dtype))
    shape = (seeds.shape[0], steps)
    fi, fj, z2a, val = (np.empty(shape, dtype) for _ in range(4))
    inb = np.empty(shape, bool)
    flat = np.full(shape, -1, np.int64)
    # escaping orbits overflow to inf and NaN, as in the reference
    with np.errstate(invalid="ignore", over="ignore"):
        cur = tuple(seeds[:, i].copy() for i in range(3))
        for _ in range(config.warmup):
            cur = step(config.attractor, *cur)
        prev = cur
        for k in range(steps):
            cur = step(config.attractor, *cur)
            x, y, z = cur
            s = tuple(m[r, 0] * x + m[r, 1] * y + m[r, 2] * z for r in range(3))
            x2 = (s[0] + ccx) * cos_v + (s[2] + ccy) * sin_v
            z2 = (s[0] + ccx) * sin_v - (s[2] + ccy) * cos_v
            i = (mid - x2) * width_scaled
            j = height / dt(2.0) - (s[1] + ccz) * width_scaled
            # the reference's skip test (src/lib.rs:789): NaN fails all
            # four and passes; Rust's saturating `as u32` then bins it at
            # pixel (0, 0) (escaped orbits)
            ok = ~((i >= width) | (j >= height) | (i < dt(0.0)) | (j < dt(0.0)))
            fi[:, k], fj[:, k], z2a[:, k], inb[:, k] = i, j, z2, ok
            val[:, k] = color_value(config.color_transform,
                                     (x - prev[0], y - prev[1], z - prev[2]), s, config.view)
            ii = np.where(ok & ~np.isnan(i), i, dt(0.0)).astype(np.int64)
            jj = np.where(ok & ~np.isnan(j), j, dt(0.0)).astype(np.int64)
            flat[:, k] = np.where(ok, jj * config.width + ii, -1)
            prev = cur
    return {"fi": fi, "fj": fj, "z2": z2a, "value": val, "inbounds": inb, "flat": flat}


def oracle_points(config: Config, p0: np.ndarray, steps: int, dtype=np.float32) -> dict:
    """Run warm-up + ``steps`` iterations of one lane; emit the binned stream.

    Returns dict of arrays (steps,): ``fi, fj, z2, value, inbounds, flat``
    exactly as the hot loop computes them (src/lib.rs:769-837). ``flat`` is
    ``j * width + i`` for in-bounds points, -1 otherwise.
    """
    return {k: v[0] for k, v in _lanes_points(config, p0, steps, dtype).items()}


def oracle_bin(width: int, height: int, flat, z2, value, count=None, steps=None, zbuf=None):
    """Sequentially bin a point stream with the reference's exact semantics.

    ``flat`` entries < 0 are out-of-bounds points (skipped). Accumulates into
    (and returns) ``count`` (u64), ``steps`` (f32), ``zbuf`` (f32) planes.
    """
    npix = width * height
    if count is None:
        count = np.zeros(npix, np.uint64)
        steps = np.zeros(npix, np.float32)
        zbuf = np.full(npix, -1.0, np.float32)
    for k in range(len(flat)):
        f = flat[k]
        if f < 0:
            continue
        count[f] += 1
        z = np.float32(z2[k])
        if z > zbuf[f]:  # strict: ties keep the earlier value (src/lib.rs:821)
            steps[f] = np.float32(value[k])
            zbuf[f] = z
    return count, steps, zbuf


def oracle_render(config: Config, seeds: np.ndarray, steps_per_lane: int, dtype=np.float32):
    """Render ``seeds.shape[0]`` lanes, binned lane after lane
    (merge-equivalent).

    ``seeds`` are pre-warm-up initial points, shape (L, 3) -- the reference
    seeds each work unit with ``rng.random::<Vec3>() * 0.1`` (src/lib.rs:748).
    Returns (count u64, steps f32, zbuf f32) reshaped to (H, W).
    """
    pts = _lanes_points(config, seeds, steps_per_lane, dtype)
    count = steps = zbuf = None
    for lane in range(pts["flat"].shape[0]):
        count, steps, zbuf = oracle_bin(config.width, config.height, pts["flat"][lane],
                                        pts["z2"][lane], pts["value"][lane], count, steps, zbuf)
    shape = (config.height, config.width)
    return count.reshape(shape), steps.reshape(shape), zbuf.reshape(shape)


def _saturate_u16(x: np.ndarray) -> np.ndarray:
    """Rust ``as u16`` float cast: NaN -> 0, clamp to [0, 65535], truncate."""
    x = np.nan_to_num(x, nan=0.0, posinf=65535.0, neginf=0.0)
    return np.clip(x, 0.0, 65535.0).astype(np.uint16)


def _interpolate(palette, value: np.ndarray) -> np.ndarray:
    """The palette lookup in float64 (src/lib.rs:439-473): only v >= 1.0
    clamps (to 0.999999), then a sqrt-of-lerp between stops."""
    stops = palette.stops
    value = np.asarray(value, np.float64)
    value = np.where(value >= 1.0, 0.999999, np.maximum(value, 0.0)) * palette.count
    n = np.floor(value).astype(np.int64)
    frac = (value % 1.0)[..., None]
    return np.sqrt(stops[n + 1] * frac + stops[n] * (1.0 - frac))


def oracle_colorize(config: Config, count: np.ndarray, steps: np.ndarray, zbuf: np.ndarray):
    """Tone-map to (H, W, 4) uint16 RGBA (reference: src/lib.rs:841-904)."""
    if config.render == RenderKind.GAS:
        bk = config.colors.brightness
        rgb = _interpolate(config.colors.palette, steps)  # (H, W, 3)
        cmax = np.float64(count.max())
        # log base (max+1); log1p(0)/log1p(0) = NaN -> 0 via saturate
        with np.errstate(divide="ignore", invalid="ignore"):
            factor = np.log(count.astype(np.float64) + 1.0) / np.log(cmax + 1.0)
        channels = (rgb * factor[..., None] + bk.offset) * bk.factor * 65535.0
        if config.transparent:
            alpha = _saturate_u16(factor * 65535.0)
        else:
            alpha = np.full(count.shape, 65535, np.uint16)
        return np.concatenate([_saturate_u16(channels), alpha[..., None]], axis=-1)

    # Depth (src/lib.rs:875-899): min/max over zbuf ignoring the -1 sentinel;
    # the fold starts at (0.0, f32::MAX), so max is floored at 0
    valid = zbuf != -1.0
    zmax = np.float32(0.0)
    zmin = np.float32(np.finfo(np.float32).max)
    if valid.any():
        zmax = max(zmax, zbuf[valid].max())
        zmin = min(zmin, zbuf[valid].min())
    diff = zmax - zmin
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.where(valid, (zbuf - zmin) / diff, np.float32(0.0))
    gray = _saturate_u16(z * np.float32(65535.0))  # f32 math like the reference
    alpha = np.full(zbuf.shape, 65535, np.uint16)
    return np.stack([gray, gray, gray, alpha], axis=-1)
