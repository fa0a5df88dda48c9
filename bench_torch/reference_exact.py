"""The plain reference of the reference-faithful EXACT accumulation, in
plain PyTorch.

The upstream renderer's Gas render (Icelk/strange-attractor-renderer,
src/lib.rs:740-838) keeps three planes a pixel. Every map step's point is
rotated by the view and projected to pixel coordinates, a depth ``z2`` and
a colour value (src/lib.rs:754-812). A point on the canvas adds one to the
pixel's hit count, and it replaces the pixel's depth ``zbuf`` and colour
value ``steps`` when ``z2 > zbuf[i, j]``, on a depth plane that starts at
the sentinel -1.0 (src/lib.rs:818-834). The points run in order and the
test is strict, so of the points that share a pixel's greatest depth the
first keeps the pixel. The tone map (src/lib.rs:841-904) reads the count
and the unquantized ``steps``, and the CLI converts it to 8 bits,
``round(v * 255 / 65535)`` (main.rs:52-57).

It is written from that definition alone and imports nothing of the
program under test. It takes from :mod:`bench_torch.reference` the
constants' reader, the camera, the seed points, the orbit (the map step)
and :func:`reference.color_value`. It adds the EXACT stream, the strict
z-test with the earliest point on equal depth, and the tone map fed from
``steps``. Each float operation is the one the definition names, in its
order, rounded once (no fused multiply-add). A division divides by a
tensor, IEEE on every device.

Departures from upstream's float64 Rust, each also :mod:`reference`'s where
it shares the step:

- The arithmetic is the configuration's precision, float32 (``dtype``),
  and the planes hold float32 depths and values.
- ``lanes`` orbits run side by side, each seeded U[0,1)^3 * 0.1 and warmed
  up, ``steps`` x ``chunks`` steps each, where upstream runs one orbit a
  thread. The program's lane count and chunk schedule are the one thing
  taken from it (``schedule``). The order of the points is the emission's:
  step-major within a chunk (every lane's point of a step before the next
  step's), chunks in turn. "Earliest" means earliest in that order.
- The z-test is taken a chunk at a time: the chunk's greatest depth at a
  pixel, the earliest point that has it, and that point replaces the
  standing pixel when its depth is strictly greater. Over a chunk this is
  the sequential strict test point by point: a later point of equal depth
  never passes, an earlier smaller one is overwritten.
- The two zeros. Upstream's float compare ties -0.0 and +0.0, so whichever
  zero came first keeps the pixel, and its own sign stays in ``zbuf``. The
  reference takes a zero depth as +0.0 before the test, as the program
  does (its bin keys every depth on +0.0), so ``zbuf`` holds +0.0 where
  upstream could hold -0.0. The winner is the same point either way (the
  two zeros still tie, and the earliest is kept), so ``steps`` and
  ``count`` are upstream's, and the Gas image, which reads only those two,
  is the same image. Only the sign bit of a zero depth could differ.
- A NaN depth (an escaped orbit) becomes -inf, which never passes the test
  against the sentinel, as upstream's NaN never passes ``z2 > zbuf``. Its
  pixel is (0, 0), by upstream's saturating cast, as in
  :func:`reference.project`, where it still adds one to the count.

``dtype`` bfloat16 is the control that a sound comparison has to fail.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_torch import reference
from bench_torch.reference import U32, VAL_MAX, Camera, Deployment, mono_u32, rounded, sqrt_rn


def exact_points(dep: Deployment, cam: Camera, new: torch.Tensor, old: torch.Tensor) -> tuple:
    """The EXACT stream of the (3, steps, L) points ``new`` whose previous
    points are ``old``: ``(flat, z2, val)``, flattened step-major. ``flat``
    is the pixel (``npix`` off the canvas, (0, 0) for NaN coordinates,
    src/lib.rs:789-812), ``z2`` the float32 depth (-inf where it is NaN),
    ``val`` the float32 colour value, unquantized."""
    nx, ny, nz = new[0], new[1], new[2]
    m, cc = cam.m, cam.cc
    # the view's rotation, each row (m0 * x + m1 * y) + m2 * z
    sx = (m[0][0] * nx + m[0][1] * ny) + m[0][2] * nz
    sy = (m[1][0] * nx + m[1][1] * ny) + m[1][2] * nz
    sz = (m[2][0] * nx + m[2][1] * ny) + m[2][2] * nz
    val = reference.color_value(dep, nx - old[0], ny - old[1], nz - old[2], sx, sy, sz)
    # the camera: center_camera.y goes with z (src/lib.rs:776-786)
    xc = sx + cc[0]
    zc = sz + cc[1]
    fj = cam.half_h - (sy + cc[2]) * cam.wscaled
    x2 = xc * cam.cos + zc * cam.sin
    z2 = xc * cam.sin - zc * cam.cos
    fi = (cam.mid - x2) * cam.wscaled
    w, h = dep.width, dep.height
    on = ~((fi >= w) | (fj >= h) | (fi < 0.0) | (fj < 0.0))
    col = torch.where(on & ~torch.isnan(fi), fi, 0.0).to(torch.int64)
    row = torch.where(on & ~torch.isnan(fj), fj, 0.0).to(torch.int64)
    flat = torch.where(on, row * w + col, dep.npix)
    z2 = torch.where(torch.isnan(z2), -math.inf, z2).to(torch.float32)
    return flat.reshape(-1), z2.reshape(-1), val.to(torch.float32).reshape(-1)


class ExactPlanes:
    """A frame's three planes: ``count`` (hits mod 2^32, int64 values),
    ``zbuf`` (float32 from the sentinel -1.0 up) and ``steps`` (float32, 0.0
    until a point lands, src/lib.rs:688-693). ``distinct`` lists the pixels
    each binned chunk touched; ``ties`` counts, a chunk at a time, the
    pixels whose outcome the earliest-point rule decided: two or more of
    the chunk's points shared the pixel's greatest depth and it passed the
    test, or the chunk's greatest depth equalled the standing one."""

    def __init__(self, npix: int, device):
        self.count = torch.zeros(npix, dtype=torch.int64, device=device)
        self.zbuf = torch.full((npix,), -1.0, dtype=torch.float32, device=device)
        self.steps = torch.zeros(npix, dtype=torch.float32, device=device)
        self.distinct: list = []
        self.ties = 0

    def bin(self, flat: torch.Tensor, z2: torch.Tensor, val: torch.Tensor) -> None:
        """Every point of a chunk that lands on the canvas: its hit, then the
        strict z-test of the chunk's earliest greatest point a pixel."""
        npix, m = self.count.shape[0], flat.shape[0]
        z2 = torch.where(z2 == 0.0, 0.0, z2)  # -0.0 as +0.0
        on = flat < npix
        f = flat[on]
        hits = torch.bincount(f, minlength=npix)
        self.count = (self.count + hits) & U32
        self.distinct.append(int((hits > 0).sum()))
        if f.numel() == 0:
            return
        # the chunk's greatest depth a pixel, in the total order of float32
        key = mono_u32(z2[on])
        top = torch.full((npix,), -1, dtype=torch.int64, device=f.device)
        top.scatter_reduce_(0, f, key, reduce="amax")
        # of the points at that depth, the earliest in the emission's order
        level = key == top[f]
        order = torch.arange(m, device=f.device)[on][level]
        first = torch.full((npix,), m, dtype=torch.int64, device=f.device)
        first.scatter_reduce_(0, f[level], order, reduce="amin")
        hit = first < m
        pick = torch.where(hit, first, 0)
        best = z2[pick]
        take = hit & (best > self.zbuf)
        shared = torch.bincount(f[level], minlength=npix) > 1
        standing = hit & (best == self.zbuf) & (best > -1.0)
        self.ties += int(((take & shared) | standing).sum())
        self.zbuf = torch.where(take, best, self.zbuf)
        self.steps = torch.where(take, val[pick], self.steps)


def render(dep: Deployment, generator: torch.Generator, schedule: dict, *, angle: float = 0.0,
           dtype: torch.dtype = torch.float32, device="cpu") -> ExactPlanes:
    """An EXACT still: ``schedule`` gives the lanes, the steps of a chunk and
    the chunks; the planes after every chunk's points."""
    p1 = reference.seed_points(generator, schedule["lanes"], dtype, device)
    cam = Camera(dep, angle, dtype)
    planes = ExactPlanes(dep.npix, device)
    for new, old in reference.orbit_chunks(dep, p1, schedule["chunk_steps"],
                                           schedule["nchunks"]):
        planes.bin(*exact_points(dep, cam, new, old))
    return planes


def tonemap8(dep: Deployment, planes: ExactPlanes, *, value=None) -> torch.Tensor:
    """The opaque 8-bit RGB image of a frame's EXACT planes, (H, W, 3) uint8:
    :func:`reference.tonemap8`'s chain (src/lib.rs:841-904, then
    main.rs:52-57's 8-bit conversion) with the palette position read from
    ``steps`` at full float32 (``value``, if given, in its place)."""
    stops = np.asarray(dep.palette, np.float64)
    stops = np.concatenate([stops, stops[-1:]])  # the last stop repeated
    k = stops.shape[0] - 1
    dev = planes.count.device
    val = planes.steps if value is None else value
    v = torch.where(val >= 1.0, rounded(VAL_MAX, torch.float32),
                    torch.clamp(val, min=0.0)) * float(k)
    n = torch.clamp(torch.floor(v).to(torch.int64), 0, k - 1)
    frac = torch.fmod(v, 1.0)[:, None]
    table = torch.from_numpy(stops.astype(np.float32)).to(dev)
    rgb = sqrt_rn(table[n + 1] * frac + table[n] * (1.0 - frac))
    cf = planes.count.to(torch.float32)
    maxc = cf.max()
    factor = torch.log1p(cf.double()).float() / torch.log1p(maxc.double()).float()
    ch = (rgb * factor[:, None] + rounded(dep.brightness_offset, torch.float32)) \
        * rounded(dep.brightness_factor, torch.float32)
    ch = torch.nan_to_num(ch * 65535.0, nan=0.0, posinf=65535.0, neginf=0.0)
    u16 = torch.clamp(ch, 0.0, 65535.0).to(torch.int64)
    u8 = (u16 * 255 + 32767) // 65535  # round(v * 255 / 65535)
    return u8.to(torch.uint8).reshape(dep.height, dep.width, 3)


def quantized(planes: ExactPlanes) -> torch.Tensor:
    """``steps`` as the PACKED planes keep it: the palette position clamped
    to [0, 0.999999] and cut to 12 bits (:func:`reference.pack`), then read
    back as the packed tone map reads it. The exact cell's second control:
    the image this gives has to fail the comparison."""
    q = torch.clamp(torch.nan_to_num(planes.steps, nan=0.0), 0.0,
                    rounded(VAL_MAX, torch.float32))
    bits = float(1 << reference.VAL_BITS)
    return (q * bits).to(torch.int64).to(torch.float32) / bits
