"""The plain reference of the depth pass (upstream's ``--depth``), in plain
PyTorch.

The upstream renderer's Depth render kind (Icelk/strange-attractor-renderer,
``RenderKind::Depth``, src/lib.rs:234-239) keeps, per pixel, the nearest
depth of the points that land there: every map step's point is rotated by
the view and projected to pixel coordinates and a depth ``z2``
(src/lib.rs:754-812), and a point replaces the pixel's depth when ``z2 >
zbuf[i, j]``, on a plane that starts at the sentinel -1.0
(src/lib.rs:818-834). The tone map (src/lib.rs:877-899) folds the plane's
largest and least depth, leaving out the sentinel, from a start of (0.0,
f32::MAX), maps each depth by the reverse lerp ``(z - min) / (max - min)``
to 16-bit gray (0 where the sentinel stands) with an opaque alpha, and the
CLI converts it to 8 bits, ``round(v * 255 / 65535)`` (main.rs:52-57).

It is written from that definition alone and imports nothing of the
program under test; it takes from :mod:`bench_torch.reference` the
constants' reader, the camera, the seed points and the orbit (the map step),
and adds the depth stream, the z-test and the depth tone map. Each float
operation is the one the definition names, in its order, rounded once (no
fused multiply-add); a division divides by a tensor (IEEE on every device).

Departures from upstream's float64 Rust, each also :mod:`reference`'s where
it shares the step:

- the arithmetic is the configuration's precision, float32 (``dtype``), and
  the plane holds float32 depths;
- ``lanes`` orbits run side by side, each seeded U[0,1)^3 * 0.1 and warmed
  up, ``steps`` x ``chunks`` steps each, where upstream runs one orbit a
  thread: the program's lane count and chunk schedule are the one thing
  taken from it (``schedule``);
- the z-test is a maximum in the order-preserving u32 order of float32
  (:func:`reference.mono_u32`), which is upstream's strict ``z2 > zbuf``
  for every depth but the two zeros: the stream's -0.0 is taken as +0.0,
  so that the maximum does not depend on the order of the points (upstream
  keeps whichever zero came first; both map to the same gray);
- a NaN depth (an escaped orbit) becomes -inf, which never passes the test
  against the sentinel, as upstream's NaN never passes ``z2 > zbuf``; its
  pixel is (0, 0) by upstream's saturating cast, as in :func:`reference.project`.

``dtype`` bfloat16 is the control that a sound comparison has to fail.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from bench_torch import reference
from bench_torch.reference import MONO_NEG1, U32, Camera, Deployment, mono_u32

FLT_MAX = float(np.finfo(np.float32).max)


def depth_points(dep: Deployment, cam: Camera, new: torch.Tensor) -> tuple:
    """The depth stream of the (3, steps, L) points ``new``: ``(flat, z2)``,
    flattened step-major. ``flat`` is the pixel (``npix`` off the canvas,
    (0, 0) for NaN coordinates, src/lib.rs:789-812), ``z2`` the float32
    depth, -inf where it is NaN."""
    nx, ny, nz = new[0], new[1], new[2]
    m, cc = cam.m, cam.cc
    # the view's rotation, each row (m0 * x + m1 * y) + m2 * z
    sx = (m[0][0] * nx + m[0][1] * ny) + m[0][2] * nz
    sy = (m[1][0] * nx + m[1][1] * ny) + m[1][2] * nz
    sz = (m[2][0] * nx + m[2][1] * ny) + m[2][2] * nz
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
    return flat.reshape(-1), z2.reshape(-1)


def from_mono(key: torch.Tensor) -> torch.Tensor:
    """The float32 whose :func:`reference.mono_u32` is ``key`` (int64 u32
    values)."""
    bits = torch.where(key < 0x80000000, key ^ U32, key & 0x7FFFFFFF)
    return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32).view(
        torch.float32)


class ZBuffer:
    """A frame's depth plane, held as the mono-u32 keys (int64) of its
    float32 depths from the sentinel -1.0 up; ``distinct`` lists the pixels
    each binned chunk touched."""

    def __init__(self, npix: int, device):
        self.key = torch.full((npix,), MONO_NEG1, dtype=torch.int64, device=device)
        self.distinct: list = []

    def bin(self, flat: torch.Tensor, z2: torch.Tensor) -> None:
        """The z-test of every point of a chunk that lands on the canvas."""
        npix = self.key.shape[0]
        on = flat < npix
        f = flat[on]
        z = z2[on]
        z = torch.where(z == 0.0, 0.0, z)  # -0.0 as +0.0
        self.key.scatter_reduce_(0, f, mono_u32(z), reduce="amax")
        self.distinct.append(int((torch.bincount(f, minlength=npix) > 0).sum()))

    @property
    def zbuf(self) -> torch.Tensor:
        """The plane as float32 depths, (npix,)."""
        return from_mono(self.key)


def render(dep: Deployment, generator: torch.Generator, schedule: dict, *, angle: float = 0.0,
           dtype: torch.dtype = torch.float32, device="cpu") -> ZBuffer:
    """A depth still: ``schedule`` gives the lanes, the steps of a chunk and
    the chunks; the plane after the z-test of every chunk's points."""
    p1 = reference.seed_points(generator, schedule["lanes"], dtype, device)
    cam = Camera(dep, angle, dtype)
    plane = ZBuffer(dep.npix, device)
    for new, _ in reference.orbit_chunks(dep, p1, schedule["chunk_steps"], schedule["nchunks"]):
        plane.bin(*depth_points(dep, cam, new))
    return plane


def tonemap8(dep: Deployment, zbuf: torch.Tensor) -> torch.Tensor:
    """The opaque 8-bit gray RGB image of a depth plane, (H, W, 3) uint8
    (src/lib.rs:877-899, then main.rs:52-57's 8-bit conversion)."""
    valid = zbuf != -1.0
    zero = torch.zeros((), dtype=torch.float32, device=zbuf.device)
    top = torch.maximum(zero, torch.where(valid, zbuf, -math.inf).max())
    least = torch.where(valid, zbuf, FLT_MAX).min()
    t = torch.where(valid, (zbuf - least) / (top - least), 0.0)
    gray = torch.nan_to_num(t * 65535.0, nan=0.0, posinf=65535.0, neginf=0.0)
    u16 = torch.clamp(gray, 0.0, 65535.0).to(torch.int64)  # Rust's saturating `as u16`
    u8 = ((u16 * 255 + 32767) // 65535).to(torch.uint8)  # round(v * 255 / 65535)
    return u8[:, None].expand(-1, 3).reshape(dep.height, dep.width, 3)
