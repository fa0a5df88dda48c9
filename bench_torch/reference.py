"""The plain reference of the benchmark's timed path, in plain PyTorch.

It renders a strange attractor the way the upstream renderer defines it
(Icelk/strange-attractor-renderer, src/lib.rs): seed points U[0,1)^3 * 0.1,
a warm-up of map steps without emission, then per map step a rotation by the
view, a camera projection to pixel coordinates, a colour value, and a bin
into two planes per pixel -- a hit count, and the max of a (depth, colour)
key -- and at the end the tone map to an 8-bit RGB image. It is written from
that definition alone and imports nothing of the program under test: every
constant comes from the configuration file (``reference`` section).

Each operation is the float operation the definition names, in the order it
names them, one rounding each (no fused multiply-add: every product and sum
is its own torch operation), so that a program which computes the same
arithmetic gives the same bits. Two functions are taken correctly rounded:
the square root (float64, rounded once) and ``log1p`` (float64). A division
by a constant divides by a tensor, because torch's CUDA division by a host
scalar multiplies by its reciprocal instead.

``dtype`` selects the precision of the render's arithmetic: float32 is the
reference; bfloat16 is the control that a sound comparison has to fail.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

U32 = 0xFFFFFFFF
# the order-preserving u32 image of float32 -1.0, the depth sentinel
MONO_NEG1 = 0x407FFFFF
VAL_BITS = 12
VAL_MASK = (1 << VAL_BITS) - 1
ZKEY_MASK = U32 ^ VAL_MASK
# the largest palette position below 1.0 (src/lib.rs:443)
VAL_MAX = 0.999999
# cos and sin of 45.5 degrees, the poisson-saturne classifier's (src/lib.rs:524-536)
COS_45_5 = 0.7009092642998509
SIN_45_5 = 0.7132504491541816


def rounded(v: float, dtype: torch.dtype) -> float:
    """The float64 constant ``v`` as ``dtype`` holds it, rounded once."""
    return float(torch.tensor(float(v), dtype=torch.float64).to(dtype))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root: in float64, rounded once."""
    return torch.sqrt(x.double()).to(x.dtype)


def div_rn(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` with ``b`` rounded to ``a``'s dtype, IEEE on every device."""
    return a / torch.full((), rounded(b, a.dtype), dtype=a.dtype, device=a.device)


@dataclass(frozen=True)
class Deployment:
    """The constants of one configuration as the reference reads them."""

    coefficients: tuple  # three rows of ten: x, y, z (src/lib.rs:588-613)
    center_camera: tuple
    axis: tuple
    rotation: float
    scale: float
    transform: dict  # {"kind": "poisson-saturne"} or {"kind": "adjusted-velocity", ...}
    palette: tuple  # RGB stops
    brightness_offset: float
    brightness_factor: float
    warmup: int
    width: int
    height: int

    @classmethod
    def from_config(cls, config: dict) -> "Deployment":
        ref = config["reference"]
        view = ref["view"]
        return cls(coefficients=tuple(tuple(float(c) for c in ref["coefficients"][k])
                                      for k in ("x", "y", "z")),
                   center_camera=tuple(view["center_camera"]), axis=tuple(view["axis"]),
                   rotation=float(view["rotation"]), scale=float(view["scale"]),
                   transform=dict(ref["transform"]),
                   palette=tuple(tuple(s) for s in ref["palette"]),
                   brightness_offset=float(ref["brightness"]["offset"]),
                   brightness_factor=float(ref["brightness"]["factor"]),
                   warmup=int(ref["warmup"]), width=int(ref["width"]),
                   height=int(ref["height"]))

    @property
    def npix(self) -> int:
        return self.width * self.height


def rotation_matrix(axis, angle: float) -> np.ndarray:
    """Rodrigues' rotation about ``axis`` (not normalised, as the
    upstream release build leaves it, src/lib.rs:179-215), float64."""
    x, y, z = axis
    c, s = math.cos(angle), math.sin(angle)
    c1 = 1.0 - c
    return np.array([[c + x * x * c1, x * y * c1 - z * s, x * z * c1 + y * s],
                     [y * x * c1 + z * s, c + y * y * c1, y * z * c1 - x * s],
                     [z * x * c1 - y * s, z * y * c1 + x * s, c + z * z * c1]])


class Camera:
    """The per-frame constants (src/lib.rs:754-786) in the render's dtype."""

    def __init__(self, dep: Deployment, angle: float, dtype: torch.dtype):
        def r(v):
            return rounded(v, dtype)

        self.m = [[r(v) for v in row] for row in rotation_matrix(dep.axis, dep.rotation)]
        self.cc = [r(v) for v in dep.center_camera]
        self.cos, self.sin = r(math.cos(angle)), r(math.sin(angle))
        self.half_h = r(dep.height / 2.0)
        self.wscaled = r(float(dep.width) * dep.scale)
        self.mid = r(0.5 / dep.scale)


def map_step_fn(dep: Deployment, dtype: torch.dtype, device):
    """The second-degree Sprott map (src/lib.rs:575-621) on a (4, L) tensor
    whose row 0 is ones and rows 1-3 the points: returns a function that
    writes the next points into a (3, L) tensor. Each coordinate is
    ``c0 + c1*x + c2*x^2 + c3*xy + c4*xz + c5*y + c6*y^2 + c7*yz + c8*z +
    c9*z^2`` summed left to right; ``c1*x`` is taken as ``c1*(1*x)``, the
    same product."""
    coef = torch.tensor([[rounded(c, dtype) for c in row] for row in dep.coefficients],
                        dtype=dtype, device=device)  # (3, 10)
    c0, c1 = coef[:, :1], coef[:, 1:, None]  # (3, 1), (3, 9, 1)
    # monomials x, x^2, xy, xz, y, y^2, yz, z, z^2 as products of rows of
    # (1, x, y, z)
    ia = torch.tensor([0, 1, 1, 1, 0, 2, 2, 0, 3], device=device)
    ib = torch.tensor([1, 1, 2, 3, 2, 2, 3, 3, 3], device=device)

    def step(p1: torch.Tensor, out: torch.Tensor) -> None:
        terms = c1 * (p1.index_select(0, ia) * p1.index_select(0, ib))  # (3, 9, L)
        torch.add(c0, terms[:, 0], out=out)
        for k in range(1, 9):
            out.add_(terms[:, k])

    return step


def color_value(dep: Deployment, dx, dy, dz, sx, sy, sz):
    """The colour transform's palette position (src/lib.rs:498-559)."""
    dtype = sx.dtype

    def c(v):
        return rounded(v, dtype)

    mag = sqrt_rn((dx * dx + dy * dy) + dz * dz)
    kind = dep.transform["kind"]
    if kind == "adjusted-velocity":
        return (mag + c(dep.transform["offset"])) * c(dep.transform["factor"])
    if kind != "poisson-saturne":
        raise ValueError(f"no reference colour transform {kind!r}")
    cc = dep.center_camera
    # the upstream classifier pairs center_camera.y with z (src/lib.rs:542-551)
    x2 = (sx + c(cc[0])) * c(COS_45_5) + (sz + c(cc[1])) * c(SIN_45_5)
    outside = ((x2 < c(-0.0839)) | (c(10.55) * x2 + sy < c(0.46 - 1.0941))
               | (c(1.0426) * x2 + sy < c(0.179 - 0.1576))
               | (c(0.5139) * x2 - sy > c(-0.04 - 0.04092)))
    part = torch.where(outside, 0.0, 1.0).to(dtype)
    return div_rn(div_rn(part + mag, 2.0) - c(0.1), 0.9)


def mono_u32(z: torch.Tensor) -> torch.Tensor:
    """Order-preserving float32 -> u32 map, as int64 values."""
    u = z.to(torch.float32).view(torch.int32).to(torch.int64) & U32
    return torch.where((u >> 31) == 1, u ^ U32, u | 0x80000000)


def pack(z: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """The (depth, colour) key of a point, int64 u32 values: 20 bits of the
    depth's order above the -1.0 sentinel, then the palette position in 12
    bits; 0 for a depth at or below the sentinel (src/lib.rs:807-834)."""
    d = (mono_u32(z) - MONO_NEG1) & U32
    q = torch.clamp(torch.nan_to_num(val, nan=0.0), 0.0, rounded(VAL_MAX, torch.float32))
    q = (q * float(1 << VAL_BITS)).to(torch.int64)
    return torch.where(z > -1.0, (d & ZKEY_MASK) | q, 0)


def shared_operands(dep: Deployment, cam: Camera, new: torch.Tensor, old: torch.Tensor):
    """The camera-angle-free part of the projection and the colour value:
    ``(xc, zc, fj, val)`` (src/lib.rs:773-786)."""
    nx, ny, nz = new[0], new[1], new[2]
    m = cam.m
    sx = (m[0][0] * nx + m[0][1] * ny) + m[0][2] * nz
    sy = (m[1][0] * nx + m[1][1] * ny) + m[1][2] * nz
    sz = (m[2][0] * nx + m[2][1] * ny) + m[2][2] * nz
    xc = sx + cam.cc[0]
    zc = sz + cam.cc[1]  # the upstream pairs center_camera.y with z
    fj = cam.half_h - (sy + cam.cc[2]) * cam.wscaled
    val = color_value(dep, nx - old[0], ny - old[1], nz - old[2], sx, sy, sz)
    return xc, zc, fj, val


def project(dep: Deployment, cam: Camera, xc, zc, fj, val):
    """The camera angle's part: pixel coordinates and depth, then the
    bounds test and the key: ``(flat, key)``. A point off the canvas gets
    ``npix``; NaN coordinates of an escaped orbit fail every bounds test
    and land on pixel (0, 0) (src/lib.rs:789-812); a NaN depth becomes -inf."""
    x2 = xc * cam.cos + zc * cam.sin
    z2 = xc * cam.sin - zc * cam.cos
    fi = (cam.mid - x2) * cam.wscaled
    w, h = dep.width, dep.height
    inb = ~((fi >= w) | (fj >= h) | (fi < 0.0) | (fj < 0.0))
    ii = torch.where(inb & ~torch.isnan(fi), fi, 0.0).to(torch.int64)
    jj = torch.where(inb & ~torch.isnan(fj), fj, 0.0).to(torch.int64)
    flat = torch.where(inb, jj * w + ii, dep.npix)
    z2 = torch.where(torch.isnan(z2), -math.inf, z2).to(torch.float32)
    return flat.reshape(-1), pack(z2, val.to(torch.float32)).reshape(-1)


class Planes:
    """A frame's two planes as int64 u32 values: hits (mod 2^32) and the
    max key; ``distinct`` lists the pixels each binned chunk touched."""

    def __init__(self, npix: int, device):
        self.count = torch.zeros(npix, dtype=torch.int64, device=device)
        self.key = torch.zeros(npix, dtype=torch.int64, device=device)
        self.distinct: list = []

    def bin(self, flat: torch.Tensor, key: torch.Tensor) -> None:
        keep = flat < self.count.shape[0]
        f = flat[keep]
        hits = torch.bincount(f, minlength=self.count.shape[0])
        self.count = (self.count + hits) & U32
        self.key = self.key.scatter_reduce(0, f, key[keep], reduce="amax")
        self.distinct.append(int((hits > 0).sum()))


def seed_points(generator: torch.Generator, lanes: int, dtype: torch.dtype, device):
    """Seed points U[0,1)^3 * 0.1 (src/lib.rs:748), drawn in float32 on the
    CPU as (lanes, 3); returned as (4, lanes) in ``dtype`` with a row of
    ones first."""
    u = torch.rand((lanes, 3), generator=generator, dtype=torch.float32)
    pts = (u * rounded(0.1, torch.float32)).to(dtype).t()
    return torch.cat([torch.ones(1, lanes, dtype=dtype), pts]).to(device)


def _steps_runner(step, buf: torch.Tensor, steps: int):
    """A function that advances ``buf[0]`` by ``steps`` map steps into
    ``buf[1:]``. On a card the steps are captured once into a CUDA graph and
    replayed: the same kernels on the same operands, without the host's
    launch cost (a 10^9 frame is some 400,000 launches)."""
    def eager():
        for s in range(steps):
            step(buf[s], buf[s + 1, 1:])

    if buf.device.type != "cuda":
        return eager
    side = torch.cuda.Stream(buf.device)
    side.wait_stream(torch.cuda.current_stream(buf.device))
    with torch.cuda.stream(side):
        eager()  # the first launches outside the capture
    torch.cuda.current_stream(buf.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        eager()
    return graph.replay


def orbit_chunks(dep: Deployment, p1: torch.Tensor, steps: int, nchunks: int):
    """Warm ``p1`` (4, L) ``dep.warmup`` steps, then yield ``nchunks``
    chunks of ``steps`` steps each as ``(new, old)``: the (3, steps, L)
    points after each step and before it."""
    step = map_step_fn(dep, p1.dtype, p1.device)
    buf = torch.empty((steps + 1, 4, p1.shape[1]), dtype=p1.dtype, device=p1.device)
    buf[:, 0] = 1
    run = _steps_runner(step, buf, steps)
    buf[0] = p1
    whole, rest = divmod(dep.warmup, steps)
    for _ in range(whole):
        run()
        buf[0] = buf[steps]
    for s in range(rest):
        step(buf[s], buf[s + 1, 1:])
    p1.copy_(buf[rest])
    for _ in range(nchunks):
        buf[0] = p1
        run()
        p1.copy_(buf[steps])
        pts = buf[:, 1:].transpose(0, 1)  # (3, steps + 1, L)
        yield pts[:, 1:], pts[:, :-1]


def render(dep: Deployment, generator: torch.Generator, schedule: dict, *, angle: float = 0.0,
           dtype: torch.dtype = torch.float32, device="cpu") -> Planes:
    """A still: ``schedule`` gives the lanes, the steps of a chunk and the
    chunks (every lane runs steps x chunks emitting steps after the
    warm-up); the planes after binning every chunk."""
    p1 = seed_points(generator, schedule["lanes"], dtype, device)
    cam = Camera(dep, angle, dtype)
    planes = Planes(dep.npix, device)
    for new, old in orbit_chunks(dep, p1, schedule["chunk_steps"], schedule["nchunks"]):
        planes.bin(*project(dep, cam, *shared_operands(dep, cam, new, old)))
    return planes


def render_shared(dep: Deployment, generator: torch.Generator, schedule: dict, angles,
                  *, dtype: torch.dtype = torch.float32, device="cpu") -> list:
    """One orbit binned at every camera angle of ``angles`` (radians): a
    rotation's frames that share their seed points. Frame ``f`` is
    :func:`render` at ``angles[f]`` of the same seeds."""
    p1 = seed_points(generator, schedule["lanes"], dtype, device)
    cams = [Camera(dep, a, dtype) for a in angles]
    frames = [Planes(dep.npix, device) for _ in angles]
    for new, old in orbit_chunks(dep, p1, schedule["chunk_steps"], schedule["nchunks"]):
        shared = shared_operands(dep, cams[0], new, old)
        for cam, planes in zip(cams, frames):
            planes.bin(*project(dep, cam, *shared))
    return frames


def tonemap8(dep: Deployment, planes: Planes) -> torch.Tensor:
    """The opaque 8-bit RGB image of a frame's planes, (H, W, 3) uint8
    (src/lib.rs:841-904, then main.rs:52-57's 8-bit conversion)."""
    stops = np.asarray(dep.palette, np.float64)
    stops = np.concatenate([stops, stops[-1:]])  # the last stop repeated
    k = stops.shape[0] - 1
    dev = planes.count.device
    val = (planes.key & VAL_MASK).to(torch.float32) / float(1 << VAL_BITS)
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
