"""PyTorch port, the CUDA source of the depth bin runs on the CPU.

``csrc/bin_depth.cu`` is compiled here with g++ against
``tests/cuda_emulation/cuda_runtime.h`` (a block's CUDA threads as fibers,
``<<<>>>`` rewritten into a loop over blocks, as in
``test_torch_tile_emulation.py``), called through ctypes on numpy arrays and
held bit for bit (tolerance 0) against the plain twin
``ops.binning.bin_chunk_depth``, which defines the result.

The stub's SM count and resident blocks (3 x 2 blocks of 256 threads) make
the longest stream take several turns of the grid-stride loop with a
ragged last turn. The sizes put the streams as views at every offset from
a 16-byte boundary, flat and z at one offset and at two, with ragged
lengths, streams shorter than one turn or one block, and a one-pixel
canvas, all of whose points are pixel 0's. It shows what the source
computes, not how the card schedules it: the card's run is chip_smoke.py.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from strange_attractor_tpu_torch.ops import binning as tb, cuda_lib
from test_torch_tile_emulation import SPECIAL, STUB, _as_cxx

GEOMETRY = {"EMU_SMS": 3, "EMU_RESIDENT": 2}
GUARD = np.uint32(0xCDCDCDCD).view(np.float32)
# NaN bit patterns of both signs, the all-ones one (key 0, the least) among them
NANS = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF, 0xFFC12345, 0x7FC00001,
                 0xFF800001], np.uint32).view(np.float32)
# (canvas pixels, points, word offset of flat and of z from a 16-byte boundary)
SIZES = ((2304, 30000, 0, 0), (851, 9001, 1, 1), (1000, 4099, 2, 3), (64, 203, 3, 3),
         (20, 3, 1, 1), (1, 1000, 0, 0))
KINDS = ("random", "out-of-bounds", "ties", "special", "flood-inf", "pixel0-inf-few",
         "flood-nan", "pixel0-nan-few", "zeros", "sentinel-plane")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The depth bin's entry point, built for the CPU."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CUDA sources for the CPU")
    work = tmp_path_factory.mktemp("depth_emulation")
    for name in ("emit_common.cuh", "bin_depth.cu"):
        (work / name).write_text(_as_cxx((cuda_lib.CSRC / name).read_text()))
    lib = work / "libdepth_emulation.so"
    cmd = [gxx, "-std=c++20", "-O1", "-U_FORTIFY_SOURCE", "-shared", "-fPIC", "-w", f"-I{STUB}",
           *(f"-D{k}={v}" for k, v in GEOMETRY.items()), "-x", "c++", str(work / "bin_depth.cu"),
           "-o", str(lib)]
    built = subprocess.run(cmd, capture_output=True, text=True)
    assert built.returncode == 0, built.stderr[-4000:]
    lib = ctypes.CDLL(str(lib))
    lib.sat_bin_depth.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                          ctypes.c_void_p]
    return lib


def _at(a: np.ndarray, words: int) -> np.ndarray:
    """A copy of ``a`` that starts ``words`` 4-byte words past a 16-byte
    boundary."""
    buf = np.empty(len(a) + 8, a.dtype)
    start = (-buf.ctypes.data % 16) // 4 + words
    out = buf[start:start + len(a)]
    out[:] = a
    assert out.ctypes.data % 16 == 4 * words
    return out


def _stream(kind, rng, npix, n):
    flat = rng.integers(0, npix, n)
    z = rng.normal(0, 0.5, n).astype(np.float32)
    if kind == "random":
        flat[rng.random(n) < 0.05] = npix
    elif kind == "out-of-bounds":  # kernel A's npix, and what no caller makes
        r = rng.random(n)
        flat[r < 0.3] = npix
        flat[(r >= 0.3) & (r < 0.4)] = -5
        flat[(r >= 0.4) & (r < 0.5)] = npix + 7
    elif kind == "ties":
        flat = rng.integers(0, min(50, npix), n)
        z = (rng.integers(-2, 3, n) * 0.25).astype(np.float32)
    elif kind == "special":
        flat = rng.integers(0, min(64, npix), n)
        z = rng.choice(SPECIAL, n)
    elif kind.startswith(("flood", "pixel0")):
        # above and below chunk/64 at pixel 0: escaped orbits (-inf, or NaN
        # keys of both signs beside -inf) among real points there
        at0 = rng.random(n) < (0.4 if kind.startswith("flood") else 0.01)
        flat[at0] = 0
        escaped = at0 & (rng.random(n) < 0.6)
        if kind.endswith("inf"):
            z[escaped] = -np.inf
        else:
            z[escaped] = rng.choice(NANS, int(escaped.sum()))
            z[at0 & ~escaped & (rng.random(n) < 0.5)] = -np.inf
    elif kind == "zeros":  # both zeros against standing -0.0, at pixel 0 too
        flat = rng.integers(0, min(100, npix), n)
        z = rng.choice(np.array([0.0, -0.0, -0.0, -1.5], np.float32), n)
    else:
        assert kind == "sentinel-plane"
    return flat.astype(np.int32), z


def _standing(kind, rng, npix):
    """A random plane with -1.0 sentinels and bands of -0.0 and +0.0 (pixel 0
    a standing -0.0), or the blank plane of a fresh render."""
    if kind == "sentinel-plane":
        return np.full(npix, -1.0, np.float32)
    zbuf = rng.normal(0, 0.5, npix).astype(np.float32)
    zbuf[rng.random(npix) < 0.3] = -1.0
    zbuf[: min(50, npix)] = (rng.integers(-2, 3, min(50, npix)) * 0.25).astype(np.float32)
    zbuf[50:80], zbuf[80:100] = -0.0, 0.0
    zbuf[0] = -0.0
    return zbuf


@pytest.mark.parametrize("size", SIZES, ids=[f"{p}px-{n}pts-at{a}+{b}" for p, n, a, b in SIZES])
@pytest.mark.parametrize("kind", KINDS)
def test_emulated_bin_depth_matches_the_twin(emulated, kind, size):
    """Three chunks (the kind, a random one, the kind again) onto a standing
    plane, the kernel in place with a guard word behind the plane."""
    npix, n, off_flat, off_z = size
    rng = np.random.default_rng(11 + KINDS.index(kind))
    want = _standing(kind, rng, npix)
    plane = np.append(want, GUARD)
    for k in (kind, "random", kind):
        flat, z = _stream(k, rng, npix, n)
        flat, z = _at(flat, off_flat), _at(z, off_z)
        err = emulated.sat_bin_depth(plane.ctypes.data, flat.ctypes.data, z.ctypes.data, n, npix,
                                     None)
        assert err == 0, f"CUDA error {err}"
        want = tb.bin_chunk_depth(torch.from_numpy(want), torch.from_numpy(flat),
                                  torch.from_numpy(z))[0].numpy()
    assert plane.view(np.uint32)[-1] == GUARD.view(np.uint32), "the kernel wrote past the plane"
    got = plane[:npix]
    bad = np.flatnonzero(got.view(np.uint32) != want.view(np.uint32))
    assert bad.size == 0, (f"{bad.size} pixels differ, first {bad[:8]}: "
                           f"{got[bad[:4]].view(np.uint32)} against {want[bad[:4]].view(np.uint32)}")
