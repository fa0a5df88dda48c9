"""PyTorch port, the CUDA sources of the tile bin run on the CPU.

``csrc/bin_exact.cu`` and ``csrc/bin_exact16.cu`` (both modes of
``csrc/bin_tile.cuh``) are compiled here with g++ against
``tests/cuda_emulation/cuda_runtime.h``, a stub that runs a block's CUDA
threads as fibers, round-robin (a fiber runs on until ``__syncthreads`` or a
warp vote, shuffle or reduction makes it wait for the others), with every ``kernel<<<grid, block, smem, stream>>>(...)`` rewritten into a
loop over blocks. The C entry points are called through ctypes on numpy
arrays and held bit for bit (tolerance 0) against the plain twins of
``ops/binning.py``, which define the result.

The geometry is shrunk with the header's ``SAT_*`` macros (tiles of 4 runs,
at most 8 tiles a band, 2 spans before the table widens, 4096-point spans,
1552 bytes of shared memory), so that canvases of 20 to 2304 pixels and
streams of 300 to 30000 points reach what the card's geometry reaches only
at sizes no CPU test can hold: many tiles, several bands, a ragged last run,
more spans than the table's least width, and the tiles of a very long
chunk's wide modes shrinking by the room the spans' starts take. It shows
what the sources compute, not how the card schedules them: the card's run
is chip_smoke.py.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from strange_attractor_tpu_torch.ops import binning as tb, cuda_lib, kernel_binning as tk
from test_torch_binning import _SPECIAL

STUB = Path(__file__).resolve().parent / "cuda_emulation"
GEOMETRY = {"SAT_TILE_RUNS": 4, "SAT_MAX_TILES": 8, "SAT_MAX_SPANS": 2, "SAT_SPAN_BITS": 12,
            "SAT_SMEM_BYTES": 1552, "EMU_SMS": 3}
GUARD = 0xCDCDCDCD
# NaNs with payloads beside the special floats: the all-ones NaN maps to the
# key word that also marks a dead point
SPECIAL = np.concatenate([_SPECIAL, np.array([0xFFFFFFFF, 0xFFC12345, 0x7FC00001],
                                             np.uint32).view(np.float32)])
# (canvas pixels, points a chunk): 7 tiles in one band and 8 spans, past the
# shrinking of the wide modes' tiles; 3 bands and a ragged second segment; a
# canvas of one ragged run; 3 spans on a canvas of no whole run
SIZES = ((851, 30000), (2304, 4097), (20, 300), (1000, 9000))
MODES = ("exact", "value", "earliest")
CASES = ("random", "ties", "special", "flood", "flood-special", "pixel0-few", "one-run",
         "one-tile", "edge-ties", "all-oob", "negative-oob")


def _split(args: str) -> list:
    out, depth, cur = [], 0, ""
    for ch in args:
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            depth += (ch in "(<") - (ch in ")>")
            cur += ch
    return out + [cur.strip()]


def _as_cxx(text: str) -> str:
    """The CUDA source with its launches and its dynamic shared memory in
    the stub's terms."""
    def launch(mo):
        grid, block, smem, _ = _split(mo.group(2))
        return f"emu::launch({grid}, {block}, {smem}, [=] {{ {mo.group(1)}({mo.group(3)}); }});"

    text = re.sub(r"([A-Za-z_][\w:]*(?:<[\w:<>]+?>)?)<<<(.*?)>>>\s*\((.*?)\);", launch, text,
                  flags=re.S)
    return text.replace("extern __shared__ __align__(16) unsigned char smem[];",
                        "unsigned char* smem = emu::dyn_smem;")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The tile bin's entry points, built for the CPU at GEOMETRY."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CUDA sources for the CPU")
    work = tmp_path_factory.mktemp("tile_emulation")
    for name in ("bin_tile.cuh", "emit_common.cuh", "bin_exact.cu", "bin_exact16.cu"):
        (work / name).write_text(_as_cxx((cuda_lib.CSRC / name).read_text()))
    lib = work / "libtile_emulation.so"
    cmd = [gxx, "-std=c++20", "-O1", "-U_FORTIFY_SOURCE", "-shared", "-fPIC", "-w", f"-I{STUB}",
           *(f"-D{k}={v}" for k, v in GEOMETRY.items()), "-x", "c++",
           str(work / "bin_exact.cu"), str(work / "bin_exact16.cu"), "-o", str(lib)]
    built = subprocess.run(cmd, capture_output=True, text=True)
    assert built.returncode == 0, built.stderr[-4000:]
    lib = ctypes.CDLL(str(lib))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sat_bin_exact.argtypes = [vp] * 8 + [i64, i32, vp]
    lib.sat_bin_exact16.argtypes = [vp] * 8 + [i64, i32, i32, vp]
    lib.sat_bin_tiles.argtypes = [i32]
    return lib


@pytest.fixture
def shrunk(monkeypatch):
    """``ops.kernel_binning``'s buffer sizes at the emulation's geometry."""
    monkeypatch.setattr(tk, "MAX_TILES", GEOMETRY["SAT_MAX_TILES"])
    monkeypatch.setattr(tk, "MAX_SPANS", GEOMETRY["SAT_MAX_SPANS"])
    monkeypatch.setattr(tk, "SPAN_BITS", GEOMETRY["SAT_SPAN_BITS"])


def _kernel(lib, mode, planes, chunk, control) -> None:
    """One chunk into ``planes`` in place through the emulated kernels, on
    work buffers of ``ops.kernel_binning``'s sizes with a guard word behind."""
    m = len(chunk[0])
    records = np.full(tk.record_words(m) + 1, GUARD, np.uint32)
    args = [a.ctypes.data for a in (*planes, control, records, *chunk)] + [m, len(planes[0])]
    err = (lib.sat_bin_exact(*args, None) if mode == "exact"
           else lib.sat_bin_exact16(*args, int(mode == "earliest"), None))
    assert err == 0
    assert records[-1] == GUARD, "the kernels wrote past the work buffer"
    assert not control.any(), "the control words were left dirty"


def _twin(mode, planes, chunk):
    count, steps, zbuf = (torch.from_numpy(p.copy()) for p in planes)
    stream = [torch.from_numpy(a) for a in chunk]
    out = (tb.bin_chunk_exact(count.view(torch.int32), steps, zbuf, *stream) if mode == "exact"
           else tb.bin_chunk_exact16(count.view(torch.int32), steps, zbuf, *stream, ties=mode))
    return out[0].numpy().view(np.uint32), out[1].numpy(), out[2].numpy()


def _tie_z(rng, n):
    z = (rng.integers(-2, 3, n) * 0.25).astype(np.float32)
    z[rng.random(n) < 0.2] = -0.0
    return z, (rng.integers(0, 8, n) / 8).astype(np.float32)


def _stream(case, rng, npix, n, tiles):
    flat = rng.integers(0, npix, n)
    z = rng.normal(0, 0.5, n).astype(np.float32)
    val = rng.random(n).astype(np.float32)
    if case == "random":
        flat[rng.random(n) < 0.05] = npix
    elif case == "ties":
        flat = rng.integers(0, min(50, npix), n)
        z, val = _tie_z(rng, n)
    elif case == "special":
        flat = rng.integers(0, min(64, npix), n)
        z, val = rng.choice(SPECIAL, n), rng.choice(SPECIAL, n)
    elif case == "flood":  # escaped orbits: z = -inf at pixel 0, among real points there
        flat[rng.random(n) < 0.4] = 0
        z[(flat == 0) & (rng.random(n) < 0.6)] = -np.inf
    elif case == "flood-special":
        flat[rng.random(n) < 0.4] = 0
        z[flat == 0] = rng.choice(SPECIAL, int((flat == 0).sum()))
    elif case == "pixel0-few":
        flat[flat == 0] = 1
        flat[rng.choice(n, max(1, n // 100), replace=False)] = 0
    elif case == "one-run":
        flat = rng.integers(0, min(32, npix), n) + (32 if npix >= 64 else 0)
        z, val = _tie_z(rng, n)
    elif case == "one-tile":  # the runs dealt to the canvas's second tile (its first, if one)
        runs = np.arange(min(1, tiles - 1), -(-npix // 32), tiles)
        flat = np.minimum(32 * rng.choice(runs, n) + rng.integers(0, 32, n), npix - 1)
    elif case == "edge-ties":
        edge = 32 * tiles
        edges = [0, 1, 31, 32, 33, 63, 64, edge - 1, edge, edge + 1, edge + 31, edge + 32,
                 2 * edge - 1, 2 * edge, npix - 33, npix - 32, npix - 2, npix - 1]
        flat = rng.choice([p for p in edges if 0 <= p < npix], n)
        z, val = _tie_z(rng, n)
    elif case == "all-oob":
        flat[:] = npix
    else:
        assert case == "negative-oob"
        flat[rng.random(n) < 0.3] = -5
    return flat.astype(np.int32), z, val


def _standing(rng, npix):
    """Random EXACT planes with sentinels, both zeros and z values the tie
    streams hit exactly."""
    zbuf = rng.normal(0, 0.5, npix).astype(np.float32)
    zbuf[rng.random(npix) < 0.3] = -1.0
    k = min(50, npix)
    zbuf[:k] = (rng.integers(-2, 3, k) * 0.25).astype(np.float32)
    if npix > 100:
        zbuf[50:80], zbuf[80:100] = -0.0, 0.0
    return (rng.integers(0, 1000, npix).astype(np.uint32), rng.random(npix).astype(np.float32),
            zbuf)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES)
def test_emulated_cuda_sources_match_the_twin(emulated, shrunk, case, mode):
    """Three chunks (the case, a random one, the case again) onto a standing
    state at every size, one set of control words through all of them."""
    rng = np.random.default_rng(7 + CASES.index(case))
    control = np.zeros(tk.CONTROL_WORDS, np.uint32)
    for npix, n in SIZES:
        tiles = emulated.sat_bin_tiles(npix)
        want = _standing(rng, npix)
        got = tuple(p.copy() for p in want)
        for c in (case, "random", case):
            chunk = _stream(c, rng, npix, n, tiles)
            _kernel(emulated, mode, got, chunk, control)
            want = _twin(mode, want, chunk)
        for name, g, w in zip(("count", "steps", "zbuf"), got, want):
            bad = np.flatnonzero(g.view(np.uint32) != w.view(np.uint32))
            assert bad.size == 0, (f"{npix} px, {n} points, {name}: {bad.size} pixels differ, "
                                   f"first {bad[:8]}: {g[bad[:4]]} against {w[bad[:4]]}")


def test_emulated_geometry_is_the_one_the_sizes_are_chosen_for(emulated, shrunk):
    """The sizes above reach several tiles, several bands, a table wider than
    its least width, and tiles shrunk by the spans' starts."""
    g = GEOMETRY
    assert [emulated.sat_bin_tiles(npix) for npix, _ in SIZES] == [8, 8, 1, 8]
    band_pixels = g["SAT_MAX_TILES"] * g["SAT_TILE_RUNS"] * 32
    assert SIZES[1][0] > 2 * band_pixels  # three bands
    spans = [-(-n >> g["SAT_SPAN_BITS"]) for _, n in SIZES]
    assert spans == [8, 2, 1, 3] and max(spans) > g["SAT_MAX_SPANS"]
    assert tk.record_words(30000) == 60000 + (8 + 2) * 8  # the table widened to 8 spans
    assert tk.record_words(300) == 600 + (2 + 2) * 8
    wide_slot = 12  # a 64-bit key and a count
    assert (g["SAT_SMEM_BYTES"] - 4 * 8) // (32 * wide_slot) < g["SAT_TILE_RUNS"]
    assert (g["SAT_SMEM_BYTES"] - 4 * 3) // (32 * wide_slot) == g["SAT_TILE_RUNS"]
