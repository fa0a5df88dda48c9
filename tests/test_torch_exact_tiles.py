"""PyTorch port, the EXACT-plane bins on the streams that a bin by canvas
tiles makes risky, against the JAX package on the CPU.

The CUDA kernels of ``csrc/bin_exact.cu`` and ``csrc/bin_exact16.cu``
partition a chunk by canvas tile (runs of 32 pixels dealt round-robin over
the tiles), take the pixel-0 flood out of the stream in the partition and
aggregate each tile in shared memory. They are held bit for bit against the
plain twins on the card by chip_smoke.py; here the twins, which define the
result, are held bit for bit (tolerance 0: every reduction is a min or an
integer add) against the JAX entry points ``bin_chunk_kernel_exact`` and
``bin_chunk_kernel_exact16`` in Pallas interpret mode on exactly those
streams: pixel (0, 0) mixing escaped and winning points above and below the
JAX flood gate, NaN and both zeros at pixel (0, 0), every point in one run,
equal-z ties on both sides of run and tile edges, a 37x23 canvas and a
canvas whose pixel count is no multiple of 32.
"""

import re

import numpy as np
import pytest
import torch

from strange_attractor_tpu.ops import kernel_binning as kb
from strange_attractor_tpu_torch.ops import binning as tb, cuda_lib, kernel_binning as tk
from test_torch_binning import _SPECIAL
from test_torch_exact import _assert_planes_bits, _jax_bin, _port_bin, _standing

N = 4096
# tiles a small canvas could be dealt over; its edges fall at multiples of 32 * TILES
TILES = 6


def _tie_z(rng, n):
    z = (rng.integers(-2, 3, n) * 0.25).astype(np.float32)
    z[rng.random(n) < 0.2] = -0.0
    return z, (rng.integers(0, 8, n) / 8).astype(np.float32)


def _pixel0(rng, npix, n, at0):
    """``at0`` points on pixel 0: 60% escaped (z = -inf, as the EXACT
    emission writes a NaN depth), the rest real points that must win."""
    flat = rng.integers(1, npix, n)
    z = rng.normal(0, 0.5, n).astype(np.float32)
    val = rng.random(n).astype(np.float32)
    where = rng.choice(n, at0, replace=False)
    flat[where] = 0
    z[where[: int(0.6 * at0)]] = -np.inf
    return flat, z, val


def _stream(case: str, rng):
    """(npix, flat int32, z float32, val float32)."""
    npix, n = 64 * 36, N
    flat = rng.integers(0, npix, n)
    z = rng.normal(0, 0.5, n).astype(np.float32)
    val = rng.random(n).astype(np.float32)
    if case == "pixel0-above-gate":  # far past n // 64
        flat, z, val = _pixel0(rng, npix, n, n * 3 // 10)
    elif case == "pixel0-below-gate":
        flat, z, val = _pixel0(rng, npix, n, n // 100)
    elif case == "pixel0-nan-and-zeros":
        flat, z, val = _pixel0(rng, npix, n, n // 4)
        at0 = np.flatnonzero(flat == 0)
        z[at0] = rng.choice(_SPECIAL, at0.size)
    elif case == "pixel0-only-escaped":  # counted, never a winner
        flat, z, val = _pixel0(rng, npix, n, n // 3)
        z[flat == 0] = -np.inf
    elif case == "one-run":
        flat = 96 + rng.integers(0, 32, n)
        z, val = _tie_z(rng, n)
    elif case == "ties-on-run-and-tile-edges":
        edge = 32 * TILES
        flat = rng.choice([0, 1, 31, 32, 33, 63, 64, edge - 1, edge, edge + 1, edge + 31,
                           edge + 32, 2 * edge - 1, 2 * edge, npix - 33, npix - 32, npix - 1], n)
        z, val = _tie_z(rng, n)
    elif case == "canvas-37x23":
        npix = 37 * 23
        flat = rng.integers(0, npix + 1, n)
    else:
        assert case == "canvas-no-multiple-of-32"
        npix = 50 * 21  # 1050 = 32 * 32 + 26
        flat = rng.integers(0, npix + 1, n)
        flat[: n // 8] = npix - 1 - rng.integers(0, 26, n // 8)  # the ragged last run
        z[: n // 8], val[: n // 8] = _tie_z(rng, n // 8)
    return npix, flat.astype(np.int32), z, val


CASES = ["pixel0-above-gate", "pixel0-below-gate", "pixel0-nan-and-zeros", "pixel0-only-escaped",
         "one-run", "ties-on-run-and-tile-edges", "canvas-37x23", "canvas-no-multiple-of-32"]
MODES = {"exact": (kb.bin_chunk_kernel_exact, tb.bin_chunk_exact, {}),
         "exact16-value": (kb.bin_chunk_kernel_exact16, tb.bin_chunk_exact16, {"ties": "value"}),
         "exact16-earliest": (kb.bin_chunk_kernel_exact16, tb.bin_chunk_exact16,
                              {"ties": "earliest"})}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("case", CASES)
def test_tile_risky_streams_match_the_jax_kernel(case, mode):
    """Two chunks of the case onto a random standing state (which holds
    -0.0, +0.0 and z values the tie streams hit exactly)."""
    rng = np.random.default_rng(CASES.index(case) + 40)
    jfn, tfn, kw = MODES[mode]
    chunks = [_stream(case, rng) for _ in range(2)]
    want = got = _standing(rng, chunks[0][0])
    for _, *chunk in chunks:
        want = _jax_bin(jfn, want, chunk, 1 << 10, **kw)
        got = _port_bin(tfn, got, chunk, **kw)
    _assert_planes_bits(got, want)
    npix, flat = chunks[0][:2]
    assert got[0].sum() > 0 and ((flat >= 0) & (flat < npix)).any()


@pytest.mark.parametrize("mode", list(MODES))
def test_pixel0_real_point_beats_the_escaped_flood(mode):
    """One real point among a flood of escaped ones on pixel (0, 0): it
    wins the pixel, and every point counts, in the JAX kernel and in the
    twin alike."""
    jfn, tfn, kw = MODES[mode]
    n = 512
    flat = np.zeros(n, np.int32)
    z = np.full(n, -np.inf, np.float32)
    val = np.zeros(n, np.float32)
    z[300], val[300] = 0.5, 0.75
    blank = (np.zeros(64, np.uint32), np.zeros(64, np.float32), np.full(64, -1.0, np.float32))
    want = _jax_bin(jfn, blank, (flat, z, val), 1 << 10, **kw)
    count, steps, zbuf = got = _port_bin(tfn, blank, (flat, z, val), **kw)
    _assert_planes_bits(got, want)
    assert count[0] == n and steps[0] == 0.75 and zbuf[0] == 0.5
    assert count[1:].sum() == 0 and (zbuf[1:] == -1.0).all()


# ------------------------------------------------------- the work buffers ---


def _header_constants():
    """The integer constants of csrc/bin_tile.cuh, by name."""
    text = (cuda_lib.CSRC / "bin_tile.cuh").read_text()
    found = dict(re.findall(r"#define (SAT_\w+) (\d+)", text))
    found.update(re.findall(r"constexpr int (\w+) = (\d+)[;,]", text))
    return {k: int(v) for k, v in found.items()}


def test_work_buffer_sizes_mirror_the_cuda_header():
    """``new_work`` allocates what ``csrc/bin_tile.cuh`` lays out: two
    words a record, then the tiles x spans table (one column a span of
    2^SPAN_BITS points once a chunk outgrows the least width) with the
    totals and the bucket starts behind it, and a control block of the
    pixel-0 aggregate. tests/test_torch_tile_emulation.py runs the header's
    layout inside buffers of these sizes."""
    c = _header_constants()
    assert (tk.MAX_TILES, tk.MAX_SPANS, tk.SPAN_BITS) == (
        c["SAT_MAX_TILES"], c["SAT_MAX_SPANS"], c["SAT_SPAN_BITS"])
    least = tk.MAX_SPANS << tk.SPAN_BITS  # points of the table's least width
    assert tk.table_words(1) == tk.table_words(least) == (tk.MAX_SPANS + 2) * tk.MAX_TILES
    assert tk.table_words(least + 1) == (tk.MAX_SPANS + 3) * tk.MAX_TILES
    assert tk.table_words((1 << 31) - 1) == ((1 << 31 - tk.SPAN_BITS) + 2) * tk.MAX_TILES
    assert tk.record_words(least + 1) == 2 * (least + 1) + tk.table_words(least + 1)
    assert c["SLOT_BITS"] + c["SAT_SPAN_BITS"] <= 32  # slot and offset share a record's word
    assert tk.CONTROL_WORDS * 4 == 8 + 4 + 4  # struct Control: u64 key0_inv, n0, pad
    assert c["SAT_TILE_RUNS"] * c["RUN"] <= 1 << c["SLOT_BITS"]
    # a full tile of the widest slot (a 64-bit key and a count) and the starts
    # of an ordinary chunk's spans fit the shared memory a block may ask for
    assert c["SAT_TILE_RUNS"] * c["RUN"] * 12 + 4 * tk.MAX_SPANS <= c["SAT_SMEM_BYTES"]
    work = tk.new_work(1000, "cpu")
    assert work.records.dtype == torch.int32
    assert work.records.numel() == 2000 + tk.table_words(1000)
    assert work.control.dtype == torch.int32 and work.control.numel() == tk.CONTROL_WORDS
    assert not work.control.any()


def test_every_cuda_source_and_header_is_built_and_hashed():
    assert sorted(cuda_lib.SOURCES) == sorted(p.name for p in cuda_lib.CSRC.glob("*.cu"))
    assert sorted(cuda_lib.HEADERS) == sorted(p.name for p in cuda_lib.CSRC.glob("*.cuh"))


@pytest.mark.parametrize("fn", ["exact", "exact16"])
def test_a_cpu_work_buffer_is_refused_for_a_cuda_launch_and_ignored_on_the_cpu(fn):
    """On CPU tensors the wrapper runs the twin and never looks at
    ``work``; the launch path's check refuses buffers that are not on the
    card."""
    wrapper = tk.bin_chunk_kernel_exact if fn == "exact" else tk.bin_chunk_kernel_exact16
    twin = tb.bin_chunk_exact if fn == "exact" else tb.bin_chunk_exact16
    rng = np.random.default_rng(50)
    npix, *chunk = _stream("canvas-37x23", rng)
    state = _standing(rng, npix)
    work = tk.new_work(8, "cpu")  # too small and on the CPU: unused here
    _assert_planes_bits(_port_bin(wrapper, state, chunk, work=work), _port_bin(twin, state, chunk))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk._work(N, work, "cuda:0")
