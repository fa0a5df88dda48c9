"""PyTorch port, the native PNG encoder (``utils/native.py`` building
``csrc/fastdeflate.cpp`` with g++) against its numpy twin and against the JAX
package's PNG writer, on the CPU.

The native adaptive filter must equal ``_filter_scanlines_numpy`` byte for
byte (tolerance 0). Parallel deflate cuts a payload over 2 MB into 256 KB
stripes deflated on their own, so its bytes differ from ``zlib.compress``'s:
PNGs are compared by their decompressed (filtered) bytes and decoded pixels,
never by their compressed bytes. The parallel stream's bytes are held to
depend on the payload alone, not on the thread count. Skipped only where
there is no g++.
"""

import shutil
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

from strange_attractor_tpu.utils import export as jexport
from strange_attractor_tpu_torch.utils import export, native
from test_export import _decode_png

CASES = [(np.uint8, 3), (np.uint8, 4), (np.uint16, 3), (np.uint16, 4)]
STRIPE = 1 << 18  # fastdeflate.cpp's stripe of input
# just over 2 MB (the parallel path's gate), then k stripes exactly, less
# one byte and plus one: the gate's edge, and a one-byte last stripe
SIZES = [(2 << 20) + 4097, 8 * STRIPE - 1, 8 * STRIPE, 8 * STRIPE + 1,
         13 * STRIPE - 1, 13 * STRIPE, 13 * STRIPE + 1]
HERO = Path(__file__).resolve().parents[1] / "media" / "poisson-saturne-tpu.png"


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build csrc/fastdeflate.cpp")
    built = native.get_lib()
    assert built is not None, "g++ is present but the native library did not build"
    assert native.encoder() == "native"
    return built


def _image(rng, h: int, w: int, dtype, ch: int) -> np.ndarray:
    """A render-like image: dark background, smooth lit blobs, noise, and
    flat runs, so every one of the five filters wins some rows."""
    top = np.iinfo(dtype).max
    yy, xx = np.mgrid[0:h, 0:w]
    blob = np.exp(-(((yy - h / 2) / (h / 4)) ** 2 + ((xx - w / 3) / (w / 5)) ** 2))
    img = (blob[..., None] * top * rng.random(ch)).astype(np.float64)
    img += rng.normal(0, top * 0.02, (h, w, ch)) * (rng.random((h, 1, 1)) < 0.3)
    img[h // 5: h // 4] = top // 3
    return np.clip(img, 0, top).astype(dtype)


def _rows(img: np.ndarray):
    raw = img.astype(">u2") if img.dtype == np.uint16 else img
    h = img.shape[0]
    return np.ascontiguousarray(raw).reshape(h, -1).view(np.uint8).reshape(h, -1), \
        img.shape[-1] * img.itemsize


def _idat(png: bytes) -> bytes:
    pos, data = 8, b""
    while pos < len(png):
        (length,) = struct.unpack(">I", png[pos:pos + 4])
        if png[pos + 4:pos + 8] == b"IDAT":
            data += png[pos + 8:pos + 8 + length]
        pos += 12 + length
    return data


@pytest.mark.parametrize("dtype,ch", CASES)
def test_native_filter_byte_identical_to_numpy(lib, dtype, ch):
    rng = np.random.default_rng(ch * 7 + np.dtype(dtype).itemsize)
    for h, w in ((1, 1), (2, 3), (37, 53), (270, 480)):
        rows, bpp = _rows(_image(rng, h, w, dtype, ch))
        want = export._filter_scanlines_numpy(rows, bpp)
        for threads in (1, 3, 16):
            assert native.png_filter_adaptive(rows, bpp, threads) == want, (h, w, threads)
    assert len({want[r * (1 + rows.shape[1])] for r in range(rows.shape[0])}) >= 3


def test_parallel_deflate_round_trip(lib):
    """A payload over 2 MB takes the parallel path, stripe by stripe, and
    decompresses to itself; a small one goes to zlib.compress."""
    rng = np.random.default_rng(4)
    data = (rng.integers(0, 8, 5_000_003, dtype=np.uint8) * 17).tobytes()
    out = native.zlib_compress_parallel(data, 6, threads=8)
    assert zlib.decompress(out) == data
    assert out != zlib.compress(data, 6)  # stitched stripes, not one stream
    small = data[:100_000]
    assert native.zlib_compress_parallel(small, 6, threads=8) == zlib.compress(small, 6)


def _payload(n: int) -> bytes:
    """Scanline-like bytes: a 20,011-byte motif repeated (so matches reach
    back across stripe boundaries, into the priming) under sparse noise."""
    rng = np.random.default_rng(n)
    data = np.resize(rng.integers(0, 8, 20_011, dtype=np.uint8) * 17, n)
    hits = rng.random(n) < 0.02
    data[hits] = rng.integers(0, 256, int(hits.sum()), dtype=np.uint8)
    return data.tobytes()


@pytest.mark.parametrize("threads", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("n", SIZES)
def test_parallel_deflate_round_trip_at_stripe_edges(lib, n, threads):
    """Every size about a stripe edge, on every thread count, decompresses
    to itself under the header ``zlib.compress`` writes at level 6; one
    stripe a 256 KB above the 2 MB gate, the stdlib's stream below it."""
    data = _payload(n)
    out = native.zlib_compress_parallel(data, 6, threads=threads)
    assert zlib.decompress(out) == data
    assert out[:2] == b"\x78\x9c"
    parallel = n >= 2 << 20 and threads > 1
    assert native.deflate_plan(n, threads) == ((threads, -(-n // STRIPE)) if parallel else (1, 1))
    if not parallel:
        assert out == zlib.compress(data, 6)


@pytest.mark.parametrize("n", [8 * STRIPE, 13 * STRIPE + 1, 6_221_880])
def test_parallel_deflate_bytes_do_not_depend_on_threads(lib, n):
    data = _payload(n)
    outs = {native.zlib_compress_parallel(data, 6, threads=t) for t in (2, 3, 8, 16)}
    assert len(outs) == 1
    assert zlib.decompress(outs.pop()) == data


def test_parallel_deflate_of_the_hero_frame_is_as_small_as_one_stream(lib):
    """The filtered scanlines of the recorded 10^9 poisson-saturne render
    (6,221,880 bytes, 24 stripes): primed stripes cost at most 0.5% over
    one level-6 zlib stream of the same bytes."""
    image = export.read_png(HERO)
    filtered = export._filter_scanlines(image, image.shape[0])
    assert len(filtered) == 6_221_880
    out = native.zlib_compress_parallel(filtered, 6, threads=8)
    assert zlib.decompress(out) == filtered
    assert out[:2] == b"\x78\x9c"
    assert len(out) <= 1.005 * len(zlib.compress(filtered, 6))


@pytest.mark.parametrize("dtype,ch", CASES)
def test_png_decodes_to_jax_pixels(lib, dtype, ch):
    """The port's PNG and the JAX package's hold the same filtered bytes and
    decode to the same pixels: a small image decoded in full, and a 1920 x
    1080 frame (over 2 MB of scanlines: parallel deflate) by its filtered
    bytes."""
    rng = np.random.default_rng(ch + np.dtype(dtype).itemsize)
    small = _image(rng, 24, 40, dtype, ch)
    np.testing.assert_array_equal(_decode_png(export.png_bytes(small)),
                                  _decode_png(jexport.png_bytes(small)))
    np.testing.assert_array_equal(_decode_png(export.png_bytes(small)), small)
    frame = _image(rng, 1080, 1920, dtype, ch)
    got, want = export.png_bytes(frame), jexport.png_bytes(frame)
    filtered = zlib.decompress(_idat(got))
    assert len(filtered) > 2 << 20
    assert filtered == zlib.decompress(_idat(want)) == export._filter_scanlines_numpy(*_rows(frame))
    assert got[:33] == want[:33]  # signature and IHDR


def test_apng_frames_decode_to_their_filtered_bytes(lib):
    frames = np.stack([_image(np.random.default_rng(f), 700, 1100, np.uint8, 3)
                       for f in range(2)])
    data = export.apng_bytes(frames, fps=24.0)
    assert b"acTL" in data and b"fdAT" in data
    idat = zlib.decompress(_idat(data))
    assert idat == export._filter_scanlines_numpy(*_rows(frames[0]))
