"""PyTorch port, the CUDA source of kernel F runs on the CPU.

``csrc/png_filter.cu`` (``sat_png_filter``, the adaptive PNG scanline filter
of a delivered image) is compiled here with g++ against
``tests/cuda_emulation/cuda_runtime.h`` (a block's CUDA threads as fibers,
``<<<>>>`` rewritten into a loop over blocks, as in
``test_torch_tile_emulation.py``) and called through ctypes with the
argument types the card's build binds (``ops.cuda_lib.ARGTYPES``) on numpy
images. Its bytes are held, byte for byte, to
``utils.export._filter_scanlines_numpy`` of the image's PNG scanlines
(16-bit samples big-endian), in all four layouts the writers take: 8- and
16-bit, RGB and RGBA, and to the JAX package's ``_filter_scanlines_numpy``
in each layout. The shapes give rows of one pixel, rows shorter than a
warp and rows of several turns of the block's 256 threads with a ragged
last one; a render-like image makes every filter win some rows, a constant
one ties them all. Guard bytes past the output must stay as they were.

It shows what the source computes, not how the card schedules it: the
card's run is chip_smoke.py's phase 33.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from strange_attractor_tpu_torch.ops import cuda_lib
from strange_attractor_tpu_torch.utils import export
from test_torch_encoder import _image, _rows
from test_torch_png_filter import _jax_filter
from test_torch_tile_emulation import STUB, _as_cxx

LAYOUTS = ((np.uint8, 3), (np.uint8, 4), (np.uint16, 3), (np.uint16, 4))
SHAPES = ((1, 1), (2, 3), (37, 53), (23, 301))
GUARD = 0xCD


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Kernel F's entry point, built for the CPU."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CUDA sources for the CPU")
    work = tmp_path_factory.mktemp("png_filter_emulation")
    source = work / "png_filter.cu"
    source.write_text(_as_cxx((cuda_lib.CSRC / "png_filter.cu").read_text()))
    lib = work / "libpng_filter_emulation.so"
    cmd = [gxx, "-std=c++20", "-O1", "-U_FORTIFY_SOURCE", "-shared", "-fPIC", "-w", f"-I{STUB}",
           "-x", "c++", str(source), "-o", str(lib)]
    built = subprocess.run(cmd, capture_output=True, text=True)
    assert built.returncode == 0, built.stderr[-4000:]
    lib = ctypes.CDLL(str(lib))
    lib.sat_png_filter.argtypes = [*cuda_lib.ARGTYPES["sat_png_filter"], ctypes.c_void_p]
    lib.sat_png_filter.restype = ctypes.c_int
    return lib


def _run(lib, img: np.ndarray) -> bytes:
    """The kernel's bytes for ``img`` as the card holds it (native byte
    order), with the output's guard bytes checked."""
    img = np.ascontiguousarray(img)
    h, w, ch = img.shape
    stride = w * ch * img.itemsize
    n = h * (1 + stride)
    out = np.full(n + 64, GUARD, np.uint8)
    before = img.copy()
    err = lib.sat_png_filter(img.ctypes.data, h, stride, ch * img.itemsize,
                             int(img.dtype == np.uint16), out.ctypes.data, None)
    assert err == 0
    assert (out[n:] == GUARD).all(), "the kernel wrote past its output"
    assert np.array_equal(img, before)
    return out[:n].tobytes()


def _cases():
    for dtype, ch in LAYOUTS:
        for h, w in SHAPES:
            yield pytest.param(dtype, ch, h, w, "render", id=f"{dtype.__name__}-{ch}-{h}x{w}")
        yield pytest.param(dtype, ch, 19, 40, "constant", id=f"{dtype.__name__}-{ch}-constant")


@pytest.mark.parametrize("dtype,ch,h,w,kind", _cases())
def test_kernel_bytes_equal_the_numpy_filter(emulated, dtype, ch, h, w, kind):
    if kind == "constant":
        img = np.full((h, w, ch), np.iinfo(dtype).max // 3, dtype)
    else:
        img = _image(np.random.default_rng(h * 1000 + w), h, w, dtype, ch)
    want = export._filter_scanlines_numpy(*_rows(img))
    assert _run(emulated, img) == want


@pytest.mark.parametrize("dtype,ch", LAYOUTS, ids=lambda v: getattr(v, "__name__", str(v)))
def test_kernel_bytes_equal_the_jax_filter(emulated, dtype, ch):
    img = _image(np.random.default_rng(ch * 31 + np.dtype(dtype).itemsize), 29, 75, dtype, ch)
    assert _run(emulated, img) == _jax_filter(img)


def test_a_render_like_image_makes_every_filter_win(emulated):
    """The largest case holds every filter type, so the kernel's residuals
    of each are compared above."""
    img = _image(np.random.default_rng(7), 97, 130, np.uint16, 4)
    got = np.frombuffer(_run(emulated, img), np.uint8).reshape(97, -1)
    assert set(got[:, 0]) == {0, 1, 2, 3, 4}
    assert got.tobytes() == export._filter_scanlines_numpy(*_rows(img))


def test_the_entry_point_refuses_what_it_cannot_filter(emulated):
    out = np.full(16, GUARD, np.uint8)
    img = np.zeros(12, np.uint8)
    # a 16-bit image of an odd pixel size, a negative row count
    assert emulated.sat_png_filter(img.ctypes.data, 1, 6, 3, 1, out.ctypes.data, None) == 1
    assert emulated.sat_png_filter(img.ctypes.data, -1, 6, 3, 0, out.ctypes.data, None) == 1
    # no rows: nothing launched, nothing written
    assert emulated.sat_png_filter(img.ctypes.data, 0, 6, 3, 0, out.ctypes.data, None) == 0
    assert (out == GUARD).all()
