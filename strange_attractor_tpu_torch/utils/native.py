"""Build and load the native PNG helpers: the adaptive scanline filter and a
parallel deflate (``csrc/fastdeflate.cpp``, host code for the CPU).

The loader follows the JAX package's ``strange_attractor_tpu/utils/native.py``
and builds the way :mod:`ops.cuda_lib` builds the CUDA sources: with
``g++`` at first use into ``build/torch_kernels/`` beside the package, under
a name keyed on a hash of the source, then loaded with ``ctypes``. Nothing
builds at import. Everything degrades: without ``g++`` or zlib's headers the
callers fall back to numpy and the stdlib's ``zlib`` (:func:`encoder` says
which one runs).

The parallel deflate is the port's own: a payload from 2 MB up is cut into
fixed 256 KB stripes (the last takes the rest; the count depends on the
length alone, :func:`deflate_plan`), each primed with the 32 KB of input
before it, which the threads pull from a shared counter; the stripes are
joined into one zlib stream behind the level-6 header ``78 9c``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import zlib
from typing import Optional

from ..ops.cuda_lib import BUILD_DIR, CSRC

SOURCE = CSRC / "fastdeflate.cpp"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> Optional[ctypes.CDLL]:
    gxx = shutil.which("g++")
    if gxx is None or not SOURCE.exists():
        return None
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libfastdeflate_{tag}.so"
    if not so.exists():
        # a per-process temporary name: two cold processes would otherwise
        # race on one path, and os.replace could promote a half-written .so
        tmp = so.with_suffix(f".tmp.{os.getpid()}.so")
        cmd = [gxx, "-O3", "-shared", "-fPIC", "-std=c++17", str(SOURCE), "-o", str(tmp),
               "-lz", "-lpthread"]
        try:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.fastdeflate_stripes.restype = ctypes.c_long
    lib.fastdeflate_stripes.argtypes = [ctypes.c_long]
    lib.fastdeflate_zlib.restype = ctypes.c_long
    lib.fastdeflate_zlib.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_void_p, ctypes.c_long]
    lib.fastdeflate_png_filter.restype = ctypes.c_int
    lib.fastdeflate_png_filter.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None if it cannot be built or loaded."""
    global _LIB, _TRIED
    with _LOCK:
        if not _TRIED:
            _LIB = _build()
            _TRIED = True
        return _LIB


def encoder() -> str:
    """``"native"`` when the PNG writers filter and deflate through the
    native library, ``"stdlib"`` when they fall back to numpy and zlib."""
    return "native" if get_lib() is not None else "stdlib"


def deflate_plan(n: int, threads: Optional[int] = None) -> tuple[int, int]:
    """(threads, stripes) :func:`zlib_compress_parallel` deflates ``n``
    bytes with (``threads`` as it is given there): one stripe a 256 KB of
    input (the last takes the rest), or (1, 1) where it takes the stdlib's
    ``zlib.compress``. One look at the library."""
    if threads is None:
        threads = min(16, os.cpu_count() or 1)
    lib = get_lib()
    if lib is None or n < (1 << 21) or threads < 2:
        return 1, 1
    return threads, lib.fastdeflate_stripes(n)


def zlib_compress_parallel(data, level: int = 6, threads: Optional[int] = None) -> bytes:
    """A zlib stream of ``data`` (bytes, or a flat C-contiguous uint8
    array) deflated on up to 16 threads; the stdlib's ``zlib.compress`` for
    payloads under 2 MB, on one core, or without the library. Above 2 MB
    the payload is cut into 256 KB stripes, each primed with the 32 KB
    before it and deflated on its own, which the threads take in turn from
    a shared counter. The stream decompresses with ``zlib.decompress``; its
    bytes differ from ``zlib.compress``'s but depend on ``data`` alone,
    never on the thread count."""
    n = len(data)
    threads, stripes = deflate_plan(n, threads)
    if threads < 2:
        return zlib.compress(data, level)
    import numpy as np

    lib = get_lib()
    # deflate's worst case, stored blocks, is under n >> 9 beyond n; each
    # stripe adds its own stream's slack: a full flush's empty stored block
    # (5 bytes and a partial byte) and deflateBound's per-stream constant
    cap = n + (n >> 9) + 64 + 32 * stripes
    out = ctypes.create_string_buffer(cap)
    written = lib.fastdeflate_zlib(np.frombuffer(data, np.uint8).ctypes.data, n, level, threads,
                                   out, cap)
    if written <= 0:
        return zlib.compress(data, level)
    return out.raw[:written]


def png_filter_adaptive(rows, bpp: int, threads: Optional[int] = None):
    """The adaptive PNG scanline filter in native code, or None without the
    library. ``rows`` is a C-contiguous (h, stride) uint8 array of raw
    scanlines; returns the h * (1 + stride) filtered bytes (filter byte,
    then the row), byte-identical to ``utils.export._filter_scanlines_numpy``."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    if rows.dtype != np.uint8 or rows.ndim != 2 or not rows.flags.c_contiguous:
        raise ValueError("rows must be a C-contiguous (h, stride) uint8 array")
    h, stride = rows.shape
    if threads is None:
        threads = min(16, os.cpu_count() or 1)
    out = ctypes.create_string_buffer(h * (1 + stride))
    if lib.fastdeflate_png_filter(rows.ctypes.data, h, stride, bpp, max(1, threads), out) != 0:
        return None
    return out.raw
