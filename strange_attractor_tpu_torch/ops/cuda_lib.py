"""Build, load and bind the hand-written CUDA kernels of ``csrc/``.

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes`` -- a few seconds, where a build against
PyTorch's C++ headers takes minutes. Each source compiles in its own
``nvcc`` process, all started together, and one more links them. The build
happens at first use, into ``build/torch_kernels/`` beside the package,
under a name keyed on a hash of the sources and flags, so a changed source
rebuilds and an unchanged one loads the existing library. Nothing is built
at import: the CPU tests import every module on machines with no CUDA
toolkit.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so that no multiply
and add contract into an FMA -- the kernels then round exactly as their
plain PyTorch twins, whose eager ops never contract. Division and square
root stay IEEE (no ``--use_fast_math``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# the longest compiles first: kernel A's five sources instantiate 31
# kernels per (compute type, map) pair
SOURCES = ("map_emit_f64_cyclic.cu", "map_emit_f64.cu", "map_emit_rk4_cyclic.cu",
           "map_emit_rk4.cu", "map_emit.cu", "project_emit.cu", "bin_packed.cu", "bin_depth.cu",
           "bin_exact.cu", "bin_exact16.cu", "tonemap.cu", "png_filter.cu")
HEADERS = ("emit_common.cuh", "map_emit.cuh", "bin_tile.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
              "-std=c++17", "-Xcompiler", "-fPIC")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def _emit_fields(real) -> list:
    """The fields of ``struct EmitParamsT<T>`` (``csrc/emit_common.cuh``)
    with ``real`` for T."""
    return [
        ("coef", real * 30), ("mc", real * 3),
        ("h", real), ("hh", real), ("h6", real),
        ("rot", real * 9),
        ("cos_v", real), ("sin_v", real),
        ("ccx", real), ("ccy", real), ("ccz", real),
        ("mid", real), ("wscaled", real), ("half_h", real),
        ("t_offset", real), ("t_factor", real),
        ("map", ctypes.c_int), ("transform", ctypes.c_int),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
    ]


class EmitParams(ctypes.Structure):
    """Mirror of ``EmitParams`` (``EmitParamsT<float>``) in
    ``csrc/emit_common.cuh``."""

    _fields_ = _emit_fields(ctypes.c_float)


class EmitParams64(ctypes.Structure):
    """Mirror of ``EmitParams64`` (``EmitParamsT<double>``), the float64
    compute path's launch constants."""

    _fields_ = _emit_fields(ctypes.c_double)


class ReseedArgs(ctypes.Structure):
    """Mirror of ``struct Reseed`` in ``csrc/emit_common.cuh``: the lane
    age pointer (0: reseeding off), the render key, the chunk index and the
    warm-up length."""

    _fields_ = [("age", ctypes.c_void_p), ("key", ctypes.c_uint64), ("chunk", ctypes.c_uint32),
                ("warmup", ctypes.c_int)]


_vp, _i32, _i64, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# each entry point's arguments before the stream, which every one takes last;
# each returns cudaGetLastError()
ARGTYPES = {
    "sat_map_emit": [_vp, _i32, _i32, _i32, EmitParams, ReseedArgs, _vp, _vp, _vp, _vp],
    "sat_map_emit_f64": [_vp, _i32, _i32, _i32, EmitParams64, ReseedArgs, _vp, _vp, _vp, _vp],
    "sat_project_emit": [_i64, _i32, EmitParams, _vp, _vp, _vp, _vp, _vp, _vp],
    "sat_project_emit_f64": [_i64, _i32, EmitParams64, _vp, _vp, _vp, _vp, _vp, _vp, _vp],
    "sat_bin_packed": [_vp, _vp, _vp, _vp, _i64, _i32],
    "sat_bin_depth": [_vp, _vp, _vp, _i64, _i32],
    "sat_bin_exact": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i64, _i32],
    "sat_bin_exact16": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _i64, _i32, _i32],
    "sat_tonemap_stats": [_vp, _vp, _vp, _i64, _i32, _vp, _vp],
    "sat_tonemap": [_vp, _vp, _vp, _vp, _vp, _vp, _i32, _f32, _f32, _i64, _i32, _i32, _i32, _i32,
                    _vp],
    "sat_png_filter": [_vp, _i64, _i64, _i32, _i32, _vp],
}


_LIB: dict = {}
# device index -> compute capability, asked once per device instead of on
# every launch
_CAPABILITY: dict = {}


def nvcc() -> str:
    """The path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                           "kernels are built from csrc/ at first use")
    return str(path)


def library_path() -> Path:
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode() + (CSRC / name).read_bytes())
    return BUILD_DIR / f"libsat_torch_{h.hexdigest()[:16]}.so"


def check_run(cmd: list, proc: subprocess.Popen) -> None:
    """Wait for an ``nvcc`` process; raise with its output if it failed."""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{Path(s).stem}.o") for s in SOURCES]
        cmds = [[compiler, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)] for s, o in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        try:
            for cmd, proc in zip(cmds, procs):
                check_run(cmd, proc)
        finally:
            for proc in procs:
                proc.kill()
                proc.wait()
        lib = str(Path(tmp) / "lib.so")
        cmd = [compiler, "-shared", "-o", lib, *objs]
        check_run(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
        os.replace(lib, path)  # atomic: two processes building at once race harmlessly
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    lib = _LIB.get("lib")
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(build()))
    for name, types in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = [*types, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # no launch: the tiles csrc/bin_tile.cuh cuts a canvas of npix pixels into
    lib.sat_bin_tiles.argtypes = [ctypes.c_int]
    lib.sat_bin_tiles.restype = ctypes.c_int
    _LIB["lib"] = lib
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``name`` with ``args`` (tensor pointers as
    ``data_ptr()`` ints) on ``device``'s current stream; raise if it
    reports a CUDA error."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    check_launch(err, name)


def check_tensor(t: torch.Tensor, dtype, name: str) -> None:
    """Raise unless ``t`` is a contiguous tensor on a Hopper card of
    ``dtype`` (or of one of the dtypes of a tuple)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    cap = _CAPABILITY.get(t.device.index)  # a tensor's CUDA device has its index
    if cap is None:
        cap = _CAPABILITY[t.device.index] = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a (Hopper); "
                           f"{torch.cuda.get_device_name(t.device)} is sm_{cap[0]}{cap[1]}")


def check_launch(err: int, name: str) -> None:
    """Raise if the C entry point reported a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
