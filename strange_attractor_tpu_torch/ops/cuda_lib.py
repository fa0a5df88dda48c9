"""Build, load and bind the hand-written CUDA kernels of ``csrc/``.

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded with ``ctypes`` -- a few seconds, where a build against
PyTorch's C++ headers takes minutes. The build happens at first use, into
``build/torch_kernels/`` beside the package, under a name keyed on a hash of
the sources and flags, so a changed source rebuilds and an unchanged one
loads the existing library. Nothing is built at import: the CPU tests import
every module on machines with no CUDA toolkit.

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
SOURCES = ("map_emit.cu", "bin_packed.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


class EmitParams(ctypes.Structure):
    """Mirror of ``struct EmitParams`` in ``csrc/map_emit.cu``."""

    _fields_ = [
        ("coef", ctypes.c_float * 30),
        ("rot", ctypes.c_float * 9),
        ("cos_v", ctypes.c_float), ("sin_v", ctypes.c_float),
        ("ccx", ctypes.c_float), ("ccy", ctypes.c_float), ("ccz", ctypes.c_float),
        ("mid", ctypes.c_float), ("wscaled", ctypes.c_float), ("half_h", ctypes.c_float),
        ("t_offset", ctypes.c_float), ("t_factor", ctypes.c_float),
        ("transform", ctypes.c_int),
        ("width", ctypes.c_int), ("height", ctypes.c_int),
    ]


_LIB: dict = {}


def _nvcc() -> str:
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
    for name in SOURCES:
        h.update(name.encode() + (CSRC / name).read_bytes())
    return BUILD_DIR / f"libsat_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the same sources exists."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, path)  # atomic: two processes building at once race harmlessly
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    lib = _LIB.get("lib")
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(build()))
    vp = ctypes.c_void_p
    lib.sat_map_emit.argtypes = [vp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 EmitParams, vp, vp, vp]
    lib.sat_map_emit.restype = ctypes.c_int
    lib.sat_bin_packed.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp]
    lib.sat_bin_packed.restype = ctypes.c_int
    _LIB["lib"] = lib
    return lib


def check_tensor(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on a Hopper card."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a (Hopper); "
                           f"{torch.cuda.get_device_name(t.device)} is sm_{cap[0]}{cap[1]}")


def check_launch(err: int, name: str) -> None:
    """Raise if the C entry point reported a CUDA error (cudaGetLastError)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
