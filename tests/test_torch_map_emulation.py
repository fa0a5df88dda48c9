"""PyTorch port, the CUDA sources of kernel A run on the CPU.

``csrc/map_emit.cu`` and ``csrc/map_emit_rk4.cu`` (``csrc/map_emit.cuh``'s
kernels for the Sprott map and the four RK4 maps) are compiled here with g++
and ``-ffp-contract=off`` against ``tests/cuda_emulation/cuda_runtime.h``
(a block's CUDA threads as fibers, ``<<<>>>`` rewritten into a loop over
blocks, as in ``test_torch_tile_emulation.py``; the producer/emitter ring's
named barriers, ``barrier.sync`` and ``barrier.arrive``, rewritten into the
stub's). The C entry point is called through ctypes on numpy arrays and held
bit for bit (tolerance 0; a NaN's payload bits are free) against the plain
twins of ``ops/emit.py``, which define the result, in every mode: the
warm-up, PACKED, DEPTH, EXACT, SHARED and SHARED_DEPTH.

The stub's one SM makes the launcher pick each of its three kernels at
CPU-sized lane counts: one thread per lane from 128 lanes (130: a ragged
last block), the 32-lane ring from 64 (70: a ragged last block), the
16-lane ring below (37). Chunks of 77 steps leave a ragged tail of the ILP
kernel's 8-step batches and of the ring's 24-step tiles. Thomas' sine is the
port's own ``sin_f32``, so it is held bit for bit too. This shows what the
sources compute under IEEE float32 without contraction, not how the card
schedules them: the card's run is chip_smoke.py.
"""

import ctypes
import math
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import strange_attractor_tpu_torch as sat
from strange_attractor_tpu_torch.ops import cuda_lib, emit
from test_torch_tile_emulation import STUB, _as_cxx

B = sat.BinStrategy
GEOMETRY = {"EMU_SMS": 1}
PRESETS = ("poisson-saturne", "lorenz", "rossler", "halvorsen", "thomas")
# lanes -> the kernel the launcher picks on one SM
LANES = {130: "ilp", 70: "ring32", 37: "ring16"}
WARMUP, STEPS, CHUNKS = 200, 77, 2
# (mode, planes kind, shared)
MODES = ((1, B.PACKED, False), (2, B.DEPTH, False), (3, B.EXACT, False),
         (4, B.PACKED, True), (5, B.DEPTH, True))


def _barriers(text: str) -> str:
    return re.sub(r'asm volatile\("barrier\.(sync|arrive) %0, %1;" ::"r"\((\w+)\), '
                  r'"r"\((\w+)\) : "memory"\);',
                  lambda mo: f"emu::named_{mo.group(1)}({mo.group(2)}, {mo.group(3)});", text)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Kernel A's entry point, built for the CPU."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CUDA sources for the CPU")
    work = tmp_path_factory.mktemp("map_emulation")
    sources = ("map_emit.cu", "map_emit_rk4.cu")
    for name in ("emit_common.cuh", "map_emit.cuh") + sources:
        text = _barriers(_as_cxx((cuda_lib.CSRC / name).read_text()))
        assert "asm" not in text, name
        (work / name).write_text(text)
    lib = work / "libmap_emulation.so"
    cmd = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-U_FORTIFY_SOURCE", "-shared",
           "-fPIC", "-w", f"-I{STUB}", *(f"-D{k}={v}" for k, v in GEOMETRY.items()),
           "-x", "c++", *(str(work / s) for s in sources), "-o", str(lib)]
    built = subprocess.run(cmd, capture_output=True, text=True)
    assert built.returncode == 0, built.stderr[-4000:]
    lib = ctypes.CDLL(str(lib))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.sat_map_emit.argtypes = [vp, i32, i32, i32, cuda_lib.EmitParams, vp, vp, vp, vp, vp]
    lib.sat_map_emit.restype = i32
    return lib


def _run(lib, spec, pts: np.ndarray, steps: int, mode: int, dtypes) -> list:
    """One emulated launch on ``pts`` (3, lanes) float32, in place."""
    lanes = pts.shape[1]
    outs = [np.full(steps * lanes, -7, dt) for dt in dtypes]
    ptrs = [o.ctypes.data for o in outs] + [None] * (4 - len(outs))
    assert lib.sat_map_emit(pts.ctypes.data, lanes, steps, mode, spec.params, *ptrs, None) == 0
    return outs


def _same(tag: str, got: np.ndarray, want: torch.Tensor) -> None:
    want = want.numpy()
    assert got.dtype.itemsize == want.dtype.itemsize == 4, tag
    g, w = got.view(np.uint32), want.view(np.uint32)
    if want.dtype == np.float32:  # NaN payloads are free
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got.view(np.float32)), nan, err_msg=tag)
        g, w = g[~nan], w[~nan]
    np.testing.assert_array_equal(g, w, err_msg=tag)


def _np_dtype(dt: torch.dtype):
    return np.int32 if dt == torch.int32 else np.float32


@pytest.mark.parametrize("lanes", sorted(LANES))
@pytest.mark.parametrize("preset", PRESETS)
def test_kernel_a_source_matches_twin(emulated, preset, lanes):
    """Warm-up, then CHUNKS chunks of STEPS steps in every emission mode:
    streams and lane state bit-identical to the plain twin's."""
    cfg = sat.presets.by_name(preset, width=96, height=54)
    spec = emit.emit_spec(cfg, math.radians(23.0))
    seeds = (np.random.default_rng(lanes).random((3, lanes)) * 0.1).astype(np.float32)
    got, want = seeds.copy(), torch.from_numpy(seeds.copy())
    assert _run(emulated, spec, got, WARMUP, 0, ()) == []
    emit.map_emit_plain(spec, want, WARMUP, emit=False)
    _same(f"{preset} warm-up state", got, want)
    lit = 0
    for mode, kind, shared in MODES:
        g, w = got.copy(), want.clone()
        for c in range(CHUNKS):
            tag = f"{preset} {LANES[lanes]} mode {mode} chunk {c}"
            if shared:
                ref = emit.map_emit_shared_plain(spec, w, STEPS, kind=kind)
            else:
                ref = emit.map_emit_plain(spec, w, STEPS, kind=kind)
            outs = _run(emulated, spec, g, STEPS, mode, [_np_dtype(r.dtype) for r in ref])
            for i, (o, r) in enumerate(zip(outs, ref)):
                _same(f"{tag} stream {i}", o, r)
            _same(f"{tag} state", g, w)
            if not shared:
                lit += int((ref[0] < cfg.width * cfg.height).sum())
    assert lit > 0, "no point landed on the canvas"
