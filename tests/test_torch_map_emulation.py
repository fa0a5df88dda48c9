"""PyTorch port, the CUDA sources of kernel A and kernel P run on the CPU.

Kernel A's five sources (``csrc/map_emit.cuh``'s kernels for the Sprott map
and the four RK4 maps, in float and double, gated and not) and
``csrc/project_emit.cu`` are compiled here with g++ (one process a source,
side by side) and ``-ffp-contract=off`` against
``tests/cuda_emulation/cuda_runtime.h``
(a block's CUDA threads as fibers, ``<<<>>>`` rewritten into a loop over
blocks, as in ``test_torch_tile_emulation.py``; the producer/emitter ring's
named barriers, ``barrier.sync`` and ``barrier.arrive``, rewritten into the
stub's). The C entry point is called through ctypes on numpy arrays and held
bit for bit (tolerance 0; a NaN's payload bits are free) against the plain
twins of ``ops/emit.py``, which define the result, in every mode: the
warm-up, PACKED, DEPTH, EXACT, SHARED and SHARED_DEPTH; in float32 and in
the float64 compute path; without and with lane reseeding (dead lanes of
every kind -- NaN, +-inf, |x| just above 1e3 -- reseeded in the first chunk
and in a later one, lane ages from -warmup to 1, the ages held after each
chunk). Kernel P is held to ``project_emit_plain`` on shared streams with
gated (fj = +inf) and NaN points, in both dtypes. The ctypes mirrors of the
launch constants are pinned to the header's layout (sizes and offsets).

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
from concurrent.futures import ThreadPoolExecutor

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


KERNEL_A = ("map_emit.cu", "map_emit_rk4.cu", "map_emit_rk4_cyclic.cu", "map_emit_f64.cu",
            "map_emit_f64_cyclic.cu")
KEY = 0x0123456789ABCDEF


def _gxx_build(gxx: str, work, sources, lib, extra=()) -> None:
    """Compile ``sources`` in ``work`` with g++, one process a source,
    side by side, and link them into ``lib``."""
    base = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-U_FORTIFY_SOURCE", "-fPIC", "-w",
            f"-I{STUB}", *(f"-D{k}={v}" for k, v in GEOMETRY.items()), *extra]

    def compile_one(name):
        return subprocess.run([*base, "-c", "-x", "c++", str(work / name), "-o",
                               str(work / f"{name}.o")], capture_output=True, text=True)

    with ThreadPoolExecutor(len(sources)) as pool:
        for name, done in zip(sources, pool.map(compile_one, sources)):
            assert done.returncode == 0, (name, done.stderr[-4000:])
    linked = subprocess.run([gxx, "-shared", "-o", str(lib),
                             *(str(work / f"{n}.o") for n in sources)],
                            capture_output=True, text=True)
    assert linked.returncode == 0, linked.stderr[-4000:]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Kernel A's and kernel P's entry points, built for the CPU."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CUDA sources for the CPU")
    work = tmp_path_factory.mktemp("map_emulation")
    sources = KERNEL_A + ("project_emit.cu",)
    for name in ("emit_common.cuh", "map_emit.cuh") + sources:
        text = _barriers(_as_cxx((cuda_lib.CSRC / name).read_text()))
        assert "asm" not in text, name
        (work / name).write_text(text)
    lib = work / "libmap_emulation.so"
    _gxx_build(gxx, work, sources, lib)
    lib = ctypes.CDLL(str(lib))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, params in (("sat_map_emit", cuda_lib.EmitParams),
                         ("sat_map_emit_f64", cuda_lib.EmitParams64)):
        fn = getattr(lib, name)
        fn.argtypes = [vp, i32, i32, i32, params, cuda_lib.ReseedArgs, vp, vp, vp, vp, vp]
        fn.restype = i32
    lib.sat_project_emit.argtypes = [i64, i32, cuda_lib.EmitParams, *[vp] * 7]
    lib.sat_project_emit_f64.argtypes = [i64, i32, cuda_lib.EmitParams64, *[vp] * 8]
    lib.sat_project_emit.restype = lib.sat_project_emit_f64.restype = i32
    return lib


def _run(lib, spec, pts: np.ndarray, steps: int, mode: int, dtypes, age=None,
         chunk: int = 0) -> list:
    """One emulated launch on ``pts`` (3, lanes) float32 or float64, in
    place; with ``age`` (int32, in place) reseeding and gated."""
    lanes = pts.shape[1]
    outs = [np.full(steps * lanes, -7, dt) for dt in dtypes]
    ptrs = [o.ctypes.data for o in outs] + [None] * (4 - len(outs))
    args = cuda_lib.ReseedArgs()
    if age is not None:
        args.age, args.key, args.chunk, args.warmup = age.ctypes.data, KEY, chunk, RESEED_WARMUP
    wide = pts.dtype == np.float64
    fn = lib.sat_map_emit_f64 if wide else lib.sat_map_emit
    params = spec.params64 if wide else spec.params
    assert fn(pts.ctypes.data, lanes, steps, mode, params, args, *ptrs, None) == 0
    return outs


def _same(tag: str, got: np.ndarray, want: torch.Tensor) -> None:
    want = want.numpy()
    assert got.dtype == want.dtype, tag
    unsigned = np.uint64 if want.dtype.itemsize == 8 else np.uint32
    g, w = got.view(unsigned), want.view(unsigned)
    if want.dtype.kind == "f":  # NaN payloads are free
        nan = np.isnan(want)
        np.testing.assert_array_equal(np.isnan(got), nan, err_msg=tag)
        g, w = g[~nan], w[~nan]
    np.testing.assert_array_equal(g, w, err_msg=tag)


def _np_dtype(dt: torch.dtype):
    return {torch.int32: np.int32, torch.float32: np.float32, torch.float64: np.float64}[dt]


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


# a reseeded lane re-warms this many steps: with chunks of STEPS, one
# reseeded in chunk 0 emits again from its 31st step
RESEED_WARMUP = 30


def _dead_lanes(pts: np.ndarray, rng) -> np.ndarray:
    """Plant dead lanes of every kind in ``pts`` (3, lanes) and return
    ages from -RESEED_WARMUP - 10 to 1, as a render's lanes may hold."""
    lanes = pts.shape[1]
    big = np.nextafter(pts.dtype.type(1e3), pts.dtype.type(np.inf))
    for lane, comp, v in ((1, 0, np.nan), (5, 1, np.inf), (9, 2, -np.inf), (13, 0, big),
                          (17, 1, -big), (21, 2, 1e3), (25, 0, -1e3), (29, 1, np.nan)):
        pts[comp, lane % lanes] = v
    return rng.integers(-RESEED_WARMUP - 10, 2, lanes).astype(np.int32)


@pytest.mark.parametrize("dtype", ("float32", "float64"))
@pytest.mark.parametrize("lanes", sorted(LANES))
@pytest.mark.parametrize("preset", ("solar-sail", "lorenz"))
def test_kernel_a_gated_source_matches_twin(emulated, preset, lanes, dtype):
    """Lane reseeding: after a short warm-up, dead lanes planted, then
    CHUNKS chunks in every emission mode, the chunk index in the reseed; the
    streams (gated points at npix, or fj = +inf in the shared modes), the
    lane state and the ages bit-identical to the plain twin's."""
    cfg = sat.presets.by_name(preset, width=96, height=54, dtype=dtype)
    spec = emit.emit_spec(cfg, math.radians(23.0))
    rng = np.random.default_rng(lanes)
    seeds = (rng.random((3, lanes)) * 0.1).astype(dtype)
    emit.map_emit_plain(spec, torch.from_numpy(seeds), 60, emit=False)  # in place
    ages = _dead_lanes(seeds, rng)
    gated = reseeded = 0
    for mode, kind, shared in MODES:
        g, w = seeds.copy(), torch.from_numpy(seeds.copy())
        ga, wa = ages.copy(), torch.from_numpy(ages.copy())
        for c in range(CHUNKS):
            tag = f"{preset} {dtype} {LANES[lanes]} gated mode {mode} chunk {c}"
            if c == 1:  # a lane dies in a later chunk
                g[0, 3], w[0, 3] = np.nan, math.nan
            reseeded += int((~(w.abs() <= 1e3).all(dim=0)).sum())
            reseed = emit.Reseed(wa, KEY, c, RESEED_WARMUP)
            fn = emit.map_emit_shared_plain if shared else emit.map_emit_plain
            ref = fn(spec, w, STEPS, kind=kind, reseed=reseed)
            outs = _run(emulated, spec, g, STEPS, mode, [_np_dtype(r.dtype) for r in ref],
                        age=ga, chunk=c)
            for i, (o, r) in enumerate(zip(outs, ref)):
                _same(f"{tag} stream {i}", o, r)
            _same(f"{tag} state", g, w)
            _same(f"{tag} age", ga, wa)
            gated += int(torch.isinf(ref[2]).sum()) if shared else 0
    assert gated > 0 and reseeded >= len(MODES) * CHUNKS


@pytest.mark.parametrize("lanes", sorted(LANES))
@pytest.mark.parametrize("preset", ("poisson-saturne", "lorenz", "thomas"))
def test_kernel_a_f64_source_matches_twin(emulated, preset, lanes):
    """The float64 compute path: warm-up, then CHUNKS chunks in every
    emission mode, float64 lane state and shared streams, float32 z and
    val, bit-identical to the twin's (Thomas through sin_f64)."""
    cfg = sat.presets.by_name(preset, width=96, height=54, dtype="float64")
    spec = emit.emit_spec(cfg, math.radians(23.0))
    seeds = np.random.default_rng(lanes).random((3, lanes)) * 0.1
    got, want = seeds.copy(), torch.from_numpy(seeds.copy())
    assert _run(emulated, spec, got, WARMUP, 0, ()) == []
    emit.map_emit_plain(spec, want, WARMUP, emit=False)
    _same(f"{preset} f64 warm-up state", got, want)
    lit = 0
    for mode, kind, shared in MODES:
        g, w = got.copy(), want.clone()
        for c in range(CHUNKS):
            tag = f"{preset} f64 {LANES[lanes]} mode {mode} chunk {c}"
            fn = emit.map_emit_shared_plain if shared else emit.map_emit_plain
            ref = fn(spec, w, STEPS, kind=kind)
            outs = _run(emulated, spec, g, STEPS, mode, [_np_dtype(r.dtype) for r in ref])
            for i, (o, r) in enumerate(zip(outs, ref)):
                _same(f"{tag} stream {i}", o, r)
            _same(f"{tag} state", g, w)
            if not shared:
                lit += int((ref[0] < cfg.width * cfg.height).sum())
    assert lit > 0, "no point landed on the canvas"


@pytest.mark.parametrize("kind", (B.PACKED, B.DEPTH, B.EXACT))
@pytest.mark.parametrize("dtype", ("float32", "float64"))
def test_kernel_p_source_matches_twin(emulated, dtype, kind):
    """Kernel P on a shared stream of solar-sail's orbit (escaped NaN
    points) with reseeding's gated points (fj = +inf) among them, at two
    angles: flat, z (and the float32 val of a float64 EXACT frame) equal to
    project_emit_plain's."""
    cfg = sat.presets.by_name("solar-sail", width=96, height=54, dtype=dtype)
    lanes = 70
    rng = np.random.default_rng(7)
    pts = torch.from_numpy((rng.random((3, lanes)) * 0.1).astype(dtype))
    spec0 = emit.emit_spec(cfg, 0.0)
    emit.map_emit_plain(spec0, pts, 60, emit=False)
    age = torch.from_numpy(_dead_lanes(pts.numpy(), rng))
    stream = emit.map_emit_shared_plain(spec0, pts, STEPS, kind=kind,
                                        reseed=emit.Reseed(age, KEY, 0, RESEED_WARMUP))
    assert bool(torch.isinf(stream[2]).any()) and bool(torch.isnan(stream[0]).any())
    n = stream[0].numel()
    mode = {B.PACKED: 1, B.DEPTH: 2, B.EXACT: 3}[kind]
    for angle in (0.0, 141.0):
        spec = emit.emit_spec(cfg, math.radians(angle))
        want = emit.project_emit_plain(spec, stream, kind=kind)
        outs = [np.full(n, -7, np.int32), np.full(n, -7, np.float32 if kind != B.PACKED
                                                  else np.int32)]
        if dtype == "float64" and kind == B.EXACT:
            outs.append(np.full(n, -7, np.float32))
        ins = [t.numpy() for t in stream] + [None] * (4 - len(stream))
        ptrs = [a.ctypes.data if a is not None else None for a in ins]
        ptrs += [o.ctypes.data for o in outs[:2]]
        if dtype == "float64":
            out2 = outs[2].ctypes.data if len(outs) == 3 else None
            err = emulated.sat_project_emit_f64(n, mode, spec.params64, *ptrs, out2, None)
        else:
            err = emulated.sat_project_emit(n, mode, spec.params, *ptrs, None)
        assert err == 0
        for i, o in enumerate(outs):
            _same(f"{dtype} {kind.value} {angle} stream {i}", o, want[i])
        if len(want) == 3 and len(outs) == 2:  # a float32 EXACT frame hands val on
            assert want[2] is stream[3] or torch.equal(want[2], stream[3])


_LAYOUT = """
#include <cstddef>
#include <cstdio>
#include "emit_common.cuh"
#define F(S, f) std::printf("%s %s %zu\\n", #S, #f, offsetof(S, f));
int main() {
  std::printf("EmitParams size %zu\\n", sizeof(EmitParams));
  std::printf("EmitParams64 size %zu\\n", sizeof(EmitParams64));
  std::printf("Reseed size %zu\\n", sizeof(Reseed));
  FIELDS
}
"""


def test_launch_constants_mirror_the_header(tmp_path):
    """ctypes' EmitParams, EmitParams64 and ReseedArgs have the sizes and
    field offsets of the header's EmitParamsT<float>, EmitParamsT<double>
    and Reseed (the struct is passed by value to every launch)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to read the header's layout")
    mirrors = {"EmitParams": cuda_lib.EmitParams, "EmitParams64": cuda_lib.EmitParams64,
               "Reseed": cuda_lib.ReseedArgs}
    fields = "".join(f"F({s}, {f[0]})" for s, m in mirrors.items() for f in m._fields_)
    (tmp_path / "emit_common.cuh").write_text((cuda_lib.CSRC / "emit_common.cuh").read_text())
    (tmp_path / "layout.cpp").write_text(_LAYOUT.replace("FIELDS", fields))
    exe = tmp_path / "layout"
    built = subprocess.run([gxx, "-std=c++20", "-w", f"-I{STUB}", "-o", str(exe),
                            str(tmp_path / "layout.cpp")], capture_output=True, text=True)
    assert built.returncode == 0, built.stderr[-4000:]
    got = {tuple(line.split()[:2]): int(line.split()[2])
           for line in subprocess.run([str(exe)], capture_output=True, text=True,
                                      check=True).stdout.splitlines()}
    for s, m in mirrors.items():
        assert got[(s, "size")] == ctypes.sizeof(m), s
        for name, _ in m._fields_:
            assert got[(s, name)] == getattr(m, name).offset, (s, name)
    assert ctypes.sizeof(cuda_lib.EmitParams64) == 456 and ctypes.sizeof(cuda_lib.ReseedArgs) == 24
