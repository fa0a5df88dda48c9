"""PyTorch port, the CUDA source of kernel T runs on the CPU.

``csrc/tonemap.cu`` (the tone map's reduction ``sat_tonemap_stats`` and its
elementwise pass fused with the (transparent, 8-bit) conversion,
``sat_tonemap``) is compiled here with g++ against
``tests/cuda_emulation/cuda_runtime.h`` (a block's CUDA threads as fibers,
``<<<>>>`` rewritten into a loop over blocks, as in
``test_torch_tile_emulation.py``), with ``-ffp-contract=off`` as the card's
build has ``-fmad=false``. It is called through ctypes with the argument
types the card's build binds (``ops.cuda_lib.ARGTYPES``) on numpy planes
made from a seed, and held byte for byte (tolerance 0) against the plain
chain, ``ops.colorize.tonemap`` on the CPU (``colorize_planes`` then
``convert_format_device``), which defines the result; the stats against
``colorize_stats`` (and, for Gas, the log1p of the max that the pass
divides by). The variants that ``tools.tonemap_variants`` times on a card
are built the same way: those said to keep the image are held to the plain
chain too, and the two that drop an operation must change it.

The stub's 3 SMs x 2 resident blocks of 256 threads make the reduction's
grid-stride loop take several turns over a 97x61 canvas, with a ragged last
turn and a ragged last block of the pass. It shows what the source computes,
not how the card schedules it: the card's run is chip_smoke.py (phase 32).

Where trouble is likely, each has a case: NaN palette positions (the stop
index of a NaN has no floor), positions >= 1.0, counts from 2^31 up (the
int32 carrier's negative half), a NaN depth among the valid ones (torch's
max and min propagate it, CUDA's fmaxf/fminf would drop it), the empty
canvas (a NaN brightness factor), the all-sentinel plane, zmax == zmin,
all-negative depths (the fold starts at 0.0), brightness that saturates
both ways, the 3-byte pixel stride of 8-bit RGB, and the 8-bit product past
int32.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from strange_attractor_tpu_torch.config import (BrightnessConstants, Colors, Palette,
                                                RenderKind)
from strange_attractor_tpu_torch.models import presets
from strange_attractor_tpu_torch.render import colorize, colorize_convert_fetch
from strange_attractor_tpu_torch.tools import tonemap_variants as tv
from strange_attractor_tpu_torch.ops import binning as tb, colorize as tc, cuda_lib
from strange_attractor_tpu_torch.runtime import RenderState
from test_torch_tile_emulation import STUB, _as_cxx

GEOMETRY = {"EMU_SMS": 3, "EMU_RESIDENT": 2}
SHAPE = (61, 97)
GUARD = 0xCD
# what the stub lacks of the runtime API the source calls
PRELUDE = """#include <cuda_runtime.h>
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
"""
_PALETTE_64 = np.random.default_rng(64).random((64, 3)).round(6).tolist()
PALETTES = {"default": None, "64-stop": _PALETTE_64}
# (config transparent, output transparent, eight_bit): the CLI's four
# deliveries (the two flags equal), colorize()'s RGBA of an opaque config,
# and a transparent config delivered without alpha
MODES = ((True, True, False), (True, True, True), (False, False, False), (False, False, True),
         (False, True, False), (False, True, True), (True, False, False), (True, False, True))
# (state kind, render kind, data): planes of each storage strategy and the
# special inputs each can hold
GAS_CASES = (("packed", "random"), ("packed", "big-counts"), ("packed", "empty"),
             ("packed", "bright"), ("packed", "dark"), ("exact", "random"),
             ("exact", "big-counts"), ("exact", "special-steps"), ("exact", "empty"),
             ("exact", "bright"), ("exact", "dark"))
DEPTH_CASES = (("packed", "random"), ("packed", "all-sentinel"), ("packed", "flat"),
               ("exact", "random"), ("exact", "nan-z"), ("exact", "flat"),
               ("exact", "all-sentinel"), ("exact", "special-z"), ("depth", "random"),
               ("depth", "all-sentinel"), ("depth", "flat"), ("depth", "zero-flat"),
               ("depth", "nan-z"), ("depth", "all-negative"), ("depth", "special-z"))
# steps a Gas render can meet: NaN (an EXACT plane keeps the stream's NaN
# values), >= 1.0, negative, the edges of the clamp
SPECIAL_STEPS = np.array([np.nan, 1.0, 1.5, np.inf, -np.inf, -0.5, -0.0, 0.0, 0.999999,
                          np.nextafter(np.float32(1.0), np.float32(0.0)), 0.9999995, 1e-30],
                         np.float32)
SPECIAL_Z = np.array([np.inf, -np.inf, -0.0, 0.0, 3.4e38, -3.4e38, 1e-40, -1.0, 5.0],
                     np.float32)


def _build(work, source: str):
    """``source`` (a text of ``csrc/tonemap.cu``) built for the CPU under
    ``work``: its two entry points, bound as the card's build binds them."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the CUDA sources for the CPU")
    (work / "emit_common.cuh").write_text(_as_cxx((cuda_lib.CSRC / "emit_common.cuh")
                                                  .read_text()))
    (work / "tonemap.cu").write_text(PRELUDE + _as_cxx(source))
    lib = work / "libtonemap_emulation.so"
    cmd = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-U_FORTIFY_SOURCE", "-shared", "-fPIC",
           "-w", f"-I{STUB}", *(f"-D{k}={v}" for k, v in GEOMETRY.items()), "-x", "c++",
           str(work / "tonemap.cu"), "-o", str(lib)]
    built = subprocess.run(cmd, capture_output=True, text=True)
    assert built.returncode == 0, built.stderr[-4000:]
    lib = ctypes.CDLL(str(lib))
    for name in ("sat_tonemap_stats", "sat_tonemap"):
        fn = getattr(lib, name)
        fn.argtypes = [*cuda_lib.ARGTYPES[name], ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """Kernel T's entry points, built for the CPU."""
    return _build(tmp_path_factory.mktemp("tonemap_emulation"),
                  (cuda_lib.CSRC / "tonemap.cu").read_text())


def _counts(rng, data: str) -> np.ndarray:
    """Skewed u32 counts with 30% empty pixels; from 2^31 up for
    ``big-counts`` (the maximum 2^32 - 1 among them)."""
    if data == "empty":
        return np.zeros(SHAPE, np.uint32)
    count = (rng.pareto(1.2, SHAPE) * 20).astype(np.uint32)
    if data == "big-counts":
        big = rng.random(SHAPE) < 0.5
        count[big] = rng.integers(1 << 31, 1 << 32, int(big.sum()), dtype=np.uint64)
        count.flat[7] = 0xFFFFFFFF
    count[rng.random(SHAPE) < 0.3] = 0
    return count


def _depths(rng, data: str, valid: np.ndarray) -> np.ndarray:
    """A float32 depth plane with the -1.0 sentinel off ``valid``."""
    z = rng.normal(0, 0.5, SHAPE).astype(np.float32)
    if data == "flat":
        z[:] = 0.25
    elif data == "zero-flat":  # zmax == zmin == 0, both zeros
        z = np.where(rng.random(SHAPE) < 0.5, np.float32(0.0), np.float32(-0.0))
    elif data == "all-negative":  # the fold's 0.0 start is zmax
        z = -np.abs(z) - np.float32(0.5)
    elif data == "special-z":
        z.flat[:3 * len(SPECIAL_Z)] = np.tile(SPECIAL_Z, 3)
    elif data == "nan-z":  # a NaN flood at pixel 0, and one more NaN
        z.flat[0] = np.nan
        z.flat[500] = np.float32(np.nan) * -1
    z = np.where(valid, z, np.float32(-1.0)).astype(np.float32)
    if data == "all-sentinel":
        z[:] = -1.0
    return z


def _state(kind: str, render: str, data: str, seed: int) -> dict:
    """numpy planes of a state of ``kind`` (packed, exact, depth), made from
    ``seed``: uint32 counts and packed words, float32 steps and depths."""
    rng = np.random.default_rng(seed)
    if kind == "depth":
        valid = rng.random(SHAPE) < (1.0 if data == "all-negative" else 0.7)
        return {"zbuf": _depths(rng, data, valid)}
    count = _counts(rng, data if render == "gas" else "random")
    if render == "depth" and data == "all-sentinel":
        count[:] = 0
    valid = count > 0
    zbuf = _depths(rng, data if render == "depth" else "random", valid)
    steps = rng.random(SHAPE).astype(np.float32)
    if data == "special-steps":
        steps.flat[:4 * len(SPECIAL_STEPS)] = np.tile(SPECIAL_STEPS, 4)
    if kind == "exact":
        return {"count": count, "steps": np.where(valid, steps, np.float32(0.0)), "zbuf": zbuf}
    packed = tb.pack_zv(torch.from_numpy(zbuf), torch.from_numpy(steps)).numpy().view(np.uint32)
    return {"count": count, "packed": np.where(valid, packed, 0).astype(np.uint32)}


def _config(render: str, data: str, palette: str, transparent: bool):
    bright = {"bright": (0.6, 2.5), "dark": (-1.5, 1.0)}.get(data)
    colors = Colors(brightness=BrightnessConstants(*bright)) if bright else Colors()
    if PALETTES[palette] is not None:
        colors = Colors(palette=Palette(PALETTES[palette]), brightness=colors.brightness)
    return presets.poisson_saturne(render=RenderKind.GAS if render == "gas" else RenderKind.DEPTH,
                                   transparent=transparent, colors=colors)


def _torch_state(planes: dict) -> RenderState:
    return RenderState(**{k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)
                          for k, v in planes.items()})


def _ptr(a) -> int:
    return 0 if a is None else a.ctypes.data


def _emulated(lib, cfg, planes: dict, transparent: bool, eight_bit: bool):
    """Kernel T on ``planes`` through the emulated entry points: (image,
    stats), the image read from a buffer with guard bytes behind it."""
    depth = cfg.render == RenderKind.DEPTH
    npix = SHAPE[0] * SHAPE[1]
    count, steps, zbuf, packed = (planes.get(k) for k in ("count", "steps", "zbuf", "packed"))
    stats = np.full(2, np.nan, np.float32)
    words = np.zeros(4 + 1, np.uint32)
    words[:] = 0xFFFFFFFF  # scratch: the entry point clears it
    err = lib.sat_tonemap_stats(_ptr(count), _ptr(zbuf), _ptr(packed), npix, int(depth),
                                words.ctypes.data, stats.ctypes.data, None)
    assert err == 0, f"CUDA error {err}"
    assert words[4] == 0xFFFFFFFF, "the reduction wrote past its four words"
    stops = np.ascontiguousarray(cfg.colors.palette.stops.astype(np.float32))
    channels, dtype = (4 if transparent else 3), (np.uint8 if eight_bit else np.uint16)
    nbytes = npix * channels * np.dtype(dtype).itemsize
    buf = np.full(nbytes + 16, GUARD, np.uint8)
    bk = cfg.colors.brightness
    err = lib.sat_tonemap(_ptr(count), _ptr(steps), _ptr(zbuf), _ptr(packed), stats.ctypes.data,
                          stops.ctypes.data, stops.shape[0] - 1, bk.offset, bk.factor, npix,
                          int(depth), int(cfg.transparent), channels, int(eight_bit),
                          buf.ctypes.data, None)
    assert err == 0, f"CUDA error {err}"
    assert (buf[nbytes:] == GUARD).all(), "the pass wrote past the image"
    return buf[:nbytes].view(dtype).reshape(*SHAPE, channels), stats


def _assert_same_image(got: np.ndarray, want: np.ndarray, planes: dict) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape,
                                                                 want.dtype, want.shape)
    bad = np.argwhere(got != want)
    if bad.size:
        px = [tuple(b[:2]) for b in bad[:4]]
        inputs = {k: [v[p] for p in px] for k, v in planes.items()}
        one_step = int((np.abs(got.astype(np.int64) - want) == 1).sum())
        raise AssertionError(f"{len(bad)} channels differ ({one_step} by one step), first at "
                             f"{[tuple(b) for b in bad[:4]]}: kernel "
                             f"{[got[tuple(b)] for b in bad[:4]]}, twin "
                             f"{[want[tuple(b)] for b in bad[:4]]}, inputs {inputs}")


def _assert_same_stats(got: np.ndarray, want: tuple) -> None:
    for g, w in zip(got, (float(w) for w in want)):
        assert (np.isnan(g) and np.isnan(w)) or g == w, (got, want)


def _want_stats(cfg, state: RenderState) -> tuple:
    """The stats the reduction must leave: ``colorize_stats``, and for Gas
    the log1p of the max count as the plain chain divides by it."""
    stats = tc.colorize_stats(cfg, *tc.state_planes(state))
    return stats if cfg.render == RenderKind.DEPTH else (stats[0], tc._log1p_f32(stats[0]))


def _run_case(lib, kind, render, data, palette, mode, seed) -> tuple:
    """Kernel T of ``lib`` and the plain chain on one case's planes:
    (kernel's image, plain chain's, planes); raises unless the stats are
    the plain chain's."""
    cfg_transparent, transparent, eight_bit = mode
    cfg = _config(render, data, palette, cfg_transparent)
    planes = _state(kind, render, data, seed)
    state = _torch_state(planes)
    want = tc.tonemap(cfg, state, transparent=transparent, eight_bit=eight_bit)
    got, stats = _emulated(lib, cfg, planes, transparent, eight_bit)
    _assert_same_stats(stats, _want_stats(cfg, state))
    return got, want.numpy(), planes


@pytest.mark.parametrize("mode", MODES, ids=[f"cfgT{a:d}-T{b:d}-8bit{c:d}" for a, b, c in MODES])
@pytest.mark.parametrize("palette", list(PALETTES))
@pytest.mark.parametrize("case", GAS_CASES, ids=["-".join(c) for c in GAS_CASES])
def test_emulated_gas_tonemap_matches_the_plain_chain(emulated, case, palette, mode):
    kind, data = case
    _assert_same_image(*_run_case(emulated, kind, "gas", data, palette, mode,
                                  100 + GAS_CASES.index(case)))


@pytest.mark.parametrize("mode", MODES, ids=[f"cfgT{a:d}-T{b:d}-8bit{c:d}" for a, b, c in MODES])
@pytest.mark.parametrize("case", DEPTH_CASES, ids=["-".join(c) for c in DEPTH_CASES])
def test_emulated_depth_tonemap_matches_the_plain_chain(emulated, case, mode):
    kind, data = case
    _assert_same_image(*_run_case(emulated, kind, "depth", data, "default", mode,
                                  200 + DEPTH_CASES.index(case)))


def test_special_cases_reach_what_they_name():
    """The planted planes hold what their names promise: counts past 2^31
    through the int32 carrier, NaN and >= 1.0 positions, a NaN depth among
    the valid ones, an all-negative valid plane, an empty canvas."""
    big = _state("packed", "gas", "big-counts", 1)["count"]
    assert big.max() == 0xFFFFFFFF and (big.view(np.int32) < 0).mean() > 0.2
    steps = _state("exact", "gas", "special-steps", 1)["steps"]
    assert np.isnan(steps).any() and (steps >= 1.0).any() and (steps < 0).any()
    z = _state("depth", "depth", "nan-z", 1)["zbuf"]
    assert np.isnan(z.flat[0]) and (z == -1.0).any()
    z = _state("depth", "depth", "all-negative", 1)["zbuf"]
    assert (z < 0).all() and not (z == -1.0).any()
    assert not _state("packed", "gas", "empty", 1)["count"].any()
    stats = tc.colorize_stats(_config("depth", "nan-z", "default", False), None, None,
                              torch.from_numpy(_state("exact", "depth", "nan-z", 3)["zbuf"]))
    assert all(bool(torch.isnan(s)) for s in stats)


def _launches() -> tuple:
    return tc.tonemap.launches, tc._tonemap_stats.launches


def test_the_wrapper_runs_the_plain_chain_on_the_cpu_without_launching():
    """On CPU planes ``tonemap`` is the plain chain, writes ``out`` when
    given one, and counts no launch; ``colorize`` is its u16 RGBA."""
    cfg = _config("gas", "random", "default", True)
    state = _torch_state(_state("packed", "gas", "random", 5))
    before = _launches()
    want = tc.convert_format_device(tc.colorize_planes(cfg, *tc.state_planes(state)), False, True)
    out = torch.empty((*SHAPE, 3), dtype=torch.uint8)
    got = tc.tonemap(cfg, state, transparent=False, eight_bit=True, out=out)
    assert got is out and torch.equal(out, want)
    assert torch.equal(colorize(cfg, state), tc.colorize_planes(cfg, *tc.state_planes(state)))
    assert _launches() == before
    with pytest.raises(ValueError, match="out must be"):
        tc.tonemap(cfg, state, out=torch.empty((*SHAPE, 3), dtype=torch.uint16))


def _meta_state(render: str) -> RenderState:
    if render == "depth":
        return RenderState(zbuf=torch.empty(SHAPE, dtype=torch.float32, device="meta"))
    return RenderState(count=torch.empty(SHAPE, dtype=torch.int32, device="meta"),
                       packed=torch.empty(SHAPE, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("failure", ["not-on-a-card", "no-build", "launch-error"])
@pytest.mark.parametrize("render", ["gas", "depth"])
@pytest.mark.parametrize("entry", ["tonemap", "colorize", "colorize_convert_fetch"])
def test_the_wrapper_raises_instead_of_falling_back(monkeypatch, entry, render, failure):
    """Planes that are not on the CPU take the kernel's path, and a request
    the kernel cannot take raises there: planes that are no CUDA tensors
    (meta tensors stand in for a card here), a library that does not
    build, a launch that reports a CUDA error. The plain chain never
    runs, and no launch is counted."""
    def fell_back(*args, **kwargs):
        raise AssertionError("the wrapper fell back to the plain chain")

    for name in ("colorize_planes", "colorize_stats", "state_planes"):
        monkeypatch.setattr(tc, name, fell_back)
    if failure != "not-on-a-card":
        monkeypatch.setattr(cuda_lib, "check_tensor", lambda *args: None)
    if failure == "no-build":
        def no_build():
            raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")
        monkeypatch.setattr(cuda_lib, "library", no_build)
    elif failure == "launch-error":
        monkeypatch.setattr(cuda_lib, "launch",
                            lambda name, device, *args: cuda_lib.check_launch(700, name))
    cfg = _config(render, "random", "default", False)
    state = _meta_state(render)
    call = {"tonemap": lambda: tc.tonemap(cfg, state, transparent=False, eight_bit=True),
            "colorize": lambda: colorize(cfg, state),
            "colorize_convert_fetch": lambda: colorize_convert_fetch(
                cfg, state, transparent=False, eight_bit=True)}[entry]
    before = _launches()
    error, match = {"not-on-a-card": (ValueError, "must be a CUDA tensor"),
                    "no-build": (RuntimeError, "nvcc not found"),
                    "launch-error": (RuntimeError, "launch failed: CUDA error 700")}[failure]
    with pytest.raises(error, match=match):
        call()
    assert _launches() == before


def test_a_depth_only_state_is_refused_for_a_gas_render():
    state = _torch_state(_state("depth", "depth", "random", 9))
    cfg = _config("gas", "random", "default", False)
    for call in (lambda: tc.tonemap(cfg, state), lambda: colorize(cfg, state)):
        with pytest.raises(ValueError, match="BinStrategy.DEPTH"):
            call()


@pytest.mark.parametrize("name", list(tv.VARIANTS))
def test_each_variant_edit_applies_once(name):
    """Every edit of ``tools.tonemap_variants`` finds its text exactly once
    in the source, and a source without that text is refused."""
    source = (cuda_lib.CSRC / "tonemap.cu").read_text()
    edited = tv.variant_source(name, source)
    assert (edited == source) == (not tv.VARIANTS[name][0])
    for old, new in tv.VARIANTS[name][0]:
        assert old not in edited and new in edited
    if tv.VARIANTS[name][0]:
        with pytest.raises(ValueError, match="occurs 0 times"):
            tv.variant_source(name, "")


@pytest.fixture(scope="module", params=list(tv.VARIANTS))
def variant(request, tmp_path_factory):
    """(name, its entry points built for the CPU)."""
    source = tv.variant_source(request.param, (cuda_lib.CSRC / "tonemap.cu").read_text())
    return request.param, _build(tmp_path_factory.mktemp("tonemap_variant"), source)


VARIANT_CASES = (("packed", "random"), ("packed", "big-counts"), ("exact", "special-steps"),
                 ("packed", "empty"))


@pytest.mark.parametrize("mode", MODES[:2], ids=[f"cfgT{a:d}-T{b:d}-8bit{c:d}"
                                                 for a, b, c in MODES[:2]])
@pytest.mark.parametrize("case", VARIANT_CASES, ids=["-".join(c) for c in VARIANT_CASES])
def test_emulated_variant_keeps_or_changes_the_image_as_it_says(variant, case, mode):
    """A variant said to keep the image gives the plain chain's byte for
    byte; one that drops an operation gives another image (the empty
    canvas is black with and without it, so that case is held to the
    plain chain for every variant)."""
    name, lib = variant
    got, want, planes = _run_case(lib, *case[:1], "gas", case[1], "default", mode,
                                  300 + VARIANT_CASES.index(case))
    if tv.VARIANTS[name][1] or case[1] == "empty":
        _assert_same_image(got, want, planes)
    else:
        assert not np.array_equal(got, want)
