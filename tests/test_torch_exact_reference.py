"""The port's reference-faithful EXACT accumulation against the benchmark's
plain EXACT reference (``bench_torch/reference_exact.py``), on the CPU at a
small size: the CLI's single-frame chain of the
``poisson-saturne-exact-1080p`` configuration's flags
(``cli.config_from_args``, ``render.render`` with ``--bin-strategy
exact-kernel``, ``render.colorize_convert_fetch``, ``write_image`` as PAM,
the file read back by ``bench_torch/images.py``) equals the reference bit
for bit in ``count``, ``steps``, ``zbuf``, the 8-bit image and the file,
over both presets and seeded random Sprott maps, one of which escapes; the
reference's own edges (a planted equal-depth tie, the two zeros, a NaN
depth); and the EXACT still driver's check, run in-process, reads
``correct`` false under each fault of the path."""

from __future__ import annotations

import json
import math
import time

import numpy as np
import pytest
import torch

from bench_torch import harness, images, reference, reference_exact
from strange_attractor_tpu_torch import cli
from strange_attractor_tpu_torch.config import BinStrategy, RenderKind
from strange_attractor_tpu_torch.ops import binning
from strange_attractor_tpu_torch.utils import export

rmod = harness.program("render")
CONFIG = json.loads((harness.HERE / "configs" / "poisson-saturne-exact-1080p.json").read_text())
SOLAR = json.loads((harness.HERE / "configs" / "solar-sail-1800x2000.json").read_text())
TRAFFIC = json.loads((harness.HERE / "traffic" / "still-1e9-pam-exact.json").read_text())
W, H, LANES, STEPS, CHUNKS = 96, 54, 512, 16, 3
SEEDS = (7, 2**31 + 11, 5_000_000_029)
CHECK_SEED = 2**31 + 977
# seeded random Sprott maps: the hero still's coefficients with N(0, 0.03)
# noise from numpy's generator of this seed. 0 and 4 draw attractors (4
# loses some lanes to infinity), 1 a few cycles with equal-depth ties, 6
# escapes on every lane (the NaN flood onto pixel (0, 0))
RANDOM_MAPS = {0: "attractor", 1: "cycles", 4: "part escapes", 6: "escapes"}


def _swap(args: list, flag: str, value: str) -> list:
    args = list(args)
    args[args.index(flag) + 1] = value
    return args


def random_rows(seed: int) -> list:
    base = np.array([CONFIG["reference"]["coefficients"][k] for k in "xyz"])
    noise = np.random.default_rng(seed).normal(0.0, 0.03, base.shape)
    return np.round(base + noise, 6).tolist()


def small_config(base: dict = CONFIG, rows=None) -> dict:
    """A configuration file at the test's canvas and schedule, EXACT_KERNEL
    on, with ``rows`` (x, y, z) as its map's coefficients if given."""
    c = json.loads(json.dumps(base))
    c["cli"] = _swap(_swap(c["cli"], "-w", str(W)), "-h", str(H)) + [
        "--lanes", str(LANES), "--chunk-steps", str(STEPS)]
    if "--bin-strategy" not in c["cli"]:
        c["cli"] += ["--bin-strategy", "exact-kernel"]
    c["reference"]["width"], c["reference"]["height"] = W, H
    if rows is not None:
        for axis, row in zip("xyz", rows):
            c["cli"] += [f"--coeffs-{axis}", *map(repr, row)]
            c["reference"]["coefficients"][axis] = list(row)
    return c


def small_traffic() -> dict:
    t = json.loads(json.dumps(TRAFFIC))
    t["cli_options"] = _swap(t["cli_options"], "-i", str(LANES * STEPS * CHUNKS))
    t["checked_items"] = 1
    return t


def _program_config(config_file: dict):
    parser = cli.build_parser()
    args = parser.parse_args([*config_file["cli"], *small_traffic()["cli_options"],
                              "--device", "cpu"])
    cli._validate(args, parser)
    return args, cli.config_from_args(args)


def test_the_configuration_is_an_exact_pam_still():
    args, config = _program_config(small_config())
    assert config.render == RenderKind.GAS and args.pam and args.eight_bit
    assert not args.transparent
    assert config.resolved_bin_strategy() == BinStrategy.EXACT_KERNEL
    assert rmod.plan_schedule(config) == (LANES, STEPS, CHUNKS)
    assert CONFIG["reduced"] == []
    assert CONFIG["reference"]["render"] == "exact"
    # the hero still's own constants and flags, and the strategy on top
    hero = json.loads((harness.HERE / "configs" / "poisson-saturne-1080p.json").read_text())
    assert {k: v for k, v in CONFIG["reference"].items() if k != "render"} == hero["reference"]
    assert [a for a in CONFIG["cli"] if a not in ("--bin-strategy", "exact-kernel")] \
        == hero["cli"]


CASES = [("poisson-saturne", seed, None) for seed in SEEDS] + [("solar-sail", 13, None)] + [
    (f"random map {k} ({what})", 100 + k, k) for k, what in RANDOM_MAPS.items()]


@pytest.mark.parametrize("name,seed,rows", CASES, ids=[c[0] for c in CASES])
def test_the_exact_chain_equals_the_reference(name, seed, rows, tmp_path):
    base = SOLAR if name == "solar-sail" else CONFIG
    file = small_config(base, None if rows is None else random_rows(rows))
    args, config = _program_config(file)
    lanes, chunk_steps, nchunks = rmod.plan_schedule(config)
    state = rmod.render(config, None, torch.Generator().manual_seed(seed), device="cpu")
    assert state.strategy == BinStrategy.EXACT
    image = rmod.colorize_convert_fetch(config, state, transparent=args.transparent,
                                        eight_bit=args.eight_bit)
    path = export.write_image(tmp_path / "frame", image, fmt="pam",
                              transparent=args.transparent, eight_bit=args.eight_bit,
                              silent=True)
    dep = reference.Deployment.from_config(file)
    schedule = {"lanes": lanes, "chunk_steps": chunk_steps, "nchunks": nchunks}
    planes = reference_exact.render(dep, torch.Generator().manual_seed(seed), schedule)
    want = reference_exact.tonemap8(dep, planes)
    assert torch.equal(state.count.reshape(-1).to(torch.int64) & 0xFFFFFFFF, planes.count)
    assert torch.equal(state.steps.reshape(-1).view(torch.int32),
                       planes.steps.view(torch.int32))
    assert torch.equal(state.zbuf.reshape(-1).view(torch.int32), planes.zbuf.view(torch.int32))
    assert torch.equal(torch.from_numpy(image), want)
    assert torch.equal(images.read_images([path], "pam")[0], want)
    points = lanes * chunk_steps * nchunks
    lit = int((planes.zbuf != -1.0).sum())
    assert len(planes.distinct) == nchunks
    if rows == 6:
        # every orbit escapes: each point counts on pixel (0, 0), none wins,
        # and that pixel alone is lit, in the palette's first colour
        assert int(planes.count[0]) == points and lit == 0
        assert int(want.reshape(-1, 3)[1:].sum()) == 0 and int(want[0, 0].sum()) > 0
    elif name in ("poisson-saturne", "solar-sail") or rows in (0, 4):
        assert 0.01 * W * H < lit < W * H
        assert len(torch.unique(want.reshape(-1, 3), dim=0)) > 20
    if name == "solar-sail" or rows == 4:
        assert 0 < int(planes.count[0]) < points  # escaped lanes on pixel (0, 0)


def _plant(npix: int = 4) -> reference_exact.ExactPlanes:
    return reference_exact.ExactPlanes(npix, "cpu")


def test_the_reference_keeps_the_earliest_of_equal_depths():
    planes = _plant()
    # pixel 1: three points, the two nearest tied at 0.5, the earliest wins;
    # pixel 2: a nearer point after a farther one replaces it
    planes.bin(torch.tensor([1, 1, 1, 2, 2]), torch.tensor([0.5, 0.25, 0.5, 0.125, 0.25]),
               torch.tensor([0.11, 0.22, 0.33, 0.44, 0.55]))
    assert planes.count.tolist() == [0, 3, 2, 0]
    assert planes.zbuf.tolist() == [-1.0, 0.5, 0.25, -1.0]
    assert planes.steps.tolist() == pytest.approx([0.0, 0.11, 0.55, 0.0])
    assert planes.ties == 1 and planes.distinct == [2]
    # a later chunk's equal depth loses to the standing point (strict test),
    # a greater one wins
    planes.bin(torch.tensor([1, 2]), torch.tensor([0.5, 0.375]), torch.tensor([0.9, 0.8]))
    assert planes.zbuf.tolist() == [-1.0, 0.5, 0.375, -1.0]
    assert planes.steps.tolist() == pytest.approx([0.0, 0.11, 0.8, 0.0])
    assert planes.count.tolist() == [0, 4, 3, 0]
    assert planes.ties == 2 and planes.distinct == [2, 2]
    # the strict test against the sentinel: -1.0 and below never land
    planes.bin(torch.tensor([0, 3]), torch.tensor([-1.0, -3.0]), torch.tensor([0.5, 0.5]))
    assert planes.zbuf[0].item() == -1.0 and planes.zbuf[3].item() == -1.0
    assert planes.steps[0].item() == 0.0 and planes.count.tolist() == [1, 4, 3, 1]


def test_the_reference_ties_the_two_zeros_and_stores_plus_zero():
    planes = _plant()
    # -0.0 first: it keeps the pixel (the zeros tie), stored as +0.0
    planes.bin(torch.tensor([1, 1, 2, 2]), torch.tensor([-0.0, 0.0, 0.0, -0.0]),
               torch.tensor([0.1, 0.2, 0.3, 0.4]))
    assert planes.steps.tolist() == pytest.approx([0.0, 0.1, 0.3, 0.0])
    assert planes.zbuf.view(torch.int32).tolist() == [
        torch.tensor(-1.0).view(torch.int32).item(), 0, 0,
        torch.tensor(-1.0).view(torch.int32).item()]
    # a later -0.0 ties a standing +0.0 and loses
    planes.bin(torch.tensor([2]), torch.tensor([-0.0]), torch.tensor([0.9]))
    assert planes.steps[2].item() == pytest.approx(0.3)
    assert planes.ties == 3


def test_the_reference_takes_nan_depth_as_minus_inf_on_pixel_zero():
    dep = reference.Deployment.from_config(small_config())
    cam = reference.Camera(dep, 0.0, torch.float32)
    # one point on the canvas, one off it, one with NaN coordinates
    new = torch.tensor([[0.1, 50.0, math.nan], [0.2, 50.0, 0.0], [0.3, 50.0, 0.0]])[:, None]
    old = torch.zeros_like(new)
    flat, z2, val = reference_exact.exact_points(dep, cam, new, old)
    assert int(flat[1]) == dep.npix
    assert int(flat[2]) == 0 and z2[2].item() == -math.inf and math.isnan(val[2].item())
    assert 0 <= int(flat[0]) < dep.npix and math.isfinite(z2[0].item())
    planes = reference_exact.ExactPlanes(dep.npix, "cpu")
    planes.bin(flat, z2, val)
    # the NaN point counts on pixel 0 and never passes the test
    assert planes.count[0].item() == 1 and planes.zbuf[0].item() == -1.0
    assert planes.steps[0].item() == 0.0
    at = int(flat[0])
    assert planes.zbuf[at].item() == z2[0].item() and planes.steps[at].item() == val[0].item()
    assert int(planes.count.sum()) == 2 and planes.distinct == [2]


def test_the_reference_and_the_twin_agree_on_planted_streams():
    """The port's plain twin (which the CPU render runs) and the reference,
    each from its own definition, on streams full of equal depths, both
    zeros and NaN: the same planes."""
    gen = torch.Generator().manual_seed(5)
    npix, m = 16, 400
    count = torch.zeros(npix, dtype=torch.int32)
    steps = torch.zeros(npix, dtype=torch.float32)
    zbuf = torch.full((npix,), -1.0)
    planes = reference_exact.ExactPlanes(npix, "cpu")
    for _ in range(3):
        flat = torch.randint(0, npix + 2, (m,), generator=gen)
        z = torch.randint(-3, 4, (m,), generator=gen).to(torch.float32) / 2.0
        z = torch.where(torch.rand(m, generator=gen) < 0.1, -0.0, z)
        z = torch.where(torch.rand(m, generator=gen) < 0.05, -math.inf, z)
        val = torch.rand(m, generator=gen)
        flat = torch.where(flat > npix, npix, flat)
        count, steps, zbuf = binning.bin_chunk_exact(count, steps, zbuf, flat.to(torch.int32),
                                                     z, val)
        planes.bin(flat, z, val)
    assert torch.equal(count.to(torch.int64), planes.count)
    assert torch.equal(steps.view(torch.int32), planes.steps.view(torch.int32))
    assert torch.equal(zbuf.view(torch.int32), planes.zbuf.view(torch.int32))
    assert planes.ties > 0


# --- exact_still.py's correctness check, in-process ----------------------

def _cell(rows=None) -> harness.Cell:
    return harness.Cell("poisson-saturne.exact-pam", 1, small_config(CONFIG, rows),
                        small_traffic(), harness.HERE)


def _measure(rows=None) -> dict:
    return harness.measure(_cell(rows), seed=CHECK_SEED, seconds=0.01, trace=False,
                           device="cpu", t0=time.perf_counter(), bench=harness.load_bench())


def _patch_bin(monkeypatch, fn):
    kernel, twin = rmod._BINS[BinStrategy.EXACT_KERNEL]
    monkeypatch.setitem(rmod._BINS, BinStrategy.EXACT_KERNEL,
                        (lambda *a, **k: fn(kernel, *a, **k), twin))


def _quantized_value(monkeypatch):
    """``steps`` cut to the PACKED planes' 1/4096 palette position."""
    def cut(bin_, count, steps, zbuf, flat, z, val, **kw):
        q = torch.clamp(torch.nan_to_num(val, nan=0.0), 0.0, 0.999999)
        return bin_(count, steps, zbuf, flat, z, torch.floor(q * 4096.0) / 4096.0, **kw)

    _patch_bin(monkeypatch, cut)


def _latest_wins(monkeypatch):
    """A ``>=`` z-test: of equal depths the latest point wins, in a chunk
    and against the standing plane."""
    def latest(bin_, count, steps, zbuf, flat, z, val, **kw):
        npix = count.shape[0]
        keep = (flat >= 0) & (flat < npix)
        f = flat[keep].to(torch.int64)
        count = binning.to_u32_bits(binning.u32(count) + torch.bincount(f, minlength=npix))
        idx = torch.arange(flat.shape[0])[keep]
        key = (binning.mono_u32(binning.canonical_zero(z[keep])) << 31) | idx
        best = torch.full((npix,), -1, dtype=torch.int64).scatter_reduce(0, f, key, "amax")
        hit = best >= 0
        z_new = binning.inv_mono_u32(torch.clamp(best, min=0) >> 31)
        take = hit & (z_new >= zbuf) & (z_new > -1.0)
        winner = torch.where(hit, best & ((1 << 31) - 1), 0)
        return count, torch.where(take, val[winner], steps), torch.where(take, z_new, zbuf)

    _patch_bin(monkeypatch, latest)


def _bfloat16_render(monkeypatch):
    """The render's arithmetic in bfloat16: the reference's own control
    planes put in the program's place."""
    render = rmod.render

    def low(config, state=None, generator=None, **kw):
        state = render(config, state, generator, **kw)
        seed = int(generator.initial_seed())
        dep = reference.Deployment.from_config(small_config())
        lanes, chunk_steps, nchunks = rmod.plan_schedule(config)
        planes = reference_exact.render(
            dep, torch.Generator().manual_seed(seed),
            {"lanes": lanes, "chunk_steps": chunk_steps, "nchunks": nchunks},
            dtype=torch.bfloat16)
        shape = state.shape
        return state._replace(count=binning.to_u32_bits(planes.count).reshape(shape),
                              steps=planes.steps.reshape(shape),
                              zbuf=planes.zbuf.reshape(shape))

    monkeypatch.setattr(rmod, "render", low)


def _one_byte_of_the_file(monkeypatch):
    write = export.write_image

    def altered(*a, **k):
        path = write(*a, **k)
        data = bytearray(path.read_bytes())
        data[-1] ^= 0x01
        path.write_bytes(bytes(data))
        return path

    monkeypatch.setattr(export, "write_image", altered)


@pytest.mark.parametrize("rows", [None, 1], ids=["hero", "random map 1"])
def test_a_sound_run_of_the_driver_is_correct(rows):
    res = _measure(None if rows is None else random_rows(rows))
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == {"count_px_off", "steps_px_off", "zbuf_px_off",
                                  "image_px_off", "file_px_off", "none_checked"}
    assert all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("fault,rows,offs", [
    (_quantized_value, None, ("steps_px_off", "image_px_off", "file_px_off")),
    # ties of equal depth and different values are rare in a real orbit:
    # random map 1's cycles have them under CHECK_SEED
    (_latest_wins, 1, ("steps_px_off",)),
    (_bfloat16_render, None, ("count_px_off", "steps_px_off", "zbuf_px_off")),
    (_one_byte_of_the_file, None, ("file_px_off",)),
], ids=["quantized value", "latest wins ties", "bfloat16 render", "broken file"])
def test_the_driver_check_catches_each_fault(fault, rows, offs, monkeypatch):
    fault(monkeypatch)
    res = _measure(None if rows is None else random_rows(rows))
    assert res["correct"] is False and res["failed"] >= 1
    for off in offs:
        assert res["checks"][off]["value"] > 0, res["checks"]
    if fault is _one_byte_of_the_file:
        assert all(res["checks"][k]["value"] == 0 for k in ("count_px_off", "steps_px_off",
                                                             "zbuf_px_off", "image_px_off"))


def test_the_controls_fail_the_comparison(tmp_path):
    """The reference in bfloat16, and the PACKED planes' 12-bit colour value,
    each put in the program's place, fail; the float32 reference passes."""
    cell = _cell()
    driver = cell.driver()
    s = driver.plan(harness.Context(cell, torch.device("cpu"), CHECK_SEED, tmp_path))
    low = driver.control(s, 0, torch.bfloat16)
    assert any(low[k] > driver.LIMITS[k] for k in driver.LIMITS), low
    cut = driver.quantized_control(s, 0)
    assert cut["steps_px_off"] > 0 and cut["count_px_off"] == cut["zbuf_px_off"] == 0
    assert driver.control(s, 0, torch.float32) == dict.fromkeys(low, 0)


def test_the_reference_imports_nothing_of_the_program_or_jax():
    """Plain torch and numpy: no kernel of the port, no JAX."""
    import ast

    tree = ast.parse((harness.HERE / "reference_exact.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert mods <= {"__future__", "math", "numpy", "torch", "bench_torch",
                    "bench_torch.reference"}, mods
