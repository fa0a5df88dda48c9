"""The port's depth pass against the benchmark's plain depth reference
(``bench_torch/reference_depth.py``), on the CPU at a small size: the CLI's
single-frame chain of the ``poisson-saturne-depth-1080p`` configuration's
flags (``cli.config_from_args``, ``render.render``,
``render.colorize_convert_fetch``, ``write_image`` as PAM, the file read back
by ``bench_torch/images.py``) equals the reference bit for bit in the
z-buffer, the 8-bit image and the file; the reference's own edges (the -1
sentinel, a NaN depth); and the depth still driver's check, run in-process,
reads ``correct`` false under each fault of the path."""

from __future__ import annotations

import json
import math
import time

import pytest
import torch

from bench_torch import harness, images, reference, reference_depth
from strange_attractor_tpu_torch import cli
from strange_attractor_tpu_torch.config import BinStrategy, RenderKind
from strange_attractor_tpu_torch.runtime import RenderState
from strange_attractor_tpu_torch.utils import export

rmod = harness.program("render")
CONFIG = json.loads((harness.HERE / "configs" / "poisson-saturne-depth-1080p.json").read_text())
TRAFFIC = json.loads((harness.HERE / "traffic" / "still-1e9-pam.json").read_text())
W, H, LANES, STEPS, CHUNKS = 96, 54, 512, 16, 3
SEEDS = (7, 2**31 + 11, 5_000_000_029)


def _swap(args: list, flag: str, value: str) -> list:
    args = list(args)
    args[args.index(flag) + 1] = value
    return args


def small_config() -> dict:
    """The configuration file at the test's canvas and schedule."""
    c = json.loads(json.dumps(CONFIG))
    c["cli"] = _swap(_swap(c["cli"], "-w", str(W)), "-h", str(H)) + [
        "--lanes", str(LANES), "--chunk-steps", str(STEPS)]
    c["reference"]["width"], c["reference"]["height"] = W, H
    return c


def small_traffic() -> dict:
    t = json.loads(json.dumps(TRAFFIC))
    t["cli_options"] = _swap(t["cli_options"], "-i", str(LANES * STEPS * CHUNKS))
    t["checked_items"] = 1
    return t


def _program_config():
    c, t = small_config(), small_traffic()
    parser = cli.build_parser()
    args = parser.parse_args([*c["cli"], *t["cli_options"], "--device", "cpu"])
    cli._validate(args, parser)
    return args, cli.config_from_args(args)


def test_the_configuration_is_a_depth_pam_still():
    args, config = _program_config()
    assert config.render == RenderKind.DEPTH and args.pam and args.eight_bit
    assert not args.transparent
    assert config.resolved_bin_strategy() == BinStrategy.DEPTH_KERNEL
    assert rmod.plan_schedule(config) == (LANES, STEPS, CHUNKS)
    assert CONFIG["reduced"] == []
    assert CONFIG["reference"]["render"] == "depth"


@pytest.mark.parametrize("seed", SEEDS)
def test_the_depth_chain_equals_the_reference(seed, tmp_path):
    args, config = _program_config()
    lanes, chunk_steps, nchunks = rmod.plan_schedule(config)
    state = rmod.render(config, None, torch.Generator().manual_seed(seed), device="cpu")
    image = rmod.colorize_convert_fetch(config, state, transparent=args.transparent,
                                        eight_bit=args.eight_bit)
    path = export.write_image(tmp_path / "frame", image, fmt="pam",
                              transparent=args.transparent, eight_bit=args.eight_bit,
                              silent=True)
    dep = reference.Deployment.from_config(small_config())
    schedule = {"lanes": lanes, "chunk_steps": chunk_steps, "nchunks": nchunks}
    plane = reference_depth.render(dep, torch.Generator().manual_seed(seed), schedule)
    want = reference_depth.tonemap8(dep, plane.zbuf)
    got_bits = state.zbuf.reshape(-1).view(torch.int32)
    assert torch.equal(got_bits, plane.zbuf.view(torch.int32))
    assert torch.equal(torch.from_numpy(image), want)
    assert torch.equal(images.read_images([path], "pam")[0], want)
    # a real picture: many pixels lit, several grays, the sentinel elsewhere
    lit = plane.zbuf != -1.0
    assert 0.05 * W * H < int(lit.sum()) < W * H
    assert len(torch.unique(want[..., 0])) > 20
    assert len(plane.distinct) == nchunks and all(d > 0 for d in plane.distinct)


def _camera(dep):
    return reference.Camera(dep, 0.0, torch.float32)


def test_the_reference_keeps_the_sentinel_and_takes_nan_depth_as_minus_inf():
    dep = reference.Deployment.from_config(small_config())
    cam = _camera(dep)
    # one point on the canvas, one off it, one with NaN coordinates
    new = torch.tensor([[0.1, 50.0, math.nan], [0.2, 50.0, 0.0], [0.3, 50.0, 0.0]])[:, None]
    flat, z2 = reference_depth.depth_points(dep, cam, new)
    assert int(flat[1]) == dep.npix
    assert int(flat[2]) == 0 and z2[2].item() == -math.inf
    assert 0 <= int(flat[0]) < dep.npix and math.isfinite(z2[0].item())
    plane = reference_depth.ZBuffer(dep.npix, "cpu")
    plane.bin(flat, z2)
    zbuf = plane.zbuf
    # the NaN depth binned at pixel 0 never passes the test against -1.0
    assert zbuf[0].item() == -1.0
    assert zbuf[int(flat[0])].item() == z2[0].item()
    assert int((zbuf != -1.0).sum()) == 1
    assert plane.distinct == [2]
    # only depths above the sentinel land; the larger wins; -0.0 lands as +0.0
    plane = reference_depth.ZBuffer(4, "cpu")
    plane.bin(torch.tensor([1, 1, 2, 3, 3]), torch.tensor([-2.0, -1.0, -0.0, 0.25, 0.5]))
    assert plane.zbuf.tolist() == [-1.0, -1.0, 0.0, 0.5]
    assert plane.zbuf.view(torch.int32)[2].item() == 0  # +0.0
    # the tone map: the sentinel is black, the rest spread from the least
    # depth to max(0, largest), opaque gray
    img = reference_depth.tonemap8(reference.Deployment.from_config(
        {**small_config(), "reference": {**small_config()["reference"], "width": 4,
                                         "height": 1}}), plane.zbuf)
    assert img[0, :, 0].tolist() == [0, 0, 0, 255]
    assert torch.equal(img[..., 0], img[..., 1]) and torch.equal(img[..., 0], img[..., 2])


def _cell() -> harness.Cell:
    return harness.Cell("poisson-saturne.depth-pam", 1, small_config(), small_traffic(),
                        harness.HERE)


def _measure() -> dict:
    return harness.measure(_cell(), seed=2**31 + 977, seconds=0.01, trace=False, device="cpu",
                           t0=time.perf_counter(), bench=harness.load_bench())


def _half_of_each_chunk(monkeypatch):
    kernel, twin = rmod._BINS[BinStrategy.DEPTH_KERNEL]

    def half(zbuf, flat, z):
        n = flat.shape[0] // 2
        return kernel(zbuf, flat[:n], z[:n])

    monkeypatch.setitem(rmod._BINS, BinStrategy.DEPTH_KERNEL, (half, twin))


def _gas_tone_map(monkeypatch):
    """The depth plane delivered through the Gas tone map (its value read
    from the plane, one hit a pixel)."""
    deliver = rmod.colorize_convert_fetch

    def gas(config, state, **kw):
        ones = torch.ones(state.shape, dtype=torch.int32)
        planes = RenderState(count=ones, steps=state.zbuf, zbuf=state.zbuf)
        return deliver(config.replace(render=RenderKind.GAS), planes, **kw)

    monkeypatch.setattr(rmod, "colorize_convert_fetch", gas)


def _one_byte_of_the_file(monkeypatch):
    write = export.write_image

    def altered(*a, **k):
        path = write(*a, **k)
        data = bytearray(path.read_bytes())
        data[-1] ^= 0x01
        path.write_bytes(bytes(data))
        return path

    monkeypatch.setattr(export, "write_image", altered)


def test_a_sound_run_of_the_driver_is_correct():
    res = _measure()
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["checks"]) == {"zbuf_px_off", "image_px_off", "file_px_off", "none_checked"}


@pytest.mark.parametrize("fault,off", [(_half_of_each_chunk, "zbuf_px_off"),
                                       (_gas_tone_map, "image_px_off"),
                                       (_one_byte_of_the_file, "file_px_off")])
def test_the_driver_check_catches_each_fault(fault, off, monkeypatch):
    fault(monkeypatch)
    res = _measure()
    assert res["correct"] is False and res["failed"] >= 1
    assert res["checks"][off]["value"] > 0, res["checks"]
    if off != "zbuf_px_off":
        assert res["checks"]["zbuf_px_off"]["value"] == 0


def test_the_reference_imports_nothing_of_the_program_or_jax():
    """Plain torch and numpy: no kernel of the port, no JAX."""
    import ast

    for name in ("reference_depth.py", "reference.py"):
        tree = ast.parse((harness.HERE / name).read_text())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        assert mods <= {"__future__", "math", "dataclasses", "numpy", "torch", "bench_torch",
                        "bench_torch.reference"}, mods
