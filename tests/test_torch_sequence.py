"""PyTorch port, the rotation-sequence engines against the JAX package on
the CPU.

The shared-orbit emission splits a map step into a frame-invariant half
(``map_emit_shared_plain``, JAX's ``_step_fn_shared``) and a per-frame
projection (``project_emit_plain``, JAX's ``_project_emit``); both are held
bit for bit to the eager JAX functions (``jax.disable_jit()``: XLA's CPU
``jit`` contracts into FMAs, see ``test_torch_emit.py``). The split must
not change a bit against the fused step, so every frame of a shared batch
equals ``render_seeds`` of the batch's seeds at its angle, as in
``tests/test_sequence_shared.py``. Whole sequences draw different seeds
from JAX's (torch.Generator against jax.random) and are compared
statistically, at the tone-map tolerance of ``test_torch_render.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from strange_attractor_tpu import presets as jpresets
from strange_attractor_tpu.config import BinStrategy as JBin
from strange_attractor_tpu.ops.projection import camera_params as jcamera_params
from strange_attractor_tpu.render import (_project_emit, _step_fn_shared,
                                          render_sequence_shared as jshared)
from strange_attractor_tpu.utils.export import convert_format
import strange_attractor_tpu_torch as sat
from strange_attractor_tpu_torch.convert import config_from_reference
from strange_attractor_tpu_torch.ops import emit
from strange_attractor_tpu_torch.render import frame_generator, seeds_and_key
from test_torch_emit import _assert_same_floats, _lanes

B = sat.BinStrategy
ANGLES_DEG = [0.0, 90.0, 222.5]


def _cfg(preset: str = "poisson-saturne", **kw):
    """48x27, 30,000 iterations over 64 lanes in 32-step chunks (15 chunks);
    a short warm-up keeps the eager twins quick."""
    base = dict(width=48, height=27, iterations=30_000, lanes=64, chunk_steps=32, warmup=100,
                seed=8)
    base.update(kw)
    if B(base.get("bin_strategy", B.AUTO)).planes_kind() == B.DEPTH:
        base.setdefault("render", sat.RenderKind.DEPTH)  # a z-only state tone-maps as Depth
    return sat.presets.by_name(preset, **base)


def _seeds(cfg, index: int = 0) -> torch.Tensor:
    return emit.seed_points(sat.plan_schedule(cfg)[0], frame_generator(cfg, index))


def _image(cfg, state) -> np.ndarray:
    return sat.colorize(cfg, state).numpy()


def _same_planes(got, want):
    for name, g in got._asdict().items():
        w = getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), name


def _jax_shared(jcfg, pts: np.ndarray, steps: int, strategy: JBin):
    """``steps`` chained eager ``_step_fn_shared`` steps -> (step-major
    invariant streams, final points)."""
    cam = jcamera_params(jcfg.view, 0.0, jcfg.width, jcfg.height)
    step = _step_fn_shared(jcfg, cam, strategy)
    x, y, z = (jnp.asarray(pts[k]) for k in range(3))
    carry = (x, y, z, x, y, z, jnp.zeros(pts.shape[1], jnp.int32))
    rows = []
    with jax.disable_jit():
        for _ in range(steps):
            carry, emitted = step(carry, None)
            rows.append(emitted)
    streams = tuple(jnp.concatenate(s) for s in zip(*rows))
    return streams, np.stack([np.asarray(c) for c in carry[:3]])


@pytest.mark.parametrize("kind", [B.PACKED, B.DEPTH, B.EXACT])
@pytest.mark.parametrize("preset,size", [("poisson-saturne", (320, 180)),
                                         ("solar-sail", (640, 360))])
def test_shared_emission_bit_exact_vs_eager_jax(preset, size, kind):
    """The invariant streams, the lane state and each frame's stream equal
    eager JAX; each frame's stream also equals the fused ``map_emit_plain``
    of the same orbit at that angle. solar-sail's NaN lanes reach pixel
    (0, 0) through the projection."""
    jcfg = jpresets.by_name(preset, width=size[0], height=size[1])
    pts = _lanes(size[0], 256)
    jstreams, jpts = _jax_shared(jcfg, pts, 3, JBin(kind.value))
    cfg = config_from_reference(jcfg)
    got_pts = torch.from_numpy(pts.copy())
    shared = emit.map_emit_shared_plain(emit.emit_spec(cfg, 0.0), got_pts, 3, kind=kind)
    assert len(shared) == (3 if kind == B.DEPTH else 4)
    for g, w in zip(shared, jstreams):
        _assert_same_floats(g.numpy(), np.asarray(w))
    _assert_same_floats(got_pts.numpy(), jpts)
    cam = jcamera_params(jcfg.view, 0.0, jcfg.width, jcfg.height)
    for deg in ANGLES_DEG:
        rad = math.radians(deg)
        spec = emit.emit_spec(cfg, rad)
        got = emit.project_emit_plain(spec, shared, kind=kind)
        with jax.disable_jit():
            want = _project_emit(jcfg, cam, JBin(kind.value), jnp.float32(np.cos(rad)),
                                 jnp.float32(np.sin(rad)), jstreams)
        assert len(got) == len(want)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            _assert_same_floats(g.numpy().view(np.float32), np.asarray(w).view(np.float32))
        fused = emit.map_emit_plain(spec, torch.from_numpy(pts.copy()), 3, kind=kind)
        for g, w in zip(got, fused):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert preset != "solar-sail" or bool((got[0] == 0).any())


@pytest.mark.parametrize("strategy", [B.PACKED, B.KERNEL, B.DEPTH, B.DEPTH_KERNEL, B.EXACT,
                                      B.EXACT_KERNEL, B.EXACT16_KERNEL])
def test_shared_frame_bit_matches_render_seeds(strategy):
    """Every frame of a shared batch is ``render_seeds`` of the batch's
    seeds (frame 0's generator) at its angle: planes and tone-mapped frame."""
    cfg = _cfg(bin_strategy=strategy)
    seeds = _seeds(cfg)
    rad = np.radians(ANGLES_DEG)
    states = sat.render_seeds_shared(cfg, seeds, rad)
    frames = sat.render_sequence_shared(cfg, ANGLES_DEG, device="cpu")
    assert frames.shape == (3, 27, 48, 4) and frames.dtype == np.uint16
    for i, a in enumerate(rad):
        want = sat.render_seeds(cfg, seeds, angle=float(a))
        _same_planes(states[i], want)
        np.testing.assert_array_equal(frames[i], _image(cfg, want))
    assert len({frames[i].tobytes() for i in range(3)}) == 3


def test_shared_batch_split_keys():
    """Each batch bins the orbit of its first frame's generator, whose
    frame equals the per-frame engine's; equal angles in one batch give
    equal frames."""
    cfg = _cfg()
    angles = [0.0, 90.0, 180.0]
    frames = sat.render_sequence_shared(cfg, angles, frames_per_batch=2, device="cpu")
    for i in (0, 2):
        want = sat.render_seeds(cfg, _seeds(cfg, i), angle=math.radians(angles[i]))
        np.testing.assert_array_equal(frames[i], _image(cfg, want))
    per_frame = sat.render_sequence_batched(cfg, angles, device="cpu")
    np.testing.assert_array_equal(frames[[0, 2]], per_frame[[0, 2]])
    assert not np.array_equal(frames[1], per_frame[1])
    dup = sat.render_sequence_shared(cfg, [45.0, 45.0], device="cpu")
    np.testing.assert_array_equal(dup[0], dup[1])


@pytest.mark.parametrize("engine", ["render_sequence_shared", "render_sequence_batched"])
def test_frames_per_batch_zero_means_auto(engine):
    fn = getattr(sat, engine)
    cfg = _cfg(iterations=8_000)
    want = fn(cfg, [0.0, 45.0], device="cpu")
    np.testing.assert_array_equal(fn(cfg, [0.0, 45.0], frames_per_batch=0, device="cpu"), want)
    np.testing.assert_array_equal(fn(cfg, [0.0, 45.0], frames_per_batch=-3, device="cpu"), want)


def test_degenerate_inputs():
    """iterations=0 gives blank frames on both engines; an empty angle list
    gives no frames, in the converted shape and type."""
    blank_cfg = _cfg(iterations=0)
    blank = sat.render_sequence_shared(blank_cfg, [0.0, 90.0], device="cpu")
    np.testing.assert_array_equal(
        blank, sat.render_sequence_batched(blank_cfg, [0.0, 90.0], device="cpu"))
    one = _image(blank_cfg, sat.RenderState.create(blank_cfg, device="cpu"))
    assert blank.shape == (2, 27, 48, 4)
    np.testing.assert_array_equal(blank[1], one)
    empty = sat.render_sequence_shared(_cfg(), [], device="cpu")
    assert empty.shape == (0, 27, 48, 4) and empty.dtype == np.uint16
    empty8 = sat.render_sequence_batched(_cfg(), [], transparent=False, eight_bit=True,
                                         device="cpu")
    assert empty8.shape == (0, 27, 48, 3) and empty8.dtype == np.uint8


@pytest.mark.parametrize("transparent,eight_bit", [(False, True), (True, True), (False, False)])
def test_device_conversion_matches_host(transparent, eight_bit):
    """Frames converted on the device equal the host conversion of the raw
    u16 RGBA frames, for a Gas and a Depth sequence."""
    for cfg in (_cfg(iterations=8_000), _cfg(iterations=8_000, bin_strategy=B.DEPTH_KERNEL)):
        raw = sat.render_sequence_shared(cfg, [0.0, 120.0], device="cpu")
        conv = sat.render_sequence_shared(cfg, [0.0, 120.0], transparent=transparent,
                                          eight_bit=eight_bit, device="cpu")
        assert conv.shape == (2, 27, 48, 4 if transparent else 3)
        assert conv.dtype == (np.uint8 if eight_bit else np.uint16)
        for f_raw, f_conv in zip(raw, conv):
            np.testing.assert_array_equal(f_conv, convert_format(f_raw, transparent, eight_bit))


def test_seeded_batched_equals_render_sequence():
    cfg = _cfg(iterations=8_000)
    seq = list(sat.render_sequence(cfg, 0.0, 3.0, 1.0, device="cpu"))
    assert [a for a, _ in seq] == [0.0, 1.0, 2.0]
    batched = sat.render_sequence_batched(cfg, [0.0, 1.0, 2.0], frames_per_batch=2,
                                          device="cpu")
    np.testing.assert_array_equal(np.stack([img for _, img in seq]), batched)
    np.testing.assert_array_equal(sat.render_frame(cfg, frame_generator(cfg, 1),
                                                   angle=math.radians(1.0), device="cpu"),
                                  batched[1])


def test_frame_generators():
    """A seeded config's frame generators are reproducible and differ by
    index; an unseeded one folds into the base it is given."""
    cfg = _cfg()
    draws = [torch.rand(4, generator=frame_generator(cfg, i)) for i in (0, 0, 1)]
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    unseeded = cfg.replace(seed=None)
    a, b = (torch.rand(4, generator=frame_generator(unseeded, 3, base=77)) for _ in range(2))
    assert torch.equal(a, b)
    assert torch.equal(torch.rand(4, generator=frame_generator(cfg.replace(seed=77), 3)), a)


@pytest.mark.parametrize("engine", ["render_sequence_shared", "render_sequence_batched",
                                    "render_seeds_shared"])
def test_reseed_lanes_raises(engine):
    """Lane reseeding (and the shared path's emission gate), ported since,
    renders in every sequence engine on the CPU: each frame bit-identical
    to the plain twins' render of its seeds and render key (a shared batch:
    its first frame's generator's)."""
    cfg = _cfg("solar-sail", reseed_lanes=True)
    rad = np.radians(ANGLES_DEG)
    seeds, key = seeds_and_key(cfg, frame_generator(cfg, 0))
    if engine == "render_seeds_shared":
        got = sat.render_seeds_shared(cfg, seeds, rad, reseed_key=key)
        want = sat.render_seeds_shared(cfg, seeds, rad, plain=True, reseed_key=key)
        for g, w in zip(got, want):
            _same_planes(g, w)
        return
    frames = getattr(sat, engine)(cfg, ANGLES_DEG, device="cpu")
    for i, a in enumerate(rad):
        if engine == "render_sequence_batched":
            seeds, key = seeds_and_key(cfg, frame_generator(cfg, i))
        want = sat.render_seeds(cfg, seeds, angle=float(a), plain=True, reseed_key=key)
        np.testing.assert_array_equal(frames[i], _image(cfg, want))


def test_wrappers_run_the_twins_on_cpu_without_launching():
    spec = emit.emit_spec(config_from_reference(jpresets.solar_sail(width=96, height=54)),
                          math.radians(30))
    a, b = torch.from_numpy(_lanes(12, 64)), torch.from_numpy(_lanes(12, 64))
    before = (emit.map_emit.launches, emit.project_emit.launches)
    got = emit.map_emit_shared(spec, a, 5, kind=B.EXACT)
    want = emit.map_emit_shared_plain(spec, b, 5, kind=B.EXACT)
    assert all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want))
    frame = emit.project_emit(spec, got, kind=B.EXACT)
    assert all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(frame, emit.project_emit_plain(spec, want, kind=B.EXACT)))
    assert frame[2] is got[3]  # an EXACT frame hands the shared value stream on
    assert (emit.map_emit.launches, emit.project_emit.launches) == before
    with pytest.raises(ValueError, match="shared streams"):
        emit.project_emit(spec, got[:3], kind=B.PACKED)


@pytest.mark.parametrize("preset", ["poisson-saturne", "solar-sail"])
def test_statistical_vs_jax_render_sequence_shared(preset):
    jcfg = jpresets.by_name(preset, width=96, height=54, iterations=400_000, lanes=128,
                            chunk_steps=125, warmup=1000, seed=3, transparent=False,
                            bin_strategy=JBin.PACKED)
    angles = [0.0, 120.0]
    want = jshared(jcfg, angles)
    cfg = config_from_reference(jcfg).replace(bin_strategy=B.KERNEL)
    got = sat.render_sequence_shared(cfg, angles, device="cpu")
    assert got.shape == want.shape == (2, 54, 96, 4)
    for g, w in zip(got, want):
        mad = np.abs(g[..., :3].astype(np.float64) - w[..., :3]).mean() / 65535.0
        assert mad < 0.035, f"mean abs tone-mapped diff {mad}"
        lit_g, lit_w = g[..., :3].max(-1) > 0, w[..., :3].max(-1) > 0
        overlap = (lit_g & lit_w).sum() / max(1, (lit_g | lit_w).sum())
        assert overlap > 0.80, f"support overlap {overlap}"
