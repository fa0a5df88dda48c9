"""PyTorch port, lane-sharded rendering (``parallel.mesh``) against the JAX
package on the CPU: the collective merge bit for bit against the JAX
``merge_collective`` under ``shard_map`` on the 8 virtual CPU devices,
sharded renders over lists of CPU devices bit for bit against the merge of
their shards' ``render_seeds`` and statistically against the JAX
``render_sharded``, progress, resume, the lane-truncation warning,
``render_parallel``, the frames x lanes sequences, and the CLI's
multi-device flags with its device list patched to several CPU devices.

Tolerances: every comparison between port functions is bit-exact; against
the JAX package the merge is bit-exact and renders (different seed draws)
agree within 5% in count sum and above 0.6 in lit-pixel IoU, as
tests/test_parallel.py holds the JAX mesh to its single-device render.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from strange_attractor_tpu import cli as jcli, presets as jpresets
from strange_attractor_tpu.config import BinStrategy as JBin, RenderKind as JKind
from strange_attractor_tpu.parallel import mesh as jmesh
import strange_attractor_tpu_torch as sat
from strange_attractor_tpu_torch import cli
from strange_attractor_tpu_torch.convert import config_from_reference, state_to_numpy
from strange_attractor_tpu_torch.parallel import mesh
from strange_attractor_tpu_torch.deliver import deliver_batch, host_frames
from strange_attractor_tpu_torch.render import frame_generator, seeds_and_key
from strange_attractor_tpu_torch.runtime import progressive_nonce, state_to_planes

CPU = torch.device("cpu")
NPIX = 6 * 40
KINDS = {"packed": sat.BinStrategy.PACKED, "depth": sat.BinStrategy.DEPTH,
         "exact": sat.BinStrategy.EXACT}
NAMES = {"packed": ("count", "packed"), "depth": ("zbuf",), "exact": ("count", "steps", "zbuf")}
# z values of the planted planes: the sentinel, both zeros, values below
# the sentinel, ties, and the specials
Z_VALUES = np.array([-1.0, -0.0, 0.0, 0.25, 0.5, 0.5, 2.0, -2.5, -1.0, np.inf, -np.inf],
                    np.float32)


def _bits(t):
    t = torch.as_tensor(t)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b) -> bool:
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _planted(kind: str, n: int, seed: int, special: bool = True) -> list:
    """``n`` shards' (NPIX,) planes of ``kind`` as numpy: packed values over
    the whole u32 range (2^31 and up included) with ties, counts near 2^32,
    z from :data:`Z_VALUES` (ties across shards, both zeros, the -1
    sentinel); with ``special`` NaN z and -0.0 and arbitrary steps too."""
    rng = np.random.default_rng(seed)
    shards = []
    for _ in range(n):
        zbuf = Z_VALUES[rng.integers(0, len(Z_VALUES), NPIX)]
        zbuf = np.where(rng.random(NPIX) < 0.4, rng.normal(0, 1, NPIX), zbuf).astype(np.float32)
        if special:
            zbuf[rng.random(NPIX) < 0.08] = np.float32(np.nan)
            zbuf[rng.random(NPIX) < 0.04] = -np.float32(np.nan)
        steps = rng.random(NPIX).astype(np.float32)
        if special:
            steps[rng.random(NPIX) < 0.2] = -0.0
        else:
            # the bins canonicalize zeros, and steps stay 0 where no point won
            zbuf[zbuf == 0.0] = 0.0
            steps[zbuf <= -1.0] = 0.0
        count = (2**32 - rng.integers(1, 2**10, NPIX)).astype(np.uint32)
        small = rng.random(NPIX) < 0.5
        count[small] = rng.integers(0, 9, int(small.sum()))
        packed = rng.integers(0, 2**32, NPIX, dtype=np.uint64).astype(np.uint32)
        packed[rng.random(NPIX) < 0.3] = np.uint32(0x80000000)
        packed[rng.random(NPIX) < 0.2] = np.uint32(0x7FFFFFFF)
        shards.append(dict(count=count, steps=steps, zbuf=zbuf, packed=packed))
    return [tuple(s[k] for k in NAMES[kind]) for s in shards]


def _port_planes(shards) -> list:
    return [tuple(torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).clone()
                  for a in planes) for planes in shards]


def _jax_merge(kind: str, shards, devices) -> tuple:
    fn = jax.jit(jmesh.shard_map(
        lambda *p: jmesh.merge_collective(p, JBin(kind), "lanes"),
        mesh=Mesh(np.array(devices), ("lanes",)),
        in_specs=(P("lanes"),) * len(shards[0]), out_specs=P(), check_vma=False))
    out = fn(*(jnp.asarray(np.stack([s[i] for s in shards])) for i in range(len(shards[0]))))
    return tuple(np.asarray(o)[0] if np.asarray(o).ndim == 2 else np.asarray(o) for o in out)


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("kind", list(KINDS))
def test_merge_collective_matches_jax_bit_for_bit(cpu_devices, kind, n):
    """Packed values from 2^31 up, counts near 2^32 (the sum wraps), z ties
    across shards, both zeros, the -1 sentinel, NaN of both signs, -0.0
    steps: every plane bit-identical to the JAX merge on n CPU devices."""
    shards = _planted(kind, n, seed=10 + n)
    want = _jax_merge(kind, shards, cpu_devices[:n])
    got = mesh.merge_collective(_port_planes(shards), KINDS[kind])
    for name, g, w in zip(NAMES[kind], got, want):
        np.testing.assert_array_equal(_as_numpy(g).view(np.uint32),
                                      np.ascontiguousarray(w).view(np.uint32), err_msg=name)


@pytest.mark.parametrize("n", [2, 5])
@pytest.mark.parametrize("kind", list(KINDS))
def test_merge_collective_matches_merge_all_on_render_planes(kind, n):
    """Planes as a render leaves them (no NaN or -0.0 depth, steps 0.0
    where no point won, no -0.0 steps): the collective merge equals
    merge_all's fold bit for bit. (On a -0.0 against a +0.0 the fold's
    ``torch.maximum`` may take either; the merge keeps the lowest shard's,
    as JAX does.)"""
    shards = _port_planes(_planted(kind, n, seed=20 + n, special=False))
    got = mesh.merge_collective(shards, KINDS[kind])
    states = [mesh.planes_to_state(p, KINDS[kind], (6, 40)) for p in shards]
    want = sat.merge_all(states)
    for name, g in zip(NAMES[kind], got):
        assert _same(g.reshape(6, 40), getattr(want, name)), name


def test_merge_collective_departs_from_the_fold_as_jax_does(cpu_devices):
    """Where merge_all's fold and the JAX merge differ, the port follows
    JAX: a NaN depth never wins (all NaN gives -inf), a lone winner's -0.0
    steps sum to +0.0 across shards, and steps are 0.0 where no shard's
    depth beats the sentinel."""
    nan = np.float32(np.nan)
    zbuf = [np.array([nan, nan, -1.0, 0.5], np.float32),
            np.array([1.0, nan, -1.0, 0.25], np.float32)]
    steps = [np.array([7.0, 7.0, 7.0, -0.0], np.float32),
             np.array([5.0, 5.0, 5.0, 5.0], np.float32)]
    count = [np.ones(4, np.uint32)] * 2
    shards = [tuple(s) for s in zip(count, steps, zbuf)]
    got = mesh.merge_collective(_port_planes(shards), sat.BinStrategy.EXACT)
    want = _jax_merge("exact", shards, cpu_devices[:2])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_as_numpy(g).view(np.uint32), w.view(np.uint32))
    np.testing.assert_array_equal(got[2].numpy(), [1.0, -np.inf, -1.0, 0.5])
    assert got[1].numpy().tolist() == [5.0, 0.0, 0.0, 0.0]
    assert not torch.signbit(got[1][3])
    fold = sat.merge_all([mesh.planes_to_state(p, sat.BinStrategy.EXACT, (4,))
                          for p in _port_planes(shards)])
    assert torch.isnan(fold.zbuf[0]) and fold.steps[2] == 7.0 and torch.signbit(fold.steps[3])


STRATEGIES = [(sat.BinStrategy.KERNEL, False), (sat.BinStrategy.PACKED, False),
              (sat.BinStrategy.DEPTH_KERNEL, True), (sat.BinStrategy.EXACT_KERNEL, False),
              (sat.BinStrategy.EXACT16_KERNEL, False)]


def _cfg(strategy=sat.BinStrategy.KERNEL, depth=False, **kw):
    base = dict(width=48, height=27, iterations=60_000, lanes=128, chunk_steps=32, seed=4,
                warmup=100, silent=True, bin_strategy=strategy,
                render=sat.RenderKind.DEPTH if depth else sat.RenderKind.GAS)
    return sat.presets.poisson_saturne(**{**base, **kw})


def _shard_renders(cfg, k, base=None) -> list:
    local = mesh.shard_config(cfg, k)
    out = []
    for i in range(k):
        seeds, key = seeds_and_key(local, mesh.shard_generator(cfg, i, k, base))
        out.append(sat.render_seeds(local, seeds, reseed_key=key))
    return out


def _assert_states_equal(a, b):
    for name in ("count", "steps", "zbuf", "packed"):
        pa, pb = getattr(a, name), getattr(b, name)
        assert (pa is None) == (pb is None), name
        if pa is not None:
            assert _same(pa, pb), name


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("strategy,depth", STRATEGIES)
def test_render_sharded_equals_merge_of_shard_renders(strategy, depth, k):
    """Bit for bit: the merge of k render_seeds at the shard schedule with
    the shard generators' seeds (the plain twins on the CPU)."""
    cfg = _cfg(strategy, depth)
    got = mesh.render_sharded(cfg, [CPU] * k)
    shards = _shard_renders(cfg, k)
    want = mesh.planes_to_state(
        mesh.merge_collective([state_to_planes(s) for s in shards], strategy),
        strategy, (27, 48))
    _assert_states_equal(got, want)
    _assert_states_equal(got, sat.merge_all(shards))
    lanes, chunk, nchunks = sat.plan_schedule(cfg)
    assert sat.plan_schedule(mesh.shard_config(cfg, k)) == (lanes // k, chunk, nchunks)


@pytest.mark.parametrize("kw", [dict(reseed_lanes=True, preset="solar-sail"),
                                dict(dtype="float64")])
def test_render_sharded_carries_reseeding_and_float64(kw):
    kw = dict(kw)
    preset = kw.pop("preset", "poisson-saturne")
    cfg = sat.presets.by_name(preset, width=48, height=27, iterations=40_000, lanes=64,
                              chunk_steps=25, seed=3, silent=True, **kw)
    got = mesh.render_sharded(cfg, [CPU] * 2)
    _assert_states_equal(got, sat.merge_all(_shard_renders(cfg, 2)))
    assert int(got.count.sum()) > 0


@pytest.mark.parametrize("strategy,depth", [(sat.BinStrategy.KERNEL, False),
                                            (sat.BinStrategy.EXACT_KERNEL, False),
                                            (sat.BinStrategy.DEPTH_KERNEL, True)])
def test_render_sharded_statistically_matches_jax(cpu_devices, strategy, depth):
    """The port over 8 CPU shards against the JAX mesh over 8 CPU devices,
    at tests/test_parallel.py's bounds: count sum within 5%, lit IoU > 0.6."""
    jcfg = jpresets.poisson_saturne(
        width=64, height=36, iterations=100_000, lanes=256, chunk_steps=64, seed=4,
        bin_strategy=JBin(strategy.value),
        render=JKind.DEPTH if depth else JKind.GAS)
    jst = jmesh.render_sharded(jcfg, cpu_devices)
    st = mesh.render_sharded(config_from_reference(jcfg).replace(silent=True), [CPU] * 8)
    if depth:
        lit, jlit = st.zbuf.numpy() != -1.0, np.asarray(jst.zbuf) != -1.0
    else:
        c, jc = st.count.numpy().view(np.uint32), np.asarray(jst.count)
        assert abs(float(c.sum()) - float(jc.sum())) / float(jc.sum()) < 0.05
        lit, jlit = c > 0, jc > 0
    assert (lit & jlit).sum() / max(1, (lit | jlit).sum()) > 0.6


def test_grouped_progress_is_bit_identical():
    """on_progress after chunks 64, 128 and 130 (render_seeds' points);
    each partial equals the sharded render stopped at that chunk, and the
    grouped render equals the ungrouped one."""
    cfg = _cfg(iterations=16 * 2 * 130, lanes=16, chunk_steps=2)
    seen = []
    got = mesh.render_sharded(cfg, [CPU] * 2,
                              on_progress=lambda d, t, s: seen.append((d, t, s)))
    assert [(d, t) for d, t, _ in seen] == [(64, 130), (128, 130), (130, 130)]
    _assert_states_equal(got, mesh.render_sharded(cfg, [CPU] * 2))
    _assert_states_equal(seen[-1][2], got)
    for done, _, partial in seen[:-1]:
        stopped = mesh.render_sharded(cfg.replace(iterations=16 * 2 * done), [CPU] * 2)
        _assert_states_equal(partial, stopped)


def test_resume_equals_merge_of_state_and_fresh():
    """state= folds a fresh sharded render into the standing state; a
    seeded config draws it from the state's content nonce, and every
    progress partial includes the standing state."""
    cfg = _cfg(sat.BinStrategy.EXACT_KERNEL, iterations=20_000)
    first = mesh.render_sharded(cfg, [CPU] * 2)
    partials = []
    resumed = mesh.render_sharded(cfg, [CPU] * 2, state=first,
                                  on_progress=lambda d, t, s: partials.append(s))
    base = mesh._shard_base(cfg, None, progressive_nonce(first))
    shards = _shard_renders(cfg, 2, base)
    fresh = mesh.planes_to_state(mesh.merge_collective(
        [state_to_planes(s) for s in shards], cfg.bin_strategy), cfg.bin_strategy, (27, 48))
    _assert_states_equal(resumed, sat.merge(first, fresh))
    _assert_states_equal(partials[-1], resumed)
    assert int(resumed.count.sum()) > int(first.count.sum())
    # a PACKED checkpoint resumes through KERNEL, and a mismatched canvas is refused
    packed = mesh.render_sharded(cfg.replace(bin_strategy=sat.BinStrategy.PACKED), [CPU] * 2)
    assert mesh.render_sharded(_cfg(), [CPU] * 2, state=packed).strategy == \
        sat.BinStrategy.PACKED
    with pytest.raises(ValueError, match="does not match"):
        mesh.render_sharded(_cfg(width=40), [CPU] * 2, state=packed)


def test_lane_truncation_warns_like_jax():
    jcfg = jpresets.poisson_saturne(width=16, height=9, iterations=3_000, lanes=100,
                                    chunk_steps=10, seed=1)
    with pytest.warns(UserWarning) as jw:
        jmesh._split_lanes(jcfg, 100, 8)
    with pytest.warns(UserWarning) as pw:
        local = mesh.shard_config(config_from_reference(jcfg), 8)
    assert str(pw[0].message) == str(jw[0].message)
    assert local.lanes == 12
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mesh.shard_config(config_from_reference(jcfg.replace(lanes=None)), 8)


def test_render_parallel():
    """One device: render_frame itself; several: the sharded render's
    colorized frame. jobs_per_thread is ignored."""
    cfg = _cfg(iterations=30_000)
    one = sat.render_parallel(cfg, devices=[CPU], jobs_per_thread=3)
    np.testing.assert_array_equal(one, sat.render_frame(cfg, device="cpu"))
    two = sat.render_parallel(cfg, devices=[CPU, CPU])
    want = sat.colorize(cfg, mesh.render_sharded(cfg, [CPU, CPU])).numpy()
    np.testing.assert_array_equal(two, want)
    assert two.shape == (27, 48, 4) and two.dtype == np.uint16


def test_render_devices_defaults_to_the_card():
    assert mesh.resolve_devices(["cpu", CPU]) == [CPU, CPU]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.resolve_devices()
        with pytest.raises(RuntimeError, match="CUDA"):
            sat.render_parallel(_cfg())


def _delivered(cfg, states, transparent=False, eight_bit=True) -> np.ndarray:
    out = host_frames(cfg, len(states), transparent, eight_bit, states[0].device)
    deliver_batch(cfg, states, out, transparent, eight_bit)
    return out


SEQ = dict(width=40, height=24, iterations=12_000, lanes=64, chunk_steps=25, seed=7,
           warmup=100, silent=True)
ANGLES = [0.0, 40.0, 95.0, 180.0, 250.0]


@pytest.mark.parametrize("frames_per_batch", [0, 1])
def test_sequence_sharded_per_frame_is_its_composition(frames_per_batch):
    """A 2 x 2 grid of CPU devices: frame i is render_sharded over its
    row's two devices with frame_generator(config, i) at its angle,
    however the angles group."""
    cfg = sat.presets.poisson_saturne(**SEQ)
    got = mesh.render_sequence_sharded(cfg, ANGLES, [CPU] * 4, frame_axis=2, transparent=False,
                                       eight_bit=True, frames_per_batch=frames_per_batch)
    states = [mesh.render_sharded(cfg.replace(angle=float(np.radians(a))), [CPU] * 2,
                                  frame_generator(cfg, i)) for i, a in enumerate(ANGLES)]
    np.testing.assert_array_equal(got, _delivered(cfg, states))


@pytest.mark.parametrize("strategy", [sat.BinStrategy.KERNEL, sat.BinStrategy.EXACT_KERNEL])
def test_sequence_sharded_shared_rows_are_their_composition(strategy):
    """orbit="shared" on a 2 x 2 grid, two frames a row: groups of four
    angles, row slices [0, 2), [2, 4), then [4, 5) and a padded row that
    renders nothing; every frame equals render_sharded of its row's orbit
    (the slice's first frame's generator) at its angle."""
    cfg = sat.presets.poisson_saturne(**SEQ, bin_strategy=strategy)
    got = mesh.render_sequence_sharded(cfg, ANGLES, [CPU] * 4, frame_axis=2, transparent=True,
                                       eight_bit=False, frames_per_batch=2, orbit="shared")
    states = []
    for lo, hi in ((0, 2), (2, 4), (4, 5)):
        states += [mesh.render_sharded(cfg.replace(angle=float(np.radians(ANGLES[i]))),
                                       [CPU] * 2, frame_generator(cfg, lo))
                   for i in range(lo, hi)]
    np.testing.assert_array_equal(got, _delivered(cfg, states, True, False))


def test_sequence_sharded_edges_match_jax():
    cfg = sat.presets.poisson_saturne(**SEQ)
    jcfg = jpresets.poisson_saturne(**SEQ)
    errors = []
    for fn, c, devs in ((jmesh.render_sequence_sharded, jcfg, jax.devices()[:2]),
                        (mesh.render_sequence_sharded, cfg, [CPU] * 2)):
        with pytest.raises(ValueError) as e:
            fn(c, [0.0, 1.0], devs, orbit="spiral")
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    empty = mesh.render_sequence_sharded(cfg, [], [CPU] * 2, eight_bit=True)
    assert empty.shape == (0, 24, 40, 4) and empty.dtype == np.uint8
    blank = mesh.render_sequence_sharded(cfg.replace(iterations=0), [0.0, 9.0], [CPU] * 2)
    np.testing.assert_array_equal(
        blank, sat.render_sequence_batched(cfg.replace(iterations=0), [0.0, 9.0], device="cpu"))


# ------------------------------------------------------------------- CLI --

SMALL = ["-i", "20000", "-w", "40", "-h", "24", "--lanes", "64", "--chunk-steps", "25",
         "--seed", "5", "-q", "-8", "--device", "cpu"]


def _parse(module, argv):
    parser = module.build_parser()
    args = parser.parse_args(argv)
    module._validate(args, parser)
    return args


@pytest.mark.parametrize("argv", [
    ["-j", "4", "--single-device"],
    ["-j", "0"],
    ["--coordinator", "127.0.0.1:1234"],
    ["--coordinator", "127.0.0.1:1234", "--num-processes", "2"],
    ["--coordinator", "127.0.0.1:1234", "--process-id", "0"],
])
def test_multi_device_flag_errors_match_jax_cli(argv, capsys):
    errors = []
    for module in (jcli, cli):
        with pytest.raises(SystemExit) as e:
            _parse(module, argv)
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.split("error: ", 1)[1])
    assert errors[1] == errors[0]


@pytest.mark.parametrize("argv,want", [
    ([], dict(jobs_per_thread=12, single_device=False, distributed=False)),
    (["-j", "4"], dict(jobs_per_thread=4)),
    (["--single-thread"], dict(single_device=True, jobs_per_thread=12)),
    (["--coordinator", "h:1", "--num-processes", "2", "--process-id", "1"],
     dict(coordinator="h:1", num_processes=2, process_id=1)),
    (["--distributed"], dict(distributed=True)),
])
def test_multi_device_flags_parse_like_jax_cli(argv, want):
    ours, theirs = vars(_parse(cli, argv)), vars(_parse(jcli, argv))
    for key, value in want.items():
        assert ours[key] == theirs[key] == value


@pytest.mark.parametrize("argv,want", [
    (["--device", "cpu"], [CPU]),
    (["--device", "cuda:1"], [torch.device("cuda", 1)]),
    (["--single-device"], [torch.device("cuda")]),
    (["--single-device", "--device", "cuda:2"], [torch.device("cuda", 2)]),
])
def test_render_devices_follows_the_flags(argv, want):
    assert cli.render_devices(_parse(cli, argv)) == want


@pytest.fixture
def two_cpus(monkeypatch):
    monkeypatch.setattr(cli, "render_devices", lambda args: [CPU, CPU])


def test_cli_frame_on_two_devices(tmp_path, two_cpus, capsys):
    """The frame is the sharded render's, the checkpoint its planes, and a
    resumed run merges a fresh sharded render into them; a preview is
    written from the merged partial."""
    from strange_attractor_tpu_torch.deliver import fetch
    from strange_attractor_tpu_torch.ops.colorize import convert_format_device

    assert cli.main([*SMALL, "-o", str(tmp_path / "a"), "--save-state",
                     str(tmp_path / "a.npz"), "--preview-every", "1e-9"]) == 0
    cfg = cli.config_from_args(_parse(cli, SMALL))
    state = mesh.render_sharded(cfg, [CPU, CPU])
    saved = np.load(tmp_path / "a.npz")
    for name, plane in state_to_numpy(state).items():
        np.testing.assert_array_equal(saved[name], plane)
    from strange_attractor_tpu_torch.utils.export import png_bytes

    image = fetch(convert_format_device(sat.colorize(cfg, state), False, True))
    assert (tmp_path / "a.png").read_bytes() == png_bytes(image)
    assert (tmp_path / "a-preview.png").exists()
    assert cli.main([*SMALL, "-o", str(tmp_path / "b"), "--load-state",
                     str(tmp_path / "a.npz"), "--save-state", str(tmp_path / "b.npz")]) == 0
    resumed = mesh.render_sharded(cfg, [CPU, CPU], state=state)
    for name, plane in state_to_numpy(resumed).items():
        np.testing.assert_array_equal(np.load(tmp_path / "b.npz")[name], plane)


@pytest.mark.parametrize("extra", [[], ["--frames-per-batch", "1"],
                                   ["--frames-per-batch", "2", "--orbit", "shared"]])
def test_cli_sequence_on_two_devices(tmp_path, two_cpus, extra):
    """Per-frame sequences render each frame over both devices; batched
    ones take the frames x lanes grid (two rows of one device here)."""
    from strange_attractor_tpu_torch.utils.export import png_bytes

    argv = [*SMALL, "-o", str(tmp_path / "s"), "sequence", "-s", "0", "-e", "3", "-d", "1",
            *extra]
    assert cli.main(argv) == 0
    cfg = cli.config_from_args(_parse(cli, SMALL))
    angles = [0.0, 1.0, 2.0]
    if extra:
        want = mesh.render_sequence_sharded(cfg, angles, [CPU, CPU], transparent=False,
                                            eight_bit=True, frames_per_batch=int(extra[1]),
                                            orbit=extra[3] if len(extra) > 2 else "per-frame")
    else:
        base = cfg.seed
        want = _delivered(cfg, [mesh.render_sharded(cfg.replace(angle=float(np.radians(a))),
                                                    [CPU, CPU], frame_generator(cfg, i, base))
                                for i, a in enumerate(angles)])
    for i in range(3):
        assert (tmp_path / f"s{i}.png").read_bytes() == png_bytes(want[i])
