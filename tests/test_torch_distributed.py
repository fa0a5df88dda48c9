"""PyTorch port, multi-process rendering (``parallel.distributed``) on the
CPU: two real processes over gloo. Both ranks hold the same merged planes,
bit for bit those of ``render_sharded`` over two shards in one process
(resume and progress included); the group form of ``merge_collective``
equals its list form on planted planes; a frames-per-batch sequence over
the ranks equals the one-row grid in one process; and the CLI under
``--coordinator`` writes its PNG (the two-device frame's bytes) and says
so on rank 0 only. Every comparison is bit-exact.
"""

from __future__ import annotations

import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import strange_attractor_tpu_torch as sat
from strange_attractor_tpu_torch import cli
from strange_attractor_tpu_torch.parallel import distributed as dist, mesh
from strange_attractor_tpu_torch.render import frame_generator
from strange_attractor_tpu_torch.utils.export import convert_format, png_bytes

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CFG = dict(width=40, height=24, iterations=30_000, lanes=64, chunk_steps=25, seed=9,
           silent=True)
CLI_ARGS = ["-i", "20000", "-w", "40", "-h", "24", "--lanes", "64", "--chunk-steps", "25",
            "--seed", "5", "-8", "--device", "cpu"]

_WORKER = r'''
import sys
import numpy as np
import torch
import strange_attractor_tpu_torch as sat
from strange_attractor_tpu_torch.parallel import distributed as dist, mesh
from strange_attractor_tpu_torch.runtime import state_to_numpy

pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid, device="cpu")
dist.initialize(f"127.0.0.1:{port}", num_processes=2, process_id=pid)  # idempotent
assert (dist.process_index(), dist.process_count(), dist.is_primary()) == (pid, 2, pid == 0)
cfg = sat.presets.poisson_saturne(**CFG)
arrays = {}
for name, strategy in (("kernel", sat.BinStrategy.KERNEL),
                       ("exact", sat.BinStrategy.EXACT_KERNEL)):
    state = dist.render_distributed(cfg.replace(bin_strategy=strategy))
    arrays.update({f"{name}_{k}": v for k, v in state_to_numpy(state).items()})
first = dist.render_distributed(cfg, state=None)
done = []
resumed = dist.render_distributed(cfg.replace(iterations=64 * 2 * 70, lanes=64, chunk_steps=2),
                                  state=None, on_progress=lambda d, t, s: done.append(d))
arrays["progress"] = np.array(done)
arrays.update({f"progress_{k}": v for k, v in state_to_numpy(resumed).items()})
again = dist.render_distributed(cfg, state=first)
arrays.update({f"resumed_{k}": v for k, v in state_to_numpy(again).items()})
rng = np.random.default_rng(pid)
planted = (torch.from_numpy(rng.integers(-2**31, 2**31, 50, dtype=np.int64).astype(np.int32)),
           torch.from_numpy(rng.choice(np.float32([-0.0, 0.0, 1.5, -1.0, np.nan]), 50)),
           torch.from_numpy(rng.choice(np.float32([-0.0, 0.0, 0.5, 0.5, -1.0, np.nan]), 50)))
merged = mesh.merge_collective(planted, sat.BinStrategy.EXACT, torch.distributed.group.WORLD)
for k, t in zip(("count", "steps", "zbuf"), merged):
    arrays[f"planted_{k}"] = t.numpy()
frames = mesh.render_sequence_sharded(cfg, [0.0, 30.0, 60.0], [dist.device()], eight_bit=True,
                                      frames_per_batch=2, orbit="shared",
                                      group=torch.distributed.group.WORLD)
arrays["frames"] = frames
np.savez(f"{out}/rank{pid}.npz", **arrays)
torch.distributed.destroy_process_group()
print("RESULT ok")
'''.replace("**CFG", ", ".join(f"{k}={v!r}" for k, v in CFG.items()))

_CLI_WORKER = r'''
import sys
from strange_attractor_tpu_torch import cli

pid, port, out = sys.argv[1], sys.argv[2], sys.argv[3]
rc = cli.main(["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
               "--process-id", pid, "-o", f"{out}/frame", *sys.argv[4:]])
print("RESULT", rc)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(src: str, out: Path, extra=(), timeout: int = 300):
    """Two ranks of ``src``, each with a timeout; the pair comes up again
    on a fresh port if it lost the port to another process."""
    for _ in range(3):
        port = str(_free_port())
        procs = [subprocess.Popen([sys.executable, "-c", src, str(i), port, str(out), *extra],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                  cwd=REPO)
                 for i in range(2)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                    q.communicate()
                pytest.fail("a distributed worker timed out")
        if any(p.returncode and "Address already in use" in o for p, o in zip(procs, outs)):
            continue
        for i, (p, o) in enumerate(zip(procs, outs)):
            assert p.returncode == 0 and "RESULT" in o, f"rank {i}:\n{o[-3000:]}"
        return outs
    pytest.fail("the coordinator's port was taken three times")


def _states_equal(arrays, prefix, state):
    from strange_attractor_tpu_torch.runtime import state_to_numpy

    for k, v in state_to_numpy(state).items():
        np.testing.assert_array_equal(arrays[f"{prefix}_{k}"].view(np.uint32),
                                      v.view(np.uint32), err_msg=f"{prefix} {k}")


def test_two_ranks_equal_render_sharded_over_two_shards(tmp_path):
    _run_workers(_WORKER, tmp_path)
    ranks = [dict(np.load(tmp_path / f"rank{i}.npz")) for i in range(2)]
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k].view(np.uint8), ranks[1][k].view(np.uint8),
                                      err_msg=k)
    got = ranks[0]
    cfg = sat.presets.poisson_saturne(**CFG)
    two = [CPU, CPU]
    _states_equal(got, "kernel", mesh.render_sharded(cfg, two))
    _states_equal(got, "exact", mesh.render_sharded(
        cfg.replace(bin_strategy=sat.BinStrategy.EXACT_KERNEL), two))
    long = cfg.replace(iterations=64 * 2 * 70, lanes=64, chunk_steps=2)
    _states_equal(got, "progress", mesh.render_sharded(long, two))
    assert got["progress"].tolist() == [64, 70]
    _states_equal(got, "resumed", mesh.render_sharded(cfg, two,
                                                      state=mesh.render_sharded(cfg, two)))
    np.testing.assert_array_equal(got["frames"], mesh.render_sequence_sharded(
        cfg, [0.0, 30.0, 60.0], two, frame_axis=1, eight_bit=True, frames_per_batch=2,
        orbit="shared"))
    # the group form of the merge equals the list form over the ranks' planes
    shards = []
    for pid in range(2):
        rng = np.random.default_rng(pid)
        shards.append((torch.from_numpy(rng.integers(-2**31, 2**31, 50, dtype=np.int64)
                                        .astype(np.int32)),
                       torch.from_numpy(rng.choice(np.float32([-0.0, 0.0, 1.5, -1.0, np.nan]),
                                                   50)),
                       torch.from_numpy(rng.choice(np.float32([-0.0, 0.0, 0.5, 0.5, -1.0,
                                                               np.nan]), 50))))
    want = mesh.merge_collective(shards, sat.BinStrategy.EXACT)
    for k, t in zip(("count", "steps", "zbuf"), want):
        np.testing.assert_array_equal(got[f"planted_{k}"].view(np.uint32),
                                      t.numpy().view(np.uint32), err_msg=k)


def test_cli_coordinator_writes_on_rank_zero_only(tmp_path, monkeypatch):
    """Both ranks render the collective; rank 0 alone writes frame.png (the
    two-device frame's bytes) and prints 'Wrote image to'."""
    outs = _run_workers(_CLI_WORKER, tmp_path, CLI_ARGS)
    assert ["Wrote image to" in o for o in outs] == [True, False]
    assert [o.count("RESULT 0") for o in outs] == [1, 1]
    monkeypatch.setattr(cli, "render_devices", lambda args: [CPU, CPU])
    alone = tmp_path / "alone"
    alone.mkdir()
    assert cli.main([*CLI_ARGS, "-q", "-o", str(alone / "frame")]) == 0
    assert (tmp_path / "frame.png").read_bytes() == (alone / "frame.png").read_bytes()
    assert len(list(tmp_path.glob("*.png"))) == 1


def test_cli_coordinator_sequence(tmp_path):
    """A per-frame sequence over the ranks: three frames, written once."""
    outs = _run_workers(_CLI_WORKER, tmp_path,
                        [*CLI_ARGS, "-q", "sequence", "-s", "0", "-e", "3", "-d", "1"])
    parser = cli.build_parser()
    args = parser.parse_args([*CLI_ARGS, "-q"])
    cli._validate(args, parser)
    cfg = cli.config_from_args(args)
    for i in range(3):
        state = mesh.render_sharded(cfg.replace(angle=float(np.radians(i))), [CPU, CPU],
                                    frame_generator(cfg, i))
        image = sat.colorize(cfg, state).numpy()
        assert (tmp_path / f"frame{i}.png").read_bytes() == png_bytes(
            convert_format(image, False, True))
    assert sum(o.count("Wrote image to") for o in outs) == 3


def test_process_queries_before_initialize():
    """Without a process group: rank 0 of 1, primary; the rank's device is
    unknown, and a card default raises without CUDA."""
    assert (dist.process_index(), dist.process_count(), dist.is_primary()) == (0, 1, True)
    if "device" not in dist._RANK:
        with pytest.raises(RuntimeError, match="initialize"):
            dist.device()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            dist._rank_device(None, None, 0)
    assert dist._rank_device("cpu", [3], 1) == CPU
