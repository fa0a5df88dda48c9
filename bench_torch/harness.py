"""The benchmark's harness: it finds a cell's files by name, runs the cell's
driver over a measured window, checks what the window produced against the
plain reference, and prints the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the deployment (the program's CLI flags, and
  the constants the plain reference renders from);
- ``traffic/<traffic>.json``: the mix (its CLI flags and parameters) and
  the name of its driver;
- ``drivers/<driver>.py``: the loop that runs one kind of traffic;
- ``metrics/<metric>.py``: one reader a metric, ``read(run)``.

The harness imports nothing of the program itself except its launch
counters (:data:`COUNTERS`); the drivers call the program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the program's launch counters: (module, function, attribute) by name
COUNTERS = {
    "map_emit": ("strange_attractor_tpu_torch.ops.emit", "map_emit", "launches"),
    "project_emit": ("strange_attractor_tpu_torch.ops.emit", "project_emit", "launches"),
    "bin_packed": ("strange_attractor_tpu_torch.ops.kernel_binning", "bin_chunk_kernel",
                   "launches"),
    "tonemap_stats": ("strange_attractor_tpu_torch.ops.colorize", "_tonemap_stats",
                      "launches"),
    "tonemap": ("strange_attractor_tpu_torch.ops.colorize", "tonemap", "launches"),
}
# the items of a window whose answers the check keeps, drawn from the seed
SAMPLE_TAG = 0x5EED


def program(module: str):
    """A module of the program under test, ``strange_attractor_tpu_torch.<module>``
    (the package's ``render`` attribute is a function, not the module)."""
    return importlib.import_module(f"strange_attractor_tpu_torch.{module}")


class NoCard(RuntimeError):
    """The machine lacks the cards a cell asks for."""


def load_module(path: Path, name: str):
    """A Python file of the benchmark as a module (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its configuration and traffic files."""

    name: str
    chips: int
    config: dict
    traffic: dict
    root: Path

    def driver(self):
        return load_module(self.root / "drivers" / f"{self.traffic['driver']}.py",
                           f"bench_torch_driver_{self.traffic['driver']}")

    def metrics(self, bench: dict, trace: bool) -> list:
        """The metric entries this cell reports: with ``trace`` the
        per-layer ones, else the end-to-end ones, each where its
        ``workloads`` (if given) lists the cell."""
        entries = bench["per_layer"] if trace else bench["end_to_end"]
        return [m for m in entries if self.name in m.get("workloads", [self.name])]


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str, root: Path = HERE) -> Cell:
    """The cell ``name`` with its files, found by the names it gives."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; there are {sorted(cells)}")
    w = cells[name]
    if w["config"] not in {c["name"] for c in bench["configs"]}:
        raise KeyError(f"workload {name!r} names no configuration of BENCHMARK.json")
    config = json.loads((root / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, int(w["chips"]), config, traffic, root)


def item_seed(seed: int, index: int, tag: int = 0) -> int:
    """A 63-bit seed for item ``index`` of a run with ``--seed`` ``seed``."""
    state = np.random.SeedSequence([seed % (1 << 64), index, tag]).generate_state(1, np.uint64)
    return int(state[0]) >> 1


class Sample:
    """A uniform sample of ``k`` of a window's items, drawn from the seed
    as they complete (reservoir sampling): :meth:`offer` returns what to
    let go, the offered payload itself or an evicted one, or None."""

    def __init__(self, k: int, seed: int):
        self.k, self.kept, self.seen = k, {}, 0
        self.rng = np.random.default_rng([seed % (1 << 64), SAMPLE_TAG])

    def offer(self, index: int, payload):
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept[index] = payload
            return None
        slot = int(self.rng.integers(self.seen))
        if slot >= self.k:
            return payload
        evict = sorted(self.kept)[slot]
        out = self.kept.pop(evict)
        self.kept[index] = payload
        return out


@dataclasses.dataclass
class Span:
    name: str
    item: int
    start: float
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Recorder:
    """The window's spans and items on the host's clock; with ``trace``
    each span is also a ``torch.profiler`` range of the same name."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.spans: list = []
        self.items: list = []  # Span("item", index, start, end) per completed item

    @contextlib.contextmanager
    def span(self, name: str, item: int):
        ctx = contextlib.nullcontext()
        if self.trace:
            from torch.profiler import record_function

            ctx = record_function(name)
        start = time.perf_counter()
        with ctx:
            yield
        self.spans.append(Span(name, item, start, time.perf_counter()))

    @contextlib.contextmanager
    def item(self, index: int):
        start = time.perf_counter()
        yield
        self.items.append(Span("item", index, start, time.perf_counter()))

    def seconds(self, name: str) -> float:
        return sum(s.seconds for s in self.spans if s.name == name)


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, the device, the seed, a directory for
    the frames the run writes (removed at exit) and the CLI flags."""

    cell: Cell
    device: object
    seed: int
    workdir: Path

    def argv(self) -> list:
        return [*self.cell.config["cli"], *self.cell.traffic["cli_options"],
                "--device", str(self.device), "--single-device",
                *self.cell.traffic.get("cli_subcommand", [])]

    def parse_args(self):
        """The program's CLI arguments of this cell, parsed and validated by
        the program's own parser."""
        cli = program("cli")
        parser = cli.build_parser()
        args = parser.parse_args(self.argv())
        cli._validate(args, parser)
        return args


def output_format(args) -> str:
    """The file format the program's CLI writes for ``args`` (``cli.main``)."""
    return "pam" if args.pam else "bmp" if args.bmp else "png"


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    rec: Recorder
    info: dict  # the driver's description of the work: schedule, shapes, frames per item
    counters: dict  # launches of each wrapper in the window
    trace: object  # a trace.Trace of the window, or None
    extras: dict  # what the check learned: pixels each chunk of a checked frame touched

    @property
    def frames(self) -> int:
        return len(self.rec.items) * self.info["frames_per_item"]


def read_counters() -> dict:
    out = {}
    for name, (module, fn, attr) in COUNTERS.items():
        try:
            out[name] = getattr(getattr(importlib.import_module(module), fn), attr)
        except (ImportError, AttributeError):
            out[name] = None
    return out


def counter_delta(before: dict, after: dict) -> dict:
    return {k: (after[k] - before[k]) if None not in (after[k], before[k]) else None
            for k in before}


def require_cards(chips: int):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoCard(f"the cell needs {chips} CUDA card(s); this machine has {have}")
    return torch.device("cuda:0")


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def host_counters() -> dict:
    """Seconds of the machine's CPUs by state (``/proc/stat``, stolen by the
    host and waiting on I/O among them) and this process's own CPU seconds,
    context switches and bytes sent to storage; what Linux lacks is left out."""
    import resource

    out = {}
    try:
        fields = Path("/proc/stat").read_text().split("\n", 1)[0].split()[1:]
        ticks = os.sysconf("SC_CLK_TCK")
        for name, value in zip(("user", "nice", "system", "idle", "iowait", "irq", "softirq",
                                "steal"), fields):
            out[f"cpu_{name}_s"] = int(value) / ticks
    except (OSError, ValueError):
        pass
    use = resource.getrusage(resource.RUSAGE_SELF)
    out.update(proc_cpu_s=use.ru_utime + use.ru_stime, proc_vol_switches=use.ru_nvcsw,
               proc_invol_switches=use.ru_nivcsw)
    try:
        for line in Path("/proc/self/io").read_text().splitlines():
            if line.startswith("write_bytes:"):
                out["proc_storage_write_bytes"] = int(line.split()[1])
    except OSError:
        pass
    return out


def host_report(rec: Recorder, before: dict, after: dict) -> str:
    """The window's spans (count, mean, median, 95th percentile and most, in
    ms) and the host's counters over it, for standard error."""
    lines = []
    for name in dict.fromkeys(s.name for s in rec.spans):
        ms = sorted(1e3 * s.seconds for s in rec.spans if s.name == name)
        lines.append(f"span {name}: n {len(ms)} mean {sum(ms) / len(ms):.2f} "
                     f"median {ms[len(ms) // 2]:.2f} p95 {ms[-(-95 * len(ms) // 100) - 1]:.2f} "
                     f"max {ms[-1]:.2f} ms")
    deltas = {k: after[k] - before[k] for k in after if k in before}
    lines.append("host over the window: " + " ".join(
        f"{k} {v:.6g}" for k, v in deltas.items()))
    return "\n".join(lines)


def cache_environment(root: Path) -> None:
    """Point every build and kernel cache a run could use into the
    checkout, at fixed paths: the program builds its kernel library and
    its PNG encoder into ``build/torch_kernels/`` there by itself."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton_cache")


def measure(cell: Cell, *, seed: int, seconds: float, trace: bool, device, t0: float,
            bench: dict) -> dict:
    """One run of ``cell``: set-up, the window, the check; the result as a
    dict in the order the line prints it."""
    import torch

    from . import trace as tracing

    cuda = torch.device(device).type == "cuda"
    workdir = Path(tempfile.mkdtemp(prefix="bench_torch_"))
    try:
        ctx = Context(cell, torch.device(device), seed, workdir)
        driver = cell.driver()
        session = driver.setup(ctx)
        rec = Recorder(trace)
        before = read_counters()
        host_before = host_counters()
        setup_s = time.perf_counter() - t0
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=activities)
            prof.__enter__()
        try:
            driver.window(session, seconds, rec)
        finally:
            if prof is not None:
                if cuda:
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
        counters = counter_delta(before, read_counters())
        print(host_report(rec, host_before, host_counters()), file=sys.stderr)
        print("item walls (s): " + " ".join(f"{it.seconds:.4f}" for it in rec.items),
              file=sys.stderr)
        print(f"bytes written: {session.info.get('bytes_written', 0)}", file=sys.stderr)
        peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
        reduced = tracing.reduce_profile(prof, driver.SPANS) if prof is not None else None
        del prof
        t_check = time.perf_counter()
        checks, extras, failed = driver.check(session)
        print(f"the check against the plain reference took {time.perf_counter() - t_check:.1f} s",
              file=sys.stderr)
        run = Run(cell, setup_s, rec, session.info, counters, reduced, extras)
        metrics = {}
        for entry in cell.metrics(bench, trace):
            module = load_module(cell.root / "metrics" / f"{entry['name']}.py",
                                 f"bench_torch_metric_{entry['name'].replace('.', '_')}")
            value = module.read(run)
            if value is not None:
                metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
        correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
               "count": cell.chips, "memory_peak_bytes": int(peak)}
        result = {"correct": correct, "attempted": run.frames, "failed": failed,
                  "metrics": metrics, "device": dev}
        if reduced is not None:
            dev["busy_s"] = reduced.busy_s
            dev["window_s"] = reduced.window_s
            result["breakdown"] = {"device_ops": reduced.top_ops(),
                                   "idle_gaps": reduced.idle_gaps()}
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None, *, t0: float, root: Path = ROOT) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Run one benchmark cell once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench = load_bench(root)
    cell = find_cell(bench, args.workload, root / "bench_torch")
    try:
        device = require_cards(cell.chips)
    except NoCard as e:
        print(f"bench_torch: {e}", file=sys.stderr)
        return 3
    cache_environment(root)
    stdout = sys.stdout
    # the program's own messages go to standard error: the result line is
    # the last line of standard output
    with contextlib.redirect_stdout(sys.stderr):
        result = measure(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                         device=device, t0=t0, bench=bench)
        card = power_limit()
    print(f"card (name, power limit): {card}", file=stdout)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=stdout, flush=True)
    return 0
