"""Profiling helpers (port of ``strange_attractor_tpu.utils.profiling``).

A render can be wrapped in :class:`RenderProfile` for phase wall times and
an iterations/s figure, and :func:`trace` records a ``torch.profiler``
trace (host ops and, on a card, its CUDA kernels) as a Chrome trace file.
:func:`sync` waits for a tensor's device, so that a phase's wall time
covers the device work it queued.

The JAX package's ``force_cpu_if_requested`` and
``enable_compilation_cache`` are not carried: they work around the TPU
plugin's start-up and XLA's compile times. Here every entry point takes
an explicit ``device`` (nothing falls back to the CPU), and the CUDA
kernels are compiled once into ``build/torch_kernels/``
(:mod:`ops.cuda_lib`), where a later process loads them.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass
class RenderProfile:
    """Collects phase wall-times and derived rates for one render.

    Usage::

        prof = RenderProfile(iterations=executed)
        with prof.phase("render"):
            state = render(config, device="cuda")
            sync(state.count)
        with prof.phase("colorize"):
            image = to_host(colorize(config, state))
        print(prof.summary())
    """

    iterations: int = 0
    phases: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    @property
    def total_seconds(self) -> float:
        return sum(self.phases.values())

    @property
    def iters_per_sec(self) -> Optional[float]:
        t = self.phases.get("render", self.total_seconds)
        if not self.iterations or t <= 0:
            return None
        return self.iterations / t

    def summary(self) -> str:
        parts = [f"{k}={v:.3f}s" for k, v in self.phases.items()]
        rate = self.iters_per_sec
        if rate is not None:
            parts.append(f"rate={rate:.3e} iters/s/chip")
        return " ".join(parts)


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a ``torch.profiler`` trace of the block: host ops, and the
    CUDA kernels when a card is in use. On exit, normal or not, it writes
    one Chrome trace file, ``<host>_<pid>.<timestamp>.pt.trace.json``, into
    ``log_dir`` (made if missing; open it in Perfetto or chrome://tracing)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                                    str(log_dir))):
        yield


def sync(x) -> None:
    """Wait until the work queued on ``x``'s device is done: a CUDA
    tensor's device is synchronized; a CPU tensor is already computed."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
