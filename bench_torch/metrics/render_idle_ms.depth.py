"""render_idle_ms.depth: milliseconds a depth frame in which the card is
idle while the host is inside ``render.launch``, read as
``render_idle_ms.still`` reads a gas still's: time the card waits on the
host's seeding and launches, which set the pace of a depth frame. None
without a device trace, or unless the window recorded one span a frame."""

from bench_torch.harness import HERE, load_module

_STILL = load_module(HERE / "metrics" / "render_idle_ms.still.py",
                     "bench_torch_metric_render_idle_ms_still_for_depth")


def read(run):
    return _STILL.read(run)
