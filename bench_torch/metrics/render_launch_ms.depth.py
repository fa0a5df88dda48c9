"""render_launch_ms.depth: milliseconds of host time to seed and enqueue a
depth frame's render, the mean of the program's ``render.launch`` spans
(``render.render`` from entry to return, which waits for nothing on the
card): some 480 ctypes launches of kernel A in its DEPTH emission and of the
DEPTH bin. None unless the window recorded one a frame and every frame's
``render.chunks`` span names the DEPTH_KERNEL strategy (``bin``
``depth-kernel``), so that it reads the depth path and nothing else."""

from bench_torch import program_spans as ps


def read(run):
    chunks = ps.named(ps.fetch(run), "render.chunks")
    if not chunks or len(chunks) != run.frames \
            or any(s.attrs.get("bin") != "depth-kernel" for s in chunks):
        return None
    return ps.per_frame_ms(run, "render.launch")
