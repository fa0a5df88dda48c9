"""render_launch_ms.exact: milliseconds of host time to seed and enqueue an
EXACT frame's render, the mean of the program's ``render.launch`` spans
(``render.render`` from entry to return, which waits for nothing on the
card): some 480 ctypes launches of kernel A in its EXACT emission and of
the EXACT tile bin (one wrapper launch a chunk, five CUDA kernels each).
None unless the window recorded one a frame and every frame's
``render.chunks`` span names the EXACT_KERNEL strategy (``bin``
``exact-kernel``), so that it reads the EXACT path and nothing else."""

from bench_torch import program_spans as ps


def read(run):
    chunks = ps.named(ps.fetch(run), "render.chunks")
    if not chunks or len(chunks) != run.frames \
            or any(s.attrs.get("bin") != "exact-kernel" for s in chunks):
        return None
    return ps.per_frame_ms(run, "render.launch")
