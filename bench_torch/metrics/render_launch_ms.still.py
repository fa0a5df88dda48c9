"""render_launch_ms.still: milliseconds of host time to seed and enqueue a
frame's render, the mean of the program's ``render.launch`` spans
(``render.render`` from entry to return, which waits for nothing on the
card). None unless the window recorded one a frame."""

from bench_torch.program_spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "render.launch")
