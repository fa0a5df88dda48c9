"""png_filter_ms.still: milliseconds of the adaptive PNG scanline filter a
frame, the mean of the program's ``png.filter`` spans
(``utils.export._filter_scanlines``: the native filter on the host's
threads, or numpy). None unless the window recorded one a frame."""

from bench_torch.program_spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "png.filter")
