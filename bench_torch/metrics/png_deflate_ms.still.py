"""png_deflate_ms.still: milliseconds of the PNG's deflate a frame, the mean
of the program's ``png.deflate`` spans (``utils.native.
zlib_compress_parallel`` on up to 16 threads). None unless the window
recorded one a frame."""

from bench_torch.program_spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "png.deflate")
