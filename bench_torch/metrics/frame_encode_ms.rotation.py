"""frame_encode_ms.rotation: milliseconds to encode and write one frame on an
encoder thread of ``cli._write_frames``, the mean of the program's
``image.write`` spans recorded off the window's thread. None unless the
window recorded one a frame."""

from bench_torch.program_spans import per_frame_ms


def read(run):
    return per_frame_ms(run, "image.write", off_thread=True)
