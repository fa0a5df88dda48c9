"""tonemap_roofline.depth: kernel T's share of its roofline over a depth
still's frames, through its depth branch: the least time the card could take
for the tone map and conversion of every frame in the traced window over
the device time of kernel T's CUDA kernels (the reduction, its finalize and
the pass; both wrapper launches of a frame, ``ops.colorize._tonemap_stats``
and ``ops.colorize.tonemap``).

A frame reads its z-buffer once (4 B a pixel) and writes its image once (3 B
a pixel in 8-bit RGB): 14.5 MB at 1920x1080, bound by bytes (4.3 us).
Operations a pixel (``csrc/tonemap.cu``, the depth branches): 11 float32
(the reduction's sentinel and NaN tests 2; the pass's sentinel test, the
two differences, the quotient and the scale 5, the saturating cast 4), no
float64.

None unless the cell's ``info`` says the render is a depth one and both
wrappers launched once a frame, or when no such kernel ran in the trace.
"""

from bench_torch.roofline import bound_s, share

KERNELS = ("tonemap_stats_kernel", "tonemap_finalize_kernel", "tonemap_kernel")
OPS_F32 = 11


def read(run):
    info, frames = run.info, run.frames
    if info.get("render") != "depth" or run.counters.get("tonemap") != frames \
            or run.counters.get("tonemap_stats") != frames:
        return None
    npix = info["width"] * info["height"]
    frame = bound_s(npix * (4 + info["channels"] * info["sample_bytes"]), OPS_F32 * npix)
    return share(run, KERNELS, frames, frames * frame)
