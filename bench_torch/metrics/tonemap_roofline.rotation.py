"""tonemap_roofline.rotation: kernel T's share of its roofline over a
rotation's frames: the least time the card could take for the tone map and
conversion of every frame in the traced window over the device time of
kernel T's CUDA kernels (the reduction, its finalize and the pass; both
wrapper launches of a frame, ``ops.colorize._tonemap_stats`` and
``ops.colorize.tonemap``).

A frame reads its count and key planes once (8 B a pixel) and writes its
image once (3 B a pixel in 8-bit RGB): 22.8 MB at 1920x1080, bound by
bytes. Operations a pixel: 50 float32 (unpacking 3, the palette's lerp and
square roots 20, the brightness 16, the saturating casts and the 8-bit
conversion 11) and 20 float64 (one log1p), at their own peaks.

None unless both wrappers launched once a frame, or when no such kernel ran
in the trace.
"""

from bench_torch.roofline import bound_s, share

KERNELS = ("tonemap_stats_kernel", "tonemap_finalize_kernel", "tonemap_kernel")
OPS_F32, OPS_F64 = 50, 20


def read(run):
    info, frames = run.info, run.frames
    if run.counters.get("tonemap") != frames or run.counters.get("tonemap_stats") != frames:
        return None
    npix = info["width"] * info["height"]
    nbytes = npix * (8 + info["channels"] * info["sample_bytes"])
    frame = bound_s(nbytes, OPS_F32 * npix, OPS_F64 * npix)
    return share(run, KERNELS, frames, frames * frame)
