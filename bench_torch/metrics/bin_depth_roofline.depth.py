"""bin_depth_roofline.depth: the DEPTH bin's share of its roofline over a
depth still's launches: the least time the card could take for every launch
of ``ops.kernel_binning.bin_chunk_kernel_depth`` in the traced window over
the device time of ``bin_depth_kernel`` there.

A chunk's launch (``csrc/bin_depth.cu``) reads its stream once (a 4 B pixel
index and a 4 B float32 depth a point) and, for every pixel the chunk
touches, reads the plane's 4 B cell and writes it once: 8 * points + 8 *
touched bytes, 38.2 MB for a flagship chunk (4,194,304 points, ~584,000
pixels); no floating-point work, so bound by bytes (11.4 us). The pixels a
chunk touches depend on the data: they are counted exactly, chunk by chunk,
in the frames the check renders with the plain depth reference, and their
mean a chunk stands for the other frames of the window, which differ from
those only in their seeds.

The launches are the driver's count over the window
(``info["bin_depth_launches"]``). None without checked frames, unless the
wrapper launched once a chunk for every frame, or when no such kernel ran in
the trace.
"""

from bench_torch.roofline import bound_s, share

KERNELS = ("bin_depth_kernel",)


def read(run):
    touched = run.extras.get("distinct_px_per_chunk")
    info, frames = run.info, len(run.rec.items)
    launches = frames * info["nchunks"]
    if not touched or info.get("bin_depth_launches") != launches:
        return None
    points = info["lanes"] * info["chunk_steps"]
    chunk = bound_s(8 * points + 8 * sum(touched) / len(touched))
    return share(run, KERNELS, launches, launches * chunk)
