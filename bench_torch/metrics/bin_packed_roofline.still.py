"""bin_packed_roofline.still: the PACKED bin's share of its roofline over a
still's launches: the least time the card could take for every launch of
``ops.kernel_binning.bin_chunk_kernel`` in the traced window over the
device time of ``bin_packed_kernel`` there.

A chunk's launch reads its stream once (a 4 B pixel index and a 4 B key a
point) and, for every pixel the chunk touches, reads and writes the count
and key planes once (16 B a pixel): 8 * points + 16 * touched bytes, 42.9
MB for a flagship chunk; no floating-point work, so bound by bytes. The
pixels a chunk touches depend on the data: they are counted exactly, chunk
by chunk, in the frames the check renders with the plain reference, and
their mean a chunk stands for the other frames of the window, which differ
from those only in their seeds.

None without checked frames, unless the wrapper launched once a chunk for
every frame, or when no such kernel ran in the trace.
"""

from bench_torch.roofline import bound_s, share

KERNELS = ("bin_packed_kernel",)


def read(run):
    touched = run.extras.get("distinct_px_per_chunk")
    info, frames = run.info, len(run.rec.items)
    launches = frames * info["nchunks"]
    if not touched or run.counters.get("bin_packed") != launches:
        return None
    points = info["lanes"] * info["chunk_steps"]
    chunk = bound_s(8 * points + 16 * sum(touched) / len(touched))
    return share(run, KERNELS, launches, launches * chunk)
