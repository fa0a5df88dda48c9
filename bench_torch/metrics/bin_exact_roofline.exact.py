"""bin_exact_roofline.exact: the EXACT tile bin's share of its roofline over
an EXACT still's launches: the least time the card could take for every
launch of ``ops.kernel_binning.bin_chunk_kernel_exact`` in the traced window
over the device time of the tile bin's five CUDA kernels there
(``csrc/bin_tile.cuh``'s namespace ``bin_tile``, built by
``csrc/bin_exact.cu``: ``tile_hist_kernel``, ``tile_column_kernel``,
``tile_scan_kernel``, ``tile_scatter_kernel`` and ``tile_merge_kernel``,
summed by name).

A chunk's launch reads its stream once (a 4 B pixel index, a 4 B float32
depth and a 4 B float32 colour value a point) and, for every pixel the
chunk touches, reads and writes the three 4 B planes (count, ``steps``,
``zbuf``) once: 12 * points + 24 * touched bytes, 64.3 MB for a flagship
chunk (4,194,304 points, ~584,000 pixels). The partition's records are the
kernels' own traffic, not the work's, and are left out of the bound. No
floating-point work (the z-test is integer compares of the depth's order),
so bound by bytes (19.2 us). The pixels a chunk touches depend on the data:
they are counted exactly, chunk by chunk, in the frames the check renders
with the plain EXACT reference, and their mean a chunk stands for the other
frames of the window, which differ from those only in their seeds.

The launches are ``drivers/exact_still.py``'s count over the window
(``info["bin_exact_launches"]``). None without checked frames, unless the
wrapper launched once a chunk for every frame, or when no such kernel ran in
the trace.
"""

from bench_torch.roofline import bound_s, share

KERNELS = tuple(f"bin_tile::tile_{k}_kernel" for k in ("hist", "column", "scan", "scatter",
                                                     "merge"))


def read(run):
    touched = run.extras.get("distinct_px_per_chunk")
    info, frames = run.info, len(run.rec.items)
    launches = frames * info["nchunks"]
    if not touched or info.get("bin_exact_launches") != launches:
        return None
    points = info["lanes"] * info["chunk_steps"]
    chunk = bound_s(12 * points + 24 * sum(touched) / len(touched))
    return share(run, KERNELS, launches, launches * chunk)
