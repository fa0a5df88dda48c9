"""project_emit_roofline.rotation: kernel P's share of its roofline over a
rotation's launches: the least time the card could take for every launch
of ``ops.emit.project_emit`` in the traced window (one a frame and a chunk
of its batch's orbit) over the device time of ``project_emit_kernel``.

A launch reads the shared stream once (xc, zc, fj and the colour value,
4 float32 a point) and writes one frame's PACKED stream (a 4 B pixel index
and a 4 B key a point): 24 B a point, 80.0 MB for a 2048 x 1628 chunk.
Operations: 18 float32 a point (the camera angle's rotation and
projection 8, the bounds and NaN tests, the key), so bound by bytes.

None unless the wrapper launched once a frame and a chunk, or when no such
kernel ran in the trace.
"""

from bench_torch.roofline import bound_s, share

KERNELS = ("project_emit_kernel",)
OPS = 18


def read(run):
    info = run.info
    points = info["lanes"] * info["chunk_steps"]
    launches = run.frames * info["nchunks"]
    if run.counters.get("project_emit") != launches:
        return None
    return share(run, KERNELS, launches, launches * bound_s(24 * points, OPS * points))
