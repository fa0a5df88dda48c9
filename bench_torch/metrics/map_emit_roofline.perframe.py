"""map_emit_roofline.perframe: kernel A's share of its roofline over a
per-frame rotation's launches: the least time the card could take for every
launch of ``ops.emit.map_emit`` in the traced window over the device time of
kernel A's CUDA kernels there. The per-frame engine
(``render.render_sequence_batched``) renders each frame on its own, one
warm-up and ``nchunks`` chunks of 2048 lanes x 1628 steps at 10^7 a frame:
a grid of 16 blocks on the card's 132 SMs, the gap a frame-parallel kernel
A would close.

Bytes and operations of a launch of ``lanes`` x ``steps`` in the PACKED
emission, each input read once and each output written once (as
``map_emit_roofline.still`` counts them):

- an emitting chunk reads and writes the lane state once (24 B a lane) and
  writes the PACKED stream, a 4 B pixel index and a 4 B key a point: 8 *
  lanes * steps + 24 * lanes bytes; 26.7 MB for a 2048 x 1628 chunk.
  Operations: 124 float32 a point, 0.41 GFLOP a chunk; bound by bytes (7.98
  us);
- the warm-up launch (``config.warmup`` steps, no emission) moves the lane
  state only (24 B a lane) and runs the map: 60 operations a lane a step;
  bound by operations (1.83 us at 2048 lanes x 1000 steps).

The launches are the harness's ``map_emit`` counter. None unless the
wrapper launched once a warm-up and once a chunk for every frame of the
window (a shared orbit launches once a batch, and reads None here), or
when no such kernel ran in the trace.
"""

from bench_torch.roofline import bound_s, share

KERNELS = ("map_kernel", "map_emit_ilp_kernel", "map_emit_kernel")
OPS_EMIT, OPS_MAP = 124, 60


def read(run):
    info, frames = run.info, run.frames
    lanes, steps = info["lanes"], info["chunk_steps"]
    launches = frames * (1 + info["nchunks"])
    if run.counters.get("map_emit") != launches:
        return None
    chunk = bound_s(8 * lanes * steps + 24 * lanes, OPS_EMIT * lanes * steps)
    warm = bound_s(24 * lanes, OPS_MAP * lanes * info["warmup"])
    return share(run, KERNELS, launches, frames * (warm + info["nchunks"] * chunk))
