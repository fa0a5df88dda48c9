"""map_emit_roofline.still: kernel A's share of its roofline over a still's
launches: the least time the card could take for every launch of
``ops.emit.map_emit`` in the traced window (one warm-up and the chunks of
each frame) over the device time of kernel A's CUDA kernels there.

Bytes and operations of a launch of ``lanes`` x ``steps``, each input read
once and each output written once:

- an emitting chunk reads and writes the lane state once (3 float32 a lane
  each way: 24 B a lane) and writes the PACKED stream, a 4 B pixel index
  and a 4 B key a point: 8 * lanes * steps + 24 * lanes bytes; 34.3 MB for
  the flagship's 32768 x 128 chunk. Operations: 124 float32 a point (the
  Sprott map 60 -- 6 monomials, 3 x (9 products + 9 sums) --, the view's
  rotation 15, the projection 13, the colour value and its square root 24,
  the bounds tests, the NaN tests and the key 12), 0.52 GFLOP a chunk;
  bound by bytes (10.3 us);
- the warm-up launch (``config.warmup`` steps, no emission) moves the
  lane state only (24 B a lane) and runs the map: 60 operations a lane a
  step; bound by operations (29.3 us at 32768 lanes x 1000 steps).

None unless the wrapper launched once a warm-up and once a chunk for every
frame, or when no such kernel ran in the trace.
"""

from bench_torch.roofline import bound_s, share

KERNELS = ("map_kernel", "map_emit_ilp_kernel", "map_emit_kernel")
OPS_EMIT, OPS_MAP = 124, 60


def read(run):
    info, frames = run.info, len(run.rec.items)
    lanes, steps = info["lanes"], info["chunk_steps"]
    launches = frames * (1 + info["nchunks"])
    if run.counters.get("map_emit") != launches:
        return None
    chunk = bound_s(8 * lanes * steps + 24 * lanes, OPS_EMIT * lanes * steps)
    warm = bound_s(24 * lanes, OPS_MAP * lanes * info["warmup"])
    return share(run, KERNELS, launches, frames * (warm + info["nchunks"] * chunk))
