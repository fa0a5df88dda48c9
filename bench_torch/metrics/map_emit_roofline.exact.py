"""map_emit_roofline.exact: kernel A's share of its roofline over an EXACT
still's launches, in its EXACT emission: the least time the card could take
for every launch of ``ops.emit.map_emit`` in the traced window (one warm-up
and the chunks of each frame) over the device time of kernel A's CUDA
kernels there.

Bytes and operations of a launch of ``lanes`` x ``steps``, each input read
once and each output written once (``csrc/map_emit.cuh``, ``emit_point``
with ``MODE_EXACT``, and ``emit_common.cuh``):

- an emitting chunk reads and writes the lane state once (3 float32 a lane
  each way: 24 B a lane) and writes the EXACT stream, a 4 B pixel index, a
  4 B float32 depth and a 4 B float32 colour value a point: 12 * lanes *
  steps + 24 * lanes bytes; 51.1 MB for the flagship's 32768 x 128 chunk.
  Operations: 121 float32 a point (the Sprott map 60 -- 6 monomials, 3 x (9
  products + 9 sums) --, the view's rotation 15, the projection 13, the
  colour value and its square root 24, the four bounds tests, the NaN tests
  of the depth and both coordinates 3, the two casts to the pixel); the
  value is stored as it is, with no key. 0.51 GFLOP a chunk; bound by bytes
  (15.3 us);
- the warm-up launch (``config.warmup`` steps, no emission) moves the lane
  state only (24 B a lane) and runs the map: 60 operations a lane a step;
  bound by operations (29.3 us at 32768 lanes x 1000 steps).

The kernels are the Gas render's (``map_kernel``, ``map_emit_ilp_kernel``,
``map_emit_kernel``); the cell's ``info`` says the bin is EXACT_KERNEL's.
None unless it does, unless the wrapper launched once a warm-up and once a
chunk for every frame, or when no such kernel ran in the trace.
"""

from bench_torch.roofline import bound_s, share

KERNELS = ("map_kernel", "map_emit_ilp_kernel", "map_emit_kernel")
OPS_EMIT, OPS_MAP = 121, 60


def read(run):
    info, frames = run.info, len(run.rec.items)
    lanes, steps = info["lanes"], info["chunk_steps"]
    launches = frames * (1 + info["nchunks"])
    if info.get("bin") != "exact-kernel" or run.counters.get("map_emit") != launches:
        return None
    chunk = bound_s(12 * lanes * steps + 24 * lanes, OPS_EMIT * lanes * steps)
    warm = bound_s(24 * lanes, OPS_MAP * lanes * info["warmup"])
    return share(run, KERNELS, launches, frames * (warm + info["nchunks"] * chunk))
