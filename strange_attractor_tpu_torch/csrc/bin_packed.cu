// KERNEL-strategy bin of one point chunk (kernel B).
//
// Replaces: the Pallas sort-bin pipeline behind bin_chunk_kernel
// (strange_attractor_tpu/ops/kernel_binning.py:475-532): the pixel-0 flood
// eviction, the section sort (_sections, :415-442), the row apply
// (_run_apply / _make_apply_kernel, :445-470 / :170-332) with its
// _flush_packed (:341), and the delta merge. It computes what that pipeline
// computes, not how: per pixel, count += hits (mod 2^32) and
// packed = max(packed, update), in place on the planes. The sort and the
// one-hot int8 MXU dot existed to dodge the TPU's scalar-scatter floor;
// Hopper has native atomics. Add and max commute, so the planes are
// deterministic and bit-identical to the plain scatter twin
// (ops/binning.py bin_chunk_packed) whatever the order.
//
// Design. A persistent grid (eight blocks of 256 threads an SM) walks the
// stream in warp strides, every lane of a warp on every iteration, so warp
// votes see the whole warp even on the ragged tail:
//   - the pixel-0 flood (escaped orbits bin at pixel (0, 0) through the
//     reference's NaN quirk: 38% of a solar-sail chunk) never reaches the
//     L2 atomics point by point. A warp counts its pixel-0 hits with
//     __ballot_sync/__popc and takes their packed max with
//     __reduce_max_sync; the block sums the warps' totals in shared memory
//     and issues one atomicAdd and one atomicMax at the end. Pixel (0, 0)
//     is a real pixel too: its non-escaped points carry packed values
//     above 0 and win through the same max. No gate: the result is the same
//     whatever the pixel-0 count. This is the GPU form of the TPU path's
//     flood eviction.
//   - every other in-bounds point adds 1 to its count (a fire-and-forget
//     L2 reduction) and reads its packed cell before the atomicMax,
//     skipping it when the standing value already wins. The read goes
//     through the SM's L1, which the atomics never refresh, so it may be
//     stale; the plane only grows in u32 order during and between launches,
//     so a stale read is never larger than the truth and only costs a
//     needless atomic. Points that pack to 0 (z <= -1, including NaN z)
//     skip it too.
// Tried on the H100 and dropped (PERF.md): 16-byte loads of the stream (no
// gain: the loads are not the limit) and merging a warp's points that
// share a pixel with __match_any_sync (slower: such duplicates are rare
// within a warp). An L2 read instead of the L1 read was slower.
//
// What bounds it on the H100: the L2's atomic and load rate, ~2 L2
// requests a point (the count's reduction, the packed read or its
// atomicMax) into two 8.3 MB planes that sit in the 50 MB L2; poisson-
// saturne's points crowd onto ~0.58M of the 2.07M pixels a chunk, so many
// land on lines other SMs are updating. The roofline bound (the stream
// read once, each touched cell of both planes read and written once) is
// ~13 us a 4M-point chunk; the kernel takes ~0.10 ms on distinct chunks
// onto a standing state (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W).

#include <cuda_runtime.h>
#include <stdint.h>

#include "emit_common.cuh"

#define FULL_MASK 0xFFFFFFFFu

__global__ void __launch_bounds__(256) bin_packed_kernel(unsigned* __restrict__ count,
                                                         unsigned* __restrict__ packed,
                                                         const int* __restrict__ flat,
                                                         const unsigned* __restrict__ update,
                                                         long long m, int npix) {
  __shared__ unsigned block_n0, block_max0;
  if (threadIdx.x == 0) block_n0 = block_max0 = 0u;
  __syncthreads();
  unsigned n0 = 0u, max0 = 0u;  // this warp's pixel-0 hits and their max (warp-uniform)
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // base is the warp's first point: uniform across the warp, so every lane
  // runs every iteration and votes
  for (long long base = (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < m;
       base += stride) {
    long long i = base + lane;
    int f = i < m ? __ldcs(flat + i) : npix;
    unsigned v = i < m ? __ldcs(update + i) : 0u;
    bool zero = f == 0;
    unsigned hits = __ballot_sync(FULL_MASK, zero);
    if (hits) {  // warp-uniform
      n0 += __popc(hits);
      max0 = max(max0, __reduce_max_sync(FULL_MASK, zero ? v : 0u));
    }
    if (zero || (unsigned)f >= (unsigned)npix) continue;  // flat == npix: out of bounds
    atomicAdd(&count[f], 1u);
    if (v != 0u && __ldca(&packed[f]) < v) atomicMax(&packed[f], v);
  }
  if (lane == 0 && n0) {
    atomicAdd(&block_n0, n0);
    atomicMax(&block_max0, max0);
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_n0) {
    atomicAdd(&count[0], block_n0);
    if (block_max0) atomicMax(&packed[0], block_max0);
  }
}

extern "C" int sat_bin_packed(unsigned* count, unsigned* packed, const int* flat,
                              const unsigned* update, long long m, int npix, void* stream) {
  if (m <= 0 || npix <= 0) return (int)cudaSuccess;  // nothing can land on the canvas
  const int threads = 256;
  // a full SM holds 8 such blocks; more blocks would only add pixel-0 atomics
  long long want = (m + threads - 1) / threads, most = 8LL * sm_count();
  int blocks = (int)(want < most ? want : most);
  bin_packed_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(count, packed, flat, update,
                                                                  m, npix);
  return (int)cudaGetLastError();
}
