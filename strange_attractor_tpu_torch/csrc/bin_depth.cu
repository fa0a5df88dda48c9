// DEPTH_KERNEL-strategy bin of one point chunk.
//
// Replaces: the Pallas sort-bin pipeline behind bin_chunk_kernel_depth
// (strange_attractor_tpu/ops/kernel_binning.py:735-787): the pixel-0 flood
// eviction, the section sort (_sections, :415-442), the row apply
// (_run_apply / _make_apply_kernel, :445-470 / :170-332) with _flush_depth
// (:403) and the mono-u32 maximum merge. It computes what that pipeline
// computes: per pixel, zbuf = inv_mono(max(mono(zbuf), mono(canon(z)))),
// where canon maps -0.0 to +0.0 and mono is the order-preserving f32 -> u32
// map. The standing plane is not canonicalized, so a standing -0.0 loses to
// a new +0.0. Out-of-bounds points (flat outside [0, npix), flat == npix
// from kernel A) are skipped.
//
// The update is an order-correct float max in place on the f32 plane by the
// sign split: for a z with the sign bit clear, a signed int atomicMax on the
// bits is the max in mono order (a standing value with the sign bit set is
// a negative int and loses); for a z with the sign bit set, an unsigned
// atomicMin on the bits is (a standing value with the sign bit clear is a
// smaller unsigned and stays). Each atomic is max_mono(standing, z), which
// commutes, so the plane is deterministic and bit-identical to the plain
// twin (ops/binning.py bin_chunk_depth) whatever the order; NaN bit
// patterns order as mono_u32 orders them too.
//
// What bounds it on the H100: the L2's rate of single-sector requests. A
// point moves 8 bytes of stream from HBM and, where it lands on the canvas,
// reads one 4-byte cell of the 8.3 MB plane, which sits in the 50 MB L2: one
// 32-byte sector request a point, ~4.2M a 4M-point flagship chunk. Behind
// the read-before-atomic skip (the plane only grows in mono order, so a
// read, however stale, is never above the truth and only skips atomics that
// could not win) few points issue an atomic once a render has run a few
// chunks. More points in flight a thread, as 16-byte vectors or as 4-byte
// loads, did not read the plane faster (PERF.md, section 6), so the design
// keeps one point a thread a turn and cuts the requests a point makes:
//
//   - the plane is read through L1 (__ldca), which answers the points that
//     crowd onto the attractor's bright pixels without an L2 request; a
//     stale L1 line only lets an atomic through that then loses;
//   - the pixel-0 flood (escaped orbits bin at pixel (0, 0) through the
//     reference's NaN quirk: 38% of a solar-sail chunk) makes no request
//     point by point: each thread keeps the max key of its pixel-0 points in
//     a register, __reduce_max_sync takes the warp's, shared memory the
//     block's, and the block makes one plane read and at most one atomic.
//     Any key reduces this way (NaN bit patterns of both signs included),
//     and pixel (0, 0)'s real points win by the same max;
//   - the stream is read with the streaming hint (__ldcs: evict first, so it
//     does not push the plane out of L2) by a grid of the blocks resident at
//     once, in 4-byte loads, so a view at any offset is read as it is.

#include <cuda_runtime.h>
#include <stdint.h>

#include "emit_common.cuh"

constexpr int THREADS = 256;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

// mono_u32 of raw bits (ops/binning.py _mono_u32)
__device__ __forceinline__ unsigned mono_bits(unsigned u) {
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

// the key a stream point brings: mono of its z with -0.0 made +0.0
__device__ __forceinline__ unsigned depth_key(unsigned b) {
  return mono_bits((b & 0x7FFFFFFFu) ? b : 0u);
}

// max_mono(*cell, the float whose mono is k), by the sign split
__device__ __forceinline__ void raise_to(unsigned* cell, unsigned k) {
  if (k >> 31) {
    atomicMax(reinterpret_cast<int*>(cell), (int)(k & 0x7FFFFFFFu));
  } else {
    atomicMin(cell, ~k);
  }
}

__global__ void __launch_bounds__(THREADS) bin_depth_kernel(
    unsigned* zbuf, const int* __restrict__ flat, const unsigned* __restrict__ z, long long m,
    unsigned npix) {
  __shared__ unsigned block_max0;
  if (threadIdx.x == 0) block_max0 = 0u;
  __syncthreads();
  unsigned max0 = 0u;  // the largest key at pixel 0 this thread met (0: none wins)
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += nthreads) {
    const int f = __ldcs(flat + i);
    const unsigned key = depth_key(__ldcs(z + i));
    if (f == 0) {
      if (key > max0) max0 = key;
    } else if ((unsigned)f < npix && mono_bits(__ldca(zbuf + f)) < key) {
      raise_to(zbuf + f, key);
    }
  }
  max0 = __reduce_max_sync(FULL_MASK, max0);
  if ((threadIdx.x & 31) == 0 && max0) atomicMax(&block_max0, max0);
  __syncthreads();
  if (threadIdx.x == 0 && block_max0 && mono_bits(__ldca(zbuf)) < block_max0) {
    raise_to(zbuf, block_max0);
  }
}

extern "C" int sat_bin_depth(float* zbuf, const int* flat, const unsigned* z, long long m,
                             int npix, void* stream) {
  if (m <= 0 || npix <= 0) return (int)cudaSuccess;  // nothing can land on the canvas
  static int resident = 0;  // blocks an SM holds at once
  if (!resident) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, bin_depth_kernel, THREADS, 0);
    if (resident <= 0) resident = 1;
  }
  const long long want = (m + THREADS - 1) / THREADS;
  const long long most = (long long)resident * sm_count();
  const int blocks = (int)(want < most ? want : most);
  bin_depth_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<unsigned*>(zbuf), flat, z, m, (unsigned)npix);
  return (int)cudaGetLastError();
}
