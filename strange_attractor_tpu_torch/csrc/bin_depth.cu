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
// a new +0.0. Out-of-bounds points (flat == npix) are skipped.
//
// Design: one thread per point, an order-correct float max in place on the
// f32 plane by the sign split. For a z with the sign bit clear, a signed
// int atomicMax on the bits is the max in mono order (any standing value
// with the sign bit set is a negative int and loses); for a z with the sign
// bit set, an unsigned atomicMin on the bits is (any standing value with
// the sign bit clear is a smaller unsigned and stays). Each atomic is
// max_mono(standing, z), which commutes, so the plane is deterministic and
// bit-identical to the plain twin (ops/binning.py bin_chunk_depth) whatever
// the order; NaN bit patterns order as mono_u32 orders them too.
//
// What bounds it on the H100: one 4-byte atomic per in-bounds point into an
// 8.3 MB plane that lives in the 50 MB L2. A plain read first skips the
// atomic when the standing value already wins: the plane only grows in mono
// order, so a stale read can only be smaller than the truth. That cuts the
// atomics of a hot pixel (the pixel-0 flood of escaping orbits, whose z is
// -inf) to the few that raise it.

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ unsigned mono_u32(unsigned u) {
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

__global__ void bin_depth_kernel(float* __restrict__ zbuf, const int* __restrict__ flat,
                                 const unsigned* __restrict__ z, long long m, int npix) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride) {
    int f = flat[i];
    if ((unsigned)f >= (unsigned)npix) continue;  // out of bounds (flat == npix)
    unsigned b = z[i];
    if ((b & 0x7FFFFFFFu) == 0u) b = 0u;  // -0.0 -> +0.0
    unsigned* cell = reinterpret_cast<unsigned*>(zbuf) + f;
    if (mono_u32(*(volatile unsigned*)cell) >= mono_u32(b)) continue;
    if ((int)b >= 0) {
      atomicMax(reinterpret_cast<int*>(cell), (int)b);
    } else {
      atomicMin(cell, b);
    }
  }
}

extern "C" int sat_bin_depth(float* zbuf, const int* flat, const unsigned* z, long long m,
                             int npix, void* stream) {
  const int threads = 256;
  long long want = (m + threads - 1) / threads;
  int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  bin_depth_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(zbuf, flat, z, m, npix);
  return (int)cudaGetLastError();
}
