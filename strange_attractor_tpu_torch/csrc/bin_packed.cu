// KERNEL-strategy bin of one point chunk (kernel B).
//
// Replaces: the Pallas sort-bin pipeline behind bin_chunk_kernel
// (strange_attractor_tpu/ops/kernel_binning.py:475-532): the section sort
// (_sections, :415-442), the row apply (_run_apply / _make_apply_kernel,
// :445-470 / :170-332) with its _flush_packed (:341), and the delta merge.
// It computes what that pipeline computes, not how: per pixel,
// count += hits and packed = max(packed, update), in place on the planes.
// The sort and the one-hot int8 MXU dot existed to dodge the TPU's
// scalar-scatter floor; Hopper has native atomics.
//
// What bounds it on the H100: atomics. A 4M-point chunk issues up to two
// 4-byte atomics per point into a 1920x1080 canvas (two 8.3 MB planes),
// which sits in the 50 MB L2, so the L2 atomic units rather than HBM bytes
// set the rate. Add and max commute, so the planes are deterministic and
// bit-identical to the plain scatter twin (ops/binning.py bin_chunk_packed)
// whatever the order. Points that pack to 0 (z <= -1, including NaN z)
// cannot raise the max and skip the atomicMax. A hot pixel (the pixel-0
// flood of escaping orbits) serializes its atomics; the TPU path evicts it
// before the sort, and the GPU analogue is later work.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void bin_packed_kernel(unsigned* __restrict__ count, unsigned* __restrict__ packed,
                                  const int* __restrict__ flat,
                                  const unsigned* __restrict__ update, long long m, int npix) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride) {
    int f = flat[i];
    if ((unsigned)f >= (unsigned)npix) continue;  // out of bounds (flat == npix)
    atomicAdd(&count[f], 1u);
    unsigned v = update[i];
    if (v != 0u) atomicMax(&packed[f], v);
  }
}

extern "C" int sat_bin_packed(unsigned* count, unsigned* packed, const int* flat,
                              const unsigned* update, long long m, int npix, void* stream) {
  const int threads = 256;
  long long want = (m + threads - 1) / threads;
  int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  bin_packed_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(count, packed, flat, update,
                                                                  m, npix);
  return (int)cudaGetLastError();
}
