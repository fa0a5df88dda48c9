// EXACT_KERNEL-strategy bin of one point chunk.
//
// Replaces: the Pallas sort-bin pipeline behind bin_chunk_kernel_exact
// (strange_attractor_tpu/ops/kernel_binning.py:542-579): the stable section
// sort on (flat, ~mono(z)) (_sections, :415-442), the row apply
// (_run_apply / _make_apply_kernel, :445-470 / :170-332) with _flush_exact
// (:352) and the strict z-test merge. It computes what that pipeline
// computes: every in-bounds point counts; per pixel the chunk's candidate
// is the point of greatest z (zeros canonicalized to +0.0), the earliest
// emitted on equal z; it replaces the standing plane only if strictly
// greater (the reference's z2 > zbuf, src/lib.rs:818-833), and steps takes
// its value's f32 bits.
//
// Design: two passes over a per-pixel u64 scratch key, all ones = empty.
//   1. one thread per point: atomicAdd the count, then atomicMin the key
//      (~mono(z)) << 32 | index, where index is the point's position in the
//      step-major stream, i.e. JAX's emission order. The smallest key is the
//      greatest z, then the earliest point: the first of the pixel's run in
//      JAX's stable descending-z sort. Min commutes, so the winner is
//      deterministic whatever the order of the atomics.
//   2. one thread per pixel: decode z and the index from the key, apply the
//      strict test against zbuf, write zbuf and steps (the winner's value
//      bits, read back through its index), and reset the key to empty, so
//      the scratch is clean for the next chunk.
// The sort and the one-hot int8 MXU dot existed to dodge the TPU's
// scalar-scatter floor; Hopper has native 64-bit atomics.
//
// What bounds it on the H100: pass 1 issues one 4-byte and at most one
// 8-byte atomic per point into 8.3 MB + 16.6 MB of planes that sit in the
// 50 MB L2. A plain read first skips the key atomic when the standing key
// is already smaller (keys only fall during the pass, so a stale read can
// only be larger than the truth), which spares most atomics of a hot pixel
// such as the pixel-0 flood of escaping orbits. Pass 2 streams the planes
// once (~41 MB at 1920x1080).

#include <cuda_runtime.h>
#include <stdint.h>

#define EMPTY_KEY 0xFFFFFFFFFFFFFFFFull

__global__ void exact_points_kernel(unsigned* __restrict__ count,
                                    unsigned long long* __restrict__ key,
                                    const int* __restrict__ flat, const unsigned* __restrict__ z,
                                    long long m, int npix) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride) {
    int f = flat[i];
    if ((unsigned)f >= (unsigned)npix) continue;  // out of bounds (flat == npix)
    atomicAdd(&count[f], 1u);
    unsigned b = z[i];
    if ((b & 0x7FFFFFFFu) == 0u) b = 0u;  // -0.0 -> +0.0
    unsigned mono = (b >> 31) ? ~b : (b | 0x80000000u);
    unsigned long long k = ((unsigned long long)(~mono) << 32) | (unsigned long long)i;
    if (*(volatile unsigned long long*)&key[f] > k) atomicMin(&key[f], k);
  }
}

__global__ void exact_merge_kernel(unsigned* __restrict__ steps, float* __restrict__ zbuf,
                                   unsigned long long* __restrict__ key,
                                   const unsigned* __restrict__ val, int npix) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  unsigned long long k = key[p];
  if (k == EMPTY_KEY) return;
  key[p] = EMPTY_KEY;
  unsigned mono = ~(unsigned)(k >> 32);
  float z_new = __uint_as_float((mono >> 31) ? (mono & 0x7FFFFFFFu) : ~mono);
  if (z_new > zbuf[p]) {  // strict: a tie keeps the standing value
    zbuf[p] = z_new;
    steps[p] = val[(unsigned)k];
  }
}

extern "C" int sat_bin_exact(unsigned* count, float* steps, float* zbuf,
                             unsigned long long* key, const int* flat, const unsigned* z,
                             const unsigned* val, long long m, int npix, void* stream) {
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  long long want = (m + threads - 1) / threads;
  int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  exact_points_kernel<<<blocks, threads, 0, s>>>(count, key, flat, z, m, npix);
  exact_merge_kernel<<<(npix + threads - 1) / threads, threads, 0, s>>>(
      reinterpret_cast<unsigned*>(steps), zbuf, key, val, npix);
  return (int)cudaGetLastError();
}
