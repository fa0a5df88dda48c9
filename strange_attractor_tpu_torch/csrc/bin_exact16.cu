// EXACT16_KERNEL-strategy bin of one point chunk, both bucket-tie rules.
//
// Replaces: the Pallas sort-bin pipeline behind bin_chunk_kernel_exact16
// (strange_attractor_tpu/ops/kernel_binning.py:584-730): the section sort
// (_sections, :415-442, or the u64 key sort :669-702), the row apply
// (_run_apply / _make_apply_kernel, :445-470 / :170-332) with
// _flush_exact16_val (:387, ties "value") or _flush_exact16 (:370, ties
// "earliest"), and the decode + strict merge. It computes what that
// pipeline computes: every in-bounds point counts; a point with z <= -1
// (NaN included) never wins; the others carry the bucket key
// sk = ~(mono(canon(z)) >> 16) & 0xFFFF (smaller is nearer) and the f16 bits
// of their value. Per pixel the chunk's winner has the smallest sk; on a
// bucket tie "value" takes the smallest f16 bit pattern, "earliest" the
// earliest-emitted point. The bucket's lower edge replaces zbuf if strictly
// greater, and steps takes the f16 value back in f32.
//
// Design: two passes over a per-pixel u64 scratch key, all ones = empty.
//   1. one thread per point: atomicAdd the count; a live point atomicMins
//      sk << 16 | f16 ("value") or sk << 48 | index << 16 | f16 ("earliest",
//      index = the point's position in the step-major stream, JAX's
//      emission order). Min commutes: deterministic in any order.
//   2. one thread per pixel: decode, strict merge, reset the key to empty.
// The f16 conversion is done in bits, rounding to nearest even, with JAX's
// NaN pattern (sign, quiet bit, top payload bits), not by the hardware's
// cvt, which may return one canonical NaN: the value rule compares the bit
// patterns, so a different NaN would change the winner. The decode back to
// f32 is done in bits too (a NaN keeps its payload and gets the quiet bit).
//
// What bounds it on the H100: as bin_exact.cu, one 4-byte and at most one
// 8-byte L2 atomic per point (a plain read first skips the key atomic when
// the standing key is already smaller), then one sweep of the planes.

#include <cuda_runtime.h>
#include <stdint.h>

#define EMPTY_KEY 0xFFFFFFFFFFFFFFFFull

// f32 bits -> f16 bits (ops/binning.py f16_bits)
__device__ __forceinline__ unsigned f16_bits(unsigned u) {
  unsigned sign = (u >> 16) & 0x8000u;
  unsigned a = u & 0x7FFFFFFFu;
  unsigned h;
  if (a > 0x7F800000u) {
    h = 0x7E00u | ((a >> 13) & 0x3FFu);  // NaN: quiet bit + top payload bits
  } else if (a >= 0x477FF000u) {
    h = 0x7C00u;  // rounds to infinity
  } else if (a >= 0x38800000u) {
    h = (a - 0x38000000u + 0xFFFu + ((a >> 13) & 1u)) >> 13;
  } else {
    // subnormal: mantissa * 2^(e - 126), rounded to nearest even
    unsigned mant = (a & 0x7FFFFFu) | 0x800000u;
    int shift = 126 - (int)(a >> 23);
    shift = shift < 14 ? 14 : (shift > 25 ? 25 : shift);
    h = (mant + (1u << (shift - 1)) - 1u + ((mant >> shift) & 1u)) >> shift;
  }
  return sign | h;
}

// f16 bits -> f32 bits (ops/binning.py f16_to_f32)
__device__ __forceinline__ unsigned f32_bits(unsigned h) {
  unsigned sign = (h & 0x8000u) << 16;
  unsigned e = (h >> 10) & 0x1Fu, m = h & 0x3FFu;
  if (e == 31u) return sign | 0x7F800000u | (m << 13) | (m ? 0x400000u : 0u);
  if (e == 0u) return sign | __float_as_uint((float)m * 5.9604644775390625e-08f);  // m * 2^-24
  return sign | ((e + 112u) << 23) | (m << 13);
}

__global__ void exact16_points_kernel(unsigned* __restrict__ count,
                                      unsigned long long* __restrict__ key,
                                      const int* __restrict__ flat,
                                      const unsigned* __restrict__ z,
                                      const unsigned* __restrict__ val, long long m, int npix,
                                      int earliest) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m; i += stride) {
    int f = flat[i];
    if ((unsigned)f >= (unsigned)npix) continue;  // out of bounds (flat == npix)
    atomicAdd(&count[f], 1u);
    unsigned b = z[i];
    if ((b & 0x7FFFFFFFu) == 0u) b = 0u;  // -0.0 -> +0.0
    if (!(__uint_as_float(b) > -1.0f)) continue;  // dead: counted, never wins
    unsigned mono = (b >> 31) ? ~b : (b | 0x80000000u);
    unsigned long long sk = (~(mono >> 16)) & 0xFFFFu;
    unsigned long long v16 = f16_bits(val[i]);
    unsigned long long k = earliest ? (sk << 48) | ((unsigned long long)i << 16) | v16
                                    : (sk << 16) | v16;
    if (*(volatile unsigned long long*)&key[f] > k) atomicMin(&key[f], k);
  }
}

__global__ void exact16_merge_kernel(unsigned* __restrict__ steps, float* __restrict__ zbuf,
                                     unsigned long long* __restrict__ key, int npix,
                                     int earliest) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npix) return;
  unsigned long long k = key[p];
  if (k == EMPTY_KEY) return;
  key[p] = EMPTY_KEY;
  unsigned sk = (unsigned)(k >> (earliest ? 48 : 16)) & 0xFFFFu;
  unsigned mono = ((~sk) & 0xFFFFu) << 16;  // the bucket's lower edge
  float z_q = __uint_as_float((mono >> 31) ? (mono & 0x7FFFFFFFu) : ~mono);
  if (z_q > zbuf[p]) {  // strict: a bucket tie keeps the standing value
    zbuf[p] = z_q;
    steps[p] = f32_bits((unsigned)k & 0xFFFFu);
  }
}

extern "C" int sat_bin_exact16(unsigned* count, float* steps, float* zbuf,
                               unsigned long long* key, const int* flat, const unsigned* z,
                               const unsigned* val, long long m, int npix, int earliest,
                               void* stream) {
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  long long want = (m + threads - 1) / threads;
  int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  exact16_points_kernel<<<blocks, threads, 0, s>>>(count, key, flat, z, val, m, npix, earliest);
  exact16_merge_kernel<<<(npix + threads - 1) / threads, threads, 0, s>>>(
      reinterpret_cast<unsigned*>(steps), zbuf, key, npix, earliest);
  return (int)cudaGetLastError();
}
