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
// Design: the tile bin of bin_tile.cuh. A record's key word is
// sk << 16 | f16 (all ones for a point that counts and never wins: a live
// point's sk is at most 0xBF80). "value" mins that word itself: a native
// 32-bit shared-memory atomic and 8 bytes a pixel of shared memory.
// "earliest" mins sk << 48 | index << 16 | f16 (index = the point's
// position in the step-major stream, JAX's emission order), rebuilt in the
// merge as in bin_exact.cu. Records are 8 bytes in both. Min commutes:
// deterministic in any order.
// The f16 conversion is done in bits, rounding to nearest even, with JAX's
// NaN pattern (sign, quiet bit, top payload bits), not by the hardware's
// cvt, which may return one canonical NaN: the value rule compares the bit
// patterns, so a different NaN would change the winner. The decode back to
// f32 is done in bits too (a NaN keeps its payload and gets the quiet bit).
//
// What bounds it on the H100: as bin_exact.cu, the partition's scatter and
// the merge, not the roofline's ~19 us a flagship chunk: 0.081 ms ("value":
// scatter 39 us, merge 16) and 0.094 ms ("earliest": 41 and 27) against the
// atomics design's 0.137 and 0.134; a solar-sail chunk 0.083 and 0.094 ms
// against 1.46 and 1.43 (one call, the two packages timed in turns by
// perf_probe.py before the path of chunks above 2^27 points got its present
// form; NVIDIA H100 80GB HBM3, 700.00 W). These sources read 0.079-0.080 and
// 0.092-0.093 ms a flagship chunk, 0.081-0.082 and 0.092-0.094 a solar-sail
// chunk in four runs of chip_smoke.py (same card and limit).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bin_tile.cuh"

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

template <bool EARLIEST>
struct Exact16Mode;

template <>
struct Exact16Mode<false> {
  typedef unsigned Key;
  static constexpr bool WIDE = false;
  static constexpr bool READS_VAL = true;
  __host__ __device__ static constexpr Key empty() { return 0xFFFFFFFFu; }
  __device__ static unsigned key_word(unsigned b, unsigned v) {
    if ((b & 0x7FFFFFFFu) == 0u) b = 0u;  // -0.0 -> +0.0
    if (!(__uint_as_float(b) > -1.0f)) return bin_tile::DEAD;  // counted, never wins
    unsigned mono = (b >> 31) ? ~b : (b | 0x80000000u);
    return (((~(mono >> 16)) & 0xFFFFu) << 16) | f16_bits(v);
  }
  __device__ static Key key(unsigned word, unsigned) { return word; }
  __device__ static unsigned bucket(Key k) { return k >> 16; }
  __device__ static float depth(Key k) {
    unsigned mono = ((~bucket(k)) & 0xFFFFu) << 16;  // the bucket's lower edge
    return __uint_as_float((mono >> 31) ? (mono & 0x7FFFFFFFu) : ~mono);
  }
  __device__ static unsigned value_bits(Key k, const unsigned*) { return f32_bits(k & 0xFFFFu); }
};

template <>
struct Exact16Mode<true> {
  typedef bin_tile::u64 Key;
  static constexpr bool WIDE = true;
  static constexpr bool READS_VAL = true;
  __host__ __device__ static constexpr Key empty() { return ~0ull; }
  __device__ static unsigned key_word(unsigned b, unsigned v) {
    return Exact16Mode<false>::key_word(b, v);
  }
  __device__ static Key key(unsigned word, unsigned index) {
    return ((Key)(word >> 16) << 48) | ((Key)index << 16) | (word & 0xFFFFu);
  }
  __device__ static float depth(Key k) {
    return Exact16Mode<false>::depth((unsigned)(k >> 48) << 16);
  }
  __device__ static unsigned value_bits(Key k, const unsigned*) {
    return f32_bits((unsigned)k & 0xFFFFu);
  }
};

extern "C" int sat_bin_exact16(unsigned* count, float* steps, float* zbuf, void* control,
                               unsigned* records, const int* flat, const unsigned* z,
                               const unsigned* val, long long m, int npix, int earliest,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return earliest ? bin_tile::tile_bin<Exact16Mode<true>>(count, steps, zbuf, control, records,
                                                           flat, z, val, m, npix, s)
                  : bin_tile::tile_bin<Exact16Mode<false>>(count, steps, zbuf, control, records,
                                                            flat, z, val, m, npix, s);
}
