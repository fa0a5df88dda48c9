// Kernel T: the tone map and the (transparent, 8-bit) conversion of a frame.
//
// Replaces: the XLA fusion the JAX package runs for a frame's delivery, its
// jitted colorize (strange_attractor_tpu/render.py:646-662) of
// colorize_stats and colorize_planes (strange_attractor_tpu/ops/colorize.py
// :89-142) and the conversion convert_format_device
// (strange_attractor_tpu/utils/export.py:36-58). Its plain twin is the torch
// chain of ops/colorize.py (colorize_stats, colorize_planes) and
// utils/export.py (convert_format_device), some 150 eager launches a frame
// that the kernel computes bit for bit in two:
//
//   - tonemap_stats_kernel, the global reduction: Gas the largest count as
//     u32 (the plane holds u32 bits, so a count from 2^31 up compares as
//     unsigned), Depth the sentinel-excluded (zmax, zmin) fold, which starts
//     at (0.0, FLT_MAX) (src/lib.rs:875-899). A grid of the blocks resident
//     at once strides over the canvas; each thread keeps four u32 maxima
//     (the count; the mono key of the valid depths and its complement, whose
//     maximum is the least key; a NaN flag), a warp reduces them with
//     __reduce_max_sync, the block in shared memory, and the block makes one
//     atomicMax a word. torch.max and torch.min propagate a NaN where
//     CUDA's fmaxf/fminf would drop it, so a NaN depth among the valid ones
//     makes both zmax and zmin NaN, and the frame gray 0, as the twin does.
//     A one-thread kernel turns the words into the float32 stats on the
//     card, and for Gas takes log1p(max) there, once a frame: no host sync,
//     so a sequence tone-maps frame after frame.
//   - tonemap_kernel, the elementwise pass, one thread a pixel: the planes as
//     they lie (a PACKED plane unpacked inline, ops/binning.py unpack_zv),
//     the palette lerp with its clamp and square root, the brightness
//     log1p(count) / log1p(max) with log1p in double rounded once to float32
//     (the port's rule, ops/colorize.py _log1p_f32; log1p(max) is the
//     finalize kernel's), the brightness offset
//     and factor, Rust's saturating `as u16`, the alpha, and one of four
//     layouts: (H, W, 4) or (H, W, 3), u16 or u8 by ((v + 128) * 65281) >> 24.
//
// Rounding: the build's -fmad=false keeps (rgb * factor + offset) * bfactor
// and the lerp from contracting into FMAs, and `/` and sqrtf are IEEE (no
// fast math), so every float op rounds as the twin's eager op does.
//
// Its bound on the H100 is bytes: a 1080p Gas frame to 8-bit RGB reads the
// count and packed planes and writes 3 bytes a pixel, 11 bytes a pixel or
// ~6.8 us at 3.35 TB/s (this design reads the count plane twice: ~9.3 us).
// The design is the simple one (a thread a pixel, a store a channel). It
// takes ~0.032 ms a frame, the reduction ~0.008 of it, where the Depth
// frame takes ~0.016 (chip_smoke.py phase 32; NVIDIA H100 80GB HBM3,
// 700 W): the Gas pass's arithmetic, not its bytes, holds it, the count's
// log1p in double first (~0.008 ms; the port's tools.tonemap_variants times
// the pass without each operation). log1p(max) is taken once a frame, in
// the finalize kernel, not in every thread. Making it fast is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "emit_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
// the (z, value) packing of ops/binning.py: 20 bits of z key, 12 of value,
// the key shifted so that the -1.0 sentinel maps to 0
constexpr unsigned ZKEY_MASK = 0xFFFFF000u, VAL_MASK = 0xFFFu, MONO_NEG1 = 0x407FFFFFu;
// mono_u32 of +0.0 and of FLT_MAX: the starts of the depth fold
constexpr unsigned MONO_ZERO = 0x80000000u, MONO_FLT_MAX = 0xFF7FFFFFu;
// stats words: the largest count, the largest key of a valid depth, the
// largest complement of one (the least key), and a NaN depth seen
constexpr int WORDS = 4;

__device__ __forceinline__ unsigned umax(unsigned a, unsigned b) { return a > b ? a : b; }

// inverse of mono_u32 (ops/binning.py _inv_mono_u32)
__device__ __forceinline__ float inv_mono(unsigned m) {
  return __uint_as_float((m >> 31) ? (m & 0x7FFFFFFFu) : ~m);
}

// ops/binning.py unpack_zv of one packed word: the depth, and the palette
// position (12 bits over 4096, exact)
__device__ __forceinline__ float packed_z(unsigned p) {
  return inv_mono((p & ZKEY_MASK) + MONO_NEG1);
}
__device__ __forceinline__ float packed_value(unsigned p) {
  return (float)(p & VAL_MASK) / 4096.0f;
}

// Rust `<f32> as u16` (ops/colorize.py _saturate_u16): NaN -> 0, clamp to
// [0, 65535] (+inf -> 65535), truncate. The float-to-int conversion of a NaN
// is undefined in C++, so NaN is handled first.
__device__ __forceinline__ unsigned saturate_u16(float x) {
  if (isnan(x) || x <= 0.0f) return 0u;
  if (x >= 65535.0f) return 65535u;
  return (unsigned)x;
}

// the 8-bit conversion of a u16 channel, round(v * 255 / 65535)
// (utils/export.py convert_format_device): (65535 + 128) * 65281 =
// 4,286,546,303 fits u32 and not int32, so the product is unsigned
template <typename Out>
__device__ __forceinline__ Out narrow(unsigned v);
template <>
__device__ __forceinline__ unsigned short narrow<unsigned short>(unsigned v) {
  return (unsigned short)v;
}
template <>
__device__ __forceinline__ unsigned char narrow<unsigned char>(unsigned v) {
  return (unsigned char)(((v + 128u) * 65281u) >> 24);
}

__global__ void __launch_bounds__(THREADS) tonemap_stats_kernel(
    const unsigned* __restrict__ count, const float* __restrict__ zbuf,
    const unsigned* __restrict__ packed, long long npix, int depth, unsigned* words) {
  __shared__ unsigned block[WORDS];
  if (threadIdx.x < WORDS) block[threadIdx.x] = 0u;
  __syncthreads();
  unsigned m[WORDS] = {0u, 0u, 0u, 0u};
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < npix; i += nthreads) {
    if (!depth) {
      m[0] = umax(m[0], count[i]);
      continue;
    }
    const float z = packed ? packed_z(packed[i]) : zbuf[i];
    if (z == -1.0f) continue;  // the sentinel: no point landed here
    if (isnan(z)) {
      m[3] = 1u;
      continue;
    }
    const unsigned key = mono_u32(z);
    m[1] = umax(m[1], key);
    m[2] = umax(m[2], ~key);
  }
  for (int w = 0; w < WORDS; ++w) {
    const unsigned r = __reduce_max_sync(FULL_MASK, m[w]);
    if ((threadIdx.x & 31) == 0 && r) atomicMax(&block[w], r);
  }
  __syncthreads();
  if (threadIdx.x < WORDS && block[threadIdx.x]) {
    atomicMax(&words[threadIdx.x], block[threadIdx.x]);
  }
}

// the words as ops/colorize.py colorize_stats gives them: Gas (max count,
// log1p of it as _log1p_f32 takes it, the brightness's divisor), Depth
// (zmax, zmin), both NaN when a valid depth is NaN
__global__ void tonemap_finalize_kernel(const unsigned* words, int depth, float* stats) {
  if (threadIdx.x != 0) return;
  if (!depth) {
    stats[0] = (float)words[0];  // rounded to nearest, as u32(count).to(float32)
    stats[1] = (float)log1p((double)stats[0]);
  } else if (words[3]) {
    stats[0] = stats[1] = __uint_as_float(0x7FC00000u);
  } else {
    stats[0] = inv_mono(umax(words[1], MONO_ZERO));
    const unsigned least = ~words[2];  // all ones when no depth is valid
    stats[1] = inv_mono(least < MONO_FLT_MAX ? least : MONO_FLT_MAX);
  }
}

struct Frame {
  const unsigned* count;  // u32 counts (Gas), else null
  const float* steps;     // EXACT planes, else null
  const float* zbuf;
  const unsigned* packed;  // a PACKED plane, else null
  const float* stats;      // (max count, its log1p) or (zmax, zmin)
  const float* palette;    // (k + 1) x 3 float32 stops, the last one doubled
  int k;
  float offset, factor;  // the brightness constants, rounded to float32
  int depth;             // 1: the Depth render, 0: Gas
  int alpha;             // Gas: the alpha is the brightness (transparent), else 65535
  long long npix;
};

template <typename Out, int C>
__global__ void __launch_bounds__(THREADS) tonemap_kernel(Frame f, Out* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= f.npix) return;
  unsigned px[4];
  if (f.depth) {
    const float z = f.packed ? packed_z(f.packed[i]) : f.zbuf[i];
    const float zmax = f.stats[0], zmin = f.stats[1];
    const float t = z != -1.0f ? (z - zmin) / (zmax - zmin) : 0.0f;
    px[0] = px[1] = px[2] = saturate_u16(t * 65535.0f);
    px[3] = 65535u;
  } else {
    const float value = f.packed ? packed_value(f.packed[i]) : f.steps[i];
    // palette_lookup (src/lib.rs:442-472): only value >= 1.0 clamps to
    // 0.999999; a NaN value stays NaN through the clamp and the product
    const float c = value >= 1.0f ? (float)0.999999 : (value < 0.0f ? 0.0f : value);
    const float v = c * (float)f.k;
    // the stop index, clamped as the twin clamps it: a NaN v has no floor,
    // so it takes row 0 (its lerp is NaN whatever the rows), and f32 can
    // round v up to exactly k within half an ulp of 1.0
    int n = v >= 1.0f ? (int)floorf(v) : 0;
    if (n > f.k - 1) n = f.k - 1;
    const float frac = fmodf(v, 1.0f);
    const float* lo = f.palette + 3 * n;
    const float* hi = lo + 3;
    const float factor = (float)log1p((double)(float)f.count[i]) / f.stats[1];
    for (int ch = 0; ch < 3; ++ch) {
      const float rgb = sqrtf(hi[ch] * frac + lo[ch] * (1.0f - frac));
      px[ch] = saturate_u16((rgb * factor + f.offset) * f.factor * 65535.0f);
    }
    // max count 0 (an empty canvas): factor 0/0 = NaN, every channel 0
    px[3] = f.alpha ? saturate_u16(factor * 65535.0f) : 65535u;
  }
  Out* o = out + i * C;  // the 3-channel layouts have a 3-element stride: store by element
  for (int ch = 0; ch < C; ++ch) o[ch] = narrow<Out>(px[ch]);
}

template <typename Out, int C>
void launch_tonemap(const Frame& f, void* out, cudaStream_t stream) {
  const long long blocks = (f.npix + THREADS - 1) / THREADS;
  tonemap_kernel<Out, C><<<(unsigned)blocks, THREADS, 0, stream>>>(f, static_cast<Out*>(out));
}

}  // namespace

// The stats of one frame into stats[0..1] (float32); words is 4 u32 of
// scratch. count for Gas; zbuf or packed for Depth.
extern "C" int sat_tonemap_stats(const unsigned* count, const float* zbuf, const unsigned* packed,
                                 long long npix, int depth, unsigned* words, float* stats,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int err = (int)cudaMemsetAsync(words, 0, WORDS * sizeof(unsigned), s);
  if (err != (int)cudaSuccess) return err;
  if (npix > 0) {
    static int resident = 0;  // blocks an SM holds at once
    if (!resident) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, tonemap_stats_kernel, THREADS, 0);
      if (resident <= 0) resident = 1;
    }
    const long long want = (npix + THREADS - 1) / THREADS;
    const long long most = (long long)resident * sm_count();
    const unsigned blocks = (unsigned)(want < most ? want : most);
    tonemap_stats_kernel<<<blocks, THREADS, 0, s>>>(count, zbuf, packed, npix, depth, words);
  }
  tonemap_finalize_kernel<<<1, 32, 0, s>>>(words, depth, stats);
  return (int)cudaGetLastError();
}

// One frame's image into out: (npix, channels) of u16, or of u8 when
// eight_bit. steps and zbuf, or packed, hold the planes; stats is
// sat_tonemap_stats's float32 stats; palette holds k + 1 float32 RGB stops.
extern "C" int sat_tonemap(const unsigned* count, const float* steps, const float* zbuf,
                           const unsigned* packed, const float* stats, const float* palette,
                           int k, float offset, float factor, long long npix, int depth,
                           int alpha, int channels, int eight_bit, void* out, void* stream) {
  if (npix <= 0) return (int)cudaSuccess;
  if (channels != 3 && channels != 4) return (int)cudaErrorInvalidValue;
  const Frame f{count, steps, zbuf, packed, stats, palette, k, offset, factor, depth, alpha, npix};
  cudaStream_t s = (cudaStream_t)stream;
  if (eight_bit) {
    if (channels == 4) launch_tonemap<unsigned char, 4>(f, out, s);
    else launch_tonemap<unsigned char, 3>(f, out, s);
  } else {
    if (channels == 4) launch_tonemap<unsigned short, 4>(f, out, s);
    else launch_tonemap<unsigned short, 3>(f, out, s);
  }
  return (int)cudaGetLastError();
}
