// Kernel F: the adaptive PNG scanline filter of a delivered image.
//
// Replaces no TPU kernel: the JAX package filters PNG scanlines on the host
// (strange_attractor_tpu/utils/export.py, numpy and csrc/fastdeflate.cpp),
// and so did this port until the filter became the largest part of a still
// frame's encode after the deflate. Its plain twin is ops/png_filter.py
// png_filter_plain, and both compute the bytes of
// utils/export.py _filter_scanlines_numpy, the reference the host's native
// filter is held to: for each row the five PNG filters (None, Sub, Up,
// Average, Paeth; "left" is bpp bytes back, row 0 and the first bpp bytes of
// a row take zero neighbours), each residual a byte mod 256, the cost
// sum(min(c, 256 - c)) over the row, the cheapest filter kept with ties to
// the lowest index. Row y of the output is the filter's index, then the
// row's residuals: out[y * (1 + stride)] is the type byte.
//
// The image is (H, W, C) of u8 or u16 samples as the card holds them. A PNG
// stores 16-bit samples big-endian, so byte x of that stream is byte x ^ 1 in
// the card's little-endian memory (a row's stride and bpp are even there):
// the kernel reads through that swap and never writes the swapped image.
//
// Its bound on the H100 is bytes: a 1080p 8-bit RGB frame is 6.2 MB in and
// 6.2 MB out, ~3.7 us at 3.35 TB/s. The design is the simple one: one block
// a row; each thread takes every THREADS-th byte of the row, so a warp reads
// 32 neighbouring bytes and the neighbours it also needs (left, up, up-left)
// come from L1; the five costs sum in registers, then by warp reduction and
// through shared memory; one thread picks the filter; then the block
// recomputes that filter's residuals alone and stores them, neighbouring
// threads on neighbouring bytes (an output row starts at an odd offset, so a
// store is a byte). It reads each input byte some eight times from L1/L2 and
// will not set a frame's pace: the launch and the copy back to the host do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FILTERS = 5;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

// the PNG spec's PaethPredictor (9.4), in integers: a, then b, then c on ties
__device__ __forceinline__ unsigned paeth(unsigned a, unsigned b, unsigned c) {
  const int p = (int)a + (int)b - (int)c;
  const int pa = abs(p - (int)a), pb = abs(p - (int)b), pc = abs(p - (int)c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// filter f's residual of byte v with neighbours left a, up b, up-left c
__device__ __forceinline__ unsigned residual(int f, unsigned v, unsigned a, unsigned b,
                                             unsigned c) {
  switch (f) {
    case 0: return v;
    case 1: return (v - a) & 0xFFu;
    case 2: return (v - b) & 0xFFu;
    case 3: return (v - ((a + b) >> 1)) & 0xFFu;
    default: return (v - paeth(a, b, c)) & 0xFFu;
  }
}

__device__ __forceinline__ unsigned cost(unsigned r) { return r < 256u - r ? r : 256u - r; }

// byte x of a row's big-endian stream and its three neighbours
struct Bytes {
  unsigned v, a, b, c;
};

__device__ __forceinline__ Bytes bytes_at(const unsigned char* __restrict__ cur,
                                          const unsigned char* __restrict__ up, long long x,
                                          int bpp, unsigned swap) {
  const long long i = x ^ swap, l = (x - bpp) ^ swap;
  const bool has_left = x >= bpp;
  Bytes q;
  q.v = cur[i];
  q.a = has_left ? cur[l] : 0u;
  q.b = up ? up[i] : 0u;
  q.c = up && has_left ? up[l] : 0u;
  return q;
}

__global__ void __launch_bounds__(THREADS) png_filter_kernel(
    const unsigned char* __restrict__ image, long long stride, int bpp, unsigned swap,
    unsigned char* __restrict__ out) {
  __shared__ unsigned partial[FILTERS][WARPS];
  __shared__ int pick;
  const long long y = blockIdx.x;
  const unsigned char* cur = image + y * stride;
  const unsigned char* up = y ? cur - stride : nullptr;
  unsigned sum[FILTERS] = {0u, 0u, 0u, 0u, 0u};
  for (long long x = threadIdx.x; x < stride; x += THREADS) {
    const Bytes q = bytes_at(cur, up, x, bpp, swap);
    for (int f = 0; f < FILTERS; ++f) sum[f] += cost(residual(f, q.v, q.a, q.b, q.c));
  }
  const int warp = threadIdx.x >> 5;
  for (int f = 0; f < FILTERS; ++f) {
    const unsigned s = __reduce_add_sync(FULL_MASK, sum[f]);
    if ((threadIdx.x & 31) == 0) partial[f][warp] = s;
  }
  __syncthreads();
  unsigned char* row = out + y * (stride + 1);
  if (threadIdx.x == 0) {
    // a row's cost is at most 128 a byte: a u32 holds rows of 33 MB
    unsigned best = 0u;
    int f_best = 0;
    for (int f = 0; f < FILTERS; ++f) {
      unsigned total = 0u;
      for (int w = 0; w < WARPS; ++w) total += partial[f][w];
      if (f == 0 || total < best) {
        best = total;
        f_best = f;
      }
    }
    pick = f_best;
    row[0] = (unsigned char)f_best;
  }
  __syncthreads();
  const int f = pick;
  for (long long x = threadIdx.x; x < stride; x += THREADS) {
    const Bytes q = bytes_at(cur, up, x, bpp, swap);
    row[1 + x] = (unsigned char)residual(f, q.v, q.a, q.b, q.c);
  }
}

}  // namespace

// The filtered scanlines of an image of h rows of stride bytes (bpp bytes a
// pixel; swap 1 for u16 samples, which the PNG stores big-endian) into out,
// h * (1 + stride) bytes.
extern "C" int sat_png_filter(const unsigned char* image, long long h, long long stride,
                              int bpp, int swap, unsigned char* out, void* stream) {
  if (h < 0 || h > 0x7FFFFFFFLL || stride < 0 || bpp <= 0 ||
      (swap && ((bpp & 1) || (stride & 1)))) {
    return (int)cudaErrorInvalidValue;
  }
  if (h == 0) return (int)cudaSuccess;
  png_filter_kernel<<<(unsigned)h, THREADS, 0, (cudaStream_t)stream>>>(image, stride, bpp,
                                                                       swap ? 1u : 0u, out);
  return (int)cudaGetLastError();
}
