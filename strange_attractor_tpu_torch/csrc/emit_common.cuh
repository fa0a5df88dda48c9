// Device code shared by the emitting kernels (map_emit.cu, project_emit.cu):
// the launch constants, the (z, value) packing and the bounds check that end
// every point's emission, the counterpart of the JAX package's _finish_emit
// (strange_attractor_tpu/render.py:164-196), and lane reseeding's counter-based
// fresh points (_reseed_dead_lanes, :278-298). Both kernels include it, so a
// frame projected from the shared-orbit stream ends exactly as the fused
// map+emit step does. Also the card's SM count, by which the launchers of
// map_emit.cu and bin_packed.cu size their grids.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

// the current card's SM count, asked once per library (132 on the H100 SXM)
static inline int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// The launch constants of both kernels in the compute type T (ops/cuda_lib.py
// EmitParams for float, EmitParams64 for double), each the host's float64
// value rounded once to T. The int fields come last, so that no padding
// lies between two fields in either type (tests/test_torch_map_emulation.py
// pins every offset against the ctypes mirror).
template <typename T>
struct EmitParamsT {
  T coef[30];  // x, y, z coefficient rows of the Sprott map
  T mc[3];     // the RK4 map's derivative constants
  T h, hh, h6;  // the RK4 step h, 0.5 h and h / 6
  T rot[9];    // row-major view rotation
  T cos_v, sin_v;
  T ccx, ccy, ccz;  // center_camera
  T mid, wscaled, half_h;  // 0.5/scale, width*scale, height/2
  T t_offset, t_factor;  // AdjustedVelocity
  int map;        // map_emit.cuh MAP_*: 0 Sprott, else an RK4 map
  int transform;  // 0 = poisson-saturne classifier, 1 = AdjustedVelocity
  int width, height;
};
using EmitParams = EmitParamsT<float>;
using EmitParams64 = EmitParamsT<double>;

// Lane reseeding (Config.reseed_lanes) in one launch of kernel A
// (ops/cuda_lib.py ReseedArgs): age is the (lanes,) int32 lane age, null
// when reseeding is off; a lane that escaped restarts from the fresh point
// of (key, chunk, lane) and re-warms from age -warmup.
struct Reseed {
  int* age;
  unsigned long long key;  // the render key
  unsigned chunk;          // the render's chunk index
  int warmup;
};

// Philox4x32-10 (Salmon et al., SC'11): the counter (c[0..3]) enciphered
// under the key (k0, k1) in ten rounds. ops/emit.py philox4x32 is the
// twin, on 16-bit halves in int64.
__device__ __forceinline__ void philox4x32(unsigned c[4], unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) k0 += 0x9E3779B9u, k1 += 0xBB67AE85u;
    unsigned long long p0 = (unsigned long long)0xD2511F53u * c[0];
    unsigned long long p1 = (unsigned long long)0xCD9E8D57u * c[2];
    unsigned n0 = (unsigned)(p1 >> 32) ^ c[1] ^ k0, n2 = (unsigned)(p0 >> 32) ^ c[3] ^ k1;
    c[0] = n0, c[1] = (unsigned)p1, c[2] = n2, c[3] = (unsigned)p0;
  }
}

// One component of a reseeded lane's fresh point, U[0,1) * 0.1 in T: Philox
// of the counter (lane, chunk, component, 0) under the render key; the
// uniform takes the top 24 bits of the first word in float, 27 + 26 bits of
// the first two in double (ops/emit.py fresh_points).
template <typename T>
__device__ __forceinline__ T fresh_component(const Reseed& r, unsigned lane, unsigned comp) {
  unsigned c[4] = {lane, r.chunk, comp, 0u};
  philox4x32(c, (unsigned)r.key, (unsigned)(r.key >> 32));
  if constexpr (sizeof(T) == 4) {
    return (float)(c[0] >> 8) * (1.0f / 16777216.0f) * (float)0.1;
  } else {
    return ((double)(c[0] >> 5) * 67108864.0 + (double)(c[1] >> 6)) *
           (1.0 / 9007199254740992.0) * 0.1;
  }
}

// _reseed_dead_lanes' test (strange_attractor_tpu/render.py:278-298): a
// lane is dead when a component is not finite or its magnitude exceeds 1e3.
// Then it takes the fresh point and age -warmup; returns the lane's age.
template <typename T>
__device__ __forceinline__ int reseed_lane(const Reseed& r, unsigned lane, T& x, T& y, T& z) {
  const T lim = (T)1000;
  if (x >= -lim && x <= lim && y >= -lim && y <= lim && z >= -lim && z <= lim)
    return r.age[lane];
  x = fresh_component<T>(r, lane, 0u);
  y = fresh_component<T>(r, lane, 1u);
  z = fresh_component<T>(r, lane, 2u);
  return -r.warmup;
}

// monotone f32 -> u32 map (ops/binning.py _mono_u32)
__device__ __forceinline__ unsigned mono_u32(float z) {
  unsigned u = __float_as_uint(z);
  return (u >> 31) ? ~u : (u | 0x80000000u);
}

// ops/binning.py pack_zv: 20 bits of depth above the -1.0 sentinel, 12 bits
// of palette position; a NaN value packs position 0 (XLA's answer)
__device__ __forceinline__ unsigned pack_zv(float z, float val) {
  if (!(z > -1.0f)) return 0u;
  unsigned d = mono_u32(z) - 0x407FFFFFu;
  float q = isnan(val) ? 0.0f : fminf(fmaxf(val, 0.0f), (float)0.999999);
  return (d & 0xFFFFF000u) | (unsigned)(q * 4096.0f);
}

// The pixel index of a projected point, npix when out of bounds, in the
// compute type T. The reference skips a point iff i >= W or j >= H or i < 0
// or j < 0 (src/lib.rs:789); NaN coordinates fail all four tests, pass, and
// bin at pixel (0, 0) through the saturating cast (src/lib.rs:799-812). A
// point whose lane re-warms after a reseed (fj = +inf in a shared stream)
// is out of bounds.
template <typename T>
__device__ __forceinline__ int pixel_index(T fi, T fj, int width, int height) {
  bool oob = (fi >= (T)width) || (fj >= (T)height) || (fi < (T)0) || (fj < (T)0);
  if (oob) return width * height;
  int ii = isnan(fi) ? 0 : (int)fi;
  int jj = isnan(fj) ? 0 : (int)fj;
  return jj * width + ii;
}

// NaN z never wins the z-test (src/lib.rs:821); -inf is its max-safe form
template <typename T>
__device__ __forceinline__ T nan_to_neg_inf(T z2) { return isnan(z2) ? (T)-INFINITY : z2; }
