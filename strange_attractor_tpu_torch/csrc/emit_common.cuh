// Device code shared by the emitting kernels (map_emit.cu, project_emit.cu):
// the (z, value) packing and the bounds check that end every point's
// emission, the counterpart of the JAX package's _finish_emit
// (strange_attractor_tpu/render.py:164-196). Both kernels include it, so a
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

// the launch constants of both kernels (ops/cuda_lib.py EmitParams)
struct EmitParams {
  float coef[30];  // x, y, z coefficient rows of the Sprott map
  int map;         // map_emit.cuh MAP_*: 0 Sprott, else an RK4 map
  float mc[3];     // the RK4 map's derivative constants (float32)
  float h, hh, h6;  // the RK4 step h, 0.5 h and h / 6, each float32
  float rot[9];    // row-major view rotation
  float cos_v, sin_v;
  float ccx, ccy, ccz;  // center_camera
  float mid, wscaled, half_h;  // 0.5/scale, width*scale, height/2
  float t_offset, t_factor;  // AdjustedVelocity
  int transform;  // 0 = poisson-saturne classifier, 1 = AdjustedVelocity
  int width, height;
};

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

// The pixel index of a projected point, npix when out of bounds. The
// reference skips a point iff i >= W or j >= H or i < 0 or j < 0
// (src/lib.rs:789); NaN coordinates fail all four tests, pass, and bin at
// pixel (0, 0) through the saturating cast (src/lib.rs:799-812).
__device__ __forceinline__ int pixel_index(float fi, float fj, int width, int height) {
  bool oob = (fi >= (float)width) || (fj >= (float)height) || (fi < 0.0f) || (fj < 0.0f);
  if (oob) return width * height;
  int ii = isnan(fi) ? 0 : (int)fi;
  int jj = isnan(fj) ? 0 : (int)fj;
  return jj * width + ii;
}

// NaN z never wins the z-test (src/lib.rs:821); -inf is its max-safe form
__device__ __forceinline__ float nan_to_neg_inf(float z2) { return isnan(z2) ? -INFINITY : z2; }
