// Fused map + emit chunk kernel (kernel A).
//
// Replaces: the XLA fusion of the JAX package's lax.scan over _step_fn
// (strange_attractor_tpu/render.py:130-196, :410-429) and _seed_warm's
// fori_loop (:394-407). The TPU has no Pallas kernel here; XLA fused the
// scan into one device program. Eager PyTorch would launch ~50 small kernels
// per map step (~6,400 per 128-step chunk), so the GPU needs its own.
//
// What it computes: one thread per trajectory lane. The point (x, y, z) is
// read once, carried in registers through `steps` map steps, and written
// back. Each step runs the Sprott map, the view rotation, the camera
// projection, the color transform, the bounds check and the (z, value)
// packing, and writes flat[s*lanes + lane] (int32 pixel, npix = out of
// bounds) and the payload of the bin strategy's planes kind at the same
// index -- the step-major order of JAX's emitted.reshape(-1) -- as
// _finish_emit does (render.py:192-196):
//   MODE_PACKED: packed (u32, pack_zv of z and the value);
//   MODE_DEPTH:  z (f32; the color transform is skipped);
//   MODE_EXACT:  z and val (f32 each, full precision).
// NaN z becomes -inf in every mode. MODE_NONE (the warm-up) only iterates.
// The mode is a template parameter: one branch-free loop per mode.
//
// What bounds it on the H100: a long dependent float32 chain per thread
// (~90 flops per step, plus an IEEE sqrt and two IEEE divisions) at one
// lane per thread; 32768 lanes give only ~250 threads per SM, so latency,
// not bandwidth, bounds it. The stores (8 bytes per point, 32 MB per 4M-point
// chunk) are coalesced across lanes. The design keeps every intermediate
// in registers; filling the card better (more lanes, or ILP across several
// lanes per thread) is later work.
//
// Rounding contract: built with -fmad=false, so every multiply and add
// rounds on its own exactly like the plain PyTorch twin (ops/emit.py),
// whose eager ops never contract; '/' and sqrtf stay IEEE (no fast math).
// Constants that JAX folds in float64 before rounding to float32 are
// written as (float)(double expression) for the same rounding.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct EmitParams {
  float coef[30];  // x, y, z coefficient rows of the Sprott map
  float rot[9];    // row-major view rotation
  float cos_v, sin_v;
  float ccx, ccy, ccz;  // center_camera
  float mid, wscaled, half_h;  // 0.5/scale, width*scale, height/2
  float t_offset, t_factor;  // AdjustedVelocity
  int transform;  // 0 = poisson-saturne classifier, 1 = AdjustedVelocity
  int width, height;
};

// sum of coefficient * monomial over [1, x, x^2, xy, xz, y, y^2, yz, z, z^2]
// in the reference's term order (src/lib.rs:588-613); c[0] * 1 is c[0]
__device__ __forceinline__ float sprott_dot(const float* c, float x, float y, float z) {
  float acc = c[0] + c[1] * x;
  acc = acc + c[2] * (x * x);
  acc = acc + c[3] * (x * y);
  acc = acc + c[4] * (x * z);
  acc = acc + c[5] * y;
  acc = acc + c[6] * (y * y);
  acc = acc + c[7] * (y * z);
  acc = acc + c[8] * z;
  acc = acc + c[9] * (z * z);
  return acc;
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

enum { MODE_NONE = 0, MODE_PACKED = 1, MODE_DEPTH = 2, MODE_EXACT = 3 };

template <int MODE>
__global__ void map_emit_kernel(float* __restrict__ pts, int lanes, int steps, EmitParams p,
                                int* __restrict__ flat, unsigned* __restrict__ out1,
                                float* __restrict__ out2) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  float x = pts[lane], y = pts[lanes + lane], z = pts[2 * lanes + lane];
  const int npix = p.width * p.height;
  const float fw = (float)p.width, fh = (float)p.height;
  size_t out = lane;
  for (int s = 0; s < steps; ++s) {
    float nx = sprott_dot(p.coef, x, y, z);
    float ny = sprott_dot(p.coef + 10, x, y, z);
    float nz = sprott_dot(p.coef + 20, x, y, z);
    if (MODE != MODE_NONE) {
      // view rotation, rows as (m0*x + m1*y) + m2*z
      float sx = p.rot[0] * nx + p.rot[1] * ny + p.rot[2] * nz;
      float sy = p.rot[3] * nx + p.rot[4] * ny + p.rot[5] * nz;
      float sz = p.rot[6] * nx + p.rot[7] * ny + p.rot[8] * nz;
      // projection with the cc.y <-> z quirk (src/lib.rs:776-786)
      float xc = sx + p.ccx;
      float zc = sz + p.ccy;
      float x2 = xc * p.cos_v + zc * p.sin_v;
      float z2 = xc * p.sin_v - zc * p.cos_v;
      float fi = (p.mid - x2) * p.wscaled;
      float fj = p.half_h - (sy + p.ccz) * p.wscaled;
      // color transform on delta = new - previous point; a depth stream
      // carries no value
      float val = 0.0f;
      if (MODE != MODE_DEPTH) {
        float dx = nx - x, dy = ny - y, dz = nz - z;
        float mag = sqrtf(dx * dx + dy * dy + dz * dz);
        if (p.transform == 0) {
          float t = (sx + p.ccx) * (float)0.7009092642998509 +
                    (sz + p.ccy) * (float)0.7132504491541816;
          bool outside = (t < (float)-0.0839) ||
                         ((float)10.55 * t + sy < (float)(0.46 - 1.0941)) ||
                         ((float)1.0426 * t + sy < (float)(0.179 - 0.1576)) ||
                         ((float)0.5139 * t - sy > (float)(-0.04 - 0.04092));
          float color = ((outside ? 0.0f : 1.0f) + mag) / 2.0f;
          val = (color - (float)0.1) / (float)0.9;
        } else {
          val = (mag + p.t_offset) * p.t_factor;
        }
      }
      // bounds check: NaN passes and bins at pixel (0, 0) (src/lib.rs:789-812)
      bool oob = (fi >= fw) || (fj >= fh) || (fi < 0.0f) || (fj < 0.0f);
      int f = npix;
      if (!oob) {
        int ii = isnan(fi) ? 0 : (int)fi;
        int jj = isnan(fj) ? 0 : (int)fj;
        f = jj * p.width + ii;
      }
      if (isnan(z2)) z2 = -INFINITY;
      flat[out] = f;
      if (MODE == MODE_PACKED) {
        out1[out] = pack_zv(z2, val);
      } else {
        out1[out] = __float_as_uint(z2);
        if (MODE == MODE_EXACT) out2[out] = val;
      }
      out += lanes;
    }
    x = nx;
    y = ny;
    z = nz;
  }
  pts[lane] = x;
  pts[lanes + lane] = y;
  pts[2 * lanes + lane] = z;
}

// out1: packed (u32) or z (f32 bits); out2: val (MODE_EXACT only)
extern "C" int sat_map_emit(float* pts, int lanes, int steps, int mode, EmitParams p,
                            int* flat, unsigned* out1, float* out2, void* stream) {
  const int threads = 128;
  int blocks = (lanes + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case MODE_NONE:
      map_emit_kernel<MODE_NONE><<<blocks, threads, 0, s>>>(pts, lanes, steps, p, flat, out1, out2);
      break;
    case MODE_PACKED:
      map_emit_kernel<MODE_PACKED><<<blocks, threads, 0, s>>>(pts, lanes, steps, p, flat, out1,
                                                              out2);
      break;
    case MODE_DEPTH:
      map_emit_kernel<MODE_DEPTH><<<blocks, threads, 0, s>>>(pts, lanes, steps, p, flat, out1,
                                                             out2);
      break;
    case MODE_EXACT:
      map_emit_kernel<MODE_EXACT><<<blocks, threads, 0, s>>>(pts, lanes, steps, p, flat, out1,
                                                             out2);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
