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
//
// The shared-orbit modes emit instead the frame-invariant half of a step,
// the counterpart of _step_fn_shared (render.py:199-243), for a rotation
// sequence whose frames all bin one orbit; project_emit.cu finishes any
// frame from it:
//   MODE_SHARED:       xc = sx + cc.x, zc = sz + cc.y,
//                      fj = H/2 - (sy + cc.z) * width*scale, val (f32 each);
//   MODE_SHARED_DEPTH: xc, zc, fj.
// They are the fused modes' own expressions, so the frame stream comes out
// bit-identical to the fused one at the same angle.
// The mode is a template parameter: one branch-free loop per mode.

// What bounds it on the H100: a long dependent float32 chain per thread
// (~90 flops per step, plus an IEEE sqrt and two IEEE divisions) at one
// lane per thread; 32768 lanes give only ~250 threads per SM, so latency,
// not bandwidth, bounds it. The stores (8 bytes per point, 32 MB per 4M-point
// chunk) are coalesced across lanes. The design keeps every intermediate
// in registers; filling the card better (more lanes, or ILP across several
// lanes per thread) is later work. The shared modes store 16 bytes per
// point (four f32 streams), also coalesced.
//
// Rounding contract: built with -fmad=false, so every multiply and add
// rounds on its own exactly like the plain PyTorch twin (ops/emit.py),
// whose eager ops never contract; '/' and sqrtf stay IEEE (no fast math).
// Constants that JAX folds in float64 before rounding to float32 are
// written as (float)(double expression) for the same rounding.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "emit_common.cuh"

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

enum { MODE_NONE = 0, MODE_PACKED = 1, MODE_DEPTH = 2, MODE_EXACT = 3, MODE_SHARED = 4,
       MODE_SHARED_DEPTH = 5 };

// o0..o3: the mode's streams. Fused modes: flat (int32), packed (u32) or
// z (f32 bits), val (MODE_EXACT). Shared modes: xc, zc, fj, val (f32).
template <int MODE>
__global__ void map_emit_kernel(float* __restrict__ pts, int lanes, int steps, EmitParams p,
                                void* __restrict__ o0, void* __restrict__ o1,
                                void* __restrict__ o2, void* __restrict__ o3) {
  constexpr bool SHARED = MODE == MODE_SHARED || MODE == MODE_SHARED_DEPTH;
  constexpr bool HAS_VAL = MODE == MODE_PACKED || MODE == MODE_EXACT || MODE == MODE_SHARED;
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  float x = pts[lane], y = pts[lanes + lane], z = pts[2 * lanes + lane];
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
      // projection operands with the cc.y <-> z quirk (src/lib.rs:776-786)
      float xc = sx + p.ccx;
      float zc = sz + p.ccy;
      float fj = p.half_h - (sy + p.ccz) * p.wscaled;
      // color transform on delta = new - previous point; a depth stream
      // carries no value
      float val = 0.0f;
      if (HAS_VAL) {
        float dx = nx - x, dy = ny - y, dz = nz - z;
        float mag = sqrtf(dx * dx + dy * dy + dz * dz);
        if (p.transform == 0) {
          float t = xc * (float)0.7009092642998509 + zc * (float)0.7132504491541816;
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
      if (SHARED) {
        ((float*)o0)[out] = xc;
        ((float*)o1)[out] = zc;
        ((float*)o2)[out] = fj;
        if (HAS_VAL) ((float*)o3)[out] = val;
      } else {
        float x2 = xc * p.cos_v + zc * p.sin_v;
        float z2 = nan_to_neg_inf(xc * p.sin_v - zc * p.cos_v);
        float fi = (p.mid - x2) * p.wscaled;
        ((int*)o0)[out] = pixel_index(fi, fj, p.width, p.height);
        if (MODE == MODE_PACKED) {
          ((unsigned*)o1)[out] = pack_zv(z2, val);
        } else {
          ((float*)o1)[out] = z2;
          if (MODE == MODE_EXACT) ((float*)o2)[out] = val;
        }
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

template <int MODE>
static void launch(float* pts, int lanes, int steps, const EmitParams& p, void* o0, void* o1,
                   void* o2, void* o3, cudaStream_t s) {
  const int threads = 128;
  int blocks = (lanes + threads - 1) / threads;
  map_emit_kernel<MODE><<<blocks, threads, 0, s>>>(pts, lanes, steps, p, o0, o1, o2, o3);
}

extern "C" int sat_map_emit(float* pts, int lanes, int steps, int mode, EmitParams p, void* o0,
                            void* o1, void* o2, void* o3, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case MODE_NONE: launch<MODE_NONE>(pts, lanes, steps, p, o0, o1, o2, o3, s); break;
    case MODE_PACKED: launch<MODE_PACKED>(pts, lanes, steps, p, o0, o1, o2, o3, s); break;
    case MODE_DEPTH: launch<MODE_DEPTH>(pts, lanes, steps, p, o0, o1, o2, o3, s); break;
    case MODE_EXACT: launch<MODE_EXACT>(pts, lanes, steps, p, o0, o1, o2, o3, s); break;
    case MODE_SHARED: launch<MODE_SHARED>(pts, lanes, steps, p, o0, o1, o2, o3, s); break;
    case MODE_SHARED_DEPTH:
      launch<MODE_SHARED_DEPTH>(pts, lanes, steps, p, o0, o1, o2, o3, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
