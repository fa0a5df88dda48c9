// Fused map + emit chunk kernel (kernel A): the kernels, templated on the
// compute type (float or double), the map, the emission mode and the
// emission gate. map_emit.cu instantiates them for the Sprott map in float
// and holds the C entry points; map_emit_rk4.cu, map_emit_rk4_cyclic.cu,
// map_emit_f64.cu and map_emit_f64_cyclic.cu instantiate the other
// (type, map) pairs, so that the sources build in parallel.
//
// Replaces: the XLA fusion of the JAX package's lax.scan over _step_fn
// (strange_attractor_tpu/render.py:130-196, :410-429) and _seed_warm's
// fori_loop (:394-407). The TPU has no Pallas kernel here; XLA fused the
// scan into one device program. Eager PyTorch would launch ~50 small kernels
// per map step (~6,400 per 128-step chunk), so the GPU needs its own.
//
// What it computes: per trajectory lane, the point (x, y, z) is read once,
// carried in registers through `steps` map steps, and written back. Each
// step runs the map, the view rotation, the camera
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
// The mode is a template parameter: one branch-free body per mode. So is
// the map (MAP_SPROTT, the reference's polynomial map, or one of the JAX
// package's fixed-step RK4 maps, strange_attractor_tpu/models/
// attractors.py:103-244): a branch in the step loop would tax the Sprott
// path. An RK4 step evaluates the derivative four times, in the plain
// twin's order (models/attractors.py _RK4Ode); Thomas' sine is sin_f32,
// the twin's own float32 sine.
//
// Design. The only step-to-step dependency is the map; the emission
// (rotation, projection, an IEEE sqrtf, the IEEE division by (float)0.9,
// pack_zv, pixel_index, the stores) carries nothing. Two kernels use that,
// chosen by how well the lanes fill the card:
//   - map_emit_ilp_kernel, from ILP_MIN_LANES_PER_SM lanes an SM (the
//     flagship's 32768): one thread per lane advances KA = 8 steps through
//     the map alone, keeping the KA + 1 points, then emits the KA points,
//     which depend on nothing but those: KA-way independent work per thread.
//   - map_emit_kernel (the ring), below that (the rotation cell's 2048
//     lanes, a ragged 1000): a block is one producer warp and EMITTERS = 3
//     emitting warps, one warp per SM sub-partition, so the producer has a
//     scheduler of its own. The producer advances the block's LB lanes
//     (32 from two blocks an SM, else 16) K = 24 steps through the map and
//     writes the K + 1 points of the tile (the point before it, then each
//     new one) to ring[b] in shared memory; the emitters emit the tile's
//     LB * K points from ring[b] (the delta is new minus previous) while the
//     producer fills ring[b ^ 1]. Named barriers (barrier.arrive / .sync)
//     pass each buffer back and forth.
// The stores stay coalesced in the step-major order out[s*lanes + lane]:
// a warp writes consecutive lanes of one step (or two, at LB = 16). Ragged
// steps (a partial batch or tile) and ragged lanes are masked. The warm-up
// (MODE_NONE) emits nothing and keeps one thread per lane.
//
// What bounds it on the H100 (NVIDIA H100 80GB HBM3, 700 W; perf_probe.py
// and chip_smoke.py, PERF.md): at the flagship shape (32768 lanes x 128
// steps, 4.2M points) the issue rate. A point costs ~120 single-rounded
// float32 ops (-fmad=false: no FMA pairs them) plus the IEEE sqrt and
// division sequences, ~230 instructions, ~33 us of the SMs' issue slots
// against a 10 us byte bound (8 B a point); 0.041 ms, where one thread per
// lane stepping one point at a time took 0.045. At the rotation cell's
// shape (2048 lanes x 1628 steps) the map's dependent chain: 1628 steps
// of ~64 instructions, ~11 of them dependent, on one scheduler, against a
// 16 us byte bound; 0.076 ms, where the one-thread-per-lane kernel, 16
// blocks on 132 SMs, took 0.243. The RK4 maps' PACKED chunk at the
// flagship shape: Lorenz 0.035 ms, Rossler 0.037, Halvorsen 0.044, Thomas
// 0.109 (twelve sin_f32 a step, ~535 ops a point against an operations
// bound of 0.034 ms). The gated PACKED chunk 0.042 ms (+2% on the ungated
// 0.041). In double at the flagship shape: PACKED 0.064 ms, DEPTH 0.035,
// EXACT 0.058, SHARED 0.052 against bounds of 0.016 (operations at the
// FP64 peak, 33.5 TFLOP/s), 0.012, 0.016 and 0.041 (bytes); Lorenz PACKED
// 0.047; at most 118 registers, no spills.

// Compute type. T = double is the float64 path (Config.dtype="float64", the
// JAX package's _dtype, render.py:48-57): the map, rotation, projection and
// color transform in double, the bounds check and the int cast of fi/fj in
// double, and z and the value cast to float only at emission, where
// _finish_emit casts them (render.py:192-196). The shared modes then write
// xc, zc, fj and val in double. Thomas' sine is sin_f64, the twin's own.
//
// Lane reseeding (Config.reseed_lanes; _reseed_dead_lanes,
// render.py:278-298, and the gate age > 0, :155-157). With GATE the thread
// that owns a lane reseeds it at the start of the launch (reseed_lane,
// emit_common.cuh: a dead lane takes the counter-based fresh point of the
// render key, the chunk and the lane, and age -warmup), then each step does
// age = min(age + 1, 1) and emits only while age > 0: a gated point goes
// to flat = npix even when its coordinates are NaN, and in the shared modes
// it is marked by fj = +inf, which fails project_emit.cu's bounds check
// the same way. The ILP kernel's thread derives a step's gate from the age
// at the start of its batch; in the ring the producer warp owns the lane
// and writes its age at the start of each tile beside the tile's points,
// from which the emitting warps derive each step's gate. GATE is a template
// parameter: with reseeding off the kernels are the code without it.
//
// Rounding contract: built with -fmad=false, so every multiply and add
// rounds on its own exactly like the plain PyTorch twin (ops/emit.py),
// whose eager ops never contract; '/' and sqrt stay IEEE (no fast math).
// Constants that JAX folds in float64 before rounding to float32 are
// written as (T)(double expression) for the same rounding.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#pragma once

#include "emit_common.cuh"

enum { MAP_SPROTT = 0, MAP_LORENZ = 1, MAP_ROSSLER = 2, MAP_HALVORSEN = 3, MAP_THOMAS = 4 };

__device__ __forceinline__ float sqrt_t(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_t(double v) { return sqrt(v); }

// sum of coefficient * monomial over [1, x, x^2, xy, xz, y, y^2, yz, z, z^2]
// in the reference's term order (src/lib.rs:588-613); c[0] * 1 is c[0]
template <typename T>
__device__ __forceinline__ T sprott_dot(const T* c, T x, T y, T z) {
  T acc = c[0] + c[1] * x;
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

// The port's float32 sine (models/attractors.py sin_f32, same operations,
// each rounded once): k = floor(x * 2/pi + 0.5); r = x - k * pi/2 in three
// parts (Cody-Waite; k * C1 and k * C2 exact for |k| < 2^13); the Cephes
// sinf/cosf polynomials on r; the quadrant k mod 4 picks sin, cos, -sin or
// -cos. NaN and inf give NaN.
__device__ __forceinline__ float sin_t(float x) {
  const float two_over_pi = (float)(2.0 / 3.141592653589793);
  const float c1 = 1.5703125f, c2 = 4.837512969970703125e-4f;
  const float c3 = (float)(3.141592653589793 / 2 - 1.5703125 - 4.837512969970703125e-4);
  float k = floorf(x * two_over_pi + 0.5f);
  float r = ((x - k * c1) - k * c2) - k * c3;
  float q = k - 4.0f * floorf(k * 0.25f);  // k mod 4, exact; NaN for infinite k
  float z = r * r;
  float s = (((float)-1.9515295891e-4 * z + (float)8.3321608736e-3) * z +
             (float)-1.6666654611e-1) * z * r + r;
  float c = ((((float)2.443315711809948e-5 * z + (float)-1.388731625493765e-3) * z +
              (float)4.166664568298827e-2) * z * z - 0.5f * z) + 1.0f;
  float v = (q == 1.0f || q == 3.0f) ? c : s;
  return q >= 2.0f ? -v : v;
}

// The port's float64 sine (models/attractors.py sin_f64, same operations):
// the reduction by pi/2 in three parts of 33, 33 and 53 bits (fdlibm's
// pio2_1, pio2_2, pio2_2t; k * C1 and k * C2 exact for |k| < 2^20), then
// Cephes' double polynomials, sin r = r + (r z) P(z), cos r = (1 - z/2) +
// z^2 Q(z) with z = r^2, in Horner form from the highest coefficient.
__device__ __forceinline__ double sin_t(double x) {
  const double two_over_pi = 2.0 / 3.141592653589793;
  const double c1 = 1.57079632673412561417e+00, c2 = 6.07710050630396597660e-11;
  const double c3 = 2.02226624879595063154e-21;
  double k = floor(x * two_over_pi + 0.5);
  double r = ((x - k * c1) - k * c2) - k * c3;
  double q = k - 4.0 * floor(k * 0.25);
  double z = r * r;
  double ps = ((((1.58962301576546568060e-10 * z + -2.50507477628578072866e-8) * z +
                 2.75573136213857245213e-6) * z + -1.98412698295895385996e-4) * z +
               8.33333333332211858878e-3) * z + -1.66666666666666307295e-1;
  double pc = ((((-1.13585365213876817300e-11 * z + 2.08757008419747316778e-9) * z +
                 -2.75573141792967388112e-7) * z + 2.48015872888517045348e-5) * z +
               -1.38888888888730564116e-3) * z + 4.16666666666665929218e-2;
  double s = r + (r * z) * ps;
  double c = (1.0 - 0.5 * z) + (z * z) * pc;
  double v = (q == 1.0 || q == 3.0) ? c : s;
  return q >= 2.0 ? -v : v;
}

// An RK4 map's derivative at (x, y, z), in the twin's term order; p.mc holds
// its constants in T.
template <typename T, int MAP>
__device__ __forceinline__ void rk4_deriv(const EmitParamsT<T>& p, T x, T y, T z, T& dx, T& dy,
                                          T& dz) {
  if constexpr (MAP == MAP_LORENZ) {  // sigma (y - x), x (rho - z) - y, x y - beta z
    dx = p.mc[0] * (y - x);
    dy = x * (p.mc[1] - z) - y;
    dz = x * y - p.mc[2] * z;
  } else if constexpr (MAP == MAP_ROSSLER) {  // -y - z, x + a y, b + z (x - c)
    dx = -y - z;
    dy = x + p.mc[0] * y;
    dz = p.mc[1] + z * (x - p.mc[2]);
  } else if constexpr (MAP == MAP_HALVORSEN) {  // -a x - 4y - 4z - y^2, cyclic
    const T na = -p.mc[0], four = (T)4;
    dx = na * x - four * y - four * z - y * y;
    dy = na * y - four * z - four * x - z * z;
    dz = na * z - four * x - four * y - x * x;
  } else {  // MAP_THOMAS: sin(y) - b x, cyclic
    dx = sin_t(y) - p.mc[0] * x;
    dy = sin_t(z) - p.mc[0] * y;
    dz = sin_t(x) - p.mc[0] * z;
  }
}

// One RK4 step: stage points x + (0.5 h) k, the last x + h k, and the step
// x + (h/6) (((k1 + 2 k2) + 2 k3) + k4), with h, 0.5 h and h/6 constants in
// T from the host (p.h, p.hh, p.h6).
template <typename T, int MAP>
__device__ __forceinline__ void rk4_step(const EmitParamsT<T>& p, T x, T y, T z, T& nx, T& ny,
                                         T& nz) {
  const T two = (T)2;
  T kx, ky, kz, sx, sy, sz;
  rk4_deriv<T, MAP>(p, x, y, z, kx, ky, kz);
  sx = kx, sy = ky, sz = kz;
  rk4_deriv<T, MAP>(p, x + p.hh * kx, y + p.hh * ky, z + p.hh * kz, kx, ky, kz);
  sx = sx + two * kx, sy = sy + two * ky, sz = sz + two * kz;
  rk4_deriv<T, MAP>(p, x + p.hh * kx, y + p.hh * ky, z + p.hh * kz, kx, ky, kz);
  sx = sx + two * kx, sy = sy + two * ky, sz = sz + two * kz;
  rk4_deriv<T, MAP>(p, x + p.h * kx, y + p.h * ky, z + p.h * kz, kx, ky, kz);
  nx = x + p.h6 * (sx + kx);
  ny = y + p.h6 * (sy + ky);
  nz = z + p.h6 * (sz + kz);
}

// One step of the map from (x, y, z).
template <typename T, int MAP>
__device__ __forceinline__ void map_step(const EmitParamsT<T>& p, T x, T y, T z, T& nx, T& ny,
                                         T& nz) {
  if constexpr (MAP == MAP_SPROTT) {
    nx = sprott_dot<T>(p.coef, x, y, z);
    ny = sprott_dot<T>(p.coef + 10, x, y, z);
    nz = sprott_dot<T>(p.coef + 20, x, y, z);
  } else {
    rk4_step<T, MAP>(p, x, y, z, nx, ny, nz);
  }
}

enum { MODE_NONE = 0, MODE_PACKED = 1, MODE_DEPTH = 2, MODE_EXACT = 3, MODE_SHARED = 4,
       MODE_SHARED_DEPTH = 5 };

// One emitted point: the step from (x, y, z) to (nx, ny, nz), written at
// stream index `out`; `live` is the emission gate (always true without
// GATE). o0..o3: the mode's streams. Fused modes: flat (int32), packed
// (u32) or z (f32 bits), val (MODE_EXACT, f32). Shared modes: xc, zc, fj,
// val (T).
template <typename T, int MODE, bool GATE>
__device__ __forceinline__ void emit_point(const EmitParamsT<T>& p, T x, T y, T z, T nx, T ny,
                                           T nz, size_t out, bool live, void* __restrict__ o0,
                                           void* __restrict__ o1, void* __restrict__ o2,
                                           void* __restrict__ o3) {
  constexpr bool SHARED = MODE == MODE_SHARED || MODE == MODE_SHARED_DEPTH;
  constexpr bool HAS_VAL = MODE == MODE_PACKED || MODE == MODE_EXACT || MODE == MODE_SHARED;
  // view rotation, rows as (m0*x + m1*y) + m2*z
  T sx = p.rot[0] * nx + p.rot[1] * ny + p.rot[2] * nz;
  T sy = p.rot[3] * nx + p.rot[4] * ny + p.rot[5] * nz;
  T sz = p.rot[6] * nx + p.rot[7] * ny + p.rot[8] * nz;
  // projection operands with the cc.y <-> z quirk (src/lib.rs:776-786)
  T xc = sx + p.ccx;
  T zc = sz + p.ccy;
  T fj = p.half_h - (sy + p.ccz) * p.wscaled;
  // color transform on delta = new - previous point; a depth stream
  // carries no value
  T val = (T)0;
  if (HAS_VAL) {
    T dx = nx - x, dy = ny - y, dz = nz - z;
    T mag = sqrt_t(dx * dx + dy * dy + dz * dz);
    if (p.transform == 0) {
      T t = xc * (T)0.7009092642998509 + zc * (T)0.7132504491541816;
      bool outside = (t < (T)-0.0839) ||
                     ((T)10.55 * t + sy < (T)(0.46 - 1.0941)) ||
                     ((T)1.0426 * t + sy < (T)(0.179 - 0.1576)) ||
                     ((T)0.5139 * t - sy > (T)(-0.04 - 0.04092));
      T color = ((outside ? (T)0 : (T)1) + mag) / (T)2;
      val = (color - (T)0.1) / (T)0.9;
    } else {
      val = (mag + p.t_offset) * p.t_factor;
    }
  }
  if (SHARED) {
    ((T*)o0)[out] = xc;
    ((T*)o1)[out] = zc;
    ((T*)o2)[out] = (GATE && !live) ? (T)INFINITY : fj;
    if (HAS_VAL) ((T*)o3)[out] = val;
  } else {
    T x2 = xc * p.cos_v + zc * p.sin_v;
    float z2 = (float)nan_to_neg_inf<T>(xc * p.sin_v - zc * p.cos_v);
    T fi = (p.mid - x2) * p.wscaled;
    int flat = pixel_index<T>(fi, fj, p.width, p.height);
    ((int*)o0)[out] = (GATE && !live) ? p.width * p.height : flat;
    if (MODE == MODE_PACKED) {
      ((unsigned*)o1)[out] = pack_zv(z2, (float)val);
    } else {
      ((float*)o1)[out] = z2;
      if (MODE == MODE_EXACT) ((float*)o2)[out] = (float)val;
    }
  }
}

// The warm-up (MODE_NONE): one thread per lane walks `steps` map steps.
template <typename T, int MAP>
__global__ void map_kernel(T* __restrict__ pts, int lanes, int steps, EmitParamsT<T> p) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  T x = pts[lane], y = pts[lanes + lane], z = pts[2 * lanes + lane];
  for (int s = 0; s < steps; ++s) {
    T nx, ny, nz;
    map_step<T, MAP>(p, x, y, z, nx, ny, nz);
    x = nx;
    y = ny;
    z = nz;
  }
  pts[lane] = x;
  pts[lanes + lane] = y;
  pts[2 * lanes + lane] = z;
}

// The emitting modes when the lanes fill the card: one thread per lane
// advances KA steps through the map alone, then emits the KA points, which
// depend on nothing but those KA + 1 points: KA-way independent work. With
// GATE, step k of a batch emits iff min(age + k + 1, 1) > 0 for the lane's
// age at the batch's start.
constexpr int KA = 8;
constexpr int ILP_THREADS = 64;

template <typename T, int MAP, int MODE, bool GATE>
__global__ void __launch_bounds__(ILP_THREADS)
    map_emit_ilp_kernel(T* __restrict__ pts, int lanes, int steps, EmitParamsT<T> p, Reseed r,
                        void* __restrict__ o0, void* __restrict__ o1, void* __restrict__ o2,
                        void* __restrict__ o3) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  T x = pts[lane], y = pts[lanes + lane], z = pts[2 * lanes + lane];
  int age = 0;
  if (GATE) age = reseed_lane<T>(r, lane, x, y, z);
  size_t out = lane;
  int s = 0;
  for (; s + KA <= steps; s += KA, out += (size_t)KA * lanes) {
    T px[KA + 1], py[KA + 1], pz[KA + 1];
    px[0] = x, py[0] = y, pz[0] = z;
#pragma unroll
    for (int k = 0; k < KA; ++k)
      map_step<T, MAP>(p, px[k], py[k], pz[k], px[k + 1], py[k + 1], pz[k + 1]);
#pragma unroll
    for (int k = 0; k < KA; ++k)
      emit_point<T, MODE, GATE>(p, px[k], py[k], pz[k], px[k + 1], py[k + 1], pz[k + 1],
                                out + (size_t)k * lanes, age + k + 1 > 0, o0, o1, o2, o3);
    x = px[KA], y = py[KA], z = pz[KA];
    if (GATE) age = min(age + KA, 1);
  }
  for (; s < steps; ++s, out += lanes) {  // the ragged tail, one step at a time
    T nx, ny, nz;
    map_step<T, MAP>(p, x, y, z, nx, ny, nz);
    emit_point<T, MODE, GATE>(p, x, y, z, nx, ny, nz, out, age + 1 > 0, o0, o1, o2, o3);
    x = nx, y = ny, z = nz;
    if (GATE) age = min(age + 1, 1);
  }
  pts[lane] = x;
  pts[lanes + lane] = y;
  pts[2 * lanes + lane] = z;
  if (GATE) r.age[lane] = age;
}

// lanes per SM from which the one-thread-per-lane kernel is faster than the
// ring (a sweep of both over lane counts on the H100, PERF.md)
constexpr int ILP_MIN_LANES_PER_SM = 128;

constexpr int K = 24;        // map steps per ring tile
constexpr int EMITTERS = 3;  // consumer warps per block: with the producer,
                             // one warp per SM sub-partition (scheduler)
constexpr int THREADS = (EMITTERS + 1) * 32;
static_assert(K * 16 % (EMITTERS * 32) == 0, "a full tile splits evenly over the emitters");
// named barriers (0 is __syncthreads'): FULL + b, the producer filled ring
// buffer b; FREE + b, the emitters are done with it
constexpr int FULL = 1, FREE = 3;

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("barrier.arrive %0, %1;" ::"r"(id), "r"(THREADS) : "memory");
}

// Blocks an SM the ring kernel is built for: 32-lane float rings from two
// blocks an SM fit eight (19.2 KB of ring each), double rings four.
template <typename T, int LB>
constexpr int ring_min_blocks() {
  return LB == 32 ? (sizeof(T) == 4 ? 8 : 4) : 1;
}

// The emitting modes: block = 1 producer warp for LB lanes + EMITTERS
// emitting warps, a double-buffered ring of K + 1 points per lane between
// (and with GATE each lane's age at the start of the tile).
template <typename T, int MAP, int MODE, bool GATE, int LB>
__global__ void __launch_bounds__(THREADS, (ring_min_blocks<T, LB>()))
    map_emit_kernel(T* __restrict__ pts, int lanes, int steps, EmitParamsT<T> p, Reseed r,
                    void* __restrict__ o0, void* __restrict__ o1, void* __restrict__ o2,
                    void* __restrict__ o3) {
  __shared__ T ring[2][K + 1][3][LB];
  __shared__ int ring_age[2][GATE ? LB : 1];
  const int lane0 = blockIdx.x * LB;
  const int nl = min(LB, lanes - lane0);
  const int ntiles = (steps + K - 1) / K;
  if (threadIdx.x < 32) {  // the producer warp: the map chain
    const int l = threadIdx.x;
    const bool act = l < nl;
    T x = (T)0, y = (T)0, z = (T)0;
    int age = 0;
    if (act) {
      x = pts[lane0 + l], y = pts[lanes + lane0 + l], z = pts[2 * lanes + lane0 + l];
      if (GATE) age = reseed_lane<T>(r, lane0 + l, x, y, z);
    }
    for (int t = 0; t < ntiles; ++t) {
      const int b = t & 1;
      if (t >= 2) bar_sync(FREE + b);  // wait for the emitters of tile t - 2
      const int kn = min(K, steps - t * K);
      if (act) {
        ring[b][0][0][l] = x, ring[b][0][1][l] = y, ring[b][0][2][l] = z;
        for (int k = 1; k <= kn; ++k) {
          T nx, ny, nz;
          map_step<T, MAP>(p, x, y, z, nx, ny, nz);
          ring[b][k][0][l] = nx, ring[b][k][1][l] = ny, ring[b][k][2][l] = nz;
          x = nx, y = ny, z = nz;
        }
        if (GATE) ring_age[b][l] = age, age = min(age + kn, 1);
      }
      bar_arrive(FULL + b);
    }
    if (act) {
      pts[lane0 + l] = x, pts[lanes + lane0 + l] = y, pts[2 * lanes + lane0 + l] = z;
      if (GATE) r.age[lane0 + l] = age;
    }
    return;
  }
  // the emitting warps: point q of a tile is step q / LB of lane q % LB
  const int e = threadIdx.x - 32;
  constexpr int PER = K * LB / (EMITTERS * 32);  // points per thread of a full tile
  for (int t = 0; t < ntiles; ++t) {
    const int b = t & 1;
    bar_sync(FULL + b);
    const int kn = min(K, steps - t * K);
    const size_t row = (size_t)t * K * lanes + lane0;
    if (kn == K) {
#pragma unroll
      for (int r_ = 0; r_ < PER; ++r_) {
        const int q = e + r_ * EMITTERS * 32, k = q / LB, l = q % LB;
        if (l < nl)
          emit_point<T, MODE, GATE>(
              p, ring[b][k][0][l], ring[b][k][1][l], ring[b][k][2][l], ring[b][k + 1][0][l],
              ring[b][k + 1][1][l], ring[b][k + 1][2][l], row + (size_t)k * lanes + l,
              !GATE || ring_age[b][GATE ? l : 0] + k + 1 > 0, o0, o1, o2, o3);
      }
    } else {
      for (int q = e; q < kn * LB; q += EMITTERS * 32) {
        const int k = q / LB, l = q % LB;
        if (l < nl)
          emit_point<T, MODE, GATE>(
              p, ring[b][k][0][l], ring[b][k][1][l], ring[b][k][2][l], ring[b][k + 1][0][l],
              ring[b][k + 1][1][l], ring[b][k + 1][2][l], row + (size_t)k * lanes + l,
              !GATE || ring_age[b][GATE ? l : 0] + k + 1 > 0, o0, o1, o2, o3);
      }
    }
    if (t + 2 < ntiles) bar_arrive(FREE + b);  // the producer reuses b for tile t + 2
  }
}

template <typename T, int MAP, int MODE, bool GATE>
static void launch(T* pts, int lanes, int steps, const EmitParamsT<T>& p, const Reseed& r,
                   void* o0, void* o1, void* o2, void* o3, cudaStream_t s) {
  if (lanes >= ILP_MIN_LANES_PER_SM * sm_count()) {
    const int blocks = (lanes + ILP_THREADS - 1) / ILP_THREADS;
    map_emit_ilp_kernel<T, MAP, MODE, GATE><<<blocks, ILP_THREADS, 0, s>>>(pts, lanes, steps, p, r,
                                                                           o0, o1, o2, o3);
    return;
  }
  // the ring: 32 lanes a block from two blocks an SM; fewer lanes (the
  // rotation cell's 2048) spread 16 a block over more SMs
  if (lanes >= 64 * sm_count()) {
    map_emit_kernel<T, MAP, MODE, GATE, 32><<<(lanes + 31) / 32, THREADS, 0, s>>>(
        pts, lanes, steps, p, r, o0, o1, o2, o3);
  } else {
    map_emit_kernel<T, MAP, MODE, GATE, 16><<<(lanes + 15) / 16, THREADS, 0, s>>>(
        pts, lanes, steps, p, r, o0, o1, o2, o3);
  }
}

template <typename T, int MAP, int MODE>
static void launch_gated(T* pts, int lanes, int steps, const EmitParamsT<T>& p, const Reseed& r,
                         void* o0, void* o1, void* o2, void* o3, cudaStream_t s) {
  if (r.age)
    launch<T, MAP, MODE, true>(pts, lanes, steps, p, r, o0, o1, o2, o3, s);
  else
    launch<T, MAP, MODE, false>(pts, lanes, steps, p, r, o0, o1, o2, o3, s);
}

// One launch of map MAP in compute type T and emission mode `mode`, gated
// and reseeding when r.age is set (never in the warm-up); returns
// cudaGetLastError().
template <typename T, int MAP>
int map_emit_launch(T* pts, int lanes, int steps, int mode, const EmitParamsT<T>& p,
                    const Reseed& r, void* o0, void* o1, void* o2, void* o3, cudaStream_t s) {
  switch (mode) {
    case MODE_NONE:
      if (r.age) return (int)cudaErrorInvalidValue;
      map_kernel<T, MAP><<<(lanes + 127) / 128, 128, 0, s>>>(pts, lanes, steps, p);
      break;
    case MODE_PACKED:
      launch_gated<T, MAP, MODE_PACKED>(pts, lanes, steps, p, r, o0, o1, o2, o3, s);
      break;
    case MODE_DEPTH:
      launch_gated<T, MAP, MODE_DEPTH>(pts, lanes, steps, p, r, o0, o1, o2, o3, s);
      break;
    case MODE_EXACT:
      launch_gated<T, MAP, MODE_EXACT>(pts, lanes, steps, p, r, o0, o1, o2, o3, s);
      break;
    case MODE_SHARED:
      launch_gated<T, MAP, MODE_SHARED>(pts, lanes, steps, p, r, o0, o1, o2, o3, s);
      break;
    case MODE_SHARED_DEPTH:
      launch_gated<T, MAP, MODE_SHARED_DEPTH>(pts, lanes, steps, p, r, o0, o1, o2, o3, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The declaration of map_emit_launch<T, MAP>, which each source of kernel A
// instantiates for its (type, map) pairs and map_emit.cu's entry points
// call for all of them.
#define SAT_MAP_EMIT_LAUNCH(T, MAP)                                                            \
  int map_emit_launch<T, MAP>(T*, int, int, int, const EmitParamsT<T>&, const Reseed&, void*, \
                              void*, void*, void*, cudaStream_t)

extern template SAT_MAP_EMIT_LAUNCH(float, MAP_SPROTT);
extern template SAT_MAP_EMIT_LAUNCH(float, MAP_LORENZ);
extern template SAT_MAP_EMIT_LAUNCH(float, MAP_ROSSLER);
extern template SAT_MAP_EMIT_LAUNCH(float, MAP_HALVORSEN);
extern template SAT_MAP_EMIT_LAUNCH(float, MAP_THOMAS);
extern template SAT_MAP_EMIT_LAUNCH(double, MAP_SPROTT);
extern template SAT_MAP_EMIT_LAUNCH(double, MAP_LORENZ);
extern template SAT_MAP_EMIT_LAUNCH(double, MAP_ROSSLER);
extern template SAT_MAP_EMIT_LAUNCH(double, MAP_HALVORSEN);
extern template SAT_MAP_EMIT_LAUNCH(double, MAP_THOMAS);
