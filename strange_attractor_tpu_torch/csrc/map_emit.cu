// Fused map + emit chunk kernel (kernel A).
//
// Replaces: the XLA fusion of the JAX package's lax.scan over _step_fn
// (strange_attractor_tpu/render.py:130-196, :410-429) and _seed_warm's
// fori_loop (:394-407). The TPU has no Pallas kernel here; XLA fused the
// scan into one device program. Eager PyTorch would launch ~50 small kernels
// per map step (~6,400 per 128-step chunk), so the GPU needs its own.
//
// What it computes: per trajectory lane, the point (x, y, z) is read once,
// carried in registers through `steps` map steps, and written back. Each
// step runs the Sprott map, the view rotation, the camera
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
// The mode is a template parameter: one branch-free body per mode.
//
// Design. The only step-to-step dependency is the Sprott map; the emission
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
// blocks on 132 SMs, took 0.243.

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

// One emitted point: the step from (x, y, z) to (nx, ny, nz), written at
// stream index `out`. o0..o3: the mode's streams. Fused modes: flat
// (int32), packed (u32) or z (f32 bits), val (MODE_EXACT). Shared modes: xc,
// zc, fj, val (f32).
template <int MODE>
__device__ __forceinline__ void emit_point(const EmitParams& p, float x, float y, float z,
                                           float nx, float ny, float nz, size_t out,
                                           void* __restrict__ o0, void* __restrict__ o1,
                                           void* __restrict__ o2, void* __restrict__ o3) {
  constexpr bool SHARED = MODE == MODE_SHARED || MODE == MODE_SHARED_DEPTH;
  constexpr bool HAS_VAL = MODE == MODE_PACKED || MODE == MODE_EXACT || MODE == MODE_SHARED;
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
}

// The warm-up (MODE_NONE): one thread per lane walks `steps` map steps.
__global__ void map_kernel(float* __restrict__ pts, int lanes, int steps, EmitParams p) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  float x = pts[lane], y = pts[lanes + lane], z = pts[2 * lanes + lane];
  for (int s = 0; s < steps; ++s) {
    float nx = sprott_dot(p.coef, x, y, z);
    float ny = sprott_dot(p.coef + 10, x, y, z);
    float nz = sprott_dot(p.coef + 20, x, y, z);
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
// depend on nothing but those KA + 1 points: KA-way independent work.
constexpr int KA = 8;
constexpr int ILP_THREADS = 64;

template <int MODE>
__global__ void __launch_bounds__(ILP_THREADS)
    map_emit_ilp_kernel(float* __restrict__ pts, int lanes, int steps, EmitParams p,
                        void* __restrict__ o0, void* __restrict__ o1, void* __restrict__ o2,
                        void* __restrict__ o3) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  float x = pts[lane], y = pts[lanes + lane], z = pts[2 * lanes + lane];
  size_t out = lane;
  int s = 0;
  for (; s + KA <= steps; s += KA, out += (size_t)KA * lanes) {
    float px[KA + 1], py[KA + 1], pz[KA + 1];
    px[0] = x, py[0] = y, pz[0] = z;
#pragma unroll
    for (int k = 0; k < KA; ++k) {
      px[k + 1] = sprott_dot(p.coef, px[k], py[k], pz[k]);
      py[k + 1] = sprott_dot(p.coef + 10, px[k], py[k], pz[k]);
      pz[k + 1] = sprott_dot(p.coef + 20, px[k], py[k], pz[k]);
    }
#pragma unroll
    for (int k = 0; k < KA; ++k)
      emit_point<MODE>(p, px[k], py[k], pz[k], px[k + 1], py[k + 1], pz[k + 1],
                       out + (size_t)k * lanes, o0, o1, o2, o3);
    x = px[KA], y = py[KA], z = pz[KA];
  }
  for (; s < steps; ++s, out += lanes) {  // the ragged tail, one step at a time
    float nx = sprott_dot(p.coef, x, y, z);
    float ny = sprott_dot(p.coef + 10, x, y, z);
    float nz = sprott_dot(p.coef + 20, x, y, z);
    emit_point<MODE>(p, x, y, z, nx, ny, nz, out, o0, o1, o2, o3);
    x = nx, y = ny, z = nz;
  }
  pts[lane] = x;
  pts[lanes + lane] = y;
  pts[2 * lanes + lane] = z;
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

// The emitting modes: block = 1 producer warp for LB lanes + EMITTERS
// emitting warps, a double-buffered ring of K + 1 points per lane between.
template <int MODE, int LB>
__global__ void __launch_bounds__(THREADS, LB == 32 ? 8 : 1)
    map_emit_kernel(float* __restrict__ pts, int lanes, int steps, EmitParams p,
                    void* __restrict__ o0, void* __restrict__ o1, void* __restrict__ o2,
                    void* __restrict__ o3) {
  __shared__ float ring[2][K + 1][3][LB];
  const int lane0 = blockIdx.x * LB;
  const int nl = min(LB, lanes - lane0);
  const int ntiles = (steps + K - 1) / K;
  if (threadIdx.x < 32) {  // the producer warp: the map chain
    const int l = threadIdx.x;
    const bool act = l < nl;
    float x = 0.0f, y = 0.0f, z = 0.0f;
    if (act) x = pts[lane0 + l], y = pts[lanes + lane0 + l], z = pts[2 * lanes + lane0 + l];
    for (int t = 0; t < ntiles; ++t) {
      const int b = t & 1;
      if (t >= 2) bar_sync(FREE + b);  // wait for the emitters of tile t - 2
      const int kn = min(K, steps - t * K);
      if (act) {
        ring[b][0][0][l] = x, ring[b][0][1][l] = y, ring[b][0][2][l] = z;
        for (int k = 1; k <= kn; ++k) {
          float nx = sprott_dot(p.coef, x, y, z);
          float ny = sprott_dot(p.coef + 10, x, y, z);
          float nz = sprott_dot(p.coef + 20, x, y, z);
          ring[b][k][0][l] = nx, ring[b][k][1][l] = ny, ring[b][k][2][l] = nz;
          x = nx, y = ny, z = nz;
        }
      }
      bar_arrive(FULL + b);
    }
    if (act) pts[lane0 + l] = x, pts[lanes + lane0 + l] = y, pts[2 * lanes + lane0 + l] = z;
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
      for (int r = 0; r < PER; ++r) {
        const int q = e + r * EMITTERS * 32, k = q / LB, l = q % LB;
        if (l < nl)
          emit_point<MODE>(p, ring[b][k][0][l], ring[b][k][1][l], ring[b][k][2][l],
                           ring[b][k + 1][0][l], ring[b][k + 1][1][l], ring[b][k + 1][2][l],
                           row + (size_t)k * lanes + l, o0, o1, o2, o3);
      }
    } else {
      for (int q = e; q < kn * LB; q += EMITTERS * 32) {
        const int k = q / LB, l = q % LB;
        if (l < nl)
          emit_point<MODE>(p, ring[b][k][0][l], ring[b][k][1][l], ring[b][k][2][l],
                           ring[b][k + 1][0][l], ring[b][k + 1][1][l], ring[b][k + 1][2][l],
                           row + (size_t)k * lanes + l, o0, o1, o2, o3);
      }
    }
    if (t + 2 < ntiles) bar_arrive(FREE + b);  // the producer reuses b for tile t + 2
  }
}

template <int MODE>
static void launch(float* pts, int lanes, int steps, const EmitParams& p, void* o0, void* o1,
                   void* o2, void* o3, cudaStream_t s) {
  if (lanes >= ILP_MIN_LANES_PER_SM * sm_count()) {
    map_emit_ilp_kernel<MODE><<<(lanes + ILP_THREADS - 1) / ILP_THREADS, ILP_THREADS, 0, s>>>(
        pts, lanes, steps, p, o0, o1, o2, o3);
    return;
  }
  // the ring: 32 lanes a block from two blocks an SM; fewer lanes (the
  // rotation cell's 2048) spread 16 a block over more SMs
  if (lanes >= 64 * sm_count()) {
    map_emit_kernel<MODE, 32><<<(lanes + 31) / 32, THREADS, 0, s>>>(pts, lanes, steps, p, o0, o1,
                                                                    o2, o3);
  } else {
    map_emit_kernel<MODE, 16><<<(lanes + 15) / 16, THREADS, 0, s>>>(pts, lanes, steps, p, o0, o1,
                                                                    o2, o3);
  }
}

extern "C" int sat_map_emit(float* pts, int lanes, int steps, int mode, EmitParams p, void* o0,
                            void* o1, void* o2, void* o3, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case MODE_NONE:
      map_kernel<<<(lanes + 127) / 128, 128, 0, s>>>(pts, lanes, steps, p);
      break;
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
