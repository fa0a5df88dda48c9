// Per-frame projection of a shared-orbit point stream (kernel P).
//
// Replaces: the XLA fusion of the JAX package's _project_emit
// (strange_attractor_tpu/render.py:246-266) inside the frame scan of
// _canvas_body_shared (:1281-1353). The TPU has no Pallas kernel here; XLA
// fused the projection into the frame's bin program. Eager PyTorch would
// launch about twenty small kernels per frame and chunk, so the GPU needs
// its own.
//
// What it computes: one thread per point of the frame-invariant stream that
// map_emit.cu's shared modes wrote (xc, zc, fj, and val unless DEPTH). With
// the frame's camera angle it forms
//   x2 = xc * cos + zc * sin,  z2 = xc * sin - zc * cos,
//   fi = (0.5/scale - x2) * width*scale,
// the only angle-dependent math of a map step (src/lib.rs:776-786), then
// ends the point as the fused step does (emit_common.cuh): the bounds check
// (NaN to pixel (0, 0)), NaN z to -inf, and the payload of the planes kind:
//   MODE_PACKED: flat, packed (pack_zv of z and val);
//   MODE_DEPTH:  flat, z;
//   MODE_EXACT:  flat, z. The val stream goes to the bin unchanged: the
//                wrapper hands the shared val tensor on instead of a copy.
// The expressions are map_emit.cu's, term for term, built with -fmad=false,
// so the frame stream is bit-identical to the fused stream at that angle.
//
// The emission gate of lane reseeding (_project_emit's gate input,
// render.py:261) rides the shared stream as fj = +inf, which kernel A writes
// for a point whose lane re-warms: it fails the bounds check, so the point
// goes to npix (dropped) whatever its other coordinates, a NaN's included.
//
// The float64 compute path (T = double, sat_project_emit_f64) reads the
// shared stream in double, computes in double and casts z and val to float
// at emission as _finish_emit does (render.py:192-196); its EXACT frame
// writes that float val stream (out2), where the float path hands the
// shared val tensor on.
//
// What bounds it on the H100: bytes. It reads 12 (DEPTH, EXACT) or 16
// (PACKED) bytes per point and writes 8: about 80 MB for a 3.3M-point chunk,
// some 25 us at the card's 3.35 TB/s, plus the launch. Loads and stores are
// coalesced, one point per thread in a grid-stride loop. Fusing it into the
// bin kernel would save the 8-byte round trip; that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "emit_common.cuh"

enum { MODE_PACKED = 1, MODE_DEPTH = 2, MODE_EXACT = 3 };

template <typename T, int MODE>
__global__ void project_emit_kernel(long long n, EmitParamsT<T> p, const T* __restrict__ xc,
                                    const T* __restrict__ zc, const T* __restrict__ fj,
                                    const T* __restrict__ val, int* __restrict__ flat,
                                    unsigned* __restrict__ out1, float* __restrict__ out2) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    T a = xc[i], c = zc[i];
    T x2 = a * p.cos_v + c * p.sin_v;
    float z2 = (float)nan_to_neg_inf<T>(a * p.sin_v - c * p.cos_v);
    T fi = (p.mid - x2) * p.wscaled;
    flat[i] = pixel_index<T>(fi, fj[i], p.width, p.height);
    if (MODE == MODE_PACKED) {
      out1[i] = pack_zv(z2, (float)val[i]);
    } else {
      out1[i] = __float_as_uint(z2);
      if (MODE == MODE_EXACT) out2[i] = (float)val[i];
    }
  }
}

template <typename T, int MODE>
static int launch(long long n, const EmitParamsT<T>& p, const T* xc, const T* zc, const T* fj,
                  const T* val, int* flat, unsigned* out1, float* out2, void* stream) {
  const int threads = 256;
  long long want = (n + threads - 1) / threads;
  int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  cudaStream_t s = (cudaStream_t)stream;
  project_emit_kernel<T, MODE><<<blocks, threads, 0, s>>>(n, p, xc, zc, fj, val, flat, out1, out2);
  return (int)cudaGetLastError();
}

// val: the shared value stream (read by MODE_PACKED only); out1: packed
// (u32) or z (f32 bits)
extern "C" int sat_project_emit(long long n, int mode, EmitParams p, const float* xc,
                                const float* zc, const float* fj, const float* val, int* flat,
                                unsigned* out1, void* stream) {
  switch (mode) {
    case MODE_PACKED:
      return launch<float, MODE_PACKED>(n, p, xc, zc, fj, val, flat, out1, nullptr, stream);
    case MODE_DEPTH:
    case MODE_EXACT:  // a float EXACT frame is a DEPTH one: the bin takes the shared val as is
      return launch<float, MODE_DEPTH>(n, p, xc, zc, fj, val, flat, out1, nullptr, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The float64 shared stream; out2: MODE_EXACT's float val stream
extern "C" int sat_project_emit_f64(long long n, int mode, EmitParams64 p, const double* xc,
                                    const double* zc, const double* fj, const double* val,
                                    int* flat, unsigned* out1, float* out2, void* stream) {
  switch (mode) {
    case MODE_PACKED:
      return launch<double, MODE_PACKED>(n, p, xc, zc, fj, val, flat, out1, out2, stream);
    case MODE_DEPTH:
      return launch<double, MODE_DEPTH>(n, p, xc, zc, fj, val, flat, out1, out2, stream);
    case MODE_EXACT:
      if (!out2) return (int)cudaErrorInvalidValue;
      return launch<double, MODE_EXACT>(n, p, xc, zc, fj, val, flat, out1, out2, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
