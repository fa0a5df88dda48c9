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
// What bounds it on the H100: bytes. It reads 12 (DEPTH, EXACT) or 16
// (PACKED) bytes per point and writes 8: about 80 MB for a 3.3M-point chunk,
// some 25 us at the card's 3.35 TB/s, plus the launch. Loads and stores are
// coalesced, one point per thread in a grid-stride loop. Fusing it into the
// bin kernel would save the 8-byte round trip; that is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "emit_common.cuh"

enum { MODE_PACKED = 1, MODE_DEPTH = 2, MODE_EXACT = 3 };

template <int MODE>
__global__ void project_emit_kernel(long long n, EmitParams p, const float* __restrict__ xc,
                                    const float* __restrict__ zc, const float* __restrict__ fj,
                                    const float* __restrict__ val, int* __restrict__ flat,
                                    unsigned* __restrict__ out1) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float a = xc[i], c = zc[i];
    float x2 = a * p.cos_v + c * p.sin_v;
    float z2 = nan_to_neg_inf(a * p.sin_v - c * p.cos_v);
    float fi = (p.mid - x2) * p.wscaled;
    flat[i] = pixel_index(fi, fj[i], p.width, p.height);
    if (MODE == MODE_PACKED) {
      out1[i] = pack_zv(z2, val[i]);
    } else {
      out1[i] = __float_as_uint(z2);
    }
  }
}

// val: the shared value stream (read by MODE_PACKED only); out1: packed
// (u32) or z (f32 bits)
extern "C" int sat_project_emit(long long n, int mode, EmitParams p, const float* xc,
                                const float* zc, const float* fj, const float* val, int* flat,
                                unsigned* out1, void* stream) {
  const int threads = 256;
  long long want = (n + threads - 1) / threads;
  int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case MODE_PACKED:
      project_emit_kernel<MODE_PACKED><<<blocks, threads, 0, s>>>(n, p, xc, zc, fj, val, flat,
                                                                  out1);
      break;
    case MODE_DEPTH:
    case MODE_EXACT:
      project_emit_kernel<MODE_DEPTH><<<blocks, threads, 0, s>>>(n, p, xc, zc, fj, val, flat,
                                                                 out1);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
