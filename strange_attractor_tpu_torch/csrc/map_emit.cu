// Kernel A for the Sprott map in float, and its C entry points for every
// map in both compute types: the kernels are map_emit.cuh's; the other
// (type, map) pairs are instantiated by map_emit_rk4.cu,
// map_emit_rk4_cyclic.cu, map_emit_f64.cu and map_emit_f64_cyclic.cu, each
// compiled in a process of its own.

#include "map_emit.cuh"

template SAT_MAP_EMIT_LAUNCH(float, MAP_SPROTT);

template <typename T>
static int dispatch(T* pts, int lanes, int steps, int mode, const EmitParamsT<T>& p,
                    const Reseed& r, void* o0, void* o1, void* o2, void* o3, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (p.map) {
    case MAP_SPROTT:
      return map_emit_launch<T, MAP_SPROTT>(pts, lanes, steps, mode, p, r, o0, o1, o2, o3, s);
    case MAP_LORENZ:
      return map_emit_launch<T, MAP_LORENZ>(pts, lanes, steps, mode, p, r, o0, o1, o2, o3, s);
    case MAP_ROSSLER:
      return map_emit_launch<T, MAP_ROSSLER>(pts, lanes, steps, mode, p, r, o0, o1, o2, o3, s);
    case MAP_HALVORSEN:
      return map_emit_launch<T, MAP_HALVORSEN>(pts, lanes, steps, mode, p, r, o0, o1, o2, o3, s);
    case MAP_THOMAS:
      return map_emit_launch<T, MAP_THOMAS>(pts, lanes, steps, mode, p, r, o0, o1, o2, o3, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// pts: the (3, lanes) lane state in float; r.age null: no reseeding
extern "C" int sat_map_emit(float* pts, int lanes, int steps, int mode, EmitParams p, Reseed r,
                            void* o0, void* o1, void* o2, void* o3, void* stream) {
  return dispatch<float>(pts, lanes, steps, mode, p, r, o0, o1, o2, o3, stream);
}

// the float64 compute path: pts in double, the shared modes' streams in
// double, the fused modes' z and val in float
extern "C" int sat_map_emit_f64(double* pts, int lanes, int steps, int mode, EmitParams64 p,
                                Reseed r, void* o0, void* o1, void* o2, void* o3, void* stream) {
  return dispatch<double>(pts, lanes, steps, mode, p, r, o0, o1, o2, o3, stream);
}
