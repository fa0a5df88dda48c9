// Kernel A for the Sprott map, and its C entry point for every map: the
// kernels are map_emit.cuh's; map_emit_rk4.cu compiles the RK4 maps'
// instantiations in a process of its own.

#include "map_emit.cuh"

template int map_emit_launch<MAP_SPROTT>(float*, int, int, int, const EmitParams&, void*, void*,
                                         void*, void*, cudaStream_t);

extern "C" int sat_map_emit(float* pts, int lanes, int steps, int mode, EmitParams p, void* o0,
                            void* o1, void* o2, void* o3, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (p.map) {
    case MAP_SPROTT:
      return map_emit_launch<MAP_SPROTT>(pts, lanes, steps, mode, p, o0, o1, o2, o3, s);
    case MAP_LORENZ:
      return map_emit_launch<MAP_LORENZ>(pts, lanes, steps, mode, p, o0, o1, o2, o3, s);
    case MAP_ROSSLER:
      return map_emit_launch<MAP_ROSSLER>(pts, lanes, steps, mode, p, o0, o1, o2, o3, s);
    case MAP_HALVORSEN:
      return map_emit_launch<MAP_HALVORSEN>(pts, lanes, steps, mode, p, o0, o1, o2, o3, s);
    case MAP_THOMAS:
      return map_emit_launch<MAP_THOMAS>(pts, lanes, steps, mode, p, o0, o1, o2, o3, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
