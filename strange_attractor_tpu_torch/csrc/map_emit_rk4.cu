// Kernel A for the JAX package's four RK4 maps (Lorenz, Rossler, Halvorsen,
// Thomas; strange_attractor_tpu/models/attractors.py:103-244): map_emit.cuh's
// kernels instantiated per map, in every emission mode, in a source of its
// own so that nvcc builds it beside map_emit.cu. sat_map_emit (map_emit.cu)
// dispatches to them by EmitParams.map.

#include "map_emit.cuh"

template int map_emit_launch<MAP_LORENZ>(float*, int, int, int, const EmitParams&, void*, void*,
                                         void*, void*, cudaStream_t);
template int map_emit_launch<MAP_ROSSLER>(float*, int, int, int, const EmitParams&, void*, void*,
                                          void*, void*, cudaStream_t);
template int map_emit_launch<MAP_HALVORSEN>(float*, int, int, int, const EmitParams&, void*,
                                            void*, void*, void*, cudaStream_t);
template int map_emit_launch<MAP_THOMAS>(float*, int, int, int, const EmitParams&, void*, void*,
                                         void*, void*, cudaStream_t);
