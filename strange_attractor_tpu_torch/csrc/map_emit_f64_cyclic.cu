// Kernel A's float64 compute path for Halvorsen and Thomas (with the port's
// own sin_f64), in a source of its own so that nvcc builds it beside the
// other sources of kernel A (map_emit_f64.cu says more).

#include "map_emit.cuh"

template SAT_MAP_EMIT_LAUNCH(double, MAP_HALVORSEN);
template SAT_MAP_EMIT_LAUNCH(double, MAP_THOMAS);
