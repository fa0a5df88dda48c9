// Kernel A for the two cyclically symmetric RK4 maps in float (Halvorsen
// and Thomas), in a source of its own so that nvcc builds it beside the
// other sources of kernel A (map_emit_rk4.cu says more).

#include "map_emit.cuh"

template SAT_MAP_EMIT_LAUNCH(float, MAP_HALVORSEN);
template SAT_MAP_EMIT_LAUNCH(float, MAP_THOMAS);
