// Kernel A's float64 compute path (Config.dtype="float64") for the Sprott
// map, Lorenz and Rossler: map_emit.cuh's kernels instantiated in double, in
// every emission mode, gated and not, in a source of its own so that nvcc
// builds it beside the other sources of kernel A. sat_map_emit_f64
// (map_emit.cu) dispatches to them by EmitParams64.map.

#include "map_emit.cuh"

template SAT_MAP_EMIT_LAUNCH(double, MAP_SPROTT);
template SAT_MAP_EMIT_LAUNCH(double, MAP_LORENZ);
template SAT_MAP_EMIT_LAUNCH(double, MAP_ROSSLER);
