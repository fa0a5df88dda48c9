// Kernel A for two of the JAX package's RK4 maps in float (Lorenz and
// Rossler; strange_attractor_tpu/models/attractors.py:103-244):
// map_emit.cuh's kernels instantiated per map, in every emission mode, gated
// and not, in a source of its own so that nvcc builds it beside the other
// sources of kernel A. sat_map_emit (map_emit.cu) dispatches to them by
// EmitParams.map.

#include "map_emit.cuh"

template SAT_MAP_EMIT_LAUNCH(float, MAP_LORENZ);
template SAT_MAP_EMIT_LAUNCH(float, MAP_ROSSLER);
