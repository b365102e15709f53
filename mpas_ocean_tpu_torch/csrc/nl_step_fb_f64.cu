// nl_step.cuh instantiated for tiled_step's nonlinear FB arm at q = 1
// (kernel 2, _tiled_step_kernel) in double: every combination of the forced,
// tracer and stratified arms, periodic and masked, with its C entries.

#include "nl_step.cuh"

MOT_NL_ENTRIES(double, f64, tiled, true)
