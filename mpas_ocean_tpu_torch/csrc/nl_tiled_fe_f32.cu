// nl_tiled.cuh instantiated for tiled_step's nonlinear forward Euler (reach 2) arm at q > 1
// (kernel 2, _tiled_step_kernel) in float: every combination of the forced,
// tracer and stratified arms, periodic and masked, with its C entry.

#include "nl_tiled.cuh"

MOT_NL_TILED_ENTRY(float, f32, fe, false)
