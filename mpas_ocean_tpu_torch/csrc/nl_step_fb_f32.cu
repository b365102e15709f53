// nl_step.cuh instantiated for tiled_step's nonlinear FB arm at q = 1
// (kernel 2, _tiled_step_kernel) in float: every combination of the forced,
// tracer and stratified arms, periodic and masked, with its C entries.

#include "nl_step.cuh"

MOT_NL_ENTRIES(float, f32, tiled, true)

// The f32 nonlinear FB plan's launch: out[0] clusters, out[1] blocks per
// SM, out[2] one block's shared memory in bytes.
extern "C" int mot_tiled_nl_plan(int ny2, int nx, int k, int rt, int ct, int ks, int* out) {
  return lattice::nl_plan_query<true>(ny2, nx, k, rt, ct, ks, out);
}
