// nl_step.cuh instantiated for fe_step's nonlinear FE arm (kernel 1,
// _rollout_kernel) in float: every combination of the forced, tracer and
// stratified arms, periodic and masked, with its C entries (the stack entry
// is the nonlinear gradient's rebuild).

#include "nl_step.cuh"

MOT_NL_ENTRIES(float, f32, fe, false)
MOT_NL_STACK_ENTRY(float, f32, fe, false)

// The f32 nonlinear FE plan's launch: out[0] clusters, out[1] blocks per
// SM, out[2] one block's shared memory in bytes.
extern "C" int mot_fe_nl_plan(int ny2, int nx, int k, int rt, int ct, int ks, int* out) {
  return lattice::nl_plan_query<false>(ny2, nx, k, rt, ct, ks, out);
}
