// nl_step.cuh instantiated for fe_step's nonlinear FE arm (kernel 1,
// _rollout_kernel) in double: every combination of the forced, tracer and
// stratified arms, periodic and masked, with its C entries (the stack entry
// is the nonlinear gradient's rebuild).

#include "nl_step.cuh"

MOT_NL_ENTRIES(double, f64, fe, false)
MOT_NL_STACK_ENTRY(double, f64, fe, false)
