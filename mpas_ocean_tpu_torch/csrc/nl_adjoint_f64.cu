// The nonlinear reverse kernel (nl_adjoint.cuh) instantiated in double, unforced:
// periodic and masked, with and without tracers, stratified or not (8 arms),
// which nl_adjoint.cu launches.

#include "nl_adjoint.cuh"

namespace lattice {
MOT_NL_ADJ_ARMS(MOT_NL_ADJ_INSTANTIATE, double, false)
}  // namespace lattice
