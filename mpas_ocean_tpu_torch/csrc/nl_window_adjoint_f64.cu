// The q-step nonlinear reverse kernel (nl_window_adjoint.cuh) instantiated in
// double, unforced: periodic and masked, with and without tracers, stratified or
// not (8 arms), which nl_window_adjoint.cu launches.

#include "nl_window_adjoint.cuh"

namespace lattice {
MOT_NL_ADJ_ARMS(MOT_NL_WIN_INSTANTIATE, double, false)
}  // namespace lattice
