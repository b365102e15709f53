// adjoint_step.cu's f64 entry (mot_adjoint_rollout_f64) and its
// instantiations, in a translation unit of their own so that they compile
// beside the f32 ones (kernels/build.py starts one nvcc per source).

#define MOT_ADJOINT_STEP_F64
#include "adjoint_step.cu"
