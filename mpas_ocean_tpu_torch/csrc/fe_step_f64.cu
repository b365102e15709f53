// fe_step.cu's f64 entries (mot_fe_steps_f64, mot_fe_stack_f64) and their
// instantiations, in a translation unit of their own so that they compile
// beside the f32 ones (kernels/build.py starts one nvcc per source).

#define MOT_FE_STEP_F64
#include "fe_step.cu"
