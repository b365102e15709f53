// tiled_adjoint.cu's f64 entry (mot_tiled_adjoint_f64) and its
// instantiations, in a translation unit of their own so that they compile
// beside the f32 ones (kernels/build.py starts one nvcc per source).

#define MOT_TILED_ADJOINT_F64
#include "tiled_adjoint.cu"
