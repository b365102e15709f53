// The nonlinear reverse kernel (nl_adjoint.cuh) instantiated in float, unforced:
// periodic and masked, with and without tracers, stratified or not (8 arms),
// which nl_adjoint.cu launches.

#include "nl_adjoint.cuh"

namespace lattice {
MOT_NL_ADJ_ARMS(MOT_NL_ADJ_INSTANTIATE, float, false)
}  // namespace lattice

// The launch of an f32 plan of the plain periodic arm: out[0] the clusters
// (one per tile), out[1] the blocks per SM (CUDA's occupancy calculator),
// out[2] one block's shared memory in bytes. Returns 0 or the CUDA error.
extern "C" int mot_nl_adjoint_plan(int ny2, int nx, int k, int rt, int ct, int ks, int* out) {
  using namespace lattice;
  int max_smem = 0;
  int e = opt_in_smem(&max_smem);
  if (e != 0) return e;
  const size_t smem = nl_adjoint_smem_bytes(rt, ct, ks, sizeof(float), 0, 4);
  if (smem > static_cast<size_t>(max_smem) || ks < 1 || ks > step_chunk(k))
    return cudaErrorInvalidValue;
  if ((e = nl_adj_prepare<float, false, false, false, false>(max_smem)) != 0) return e;
  out[0] = ((ny2 + rt - 1) / rt) * ((nx + ct - 1) / ct);
  out[2] = static_cast<int>(smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], nl_adjoint_kernel<float, false, false, false, false>, kStepThreads, smem));
}
