// The nonlinear reverse kernel (nl_adjoint.cuh): its instantiations (f32,
// f64; periodic, masked), its launch loop and its C entries. It serves the
// reverse of kernel 3 (_adjoint_segment_kernel) and, at q = 1, of kernel 4
// (_tiled_adjoint_kernel): kernels/adjoint_step.nl_adjoint_rollout.

#include "nl_adjoint.cuh"

namespace {

using namespace lattice;

template <typename T, bool kMasked>
int prepare(int max_smem) {
  static bool done = false;
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      nl_adjoint_kernel<T, kMasked>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  done = e == cudaSuccess;
  return static_cast<int>(e);
}

// One call's launch set-up.
template <typename T>
struct NlAdjPlan {
  NlAdjArgs<T> a;
  NlAdjTaps<T> tp;
  int n_ranks, n_tiles, max_smem;
  size_t smem;
};

template <typename T>
int make_plan(NlAdjPlan<T>* pl, const T* fv, int n_fv, const int* live, const int* table,
              const double* weights, const int* adj, const double* adj_w, const int* vc,
              const double* vc_w, const int* ev, double dt, double inv_dc, double s_div,
              double s_ke, double s_curl, double ds_scale, double dke_scale, int ny2, int nx,
              int k, int n_steps, int n_terms, int rt, int ct, int ks, bool vec) {
  if (!valid_shape(ny2, nx, k, n_steps, n_terms) || table[0] != n_terms || adj[0] != n_terms)
    return cudaErrorInvalidValue;
  if (rt < 1 || ct < 1 || rt > ny2 || ct > nx || (n_fv != 4 && n_fv != 20) ||
      (live != nullptr) != (n_fv == 20))
    return cudaErrorInvalidValue;
  const int kc = step_chunk(k);
  if (ks < 1 || ks > kc || (ks & (ks - 1)) || ks > 16) return cudaErrorInvalidValue;
  pl->n_ranks = (k + kc - 1) / kc;
  if (!resolve_nl_adjoint_taps<T>(&pl->tp, table, weights, adj, adj_w, vc, vc_w, ev, rt, ct, ks))
    return kNotHexTable;
  int e = opt_in_smem(&pl->max_smem);
  if (e != 0) return e;
  pl->smem = nl_adjoint_smem_bytes(rt, ct, ks, sizeof(T));
  if (pl->smem > static_cast<size_t>(pl->max_smem)) return cudaErrorInvalidValue;
  const int n_ti = (nx + ct - 1) / ct;
  pl->n_tiles = ((ny2 + rt - 1) / rt) * n_ti;
  const bool vec_ok = vec && (ks * static_cast<int>(sizeof(T))) % 16 == 0;
  pl->a = NlAdjArgs<T>{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, fv, live, nullptr,
                       nullptr, nullptr, nullptr, T(dt), T(inv_dc), T(s_div), T(s_ke),
                       T(s_curl), T(ds_scale), T(dke_scale), ny2, nx, k, rt, ct, n_fv,
                       log2_exact(kc), log2_exact(ks),
                       vec_ok ? log2_exact(ks * static_cast<int>(sizeof(T)) / 16) : -1, n_ti};
  return 0;
}

// n_steps reverse steps, as adjoint_step.cu's adjoint_rollout: the primal
// state of step j in slot j of the stacks, the cotangent at step n_steps in
// `g_in` (left as it is), the one at step 0 out in `g_out` through `g_tmp`;
// `part` holds n_steps * tiles * ranks doubles; d(dt) is added to ddt[0].
template <typename T>
int nl_adjoint_rollout(const T* fv, int n_fv, const int* live, const int* table,
                       const double* weights, const int* adj, const double* adj_w,
                       const int* vc, const double* vc_w, const int* ev, const T* ssh_st,
                       const T* h_st, const T* u_st, const T* gs_in, const T* gh_in,
                       const T* gu_in, T* gs_out, T* gh_out, T* gu_out, T* gs_tmp, T* gh_tmp,
                       T* gu_tmp, double* part, double* ddt, double dt, double inv_dc,
                       double s_div, double s_ke, double s_curl, double ds_scale,
                       double dke_scale, int ny2, int nx, int k, int n_steps, int n_terms,
                       int rt, int ct, int ks, cudaStream_t stream) {
  const int kc = step_chunk(k);
  const bool vec = vector_loads(k, kc, sizeof(T), h_st, u_st) &&
                   vector_loads(k, kc, sizeof(T), gh_in, gu_in) &&
                   vector_loads(k, kc, sizeof(T), gh_out, gu_out) &&
                   vector_loads(k, kc, sizeof(T), gh_tmp, gu_tmp);
  NlAdjPlan<T> pl;
  int err = make_plan<T>(&pl, fv, n_fv, live, table, weights, adj, adj_w, vc, vc_w, ev, dt,
                         inv_dc, s_div, s_ke, s_curl, ds_scale, dke_scale, ny2, nx, k, n_steps,
                         n_terms, rt, ct, ks, vec);
  if (err != 0) return err;
  const bool masked = live != nullptr;
  if ((err = masked ? prepare<T, true>(pl.max_smem) : prepare<T, false>(pl.max_smem)) != 0)
    return err;
  const size_t cells = 2ULL * ny2 * nx;
  const size_t hs = cells * k, us = 3 * cells * k;
  const size_t shares = static_cast<size_t>(pl.n_tiles) * pl.n_ranks;
  const T *gs = gs_in, *gh = gh_in, *gu = gu_in;
  for (int s = 0; s < n_steps; ++s) {
    const size_t j = n_steps - 1 - s;
    const bool to_out = ((n_steps - 1 - s) & 1) == 0;
    NlAdjArgs<T>& a = pl.a;
    a.ssh = ssh_st + j * cells, a.h = h_st + j * hs, a.u = u_st + j * us;
    a.gs = gs, a.gh = gh, a.gu = gu;
    a.ds = to_out ? gs_out : gs_tmp;
    a.dh = to_out ? gh_out : gh_tmp;
    a.du = to_out ? gu_out : gu_tmp;
    a.ddt_part = part + s * shares;
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg = step_config(pl.n_ranks, pl.n_tiles, pl.smem, stream, attr);
    cudaError_t le = masked ? cudaLaunchKernelEx(&cfg, nl_adjoint_kernel<T, true>, pl.a, pl.tp)
                            : cudaLaunchKernelEx(&cfg, nl_adjoint_kernel<T, false>, pl.a, pl.tp);
    if (le == cudaSuccess) le = cudaGetLastError();
    if (le != cudaSuccess) return static_cast<int>(le);
    gs = a.ds, gh = a.dh, gu = a.du;
  }
  if (n_steps == 0) return 0;
  return reduce_ddt(part, static_cast<long long>(n_steps) * static_cast<long long>(shares), ddt,
                    stream);
}

}  // namespace

// Returns 0, kNotHexTable for a stencil or vertex table that is not the hex
// lattice's, or the CUDA error of the first launch that failed
// (cudaErrorInvalidValue for a plan the card does not take). `table` /
// `weights` are host copies of the Coriolis stencil, `adj` / `adj_w` of its
// transpose, `vc` / `vc_w` / `ev` of the vertex tables
// (kernels/fe_step.vertex_tables); rt x ct is the tile (it need not divide
// the lattice), ks the levels per slice; `fv` holds the vertex constants
// (n_fv = 4 planes periodic, 20 with live bits); ds_scale = g dt / dc and
// dke_scale = dt / dc.
#define MOT_NL_ADJOINT_ENTRY(T, SUFFIX)                                                        \
  extern "C" int mot_nl_adjoint_##SUFFIX(                                                      \
      const T* fv, int n_fv, const int* live, const int* table, const double* weights,         \
      const int* adj, const double* adj_w, const int* vc, const double* vc_w, const int* ev,   \
      const T* ssh_st, const T* h_st, const T* u_st, const T* gs_in, const T* gh_in,           \
      const T* gu_in, T* gs_out, T* gh_out, T* gu_out, T* gs_tmp, T* gh_tmp, T* gu_tmp,        \
      double* part, double* ddt, double dt, double inv_dc, double s_div, double s_ke,          \
      double s_curl, double ds_scale, double dke_scale, int ny2, int nx, int k, int n_steps,   \
      int n_terms, int rt, int ct, int ks, void* stream) {                                     \
    return nl_adjoint_rollout<T>(fv, n_fv, live, table, weights, adj, adj_w, vc, vc_w, ev,     \
                                 ssh_st, h_st, u_st, gs_in, gh_in, gu_in, gs_out, gh_out,      \
                                 gu_out, gs_tmp, gh_tmp, gu_tmp, part, ddt, dt, inv_dc, s_div, \
                                 s_ke, s_curl, ds_scale, dke_scale, ny2, nx, k, n_steps,       \
                                 n_terms, rt, ct, ks,                                          \
                                 static_cast<cudaStream_t>(stream));                           \
  }

MOT_NL_ADJOINT_ENTRY(float, f32)
MOT_NL_ADJOINT_ENTRY(double, f64)

// The launch of an f32 plan: out[0] the clusters (one per tile), out[1] the
// blocks per SM (CUDA's occupancy calculator), out[2] one block's shared
// memory in bytes. Returns 0 or the CUDA error.
extern "C" int mot_nl_adjoint_plan(int ny2, int nx, int k, int rt, int ct, int ks, int* out) {
  int max_smem = 0;
  int e = opt_in_smem(&max_smem);
  if (e != 0) return e;
  const size_t smem = nl_adjoint_smem_bytes(rt, ct, ks, sizeof(float));
  if (smem > static_cast<size_t>(max_smem) || ks < 1 || ks > step_chunk(k))
    return cudaErrorInvalidValue;
  if ((e = prepare<float, false>(max_smem)) != 0) return e;
  out[0] = ((ny2 + rt - 1) / rt) * ((nx + ct - 1) / ct);
  out[2] = static_cast<int>(smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], nl_adjoint_kernel<float, false>, kStepThreads, smem));
}
