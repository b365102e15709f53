// The nonlinear reverse kernel's (nl_adjoint.cuh) launch loop and C entries.
// It serves the reverse of kernel 3 (_adjoint_segment_kernel) and, at q = 1,
// of kernel 4 (_tiled_adjoint_kernel): kernels/adjoint_step.nl_adjoint_rollout.
// The kernel's 32 arms (f32, f64; periodic, masked; forced, tracers,
// stratified in any combination) are instantiated in
// nl_adjoint_{f32,f64}{,_forced}.cu, 8 each, which compile in parallel.
// The stratified arms chain one launch of adjoint_window.cuh's stratified
// pass (strat_pass_kernel, f32 and f64, instantiated here) after each step.

#include "nl_adjoint.cuh"

namespace lattice {
MOT_NL_ADJ_ARMS(MOT_NL_ADJ_EXTERN, float, false)
MOT_NL_ADJ_ARMS(MOT_NL_ADJ_EXTERN, float, true)
MOT_NL_ADJ_ARMS(MOT_NL_ADJ_EXTERN, double, false)
MOT_NL_ADJ_ARMS(MOT_NL_ADJ_EXTERN, double, true)
}  // namespace lattice

namespace {

using namespace lattice;

template <typename T>
using NlAdjLaunch = int (*)(const NlAdjPlan<T>&, cudaStream_t);

// The launch of the plan's arm: masked or not, and any combination of
// forced, tracers and stratified.
template <typename T, bool kMasked>
NlAdjLaunch<T> arm_of(bool forced, bool tracers, bool strat) {
  static const NlAdjLaunch<T> arms[8] = {
      nl_adj_launch<T, kMasked, false, false, false>, nl_adj_launch<T, kMasked, false, false, true>,
      nl_adj_launch<T, kMasked, false, true, false>,  nl_adj_launch<T, kMasked, false, true, true>,
      nl_adj_launch<T, kMasked, true, false, false>,  nl_adj_launch<T, kMasked, true, false, true>,
      nl_adj_launch<T, kMasked, true, true, false>,   nl_adj_launch<T, kMasked, true, true, true>};
  return arms[(forced ? 4 : 0) + (tracers ? 2 : 0) + (strat ? 1 : 0)];
}

template <typename T>
using NlAdjClusters = int (*)(size_t, int, int, int*);

// The resident-cluster query of the plan's arm.
template <typename T, bool kMasked>
NlAdjClusters<T> clusters_of(bool forced, bool tracers, bool strat) {
  static const NlAdjClusters<T> arms[8] = {
      nl_adj_clusters<T, kMasked, false, false, false>,
      nl_adj_clusters<T, kMasked, false, false, true>,
      nl_adj_clusters<T, kMasked, false, true, false>,
      nl_adj_clusters<T, kMasked, false, true, true>,
      nl_adj_clusters<T, kMasked, true, false, false>,
      nl_adj_clusters<T, kMasked, true, false, true>,
      nl_adj_clusters<T, kMasked, true, true, false>,
      nl_adj_clusters<T, kMasked, true, true, true>};
  return arms[(forced ? 4 : 0) + (tracers ? 2 : 0) + (strat ? 1 : 0)];
}

// The levels a block takes (a multiple of ks): of the splits of k levels over
// 1 .. kMaxCluster ranks, the one whose launch takes the fewest slice times,
// reckoned as its waves of clusters (as many as the card keeps resident,
// `clusters`' query) times the slices of a rank plus half a slice for a
// block's fixed cost (its prologue and the ranks' sums). Where the split is
// uneven the last rank idles at the cluster barrier; this rule weighs that
// against the waves a larger cluster adds.
template <typename T>
int choose_kc(NlAdjClusters<T> clusters, size_t smem, int max_smem, int k, int ks, int n_tiles,
              int* kc) {
  double best = 0.0;
  *kc = 0;
  for (int r = 1; r <= kMaxCluster; ++r) {
    const int kc_r = ks * ((k + r * ks - 1) / (r * ks));
    if ((k + kc_r - 1) / kc_r != r) continue;  // the split of fewer ranks
    int resident = 0;
    const int err = clusters(smem, r, max_smem, &resident);
    if (err != 0) return err;
    if (resident < 1) continue;
    const double cost = static_cast<double>((n_tiles + resident - 1) / resident) *
                        (static_cast<double>(kc_r / ks) + 0.5);
    if (*kc == 0 || cost < best) best = cost, *kc = kc_r;
  }
  return *kc > 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int make_plan(NlAdjPlan<T>* pl, const T* fv, int n_fv, const int* live, const ForcingArgs<T>& fc,
              T* dwind, const AdjTracers<T>& at, const AdjStrat<T>& st, const int* table,
              const double* weights, const int* adj, const double* adj_w, const int* vc,
              const double* vc_w, const int* ev, double dt, double inv_dc, double s_div,
              double s_ke, double s_curl, double ds_scale, double dke_scale, int ny2, int nx,
              int k, int n_steps, int n_terms, int rt, int ct, int ks, int kc, bool vec) {
  if (!valid_shape(ny2, nx, k, n_steps, n_terms) || table[0] != n_terms || adj[0] != n_terms)
    return cudaErrorInvalidValue;
  if (rt < 1 || ct < 1 || rt > ny2 || ct > nx || (n_fv != 4 && n_fv != 20) ||
      (live != nullptr) != (n_fv == 20))
    return cudaErrorInvalidValue;
  // the tracer arm: at least one tracer, the cell mask with the live bits
  if (at.tr != nullptr && (at.n < 1 || (live == nullptr) != (at.cmask == nullptr)))
    return cudaErrorInvalidValue;
  if (ks < 1 || (ks & (ks - 1)) || ks > 16 || kc < ks || kc % ks != 0 ||
      (k + kc - 1) / kc > kMaxCluster)
    return cudaErrorInvalidValue;
  pl->n_ranks = (k + kc - 1) / kc;
  if (!resolve_nl_adjoint_taps<T>(&pl->tp, table, weights, adj, adj_w, vc, vc_w, ev, rt, ct, ks))
    return kNotHexTable;
  int e = opt_in_smem(&pl->max_smem);
  if (e != 0) return e;
  pl->smem = nl_adjoint_smem_bytes(rt, ct, ks, sizeof(T), at.tr != nullptr ? at.n : 0, n_fv);
  if (pl->smem > static_cast<size_t>(pl->max_smem)) return cudaErrorInvalidValue;
  const int n_ti = (nx + ct - 1) / ct;
  pl->n_tiles = ((ny2 + rt - 1) / rt) * n_ti;
  const bool vec_ok = vec && (ks * static_cast<int>(sizeof(T))) % 16 == 0;
  pl->a = NlAdjArgs<T>{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, fv, live, nullptr,
                       nullptr, nullptr, nullptr, fc, dwind, at, st, T(dt), T(inv_dc), T(s_div),
                       T(s_ke), T(s_curl), T(ds_scale), T(dke_scale), ny2, nx, k, rt, ct, n_fv,
                       0, log2_exact(ks),
                       vec_ok ? log2_exact(ks * static_cast<int>(sizeof(T)) / 16) : -1, n_ti,
                       static_cast<long long>(n_steps) * pl->n_tiles * pl->n_ranks, nullptr,
                       kc};
  return 0;
}

// n_steps reverse steps, as adjoint_step.cu's adjoint_rollout: the primal
// state of step j in slot j of the stacks, the cotangent at step n_steps in
// `g_in` (left as it is), the one at step 0 out in `g_out` through `g_tmp`;
// `part` holds n_steps * tiles * ranks doubles (kShares times as many for
// the forced arm; ranks = ceil(k / kc), at most kMaxCluster, kc the levels
// a block, 0 for choose_kc's); d(dt) is added to ddt[0], the forced arm's d(wind) to
// dwind and d(r_lin, Cd, lambda) to dcoef[0 .. 2]; the tracer arm (at.tr
// the tracer stack) as adjoint_rollout's. The stratified arm (st.w the W)
// runs after each step's launch one launch of the stratified pass
// (adjoint_window.cuh, strat_pass_kernel) on `pass_groups` groups of cells
// (kPassSplits blocks each) over the step's S in `s_scr` (cells * k values),
// its d(W) partials in st.acc (pass_groups * k * k doubles) and its d(dt)
// shares in `pass_shares` (n_steps * pass_groups * kPassSplits doubles); at
// the end d(W) is added to dstrat.
template <typename T>
int nl_adjoint_rollout(const T* fv, int n_fv, const int* live, const ForcingArgs<T>& fc,
                       T* dwind, double* dcoef, AdjTracers<T> at, T* gtr_out, T* gtr_tmp,
                       const T* h_end, const T* tr_end, AdjStrat<T> st, double* dstrat,
                       T* s_scr, double* pass_shares, int pass_groups, const int* table,
                       const double* weights, const int* adj, const double* adj_w,
                       const int* vc, const double* vc_w, const int* ev, const T* ssh_st,
                       const T* h_st, const T* u_st, const T* gs_in, const T* gh_in,
                       const T* gu_in, T* gs_out, T* gh_out, T* gu_out, T* gs_tmp, T* gh_tmp,
                       T* gu_tmp, double* part, double* ddt, double dt, double inv_dc,
                       double s_div, double s_ke, double s_curl, double ds_scale,
                       double dke_scale, int ny2, int nx, int k, int n_steps, int n_terms, int rt,
                       int ct, int ks, int kc, cudaStream_t stream) {
  const bool tracers = at.tr != nullptr;
  // 16-byte copies need the slices (and so the blocks' first levels, a
  // multiple of ks apart) whole vectors
  const bool vec = vector_loads(k, ks, sizeof(T), h_st, u_st) &&
                   vector_loads(k, ks, sizeof(T), gh_in, gu_in) &&
                   vector_loads(k, ks, sizeof(T), gh_out, gu_out) &&
                   vector_loads(k, ks, sizeof(T), gh_tmp, gu_tmp) &&
                   (!tracers || (vector_loads(k, ks, sizeof(T), at.tr, at.gtr) &&
                                 vector_loads(k, ks, sizeof(T), gtr_out, gtr_tmp)));
  const bool forced = fc.wind != nullptr, strat = st.w != nullptr;
  if (kc == 0) {  // the level split of the fewest slice times
    int max_smem = 0;
    int e = opt_in_smem(&max_smem);
    if (e != 0) return e;
    const size_t smem = nl_adjoint_smem_bytes(rt, ct, ks, sizeof(T), tracers ? at.n : 0, n_fv);
    if (ks < 1 || smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
    const int n_tiles = ((ny2 + rt - 1) / rt) * ((nx + ct - 1) / ct);
    e = choose_kc<T>(live != nullptr ? clusters_of<T, true>(forced, tracers, strat)
                                     : clusters_of<T, false>(forced, tracers, strat),
                     smem, max_smem, k, ks, n_tiles, &kc);
    if (e != 0) return e;
  }
  NlAdjPlan<T> pl;
  int err = make_plan<T>(&pl, fv, n_fv, live, fc, dwind, at, st, table, weights, adj, adj_w, vc,
                         vc_w, ev, dt, inv_dc, s_div, s_ke, s_curl, ds_scale, dke_scale, ny2, nx,
                         k, n_steps, n_terms, rt, ct, ks, kc, vec);
  if (err != 0) return err;
  const size_t cells = 2ULL * ny2 * nx;
  StratPassArgs<T> pa{};
  size_t pass_smem = 0;
  if (strat) {
    if (s_scr == nullptr || pass_shares == nullptr ||
        !strat_pass_setup<T>(&pa, &pass_smem, static_cast<int>(cells), k, pass_groups,
                             pl.max_smem, st.w, st.acc, dt, inv_dc))
      return cudaErrorInvalidValue;
    pl.a.s_out = s_scr;
  }
  const NlAdjLaunch<T> launch = live != nullptr ? arm_of<T, true>(forced, tracers, strat)
                                                : arm_of<T, false>(forced, tracers, strat);
  const size_t hs = cells * k, us = 3 * cells * k, trs = tracers ? at.n * hs : 0;
  const size_t shares = static_cast<size_t>(pl.n_tiles) * pl.n_ranks;
  const T *gs = gs_in, *gh = gh_in, *gu = gu_in, *gt = at.gtr;
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
    if (tracers) {
      const bool last = static_cast<int>(j) + 1 == n_steps;
      a.at.tr = at.tr + j * trs, a.at.gtr = gt;
      a.at.h_next = last ? h_end : h_st + (j + 1) * hs;
      a.at.tr_next = last ? tr_end : at.tr + (j + 1) * trs;
      a.at.dtr = to_out ? gtr_out : gtr_tmp;
      gt = a.at.dtr;
    }
    if ((err = launch(pl, stream)) != 0) return err;
    if (strat) {  // the step's W S, d(W) and d(dt) W part
      pa.h = a.h, pa.s = s_scr, pa.dh = a.dh;
      pa.share = pass_shares + static_cast<size_t>(s) * pass_groups * kPassSplits;
      pa.first = s == 0;
      if ((err = launch_strat_pass<T>(pa, pass_groups, pass_smem, pl.max_smem, stream)) != 0)
        return err;
    }
    gs = a.ds, gh = a.dh, gu = a.du;
  }
  if (n_steps == 0) return 0;
  err = reduce_shares(part, pl.a.n_shares, ddt, forced ? dcoef : nullptr, stream);
  if (err == 0 && strat)
    err = reduce_ddt(pass_shares, static_cast<long long>(n_steps) * pass_groups * kPassSplits,
                     ddt, stream);
  if (err == 0 && strat) err = strat_reduce(st.acc, pass_groups, k, dstrat, stream);
  return err;
}

}  // namespace

// Returns 0, kNotHexTable for a stencil or vertex table that is not the hex
// lattice's, or the CUDA error of the first launch that failed
// (cudaErrorInvalidValue for a plan the card does not take). `table` /
// `weights` are host copies of the Coriolis stencil, `adj` / `adj_w` of its
// transpose, `vc` / `vc_w` / `ev` of the vertex tables
// (kernels/fe_step.vertex_tables); rt x ct is the tile (it need not divide
// the lattice), ks the levels per slice, kc the levels a block (a multiple
// of ks; 0: choose_kc's split);
// `fv` holds the vertex constants (n_fv = 4 planes periodic, 20 with live
// bits); ds_scale = g dt / dc and dke_scale = dt / dc. A null `wind` runs
// the unforced arm, any other the forced one with `lvl`, the coefficients
// and the accumulators `dwind` (6, ny2, nx) and `dcoef` (3 doubles); a null
// `tr_st` the tracer-free arm, any other the tracer arm with n_tr tracers
// (the tracer stack, the cotangent planes in, out and scratch, the state
// after the stack's last slot `h_end`, `tr_end`, the live-cell mask `cmask`,
// kappa and upwind); a null `strat_w` the unstratified arm, any other (W,
// (k, k) row-major) the stratified one with the stratified pass's d(W)
// partials `dw_acc` (pass_groups * k * k doubles), d(W) `dstrat` (k * k
// doubles, added to), the S scratch `s_scr` (2 ny2 nx k values) and the
// pass's d(dt) shares `pass_shares` (n_steps * pass_groups * 2 doubles); in
// any combination.
#define MOT_NL_ADJOINT_ENTRY(T, SUFFIX)                                                        \
  extern "C" int mot_nl_adjoint_##SUFFIX(                                                      \
      const T* fv, int n_fv, const int* live, const T* wind, const int* lvl, T* dwind,         \
      double* dcoef, const int* table, const double* weights, const int* adj,                 \
      const double* adj_w, const int* vc, const double* vc_w, const int* ev, const T* ssh_st,  \
      const T* h_st, const T* u_st, const T* gs_in, const T* gh_in, const T* gu_in,            \
      T* gs_out, T* gh_out, T* gu_out, T* gs_tmp, T* gh_tmp, T* gu_tmp, double* part,          \
      double* ddt, const T* tr_st, const T* gtr_in, T* gtr_out, T* gtr_tmp, const T* h_end,   \
      const T* tr_end, const T* cmask, const T* strat_w, double* dw_acc, double* dstrat,      \
      T* s_scr, double* pass_shares, double dt, double inv_dc, double s_div, double s_ke,      \
      double s_curl, double ds_scale, double dke_scale, double dlin, double dquad,             \
      double rayl, double kappa, double upwind, int lvl_ranks, int wind_ranks, int ny2,        \
      int nx, int k, int n_steps, int n_terms, int rt, int ct, int ks, int pass_groups,        \
      int kc, int n_tr, void* stream) {                                                        \
    const ForcingArgs<T> fc{wind, lvl, T(dlin), T(dquad), T(rayl),                             \
                            static_cast<unsigned>(lvl_ranks),                                  \
                            static_cast<unsigned>(wind_ranks)};                                \
    const AdjTracers<T> at{tr_st, gtr_in, nullptr, nullptr, cmask, nullptr, T(kappa),          \
                           T(0.5 * upwind), n_tr};                                             \
    const AdjStrat<T> st{strat_w, dw_acc, 1};                                                  \
    return nl_adjoint_rollout<T>(fv, n_fv, live, fc, dwind, dcoef, at, gtr_out, gtr_tmp,       \
                                 h_end, tr_end, st, dstrat, s_scr, pass_shares, pass_groups,  \
                                 table, weights, adj, adj_w, vc, vc_w, ev, ssh_st, h_st, u_st, \
                                 gs_in, gh_in, gu_in, gs_out, gh_out, gu_out, gs_tmp, gh_tmp,  \
                                 gu_tmp, part, ddt, dt, inv_dc, s_div, s_ke, s_curl, ds_scale, \
                                 dke_scale, ny2, nx, k, n_steps, n_terms, rt, ct, ks, kc,      \
                                 static_cast<cudaStream_t>(stream));                           \
  }

MOT_NL_ADJOINT_ENTRY(float, f32)
MOT_NL_ADJOINT_ENTRY(double, f64)

// One launch of the stratified pass alone (the GPU tests and chip_smoke.py
// hold it against its plain version, structured/adjoint.strat_pass): over
// `cells` cells of k levels in `groups` groups, dh += (dt / dc) W S in
// place, d(W) added to dstrat and d(dt)'s W part to ddt[0]; `acc` holds
// groups * k * k doubles, `shares` groups * 2. Returns 0 or the CUDA error
// (cudaErrorInvalidValue where no sub-chunk fits).
#define MOT_STRAT_PASS_ENTRY(T, SUFFIX)                                                        \
  extern "C" int mot_strat_pass_##SUFFIX(const T* h, const T* s, const T* w, T* dh,            \
                                         double* acc, double* shares, double* dstrat,          \
                                         double* ddt, double dt, double inv_dc, int cells,     \
                                         int k, int groups, void* stream) {                    \
    const cudaStream_t cs = static_cast<cudaStream_t>(stream);                                 \
    int max_smem = 0;                                                                          \
    int err = opt_in_smem(&max_smem);                                                          \
    if (err != 0) return err;                                                                  \
    StratPassArgs<T> pa{};                                                                     \
    size_t smem = 0;                                                                           \
    if (k < 1 || cells < 1 ||                                                                  \
        !strat_pass_setup<T>(&pa, &smem, cells, k, groups, max_smem, w, acc, dt, inv_dc))      \
      return cudaErrorInvalidValue;                                                            \
    pa.h = h, pa.s = s, pa.dh = dh, pa.share = shares;                                         \
    if ((err = launch_strat_pass<T>(pa, groups, smem, max_smem, cs)) != 0) return err;         \
    if ((err = reduce_ddt(shares, groups * kPassSplits, ddt, cs)) != 0) return err;            \
    return strat_reduce(acc, groups, k, dstrat, cs);                                           \
  }

MOT_STRAT_PASS_ENTRY(float, f32)
MOT_STRAT_PASS_ENTRY(double, f64)
