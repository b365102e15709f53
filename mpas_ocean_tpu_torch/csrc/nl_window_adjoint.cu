// The q-step nonlinear reverse kernel's (nl_window_adjoint.cuh) launch loop
// and C entries: kernel 4's (_tiled_adjoint_kernel's) nonlinear arm at
// q > 1, kernels/adjoint_step.nl_window_adjoint_rollout. The kernel's 32
// arms (f32, f64; periodic, masked; forced, tracers, stratified in any
// combination) are instantiated in nl_window_adjoint_{f32,f64}{,_forced}.cu,
// 8 each, which compile in parallel.

#include "nl_window_adjoint.cuh"

namespace lattice {
MOT_NL_ADJ_ARMS(MOT_NL_WIN_EXTERN, float, false)
MOT_NL_ADJ_ARMS(MOT_NL_WIN_EXTERN, float, true)
MOT_NL_ADJ_ARMS(MOT_NL_WIN_EXTERN, double, false)
MOT_NL_ADJ_ARMS(MOT_NL_WIN_EXTERN, double, true)
}  // namespace lattice

namespace {

using namespace lattice;

template <typename T>
using NlWinLaunch = int (*)(const NlWinPlan<T>&, cudaStream_t);

template <typename T, bool kMasked>
NlWinLaunch<T> arm_of(bool forced, bool tracers, bool strat) {
  static const NlWinLaunch<T> arms[8] = {
      nl_win_launch<T, kMasked, false, false, false>, nl_win_launch<T, kMasked, false, false, true>,
      nl_win_launch<T, kMasked, false, true, false>,  nl_win_launch<T, kMasked, false, true, true>,
      nl_win_launch<T, kMasked, true, false, false>,  nl_win_launch<T, kMasked, true, false, true>,
      nl_win_launch<T, kMasked, true, true, false>,   nl_win_launch<T, kMasked, true, true, true>};
  return arms[(forced ? 4 : 0) + (tracers ? 2 : 0) + (strat ? 1 : 0)];
}

// Values of a slot's ssh part (every rank's [2][sites]), a whole number of
// 16-byte vectors of either dtype, so that the planes after it stay aligned.
inline long long ssh_part(int n_ranks, long long sites) {
  return (2LL * n_ranks * sites + 3) / 4 * 4;
}

// The scratch of one tile, in values: q - 1 primal slots over P_1, then
// min(q - 1, 2) cotangent slots over R_{q-1} (nl_window_adjoint.cuh,
// NlWinArgs); kernels/adjoint_step.nl_window_scratch_values mirrors it.
long long scratch_per_tile(int rt, int ct, int q, int k, int n_tr) {
  const int n_ranks = (k + step_chunk(k) - 1) / step_chunk(k);
  const long long ps = static_cast<long long>(rt + 2 * win_p_halo_m(q)) *
                       (ct + 2 * win_p_halo_i(q));
  const long long cs = static_cast<long long>(rt + 2 * kWinM * (q - 1)) *
                       (ct + 2 * kWinI * (q - 1));
  const long long planes = (8 + 2LL * n_tr) * k;
  return (q - 1) * (ssh_part(n_ranks, ps) + planes * ps) +
         (q - 1 < 2 ? q - 1 : 2) * (ssh_part(n_ranks, cs) + planes * cs);
}

// n_launches reverse supersteps of q nonlinear FE steps each, as
// nl_adjoint.cu's nl_adjoint_rollout does single steps: the superstep-start
// state of superstep j in slot j of the stacks, the cotangent at the end in
// `g_in` (left as it is), the one at the start out in `g_out` through `g_tmp`,
// the tiles' states between the steps in `scratch` (scratch_values values);
// d(dt), the forced, tracer and stratified arms' accumulators as there.
template <typename T>
int nl_window_rollout(const T* rts, const T* fv, int n_fv, const int* live,
                      const ForcingArgs<T>& fc, T* dwind, double* dcoef, AdjTracers<T> at,
                      T* gtr_out, T* gtr_tmp, const T* h_end, const T* tr_end, AdjStrat<T> st,
                      double* dstrat, const int* table, const double* weights, const int* adj,
                      const double* adj_w, const int* vc, const double* vc_w, const int* ev,
                      const T* ssh_st, const T* h_st, const T* u_st, const T* gs_in,
                      const T* gh_in, const T* gu_in, T* gs_out, T* gh_out, T* gu_out,
                      T* gs_tmp, T* gh_tmp, T* gu_tmp, double* part, double* ddt, T* scratch,
                      long long scratch_values, double dt, double inv_dc, double s_div,
                      double s_ke, double s_curl, double ds_scale, double dke_scale, int ny2,
                      int nx, int k, int n_launches, int n_terms, int rt, int ct, int ks, int q,
                      cudaStream_t stream) {
  if (!valid_shape(ny2, nx, k, n_launches, n_terms) || table[0] != n_terms ||
      adj[0] != n_terms)
    return cudaErrorInvalidValue;
  if (q < 2 || rt < 1 || ct < 1 || ny2 % rt || nx % ct || (n_fv != 4 && n_fv != 20) ||
      (live != nullptr) != (n_fv == 20) || scratch == nullptr)
    return cudaErrorInvalidValue;
  const bool tracers = at.tr != nullptr, forced = fc.wind != nullptr, strat = st.w != nullptr;
  // the tracer arm: at least one tracer, the cell mask with the live bits
  if (tracers && (at.n < 1 || (live == nullptr) != (at.cmask == nullptr)))
    return cudaErrorInvalidValue;
  const int kc = step_chunk(k);
  if (ks < 1 || ks > kc || (ks & (ks - 1)) || ks > 16) return cudaErrorInvalidValue;
  const int n_tr = tracers ? at.n : 0;
  const long long per_tile = scratch_per_tile(rt, ct, q, k, n_tr);
  const int n_ti = nx / ct;
  NlWinPlan<T> pl;
  pl.n_ranks = (k + kc - 1) / kc;
  pl.n_tiles = (ny2 / rt) * n_ti;
  if (scratch_values < per_tile * pl.n_tiles) return cudaErrorInvalidValue;
  const bool vec = vector_loads(k, kc, sizeof(T), h_st, u_st) &&
                   vector_loads(k, kc, sizeof(T), gh_in, gu_in) &&
                   vector_loads(k, kc, sizeof(T), gh_out, gu_out) &&
                   vector_loads(k, kc, sizeof(T), gh_tmp, gu_tmp) &&
                   vector_loads(k, kc, sizeof(T), scratch, scratch) &&
                   (!tracers || (vector_loads(k, kc, sizeof(T), at.tr, at.gtr) &&
                                 vector_loads(k, kc, sizeof(T), gtr_out, gtr_tmp)));
  const bool vec_ok = vec && (ks * static_cast<int>(sizeof(T))) % 16 == 0;
  const int vec_log2 = vec_ok ? log2_exact(ks * static_cast<int>(sizeof(T)) / 16) : -1;
  // the reverse's taps at the tile (nl_adjoint.cuh), the recompute's (the FE
  // step's window and derived ring at the tile, nl_step.cuh)
  if (!resolve_nl_adjoint_taps<T>(&pl.tp, table, weights, adj, adj_w, vc, vc_w, ev, rt, ct, ks))
    return kNotHexTable;
  const int fWi = ct + 2 * kFwdI, fW = (rt + 2 * kFwdM) * fWi;
  const int Di = ct + 2 * kFwdDc, D = (rt + 2 * kFwdDr) * Di;
  const int pw = strat ? (rt + 2) * (ct + 2) : fW, pi = strat ? ct + 2 : fWi;
  if (!resolve_nl_taps<T>(&pl.ftp, table, weights, vc, vc_w, ev, fWi, fW, Di, D, ks, pw, pi))
    return kNotHexTable;
  TracerArgs<T> tr{at.tr, nullptr, at.cmask, at.kappa, at.half_up, n_tr, {}, {}};
  resolve_tracer_taps(&tr, table, fWi);
  int e = opt_in_smem(&pl.max_smem);
  if (e != 0) return e;
  pl.smem = nl_window_smem_bytes(rt, ct, ks, sizeof(T), n_tr, kc, strat ? k : 0, forced);
  if (pl.smem > static_cast<size_t>(pl.max_smem)) return cudaErrorInvalidValue;
  const T tdt = T(dt), tinv = T(inv_dc), tdiv = T(s_div), tke = T(s_ke), tcurl = T(s_curl);
  NlArgs<T> f{nullptr, nullptr, nullptr, rts, fv, live, nullptr, nullptr, nullptr, fc, tr,
              st.w, nbr_reach(table), tdt, tinv, tdiv, tke, tcurl, ny2, nx, k, rt, ct, kFwdM,
              kFwdI, kFwdDr, kFwdDc, n_fv, log2_exact(kc), log2_exact(ks), vec_log2, n_ti, 0};
  NlAdjArgs<T> r{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, fv, live, nullptr,
                 nullptr, nullptr, nullptr, fc, dwind, at, st, tdt, tinv, tdiv, tke, tcurl,
                 T(ds_scale), T(dke_scale), ny2, nx, k, rt, ct, n_fv, log2_exact(kc),
                 log2_exact(ks), vec_log2, n_ti,
                 static_cast<long long>(n_launches) * pl.n_tiles * pl.n_ranks};
  const long long ps = static_cast<long long>(rt + 2 * win_p_halo_m(q)) *
                       (ct + 2 * win_p_halo_i(q));
  const long long cs = static_cast<long long>(rt + 2 * kWinM * (q - 1)) *
                       (ct + 2 * kWinI * (q - 1));
  const long long planes = (8 + 2LL * n_tr) * k;
  pl.w = NlWinArgs<T>{f, r, scratch, per_tile,
                      ssh_part(pl.n_ranks, ps) + planes * ps,
                      ssh_part(pl.n_ranks, cs) + planes * cs, q,
                      rt + 2 * win_p_halo_m(q), ct + 2 * win_p_halo_i(q),
                      rt + 2 * kWinM * (q - 1), ct + 2 * kWinI * (q - 1),
                      static_cast<int>(ssh_part(pl.n_ranks, ps)),
                      static_cast<int>(ssh_part(pl.n_ranks, cs))};
  const NlWinLaunch<T> launch = live != nullptr ? arm_of<T, true>(forced, tracers, strat)
                                                : arm_of<T, false>(forced, tracers, strat);
  const size_t cells = 2ULL * ny2 * nx;
  const size_t hs = cells * k, us = 3 * cells * k, trs = tracers ? at.n * hs : 0;
  const size_t shares = static_cast<size_t>(pl.n_tiles) * pl.n_ranks;
  const T *gs = gs_in, *gh = gh_in, *gu = gu_in, *gt = at.gtr;
  for (int s = 0; s < n_launches; ++s) {
    const size_t j = n_launches - 1 - s;
    const bool to_out = ((n_launches - 1 - s) & 1) == 0;
    NlArgs<T>& fa = pl.w.f;
    NlAdjArgs<T>& a = pl.w.r;
    a.ssh = fa.ssh = ssh_st + j * cells;
    a.h = fa.h = h_st + j * hs;
    a.u = fa.u = u_st + j * us;
    a.gs = gs, a.gh = gh, a.gu = gu;
    a.ds = to_out ? gs_out : gs_tmp;
    a.dh = to_out ? gh_out : gh_tmp;
    a.du = to_out ? gu_out : gu_tmp;
    a.ddt_part = part + s * shares;
    a.st.first = s == 0;
    if (tracers) {
      const bool last = static_cast<int>(j) + 1 == n_launches;
      a.at.tr = fa.tr.tr = at.tr + j * trs;
      a.at.gtr = gt;
      a.at.h_next = last ? h_end : h_st + (j + 1) * hs;
      a.at.tr_next = last ? tr_end : at.tr + (j + 1) * trs;
      a.at.dtr = to_out ? gtr_out : gtr_tmp;
      gt = a.at.dtr;
    }
    if ((e = launch(pl, stream)) != 0) return e;
    gs = a.ds, gh = a.dh, gu = a.du;
  }
  if (n_launches == 0) return 0;
  e = reduce_shares(part, pl.w.r.n_shares, ddt, forced ? dcoef : nullptr, stream);
  if (e == 0 && strat) e = strat_reduce(st.acc, pl.n_tiles, k, dstrat, stream);
  return e;
}

}  // namespace

// Returns 0, kNotHexTable for a stencil or vertex table that is not the hex
// lattice's, or the CUDA error of the first launch that failed
// (cudaErrorInvalidValue for a plan the lattice or the card does not take:
// tiles that do not divide the lattice, a tile whose layouts exceed the
// shared memory, a scratch smaller than scratch_per_tile's per tile).
// The arguments are nl_adjoint.cu's entry's, with the resting thickness sum
// `rts` (the recompute's ssh) first, the tiles' `scratch` and its size, and
// q; the stacks hold the superstep-start states, one launch per superstep.
#define MOT_NL_WINDOW_ENTRY(T, SUFFIX)                                                         \
  extern "C" int mot_nl_window_adjoint_##SUFFIX(                                               \
      const T* rts, const T* fv, int n_fv, const int* live, const T* wind, const int* lvl,    \
      T* dwind, double* dcoef, const int* table, const double* weights, const int* adj,       \
      const double* adj_w, const int* vc, const double* vc_w, const int* ev, const T* ssh_st,  \
      const T* h_st, const T* u_st, const T* gs_in, const T* gh_in, const T* gu_in,            \
      T* gs_out, T* gh_out, T* gu_out, T* gs_tmp, T* gh_tmp, T* gu_tmp, double* part,          \
      double* ddt, const T* tr_st, const T* gtr_in, T* gtr_out, T* gtr_tmp, const T* h_end,   \
      const T* tr_end, const T* cmask, const T* strat_w, double* dw_acc, double* dstrat,      \
      T* scratch, long long scratch_values, double dt, double inv_dc, double s_div,           \
      double s_ke, double s_curl, double ds_scale, double dke_scale, double dlin,             \
      double dquad, double rayl, double kappa, double upwind, int lvl_ranks, int wind_ranks,  \
      int ny2, int nx, int k, int n_launches, int n_terms, int rt, int ct, int ks, int n_tr,  \
      int q, void* stream) {                                                                  \
    const ForcingArgs<T> fc{wind, lvl, T(dlin), T(dquad), T(rayl),                             \
                            static_cast<unsigned>(lvl_ranks),                                  \
                            static_cast<unsigned>(wind_ranks)};                                \
    const AdjTracers<T> at{tr_st, gtr_in, nullptr, nullptr, cmask, nullptr, T(kappa),          \
                           T(0.5 * upwind), n_tr};                                             \
    const AdjStrat<T> st{strat_w, dw_acc, 1};                                                  \
    return nl_window_rollout<T>(rts, fv, n_fv, live, fc, dwind, dcoef, at, gtr_out, gtr_tmp,   \
                                h_end, tr_end, st, dstrat, table, weights, adj, adj_w, vc,     \
                                vc_w, ev, ssh_st, h_st, u_st, gs_in, gh_in, gu_in, gs_out,     \
                                gh_out, gu_out, gs_tmp, gh_tmp, gu_tmp, part, ddt, scratch,    \
                                scratch_values, dt, inv_dc, s_div, s_ke, s_curl, ds_scale,     \
                                dke_scale, ny2, nx, k, n_launches, n_terms, rt, ct, ks, q,     \
                                static_cast<cudaStream_t>(stream));                            \
  }

MOT_NL_WINDOW_ENTRY(float, f32)
MOT_NL_WINDOW_ENTRY(double, f64)
