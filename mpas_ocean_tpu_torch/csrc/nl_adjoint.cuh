// Reverse (adjoint) of one nonlinear (vector-invariant) forward-Euler step of
// the TRiSK shallow-water core on the parity-plane hex lattice, for NVIDIA
// Hopper (sm_90a): one kernel, periodic and wall-masked, forced, with
// tracers and stratified in any combination, f32 and f64, instantiated per
// dtype and forcing in nl_adjoint_{f32,f64}{,_forced}.cu (8 arms each) and
// launched from nl_adjoint.cu.
//
// Replaces: the nonlinear arm of _adjoint_segment_kernel
// (mpas_ocean_tpu/structured/pallas_model.py:1480; its in-kernel jax.vjp of
// _step_planes with nl_terms, :1538, 1545-1590) and, at q = 1 (the only q the
// JAX router takes, _ADJ_Q_ORDER :2673), of _tiled_adjoint_kernel (:1979; the
// VJP of _window_steps at reach 2, :2050-2104), with the forced operands
// (:1514-1520; d(wind), d(coefs)), the tracer cotangent (gt_ref / gt_out,
// :1525-1526) and W (sw_ref, :1506-1510; d(W)). CUDA has no vjp, so the transpose is written out by
// hand; its plain version is structured/adjoint.structured_nl_adjoint_step,
// whose docstring derives it. One launch maps (primal state at step j, the
// vertex constants, cotangent at step j + 1) to the cotangent at step j and
// one d(dt) share per (tile, rank).
//
// Design: nl_step.cuh's two stages run backwards, as four stages over rings
// around the tile (structured/slab.nl_adjoint_rings derives them from the
// tables; tests check the constants below against it):
//   A (tile + (3, 4)): the primal F = u h_edge and q_e, as nl_step.cuh's
//     stage A computes them (hex_vert:: sources);
//   B (tile + (2, 2)): T(F), T^T(gu) and T^T(gu q_e) through the Coriolis
//     taps and their transposes, then dq_e = (a T(F) + F T^T(a)) / 2,
//     dF = dt s_div (G[nbr] - G[owner]) + (T^T(a q_e) + q_e T^T(a)) / 2 and
//     Sg = sum_owned gu - sum_incoming gu, a = dt gu; on the tile, the step's
//     d(dt) in edge form (s_div F dG + gu q_e T(F) / 2 + F q_e T^T(gu) / 2 per
//     owned edge, (g ssh + KE) Sg / dc per cell: the transposes of
//     <G, tend_h> and <gu, tend_u> summed by parts);
//   C (tile + (1, 1)): per vertex, dq_v = the endpoint mean's transpose of
//     dq_e, then dzeta s_curl = dq_v / h_v s_curl and dh_v = -dq_v q_v / h_v
//     (q_v and h_v recomputed from the state; on a channel the division
//     guarded where the vertex mask is 0, and dzeta times it);
//   D (the tile): du = gu + h_edge dF + 2 s_ke u (dKE_owner + dKE_nbr) + the
//     curl's transpose of dzeta s_curl, dh = G + sum over the 6 edges of
//     u dF / 2 + the kite's transpose of dh_v, dKE = dt Sg / dc; the level
//     sums of Sg for ds.
// Levels couple only through ds = (g / dc) dt sum_k Sg and d(dt): as in
// adjoint_step.cu, a thread-block cluster takes a tile, its blocks split the
// levels in power-of-two chunks (step_window.cuh), each block's per-site
// partial sums are added by rank 0 in rank order through distributed shared
// memory, and each block writes one d(dt) share that ddt_reduce adds in a
// fixed order: no atomics, so f64 reruns are bitwise equal. A block walks its
// chunk in slices of ks levels: each slice's window (the tile plus (4, 6)) of
// the primal h, u and the cotangent gh, gu comes in by async copies (16-byte
// ones where the shape allows; adjoint_window.cuh folds gs into gh and, on a
// channel, the wall mask into gu: fold_ssh, fold_live), then the four
// stages, one barrier apart; the window is single-buffered. The stencils are
// resolved once per call on the host into constant-bank offsets: the Coriolis
// table through resolve_taps (T) and resolve_adjoint_taps (T^T: hex_adj::),
// the vertex tables through hex_vert:: and their transposes hex_vadj::, which
// the host derives from the tables and checks; the kernel takes the hex
// lattice's tables only. Shared memory binds: 16 window values per
// site-level, 12 on ring A, 14 on ring B and 8 on ring C, so slices are
// 1-4 levels and a block takes an SM (kernels/adjoint_step.nl_adjoint_plan).
// What bounds it is read in PERF.md: per (m, i, k) site a primal state, a
// cotangent and the vertex constants read, a cotangent written (bytes, like
// the linear reverse), against ~3x the forward's arithmetic on rings that
// re-read the window 3.5-7.5x.
//
// The composed arms (template flags kForced, kTracers, kStrat, each off in
// the plain arm's code; structured/adjoint.structured_nl_adjoint_step with
// forcing=, tracers and strat=):
//   forced: Rayleigh's du -= dt lambda gu in stage D at every level (its
//     sum of gu u in double gives d(lambda) and d(dt)'s Rayleigh part), and
//     after stage D of each slice, in the ranks whose chunk holds some
//     edge's top or bottom level, two passes over the tile (a thread an
//     edge, then a cell; adjoint_window.cuh's wind_drag_adjoint and
//     wind_drag_dhe): at the slice's top and bottom levels the wind and drag
//     terms added to the stored du, d(wind) per edge in place (one block
//     owns each edge's top level), the d(r_lin) and d(Cd) shares, and the
//     h_edge cotangents added to the stored dh, half to each of the edge's
//     cells. The winds and packed levels are read from device memory there:
//     two levels of the K touch them, and shared memory is what bounds the
//     slice. A block writes kShares shares in double, summed in a fixed
//     order as adjoint_step.cu's forced arm does.
//   tracers: each slice's window carries the 2 nT tracer planes of the
//     primal and of the cotangent after the state's 8 (SK planes a state),
//     a and the h' feedback folded into G once per slice from h' and T' of
//     state j + 1 (the stack's next slot, or `end`: fold_tracers); stage B
//     adds the tracers' flux cotangent sum_t dg te to dF on ring B, where
//     the incoming edges' u dF reads it; stage D forms, per site-level, the
//     tracer cotangents, the kappa h_edge cotangents, sum_t a T and the
//     per-cell d(dt) terms (tracer_adjoint without the incoming edges' u dF),
//     and takes <G, tend_h> per cell from them in place of stage B's edge
//     form, as the linear tracer arm does.
//   stratified: stage D keeps the slice's S = Sg at the tile's cells in
//     shared memory, so that each rank holds its chunk of S on the tile
//     ([2][core][kc]) with its rows of W; after the slices a cluster barrier
//     and adjoint_window.cuh's strat_adjoint_pass (every rank's S read in
//     place, the rank's h from device memory) add (dt / dc) W S to the
//     stored dh and form the tile's d(W) rows in double into its
//     accumulator, summed over tiles by strat_reduce, no atomics.

#pragma once

#include "adjoint_window.cuh"
#include "nl_step.cuh"

namespace lattice {

// The transposes of the hex lattice's vertex stencils, grouped by output in
// the forward tables' order (structured/stencils.py: transpose_curl_terms,
// transpose_kite_terms, transpose_endpoint_terms; tests parse these maps).
namespace hex_vadj {
constexpr int kTaps = 12;
// the curl's: (channel, kind, p, dm, di, sign), 2 per channel
__host__ __device__ constexpr int curl_t(int t, int j) {
  constexpr int m[kTaps][6] = {{0, 0, 1, -1, 0, -1}, {0, 1, 0, 0, 0, 1},  {1, 0, 0, 0, 1, -1},
                               {1, 1, 1, 0, 0, 1},   {2, 0, 0, 0, 0, 1},  {2, 1, 0, 0, 0, -1},
                               {3, 0, 1, 0, 0, 1},   {3, 1, 1, 0, 0, -1}, {4, 0, 0, 0, 0, -1},
                               {4, 1, 0, 0, -1, 1},  {5, 0, 1, 0, 0, -1}, {5, 1, 1, 0, -1, 1}};
  return m[t][j];
}
// the kite average's: (p_in, kind, p_out, dm, di, kite tap), 6 per cell plane
__host__ __device__ constexpr int kite_t(int t, int j) {
  constexpr int m[kTaps][6] = {{0, 0, 0, 0, 0, 0},  {0, 0, 1, -1, -1, 4}, {0, 0, 1, -1, 0, 5},
                               {0, 1, 0, 0, 0, 6},  {0, 1, 0, 0, -1, 7},  {0, 1, 1, -1, -1, 11},
                               {1, 0, 0, 0, 0, 1},  {1, 0, 0, 0, 1, 2},   {1, 0, 1, 0, 0, 3},
                               {1, 1, 0, 0, 0, 8},  {1, 1, 1, 0, 0, 9},   {1, 1, 1, 0, -1, 10}};
  return m[t][j];
}
// the endpoint mean's: (kind, p, f_out, p_out, dm, di), 3 per vertex plane
__host__ __device__ constexpr int ev_t(int t, int j) {
  constexpr int m[kTaps][6] = {{0, 0, 0, 1, 0, -1}, {0, 0, 1, 0, 0, 0}, {0, 0, 2, 0, 0, 0},
                               {0, 1, 0, 0, 1, 0},  {0, 1, 1, 1, 0, 0}, {0, 1, 2, 1, 0, 0},
                               {1, 0, 0, 0, 0, 0},  {1, 0, 1, 0, 0, 0}, {1, 0, 2, 0, 0, 1},
                               {1, 1, 0, 1, 0, 0},  {1, 1, 1, 1, 0, 0}, {1, 1, 2, 1, 0, 1}};
  return m[t][j];
}
// hex_vert::'s vertex number (v_src) of the site's own vertex of plane
// kind * 2 + p
__host__ __device__ constexpr int own_v(int v4) {
  constexpr int m[4] = {4, 5, 1, 3};
  return m[v4];
}
}  // namespace hex_vadj

// The rings (rows, columns) per side around the tile of stages C, B and A
// and of the window (slab.nl_adjoint_rings on the hex tables).
constexpr int kRingCm = 1, kRingCi = 1, kRingBm = 2, kRingBi = 2, kRingAm = 3, kRingAi = 4;
constexpr int kWinM = 4, kWinI = 6;
// planes per site-level: the window's primal h, u and cotangent G, gu; ring
// A's F, q_e; ring B's dq_e, dF, Sg; ring C's dzeta s_curl, dh_v
constexpr int kWinPlanes = 16, kAPlanes = 12, kBPlanes = 14, kCPlanes = 8;

template <typename T>
struct NlAdjArgs {
  const T* ssh;  // primal state j
  const T* h;
  const T* u;
  const T* gs;  // cotangent j + 1
  const T* gh;
  const T* gu;
  const T* fv;      // vertex constants [n_fv][ny2][nx]
  const int* live;  // the masked arm's live bits, (ny2, nx); null otherwise
  T* ds;            // cotangent j
  T* dh;
  T* du;
  double* ddt_part;  // one share per block: (tile, rank); the forced arm's
                     // three more kinds n_shares apart
  ForcingArgs<T> fc;  // the forced arm's operands; wind null otherwise
  T* dwind;           // the forced arm's d(wind) (6, ny2, nx), added to
  AdjTracers<T> at;   // the tracer arm's operands; tr null otherwise
  AdjStrat<T> st;     // the stratified arm's operands; w null otherwise
  T dt, inv_dc, s_div, s_ke, s_curl;
  // g dt / dc and dt / dc, each rounded once from double on the host (a
  // product of rounded factors, applied at every site, would bias ds and
  // dKE by its rounding in f32)
  T ds_scale, dke_scale;
  int ny2, nx, K, rt, ct, n_fv, kc_log2, ks_log2, vec_log2, n_tiles_i;
  long long n_shares;
};

// The stencils as offsets, resolved once per call on the host (kernel
// parameters, in the constant bank). Window offsets in [16][W][ks] (the
// cotangent's from its base, plane 8), ring offsets in the rings' planes.
template <typename T>
struct NlAdjTaps {
  T w[hex::kTaps];       // Coriolis weights (T)
  T kw[hex_vert::kVC];   // kite weights (periodic arm)
  int a_u[hex_vert::kU];  // stage A, C, D: u sources in the window
  int a_h[hex_vert::kH];  //   h sources
  int a_v[hex_vert::kV];  //   endpoint vertices, window sites
  int b_f[hex::kU];       // stage B: F at T's u sources, ring A
  int b_q[hex_adj::kGu];  //   q_e at T^T's gu sources, ring A
  int c_q[hex_vadj::kTaps];   // stage C: dq_e at the endpoint mean's transposed taps, ring B
  int d_z[hex_vadj::kTaps];   // stage D: dzeta s_curl at the curl's transposed taps, ring C
  int d_hv[hex_vadj::kTaps];  //   dh_v at the kite's transposed taps, ring C
  int d_kw[hex_vadj::kTaps];  //   their vertices, window sites (the channel's kite planes)
  int d_ke[6];                //   Sg across channel c's owned edge, ring B
  int d_f[6];                 //   dF at incoming edge x = 3p + j, ring B
  AdjTaps<T> adj;  // T^T on the window: its weights, the gu and G sources of stage B,
                   // and the sources of the composed arms (as the linear reverse's)
};

// The vertex tables' transposes, derived on the host from the tables as
// structured/stencils.py derives them (grouped by output, stable), equal to
// hex_vadj::'s.
inline bool check_vertex_transposes(const int* vc, const int* ev) {
  int n = 0;
  for (int o = 0; o < 2; ++o)  // kite: (kind, p_out, p_in, dm, di) -> by p_in
    for (int t = 0; t < hex_vert::kVC; ++t) {
      const int* x = vc + 5 * t;
      if (x[2] != o) continue;
      const int want[6] = {x[2], x[0], x[1], -x[3], -x[4], t};
      for (int j = 0; j < 6; ++j)
        if (want[j] != hex_vadj::kite_t(n, j)) return false;
      ++n;
    }
  n = 0;
  for (int o = 0; o < 4; ++o)  // endpoint: (f_out, p_out, kind, p_in, dm, di) -> by kind, p_in
    for (int t = 0; t < hex_vert::kEV; ++t) {
      const int* x = ev + 6 * t;
      if (x[2] * 2 + x[3] != o) continue;
      const int want[6] = {x[2], x[3], x[0], x[1], -x[4], -x[5]};
      for (int j = 0; j < 6; ++j)
        if (want[j] != hex_vadj::ev_t(n, j)) return false;
      ++n;
    }
  return n == hex_vadj::kTaps;
}

// The tables resolved for a tile of rt x ct sites in slices of ks levels;
// false for a table that is not the hex lattice's.
template <typename T>
inline bool resolve_nl_adjoint_taps(NlAdjTaps<T>* s, const int* table, const double* weights,
                                    const int* adj, const double* adj_w, const int* vc,
                                    const double* vc_w, const int* ev, int rt, int ct, int ks) {
  for (int t = 0; t < hex_vert::kVC; ++t) {
    for (int j = 0; j < 5; ++j)
      if (vc[5 * t + j] != hex_vert::vc_tap(t, j)) return false;
    s->kw[t] = static_cast<T>(vc_w[t]);
  }
  for (int t = 0; t < hex_vert::kEV; ++t)
    for (int j = 0; j < 6; ++j)
      if (ev[6 * t + j] != hex_vert::ev_tap(t, j)) return false;
  if (!check_vertex_transposes(vc, ev)) return false;
  const int Wi = ct + 2 * kWinI, W = (rt + 2 * kWinM) * Wi;
  const int Ai = ct + 2 * kRingAi, A = (rt + 2 * kRingAm) * Ai;
  const int Bi = ct + 2 * kRingBi, B = (rt + 2 * kRingBm) * Bi;
  const int Ci = ct + 2 * kRingCi, C = (rt + 2 * kRingCm) * Ci;
  StepTaps<T> fwd;  // T on ring A's geometry: u sources ((2 + c) * A + site) * ks
  if (!resolve_taps<T>(&fwd, table, weights, Ai, A, ks)) return false;
  AdjTaps<T> win, ring;  // T^T on the window's and on ring A's geometry
  if (!resolve_adjoint_taps<T>(&win, adj, adj_w, Wi, W, ks) ||
      !resolve_adjoint_taps<T>(&ring, adj, adj_w, Ai, A, ks))
    return false;
  s->adj = win;
  for (int t = 0; t < hex::kTaps; ++t) s->w[t] = fwd.w[t];
  for (int i = 0; i < hex::kU; ++i) s->b_f[i] = fwd.us[i] - 2 * A * ks;        // F: planes 0-5
  for (int i = 0; i < hex_adj::kGu; ++i) s->b_q[i] = ring.us[i] + 4 * A * ks;  // q_e: 6-11
  for (int i = 0; i < hex_vert::kU; ++i)
    s->a_u[i] = ((2 + hex_vert::u_src(i, 0)) * W + hex_vert::u_src(i, 1) * Wi +
                 hex_vert::u_src(i, 2)) * ks;
  for (int i = 0; i < hex_vert::kH; ++i)
    s->a_h[i] = (hex_vert::h_src(i, 0) * W + hex_vert::h_src(i, 1) * Wi +
                 hex_vert::h_src(i, 2)) * ks;
  for (int i = 0; i < hex_vert::kV; ++i)
    s->a_v[i] = hex_vert::v_src(i, 1) * Wi + hex_vert::v_src(i, 2);
  for (int t = 0; t < hex_vadj::kTaps; ++t) {
    using namespace hex_vadj;
    s->c_q[t] = ((ev_t(t, 2) * 2 + ev_t(t, 3)) * B + ev_t(t, 4) * Bi + ev_t(t, 5)) * ks;
    s->d_z[t] = ((curl_t(t, 1) * 2 + curl_t(t, 2)) * C + curl_t(t, 3) * Ci + curl_t(t, 4)) * ks;
    s->d_hv[t] =
        ((4 + kite_t(t, 1) * 2 + kite_t(t, 2)) * C + kite_t(t, 3) * Ci + kite_t(t, 4)) * ks;
    s->d_kw[t] = kite_t(t, 3) * Wi + kite_t(t, 4);
  }
  for (int c = 0; c < 6; ++c) {
    const int* tn = table + kNbr + 3 * c;
    s->d_ke[c] = ((12 + tn[0]) * B + tn[1] * Bi + tn[2]) * ks;
  }
  for (int x = 0; x < 6; ++x) {
    const int* tc = table + kInc + 3 * x;
    s->d_f[x] = ((6 + tc[0]) * B + tc[1] * Bi + tc[2]) * ks;
  }
  return true;
}

// q_v of hex_vert:: vertex v and its guarded thickness (h_v, or 1 at a dead
// vertex of a channel) from the window's sources u[], h[], as nl_step.cuh's
// stage A computes them; fv_s at the vertex's window site sv, w0..w2 its kite
// taps' weights (periodic arm).
template <typename T, bool kMasked>
__device__ __forceinline__ T vertex_pv(const T* u, const T* h, const T* fv_s, int W, int sv,
                                       int v, T s_curl, T w0, T w1, T w2, T* safe) {
  using namespace hex_vert;
  const int cls = v_src(v, 0);
  const T zeta = (cls < 2 ? (u[curl_u(v, 0)] - u[curl_u(v, 1)]) - u[curl_u(v, 2)]
                          : (u[curl_u(v, 0)] + u[curl_u(v, 1)]) - u[curl_u(v, 2)]) *
                 s_curl;
  const T ws[3] = {w0, w1, w2};
  T hv = T(0);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const T wgt = kMasked ? fv_s[(8 + kite_t(v, j)) * W + sv] : ws[j];
    const T contrib = wgt * h[kite_h(v, j)];
    hv = j == 0 ? contrib : hv + contrib;
  }
  const T num = fv_s[cls * W + sv] + zeta;
  if (kMasked) {
    const T vm = fv_s[(4 + cls) * W + sv];
    *safe = vm > T(0) ? hv : T(1);
    return num / *safe * vm;
  }
  *safe = hv;
  return num / hv;
}

// The tracers' flux cotangent at the owned edge of channel ch of a
// site-level: sum_t dg te, dg = dt s_div (a_nb - a_own), the sign of the
// edge's primal flux F held fixed (tracer_edge_adjoint, summed as
// tracer_adjoint sums its trF). P and C point at the site-level in the
// window's primal and cotangent slices, the tracer planes after the
// state's 8, pk values a plane apart.
template <typename T>
__device__ __forceinline__ T tracer_dflux(const T* P, const T* C, int pk, const AdjTaps<T>& tp,
                                          const AdjTracers<T>& at, int ch, T F, T dt_div,
                                          T inv_dc) {
  const int o = tp.hs[hex::self_h(ch & 1)], nb = tp.hs[hex::nb_h(ch)];
  T sum = T(0);
  for (int t = 0; t < at.n; ++t) {
    const T* tv = P + (8 + 2 * t) * pk;
    const T* av = C + (8 + 2 * t) * pk;
    T dF, dtn, dto, dhe, g;
    tracer_edge_adjoint(F, T(0), tv[nb], tv[o], dt_div * (av[nb] - av[o]), false, at, inv_dc,
                        &dF, &dtn, &dto, &dhe, &g);
    sum += dF;
  }
  return sum;
}

// The forced arm's passes after stage D of a slice (levels kb .. kb + kn -
// 1 of the block's chunk from k0), over the tile's rt x ct sites: first a
// thread an owned edge, which at the edge's top and bottom level in the
// slice adds the wind and drag terms to the stored du and d(wind), and
// their d(dt), d(r_lin) and d(Cd) terms to *dd, *d_lin, *d_quad; then a
// thread a cell, which at each slice level that is the top or bottom level
// of one of its 6 edges adds 1/2 their h_edge cotangents to the stored dh
// (as dh_pass<true>). `st` and `cot` are the window's primal and (folded)
// cotangent slices, the winds and packed levels are read from device memory
// (incoming edges at their owners' lattice sites, gsite).
template <typename T>
__device__ __forceinline__ void nl_forcing_passes(const NlAdjArgs<T>& a, const AdjTaps<T>& tp,
                                                  const T* st, const T* cot, const int* gsite,
                                                  int tm, int ti, int Wi, int kb, int kn, int k0,
                                                  double* dd, double* d_lin, double* d_quad) {
  const int ks = 1 << a.ks_log2, core = a.rt * a.ct, plane = a.ny2 * a.nx, K = a.K;
  const FastDiv by_ct(a.ct);
  for (int e = threadIdx.x; e < 6 * core; e += blockDim.x) {
    const int ch = e / core, t = e - ch * core;
    const int r = by_ct.div(t), c = by_ct.mod(t, r);
    const int gm = tm * a.rt + r, gi = ti * a.ct + c;
    if (gm >= a.ny2 || gi >= a.nx) continue;
    const int g = gm * a.nx + gi;
    const int lv = a.fc.lvl[ch * plane + g];
    int lev[2];
    chunk_levels(lv, k0 + kb, kn, &lev[0], &lev[1]);
    const int sw = (r + kWinM) * Wi + c + kWinI;
    for (int j = 0; j < 2; ++j) {
      const int kl = lev[j];
      if (kl < 0) continue;
      const T* v = st + sw * ks + kl;
      const T* gq = cot + sw * ks + kl;
      const int us = tp.us[hex::self_u(ch)];
      const T he = T(0.5) * (v[tp.hs[hex::nb_h(ch)]] + v[tp.hs[hex::self_h(ch & 1)]]);
      T du = T(0);
      wind_drag_adjoint(gq[us], v[us], he, lv, k0 + kb + kl, a.fc.wind + ch * plane + g,
                        a.dwind + ch * plane + g, a.fc, a.dt, &du, dd, d_lin, d_quad);
      T& o = a.du[(static_cast<size_t>(ch) * plane + g) * K + k0 + kb + kl];
      o = o + du;
    }
  }
  for (int e = threadIdx.x; e < 2 * core; e += blockDim.x) {
    const int p = e >= core ? 1 : 0, t = e - p * core;
    const int r = by_ct.div(t), c = by_ct.mod(t, r);
    const int gm = tm * a.rt + r, gi = ti * a.ct + c;
    if (gm >= a.ny2 || gi >= a.nx) continue;
    const int g = gm * a.nx + gi;
    const int sw = (r + kWinM) * Wi + c + kWinI;
    // the 6 edges: owned i = f (channel 2f + p), incoming x = 3p + i - 3
    int lv[6], ew[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      ew[i] = i < 3 ? (2 * i + p) * plane + g
                    : tp.inc_ch[3 * p + i - 3] * plane + gsite[sw + tp.inc_off[3 * p + i - 3]];
      lv[i] = a.fc.lvl[ew[i]];
    }
    for (int m = 0; m < 12; ++m) {
      int lev[2];
      chunk_levels(lv[m >> 1], k0 + kb, kn, &lev[0], &lev[1]);
      const int kl = lev[m & 1];
      if (kl < 0) continue;
      bool seen = false;  // the level of an earlier (edge, end)
      for (int m2 = 0; m2 < m; ++m2) {
        int l2[2];
        chunk_levels(lv[m2 >> 1], k0 + kb, kn, &l2[0], &l2[1]);
        seen = seen || l2[m2 & 1] == kl;
      }
      if (seen) continue;
      const T* v = st + sw * ks + kl;
      const T* gq = cot + sw * ks + kl;
      const T hc = v[tp.hs[hex::self_h(p)]];
      T dhe = T(0);
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const int ch = 2 * f + p, us = tp.us[hex::self_u(ch)];
        dhe += wind_drag_dhe(gq[us], v[us], T(0.5) * (v[tp.hs[hex::nb_h(ch)]] + hc), lv[f],
                             k0 + kb + kl, a.fc.wind + ew[f], a.fc, a.dt);
      }
#pragma unroll
      for (int x = 3 * p; x < 3 * p + 3; ++x) {
        const int us = tp.us[hex::inc_u(x)];
        dhe += wind_drag_dhe(gq[us], v[us],
                             T(0.5) * (v[tp.hs[hex::inc_nb_h(x)]] + v[tp.hs[hex::inc_self_h(x)]]),
                             lv[x - 3 * p + 3], k0 + kb + kl, a.fc.wind + ew[x - 3 * p + 3], a.fc,
                             a.dt);
      }
      T& o = a.dh[(static_cast<size_t>(p) * plane + g) * K + k0 + kb + kl];
      o = o + T(0.5) * dhe;
    }
  }
}

// One reverse step; a cluster of n_ranks blocks per tile, blocks of
// kStepThreads threads, groups of ks lanes on one site's slice levels.
template <typename T, bool kMasked, bool kForced, bool kTracers, bool kStrat>
__global__ void __launch_bounds__(kStepThreads, 1)
    nl_adjoint_kernel(const NlAdjArgs<T> a, const NlAdjTaps<T> tp) {
  using namespace hex_vert;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int tile = blockIdx.x / n_ranks;
  const int tm = tile / a.n_tiles_i, ti = tile % a.n_tiles_i;
  const int Wi = a.ct + 2 * kWinI, W = (a.rt + 2 * kWinM) * Wi;
  const int Ai = a.ct + 2 * kRingAi, A = (a.rt + 2 * kRingAm) * Ai;
  const int Bi = a.ct + 2 * kRingBi, B = (a.rt + 2 * kRingBm) * Bi;
  const int Ci = a.ct + 2 * kRingCi, C = (a.rt + 2 * kRingCm) * Ci;
  const int core = a.rt * a.ct;
  const int kc = 1 << a.kc_log2, ks = 1 << a.ks_log2;
  const int k0 = rank * kc, kr = min(kc, a.K - k0);
  const int n_slices = (kr + ks - 1) >> a.ks_log2;
  const int plane = a.ny2 * a.nx;
  const int K = a.K;
  const int WK = W * ks, AK = A * ks, BK = B * ks, CK = C * ks;
  // the tracer arm's planes follow the state's, in the primal and the cotangent
  const int n_pl = kTracers ? 8 + 2 * a.at.n : 8;

  double* red = reinterpret_cast<double*>(smem_raw);  // [kRedDoubles]
  T* st = reinterpret_cast<T*>(red + kRedDoubles);    // [n_pl][W][ks]: h, u, T
  T* cot = st + n_pl * WK;                            // [n_pl][W][ks]: G, gu, a
  T* pa = st + 2 * n_pl * WK;                         // [12][A][ks]: F, q_e
  T* pb = pa + kAPlanes * AK;                         // [14][B][ks]: dq_e, dF, Sg
  T* pc = pb + kBPlanes * BK;                         // [8][C][ks]: dzeta s_curl, dh_v
  T* ssh_s = pc + kCPlanes * CK;                      // [2][W]
  T* gs_s = ssh_s + 2 * W;                            // [2][W]
  T* fv_s = gs_s + 2 * W;                             // [kFv][W]
  T* part = fv_s + kFv * W;                           // [2][core]: sum over levels of Sg
  int* gsite = reinterpret_cast<int*>(part + 2 * core);  // [W]
  int* live_s = gsite + W;                               // [W]
  // the stratified arm's S chunk on the tile and W rows
  const StratAdjSmem<T> ssm(live_s + W, core, 1 << a.kc_log2);

  allow_next_grid();
  window_sites(gsite, tm * a.rt - kWinM, ti * a.ct - kWinI, Wi, W, a.ny2, a.nx, 0);
  __syncthreads();
  wait_previous_grid();
  for (int s = threadIdx.x; s < W; s += blockDim.x) {
    const int g = gsite[s];
    for (int p = 0; p < 2; ++p) {
      copy_async(ssh_s + p * W + s, a.ssh + p * plane + g);
      copy_async(gs_s + p * W + s, a.gs + p * plane + g);
    }
    for (int x = 0; x < a.n_fv; ++x) copy_async(fv_s + x * W + s, a.fv + x * plane + g);
  }
  if (kMasked) load_live(live_s, gsite, a.live, W);
  if (kStrat) load_strat_rows(ssm, a.st.w, core, K, k0, kr, a.kc_log2);
  __pipeline_commit();

  const T dt_div = a.dt * a.s_div;
  const T two_ske = T(2) * a.s_ke;
  const T grav = T(kGravity);
  const FastDiv by_ai(Ai), by_bi(Bi), by_ci(Ci), by_ct(a.ct);
  const int lane_mask = ks - 1;
  double share = 0.0;
  // the forced arm: dt lambda; the sums, in double, of gu u (Rayleigh) and
  // of the d(r_lin) and d(Cd) shares; whether this rank's chunk holds some
  // edge's top or bottom level (its passes run)
  const T dt_rayl = a.dt * a.fc.rayl;
  double s_rayl = 0.0, s_lin = 0.0, s_quad = 0.0;
  const bool wd = kForced && ((a.fc.lvl_ranks >> rank) & 1u);

  for (int sl = 0; sl < n_slices; ++sl) {
    const int kb = sl * ks;           // the slice's first level in the chunk
    const int kn = min(ks, kr - kb);  // its real levels
    load_slice(st, gsite, a.h, a.u, W, a.ks_log2, a.vec_log2, k0 + kb, kn, K, plane);
    load_slice(cot, gsite, a.gh, a.gu, W, a.ks_log2, a.vec_log2, k0 + kb, kn, K, plane);
    if (kTracers) {
      load_tracers(st + 8 * WK, gsite, a.at.tr, 2 * a.at.n, W, a.ks_log2, a.vec_log2, k0 + kb,
                   kn, K, plane);
      load_tracers(cot + 8 * WK, gsite, a.at.gtr, 2 * a.at.n, W, a.ks_log2, a.vec_log2, k0 + kb,
                   kn, K, plane);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    fold_ssh(cot, gs_s, W, Wi, 0, 0, a.rt + 2 * kWinM, Wi, ks, a.ks_log2, kn);
    if (kMasked) fold_live(cot + 2 * WK, live_s, W, ks, kn);
    __syncthreads();
    if (kTracers) {  // a = c gT' / h' and the h' feedback into G
      fold_tracers(cot, gsite, a.at, W, ks, a.ks_log2, k0 + kb, kn, K, plane);
      __syncthreads();
    }

    // stage A: the primal F and q_e on ring A
    for (int e = threadIdx.x; e < A * ks; e += blockDim.x) {
      const int d = e >> a.ks_log2, kl = e & lane_mask;
      if (kl >= kn) continue;
      const int r = by_ai.div(d), c = by_ai.mod(d, r);
      const int sw = (r + kWinM - kRingAm) * Wi + c + kWinI - kRingAi;
      const T* lv = st + sw * ks + kl;
      T u[kU], h[kH], qv[kV];
#pragma unroll
      for (int i = 0; i < kU; ++i) u[i] = lv[tp.a_u[i]];
#pragma unroll
      for (int i = 0; i < kH; ++i) h[i] = lv[tp.a_h[i]];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        T safe;
        qv[v] = vertex_pv<T, kMasked>(u, h, fv_s, W, sw + tp.a_v[v], v, a.s_curl,
                                      tp.kw[kite_t(v, 0)], tp.kw[kite_t(v, 1)],
                                      tp.kw[kite_t(v, 2)], &safe);
      }
      T* out = pa + d * ks + kl;
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) {
        out[ch * AK] = u[ch] * (T(0.5) * (h[nb_h(ch)] + h[ch & 1]));
        out[(6 + ch) * AK] = T(0.5) * (qv[ev_v(2 * ch)] + qv[ev_v(2 * ch + 1)]);
      }
    }
    __syncthreads();

    // stage B: dq_e, dF and Sg on ring B; on the tile, the step's d(dt)
    for (int e = threadIdx.x; e < B * ks; e += blockDim.x) {
      const int d = e >> a.ks_log2, kl = e & lane_mask;
      if (kl >= kn) continue;
      const int r = by_bi.div(d), c = by_bi.mod(d, r);
      const int sw = (r + kWinM - kRingBm) * Wi + c + kWinI - kRingBi;
      const T* cv = cot + sw * ks + kl;
      const T* fa = pa + ((r + kRingAm - kRingBm) * Ai + c + kRingAi - kRingBi) * ks + kl;
      T gu[hex_adj::kGu], G[hex_adj::kG];
#pragma unroll
      for (int x = 0; x < hex_adj::kGu; ++x) gu[x] = cv[tp.adj.us[x]];
#pragma unroll
      for (int x = 0; x < hex_adj::kG; ++x) G[x] = cv[tp.adj.hs[x]];
      const int gm = tm * a.rt + r - kRingBm, gi = ti * a.ct + c - kRingBi;
      const bool on_tile = r >= kRingBm && r < kRingBm + a.rt && c >= kRingBi &&
                           c < kRingBi + a.ct && gm < a.ny2 && gi < a.nx;
      T* out = pb + d * ks + kl;
      T part_dt = T(0);
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) {
        T tf = T(0), tg = T(0), tgq = T(0);
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int t2 = 8 * ch + x;
          const int src = hex_adj::tap_u(t2);
          const T c1 = tp.w[t2] * fa[tp.b_f[hex::tap_u(t2)]];
          const T c2 = tp.adj.w[t2] * gu[src];
          const T c3 = tp.adj.w[t2] * (gu[src] * fa[tp.b_q[src]]);
          tf = x == 0 ? c1 : tf + c1;
          tg = x == 0 ? c2 : tg + c2;
          tgq = x == 0 ? c3 : tgq + c3;
        }
        const T ta = a.dt * tg;
        const T Fc = fa[ch * AK], qc = fa[(6 + ch) * AK];
        const T ac = a.dt * gu[ch];
        const T dG = G[hex::nb_h(ch)] - G[ch & 1];
        out[ch * BK] = T(0.5) * (ac * tf + Fc * ta);
        T dF = dG * dt_div + T(0.5) * (a.dt * tgq + qc * ta);
        if (kTracers)
          dF += tracer_dflux(st + sw * ks + kl, cv, WK, tp.adj, a.at, ch, Fc, dt_div, a.inv_dc);
        out[(6 + ch) * BK] = dF;
        // <G, tend_h>'s edge term; the tracer arm takes it per cell in stage D
        if (on_tile)
          part_dt += (kTracers ? T(0.5) * gu[ch] * qc * tf
                               : a.s_div * Fc * dG + T(0.5) * gu[ch] * qc * tf) +
                     T(0.5) * (Fc * qc) * tg;
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const T sg = ((gu[p] + gu[2 + p]) + gu[4 + p]) - gu[hex::inc_u(3 * p)] -
                     gu[hex::inc_u(3 * p + 1)] - gu[hex::inc_u(3 * p + 2)];
        out[(12 + p) * BK] = sg;
        if (on_tile) {
          const T* lv = st + sw * ks + kl;
          T ke = T(0);
#pragma unroll
          for (int x = 0; x < 3; ++x) {
            const T v = lv[tp.a_u[2 * x + p]];
            ke += v * v;
          }
#pragma unroll
          for (int x = 3 * p; x < 3 * p + 3; ++x) {
            const T v = lv[tp.a_u[inc_u(x)]];
            ke += v * v;
          }
          part_dt += (grav * ssh_s[p * W + sw] + ke * a.s_ke) * a.inv_dc * sg;
        }
      }
      if (on_tile) share += static_cast<double>(part_dt);
    }
    __syncthreads();

    // stage C: the vertex cotangents on ring C
    for (int e = threadIdx.x; e < C * ks; e += blockDim.x) {
      const int d = e >> a.ks_log2, kl = e & lane_mask;
      if (kl >= kn) continue;
      const int r = by_ci.div(d), c = by_ci.mod(d, r);
      const int sw = (r + kWinM - kRingCm) * Wi + c + kWinI - kRingCi;
      const T* lv = st + sw * ks + kl;
      const T* qb = pb + ((r + kRingBm - kRingCm) * Bi + c + kRingBi - kRingCi) * ks + kl;
      T u[kU], h[kH];
#pragma unroll
      for (int i = 0; i < kU; ++i) u[i] = lv[tp.a_u[i]];
#pragma unroll
      for (int i = 0; i < kH; ++i) h[i] = lv[tp.a_h[i]];
      T* out = pc + d * ks + kl;
#pragma unroll
      for (int v4 = 0; v4 < 4; ++v4) {
        const T dqv = T(0.5) * ((qb[tp.c_q[3 * v4]] + qb[tp.c_q[3 * v4 + 1]]) +
                                qb[tp.c_q[3 * v4 + 2]]);
        T safe;
        const int v = hex_vadj::own_v(v4);
        const T qv = vertex_pv<T, kMasked>(u, h, fv_s, W, sw, v, a.s_curl,
                                           tp.kw[kite_t(v, 0)], tp.kw[kite_t(v, 1)],
                                           tp.kw[kite_t(v, 2)], &safe);
        const T dz = kMasked ? dqv * fv_s[(4 + v4) * W + sw] / safe : dqv / safe;
        out[v4 * CK] = dz * a.s_curl;
        out[(4 + v4) * CK] = -(dqv * qv) / safe;
      }
    }
    __syncthreads();

    // stage D on the tile: du, dh stored; each slice's level sums of Sg
    // added to the block's partial sums in order
    for (int e0 = 0; e0 < core * ks; e0 += blockDim.x) {
      const int e = e0 + threadIdx.x;
      const int t = e >> a.ks_log2, kl = e & lane_mask;
      const int tt = e < core * ks ? t : 0;
      const int r = by_ct.div(tt), c = by_ct.mod(tt, r);
      const int gm = tm * a.rt + r, gi = ti * a.ct + c;
      const bool on = e < core * ks && kl < kn;
      T sg[2] = {T(0), T(0)};
      if (on) {
        const int sw = (r + kWinM) * Wi + c + kWinI;
        const T* lv = st + sw * ks + kl;
        const T* cv = cot + sw * ks + kl;
        const T* qb = pb + ((r + kRingBm) * Bi + c + kRingBi) * ks + kl;
        const T* qc = pc + ((r + kRingCm) * Ci + c + kRingCi) * ks + kl;
        const bool inside = gm < a.ny2 && gi < a.nx;
        const size_t g = static_cast<size_t>(gm) * a.nx + gi;
        sg[0] = qb[12 * BK];
        sg[1] = qb[13 * BK];
        // the tracer arm's terms of dh (the kappa h_edge cotangents, sum_t
        // a T), its tracer cotangents and its per-cell d(dt) terms
        T trX[2] = {T(0), T(0)}, trY[2] = {T(0), T(0)};
        if (kTracers) {
          T trF[6];
          double trdd = 0.0;
          const unsigned live = kMasked ? static_cast<unsigned>(live_s[sw]) : 0u;
          const unsigned inc_live = kMasked ? adj_incoming_live(live_s, sw, tp.adj) : 0u;
          tracer_adjoint<T, kMasked>(
              lv, cv, WK, tp.adj, a.at, live, inc_live, dt_div, a.s_div, a.inv_dc, trF, trX, trY,
              &trdd,
              [&](int i, T v) {
                if (inside) a.at.dtr[(static_cast<size_t>(i) * plane + g) * K + k0 + kb + kl] = v;
              },
              false);
          if (inside) share += trdd;
        }
        if (kStrat && inside) {  // the tile's S chunk, for the stratified pass
          ssm.sl[(t << a.kc_log2) + kb + kl] = sg[0];
          ssm.sl[((core + t) << a.kc_log2) + kb + kl] = sg[1];
        }
        T du[6], dh[2];
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) {
          const T he = T(0.5) * (lv[tp.a_h[nb_h(ch)]] + lv[tp.a_h[ch & 1]]);
          const T dke = a.dke_scale * qb[tp.d_ke[ch]] + a.dke_scale * sg[ch & 1];
          const T uc = lv[tp.a_u[ch]];
          T curl = T(0);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int t2 = 2 * ch + j;
            const T v = hex_vadj::curl_t(t2, 5) > 0 ? qc[tp.d_z[t2]] : -qc[tp.d_z[t2]];
            curl = j == 0 ? v : curl + v;
          }
          du[ch] = ((cv[(2 + ch) * WK] + he * qb[(6 + ch) * BK]) + two_ske * uc * dke) + curl;
          if (kForced) {
            const T gue = cv[(2 + ch) * WK];
            du[ch] = du[ch] - dt_rayl * gue;
            if (inside) s_rayl = fma(static_cast<double>(gue), static_cast<double>(uc), s_rayl);
          }
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          T flux = (lv[tp.a_u[p]] * qb[(6 + p) * BK] + lv[tp.a_u[2 + p]] * qb[(8 + p) * BK]) +
                   lv[tp.a_u[4 + p]] * qb[(10 + p) * BK];
#pragma unroll
          for (int x = 3 * p; x < 3 * p + 3; ++x) flux += lv[tp.a_u[inc_u(x)]] * qb[tp.d_f[x]];
          T kite = T(0);
#pragma unroll
          for (int j = 0; j < 6; ++j) {
            const int t2 = 6 * p + j;
            const T wgt = kMasked ? fv_s[(8 + hex_vadj::kite_t(t2, 5)) * W + sw + tp.d_kw[t2]]
                                  : tp.kw[hex_vadj::kite_t(t2, 5)];
            const T v = wgt * qc[tp.d_hv[t2]];
            kite = j == 0 ? v : kite + v;
          }
          dh[p] = kTracers ? ((cv[p * WK] + T(0.5) * (flux + trX[p])) + kite) + trY[p]
                           : (cv[p * WK] + T(0.5) * flux) + kite;
        }
        if (inside) {
          T* h_o = a.dh + (gm * a.nx + gi) * K + k0 + kb + kl;
          T* u_o = a.du + (gm * a.nx + gi) * K + k0 + kb + kl;
#pragma unroll
          for (int p = 0; p < 2; ++p) h_o[p * plane * K] = dh[p];
#pragma unroll
          for (int ch = 0; ch < 6; ++ch) u_o[ch * plane * K] = du[ch];
        }
      }
      const T s0 = group_sum(sg[0], ks), s1 = group_sum(sg[1], ks);
      if (e < core * ks && kl == 0) {
        part[t] = sl == 0 ? s0 : part[t] + s0;
        part[core + t] = sl == 0 ? s1 : part[core + t] + s1;
      }
    }
    __syncthreads();
    if (wd) {  // the wind and drag at the slice's top and bottom levels
      nl_forcing_passes(a, tp.adj, st, cot, gsite, tm, ti, Wi, kb, kn, k0, &share, &s_lin,
                        &s_quad);
      __syncthreads();
    }
  }
  if (kStrat) {
    // W dPhi into the stored dh, the tile's d(W) rows and d(dt)'s h @ W
    // part, once every rank's S chunk is visible; h from device memory
    cluster.sync();
    strat_adjoint_pass(
        ssm, cluster,
        [&](int p, int r, int c, int kl) -> T {
          const int gm = tm * a.rt + r, gi = ti * a.ct + c;
          return gm < a.ny2 && gi < a.nx
                     ? a.h[(static_cast<size_t>(p) * plane + gm * a.nx + gi) * K + k0 + kl]
                     : T(0);
        },
        a.st.acc + static_cast<size_t>(tile) * K * K, a.st.first != 0,
        [&](int p, int t, int kl) -> T* {
          const int r = by_ct.div(t), c = by_ct.mod(t, r);
          const int gm = tm * a.rt + r, gi = ti * a.ct + c;
          return gm < a.ny2 && gi < a.nx
                     ? a.dh + (static_cast<size_t>(p) * plane + gm * a.nx + gi) * K + k0 + kl
                     : nullptr;
        },
        core, a.ct, a.kc_log2, k0, kr, K, n_ranks, a.dt, a.inv_dc, &share);
  }
  // the forced arm's Rayleigh part of d(dt), -lambda sum gu u
  if (kForced) share -= static_cast<double>(a.fc.rayl) * s_rayl;
  share_warps(share, red);

  // ds = (g / dc) dt * the ranks' partial sums, added by rank 0 in rank
  // order; each block's d(dt) share, and the forced arm's three more
  cluster.sync();
  if (threadIdx.x == 0) a.ddt_part[blockIdx.x] = share_total(red);
  if (kForced)
    write_forcing_shares(red, a.ddt_part + blockIdx.x, a.n_shares, s_lin, s_quad, s_rayl,
                         static_cast<double>(a.dt));
  if (rank == 0) {
    for (int e = threadIdx.x; e < 2 * core; e += blockDim.x) {
      const int p = e >= core ? 1 : 0, x = e - p * core;
      const int r = by_ct.div(x), c = by_ct.mod(x, r);
      const int gm = tm * a.rt + r, gi = ti * a.ct + c;
      if (gm >= a.ny2 || gi >= a.nx) continue;
      T v = part[e];
      for (int rr = 1; rr < n_ranks; ++rr) v += *cluster.map_shared_rank(part + e, rr);
      a.ds[p * plane + gm * a.nx + gi] = a.ds_scale * v;
    }
  }
  // no block may leave while rank 0 can still read its partial sums
  cluster.sync();
}

// Dynamic shared memory of one block (kernels/adjoint_step.nl_adjoint_smem_bytes
// mirrors this): the warps' d(dt) sums; the window's slice of the primal
// state and the cotangent, with the tracer arm's 2 n_tr planes each, the
// rings' planes; the window's ssh, gs and vertex constants (20 planes, the
// masked arm's, reserved by the periodic one too); the partial sums; the
// window's sites with their live bits; the stratified arm's S chunk and W
// rows at strat_k levels in chunks of kc (strat_k > 0). The forced arm
// takes none.
inline size_t nl_adjoint_smem_bytes(int rt, int ct, int ks, size_t itemsize, int n_tr = 0,
                                    int kc = 0, int strat_k = 0) {
  const long long W = static_cast<long long>(rt + 2 * kWinM) * (ct + 2 * kWinI);
  const long long A = static_cast<long long>(rt + 2 * kRingAm) * (ct + 2 * kRingAi);
  const long long B = static_cast<long long>(rt + 2 * kRingBm) * (ct + 2 * kRingBi);
  const long long C = static_cast<long long>(rt + 2 * kRingCm) * (ct + 2 * kRingCi);
  const long long vals = ((kWinPlanes + 4LL * n_tr) * W + kAPlanes * A + kBPlanes * B +
                          kCPlanes * C) * ks +
                         (4 + hex_vert::kFv) * W + 2LL * rt * ct;
  return sizeof(double) * kRedDoubles + itemsize * static_cast<size_t>(vals) +
         2 * sizeof(int) * static_cast<size_t>(W) +
         (strat_k > 0 ? strat_adj_smem_bytes(rt * ct, kc, strat_k, itemsize) : 0);
}

// One call's launch set-up.
template <typename T>
struct NlAdjPlan {
  NlAdjArgs<T> a;
  NlAdjTaps<T> tp;
  int n_ranks, n_tiles, max_smem;
  size_t smem;
};

template <typename T, bool kMasked, bool kForced, bool kTracers, bool kStrat>
int nl_adj_prepare(int max_smem) {
  static bool done = false;
  if (done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(nl_adjoint_kernel<T, kMasked, kForced, kTracers, kStrat>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  done = e == cudaSuccess;
  return static_cast<int>(e);
}

// One launch of an arm's instantiation with the plan's operands; returns 0
// or the CUDA error. Each nl_adjoint_{f32,f64}{,_forced}.cu instantiates 8
// of the 32 (MOT_NL_ADJ_ARMS), and nl_adjoint.cu, which launches them,
// declares them extern, so that the arms compile in parallel.
template <typename T, bool kMasked, bool kForced, bool kTracers, bool kStrat>
int nl_adj_launch(const NlAdjPlan<T>& pl, cudaStream_t stream) {
  int err = nl_adj_prepare<T, kMasked, kForced, kTracers, kStrat>(pl.max_smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = step_config(pl.n_ranks, pl.n_tiles, pl.smem, stream, attr);
  cudaError_t le = cudaLaunchKernelEx(&cfg, nl_adjoint_kernel<T, kMasked, kForced, kTracers, kStrat>,
                                      pl.a, pl.tp);
  if (le == cudaSuccess) le = cudaGetLastError();
  return static_cast<int>(le);
}

// X(T, kMasked, kForced, kTracers, kStrat) for the 8 arms of one dtype and
// forcing.
#define MOT_NL_ADJ_ARMS(X, T, F)                                                             \
  X(T, false, F, false, false) X(T, false, F, false, true) X(T, false, F, true, false)       \
  X(T, false, F, true, true) X(T, true, F, false, false) X(T, true, F, false, true)          \
  X(T, true, F, true, false) X(T, true, F, true, true)
#define MOT_NL_ADJ_INSTANTIATE(T, M, F, TR, S) \
  template int nl_adj_launch<T, M, F, TR, S>(const NlAdjPlan<T>&, cudaStream_t);
#define MOT_NL_ADJ_EXTERN(T, M, F, TR, S) \
  extern template int nl_adj_launch<T, M, F, TR, S>(const NlAdjPlan<T>&, cudaStream_t);

}  // namespace lattice
