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
//     sums of Sg for ds. A thread takes one parity of a (site, level): its
//     three du channels and its dh (2 core ks items: 512 on the core's
//     (8, 8, 4) plan, every thread busy); where the items are at most half
//     the block's threads (256 on the tracer arms' (4, 8, 4) plan), two
//     threads take each, the three du channels on one and the dh on the
//     other, and where at most a quarter (128 on f64's (4, 4, 4)), four, a
//     du channel on each of three: on the planner's plans no thread idles.
//     Each output is a template instance with its channel's offsets
//     constant.
// Levels couple only through ds = (g / dc) dt sum_k Sg and d(dt): as in
// adjoint_step.cu, a thread-block cluster takes a tile, its blocks split the
// levels in chunks of kc (a multiple of the slice; nl_adjoint.cu's
// choose_kc picks the split that the card's resident clusters run in the
// fewest slice times: at 64x64x100 f32 3 blocks of 36 levels, not 7 of
// 16, the last of which idled at the cluster barrier), each block's per-site
// partial sums are added by rank 0 in rank order through distributed shared
// memory, and each block writes one d(dt) share that ddt_reduce adds in a
// fixed order: no atomics, so f64 reruns are bitwise equal. A block walks its
// chunk in slices of ks levels: each slice's window (the tile plus (4, 6)) of
// the primal h, u and the cotangent gh, gu comes in by async copies (16-byte
// ones where the shape allows; adjoint_window.cuh folds gs into gh and, on a
// channel, the wall mask into gu: fold_ssh, fold_live), then the four
// stages. Each slice waits for its own copies (the tracer arm's h' and T'
// loads are issued before the wait); a second window buffer, which would
// keep the next slice's copies in flight as nl_step.cuh's forward does, fits
// none of the main plans. The folds and stage A share one barrier. The stencils are
// resolved once per call on the host into constant-bank offsets: the Coriolis
// table through resolve_taps (T) and resolve_adjoint_taps (T^T: hex_adj::),
// the vertex tables through hex_vert:: and their transposes hex_vadj::, which
// the host derives from the tables and checks; the kernel takes the hex
// lattice's tables only. Shared memory binds: 16 window values per
// site-level a buffer, 12 on ring A, 14 on ring B and 8 on ring C, so slices
// are 1-4 levels and a block takes an SM (kernels/adjoint_step.nl_adjoint_plan).
// What bounds it is read in PERF.md: per (m, i, k) site a primal state, a
// cotangent and the vertex constants read, a cotangent written (bytes, like
// the linear reverse), against ~3x the forward's arithmetic on rings that
// re-read the window 3.5-7.5x.
//
// The composed arms (template flags kForced, kTracers, kStrat, each off in
// the plain arm's code; structured/adjoint.structured_nl_adjoint_step with
// forcing=, tracers and strat=):
//   forced: in stage D, Rayleigh's du -= dt lambda gu at every level (its
//     sum of gu u in double gives d(lambda) and d(dt)'s Rayleigh part), and
//     at each edge's top and bottom level (the packed levels of the edges
//     owned on the tile plus one ring staged once a launch) the wind and
//     drag terms added to du (adjoint_window.cuh's wind_drag_adjoint),
//     d(wind) per edge in place (one block owns each edge's top level), the
//     d(r_lin) and d(Cd) shares, and the h_edge cotangents of the cell's 6
//     edges added to its dh, half each (wind_drag_dhe). The winds are read
//     from device memory at those levels only. A block writes kShares shares
//     in double, summed in a fixed order as adjoint_step.cu's forced arm
//     does.
//   tracers: each slice's window carries the 2 nT tracer planes of the
//     primal and of the cotangent after the state's 8 (n_pl planes a state),
//     a and the h' feedback folded into G once per slice from h' and T' of
//     state j + 1 (the stack's next slot, or `end`), read from device memory
//     into registers while the window's copies land (fold_tracers' work,
//     which it does for more than 2 tracers). Stage B
//     forms each edge's tracer transpose once, at the owner's site on the
//     tile plus one ring (tracer_edge_once): the tracers' flux cotangent
//     sum_t dg te joins dF there, and the edge's kappa h_edge cotangent
//     (summed over the tracers) and per tracer dT_n, dT_o and its flux g go
//     to shared memory ([1 + 3 nT][6][ring C][ks]); stage D's dh items read
//     them back for the owned and the incoming edges (tracer_cell_sums): the
//     tracer cotangents, the kappa h_edge cotangents, sum_t a T and the
//     per-cell d(dt) terms, <G, tend_h> per cell in place of stage B's edge
//     form, as the linear tracer arm does.
//   stratified: stage D's dh items store the step's S = Sg at every cell
//     and level of the tile in a device scratch [cells][K]; after the launch
//     one launch of adjoint_window.cuh's strat_pass_kernel adds (dt / dc) W S
//     to the stored dh and forms the step's d(W) (on the FP64 tensor cores)
//     and d(dt)'s W part; nl_adjoint.cu chains the two by programmatic
//     dependent launch.

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
  T* s_out;  // the stratified arm's S scratch [cells][K] (q = 1 kernel); null otherwise
  int kc;    // levels a block of the q = 1 kernel (a multiple of ks; kc_log2 is the q > 1 one's)
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
  int d_tr[6];                //   the tracers' values of incoming edge x, ring C
  int c_inc[6];               //   its owner's ring C site, from the site's
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
    s->d_tr[x] = (tc[0] * C + tc[1] * Ci + tc[2]) * ks;
    s->c_inc[x] = tc[1] * Ci + tc[2];
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

// The tracers' transpose at the owned edge of channel ch of a site-level,
// formed once for both of its cells (tracer_edge_adjoint with the edge's
// kappa term and live bit `live`; dg = dt s_div (a_nb - a_own), the sign of
// the primal flux F held fixed): returns sum_t dF, the tracers' flux
// cotangent that joins dF, and stores at `out` (values [1 + 3 nT][6] planes
// of `stride` apart) the sum over the tracers of the kappa h_edge
// cotangent, then per tracer dT_n, dT_o and the flux g. P and C point at the
// site-level in the window's primal and cotangent slices, the tracer planes
// after the state's 8, pk values a plane apart.
template <typename T>
__device__ __forceinline__ T tracer_edge_once(const T* P, const T* C, int pk, const AdjTaps<T>& tp,
                                              const AdjTracers<T>& at, int ch, T F, bool live,
                                              T dt_div, T inv_dc, T* out, int stride) {
  const int o = tp.hs[hex::self_h(ch & 1)], nb = tp.hs[hex::nb_h(ch)];
  const T he = T(0.5) * (P[nb] + P[o]);
  T sum = T(0), dhe_sum = T(0);
  for (int t = 0; t < at.n; ++t) {
    const T* tv = P + (8 + 2 * t) * pk;
    const T* av = C + (8 + 2 * t) * pk;
    T dF, dtn, dto, dhe, g;
    tracer_edge_adjoint(F, he, tv[nb], tv[o], dt_div * (av[nb] - av[o]), live, at, inv_dc, &dF,
                        &dtn, &dto, &dhe, &g);
    sum += dF;
    dhe_sum += dhe;
    T* v = out + (1 + 3 * t) * 6 * stride;
    v[0] = dtn;
    v[6 * stride] = dto;
    v[12 * stride] = g;
  }
  out[0] = dhe_sum;
  return sum;
}

// The tracer transpose's per-cell half at one (site, level) of the tile and
// parity P, from the edges' values tracer_edge_once stored (`pe` at the
// site's ring C site-level; an incoming edge's at its owner's, tp.d_tr):
// per tracer dT = a h + the owned edges' dT_o + the incoming ones' dT_n,
// through store(2 t + P, v); in *trX the six edges' kappa h_edge cotangents,
// in *trY sum_t a T, and in *dd the d(dt) terms that the h' feedback makes
// cancel, <G, tend_h> and sum_t <a, tend_T>, per cell as tracer_adjoint forms
// them (a cell's G or a times its divergence, in the forward's order).
template <int P, typename T, typename Store>
__device__ __forceinline__ void tracer_cell_sums(const T* Pv, const T* Cv, int pk,
                                                 const NlAdjTaps<T>& tp, const AdjTracers<T>& at,
                                                 const T* pe, int CK, T s_div, T* trX, T* trY,
                                                 double* dd, Store store) {
  const AdjTaps<T>& ap = tp.adj;
  const int o = ap.hs[hex::self_h(P)];
  T total = T(0);  // the owned edges' flux - the incoming ones'
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const int ch = 2 * f + P;
    const T fl = Pv[ap.us[hex::self_u(ch)]] * (T(0.5) * (Pv[ap.hs[hex::nb_h(ch)]] + Pv[o]));
    total = (f == 0) ? fl : total + fl;
  }
#pragma unroll
  for (int x = 3 * P; x < 3 * P + 3; ++x)
    total = total - Pv[ap.us[hex::inc_u(x)]] *
                        (T(0.5) * (Pv[ap.hs[hex::inc_nb_h(x)]] + Pv[ap.hs[hex::inc_self_h(x)]]));
  *dd = static_cast<double>(Cv[o] * -(total * s_div));
  T x_sum = T(0);
#pragma unroll
  for (int f = 0; f < 3; ++f) x_sum += pe[(2 * f + P) * CK];
#pragma unroll
  for (int x = 3 * P; x < 3 * P + 3; ++x) x_sum += pe[tp.d_tr[x]];
  *trX = x_sum;
  T y = T(0);
  const T h_o = Pv[o];
  for (int t = 0; t < at.n; ++t) {
    const T a_o = Cv[(8 + 2 * t) * pk + o];
    T d = a_o * h_o;
    y += a_o * Pv[(8 + 2 * t) * pk + o];
    const T* dn = pe + (1 + 3 * t) * 6 * CK;
    const T* dov = dn + 6 * CK;
    const T* gv = dn + 12 * CK;
    T tot = T(0);
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const int ch = 2 * f + P;
      d += dov[ch * CK];
      tot = (f == 0) ? gv[ch * CK] : tot + gv[ch * CK];
    }
#pragma unroll
    for (int x = 3 * P; x < 3 * P + 3; ++x) {
      d += dn[tp.d_tr[x]];
      tot = tot - gv[tp.d_tr[x]];
    }
    *dd += static_cast<double>(a_o * -(tot * s_div));
    store(2 * t + P, d);
  }
  *trY = y;
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
  const int kc = a.kc, ks = 1 << a.ks_log2;
  const int k0 = rank * kc, kr = min(kc, a.K - k0);
  const int n_slices = (kr + ks - 1) >> a.ks_log2;
  const int plane = a.ny2 * a.nx;
  const int K = a.K;
  const int WK = W * ks, AK = A * ks, BK = B * ks, CK = C * ks;
  // the tracer arm's planes follow the state's, in the primal and the
  // cotangent; the window holds both slices; the tracer arm's values per
  // edge (tracer_edge_once)
  const int n_pl = kTracers ? 8 + 2 * a.at.n : 8;
  const int SK = 2 * n_pl * WK;
  const int n_te = kTracers ? 1 + 3 * a.at.n : 0;

  double* red = reinterpret_cast<double*>(smem_raw);  // [kRedDoubles]
  T* win = reinterpret_cast<T*>(red + kRedDoubles);   // [2][n_pl][W][ks]: h, u, T; G, gu, a
  T* pa = win + SK;                                   // [12][A][ks]: F, q_e
  T* pb = pa + kAPlanes * AK;                         // [14][B][ks]: dq_e, dF, Sg
  T* pc = pb + kBPlanes * BK;                         // [8][C][ks]: dzeta s_curl, dh_v
  T* pt = pc + kCPlanes * CK;                         // [n_te][6][C][ks]: the tracers' edges
  T* ssh_s = pt + 6 * n_te * CK;                      // [2][W]
  T* gs_s = ssh_s + 2 * W;                            // [2][W]
  T* fv_s = gs_s + 2 * W;                             // [n_fv][W]
  T* part = fv_s + a.n_fv * W;                        // [2][core]: sum over levels of Sg
  int* gsite = reinterpret_cast<int*>(part + 2 * core);  // [W]
  int* live_s = gsite + W;                               // [W]
  int* lvl_s = live_s + W;  // [6][C]: the forced arm's packed levels of the edges owned on ring C

  // the copies of slice sl of the primal state and the cotangent (and the
  // tracer planes) into the window
  auto issue = [&](int sl, T* st) {
    const int kb = sl * ks, kn = min(ks, kr - kb);
    T* cot = st + n_pl * WK;
    load_slice(st, gsite, a.h, a.u, W, a.ks_log2, a.vec_log2, k0 + kb, kn, K, plane);
    load_slice(cot, gsite, a.gh, a.gu, W, a.ks_log2, a.vec_log2, k0 + kb, kn, K, plane);
    if (kTracers) {
      load_tracers(st + 8 * WK, gsite, a.at.tr, 2 * a.at.n, W, a.ks_log2, a.vec_log2, k0 + kb,
                   kn, K, plane);
      load_tracers(cot + 8 * WK, gsite, a.at.gtr, 2 * a.at.n, W, a.ks_log2, a.vec_log2, k0 + kb,
                   kn, K, plane);
    }
  };

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
  if (kForced)
    for (int e = threadIdx.x; e < 6 * C; e += blockDim.x) {
      const int ch = e / C, x = e - ch * C, r = x / Ci, c = x - r * Ci;
      copy_async(lvl_s + e, a.fc.lvl + ch * plane +
                                gsite[(r + kWinM - kRingCm) * Wi + c + kWinI - kRingCi]);
    }
  if (n_slices > 0) issue(0, win);
  __pipeline_commit();

  const T dt_div = a.dt * a.s_div;
  const T two_ske = T(2) * a.s_ke;
  const T grav = T(kGravity);
  const FastDiv by_ai(Ai), by_bi(Bi), by_ci(Ci), by_ct(a.ct);
  const int lane_mask = ks - 1;
  double share = 0.0;
  // the forced arm: dt lambda; the sums, in double, of gu u (Rayleigh) and
  // of the d(r_lin) and d(Cd) shares
  const T dt_rayl = a.dt * a.fc.rayl;
  double s_rayl = 0.0, s_lin = 0.0, s_quad = 0.0;
  // stage D's items: the 2 parities of a (site, level), on `split` threads
  // each where they are at most a half or a quarter of the block: at 2 the
  // three du channels on the first and the dh on the second, at 4 a du
  // channel on each of the first three
  const int nd = (2 * core) << a.ks_log2;
  const int split = 4 * nd <= static_cast<int>(blockDim.x)   ? 4
                    : 2 * nd <= static_cast<int>(blockDim.x) ? 2
                                                             : 1;
  // the tracer arm's fold from values loaded before each window wait (up to
  // kFoldTracers tracers and kFoldItems items a thread; fold_tracers else)
  constexpr int kFoldItems = 6, kFoldTracers = 2;
  const bool fold_fast = kTracers && a.at.n <= kFoldTracers &&
                         (2 * W << a.ks_log2) <= kFoldItems * static_cast<int>(blockDim.x);

  for (int sl = 0; sl < n_slices; ++sl) {
    const int kb = sl * ks;           // the slice's first level in the chunk
    const int kn = min(ks, kr - kb);  // its real levels
    T* st = win;
    T* cot = st + n_pl * WK;
    // the tracer arm: h' and T' (and on a channel the cell mask) of the
    // fold's items from device memory, loaded while the window's copies land
    T fh[kFoldItems], ft[kFoldItems][kFoldTracers], fm[kFoldItems];
    if (kTracers && fold_fast)
#pragma unroll
      for (int i = 0; i < kFoldItems; ++i) {
        const int e = threadIdx.x + i * blockDim.x, q = e >> a.ks_log2, kl = e & lane_mask;
        fh[i] = T(1), fm[i] = T(1);
        if (q >= 2 * W || kl >= kn) continue;
        const int p = q >= W ? 1 : 0;
        const size_t g = static_cast<size_t>(p) * plane + gsite[q - p * W];
        const size_t o = g * K + k0 + kb + kl;
        fh[i] = a.at.h_next[o];
        if (kMasked) fm[i] = a.at.cmask[g];
#pragma unroll
        for (int t = 0; t < kFoldTracers; ++t)
          if (t < a.at.n) ft[i][t] = a.at.tr_next[o + static_cast<size_t>(2 * t) * plane * K];
      }
    if (sl > 0) {  // the last slice's stages are done (the barrier after stage D)
      issue(sl, st);
      __pipeline_commit();
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    // the folds (fold_ssh and fold_tracers take each (parity, site, level)
    // of G on the same thread; fold_live other planes) and stage A, which
    // reads the primal slice only: one barrier
    fold_ssh(cot, gs_s, W, Wi, 0, 0, a.rt + 2 * kWinM, Wi, ks, a.ks_log2, kn);
    if (kMasked) fold_live(cot + 2 * WK, live_s, W, ks, kn);
    if (kTracers && fold_fast) {  // fold_tracers from the loaded values
#pragma unroll
      for (int i = 0; i < kFoldItems; ++i) {
        const int e = threadIdx.x + i * blockDim.x, q = e >> a.ks_log2, kl = e & lane_mask;
        if (q >= 2 * W || kl >= kn) continue;
        const int p = q >= W ? 1 : 0, s = q - p * W;
        T corr = T(0);
#pragma unroll
        for (int t = 0; t < kFoldTracers; ++t) {
          if (t >= a.at.n) continue;
          T* ap = cot + (8 + 2 * t + p) * WK + s * ks + kl;
          const T av = fm[i] > T(0) ? *ap / fh[i] : T(0);
          *ap = av;
          corr += av * ft[i][t];
        }
        cot[(p * W + s) * ks + kl] -= corr;
      }
    } else if (kTracers) {
      fold_tracers(cot, gsite, a.at, W, ks, a.ks_log2, k0 + kb, kn, K, plane);
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

    // stage B: dq_e, dF and Sg on ring B; on the tile, the step's d(dt); on
    // the tile plus one ring, the tracers' edges
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
      const int rc = r - (kRingBm - kRingCm), cc = c - (kRingBi - kRingCi);
      const bool ring_c = kTracers && rc >= 0 && rc < a.rt + 2 * kRingCm && cc >= 0 &&
                          cc < a.ct + 2 * kRingCi;
      const unsigned live = kMasked && kTracers ? static_cast<unsigned>(live_s[sw]) : 0u;
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
        if (kTracers && ring_c)
          dF += tracer_edge_once(st + sw * ks + kl, cv, WK, tp.adj, a.at, ch, Fc,
                                 !kMasked || ((live >> ch) & 1u), dt_div, a.inv_dc,
                                 pt + (ch * C + rc * Ci + cc) * ks + kl, CK);
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

    // stage D on the tile: a parity of a (site, level) on `split` threads,
    // kl fastest: its three du channels and its dh (with the tracers' sums,
    // S for the stratified pass and the level sums of Sg)
    for (int e0 = 0; e0 < split * nd; e0 += blockDim.x) {
      const int ex = e0 + threadIdx.x;
      const int part_of = split == 1 ? 0 : min(ex / nd, split - 1);  // split - 1: the dh
      const int e = ex - part_of * nd;
      // the item's du channel f (0 .. 2) and its dh on this thread
      auto do_du = [&](int f) { return split == 1 || (split == 2 ? part_of == 0 : part_of == f); };
      const bool do_dh = part_of == split - 1;
      const int kl = e & lane_mask, q = e >> a.ks_log2;
      const int j = q >= core ? 1 : 0, t = q - j * core;
      T sg = T(0);
      if (e < nd && kl < kn) {
        const int r = by_ct.div(t), c = by_ct.mod(t, r);
        const int gm = tm * a.rt + r, gi = ti * a.ct + c;
        const bool inside = gm < a.ny2 && gi < a.nx;
        const size_t g = static_cast<size_t>(gm) * a.nx + gi;
        const size_t ko = static_cast<size_t>(k0 + kb + kl);
        const int sw = (r + kWinM) * Wi + c + kWinI;
        const T* lv = st + sw * ks + kl;
        const T* cv = cot + sw * ks + kl;
        const T* qb = pb + ((r + kRingBm) * Bi + c + kRingBi) * ks + kl;
        const T* qc = pc + ((r + kRingCm) * Ci + c + kRingCi) * ks + kl;
        const int sc = (r + kRingCm) * Ci + c + kRingCi;  // the site on ring C
        auto du_item = [&](auto chc) {
          constexpr int ch = decltype(chc)::value;
          const T he = T(0.5) * (lv[tp.a_h[nb_h(ch)]] + lv[tp.a_h[ch & 1]]);
          const T dke = a.dke_scale * qb[tp.d_ke[ch]] + a.dke_scale * qb[(12 + (ch & 1)) * BK];
          const T uc = lv[tp.a_u[ch]];
          T curl = T(0);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int t2 = 2 * ch + jj;
            const T v = hex_vadj::curl_t(t2, 5) > 0 ? qc[tp.d_z[t2]] : -qc[tp.d_z[t2]];
            curl = jj == 0 ? v : curl + v;
          }
          const T gue = cv[(2 + ch) * WK];
          T du = ((gue + he * qb[(6 + ch) * BK]) + two_ske * uc * dke) + curl;
          if (kForced && inside) {
            du = du - dt_rayl * gue;
            s_rayl = fma(static_cast<double>(gue), static_cast<double>(uc), s_rayl);
            // the wind and drag at the edge's top and bottom level, d(wind)
            // in place (the edge's top level is this block's alone)
            const int lvl = lvl_s[ch * C + sc];
            if (top_level(lvl, static_cast<int>(ko)) || bottom_level(lvl, static_cast<int>(ko))) {
              const size_t ew = static_cast<size_t>(ch) * plane + g;
              T du_f = T(0);
              double x_dd = 0.0, x_lin = 0.0, x_quad = 0.0;
              wind_drag_adjoint(gue, uc, he, lvl, static_cast<int>(ko), a.fc.wind + ew,
                                a.dwind + ew, a.fc, a.dt, &du_f, &x_dd, &x_lin, &x_quad);
              du = du + du_f;
              share += x_dd, s_lin += x_lin, s_quad += x_quad;
            }
          }
          if (inside) a.du[(static_cast<size_t>(ch) * plane + g) * K + ko] = du;
        };
        auto dh_item = [&](auto pcc) {
          constexpr int p = decltype(pcc)::value;
          const T s = qb[(12 + p) * BK];
          T flux = (lv[tp.a_u[p]] * qb[(6 + p) * BK] + lv[tp.a_u[2 + p]] * qb[(8 + p) * BK]) +
                   lv[tp.a_u[4 + p]] * qb[(10 + p) * BK];
#pragma unroll
          for (int x = 3 * p; x < 3 * p + 3; ++x) flux += lv[tp.a_u[inc_u(x)]] * qb[tp.d_f[x]];
          T kite = T(0);
#pragma unroll
          for (int jj = 0; jj < 6; ++jj) {
            const int t2 = 6 * p + jj;
            const T wgt = kMasked ? fv_s[(8 + hex_vadj::kite_t(t2, 5)) * W + sw + tp.d_kw[t2]]
                                  : tp.kw[hex_vadj::kite_t(t2, 5)];
            const T v = wgt * qc[tp.d_hv[t2]];
            kite = jj == 0 ? v : kite + v;
          }
          T dh;
          if (kTracers) {
            // the tracer arm's terms of dh (the kappa h_edge cotangents,
            // sum_t a T), its tracer cotangents and its per-cell d(dt) terms
            T trX, trY;
            double trdd;
            tracer_cell_sums<p>(
                lv, cv, WK, tp, a.at, pt + ((r + kRingCm) * Ci + c + kRingCi) * ks + kl, CK,
                a.s_div, &trX, &trY, &trdd, [&](int i, T v) {
                  if (inside) a.at.dtr[(static_cast<size_t>(i) * plane + g) * K + ko] = v;
                });
            if (inside) share += trdd;
            dh = ((cv[p * WK] + T(0.5) * (flux + trX)) + kite) + trY;
          } else {
            dh = (cv[p * WK] + T(0.5) * flux) + kite;
          }
          if (kForced && inside) {
            // the h_edge cotangents of the wind and drag at the top and
            // bottom levels of the cell's 6 edges (owned, then incoming at
            // their owners), half each
            int lvs[6];
            bool any = false;
#pragma unroll
            for (int i = 0; i < 6; ++i) {
              const int x = 3 * p + i - 3;
              lvs[i] = i < 3 ? lvl_s[(2 * i + p) * C + sc]
                             : lvl_s[tp.adj.inc_ch[x] * C + sc + tp.c_inc[x]];
              any = any || top_level(lvs[i], static_cast<int>(ko)) ||
                    bottom_level(lvs[i], static_cast<int>(ko));
            }
            if (any) {
              const AdjTaps<T>& ap = tp.adj;
              const T hc = lv[ap.hs[hex::self_h(p)]];
              T dhe = T(0);
#pragma unroll
              for (int f = 0; f < 3; ++f) {
                const int ch = 2 * f + p, us = ap.us[hex::self_u(ch)];
                dhe += wind_drag_dhe(cv[us], lv[us], T(0.5) * (lv[ap.hs[hex::nb_h(ch)]] + hc),
                                     lvs[f], static_cast<int>(ko),
                                     a.fc.wind + static_cast<size_t>(ch) * plane + g, a.fc,
                                     a.dt);
              }
#pragma unroll
              for (int x = 3 * p; x < 3 * p + 3; ++x) {
                const int us = ap.us[hex::inc_u(x)];
                const size_t ew = static_cast<size_t>(ap.inc_ch[x]) * plane +
                                  gsite[sw + ap.inc_off[x]];
                dhe += wind_drag_dhe(
                    cv[us], lv[us],
                    T(0.5) * (lv[ap.hs[hex::inc_nb_h(x)]] + lv[ap.hs[hex::inc_self_h(x)]]),
                    lvs[x - 3 * p + 3], static_cast<int>(ko), a.fc.wind + ew, a.fc, a.dt);
              }
              dh = dh + T(0.5) * dhe;
            }
          }
          if (inside) {
            const size_t o = (static_cast<size_t>(p) * plane + g) * K + ko;
            if (kStrat) a.s_out[o] = s;  // the stratified pass's S
            a.dh[o] = dh;
          }
          return s;
        };
        if (j == 0) {  // the parity's three channels and its cell
          if (do_du(0)) du_item(std::integral_constant<int, 0>{});
          if (do_du(1)) du_item(std::integral_constant<int, 2>{});
          if (do_du(2)) du_item(std::integral_constant<int, 4>{});
          if (do_dh) sg = dh_item(std::integral_constant<int, 0>{});
        } else {
          if (do_du(0)) du_item(std::integral_constant<int, 1>{});
          if (do_du(1)) du_item(std::integral_constant<int, 3>{});
          if (do_du(2)) du_item(std::integral_constant<int, 5>{});
          if (do_dh) sg = dh_item(std::integral_constant<int, 1>{});
        }
      }
      const T s = group_sum(sg, ks);
      if (e < nd && kl == 0 && do_dh) {
        T& o = part[j * core + t];
        o = sl == 0 ? s : o + s;
      }
    }
    __syncthreads();
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
// mirrors this): the warps' d(dt) sums; the window, the slice of the
// primal state and of the cotangent, with the tracer arm's 2 n_tr planes
// each; the rings' planes; the tracer arm's values per edge on ring C
// (1 + 3 n_tr a channel); the window's ssh, gs and n_fv vertex constant
// planes (4 periodic, 20 masked); the partial sums; the window's sites with
// their live bits; the packed levels of the 6 edges of each ring C site (the
// forced arm's, reserved by every arm). The stratified arm takes none.
inline size_t nl_adjoint_smem_bytes(int rt, int ct, int ks, size_t itemsize, int n_tr, int n_fv) {
  const long long W = static_cast<long long>(rt + 2 * kWinM) * (ct + 2 * kWinI);
  const long long A = static_cast<long long>(rt + 2 * kRingAm) * (ct + 2 * kRingAi);
  const long long B = static_cast<long long>(rt + 2 * kRingBm) * (ct + 2 * kRingBi);
  const long long C = static_cast<long long>(rt + 2 * kRingCm) * (ct + 2 * kRingCi);
  const long long vals =
      (2LL * (8 + 2LL * n_tr) * W + kAPlanes * A + kBPlanes * B + kCPlanes * C +
       (n_tr > 0 ? 6LL * (1 + 3LL * n_tr) * C : 0)) * ks +
      (4LL + n_fv) * W + 2LL * rt * ct;
  return sizeof(double) * kRedDoubles + itemsize * static_cast<size_t>(vals) +
         sizeof(int) * static_cast<size_t>(2 * W + 6 * C);
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

// The clusters of n_ranks blocks of `smem` bytes an arm's launch keeps
// resident at once (CUDA's occupancy calculator for clusters) in *out;
// returns 0 or the CUDA error. Instantiated with nl_adj_launch.
template <typename T, bool kMasked, bool kForced, bool kTracers, bool kStrat>
int nl_adj_clusters(size_t smem, int n_ranks, int max_smem, int* out) {
  int err = nl_adj_prepare<T, kMasked, kForced, kTracers, kStrat>(max_smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = step_config(n_ranks, 1, smem, nullptr, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      out, nl_adjoint_kernel<T, kMasked, kForced, kTracers, kStrat>, &cfg));
}

// X(T, kMasked, kForced, kTracers, kStrat) for the 8 arms of one dtype and
// forcing.
#define MOT_NL_ADJ_ARMS(X, T, F)                                                             \
  X(T, false, F, false, false) X(T, false, F, false, true) X(T, false, F, true, false)       \
  X(T, false, F, true, true) X(T, true, F, false, false) X(T, true, F, false, true)          \
  X(T, true, F, true, false) X(T, true, F, true, true)
#define MOT_NL_ADJ_INSTANTIATE(T, M, F, TR, S)                                   \
  template int nl_adj_launch<T, M, F, TR, S>(const NlAdjPlan<T>&, cudaStream_t); \
  template int nl_adj_clusters<T, M, F, TR, S>(size_t, int, int, int*);
#define MOT_NL_ADJ_EXTERN(T, M, F, TR, S)                                               \
  extern template int nl_adj_launch<T, M, F, TR, S>(const NlAdjPlan<T>&, cudaStream_t); \
  extern template int nl_adj_clusters<T, M, F, TR, S>(size_t, int, int, int*);

}  // namespace lattice
