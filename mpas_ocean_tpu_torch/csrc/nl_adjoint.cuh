// Reverse (adjoint) of one nonlinear (vector-invariant) forward-Euler step of
// the TRiSK shallow-water core on the parity-plane hex lattice, for NVIDIA
// Hopper (sm_90a): one kernel, periodic and wall-masked, f32 and f64, which
// nl_adjoint.cu instantiates once per arm.
//
// Replaces: the nonlinear arm of _adjoint_segment_kernel
// (mpas_ocean_tpu/structured/pallas_model.py:1480; its in-kernel jax.vjp of
// _step_planes with nl_terms, :1538, 1545-1590) and, at q = 1 (the only q the
// JAX router takes, _ADJ_Q_ORDER :2673), of _tiled_adjoint_kernel (:1979; the
// VJP of _window_steps at reach 2, :2050-2104), forcing, tracers and
// stratification off. CUDA has no vjp, so the transpose is written out by
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
  double* ddt_part;  // one share per block: (tile, rank)
  T dt, inv_dc, s_div, s_ke, s_curl;
  // g dt / dc and dt / dc, each rounded once from double on the host (a
  // product of rounded factors, applied at every site, would bias ds and
  // dKE by its rounding in f32)
  T ds_scale, dke_scale;
  int ny2, nx, K, rt, ct, n_fv, kc_log2, ks_log2, vec_log2, n_tiles_i;
};

// The stencils as offsets, resolved once per call on the host (kernel
// parameters, in the constant bank). Window offsets in [16][W][ks] (the
// cotangent's from its base, plane 8), ring offsets in the rings' planes.
template <typename T>
struct NlAdjTaps {
  T w[hex::kTaps];       // Coriolis weights (T)
  T wt[hex_adj::kTaps];  // transposed Coriolis weights (T^T)
  T kw[hex_vert::kVC];   // kite weights (periodic arm)
  int a_u[hex_vert::kU];  // stage A, C, D: u sources in the window
  int a_h[hex_vert::kH];  //   h sources
  int a_v[hex_vert::kV];  //   endpoint vertices, window sites
  int b_f[hex::kU];       // stage B: F at T's u sources, ring A
  int b_q[hex_adj::kGu];  //   q_e at T^T's gu sources, ring A
  int b_gu[hex_adj::kGu];  //  gu sources, the window's cotangent
  int b_g[hex_adj::kG];    //  G sources, the window's cotangent
  int c_q[hex_vadj::kTaps];   // stage C: dq_e at the endpoint mean's transposed taps, ring B
  int d_z[hex_vadj::kTaps];   // stage D: dzeta s_curl at the curl's transposed taps, ring C
  int d_hv[hex_vadj::kTaps];  //   dh_v at the kite's transposed taps, ring C
  int d_kw[hex_vadj::kTaps];  //   their vertices, window sites (the channel's kite planes)
  int d_ke[6];                //   Sg across channel c's owned edge, ring B
  int d_f[6];                 //   dF at incoming edge x = 3p + j, ring B
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
  for (int t = 0; t < hex::kTaps; ++t) s->w[t] = fwd.w[t], s->wt[t] = win.w[t];
  for (int i = 0; i < hex::kU; ++i) s->b_f[i] = fwd.us[i] - 2 * A * ks;        // F: planes 0-5
  for (int i = 0; i < hex_adj::kGu; ++i) s->b_q[i] = ring.us[i] + 4 * A * ks;  // q_e: 6-11
  for (int i = 0; i < hex_adj::kGu; ++i) s->b_gu[i] = win.us[i];
  for (int i = 0; i < hex_adj::kG; ++i) s->b_g[i] = win.hs[i];
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

// One reverse step; a cluster of n_ranks blocks per tile, blocks of
// kStepThreads threads, groups of ks lanes on one site's slice levels.
template <typename T, bool kMasked>
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

  double* red = reinterpret_cast<double*>(smem_raw);  // [kRedDoubles]
  T* st = reinterpret_cast<T*>(red + kRedDoubles);    // [16][W][ks]: h, u, G, gu
  T* cot = st + 8 * WK;                               // the cotangent's 8 planes
  T* pa = st + kWinPlanes * WK;                       // [12][A][ks]: F, q_e
  T* pb = pa + kAPlanes * AK;                         // [14][B][ks]: dq_e, dF, Sg
  T* pc = pb + kBPlanes * BK;                         // [8][C][ks]: dzeta s_curl, dh_v
  T* ssh_s = pc + kCPlanes * CK;                      // [2][W]
  T* gs_s = ssh_s + 2 * W;                            // [2][W]
  T* fv_s = gs_s + 2 * W;                             // [kFv][W]
  T* part = fv_s + kFv * W;                           // [2][core]: sum over levels of Sg
  int* gsite = reinterpret_cast<int*>(part + 2 * core);  // [W]
  int* live_s = gsite + W;                               // [W]

  allow_next_grid();
  window_sites(gsite, tm * a.rt - kWinM, ti * a.ct - kWinI, Wi, W, a.ny2, a.nx);
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
  __pipeline_commit();

  const T dt_div = a.dt * a.s_div;
  const T two_ske = T(2) * a.s_ke;
  const T grav = T(kGravity);
  const FastDiv by_ai(Ai), by_bi(Bi), by_ci(Ci), by_ct(a.ct);
  const int lane_mask = ks - 1;
  double share = 0.0;

  for (int sl = 0; sl < n_slices; ++sl) {
    const int kb = sl * ks;           // the slice's first level in the chunk
    const int kn = min(ks, kr - kb);  // its real levels
    load_slice(st, gsite, a.h, a.u, W, a.ks_log2, a.vec_log2, k0 + kb, kn, K, plane);
    load_slice(cot, gsite, a.gh, a.gu, W, a.ks_log2, a.vec_log2, k0 + kb, kn, K, plane);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    fold_ssh(cot, gs_s, W, Wi, 0, 0, a.rt + 2 * kWinM, Wi, ks, a.ks_log2, kn);
    if (kMasked) fold_live(cot + 2 * WK, live_s, W, ks, kn);
    __syncthreads();

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
      for (int x = 0; x < hex_adj::kGu; ++x) gu[x] = cv[tp.b_gu[x]];
#pragma unroll
      for (int x = 0; x < hex_adj::kG; ++x) G[x] = cv[tp.b_g[x]];
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
          const T c2 = tp.wt[t2] * gu[src];
          const T c3 = tp.wt[t2] * (gu[src] * fa[tp.b_q[src]]);
          tf = x == 0 ? c1 : tf + c1;
          tg = x == 0 ? c2 : tg + c2;
          tgq = x == 0 ? c3 : tgq + c3;
        }
        const T ta = a.dt * tg;
        const T Fc = fa[ch * AK], qc = fa[(6 + ch) * AK];
        const T ac = a.dt * gu[ch];
        const T dG = G[hex::nb_h(ch)] - G[ch & 1];
        out[ch * BK] = T(0.5) * (ac * tf + Fc * ta);
        out[(6 + ch) * BK] = dG * dt_div + T(0.5) * (a.dt * tgq + qc * ta);
        if (on_tile)
          part_dt += (a.s_div * Fc * dG + T(0.5) * gu[ch] * qc * tf) + T(0.5) * (Fc * qc) * tg;
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
        sg[0] = qb[12 * BK];
        sg[1] = qb[13 * BK];
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
          dh[p] = (cv[p * WK] + T(0.5) * flux) + kite;
        }
        if (gm < a.ny2 && gi < a.nx) {
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
  }
  share_warps(share, red);

  // ds = (g / dc) dt * the ranks' partial sums, added by rank 0 in rank
  // order; each block's d(dt) share
  cluster.sync();
  if (threadIdx.x == 0) a.ddt_part[blockIdx.x] = share_total(red);
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
// state and the cotangent, the rings' planes; the window's ssh, gs and vertex
// constants (20 planes, the masked arm's, reserved by the periodic one too);
// the partial sums; the window's sites with their live bits.
inline size_t nl_adjoint_smem_bytes(int rt, int ct, int ks, size_t itemsize) {
  const long long W = static_cast<long long>(rt + 2 * kWinM) * (ct + 2 * kWinI);
  const long long A = static_cast<long long>(rt + 2 * kRingAm) * (ct + 2 * kRingAi);
  const long long B = static_cast<long long>(rt + 2 * kRingBm) * (ct + 2 * kRingBi);
  const long long C = static_cast<long long>(rt + 2 * kRingCm) * (ct + 2 * kRingCi);
  const long long vals = (kWinPlanes * W + kAPlanes * A + kBPlanes * B + kCPlanes * C) * ks +
                         (4 + hex_vert::kFv) * W + 2LL * rt * ct;
  return sizeof(double) * kRedDoubles + itemsize * static_cast<size_t>(vals) +
         2 * sizeof(int) * static_cast<size_t>(W);
}

}  // namespace lattice
