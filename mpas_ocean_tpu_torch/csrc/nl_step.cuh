// One step of the nonlinear (vector-invariant) TRiSK shallow-water core on the
// parity-plane hex lattice, forward Euler (FE) or forward-backward (FB), for
// NVIDIA Hopper (sm_90a): the nonlinear arms of fe_step (FE) and tiled_step
// (FB, q = 1), instantiated per arm and dtype by nl_step_{fe,fb}_{f32,f64}.cu.
//
// Replaces: the nonlinear branch of _step_planes (nl, pallas_model.py:172-242)
// in _rollout_kernel (:320, FE) and _step_slab_nl (sharded.py:597) in
// _tiled_step_kernel (:852, FE reach 2 and FB reach 3), periodic (4 f_vertex
// planes) and wall-masked (20 planes: f_vertex, vertex mask, 12 live kite
// weights; _nl_setup, :586-607), with momentum forcing (:244-256), tracers
// (:258-298) and layered stratification (Phi = g ssh + h @ W, :150-165) in
// any combination, in _step_planes' order: the base update plus dt F of the
// old u and h_edge, then the wall mask; the tracers by the old thickness
// flux over h'; Phi of the old state (FE) or of the fresh h' and ssh' (FB).
// The halo rows are read from the state, periodically (the single-chip
// rollout), or received (ro > 0: the sharded superstep at q = 1, sharded.py:
// 1640-1886, whose slabs hold ro = reach halo rows per side; step_window.cuh,
// buffer_plane).
//
// Per site and level, from the old state: the thickness flux
// F = u (h + h_nbr) / 2, KE = s_ke (sum of the cell's 6 u^2), the curl at the
// 2 x 2 vertex planes, h_v from the 12 kite taps, q_v = (f_v + curl) / h_v
// (on a channel the division guarded where the vertex mask is 0, and the
// result times it), q_e the half-sum of the 12 endpoint taps, F q_e; then
// h' = h - dt s_div div F, ssh' = sum_k h' - rts and
// u' = u + dt ((q_e T(F) + T(F q_e)) / 2 - grad KE) - g dt grad ssh, with T the
// 60-tap tangential pass (hex::), the pressure from the old ssh (FE) or from
// the fresh one (FB: h' and ssh' first, on the tile plus one ring), and u' = 0
// on masked channels.
//
// Design. The chained stencil reaches 2 rows (FE) or 3 (FB), 4 columns, but
// each factor reaches 1 row and 2 columns (structured/slab.py, stencil_reach
// and derived_ring): so, as the JAX slab form does, a stage A computes the
// derived planes F, F q_e, q_e and KE on the tile plus a ring (1 row and 2
// columns for FE, 2 and 2 for FB) into shared memory, and a stage B applies
// them on the tile (FB: the fresh continuity on the tile plus one ring, then
// the momentum). Levels couple only through the column sum of h: as in the
// linear kernels, a thread-block cluster takes a tile, its blocks split the
// levels in power-of-two chunks (step_window.cuh), and the ranks' partial
// column sums are added in rank order through distributed shared memory (no
// atomics: f64 reruns are bitwise equal). Shared memory binds: 20 derived
// values per site-level on top of the 8 state values. So a block walks its
// level chunk in slices of ks levels: each slice's window of h and u comes in
// by async copies (16-byte ones where the shape allows) into one of two
// buffers while the block works on the other, then stage A, then stage B.
// The partial column sums gather over the slices in a fixed order. FB keeps
// u + dt (PV flux - grad KE) of its chunk on the tile in shared memory until
// the cluster's fresh ssh is known. Each distinct state value of a
// site-level is loaded once (hex_vert:: sources, resolved on the host into
// kernel parameters, as hex:: does for the Coriolis taps), and the kernels
// take the hex lattice's vertex tables only. Per (m, i, k) site the step does
// 376 FLOPs (382 masked; pallas_model.step_flop_count with the hex table's 48
// taps) against 162 for the linear one, over the same 8 state values in and
// out: the 64x64x100 and 256x256x100 f32 lattices stay bound by bytes on an
// H100's roofline.

#pragma once

#include <algorithm>

#include "step_window.cuh"

namespace lattice {

// The hex lattice's vertex stencils (structured/hex_layout.py): kite taps
// (kind, p_out, p_in, dm, di) of the cell->vertex average, endpoint taps
// (f_out, p_out, kind, p_in, dm, di) of the vertex->edge mean, and the
// distinct state values a site's stage A reads, numbered in order of first
// use (the site's own u, the incoming u, the curls of the 8 endpoint
// vertices; the site's h, its neighbours', the kites').
namespace hex_vert {
constexpr int kVC = 12;  // kite taps, 3 per vertex plane
constexpr int kEV = 12;  // endpoint taps, 2 per edge channel
constexpr int kU = 17;   // u sources: (channel, dm, di)
constexpr int kH = 9;    // h sources: (plane, dm, di)
constexpr int kV = 8;    // endpoint vertices: (kind * 2 + plane, dm, di)
constexpr int kPlanes = 20;  // derived planes: F [6], F q_e [6], q_e [6], KE [2]
constexpr int kFv = 20;  // vertex constant planes reserved: f_v [4], mask [4], kite [12]

__host__ __device__ constexpr int vc_tap(int t, int j) {
  constexpr int m[kVC][5] = {{0, 0, 0, 0, 0}, {0, 0, 1, 0, 0}, {0, 0, 1, 0, -1}, {0, 1, 1, 0, 0},
                             {0, 1, 0, 1, 1}, {0, 1, 0, 1, 0}, {1, 0, 0, 0, 0}, {1, 0, 0, 0, 1},
                             {1, 0, 1, 0, 0}, {1, 1, 1, 0, 0}, {1, 1, 1, 0, 1}, {1, 1, 0, 1, 1}};
  return m[t][j];
}
__host__ __device__ constexpr int ev_tap(int t, int j) {
  constexpr int m[kEV][6] = {{0, 0, 0, 1, -1, 0}, {0, 0, 1, 0, 0, 0}, {0, 1, 0, 0, 0, 1},
                             {0, 1, 1, 1, 0, 0},  {1, 0, 1, 0, 0, 0}, {1, 0, 0, 0, 0, 0},
                             {1, 1, 1, 1, 0, 0},  {1, 1, 0, 1, 0, 0}, {2, 0, 0, 0, 0, 0},
                             {2, 0, 1, 0, 0, -1}, {2, 1, 0, 1, 0, 0}, {2, 1, 1, 1, 0, -1}};
  return m[t][j];
}
__host__ __device__ constexpr int u_src(int i, int j) {
  constexpr int m[kU][3] = {{0, 0, 0},  {1, 0, 0},  {2, 0, 0},   {3, 0, 0},  {4, 0, 0},  {5, 0, 0},
                            {0, 0, -1}, {3, -1, -1}, {5, -1, 0}, {1, 0, -1}, {4, 0, 1},  {3, -1, 0},
                            {2, 0, 1},  {5, 0, 1},  {0, 1, 0},   {2, 0, -1}, {3, 0, -1}};
  return m[i][j];
}
__host__ __device__ constexpr int h_src(int i, int j) {
  constexpr int m[kH][3] = {{0, 0, 0}, {1, 0, 0}, {0, 0, 1}, {1, 0, 1},  {0, 1, 1},
                            {1, 0, -1}, {0, 1, 0}, {1, -1, 0}, {0, 0, -1}};
  return m[i][j];
}
__host__ __device__ constexpr int v_src(int i, int j) {
  constexpr int m[kV][3] = {{1, -1, 0}, {2, 0, 0}, {0, 0, 1}, {3, 0, 0},
                            {0, 0, 0},  {1, 0, 0}, {2, 0, -1}, {3, 0, -1}};
  return m[i][j];
}
// h source of the cell across channel c's owned edge (the site's own u of
// channel c is u source c, its own h of plane p is h source p)
__host__ __device__ constexpr int nb_h(int c) {
  constexpr int m[6] = {2, 3, 1, 4, 5, 6};
  return m[c];
}
// u source of incoming edge x = 3p + j (KE)
__host__ __device__ constexpr int inc_u(int x) {
  constexpr int m[6] = {6, 7, 8, 9, 2, 10};
  return m[x];
}
// the curl's three u sources of vertex v: A: u_NE - u_E(NW) - u_NW;
// B: u_E + u_NW(E) - u_NE
__host__ __device__ constexpr int curl_u(int v, int j) {
  constexpr int m[kV][3] = {{11, 0, 8}, {0, 10, 2}, {12, 1, 10}, {1, 13, 3},
                            {2, 9, 4},  {3, 14, 5}, {6, 4, 15},  {9, 5, 16}};
  return m[v][j];
}
// vertex v's kite taps: the tap's number and its h source
__host__ __device__ constexpr int kite_t(int v, int j) {
  constexpr int m[kV][3] = {{3, 4, 5}, {6, 7, 8}, {0, 1, 2}, {9, 10, 11},
                            {0, 1, 2}, {3, 4, 5}, {6, 7, 8}, {9, 10, 11}};
  return m[v][j];
}
__host__ __device__ constexpr int kite_h(int v, int j) {
  constexpr int m[kV][3] = {{7, 2, 0}, {0, 2, 1}, {2, 3, 1}, {1, 3, 4},
                            {0, 1, 5}, {1, 4, 6}, {8, 0, 5}, {5, 1, 6}};
  return m[v][j];
}
// the endpoint vertex of endpoint tap t (2 per channel, in tap order)
__host__ __device__ constexpr int ev_v(int t) {
  constexpr int m[kEV] = {0, 1, 2, 3, 1, 4, 3, 5, 4, 6, 5, 7};
  return m[t];
}
}  // namespace hex_vert

template <typename T>
struct NlArgs {
  const T* ssh;
  const T* h;
  const T* u;
  const T* rts;
  const T* fv;      // vertex constants [n_fv][ny2][nx]
  const int* live;  // the masked arm's live bits, (ny2, nx); null otherwise
  T* ssh_out;
  T* h_out;
  T* u_out;
  ForcingArgs<T> fc;  // the forced arm's operands; wind null otherwise
  TracerArgs<T> tr;   // the tracer arm's operands; tr null otherwise
  const T* strat_w;   // the stratified arm's W (K, K); null otherwise
  NbrReach nr;        // the gradient's reach, which grows the tile to Phi's region
  T dt, inv_dc, s_div, s_ke, s_curl;
  int ny2, nx, K, rt, ct, hm, hi, dr, dc, n_fv, kc_log2, ks_log2, vec_log2, n_tiles_i;
  int ro;  // received halo rows per side (step_window.cuh, buffer_plane); 0 periodic
};

// The stencils as offsets, resolved once per call on the host (kernel
// parameters, in the constant bank): stage A's sources in the state slice
// [8][W][ks], the endpoint vertices' window sites, and stage B's reads of
// the derived planes [20][D][ks] (D: the tile plus the ring); for the
// tracer and forced arms, the linear step's own and incoming u and its h
// sources in the state slice (hex::, as resolve_taps numbers them).
template <typename T>
struct NlTaps {
  T w[hex::kTaps];        // Coriolis weights, 8 per output channel
  T kw[hex_vert::kVC];    // kite weights (periodic arm)
  int a_u[hex_vert::kU];  // u sources, state units
  int a_h[hex_vert::kH];  // h sources, state units
  int a_v[hex_vert::kV];  // endpoint vertices, window sites
  int b_f[hex::kU];       // F at the hex:: u sources, derived units
  int b_ke[6];            // KE across channel c's owned edge, derived units
  int nb_p[6];            // the pressure's neighbour across channel c, its planes' sites
  int us[hex::kEdgeU];    // hex:: u sources 0 .. 10, state units
  int hs[hex::kH];        // hex:: h sources, state units
};

// The hex tables resolved for a window of Wm x Wi = W sites, a derived ring
// (dr, dc) and slices of ks levels; false for a Coriolis or vertex table that
// is not the hex lattice's. ``pw``, ``pi`` are the pressure planes' sites per
// plane and per row (FE: the window's; FB and the stratified arms: the tile
// plus one ring).
template <typename T>
inline bool resolve_nl_taps(NlTaps<T>* s, const int* table, const double* weights,
                            const int* vc, const double* vc_w, const int* ev, int Wi, int W,
                            int Di, int D, int ks, int pw, int pi) {
  for (int t = 0; t < hex_vert::kVC; ++t) {
    for (int j = 0; j < 5; ++j)
      if (vc[5 * t + j] != hex_vert::vc_tap(t, j)) return false;
    s->kw[t] = static_cast<T>(vc_w[t]);
  }
  for (int t = 0; t < hex_vert::kEV; ++t)
    for (int j = 0; j < 6; ++j)
      if (ev[6 * t + j] != hex_vert::ev_tap(t, j)) return false;
  StepTaps<T> tp;  // the Coriolis table on the derived planes' geometry
  if (!resolve_taps<T>(&tp, table, weights, Di, D, ks)) return false;
  for (int t = 0; t < hex::kTaps; ++t) s->w[t] = tp.w[t];
  for (int i = 0; i < hex::kU; ++i) s->b_f[i] = tp.us[i] - 2 * D * ks;
  for (int c = 0; c < 6; ++c) {
    s->b_ke[c] = (18 * D + tp.nb[c]) * ks;
    const int* tn = table + kNbr + 3 * c;
    s->nb_p[c] = tn[0] * pw + tn[1] * pi + tn[2];
  }
  for (int i = 0; i < hex_vert::kU; ++i)
    s->a_u[i] = ((2 + hex_vert::u_src(i, 0)) * W + hex_vert::u_src(i, 1) * Wi +
                 hex_vert::u_src(i, 2)) * ks;
  for (int i = 0; i < hex_vert::kH; ++i)
    s->a_h[i] = (hex_vert::h_src(i, 0) * W + hex_vert::h_src(i, 1) * Wi +
                 hex_vert::h_src(i, 2)) * ks;
  for (int i = 0; i < hex_vert::kV; ++i)
    s->a_v[i] = hex_vert::v_src(i, 1) * Wi + hex_vert::v_src(i, 2);
  StepTaps<T> ws;  // the same table on the state slice's geometry
  if (!resolve_taps<T>(&ws, table, weights, Wi, W, ks)) return false;
  for (int i = 0; i < hex::kEdgeU; ++i) s->us[i] = ws.us[i];
  for (int i = 0; i < hex::kH; ++i) s->hs[i] = ws.hs[i];
  return true;
}

// The level slice [kb, kb + n) of h and u over the window into buf
// [8][W][ks], by async copies: 16-byte vectors where vec_log2 >= 0 (as
// load_state's), else one value per copy. Needs gs[] written and a
// __syncthreads() before.
template <typename T>
__device__ __forceinline__ void load_slice(T* buf, const int* gs, const T* h, const T* u, int W,
                                           int ks_log2, int vec_log2, int kb, int n, int K,
                                           int plane) {
  const int ks = 1 << ks_log2;
  if (vec_log2 >= 0) {
    constexpr int per = 16 / sizeof(T);
    const int vr = n / per;
    const int cnt = (W * 8) << vec_log2;
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
      const int v = e & ((1 << vec_log2) - 1);
      const int q = e >> vec_log2;
      const int ch = q & 7, s = q >> 3;
      if (v >= vr) continue;
      const int g = gs[s];
      const T* src = ch < 2 ? h + (ch * plane + g) * K : u + ((ch - 2) * plane + g) * K;
      copy_async16(buf + (ch * W + s) * ks + v * per, src + kb + v * per);
    }
  } else {
    const int cnt = (W * 8) << ks_log2;
    for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
      const int kl = e & (ks - 1);
      const int q = e >> ks_log2;
      const int ch = q & 7, s = q >> 3;
      if (kl >= n) continue;
      const int g = gs[s];
      const T* src = ch < 2 ? h + (ch * plane + g) * K : u + ((ch - 2) * plane + g) * K;
      copy_async(buf + (ch * W + s) * ks + kl, src + kb + kl);
    }
  }
}

// The forced arm's staged planes of a nonlinear block, on the tile only
// (its wind and drag act at the tile's edges): the packed levels [6][core]
// if its rank is in lvl_ranks, the winds [6][core] if in wind_ranks, by
// async copies with the first slice (needs gs[]).
template <typename T>
__device__ __forceinline__ void load_tile_forcing(const ForcingSmem<T>& fs, const int* gs,
                                                  const ForcingArgs<T>& fc, int rt, int ct,
                                                  int hm, int hi, int Wi, int plane, int rank) {
  const bool lvl = (fc.lvl_ranks >> rank) & 1u, wind = (fc.wind_ranks >> rank) & 1u;
  if (!lvl) return;
  const int core = rt * ct;
  for (int t = threadIdx.x; t < core; t += blockDim.x) {
    const int r = t / ct;
    const int g = gs[(hm + r) * Wi + hi + t - r * ct];
    for (int c6 = 0; c6 < 6; ++c6) {
      copy_async(fs.lvl + c6 * core + t, fc.lvl + c6 * plane + g);
      if (wind) copy_async(fs.wind + c6 * core + t, fc.wind + c6 * plane + g);
    }
  }
}

// One nonlinear step; a cluster of n_ranks blocks per tile, blocks of
// kStepThreads threads, groups of ks lanes on one site's slice levels. The
// forced, tracer and stratified arms (kForced, kTracers, kStrat, in any
// combination; the plain arm keeps its code):
// - forced: Rayleigh in stage B's momentum; the wind and drag, which act at
//   an edge's top and bottom level only, in a pass after each slice over the
//   tile's edges whose levels the slice holds (the slice's old state is in
//   shared memory then), by the ranks whose chunk holds such levels, from
//   the tile's winds and packed levels staged once;
// - tracers: the slice's 2 nT tracer planes ride with its 8 state planes,
//   and continuity's lane group carries them at the tile's sites with the
//   old state's edge fluxes (the F of stage A, formed again from the same
//   values) over h' (step_window.cuh, tracer_step);
// - stratified: Phi at a level needs every level's h at the site and its
//   ring, and a rank holds one slice of its chunk at a time. So each rank
//   keeps its chunk of h on the tile plus one ring (the old h in FE, the
//   fresh h' in FB, as continuity forms it), FE defers its pressure as FB
//   does, and after the cluster barrier of the column sums every rank forms
//   Phi = g ssh + h @ W at its levels through distributed shared memory in
//   rank order (step_window.cuh, montgomery) and applies its gradient with
//   scale -dt.
template <typename T, bool FB, bool kMasked, bool kForced, bool kTracers, bool kStrat>
__global__ void __launch_bounds__(kStepThreads, 1)
    nl_step_kernel(const NlArgs<T> a, const NlTaps<T> tp) {
  using namespace hex_vert;
  // the pressure waits for the cluster's column sums: FB's for the fresh
  // ssh, the stratified arm's for every rank's h
  constexpr bool kDefer = FB || kStrat;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int tile = blockIdx.x / n_ranks;
  const int tm = tile / a.n_tiles_i, ti = tile % a.n_tiles_i;
  const int Wi = a.ct + 2 * a.hi, W = (a.rt + 2 * a.hm) * Wi;
  const int Di = a.ct + 2 * a.dc, D = (a.rt + 2 * a.dr) * Di;
  const int Fi = a.ct + 2, Fs = (a.rt + 2) * Fi;  // the tile plus one ring
  const int core = a.rt * a.ct;
  const int P = FB ? Fs : core;  // the sites of the partial column sums
  const int kc = 1 << a.kc_log2, ks = 1 << a.ks_log2;
  const int k0 = rank * kc, kr = min(kc, a.K - k0);
  const int n_slices = (kr + ks - 1) >> a.ks_log2;
  const int plane = buffer_plane(a.ny2, a.nx, a.ro);
  const int K = a.K;
  const int WK = W * ks, DK = D * ks;
  // one state slice: the state's 8 planes, and the tracer arm's after them
  const int SK = (kTracers ? 8 + 2 * a.tr.n : 8) * WK;

  T* st = reinterpret_cast<T*>(smem_raw);  // [2][8 (+ 2 nT)][W][ks]: h p0, h p1, u c0..c5, tracers
  T* dsm = st + 2 * SK;                    // [20][D][ks]: F, F q_e, q_e, KE
  T* ssh_s = dsm + hex_vert::kPlanes * DK;           // [2][W]: the old ssh (FE)
  T* rts_s = ssh_s + 2 * W;                // [2][W]
  T* fv_s = rts_s + 2 * W;                 // [kFv][W]
  T* part = fv_s + kFv * W;                // [2][P]
  T* sshf = part + 2 * P;                  // deferred: [2][Fs], the pressure's ssh
  T* upart = sshf + (kDefer ? 2 * Fs : 0);  // deferred: [6][core][kc]
  int* gs = reinterpret_cast<int*>(upart + (kDefer ? 6 * core * kc : 0));  // [W]
  int* live_s = gs + W;                                                     // [W]
  // the stratified arm's Phi, staging and W slice, and (`fresh`) its chunk of
  // h on the tile plus one ring
  const StratSmem<T> ssm(live_s + W, Fs, kc, K);
  // the forced arm's winds and levels on the tile, after the stratified arm's
  const ForcingSmem<T> fsm(kStrat ? ssm.end(Fs, kc, true) : static_cast<void*>(live_s + W),
                           core, 0);

  allow_next_grid();
  window_sites(gs, tm * a.rt - a.hm, ti * a.ct - a.hi, Wi, W, a.ny2, a.nx, a.ro);
  __syncthreads();
  wait_previous_grid();
  for (int s = threadIdx.x; s < W; s += blockDim.x) {
    const int g = gs[s];
    for (int p = 0; p < 2; ++p) {
      copy_async(rts_s + p * W + s, a.rts + p * plane + g);
      if (!FB) copy_async(ssh_s + p * W + s, a.ssh + p * plane + g);
    }
    for (int x = 0; x < a.n_fv; ++x) copy_async(fv_s + x * W + s, a.fv + x * plane + g);
  }
  if (kMasked) load_live(live_s, gs, a.live, W);
  if (kForced) load_tile_forcing(fsm, gs, a.fc, a.rt, a.ct, a.hm, a.hi, Wi, plane, rank);
  if (kStrat) load_strat_w(ssm.wsl, a.strat_w, K, k0, kr, a.kc_log2);
  if (n_slices > 0) {
    load_slice(st, gs, a.h, a.u, W, a.ks_log2, a.vec_log2, k0, min(ks, kr), K, plane);
    if (kTracers)
      load_tracers(st + 8 * WK, gs, a.tr.tr, 2 * a.tr.n, W, a.ks_log2, a.vec_log2, k0,
                   min(ks, kr), K, plane);
  }
  __pipeline_commit();

  const T dt_div = a.dt * a.s_div;
  const T pg_scale = kStrat ? -a.dt : T(-kGravity) * a.dt;
  const T dt_rayl = a.dt * a.fc.rayl;  // the forced arm's Rayleigh factor
  // the forced arm: whether this block's chunk holds some edge's top or
  // bottom level (then its tile's levels are staged and its pass runs)
  const bool wd = kForced && ((a.fc.lvl_ranks >> rank) & 1u);
  const FastDiv by_di(Di), by_ct(a.ct), by_fi(Fi);
  const int lane_mask = ks - 1;
  const int g_width = min(ks, 32);

  for (int sl = 0; sl < n_slices; ++sl) {
    const int kb = sl * ks;        // the slice's first level in the chunk
    const int kn = min(ks, kr - kb);  // its real levels
    if (sl + 1 < n_slices) {
      const int kb2 = kb + ks;
      T* nxt = st + ((sl + 1) & 1) * SK;
      load_slice(nxt, gs, a.h, a.u, W, a.ks_log2, a.vec_log2, k0 + kb2, min(ks, kr - kb2), K,
                 plane);
      if (kTracers)
        load_tracers(nxt + 8 * WK, gs, a.tr.tr, 2 * a.tr.n, W, a.ks_log2, a.vec_log2, k0 + kb2,
                     min(ks, kr - kb2), K, plane);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const T* cur = st + (sl & 1) * SK;

    if (kStrat && !FB) {
      // the stratified arm's chunk of the old h on the tile plus one ring
      for (int e = threadIdx.x; e < Fs * ks; e += blockDim.x) {
        const int t = e >> a.ks_log2, kl = e & lane_mask;
        if (kl >= kn) continue;
        const int r = by_fi.div(t), c = by_fi.mod(t, r);
        const int sw = (a.hm - 1 + r) * Wi + a.hi - 1 + c;
        ssm.fresh[t * kc + kb + kl] = cur[sw * ks + kl];
        ssm.fresh[(Fs + t) * kc + kb + kl] = cur[WK + sw * ks + kl];
      }
    }

    // stage A: the derived planes on the tile plus the ring
    for (int e = threadIdx.x; e < D * ks; e += blockDim.x) {
      const int d = e >> a.ks_log2, kl = e & lane_mask;
      if (kl >= kn) continue;
      const int r = by_di.div(d), c = by_di.mod(d, r);
      const int sw = (r + a.hm - a.dr) * Wi + c + a.hi - a.dc;
      const T* lv = cur + sw * ks + kl;
      T u[kU], h[kH];
#pragma unroll
      for (int i = 0; i < kU; ++i) u[i] = lv[tp.a_u[i]];
#pragma unroll
      for (int i = 0; i < kH; ++i) h[i] = lv[tp.a_h[i]];
      T F[6], ke[2], qv[kV];
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) F[ch] = u[ch] * (T(0.5) * (h[nb_h(ch)] + h[ch & 1]));
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        T tot = u[p] * u[p] + u[2 + p] * u[2 + p];
        tot = tot + u[4 + p] * u[4 + p];
#pragma unroll
        for (int x = 3 * p; x < 3 * p + 3; ++x) tot = tot + u[inc_u(x)] * u[inc_u(x)];
        ke[p] = tot * a.s_ke;
      }
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int cls = v_src(v, 0);
        const int sv = sw + tp.a_v[v];
        const T zeta = (cls < 2 ? (u[curl_u(v, 0)] - u[curl_u(v, 1)]) - u[curl_u(v, 2)]
                                : (u[curl_u(v, 0)] + u[curl_u(v, 1)]) - u[curl_u(v, 2)]) *
                       a.s_curl;
        T hv = T(0);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const T wgt = kMasked ? fv_s[(8 + kite_t(v, j)) * W + sv] : tp.kw[kite_t(v, j)];
          const T contrib = wgt * h[kite_h(v, j)];
          hv = j == 0 ? contrib : hv + contrib;
        }
        const T num = fv_s[cls * W + sv] + zeta;
        if (kMasked) {
          const T vm = fv_s[(4 + cls) * W + sv];
          qv[v] = num / (vm > T(0) ? hv : T(1)) * vm;
        } else {
          qv[v] = num / hv;
        }
      }
      T* out = dsm + d * ks + kl;
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) {
        const T qe = T(0.5) * (qv[ev_v(2 * ch)] + qv[ev_v(2 * ch + 1)]);
        out[ch * DK] = F[ch];
        out[(6 + ch) * DK] = F[ch] * qe;
        out[(12 + ch) * DK] = qe;
      }
      out[18 * DK] = ke[0];
      out[19 * DK] = ke[1];
    }
    __syncthreads();

    // stage B, continuity: h' on the tile (FE) or on the tile plus one ring
    // (FB), each slice's column sums added in order; the tile's h' stored
    // (and its tracers carried), FB's stratified arm keeping its chunk of h'
    const int cn = FB ? Fs : core;
    for (int e0 = 0; e0 < cn * ks; e0 += blockDim.x) {
      const int e = e0 + threadIdx.x;
      const int t = e >> a.ks_log2, kl = e & lane_mask;
      const bool on = e < cn * ks && kl < kn;
      int r = 0, c = 0;
      if (FB) {
        const int tt = on ? t : 0;
        r = by_fi.div(tt) - 1;
        c = by_fi.mod(tt, r + 1) - 1;
      } else {
        const int tt = on ? t : 0;
        r = by_ct.div(tt);
        c = by_ct.mod(tt, r);
      }
      T hnew[2] = {T(0), T(0)};
      if (on) {
        const int sw = (a.hm + r) * Wi + a.hi + c;
        const int bd = ((a.dr + r) * Di + a.dc + c) * ks + kl;
        const T* fl = dsm + bd;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          T total = fl[tp.b_f[hex::self_u(p)]] + fl[tp.b_f[hex::self_u(2 + p)]];
          total = total + fl[tp.b_f[hex::self_u(4 + p)]];
#pragma unroll
          for (int x = 3 * p; x < 3 * p + 3; ++x) total = total - fl[tp.b_f[hex::inc_u(x)]];
          hnew[p] = cur[sw * ks + kl + p * WK] - dt_div * total;
        }
        const int gm = tm * a.rt + r, gi = ti * a.ct + c;
        const bool own = r >= 0 && r < a.rt && c >= 0 && c < a.ct && gm < a.ny2 && gi < a.nx;
        if (own) {
          T* h_o = a.h_out + buffer_site(gm, gi, a.nx, a.ro) * K + k0 + kb + kl;
          h_o[0] = hnew[0];
          h_o[plane * K] = hnew[1];
        }
        if (kStrat && FB) {  // the fresh h' that Phi reads
          ssm.fresh[t * kc + kb + kl] = hnew[0];
          ssm.fresh[(Fs + t) * kc + kb + kl] = hnew[1];
        }
        if (kTracers && own) {
          const T* lv = cur + sw * ks + kl;
          const int g = buffer_site(gm, gi, a.nx, a.ro);
          T u[hex::kEdgeU], h[hex::kH];
#pragma unroll
          for (int i = 0; i < hex::kEdgeU; ++i) u[i] = lv[tp.us[i]];
#pragma unroll
          for (int i = 0; i < hex::kH; ++i) h[i] = lv[tp.hs[i]];
          T cm[2] = {T(1), T(1)};
          unsigned live = 0u, inc_live = 0u;
          if (kMasked) {  // the live bits and live-cell mask of the site (a channel's)
            live = static_cast<unsigned>(live_s[sw]);
            inc_live = incoming_live(live_s, sw, a.tr);
            cm[0] = a.tr.cmask[g], cm[1] = a.tr.cmask[plane + g];
          }
          tracer_step<T, kMasked>(lv, WK, tp, u, h, hnew, cm, live, inc_live, a.tr, dt_div,
                                  a.inv_dc, [&](int i, T v) {
                                    a.tr.tr_out[(i * plane + g) * K + k0 + kb + kl] = v;
                                  });
        }
      }
      const T s0 = group_sum(hnew[0], g_width), s1 = group_sum(hnew[1], g_width);
      if (e < cn * ks && kl == 0) {
        part[t] = sl == 0 ? s0 : part[t] + s0;
        part[P + t] = sl == 0 ? s1 : part[P + t] + s1;
      }
    }

    // stage B, momentum on the tile: u + dt ((q_e T(F) + T(F q_e)) / 2 -
    // grad KE) (forced: - dt lambda u), then (FE) the old ssh's pressure and
    // the mask, stored; deferred, kept for the pressure
    for (int e = threadIdx.x; e < core * ks; e += blockDim.x) {
      const int t = e >> a.ks_log2, kl = e & lane_mask;
      if (kl >= kn) continue;
      const int r = by_ct.div(t), c = by_ct.mod(t, r);
      const int sw = (a.hm + r) * Wi + a.hi + c;
      const int bd = ((a.dr + r) * Di + a.dc + c) * ks + kl;
      const T* fl = dsm + bd;
      T F[hex::kU], Fq[hex::kU];
#pragma unroll
      for (int i = 0; i < hex::kU; ++i) {
        F[i] = fl[tp.b_f[i]];
        Fq[i] = fl[tp.b_f[i] + 6 * DK];
      }
      const T ke0 = fl[18 * DK], ke1 = fl[19 * DK];
      T unew[6];
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) {
        T tf = T(0), tfq = T(0);
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int t2 = 8 * ch + x;
          const T c1 = tp.w[t2] * F[hex::tap_u(t2)];
          const T c2 = tp.w[t2] * Fq[hex::tap_u(t2)];
          tf = x == 0 ? c1 : tf + c1;
          tfq = x == 0 ? c2 : tfq + c2;
        }
        const T pv = T(0.5) * (fl[(12 + ch) * DK] * tf + tfq);
        const T gke = (fl[tp.b_ke[ch]] - ((ch & 1) ? ke1 : ke0)) * a.inv_dc;
        unew[ch] = cur[sw * ks + kl + (2 + ch) * WK] + a.dt * (pv - gke);
        if (kForced && kDefer) unew[ch] = unew[ch] - dt_rayl * cur[sw * ks + kl + (2 + ch) * WK];
      }
      if (kDefer) {
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) upart[(ch * core + t) * kc + kb + kl] = unew[ch];
      } else {
        const int gm = tm * a.rt + r, gi = ti * a.ct + c;
        if (gm >= a.ny2 || gi >= a.nx) continue;  // a ragged tile's edge
        const unsigned lb = kMasked ? static_cast<unsigned>(live_s[sw]) : kAllLive;
        T* u_o = a.u_out + buffer_site(gm, gi, a.nx, a.ro) * K + k0 + kb + kl;
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) {
          const T grad = (ssh_s[sw + tp.nb_p[ch]] - ssh_s[(ch & 1) * W + sw]) * a.inv_dc;
          T v = unew[ch] + pg_scale * grad;
          if (kForced) v = v - dt_rayl * cur[sw * ks + kl + (2 + ch) * WK];
          u_o[ch * plane * K] = (kMasked && !((lb >> ch) & 1u)) ? T(0) : v;
        }
      }
    }
    __syncthreads();

    if (wd) {
      // the forced arm: the wind and drag at the tile's edges' top and bottom
      // levels in this slice, of the slice's old state, added to the stored
      // u' (deferred: to the kept momentum); masked channels keep their 0
      for (int e = threadIdx.x; e < 6 * core; e += blockDim.x) {
        const int ch = e / core, t = e - ch * core;
        const int r = by_ct.div(t), c = by_ct.mod(t, r);
        const int gm = tm * a.rt + r, gi = ti * a.ct + c;
        const int sw = (a.hm + r) * Wi + a.hi + c;
        if (gm >= a.ny2 || gi >= a.nx || (kMasked && !((live_s[sw] >> ch) & 1u))) continue;
        const int lv = fsm.lvl[ch * core + t];
        int lev[2];
        chunk_levels(lv, k0 + kb, kn, &lev[0], &lev[1]);
        for (int i = 0; i < 2; ++i) {
          const int kl = lev[i];
          if (kl < 0) continue;
          const T* v = cur + sw * ks + kl;
          const T he = T(0.5) * (v[tp.hs[hex::nb_h(ch)]] + v[tp.hs[hex::self_h(ch & 1)]]);
          T& o = kDefer ? upart[(ch * core + t) * kc + kb + kl]
                        : a.u_out[(ch * plane + buffer_site(gm, gi, a.nx, a.ro)) * K + k0 +
                                  kb + kl];
          o = o + a.dt * wind_drag(v[tp.us[hex::self_u(ch)]], he, lv, k0 + kb + kl,
                                   fsm.wind + ch * core + t, a.fc);
        }
      }
      __syncthreads();
    }
  }

  // ssh' = sum_k h' - rts over the ranks' partial sums, in rank order (FB:
  // every rank, on the tile plus one ring; FE: rank 0, on the tile)
  cluster.sync();
  if (FB || rank == 0) {
    for (int e = threadIdx.x; e < 2 * P; e += blockDim.x) {
      const int p = e >= P ? 1 : 0, x = e - p * P;
      int r, c;
      if (FB) {
        r = by_fi.div(x);
        c = by_fi.mod(x, r);
      } else {
        r = by_ct.div(x) + 1;
        c = by_ct.mod(x, r - 1) + 1;
      }
      T v[kMaxCluster];
#pragma unroll
      for (int rr = 0; rr < kMaxCluster; ++rr)
        if (rr < n_ranks) v[rr] = *cluster.map_shared_rank(part + e, rr);
      T sum = v[0];
#pragma unroll
      for (int rr = 1; rr < kMaxCluster; ++rr)
        if (rr < n_ranks) sum += v[rr];
      const T ssh = sum - rts_s[p * W + (a.hm - 1 + r) * Wi + a.hi - 1 + c];
      if (FB) sshf[e] = ssh;
      const int gm = tm * a.rt + r - 1, gi = ti * a.ct + c - 1;
      if (rank == 0 && r >= 1 && r <= a.rt && c >= 1 && c <= a.ct && gm < a.ny2 && gi < a.nx)
        a.ssh_out[p * plane + buffer_site(gm, gi, a.nx, a.ro)] = ssh;
    }
  }
  if (kStrat && !FB) {
    // FE's Phi takes the old ssh, on the tile plus one ring
    for (int e = threadIdx.x; e < 2 * Fs; e += blockDim.x) {
      const int p = e >= Fs ? 1 : 0, x = e - p * Fs;
      const int r = by_fi.div(x), c = by_fi.mod(x, r);
      sshf[e] = ssh_s[p * W + (a.hm - 1 + r) * Wi + a.hi - 1 + c];
    }
  }
  if (kDefer) {
    __syncthreads();
    // the stratified arm: Phi at this block's levels on the tile grown by
    // the gradient's reach, from every rank's chunk of h (each written before
    // the barrier above, none written after it)
    if (kStrat)
      montgomery(ssm, cluster, ssm.fresh, sshf, 1 + a.nr.m0, 1 + a.rt + a.nr.m1, 1 + a.nr.i0,
                 1 + a.ct + a.nr.i1, Fi, Fs, a.kc_log2, kr, K, rank, n_ranks);
    // the pressure (of the fresh ssh, FB; of each level's Phi, stratified)
    // on this rank's chunk of the tile
    for (int e = threadIdx.x; e < core * kc; e += blockDim.x) {
      const int t = e >> a.kc_log2, kl = e & (kc - 1);
      if (kl >= kr) continue;
      const int r = by_ct.div(t), c = by_ct.mod(t, r);
      const int gm = tm * a.rt + r, gi = ti * a.ct + c;
      if (gm >= a.ny2 || gi >= a.nx) continue;
      const int sf = (r + 1) * Fi + c + 1;
      const unsigned lb =
          kMasked ? static_cast<unsigned>(live_s[(a.hm + r) * Wi + a.hi + c]) : kAllLive;
      T* u_o = a.u_out + buffer_site(gm, gi, a.nx, a.ro) * K + k0 + kl;
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) {
        T grad;
        if (kStrat) {
          const T* ph = ssm.phi + (sf << a.kc_log2) + kl;
          grad = (ph[tp.nb_p[ch] << a.kc_log2] - ph[(ch & 1) * (Fs << a.kc_log2)]) * a.inv_dc;
        } else {
          grad = (sshf[sf + tp.nb_p[ch]] - sshf[(ch & 1) * Fs + sf]) * a.inv_dc;
        }
        const T v = upart[(ch * core + t) * kc + kl] + pg_scale * grad;
        u_o[ch * plane * K] = (kMasked && !((lb >> ch) & 1u)) ? T(0) : v;
      }
    }
  }
  // no block may leave while another can still read its partial sums (and
  // the stratified arm's h chunk)
  cluster.sync();
}

// Dynamic shared memory of one block (kernels/fe_step.nl_smem_bytes mirrors
// this): two state slices (with the tracer arm's 2 n_tr planes each), the
// derived planes, the window's ssh, rts and vertex constants (20 planes, the
// masked arm's, reserved by the periodic one too), the partial column sums,
// for FB and the stratified arm the pressure's ssh and the chunk's u + dt
// (PV flux - grad KE) on the tile, and the window's sites with their live
// bits; the stratified arm's (strat_k = K > 0: Phi, staging, W slice and h
// chunk on the tile plus one ring) and the forced arm's (the tile's winds
// and packed levels) beyond.
inline size_t nl_smem_bytes(int rt, int ct, int hm, int hi, int dr, int dc, int kc, int ks,
                            bool fb, size_t itemsize, bool forced = false, int n_tr = 0,
                            int strat_k = 0) {
  const long long W = static_cast<long long>(rt + 2 * hm) * (ct + 2 * hi);
  const long long D = static_cast<long long>(rt + 2 * dr) * (ct + 2 * dc);
  const long long F = static_cast<long long>(rt + 2) * (ct + 2);
  const long long core = static_cast<long long>(rt) * ct;
  const long long P = fb ? F : core;
  long long vals = 2 * (8 + 2 * n_tr) * W * ks + hex_vert::kPlanes * D * ks +
                   (4 + hex_vert::kFv) * W + 2 * P;
  if (fb || strat_k > 0) vals += 2 * F + 6 * core * kc;
  return itemsize * static_cast<size_t>(vals) + 2 * sizeof(int) * static_cast<size_t>(W) +
         (strat_k > 0 ? strat_smem_bytes(F, kc, strat_k, itemsize, true) : 0) +
         (forced ? forcing_smem_bytes(core, 0, itemsize) : 0);
}

// One call's launch set-up.
template <typename T>
struct NlPlan {
  NlArgs<T> a;
  NlTaps<T> tp;
  int n_ranks, n_tiles, max_smem;
  size_t smem;
};

// FE reaches (2, 4) and computes its derived planes on a (1, 2) ring, FB
// (3, 4) and (2, 2) (slab.stencil_reach, slab.derived_ring on the hex
// tables, which resolve_nl_taps checks).
template <typename T>
int make_nl_plan(NlPlan<T>* pl, bool fb, const T* rts, const T* fv, int n_fv, const int* live,
                 const ForcingArgs<T>& fc, TracerArgs<T> tr, const T* strat_w,
                 const int* table, const double* weights, const int* vc, const double* vc_w,
                 const int* ev, double dt, double inv_dc, double s_div, double s_ke,
                 double s_curl, int ny2, int nx, int k, int n_steps, int n_terms, int rt, int ct,
                 int ks, bool vec, int ro = 0) {
  if (!valid_shape(ny2, nx, k, n_steps, n_terms) || table[0] != n_terms)
    return cudaErrorInvalidValue;
  if (rt < 1 || ct < 1 || rt > ny2 + 2 * ro || ct > nx || ro < 0 || (n_fv != 4 && n_fv != 20) ||
      (live != nullptr) != (n_fv == 20))
    return cudaErrorInvalidValue;
  // the tracer arm: at least one tracer, the cell mask with the live bits
  if (tr.tr != nullptr && (tr.n < 1 || (live == nullptr) != (tr.cmask == nullptr)))
    return cudaErrorInvalidValue;
  const bool strat = strat_w != nullptr;
  const int hm = fb ? 3 : 2, hi = 4, dr = fb ? 2 : 1, dc = 2;
  const int kc = step_chunk(k);
  if (ks < 1 || ks > kc || (ks & (ks - 1)) || ks > 16) return cudaErrorInvalidValue;
  const int Wi = ct + 2 * hi, W = (rt + 2 * hm) * Wi;
  const int Di = ct + 2 * dc, D = (rt + 2 * dr) * Di;
  const bool ring = fb || strat;  // the pressure on the tile plus one ring
  const int pw = ring ? (rt + 2) * (ct + 2) : W, pi = ring ? ct + 2 : Wi;
  pl->n_ranks = (k + kc - 1) / kc;
  if (!resolve_nl_taps<T>(&pl->tp, table, weights, vc, vc_w, ev, Wi, W, Di, D, ks, pw, pi))
    return kNotHexTable;
  resolve_tracer_taps(&tr, table, Wi);
  int e = opt_in_smem(&pl->max_smem);
  if (e != 0) return e;
  pl->smem = nl_smem_bytes(rt, ct, hm, hi, dr, dc, kc, ks, fb, sizeof(T), fc.wind != nullptr,
                           tr.tr != nullptr ? tr.n : 0, strat ? k : 0);
  if (pl->smem > static_cast<size_t>(pl->max_smem)) return cudaErrorInvalidValue;
  const int n_ti = (nx + ct - 1) / ct;
  pl->n_tiles = ((ny2 + rt - 1) / rt) * n_ti;
  const bool vec_ok = vec && (ks * static_cast<int>(sizeof(T))) % 16 == 0;
  pl->a = NlArgs<T>{nullptr, nullptr, nullptr, rts, fv, live, nullptr, nullptr, nullptr, fc,
                    tr, strat_w, nbr_reach(table), T(dt), T(inv_dc), T(s_div), T(s_ke),
                    T(s_curl), ny2, nx, k, rt, ct, hm, hi, dr, dc, n_fv, log2_exact(kc),
                    log2_exact(ks),
                    vec_ok ? log2_exact(ks * static_cast<int>(sizeof(T)) / 16) : -1, n_ti, ro};
  return 0;
}

template <typename T, bool FB, bool kMasked, bool kForced, bool kTracers, bool kStrat>
int nl_prepare(int max_smem) {
  static bool done = false;
  if (done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(nl_step_kernel<T, FB, kMasked, kForced, kTracers, kStrat>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  done = e == cudaSuccess;
  return static_cast<int>(e);
}

template <typename T, bool FB, bool kMasked, bool kForced, bool kTracers, bool kStrat>
int nl_launch_arm(const NlPlan<T>* pl, cudaStream_t stream) {
  const int err = nl_prepare<T, FB, kMasked, kForced, kTracers, kStrat>(pl->max_smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = step_config(pl->n_ranks, pl->n_tiles, pl->smem, stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, nl_step_kernel<T, FB, kMasked, kForced, kTracers, kStrat>, pl->a, pl->tp);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of the plan's arm: any combination of forced, tracers
// and stratified.
template <typename T, bool FB, bool kMasked>
int nl_launch_masked(const NlPlan<T>* pl, cudaStream_t stream) {
  using Launch = int (*)(const NlPlan<T>*, cudaStream_t);
  static const Launch arms[8] = {
      nl_launch_arm<T, FB, kMasked, false, false, false>,
      nl_launch_arm<T, FB, kMasked, false, false, true>,
      nl_launch_arm<T, FB, kMasked, false, true, false>,
      nl_launch_arm<T, FB, kMasked, false, true, true>,
      nl_launch_arm<T, FB, kMasked, true, false, false>,
      nl_launch_arm<T, FB, kMasked, true, false, true>,
      nl_launch_arm<T, FB, kMasked, true, true, false>,
      nl_launch_arm<T, FB, kMasked, true, true, true>};
  return arms[(pl->a.fc.wind != nullptr ? 4 : 0) + (pl->a.tr.tr != nullptr ? 2 : 0) +
              (pl->a.strat_w != nullptr ? 1 : 0)](pl, stream);
}

template <typename T, bool FB>
int nl_launch(NlPlan<T>* pl, const T* ssh, const T* h, const T* u, T* ssh_out, T* h_out,
              T* u_out, cudaStream_t stream, const T* tr = nullptr, T* tr_out = nullptr) {
  pl->a.ssh = ssh, pl->a.h = h, pl->a.u = u;
  pl->a.ssh_out = ssh_out, pl->a.h_out = h_out, pl->a.u_out = u_out;
  if (pl->a.tr.tr != nullptr) pl->a.tr.tr = tr, pl->a.tr.tr_out = tr_out;
  return pl->a.live != nullptr ? nl_launch_masked<T, FB, true>(pl, stream)
                               : nl_launch_masked<T, FB, false>(pl, stream);
}

// n_steps nonlinear FE or FB steps from `in` into `out` through `tmp`, as fe_steps in
// fe_step.cu: step s writes `out` when n_steps - 1 - s is even, so the last
// lands in `out` and no step writes the buffers it reads; the tracer arm's
// planes (tr.tr non-null) alike.
template <typename T, bool FB>
int nl_steps(const T* rts, const T* fv, int n_fv, const int* live, const ForcingArgs<T>& fc,
             const TracerArgs<T>& tr, T* tr_tmp, const T* strat_w, const int* table,
             const double* weights, const int* vc, const double* vc_w, const int* ev,
             const T* ssh_in, const T* h_in, const T* u_in, T* ssh_out, T* h_out, T* u_out,
             T* ssh_tmp, T* h_tmp, T* u_tmp, double dt, double inv_dc, double s_div,
             double s_ke, double s_curl, int ny2, int nx, int k, int n_steps, int n_terms,
             int rt, int ct, int ks, int ro, cudaStream_t stream) {
  // received halos: one step's reach of rows (FE 2, FB 3), and no more, and
  // tiles whose rows divide the slab's (a ragged tile's window would leave it)
  if (ro != 0 && (ro != (FB ? 3 : 2) || ny2 % rt)) return cudaErrorInvalidValue;
  const int kc = step_chunk(k);
  const bool vec = vector_loads(k, kc, sizeof(T), h_in, u_in) &&
                   vector_loads(k, kc, sizeof(T), h_out, u_out) &&
                   vector_loads(k, kc, sizeof(T), h_tmp, u_tmp) &&
                   (tr.tr == nullptr || (vector_loads(k, kc, sizeof(T), tr.tr, tr.tr_out) &&
                                         vector_loads(k, kc, sizeof(T), tr_tmp, tr_tmp)));
  NlPlan<T> pl;
  int err = make_nl_plan<T>(&pl, FB, rts, fv, n_fv, live, fc, tr, strat_w, table, weights, vc,
                            vc_w, ev, dt, inv_dc, s_div, s_ke, s_curl, ny2, nx, k, n_steps,
                            n_terms, rt, ct, ks, vec, ro);
  if (err != 0) return err;
  const T *ssh = ssh_in, *h = h_in, *u = u_in, *t = tr.tr;
  for (int s = 0; s < n_steps; ++s) {
    const bool to_out = ((n_steps - 1 - s) & 1) == 0;
    T* ssh_d = to_out ? ssh_out : ssh_tmp;
    T* h_d = to_out ? h_out : h_tmp;
    T* u_d = to_out ? u_out : u_tmp;
    T* t_d = to_out ? tr.tr_out : tr_tmp;
    err = nl_launch<T, FB>(&pl, ssh, h, u, ssh_d, h_d, u_d, stream, t, t_d);
    if (err != 0) return err;
    ssh = ssh_d, h = h_d, u = u_d, t = t_d;
  }
  return 0;
}

// n_steps nonlinear steps through a stack of states: slot s + 1 = step(slot
// s), the launches nl_steps makes (the same kernel and plan, with the same
// forced, tracer and stratified arms; tr.tr the tracer stack (S, 2 nT, ny2,
// nx, K)), so a stack refilled from a state holds nl_steps' states bit for
// bit.
template <typename T, bool FB>
int nl_stack(const T* rts, const T* fv, int n_fv, const int* live, const ForcingArgs<T>& fc,
             const TracerArgs<T>& tr, const T* strat_w, const int* table,
             const double* weights, const int* vc, const double* vc_w, const int* ev, T* ssh,
             T* h, T* u, double dt, double inv_dc, double s_div, double s_ke, double s_curl,
             int ny2, int nx, int k, int n_steps, int n_terms, int rt, int ct, int ks,
             cudaStream_t stream) {
  const int kc = step_chunk(k);
  NlPlan<T> pl;
  int err = make_nl_plan<T>(&pl, FB, rts, fv, n_fv, live, fc, tr, strat_w, table, weights, vc,
                            vc_w, ev, dt, inv_dc, s_div, s_ke, s_curl, ny2, nx, k, n_steps,
                            n_terms, rt, ct, ks,
                            vector_loads(k, kc, sizeof(T), h, u) &&
                                (tr.tr == nullptr || vector_loads(k, kc, sizeof(T), tr.tr, tr.tr)));
  if (err != 0) return err;
  const size_t cells = 2ULL * ny2 * nx;
  const size_t hs = cells * k, us = 3 * cells * k, trs = tr.tr != nullptr ? tr.n * hs : 0;
  T* t = const_cast<T*>(tr.tr);
  for (int s = 0; s < n_steps; ++s) {
    err = nl_launch<T, FB>(&pl, ssh + s * cells, h + s * hs, u + s * us, ssh + (s + 1) * cells,
                           h + (s + 1) * hs, u + (s + 1) * us, stream,
                           t ? t + s * trs : nullptr, t ? t + (s + 1) * trs : nullptr);
    if (err != 0) return err;
  }
  return 0;
}

// The launch of an f32 nonlinear plan of the plain arm: out[0] the clusters
// (one per tile), out[1] the blocks per SM, out[2] one block's shared memory
// in bytes.
template <bool FB>
int nl_plan_query(int ny2, int nx, int k, int rt, int ct, int ks, int* out) {
  int max_smem = 0;
  int e = opt_in_smem(&max_smem);
  if (e != 0) return e;
  const int kc = step_chunk(k);
  const size_t smem = nl_smem_bytes(rt, ct, FB ? 3 : 2, 4, FB ? 2 : 1, 2, kc, ks, FB,
                                    sizeof(float));
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  if ((e = nl_prepare<float, FB, false, false, false, false>(max_smem)) != 0) return e;
  out[0] = ((ny2 + rt - 1) / rt) * ((nx + ct - 1) / ct);
  out[2] = static_cast<int>(smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], nl_step_kernel<float, FB, false, false, false, false>, kStepThreads, smem));
}

}  // namespace lattice

// The C entries of one arm (FB false: fe_step's FE arm, entries mot_fe_nl_*;
// FB true: tiled_step's FB arm, q = 1, mot_tiled_nl_*) in one dtype; each
// nl_step_*.cu translation unit expands those of one arm and dtype, so that
// the instantiations compile in parallel.
//
// The steps entry: n_steps nonlinear steps from `in` into `out` through
// `tmp`, over rt x ct tiles (they need not divide the lattice) in level
// slices of ks. `fv` holds the vertex constants (n_fv = 4 planes periodic,
// 20 with live bits), `vc` / `vc_w` / `ev` the vertex tables (host copies,
// kernels/fe_step.vertex_tables); a null `wind` runs the unforced arm, any
// other the forced one with `lvl` and the coefficients; a null `tr_in` the
// tracer-free arm, any other the tracer arm with n_tr tracers (planes
// (2 n_tr, ny2, nx, k) in `tr_in`, `tr_out`, `tr_tmp`), the live-cell mask
// `cmask` (non-null exactly when `live` is), kappa and upwind; a null
// `strat_w` the unstratified arm, any other (W, (k, k) row-major) the
// stratified one; the three in any combination. The stack entry (the
// gradient's rebuild, nl_stack): slot s + 1 = step(slot s) for s < n_steps,
// the same arms, the tracer arm's planes in the tracer stack `tr`
// (S, 2 n_tr, ny2, nx, k). Each returns 0, kNotHexTable for a table that is
// not the hex lattice's, or the CUDA error.
#define MOT_NL_ENTRIES(T, SUFFIX, ARM, FB)                                                    \
  extern "C" int mot_##ARM##_nl_steps_##SUFFIX(                                               \
      const T* rts, const T* fv, int n_fv, const int* live, const T* wind, const int* lvl,    \
      const int* table, const double* weights, const int* vc, const double* vc_w,             \
      const int* ev, const T* ssh_in, const T* h_in, const T* u_in, T* ssh_out, T* h_out,     \
      T* u_out, T* ssh_tmp, T* h_tmp, T* u_tmp, const T* tr_in, T* tr_out, T* tr_tmp,         \
      const T* cmask, const T* strat_w, double dt, double inv_dc, double s_div, double s_ke,  \
      double s_curl, double kappa, double upwind, double dlin, double dquad, double rayl,     \
      int lvl_ranks, int wind_ranks, int ny2, int nx, int k, int n_steps, int n_terms,        \
      int ro, int rt, int ct, int ks, int n_tr, void* stream) {                               \
    const lattice::ForcingArgs<T> fc{wind, lvl, T(dlin), T(dquad), T(rayl),                   \
                                     static_cast<unsigned>(lvl_ranks),                        \
                                     static_cast<unsigned>(wind_ranks)};                      \
    const lattice::TracerArgs<T> tr{tr_in, tr_out, cmask, T(kappa), T(0.5 * upwind), n_tr,   \
                                    {}, {}};                                                  \
    return lattice::nl_steps<T, FB>(rts, fv, n_fv, live, fc, tr, tr_tmp, strat_w, table,      \
                                    weights, vc, vc_w, ev, ssh_in, h_in, u_in, ssh_out,       \
                                    h_out, u_out, ssh_tmp, h_tmp, u_tmp, dt, inv_dc, s_div,   \
                                    s_ke, s_curl, ny2, nx, k, n_steps, n_terms, rt, ct, ks,   \
                                    ro, static_cast<cudaStream_t>(stream));                   \
  }
#define MOT_NL_STACK_ENTRY(T, SUFFIX, ARM, FB)                                                \
  extern "C" int mot_##ARM##_nl_stack_##SUFFIX(                                               \
      const T* rts, const T* fv, int n_fv, const int* live, const T* wind, const int* lvl,    \
      const int* table, const double* weights, const int* vc, const double* vc_w,             \
      const int* ev, T* ssh, T* h, T* u, T* tr, const T* cmask, const T* strat_w, double dt,  \
      double inv_dc, double s_div, double s_ke, double s_curl, double kappa, double upwind,   \
      double dlin, double dquad, double rayl, int lvl_ranks, int wind_ranks, int ny2, int nx, \
      int k, int n_steps, int n_terms, int rt, int ct, int ks, int n_tr, void* stream) {      \
    const lattice::ForcingArgs<T> fc{wind, lvl, T(dlin), T(dquad), T(rayl),                   \
                                     static_cast<unsigned>(lvl_ranks),                        \
                                     static_cast<unsigned>(wind_ranks)};                      \
    const lattice::TracerArgs<T> trs{tr, nullptr, cmask, T(kappa), T(0.5 * upwind), n_tr,    \
                                     {}, {}};                                                 \
    return lattice::nl_stack<T, FB>(rts, fv, n_fv, live, fc, trs, strat_w, table, weights,    \
                                    vc, vc_w, ev, ssh, h, u, dt, inv_dc, s_div, s_ke, s_curl, \
                                    ny2, nx, k, n_steps, n_terms, rt, ct, ks,                 \
                                    static_cast<cudaStream_t>(stream));                       \
  }
