// One step of the nonlinear (vector-invariant) TRiSK shallow-water core on the
// parity-plane hex lattice, forward Euler (FE) or forward-backward (FB), for
// NVIDIA Hopper (sm_90a): the nonlinear arms of fe_step.cu (FE) and
// tiled_step.cu (FB, q = 1), which each instantiate this kernel once.
//
// Replaces: the nonlinear branch of _step_planes (nl, pallas_model.py:172-242)
// in _rollout_kernel (:320, FE) and _step_slab_nl (sharded.py:597) in
// _tiled_step_kernel (:852, FE reach 2 and FB reach 3), periodic (4 f_vertex
// planes) and wall-masked (20 planes: f_vertex, vertex mask, 12 live kite
// weights; _nl_setup, :586-607), forcing, tracers and stratification off.
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
  T dt, inv_dc, s_div, s_ke, s_curl;
  int ny2, nx, K, rt, ct, hm, hi, dr, dc, n_fv, kc_log2, ks_log2, vec_log2, n_tiles_i;
};

// The stencils as offsets, resolved once per call on the host (kernel
// parameters, in the constant bank): stage A's sources in the state slice
// [8][W][ks], the endpoint vertices' window sites, and stage B's reads of
// the derived planes [20][D][ks] (D: the tile plus the ring).
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
};

// The hex tables resolved for a window of Wm x Wi = W sites, a derived ring
// (dr, dc) and slices of ks levels; false for a Coriolis or vertex table that
// is not the hex lattice's. ``pw``, ``pi`` are the pressure planes' sites per
// plane and per row (FE: the window's; FB: the tile plus one ring).
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

// One nonlinear step; a cluster of n_ranks blocks per tile, blocks of
// kStepThreads threads, groups of ks lanes on one site's slice levels.
template <typename T, bool FB, bool kMasked>
__global__ void __launch_bounds__(kStepThreads, 1)
    nl_step_kernel(const NlArgs<T> a, const NlTaps<T> tp) {
  using namespace hex_vert;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int tile = blockIdx.x / n_ranks;
  const int tm = tile / a.n_tiles_i, ti = tile % a.n_tiles_i;
  const int Wi = a.ct + 2 * a.hi, W = (a.rt + 2 * a.hm) * Wi;
  const int Di = a.ct + 2 * a.dc, D = (a.rt + 2 * a.dr) * Di;
  const int Fi = a.ct + 2, Fs = (a.rt + 2) * Fi;  // FB: the tile plus one ring
  const int core = a.rt * a.ct;
  const int P = FB ? Fs : core;  // the sites of the partial column sums
  const int kc = 1 << a.kc_log2, ks = 1 << a.ks_log2;
  const int k0 = rank * kc, kr = min(kc, a.K - k0);
  const int n_slices = (kr + ks - 1) >> a.ks_log2;
  const int plane = a.ny2 * a.nx;
  const int K = a.K;
  const int WK = W * ks, DK = D * ks;

  T* st = reinterpret_cast<T*>(smem_raw);  // [2][8][W][ks]: h p0, h p1, u c0..c5
  T* dsm = st + 2 * 8 * WK;                // [20][D][ks]: F, F q_e, q_e, KE
  T* ssh_s = dsm + hex_vert::kPlanes * DK;           // [2][W]: the old ssh (FE)
  T* rts_s = ssh_s + 2 * W;                // [2][W]
  T* fv_s = rts_s + 2 * W;                 // [kFv][W]
  T* part = fv_s + kFv * W;                // [2][P]
  T* sshf = part + 2 * P;                  // FB: [2][Fs], the fresh ssh
  T* upart = sshf + (FB ? 2 * Fs : 0);     // FB: [6][core][kc]
  int* gs = reinterpret_cast<int*>(upart + (FB ? 6 * core * kc : 0));  // [W]
  int* live_s = gs + W;                                                  // [W]

  allow_next_grid();
  window_sites(gs, tm * a.rt - a.hm, ti * a.ct - a.hi, Wi, W, a.ny2, a.nx);
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
  if (n_slices > 0)
    load_slice(st, gs, a.h, a.u, W, a.ks_log2, a.vec_log2, k0, min(ks, kr), K, plane);
  __pipeline_commit();

  const T dt_div = a.dt * a.s_div;
  const T pg_scale = T(-kGravity) * a.dt;
  const FastDiv by_di(Di), by_ct(a.ct), by_fi(Fi);
  const int lane_mask = ks - 1;
  const int g_width = min(ks, 32);

  for (int sl = 0; sl < n_slices; ++sl) {
    const int kb = sl * ks;        // the slice's first level in the chunk
    const int kn = min(ks, kr - kb);  // its real levels
    if (sl + 1 < n_slices) {
      const int kb2 = kb + ks;
      load_slice(st + ((sl + 1) & 1) * 8 * WK, gs, a.h, a.u, W, a.ks_log2, a.vec_log2,
                 k0 + kb2, min(ks, kr - kb2), K, plane);
      __pipeline_commit();
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const T* cur = st + (sl & 1) * 8 * WK;

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
        if (r >= 0 && r < a.rt && c >= 0 && c < a.ct && gm < a.ny2 && gi < a.nx) {
          T* h_o = a.h_out + (gm * a.nx + gi) * K + k0 + kb + kl;
          h_o[0] = hnew[0];
          h_o[plane * K] = hnew[1];
        }
      }
      const T s0 = group_sum(hnew[0], g_width), s1 = group_sum(hnew[1], g_width);
      if (e < cn * ks && kl == 0) {
        part[t] = sl == 0 ? s0 : part[t] + s0;
        part[P + t] = sl == 0 ? s1 : part[P + t] + s1;
      }
    }

    // stage B, momentum on the tile: u + dt ((q_e T(F) + T(F q_e)) / 2 -
    // grad KE), then (FE) the old ssh's pressure and the mask, stored; FB
    // keeps it for the fresh pressure
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
      }
      if (FB) {
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) upart[(ch * core + t) * kc + kb + kl] = unew[ch];
      } else {
        const int gm = tm * a.rt + r, gi = ti * a.ct + c;
        if (gm >= a.ny2 || gi >= a.nx) continue;  // a ragged tile's edge
        const unsigned lb = kMasked ? static_cast<unsigned>(live_s[sw]) : kAllLive;
        T* u_o = a.u_out + (gm * a.nx + gi) * K + k0 + kb + kl;
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) {
          const T grad = (ssh_s[sw + tp.nb_p[ch]] - ssh_s[(ch & 1) * W + sw]) * a.inv_dc;
          const T v = unew[ch] + pg_scale * grad;
          u_o[ch * plane * K] = (kMasked && !((lb >> ch) & 1u)) ? T(0) : v;
        }
      }
    }
    __syncthreads();
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
        a.ssh_out[p * plane + gm * a.nx + gi] = ssh;
    }
  }
  if (FB) {
    // the fresh ssh's pressure on this rank's chunk of the tile
    __syncthreads();
    for (int e = threadIdx.x; e < core * kc; e += blockDim.x) {
      const int t = e >> a.kc_log2, kl = e & (kc - 1);
      if (kl >= kr) continue;
      const int r = by_ct.div(t), c = by_ct.mod(t, r);
      const int gm = tm * a.rt + r, gi = ti * a.ct + c;
      if (gm >= a.ny2 || gi >= a.nx) continue;
      const int sf = (r + 1) * Fi + c + 1;
      const unsigned lb =
          kMasked ? static_cast<unsigned>(live_s[(a.hm + r) * Wi + a.hi + c]) : kAllLive;
      T* u_o = a.u_out + (gm * a.nx + gi) * K + k0 + kl;
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) {
        const T grad = (sshf[sf + tp.nb_p[ch]] - sshf[(ch & 1) * Fs + sf]) * a.inv_dc;
        const T v = upart[(ch * core + t) * kc + kl] + pg_scale * grad;
        u_o[ch * plane * K] = (kMasked && !((lb >> ch) & 1u)) ? T(0) : v;
      }
    }
  }
  // no block may leave while another can still read its partial sums
  cluster.sync();
}

// Dynamic shared memory of one block (kernels/fe_step.nl_smem_bytes mirrors
// this): two state slices, the derived planes, the window's ssh, rts and
// vertex constants (20 planes, the masked arm's, reserved by the periodic
// one too), the partial column sums, for FB the fresh ssh and the chunk's
// u + dt (PV flux - grad KE) on the tile, and the window's sites with their
// live bits.
inline size_t nl_smem_bytes(int rt, int ct, int hm, int hi, int dr, int dc, int kc, int ks,
                            bool fb, size_t itemsize) {
  const long long W = static_cast<long long>(rt + 2 * hm) * (ct + 2 * hi);
  const long long D = static_cast<long long>(rt + 2 * dr) * (ct + 2 * dc);
  const long long F = static_cast<long long>(rt + 2) * (ct + 2);
  const long long core = static_cast<long long>(rt) * ct;
  const long long P = fb ? F : core;
  long long vals = 16 * W * ks + hex_vert::kPlanes * D * ks + (4 + hex_vert::kFv) * W + 2 * P;
  if (fb) vals += 2 * F + 6 * core * kc;
  return itemsize * static_cast<size_t>(vals) + 2 * sizeof(int) * static_cast<size_t>(W);
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
                 const int* table, const double* weights, const int* vc, const double* vc_w,
                 const int* ev, double dt, double inv_dc, double s_div, double s_ke,
                 double s_curl, int ny2, int nx, int k, int n_steps, int n_terms, int rt, int ct,
                 int ks, bool vec) {
  if (!valid_shape(ny2, nx, k, n_steps, n_terms) || table[0] != n_terms)
    return cudaErrorInvalidValue;
  if (rt < 1 || ct < 1 || rt > ny2 || ct > nx || (n_fv != 4 && n_fv != 20) ||
      (live != nullptr) != (n_fv == 20))
    return cudaErrorInvalidValue;
  const int hm = fb ? 3 : 2, hi = 4, dr = fb ? 2 : 1, dc = 2;
  const int kc = step_chunk(k);
  if (ks < 1 || ks > kc || (ks & (ks - 1)) || ks > 16) return cudaErrorInvalidValue;
  const int Wi = ct + 2 * hi, W = (rt + 2 * hm) * Wi;
  const int Di = ct + 2 * dc, D = (rt + 2 * dr) * Di;
  const int pw = fb ? (rt + 2) * (ct + 2) : W, pi = fb ? ct + 2 : Wi;
  pl->n_ranks = (k + kc - 1) / kc;
  if (!resolve_nl_taps<T>(&pl->tp, table, weights, vc, vc_w, ev, Wi, W, Di, D, ks, pw, pi))
    return kNotHexTable;
  int e = opt_in_smem(&pl->max_smem);
  if (e != 0) return e;
  pl->smem = nl_smem_bytes(rt, ct, hm, hi, dr, dc, kc, ks, fb, sizeof(T));
  if (pl->smem > static_cast<size_t>(pl->max_smem)) return cudaErrorInvalidValue;
  const int n_ti = (nx + ct - 1) / ct;
  pl->n_tiles = ((ny2 + rt - 1) / rt) * n_ti;
  const bool vec_ok = vec && (ks * static_cast<int>(sizeof(T))) % 16 == 0;
  pl->a = NlArgs<T>{nullptr, nullptr, nullptr, rts, fv, live, nullptr, nullptr, nullptr,
                    T(dt), T(inv_dc), T(s_div), T(s_ke), T(s_curl), ny2, nx, k, rt, ct, hm, hi,
                    dr, dc, n_fv, log2_exact(kc), log2_exact(ks),
                    vec_ok ? log2_exact(ks * static_cast<int>(sizeof(T)) / 16) : -1, n_ti};
  return 0;
}

template <typename T, bool FB, bool kMasked>
int nl_prepare(int max_smem) {
  static bool done = false;
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      nl_step_kernel<T, FB, kMasked>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  done = e == cudaSuccess;
  return static_cast<int>(e);
}

template <typename T, bool FB>
int nl_launch(NlPlan<T>* pl, const T* ssh, const T* h, const T* u, T* ssh_out, T* h_out,
              T* u_out, cudaStream_t stream) {
  pl->a.ssh = ssh, pl->a.h = h, pl->a.u = u;
  pl->a.ssh_out = ssh_out, pl->a.h_out = h_out, pl->a.u_out = u_out;
  const bool masked = pl->a.live != nullptr;
  const int err = masked ? nl_prepare<T, FB, true>(pl->max_smem)
                         : nl_prepare<T, FB, false>(pl->max_smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = step_config(pl->n_ranks, pl->n_tiles, pl->smem, stream, attr);
  const cudaError_t e = masked ? cudaLaunchKernelEx(&cfg, nl_step_kernel<T, FB, true>, pl->a, pl->tp)
                               : cudaLaunchKernelEx(&cfg, nl_step_kernel<T, FB, false>, pl->a, pl->tp);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// n_steps nonlinear FE or FB steps from `in` into `out` through `tmp`, as fe_steps in
// fe_step.cu: step s writes `out` when n_steps - 1 - s is even, so the last
// lands in `out` and no step writes the buffers it reads.
template <typename T, bool FB>
int nl_steps(const T* rts, const T* fv, int n_fv, const int* live, const int* table,
             const double* weights, const int* vc, const double* vc_w, const int* ev,
             const T* ssh_in, const T* h_in, const T* u_in, T* ssh_out, T* h_out, T* u_out,
             T* ssh_tmp, T* h_tmp, T* u_tmp, double dt, double inv_dc, double s_div,
             double s_ke, double s_curl, int ny2, int nx, int k, int n_steps, int n_terms,
             int rt, int ct, int ks, cudaStream_t stream) {
  const int kc = step_chunk(k);
  const bool vec = vector_loads(k, kc, sizeof(T), h_in, u_in) &&
                   vector_loads(k, kc, sizeof(T), h_out, u_out) &&
                   vector_loads(k, kc, sizeof(T), h_tmp, u_tmp);
  NlPlan<T> pl;
  int err = make_nl_plan<T>(&pl, FB, rts, fv, n_fv, live, table, weights, vc, vc_w, ev, dt,
                            inv_dc, s_div, s_ke, s_curl, ny2, nx, k, n_steps, n_terms, rt, ct,
                            ks, vec);
  if (err != 0) return err;
  const T *ssh = ssh_in, *h = h_in, *u = u_in;
  for (int s = 0; s < n_steps; ++s) {
    const bool to_out = ((n_steps - 1 - s) & 1) == 0;
    T* ssh_d = to_out ? ssh_out : ssh_tmp;
    T* h_d = to_out ? h_out : h_tmp;
    T* u_d = to_out ? u_out : u_tmp;
    err = nl_launch<T, FB>(&pl, ssh, h, u, ssh_d, h_d, u_d, stream);
    if (err != 0) return err;
    ssh = ssh_d, h = h_d, u = u_d;
  }
  return 0;
}

// n_steps nonlinear steps through a stack of states: slot s + 1 = step(slot
// s), the launches nl_steps makes (the same kernel and plan), so a stack
// refilled from a state holds nl_steps' states bit for bit.
template <typename T, bool FB>
int nl_stack(const T* rts, const T* fv, int n_fv, const int* live, const int* table,
             const double* weights, const int* vc, const double* vc_w, const int* ev, T* ssh,
             T* h, T* u, double dt, double inv_dc, double s_div, double s_ke, double s_curl,
             int ny2, int nx, int k, int n_steps, int n_terms, int rt, int ct, int ks,
             cudaStream_t stream) {
  NlPlan<T> pl;
  int err = make_nl_plan<T>(&pl, FB, rts, fv, n_fv, live, table, weights, vc, vc_w, ev, dt,
                            inv_dc, s_div, s_ke, s_curl, ny2, nx, k, n_steps, n_terms, rt, ct,
                            ks, vector_loads(k, step_chunk(k), sizeof(T), h, u));
  if (err != 0) return err;
  const size_t cells = 2ULL * ny2 * nx;
  const size_t hs = cells * k, us = 3 * cells * k;
  for (int s = 0; s < n_steps; ++s) {
    err = nl_launch<T, FB>(&pl, ssh + s * cells, h + s * hs, u + s * us, ssh + (s + 1) * cells,
                           h + (s + 1) * hs, u + (s + 1) * us, stream);
    if (err != 0) return err;
  }
  return 0;
}

// The launch of an f32 nonlinear plan: out[0] the clusters (one per tile),
// out[1] the blocks per SM, out[2] one block's shared memory in bytes.
template <bool FB>
int nl_plan_query(int ny2, int nx, int k, int rt, int ct, int ks, int* out) {
  int max_smem = 0;
  int e = opt_in_smem(&max_smem);
  if (e != 0) return e;
  const int kc = step_chunk(k);
  const size_t smem = nl_smem_bytes(rt, ct, FB ? 3 : 2, 4, FB ? 2 : 1, 2, kc, ks, FB,
                                    sizeof(float));
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  if ((e = nl_prepare<float, FB, false>(max_smem)) != 0) return e;
  out[0] = ((ny2 + rt - 1) / rt) * ((nx + ct - 1) / ct);
  out[2] = static_cast<int>(smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], nl_step_kernel<float, FB, false>, kStepThreads, smem));
}

}  // namespace lattice
