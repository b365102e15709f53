// q > 1 steps per launch of the nonlinear (vector-invariant) TRiSK
// shallow-water core on the parity-plane hex lattice, forward Euler (FE,
// reach 2) or forward-backward (FB, reach 3), for NVIDIA Hopper (sm_90a):
// tiled_step's nonlinear arms at q > 1, instantiated per arm and dtype by
// nl_tiled_{fe,fb}_{f32,f64}.cu.
//
// Replaces: _tiled_step_kernel (mpas_ocean_tpu/structured/pallas_model.py:
// 852) with nl_terms on and q > 1, that is _window_steps (:802-849) over
// _step_slab_nl (sharded.py:597): step j works on the window less j reaches
// per side, (2, 4) for FE and (3, 4) for FB, periodic and wall-masked, with
// momentum forcing, tracers and layered stratification in any combination,
// as nl_step.cuh's q = 1 kernel takes them; the halo rows read from the
// state periodically, or (ro = reach * q > 0) received by the sharded
// superstep's exchange (sharded.py:1640-1886; step_window.cuh, buffer_plane).
//
// Design. Step j of a tile is nl_step.cuh's step on the tile grown by
// q - 1 - j reaches per side: step 0 is the q = 1 kernel on the tile grown
// by q - 1 reaches, and every later step works on a region of the same
// layouts, shrunk by one reach per side each step. So one set of resolved
// taps serves every step, and a block's shared memory is the q = 1 kernel's
// at the grown tile plus one more ssh pair (nl_tiled_smem_bytes).
//
// Where the state lives between the steps. The q = 1 kernel walks its level
// chunk in slices and keeps nothing between steps; here step j + 1 needs
// step j's h, u and tracers at every level of the chunk on its window (the
// column sum of h, and with stratification Phi, couple all levels). Kept in
// shared memory, that state does not fit: at a (4, 8) tile, 16-level chunks
// and f32, the FE q = 2 window is 288 sites x 8 values x 16 levels, 147 KB
// per copy, FB's 197 KB, before the 20 derived planes. Smaller tiles or
// level chunks would leave q = 2 too little work per block, and clusters of
// more than 8 blocks are not portable. So each tile keeps the state between
// its steps in a scratch of its own in device memory ([n_pl][grown tile]
// [K] per tile, n_pl = 8 + 2 nT): step j < q - 1 writes its new h, u and
// tracers there instead of to the output, and step j + 1 reads its window's
// slices back from there by the same async copies. Each block reads back
// only the levels it wrote itself, so no exchange between blocks goes
// through device memory: the column sums and Phi's h still go through
// distributed shared memory, as in the q = 1 kernel. The scratch is one
// state region per tile, rewritten in place: step j + 1 writes a region
// inside the one it read, and each level slice is read whole into shared
// memory before any of its levels is written. FE's old ssh for step j + 1 is
// step j's fresh ssh on the step's tile, which every block sums from the
// ranks' partials into a second ssh pair in shared memory.
//
// Each step runs the q = 1 kernel's stages in its order: stage A, the
// derived planes on the tile plus its ring; stage B, continuity (FB on the
// tile plus one ring) and the momentum with its forcing pass; the ranks'
// column sums after a cluster barrier; for FB and the stratified arms the
// deferred pressure, with Phi; a cluster barrier that ends the step. The
// q = 1 kernel's body is kept as it is (one shared step function cost
// tiled_step's FB arm 11.5% in an earlier design, PERF.md): this kernel
// repeats its stages with the step's region offsets. Tiles divide the
// lattice.

#pragma once

#include "nl_step.cuh"

namespace lattice {

// The q-step kernel's arguments: nl_step's (its tile rt x ct the launch's,
// which the last step writes), the steps per launch and the tiles' scratch
// [n_tiles][8 + 2 nT][grown tile][K].
template <typename T>
struct NlTiledArgs {
  NlArgs<T> a;
  T* scr;
  int q;
};

// The slice [kb, kb + n) of the n_pl planes (h p0, h p1, u c0..c5,
// tracers) at the window rows r0 .. r0 + nr - 1, columns c0 .. c0 + nc - 1,
// into buf [n_pl][W][ks], by async copies (16-byte vectors where vec_log2
// >= 0). The source is the state (site gs[s], planes `plane` sites apart) or
// the tile's scratch (the grown tile's site, row width ct0, from window row
// hm and column hi; planes `plane` = its sites apart). Needs gs[] written
// and a __syncthreads() before.
template <typename T>
__device__ __forceinline__ void load_region_slice(T* buf, const T* h, const T* u, const T* tr,
                                                  int n_pl, const int* gs, bool scratch,
                                                  int plane, int r0, int c0, int nr, int nc,
                                                  int Wi, int W, int hm, int hi, int ct0,
                                                  int ks_log2, int vec_log2, int kb, int n,
                                                  int K) {
  constexpr int per = 16 / sizeof(T);
  const int lg = vec_log2 >= 0 ? vec_log2 : ks_log2;
  const int lim = vec_log2 >= 0 ? n / per : n;
  const FastDiv by_pl(n_pl), by_nc(nc);
  const int cnt = (nr * nc * n_pl) << lg;
  for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
    const int v = e & ((1 << lg) - 1);
    if (v >= lim) continue;
    const int qq = e >> lg;
    const int t = by_pl.div(qq), ch = by_pl.mod(qq, t);
    const int r = by_nc.div(t), c = by_nc.mod(t, r);
    const int s = (r0 + r) * Wi + c0 + c;
    const int g = scratch ? (r0 + r - hm) * ct0 + c0 + c - hi : gs[s];
    const T* src = ch < 2   ? h + (ch * plane + g) * K
                   : ch < 8 ? u + ((ch - 2) * plane + g) * K
                            : tr + ((ch - 8) * plane + g) * K;
    T* dst = buf + (ch * W + s) * (1 << ks_log2);
    if (vec_log2 >= 0)
      copy_async16(dst + v * per, src + kb + v * per);
    else
      copy_async(dst + v, src + kb + v);
  }
}

// One launch: q nonlinear steps of one tile; a cluster of n_ranks blocks per
// tile, blocks of kStepThreads threads, groups of ks lanes on one site's
// slice levels, as nl_step_kernel.
template <typename T, bool FB, bool kMasked, bool kForced, bool kTracers, bool kStrat>
__global__ void __launch_bounds__(kStepThreads, 1)
    nl_tiled_kernel(const NlTiledArgs<T> ta, const NlTaps<T> tp) {
  using namespace hex_vert;
  constexpr bool kDefer = FB || kStrat;
  const NlArgs<T>& a = ta.a;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int tile = blockIdx.x / n_ranks;
  const int tm = tile / a.n_tiles_i, ti = tile % a.n_tiles_i;
  const int q = ta.q;
  // step 0's tile (the launch's grown by q - 1 reaches) and its layouts
  const int rt0 = a.rt + 2 * a.hm * (q - 1), ct0 = a.ct + 2 * a.hi * (q - 1);
  const int Wi = ct0 + 2 * a.hi, W = (rt0 + 2 * a.hm) * Wi;
  const int Di = ct0 + 2 * a.dc, D = (rt0 + 2 * a.dr) * Di;
  const int Fi = ct0 + 2, Fs = (rt0 + 2) * Fi;  // the grown tile plus one ring
  const int core0 = rt0 * ct0;
  const int P = FB ? Fs : core0;  // the sites of the partial column sums
  const int kc = 1 << a.kc_log2, ks = 1 << a.ks_log2;
  const int k0 = rank * kc, kr = min(kc, a.K - k0);
  const int n_slices = (kr + ks - 1) >> a.ks_log2;
  const int plane = buffer_plane(a.ny2, a.nx, a.ro);
  const int K = a.K;
  const int WK = W * ks, DK = D * ks;
  const int n_pl = kTracers ? 8 + 2 * a.tr.n : 8;
  const int SK = n_pl * WK;
  // the tile's scratch: h, u and tracer planes of the grown tile's sites
  T* scr = ta.scr + static_cast<size_t>(tile) * n_pl * core0 * K;

  T* st = reinterpret_cast<T*>(smem_raw);  // [2][n_pl][W][ks]
  T* dsm = st + 2 * SK;                    // [20][D][ks]: F, F q_e, q_e, KE
  T* ssh_s = dsm + hex_vert::kPlanes * DK;  // [2][2][W]: FE's old ssh, by step parity
  T* rts_s = ssh_s + 4 * W;                // [2][W]
  T* fv_s = rts_s + 2 * W;                 // [kFv][W]
  T* part = fv_s + kFv * W;                // [2][P]
  T* sshf = part + 2 * P;                  // deferred: [2][Fs], the pressure's ssh
  T* upart = sshf + (kDefer ? 2 * Fs : 0);  // deferred: [6][core0][kc]
  int* gs = reinterpret_cast<int*>(upart + (kDefer ? 6 * core0 * kc : 0));  // [W]
  int* live_s = gs + W;                                                      // [W]
  const StratSmem<T> ssm(live_s + W, Fs, kc, K);
  const ForcingSmem<T> fsm(kStrat ? ssm.end(Fs, kc, true) : static_cast<void*>(live_s + W),
                           core0, 0);

  allow_next_grid();
  window_sites(gs, tm * a.rt - a.hm * q, ti * a.ct - a.hi * q, Wi, W, a.ny2, a.nx, a.ro);
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
  if (kForced) load_tile_forcing(fsm, gs, a.fc, rt0, ct0, a.hm, a.hi, Wi, plane, rank);
  if (kStrat) load_strat_w(ssm.wsl, a.strat_w, K, k0, kr, a.kc_log2);

  const T dt_div = a.dt * a.s_div;
  const T pg_scale = kStrat ? -a.dt : T(-kGravity) * a.dt;
  const T dt_rayl = a.dt * a.fc.rayl;
  const bool wd = kForced && ((a.fc.lvl_ranks >> rank) & 1u);
  const int lane_mask = ks - 1;
  const int g_width = min(ks, 32);
  const T* tr_in = kTracers ? a.tr.tr : nullptr;

  for (int j = 0; j < q; ++j) {
    const bool last = j == q - 1;
    // the step's tile: the launch's grown by q - 1 - j reaches, at (om, oi)
    // in step 0's tile
    const int om = a.hm * j, oi = a.hi * j;
    const int rj = a.rt + 2 * a.hm * (q - 1 - j), cj = a.ct + 2 * a.hi * (q - 1 - j);
    const int coj = rj * cj;
    // its window, its source (the state at step 0, else the scratch) and
    // its destination (the output at the last step, else the scratch)
    const int wnr = rj + 2 * a.hm, wnc = cj + 2 * a.hi;
    const bool from_scr = j > 0;
    const T* src_h = from_scr ? scr : a.h;
    const T* src_u = from_scr ? scr + 2 * core0 * K : a.u;
    const T* src_t = from_scr ? scr + 8 * core0 * K : tr_in;
    const int src_plane = from_scr ? core0 : plane;
    T* dst_h = last ? a.h_out : scr;
    T* dst_u = last ? a.u_out : scr + 2 * core0 * K;
    T* dst_t = last ? a.tr.tr_out : scr + 8 * core0 * K;
    const int dst_plane = last ? plane : core0;
    // the destination's site of the step's tile site (r, c)
    const auto dst_site = [&](int r, int c) {
      return last ? buffer_site(tm * a.rt + r, ti * a.ct + c, a.nx, a.ro)
                  : (om + r) * ct0 + oi + c;
    };
    const T* ssh_o = ssh_s + (j & 1) * 2 * W;    // FE: the step's old ssh
    T* ssh_n = ssh_s + ((j + 1) & 1) * 2 * W;    // FE: the next step's
    const auto load = [&](T* buf, int kb) {
      load_region_slice(buf, src_h, src_u, src_t, n_pl, gs, from_scr, src_plane, om, oi, wnr,
                        wnc, Wi, W, a.hm, a.hi, ct0, a.ks_log2, a.vec_log2, k0 + kb,
                        min(ks, kr - kb), K);
    };
    if (n_slices > 0) load(st, 0);
    __pipeline_commit();

    const int ndc = cj + 2 * a.dc, nd = (rj + 2 * a.dr) * ndc;
    const FastDiv by_dj(ndc), by_cj(cj), by_fj(cj + 2);
    for (int sl = 0; sl < n_slices; ++sl) {
      const int kb = sl * ks;
      const int kn = min(ks, kr - kb);
      if (sl + 1 < n_slices) {
        load(st + ((sl + 1) & 1) * SK, kb + ks);
        __pipeline_commit();
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      const T* cur = st + (sl & 1) * SK;

      if (kStrat && !FB) {
        // the old h on the step's tile plus one ring, for Phi
        const int fn = (rj + 2) * (cj + 2);
        for (int e = threadIdx.x; e < fn * ks; e += blockDim.x) {
          const int t = e >> a.ks_log2, kl = e & lane_mask;
          if (kl >= kn) continue;
          const int r = by_fj.div(t), c = by_fj.mod(t, r);
          const int f = (om + r) * Fi + oi + c;
          const int sw = (om + a.hm - 1 + r) * Wi + oi + a.hi - 1 + c;
          ssm.fresh[f * kc + kb + kl] = cur[sw * ks + kl];
          ssm.fresh[(Fs + f) * kc + kb + kl] = cur[WK + sw * ks + kl];
        }
      }

      // stage A: the derived planes on the step's tile plus the ring
      for (int e = threadIdx.x; e < nd * ks; e += blockDim.x) {
        const int dl = e >> a.ks_log2, kl = e & lane_mask;
        if (kl >= kn) continue;
        const int r = by_dj.div(dl), c = by_dj.mod(dl, r);
        const int d = (om + r) * Di + oi + c;
        const int sw = (om + r + a.hm - a.dr) * Wi + oi + c + a.hi - a.dc;
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
          for (int jj = 0; jj < 3; ++jj) {
            const T wgt = kMasked ? fv_s[(8 + kite_t(v, jj)) * W + sv] : tp.kw[kite_t(v, jj)];
            const T contrib = wgt * h[kite_h(v, jj)];
            hv = jj == 0 ? contrib : hv + contrib;
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

      // stage B, continuity: h' on the step's tile (FE) or on it plus one
      // ring (FB), the slices' column sums added in order; the tile's h'
      // stored (and its tracers carried), FB's stratified arm keeping its
      // chunk of h'
      const int cn = FB ? (rj + 2) * (cj + 2) : coj;
      for (int e0 = 0; e0 < cn * ks; e0 += blockDim.x) {
        const int e = e0 + threadIdx.x;
        const int t = e >> a.ks_log2, kl = e & lane_mask;
        const bool on = e < cn * ks && kl < kn;
        const int tt = on ? t : 0;
        int r, c;
        if (FB) {
          r = by_fj.div(tt) - 1;
          c = by_fj.mod(tt, r + 1) - 1;
        } else {
          r = by_cj.div(tt);
          c = by_cj.mod(tt, r);
        }
        // the site's partial-sum slot (FB: the grown tile plus a ring;
        // FE: the grown tile)
        const int x = FB ? (1 + om + r) * Fi + 1 + oi + c : (om + r) * ct0 + oi + c;
        T hnew[2] = {T(0), T(0)};
        if (on) {
          const int sw = (a.hm + om + r) * Wi + a.hi + oi + c;
          const int bd = ((a.dr + om + r) * Di + a.dc + oi + c) * ks + kl;
          const T* fl = dsm + bd;
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            T total = fl[tp.b_f[hex::self_u(p)]] + fl[tp.b_f[hex::self_u(2 + p)]];
            total = total + fl[tp.b_f[hex::self_u(4 + p)]];
#pragma unroll
            for (int xx = 3 * p; xx < 3 * p + 3; ++xx) total = total - fl[tp.b_f[hex::inc_u(xx)]];
            hnew[p] = cur[sw * ks + kl + p * WK] - dt_div * total;
          }
          const bool own = r >= 0 && r < rj && c >= 0 && c < cj;
          if (own) {
            T* h_o = dst_h + static_cast<size_t>(dst_site(r, c)) * K + k0 + kb + kl;
            h_o[0] = hnew[0];
            h_o[static_cast<size_t>(dst_plane) * K] = hnew[1];
          }
          if (kStrat && FB) {  // the fresh h' that Phi reads
            ssm.fresh[x * kc + kb + kl] = hnew[0];
            ssm.fresh[(Fs + x) * kc + kb + kl] = hnew[1];
          }
          if (kTracers && own) {
            const T* lv = cur + sw * ks + kl;
            const int g = gs[sw];
            const size_t o = static_cast<size_t>(dst_site(r, c)) * K + k0 + kb + kl;
            T u[hex::kEdgeU], h[hex::kH];
#pragma unroll
            for (int i = 0; i < hex::kEdgeU; ++i) u[i] = lv[tp.us[i]];
#pragma unroll
            for (int i = 0; i < hex::kH; ++i) h[i] = lv[tp.hs[i]];
            T cm[2] = {T(1), T(1)};
            unsigned live = 0u, inc_live = 0u;
            if (kMasked) {
              live = static_cast<unsigned>(live_s[sw]);
              inc_live = incoming_live(live_s, sw, a.tr);
              cm[0] = a.tr.cmask[g], cm[1] = a.tr.cmask[plane + g];
            }
            tracer_step<T, kMasked>(lv, WK, tp, u, h, hnew, cm, live, inc_live, a.tr, dt_div,
                                    a.inv_dc, [&](int i, T v) {
                                      dst_t[static_cast<size_t>(i) * dst_plane * K + o] = v;
                                    });
          }
        }
        const T s0 = group_sum(hnew[0], g_width), s1 = group_sum(hnew[1], g_width);
        if (e < cn * ks && kl == 0) {
          part[x] = sl == 0 ? s0 : part[x] + s0;
          part[P + x] = sl == 0 ? s1 : part[P + x] + s1;
        }
      }

      // stage B, momentum on the step's tile, as nl_step_kernel's
      for (int e = threadIdx.x; e < coj * ks; e += blockDim.x) {
        const int t = e >> a.ks_log2, kl = e & lane_mask;
        if (kl >= kn) continue;
        const int r = by_cj.div(t), c = by_cj.mod(t, r);
        const int sw = (a.hm + om + r) * Wi + a.hi + oi + c;
        const int bd = ((a.dr + om + r) * Di + a.dc + oi + c) * ks + kl;
        const int t0 = (om + r) * ct0 + oi + c;
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
          for (int xx = 0; xx < 8; ++xx) {
            const int t2 = 8 * ch + xx;
            const T c1 = tp.w[t2] * F[hex::tap_u(t2)];
            const T c2 = tp.w[t2] * Fq[hex::tap_u(t2)];
            tf = xx == 0 ? c1 : tf + c1;
            tfq = xx == 0 ? c2 : tfq + c2;
          }
          const T pv = T(0.5) * (fl[(12 + ch) * DK] * tf + tfq);
          const T gke = (fl[tp.b_ke[ch]] - ((ch & 1) ? ke1 : ke0)) * a.inv_dc;
          unew[ch] = cur[sw * ks + kl + (2 + ch) * WK] + a.dt * (pv - gke);
          if (kForced && kDefer) unew[ch] = unew[ch] - dt_rayl * cur[sw * ks + kl + (2 + ch) * WK];
        }
        if (kDefer) {
#pragma unroll
          for (int ch = 0; ch < 6; ++ch) upart[(ch * core0 + t0) * kc + kb + kl] = unew[ch];
        } else {
          const unsigned lb = kMasked ? static_cast<unsigned>(live_s[sw]) : kAllLive;
          T* u_o = dst_u + static_cast<size_t>(dst_site(r, c)) * K + k0 + kb + kl;
#pragma unroll
          for (int ch = 0; ch < 6; ++ch) {
            const T grad = (ssh_o[sw + tp.nb_p[ch]] - ssh_o[(ch & 1) * W + sw]) * a.inv_dc;
            T v = unew[ch] + pg_scale * grad;
            if (kForced) v = v - dt_rayl * cur[sw * ks + kl + (2 + ch) * WK];
            u_o[static_cast<size_t>(ch) * dst_plane * K] =
                (kMasked && !((lb >> ch) & 1u)) ? T(0) : v;
          }
        }
      }
      __syncthreads();

      if (wd) {
        // the wind and drag at the step's tile's edges' top and bottom
        // levels in this slice, of the slice's old state
        for (int e = threadIdx.x; e < 6 * coj; e += blockDim.x) {
          const int ch = e / coj, t = e - ch * coj;
          const int r = by_cj.div(t), c = by_cj.mod(t, r);
          const int sw = (a.hm + om + r) * Wi + a.hi + oi + c;
          const int t0 = (om + r) * ct0 + oi + c;
          if (kMasked && !((live_s[sw] >> ch) & 1u)) continue;
          const int lv = fsm.lvl[ch * core0 + t0];
          int lev[2];
          chunk_levels(lv, k0 + kb, kn, &lev[0], &lev[1]);
          for (int i = 0; i < 2; ++i) {
            const int kl = lev[i];
            if (kl < 0) continue;
            const T* v = cur + sw * ks + kl;
            const T he = T(0.5) * (v[tp.hs[hex::nb_h(ch)]] + v[tp.hs[hex::self_h(ch & 1)]]);
            T& o = kDefer ? upart[(ch * core0 + t0) * kc + kb + kl]
                          : dst_u[(static_cast<size_t>(ch) * dst_plane + dst_site(r, c)) * K +
                                  k0 + kb + kl];
            o = o + a.dt * wind_drag(v[tp.us[hex::self_u(ch)]], he, lv, k0 + kb + kl,
                                     fsm.wind + ch * core0 + t0, a.fc);
          }
        }
        __syncthreads();
      }
    }

    // ssh' = sum_k h' - rts over the ranks' partial sums, in rank order (FB:
    // on the step's tile plus one ring, for the pressure; FE: on the step's
    // tile, the next step's old ssh, by every rank); the last step's tile
    // written by rank 0
    cluster.sync();
    if (FB || !last || rank == 0) {
      const int pn = FB ? (rj + 2) * (cj + 2) : coj;
      for (int e = threadIdx.x; e < 2 * pn; e += blockDim.x) {
        const int p = e >= pn ? 1 : 0, xx = e - p * pn;
        int r, c;  // in the step's tile, from -1 (FB)
        if (FB) {
          r = by_fj.div(xx) - 1;
          c = by_fj.mod(xx, r + 1) - 1;
        } else {
          r = by_cj.div(xx);
          c = by_cj.mod(xx, r);
        }
        const int x = FB ? (1 + om + r) * Fi + 1 + oi + c : (om + r) * ct0 + oi + c;
        T v[kMaxCluster];
#pragma unroll
        for (int rr = 0; rr < kMaxCluster; ++rr)
          if (rr < n_ranks) v[rr] = *cluster.map_shared_rank(part + p * P + x, rr);
        T sum = v[0];
#pragma unroll
        for (int rr = 1; rr < kMaxCluster; ++rr)
          if (rr < n_ranks) sum += v[rr];
        const int sw = (a.hm + om + r) * Wi + a.hi + oi + c;
        const T ssh = sum - rts_s[p * W + sw];
        if (FB)
          sshf[p * Fs + x] = ssh;
        else if (!last)
          ssh_n[p * W + sw] = ssh;
        if (last && rank == 0 && r >= 0 && r < rj && c >= 0 && c < cj)
          a.ssh_out[p * plane + buffer_site(tm * a.rt + r, ti * a.ct + c, a.nx, a.ro)] = ssh;
      }
    }
    if (kStrat && !FB) {
      // FE's Phi takes the step's old ssh, on its tile plus one ring
      const int fn = (rj + 2) * (cj + 2);
      for (int e = threadIdx.x; e < 2 * fn; e += blockDim.x) {
        const int p = e >= fn ? 1 : 0, xx = e - p * fn;
        const int r = by_fj.div(xx), c = by_fj.mod(xx, r);
        sshf[p * Fs + (om + r) * Fi + oi + c] =
            ssh_o[p * W + (om + a.hm - 1 + r) * Wi + oi + a.hi - 1 + c];
      }
    }
    if (kDefer) {
      __syncthreads();
      // Phi at this block's levels on the step's tile grown by the
      // gradient's reach, from every rank's chunk of h
      if (kStrat)
        montgomery(ssm, cluster, ssm.fresh, sshf, 1 + om + a.nr.m0, 1 + om + rj + a.nr.m1,
                   1 + oi + a.nr.i0, 1 + oi + cj + a.nr.i1, Fi, Fs, a.kc_log2, kr, K, rank,
                   n_ranks);
      // the pressure on this rank's chunk of the step's tile
      for (int e = threadIdx.x; e < coj * kc; e += blockDim.x) {
        const int t = e >> a.kc_log2, kl = e & (kc - 1);
        if (kl >= kr) continue;
        const int r = by_cj.div(t), c = by_cj.mod(t, r);
        const int t0 = (om + r) * ct0 + oi + c;
        const int sf = (1 + om + r) * Fi + 1 + oi + c;
        const unsigned lb = kMasked
                                ? static_cast<unsigned>(live_s[(a.hm + om + r) * Wi + a.hi + oi + c])
                                : kAllLive;
        T* u_o = dst_u + static_cast<size_t>(dst_site(r, c)) * K + k0 + kl;
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) {
          T grad;
          if (kStrat) {
            const T* ph = ssm.phi + (sf << a.kc_log2) + kl;
            grad = (ph[tp.nb_p[ch] << a.kc_log2] - ph[(ch & 1) * (Fs << a.kc_log2)]) * a.inv_dc;
          } else {
            grad = (sshf[sf + tp.nb_p[ch]] - sshf[(ch & 1) * Fs + sf]) * a.inv_dc;
          }
          const T v = upart[(ch * core0 + t0) * kc + kl] + pg_scale * grad;
          u_o[static_cast<size_t>(ch) * dst_plane * K] =
              (kMasked && !((lb >> ch) & 1u)) ? T(0) : v;
        }
      }
    }
    // the step's end: no block reads the next step's scratch, or writes its
    // partial sums and h chunk, before every block is done with this step's
    cluster.sync();
  }
}

// Dynamic shared memory of one block of the q-step kernel
// (kernels/fe_step.nl_smem_bytes mirrors this with q): nl_step_kernel's at
// the tile grown by q - 1 reaches, and a second ssh pair over its window.
inline size_t nl_tiled_smem_bytes(int rt, int ct, int q, int hm, int hi, int dr, int dc, int kc,
                                  int ks, bool fb, size_t itemsize, bool forced, int n_tr,
                                  int strat_k) {
  const int rt0 = rt + 2 * hm * (q - 1), ct0 = ct + 2 * hi * (q - 1);
  const size_t W = static_cast<size_t>(rt0 + 2 * hm) * (ct0 + 2 * hi);
  return nl_smem_bytes(rt0, ct0, hm, hi, dr, dc, kc, ks, fb, itemsize, forced, n_tr, strat_k) +
         2 * W * itemsize;
}

template <typename T, bool FB, bool kMasked, bool kForced, bool kTracers, bool kStrat>
int nl_tiled_arm(const NlTiledArgs<T>& ta, const NlTaps<T>& tp, int n_ranks, int n_tiles,
                 size_t smem, int max_smem, cudaStream_t stream) {
  static bool done = false;
  if (!done) {
    const cudaError_t e =
        cudaFuncSetAttribute(nl_tiled_kernel<T, FB, kMasked, kForced, kTracers, kStrat>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    done = true;
  }
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = step_config(n_ranks, n_tiles, smem, stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, nl_tiled_kernel<T, FB, kMasked, kForced, kTracers, kStrat>, ta, tp);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool FB, bool kMasked>
int nl_tiled_masked(const NlTiledArgs<T>& ta, const NlTaps<T>& tp, int n_ranks, int n_tiles,
                    size_t smem, int max_smem, cudaStream_t stream) {
  using Launch = int (*)(const NlTiledArgs<T>&, const NlTaps<T>&, int, int, size_t, int,
                         cudaStream_t);
  static const Launch arms[8] = {
      nl_tiled_arm<T, FB, kMasked, false, false, false>,
      nl_tiled_arm<T, FB, kMasked, false, false, true>,
      nl_tiled_arm<T, FB, kMasked, false, true, false>,
      nl_tiled_arm<T, FB, kMasked, false, true, true>,
      nl_tiled_arm<T, FB, kMasked, true, false, false>,
      nl_tiled_arm<T, FB, kMasked, true, false, true>,
      nl_tiled_arm<T, FB, kMasked, true, true, false>,
      nl_tiled_arm<T, FB, kMasked, true, true, true>};
  const NlArgs<T>& a = ta.a;
  return arms[(a.fc.wind != nullptr ? 4 : 0) + (a.tr.tr != nullptr ? 2 : 0) +
              (a.strat_w != nullptr ? 1 : 0)](ta, tp, n_ranks, n_tiles, smem, max_smem, stream);
}

// n_steps nonlinear steps, q per launch over rt x ct tiles that divide the
// lattice, from `in` into `out` through `tmp` (launch l writes `out` when
// n_steps / q - 1 - l is even), the tiles' state between steps in
// `scratch` (n_tiles x (8 + 2 n_tr) x the grown tile's sites x k values).
template <typename T, bool FB>
int nl_tiled_steps(const T* rts, const T* fv, int n_fv, const int* live,
                   const ForcingArgs<T>& fc, const TracerArgs<T>& tr, T* tr_tmp,
                   const T* strat_w, T* scratch, const int* table, const double* weights,
                   const int* vc, const double* vc_w, const int* ev, const T* ssh_in,
                   const T* h_in, const T* u_in, T* ssh_out, T* h_out, T* u_out, T* ssh_tmp,
                   T* h_tmp, T* u_tmp, double dt, double inv_dc, double s_div, double s_ke,
                   double s_curl, int ny2, int nx, int k, int n_steps, int n_terms, int rt,
                   int ct, int ks, int q, int ro, cudaStream_t stream) {
  const int hm = FB ? 3 : 2, hi = 4;
  if (q < 2 || n_steps % q || rt < 1 || ct < 1 || ny2 % rt || nx % ct || scratch == nullptr)
    return cudaErrorInvalidValue;
  // received halos: the windows' q reaches of rows, and no more
  if (ro != 0 && ro != hm * q) return cudaErrorInvalidValue;
  const int rt0 = rt + 2 * hm * (q - 1), ct0 = ct + 2 * hi * (q - 1);
  const int kc = step_chunk(k);
  const bool vec = vector_loads(k, kc, sizeof(T), h_in, u_in) &&
                   vector_loads(k, kc, sizeof(T), h_out, u_out) &&
                   vector_loads(k, kc, sizeof(T), h_tmp, u_tmp) &&
                   vector_loads(k, kc, sizeof(T), scratch, scratch) &&
                   (tr.tr == nullptr || (vector_loads(k, kc, sizeof(T), tr.tr, tr.tr_out) &&
                                         vector_loads(k, kc, sizeof(T), tr_tmp, tr_tmp)));
  // the plan of the grown tile: its taps, layouts and checks are step 0's
  NlPlan<T> pl;
  int err = make_nl_plan<T>(&pl, FB, rts, fv, n_fv, live, fc, tr, strat_w, table, weights, vc,
                            vc_w, ev, dt, inv_dc, s_div, s_ke, s_curl, ny2, nx, k, n_steps,
                            n_terms, rt0, ct0, ks, vec, ro);
  if (err != 0) return err;
  const size_t smem = nl_tiled_smem_bytes(rt, ct, q, hm, hi, FB ? 2 : 1, 2, kc, ks, FB, sizeof(T),
                                          fc.wind != nullptr, tr.tr != nullptr ? tr.n : 0,
                                          strat_w != nullptr ? k : 0);
  if (smem > static_cast<size_t>(pl.max_smem)) return cudaErrorInvalidValue;
  NlTiledArgs<T> ta{pl.a, scratch, q};
  ta.a.rt = rt, ta.a.ct = ct, ta.a.n_tiles_i = nx / ct;
  const int n_tiles = (ny2 / rt) * (nx / ct);
  const int n_launches = n_steps / q;
  const T *ssh = ssh_in, *h = h_in, *u = u_in, *t = tr.tr;
  for (int l = 0; l < n_launches; ++l) {
    const bool to_out = ((n_launches - 1 - l) & 1) == 0;
    ta.a.ssh = ssh, ta.a.h = h, ta.a.u = u;
    ta.a.ssh_out = to_out ? ssh_out : ssh_tmp;
    ta.a.h_out = to_out ? h_out : h_tmp;
    ta.a.u_out = to_out ? u_out : u_tmp;
    if (tr.tr != nullptr) ta.a.tr.tr = t, ta.a.tr.tr_out = to_out ? tr.tr_out : tr_tmp;
    err = live != nullptr
              ? nl_tiled_masked<T, FB, true>(ta, pl.tp, pl.n_ranks, n_tiles, smem, pl.max_smem,
                                             stream)
              : nl_tiled_masked<T, FB, false>(ta, pl.tp, pl.n_ranks, n_tiles, smem,
                                              pl.max_smem, stream);
    if (err != 0) return err;
    ssh = ta.a.ssh_out, h = ta.a.h_out, u = ta.a.u_out, t = ta.a.tr.tr_out;
  }
  return 0;
}

}  // namespace lattice

// The C entry of one arm (FB false: FE at reach 2, true: FB at reach 3) in
// one dtype: nl_step.cuh's steps entry with q > 1 steps per launch and the
// tiles' `scratch` (kernels/tiled_step.nl_scratch_shape); each
// nl_tiled_*.cu translation unit expands one, so that the instantiations
// compile in parallel. Returns 0, kNotHexTable for a table that is not the
// hex lattice's, or the CUDA error (cudaErrorInvalidValue for a plan the
// lattice or the card does not take).
#define MOT_NL_TILED_ENTRY(T, SUFFIX, ARM, FB)                                                \
  extern "C" int mot_nl_tiled_##ARM##_##SUFFIX(                                               \
      const T* rts, const T* fv, int n_fv, const int* live, const T* wind, const int* lvl,    \
      const int* table, const double* weights, const int* vc, const double* vc_w,             \
      const int* ev, const T* ssh_in, const T* h_in, const T* u_in, T* ssh_out, T* h_out,     \
      T* u_out, T* ssh_tmp, T* h_tmp, T* u_tmp, const T* tr_in, T* tr_out, T* tr_tmp,         \
      const T* cmask, const T* strat_w, T* scratch, double dt, double inv_dc, double s_div,   \
      double s_ke, double s_curl, double kappa, double upwind, double dlin, double dquad,     \
      double rayl, int lvl_ranks, int wind_ranks, int ny2, int nx, int k, int n_steps,        \
      int n_terms, int ro, int rt, int ct, int ks, int n_tr, int q, void* stream) {           \
    const lattice::ForcingArgs<T> fc{wind, lvl, T(dlin), T(dquad), T(rayl),                   \
                                     static_cast<unsigned>(lvl_ranks),                        \
                                     static_cast<unsigned>(wind_ranks)};                      \
    const lattice::TracerArgs<T> tr{tr_in, tr_out, cmask, T(kappa), T(0.5 * upwind), n_tr,   \
                                    {}, {}};                                                  \
    return lattice::nl_tiled_steps<T, FB>(                                                    \
        rts, fv, n_fv, live, fc, tr, tr_tmp, strat_w, scratch, table, weights, vc, vc_w, ev,  \
        ssh_in, h_in, u_in, ssh_out, h_out, u_out, ssh_tmp, h_tmp, u_tmp, dt, inv_dc, s_div,  \
        s_ke, s_curl, ny2, nx, k, n_steps, n_terms, rt, ct, ks, q, ro,                        \
        static_cast<cudaStream_t>(stream));                                                   \
  }
