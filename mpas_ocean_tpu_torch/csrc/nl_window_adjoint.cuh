// Reverse (adjoint) of one q-step superstep (q > 1) of the nonlinear
// (vector-invariant) forward-Euler TRiSK shallow-water core on the
// parity-plane hex lattice, per row x column tile, for NVIDIA Hopper
// (sm_90a): one kernel, periodic and wall-masked, forced, with tracers and
// stratified in any combination, f32 and f64, instantiated per dtype and
// forcing in nl_window_adjoint_{f32,f64}{,_forced}.cu (8 arms each) and
// launched from nl_window_adjoint.cu.
//
// Replaces: the nonlinear arm of _tiled_adjoint_kernel
// (mpas_ocean_tpu/structured/pallas_model.py:1979) at q > 1, that is the VJP
// of _window_steps (:802) with nl_terms on and fb=False over q steps
// (:2040-2124; halo reach * q, reach 2 rows), with the forced operands and
// their cotangents d(wind), d(r_lin, Cd, lambda), the tracer cotangent and W
// with d(W). At q = 1 the nonlinear reverse kernel (nl_adjoint.cuh) serves
// that arm; this kernel is its q-step form. Its plain version is
// structured/tiled_diff.plain_tiled_adjoint_superstep(nonlinear=True).
//
// Gather form, as tiled_adjoint.cu: a tile computes the cotangent of its own
// core only, from the superstep's start primal and end cotangent read with
// halos, so there is no overlap-add and no atomics. One reverse step of the
// nonlinear core on a region needs the cotangent after the step and the
// primal state before it on the region grown by the window's reach (4, 6)
// (structured/slab.nl_adjoint_rings), and one forward step on a region needs
// the state before it on the region grown by (2, 4) (slab.stencil_reach with
// the vertex terms). So, with R_j the core grown by j (4, 6) per side:
//   1. the recompute: x_{j+1} = step(x_j) on P_{j+1}, j = 0 .. q - 2, where
//      P_j is the core grown by q (4, 6) + (q - 1 - j) (2, 4); x_0 is read
//      from the superstep's start on P_0's window;
//   2. the reverse: g_j on R_j from g_{j+1} on R_{j+1} and x_j on R_{j+1},
//      j = q - 1 .. 0; g_q is read from the superstep's end, and g_0 on the
//      core is the launch's output.
// The tracer arm's h' and T' of state j + 1 (a = c gT' / h', the h' feedback)
// come from x_{j + 1}, the recompute's, or at j = q - 1 from the state after
// the superstep (`end`), as nl_adjoint.cuh reads them.
//
// Where the states live. A region grows by (4, 6) per side and step, so the
// states do not fit shared memory at any useful tile (the q = 2 window of an
// (8, 8) core is 28 x 40 sites). Each tile keeps the recomputed states
// x_1 .. x_{q-1} and the cotangents g_{q-1} .. g_1 (two in turn) in a scratch
// of its own in device memory, and walks every region in sub-tiles of the
// core's size, each the q = 1 kernels' work: nl_step.cuh's FE step
// (stages A and B, the column sums, Phi and the deferred pressure with
// stratification, the forcing pass) for the recompute, and nl_adjoint.cuh's
// stages A-D (the forcing passes, the stratified pass, ds) for the reverse.
// A region's last sub-tile of a row or column is moved back inside it and
// overlaps the one before; a site is written, and its shares counted, by the
// sub-tile that owns it (the one whose place it is in the region's grid).
// Shared memory is thus that of the q = 1 kernels at the tile, whatever q.
// The stages are repeated here with the sub-tile's sources and destinations,
// and the q = 1 kernels keep their bodies as they are, as nl_tiled.cuh
// repeats nl_step.cuh's (its header gives the measured reason).
// Each block reads back only the levels it wrote itself; what couples the
// levels goes through distributed shared memory as in the q = 1 kernels (the
// column sums, Phi's h chunk, the level sums of Sg, S), and each block keeps
// its own copy of the ssh and ds planes it sums from the ranks' partials.
//
// What a tile adds to the shares. The cotangent on R_j overlaps the
// neighbouring tiles' regions, and the d(dt) terms, d(wind), d(r_lin, Cd,
// lambda) and d(W) of a step are sums over sites: a tile adds those of its
// core's sites only, at every step (d(wind) summed over the q steps, in
// place, by the block that owns the edge's top level; d(W) through
// strat_adjoint_pass with the primal h read as 0 off the core). Every sum
// runs in a fixed order, so f64 reruns are bitwise equal.
//
// The cost: at q = 2 on (8, 8) tiles the recompute walks 12 sub-tiles and the
// reverse 6 + 1, where two q = 1 launches walk 2; it is expected to lose to
// q = 1 on this card, as the linear q > 1 reverse does (PERF.md).

#pragma once

#include "nl_adjoint.cuh"

namespace lattice {

// The forward step's reach (FE) and ring of derived planes (nl_step.cuh).
constexpr int kFwdM = 2, kFwdI = 4, kFwdDr = 1, kFwdDc = 2;

// The launch's operands: the recompute's (nl_step.cuh's, ssh/h/u and the
// tracers those of the superstep start) and the reverse's (nl_adjoint.cuh's),
// the tiles' scratch and its layout. The scratch of a tile is q - 1 primal
// slots (x_1 .. x_{q-1}) over the region P_1 (pr x pc sites), then
// min(q - 1, 2) cotangent slots over R_{q-1} (cr x cc sites); a slot holds
// every rank's copy of the ssh planes [n_ranks][2][sites] (padded to
// ssh_pad, or cssh_pad, values), then h [2], u [6] and the tracers [2 nT],
// each [sites][K].
template <typename T>
struct NlWinArgs {
  NlArgs<T> f;
  NlAdjArgs<T> r;
  T* scr;
  long long scr_tile, p_slot, c_slot;
  int q, pr, pc, cr, cc, ssh_pad, cssh_pad;
};

// The halo of P_1 (rows, columns per side) and of R_{q-1}.
__host__ __device__ inline int win_p_halo_m(int q) { return kWinM * q + kFwdM * (q - 2); }
__host__ __device__ inline int win_p_halo_i(int q) { return kWinI * q + kFwdI * (q - 2); }

// A window's sites, rows of Wi from (m_base, i_base) relative to the tile's
// first lattice site (tm0, ti0): in the lattice (gs, periodic), in the primal
// scratch (ps: rows of pc sites from (-hpm, -hpi)) and in the cotangent
// scratch (cs: rows of cc from (-hcm, -hci)). ps and cs mean nothing where the
// window leaves their regions, which the phases never read there.
__device__ __forceinline__ void window_tables(int* gs, int* ps, int* cs, int m_base,
                                              int i_base, int Wi, int W, int tm0, int ti0,
                                              int ny2, int nx, int hpm, int hpi, int pc,
                                              int hcm, int hci, int cc) {
  const FastDiv by_wi(Wi);
  for (int s = threadIdx.x; s < W; s += blockDim.x) {
    const int r = by_wi.div(s), c = by_wi.mod(s, r);
    const int m = m_base + r, i = i_base + c;
    gs[s] = wrap(tm0 + m, ny2) * nx + wrap(ti0 + i, nx);
    ps[s] = (m + hpm) * pc + i + hpi;
    cs[s] = (m + hcm) * cc + i + hci;
  }
}

// fold_tracers (adjoint_window.cuh) with h' and T' read from a source of its
// own: `ns` its sites and n_plane its plane (the lattice, or a primal
// scratch slot); the cell mask from the lattice (gs, plane).
template <typename T>
__device__ __forceinline__ void fold_tracers_from(T* cot, const int* gs, const int* ns,
                                                  const T* h_next, const T* tr_next,
                                                  int n_plane, const AdjTracers<T>& at, int W,
                                                  int kc, int kc_log2, int k0, int kr, int K,
                                                  int plane) {
  const int pk = W * kc;
  const int n = (2 * W) << kc_log2;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int kl = e & ((1 << kc_log2) - 1);
    const int q = e >> kc_log2;
    if (kl >= kr) continue;
    const int p = q >= W ? 1 : 0, s = q - p * W;
    const size_t gn = static_cast<size_t>(p) * n_plane + ns[s];
    const T hn = h_next[gn * K + k0 + kl];
    const bool live = at.cmask == nullptr || at.cmask[p * plane + gs[s]] > T(0);
    T corr = T(0);
    for (int t = 0; t < at.n; ++t) {
      T* ap = cot + (8 + 2 * t + p) * pk + s * kc + kl;
      const T a = live ? *ap / hn : T(0);
      *ap = a;
      corr += a * tr_next[(static_cast<size_t>(2 * t) * n_plane + gn) * K + k0 + kl];
    }
    cot[(p * W + s) * kc + kl] -= corr;
  }
}

// One launch: the reverse of one q-step superstep of one tile; a cluster of
// n_ranks blocks per tile, blocks of kStepThreads threads, groups of ks lanes
// on one site's slice levels, as the q = 1 kernels.
template <typename T, bool kMasked, bool kForced, bool kTracers, bool kStrat>
__global__ void __launch_bounds__(kStepThreads, 1)
    nl_window_adjoint_kernel(const NlWinArgs<T> w, const NlTaps<T> ftp, const NlAdjTaps<T> tp) {
  using namespace hex_vert;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int tile = blockIdx.x / n_ranks;
  const NlArgs<T>& fa = w.f;
  const NlAdjArgs<T>& a = w.r;
  const int rt = a.rt, ct = a.ct, q = w.q;
  const int tm = tile / a.n_tiles_i, ti = tile % a.n_tiles_i;
  const int tm0 = tm * rt, ti0 = ti * ct;
  const int core = rt * ct;
  const int kc = 1 << a.kc_log2, ks = 1 << a.ks_log2;
  const int k0 = rank * kc, kr = min(kc, a.K - k0);
  const int n_slices = (kr + ks - 1) >> a.ks_log2;
  const int plane = a.ny2 * a.nx;
  const int K = a.K;
  const int n_pl = kTracers ? 8 + 2 * a.at.n : 8;
  const int PS = w.pr * w.pc, CS = w.cr * w.cc;
  const int hpm = win_p_halo_m(q), hpi = win_p_halo_i(q);
  const int hcm = kWinM * (q - 1), hci = kWinI * (q - 1);
  T* const scr = w.scr + static_cast<size_t>(tile) * w.scr_tile;
  // x_j (1 <= j < q) and g_j (1 <= j < q, two slots in turn)
  const auto pslot = [&](int j) { return scr + static_cast<size_t>(j - 1) * w.p_slot; };
  const auto cslot = [&](int j) {
    return scr + static_cast<size_t>(q - 1) * w.p_slot +
           static_cast<size_t>((j - 1) & 1) * w.c_slot;
  };

  // the reverse's layouts (nl_adjoint.cuh) at the tile
  const int Wi = ct + 2 * kWinI, W = (rt + 2 * kWinM) * Wi;
  const int Ai = ct + 2 * kRingAi, A = (rt + 2 * kRingAm) * Ai;
  const int Bi = ct + 2 * kRingBi, B = (rt + 2 * kRingBm) * Bi;
  const int Ci = ct + 2 * kRingCi, C = (rt + 2 * kRingCm) * Ci;
  const int WK = W * ks, AK = A * ks, BK = B * ks, CK = C * ks;
  // the recompute's (nl_step.cuh, FE) at the tile
  const int fWi = ct + 2 * kFwdI, fW = (rt + 2 * kFwdM) * fWi;
  const int Di = ct + 2 * kFwdDc, D = (rt + 2 * kFwdDr) * Di;
  const int Fi = ct + 2, Fs = (rt + 2) * Fi;  // the tile plus one ring
  const int fWK = fW * ks, DK = D * ks;

  double* red = reinterpret_cast<double*>(smem_raw);  // [kRedDoubles]
  int* gsite = reinterpret_cast<int*>(red + kRedDoubles);  // [W]: lattice sites
  int* psite = gsite + W;                                  // [W]: primal scratch sites
  int* csite = psite + W;                                  // [W]: cotangent scratch sites
  int* live_s = csite + W;                                 // [W]
  T* const base = reinterpret_cast<T*>(live_s + W);  // the two phases' layouts, in turn
  // the reverse's
  T* st = base;                        // [n_pl][W][ks]: h, u, T
  T* cot = st + n_pl * WK;             // [n_pl][W][ks]: G, gu, a
  T* pa = cot + n_pl * WK;             // [12][A][ks]: F, q_e
  T* pb = pa + kAPlanes * AK;          // [14][B][ks]: dq_e, dF, Sg
  T* pcv = pb + kBPlanes * BK;         // [8][C][ks]: dzeta s_curl, dh_v
  T* ssh_s = pcv + kCPlanes * CK;      // [2][W]
  T* gs_s = ssh_s + 2 * W;             // [2][W]
  T* fv_s = gs_s + 2 * W;              // [kFv][W]
  T* part = fv_s + kFv * W;            // [2][core]: sum over levels of Sg
  const StratAdjSmem<T> ssm(part + 2 * core, core, kc);
  // the recompute's
  T* fst = base;                       // [n_pl][fW][ks]: h, u, T
  T* dsm = fst + n_pl * fWK;           // [20][D][ks]: F, F q_e, q_e, KE
  T* fssh = dsm + kPlanes * DK;        // [2][fW]: the old ssh
  T* rts_s = fssh + 2 * fW;            // [2][fW]
  T* ffv = rts_s + 2 * fW;             // [kFv][fW]
  T* fpart = ffv + kFv * fW;           // [2][core]
  T* sshf = fpart + 2 * core;          // stratified: [2][Fs], Phi's ssh
  T* upart = sshf + (kStrat ? 2 * Fs : 0);  // stratified: [6][core][kc]
  void* fend = upart + (kStrat ? 6 * core * kc : 0);
  const StratSmem<T> fss(fend, Fs, kc, K);
  const ForcingSmem<T> fsm(kStrat ? fss.end(Fs, kc, true) : fend, core, 0);

  allow_next_grid();
  wait_previous_grid();

  const T dt_div = a.dt * a.s_div;
  const int lane_mask = ks - 1;
  const int g_width = min(ks, 32);
  const FastDiv by_ct(ct);
  // the forced arm: whether this rank's chunk holds some edge's top or
  // bottom level (its passes run), dt lambda, and the shares' sums in double
  const bool wd = kForced && ((a.fc.lvl_ranks >> rank) & 1u);
  const T dt_rayl = a.dt * a.fc.rayl;
  double share = 0.0, s_rayl = 0.0, s_lin = 0.0, s_quad = 0.0;
  if (kStrat) load_strat_w(fss.wsl, fa.strat_w, K, k0, kr, a.kc_log2);

  // ---- the recompute: x_{j+1} = step(x_j) on P_{j+1}, j = 0 .. q - 2
  const T pg_scale = kStrat ? -a.dt : T(-kGravity) * a.dt;
  const FastDiv by_di(Di), by_fi(Fi);
  for (int j = 0; j + 1 < q; ++j) {
    const int om = kWinM * q + kFwdM * (q - 2 - j), oi = kWinI * q + kFwdI * (q - 2 - j);
    const int nr = rt + 2 * om, nc = ct + 2 * oi;
    const int nbc = (nc + ct - 1) / ct, nb = ((nr + rt - 1) / rt) * nbc;
    const bool from_g = j == 0;
    const T* sb = from_g ? nullptr : pslot(j);
    const T* src_h = from_g ? fa.h : sb + w.ssh_pad;
    const T* src_u = from_g ? fa.u : src_h + 2LL * PS * K;
    const T* src_t = from_g ? fa.tr.tr : src_h + 8LL * PS * K;
    const T* src_ssh = from_g ? fa.ssh : sb + 2LL * rank * PS;
    const int src_plane = from_g ? plane : PS;
    const int* src_site = from_g ? gsite : psite;
    T* const db = pslot(j + 1);
    T* const dst_h = db + w.ssh_pad;
    T* const dst_u = dst_h + 2LL * PS * K;
    T* const dst_t = dst_h + 8LL * PS * K;
    T* const dst_ssh = db + 2LL * rank * PS;
    for (int b = 0; b < nb; ++b) {
      const int bi = b / nbc, bj = b - bi * nbc;
      const int r0 = min(bi * rt, nr - rt), c0 = min(bj * ct, nc - ct);
      const int own_r = bi * rt - r0, own_c = bj * ct - c0;
      window_tables(gsite, psite, csite, r0 - om - kFwdM, c0 - oi - kFwdI, fWi, fW, tm0, ti0,
                    a.ny2, a.nx, hpm, hpi, w.pc, hcm, hci, w.cc);
      __syncthreads();
      for (int s = threadIdx.x; s < fW; s += blockDim.x) {
        const int g = gsite[s];
        for (int p = 0; p < 2; ++p) {
          copy_async(rts_s + p * fW + s, fa.rts + p * plane + g);
          copy_async(fssh + p * fW + s, src_ssh + p * src_plane + src_site[s]);
        }
        for (int x = 0; x < fa.n_fv; ++x) copy_async(ffv + x * fW + s, fa.fv + x * plane + g);
      }
      if (kMasked) load_live(live_s, gsite, fa.live, fW);
      if (kForced) load_tile_forcing(fsm, gsite, fa.fc, rt, ct, kFwdM, kFwdI, fWi, plane, rank);
      __pipeline_commit();

      for (int sl = 0; sl < n_slices; ++sl) {
        const int kb = sl * ks;           // the slice's first level in the chunk
        const int kn = min(ks, kr - kb);  // its real levels
        load_slice(fst, src_site, src_h, src_u, fW, a.ks_log2, a.vec_log2, k0 + kb, kn, K,
                   src_plane);
        if (kTracers)
          load_tracers(fst + 8 * fWK, src_site, src_t, 2 * a.at.n, fW, a.ks_log2, a.vec_log2,
                       k0 + kb, kn, K, src_plane);
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();
        const T* cur = fst;

        if (kStrat) {
          // the old h chunk on the sub-tile plus one ring, for Phi
          for (int e = threadIdx.x; e < Fs * ks; e += blockDim.x) {
            const int t = e >> a.ks_log2, kl = e & lane_mask;
            if (kl >= kn) continue;
            const int r = by_fi.div(t), c = by_fi.mod(t, r);
            const int sw = (kFwdM - 1 + r) * fWi + kFwdI - 1 + c;
            fss.fresh[t * kc + kb + kl] = cur[sw * ks + kl];
            fss.fresh[(Fs + t) * kc + kb + kl] = cur[fWK + sw * ks + kl];
          }
        }

        // stage A: the derived planes on the sub-tile plus the ring
        for (int e = threadIdx.x; e < D * ks; e += blockDim.x) {
          const int d = e >> a.ks_log2, kl = e & lane_mask;
          if (kl >= kn) continue;
          const int r = by_di.div(d), c = by_di.mod(d, r);
          const int sw = (r + kFwdM - kFwdDr) * fWi + c + kFwdI - kFwdDc;
          const T* lv = cur + sw * ks + kl;
          T u[kU], h[kH];
#pragma unroll
          for (int i = 0; i < kU; ++i) u[i] = lv[ftp.a_u[i]];
#pragma unroll
          for (int i = 0; i < kH; ++i) h[i] = lv[ftp.a_h[i]];
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
            const int sv = sw + ftp.a_v[v];
            const T zeta = (cls < 2 ? (u[curl_u(v, 0)] - u[curl_u(v, 1)]) - u[curl_u(v, 2)]
                                    : (u[curl_u(v, 0)] + u[curl_u(v, 1)]) - u[curl_u(v, 2)]) *
                           a.s_curl;
            T hv = T(0);
#pragma unroll
            for (int jj = 0; jj < 3; ++jj) {
              const T wgt = kMasked ? ffv[(8 + kite_t(v, jj)) * fW + sv] : ftp.kw[kite_t(v, jj)];
              const T contrib = wgt * h[kite_h(v, jj)];
              hv = jj == 0 ? contrib : hv + contrib;
            }
            const T num = ffv[cls * fW + sv] + zeta;
            if (kMasked) {
              const T vm = ffv[(4 + cls) * fW + sv];
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

        // stage B, continuity on the sub-tile: the owned sites' h' stored
        // (and their tracers carried), each slice's column sums added in order
        for (int e0 = 0; e0 < core * ks; e0 += blockDim.x) {
          const int e = e0 + threadIdx.x;
          const int t = e >> a.ks_log2, kl = e & lane_mask;
          const bool on = e < core * ks && kl < kn;
          const int tt = on ? t : 0;
          const int r = by_ct.div(tt), c = by_ct.mod(tt, r);
          T hnew[2] = {T(0), T(0)};
          if (on) {
            const int sw = (kFwdM + r) * fWi + kFwdI + c;
            const T* fl = dsm + ((kFwdDr + r) * Di + kFwdDc + c) * ks + kl;
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              T total = fl[ftp.b_f[hex::self_u(p)]] + fl[ftp.b_f[hex::self_u(2 + p)]];
              total = total + fl[ftp.b_f[hex::self_u(4 + p)]];
#pragma unroll
              for (int x = 3 * p; x < 3 * p + 3; ++x) total = total - fl[ftp.b_f[hex::inc_u(x)]];
              hnew[p] = cur[sw * ks + kl + p * fWK] - dt_div * total;
            }
            if (r >= own_r && c >= own_c) {
              const size_t o = static_cast<size_t>(psite[sw]) * K + k0 + kb + kl;
              dst_h[o] = hnew[0];
              dst_h[static_cast<size_t>(PS) * K + o] = hnew[1];
              if (kTracers) {
                const T* lv = cur + sw * ks + kl;
                const int g = gsite[sw];
                T u[hex::kEdgeU], h[hex::kH];
#pragma unroll
                for (int i = 0; i < hex::kEdgeU; ++i) u[i] = lv[ftp.us[i]];
#pragma unroll
                for (int i = 0; i < hex::kH; ++i) h[i] = lv[ftp.hs[i]];
                T cm[2] = {T(1), T(1)};
                unsigned live = 0u, inc_live = 0u;
                if (kMasked) {
                  live = static_cast<unsigned>(live_s[sw]);
                  inc_live = incoming_live(live_s, sw, fa.tr);
                  cm[0] = fa.tr.cmask[g], cm[1] = fa.tr.cmask[plane + g];
                }
                tracer_step<T, kMasked>(lv, fWK, ftp, u, h, hnew, cm, live, inc_live, fa.tr,
                                        dt_div, a.inv_dc, [&](int i, T v) {
                                          dst_t[static_cast<size_t>(i) * PS * K + o] = v;
                                        });
              }
            }
          }
          const T s0 = group_sum(hnew[0], g_width), s1 = group_sum(hnew[1], g_width);
          if (e < core * ks && kl == 0) {
            fpart[t] = sl == 0 ? s0 : fpart[t] + s0;
            fpart[core + t] = sl == 0 ? s1 : fpart[core + t] + s1;
          }
        }

        // stage B, momentum on the sub-tile: u + dt ((q_e T(F) + T(F q_e)) /
        // 2 - grad KE) (forced: - dt lambda u), then the old ssh's pressure
        // and the mask, stored; stratified, kept for Phi's pressure
        for (int e = threadIdx.x; e < core * ks; e += blockDim.x) {
          const int t = e >> a.ks_log2, kl = e & lane_mask;
          if (kl >= kn) continue;
          const int r = by_ct.div(t), c = by_ct.mod(t, r);
          const int sw = (kFwdM + r) * fWi + kFwdI + c;
          const T* fl = dsm + ((kFwdDr + r) * Di + kFwdDc + c) * ks + kl;
          T F[hex::kU], Fq[hex::kU];
#pragma unroll
          for (int i = 0; i < hex::kU; ++i) {
            F[i] = fl[ftp.b_f[i]];
            Fq[i] = fl[ftp.b_f[i] + 6 * DK];
          }
          const T ke0 = fl[18 * DK], ke1 = fl[19 * DK];
          T unew[6];
#pragma unroll
          for (int ch = 0; ch < 6; ++ch) {
            T tf = T(0), tfq = T(0);
#pragma unroll
            for (int x = 0; x < 8; ++x) {
              const int t2 = 8 * ch + x;
              const T c1 = ftp.w[t2] * F[hex::tap_u(t2)];
              const T c2 = ftp.w[t2] * Fq[hex::tap_u(t2)];
              tf = x == 0 ? c1 : tf + c1;
              tfq = x == 0 ? c2 : tfq + c2;
            }
            const T pv = T(0.5) * (fl[(12 + ch) * DK] * tf + tfq);
            const T gke = (fl[ftp.b_ke[ch]] - ((ch & 1) ? ke1 : ke0)) * a.inv_dc;
            unew[ch] = cur[sw * ks + kl + (2 + ch) * fWK] + a.dt * (pv - gke);
            if (kForced && kStrat) unew[ch] = unew[ch] - dt_rayl * cur[sw * ks + kl + (2 + ch) * fWK];
          }
          if (kStrat) {
#pragma unroll
            for (int ch = 0; ch < 6; ++ch) upart[(ch * core + t) * kc + kb + kl] = unew[ch];
          } else if (r >= own_r && c >= own_c) {
            const unsigned lb = kMasked ? static_cast<unsigned>(live_s[sw]) : kAllLive;
            T* u_o = dst_u + static_cast<size_t>(psite[sw]) * K + k0 + kb + kl;
#pragma unroll
            for (int ch = 0; ch < 6; ++ch) {
              const T grad = (fssh[sw + ftp.nb_p[ch]] - fssh[(ch & 1) * fW + sw]) * a.inv_dc;
              T v = unew[ch] + pg_scale * grad;
              if (kForced) v = v - dt_rayl * cur[sw * ks + kl + (2 + ch) * fWK];
              u_o[static_cast<size_t>(ch) * PS * K] = (kMasked && !((lb >> ch) & 1u)) ? T(0) : v;
            }
          }
        }
        __syncthreads();

        if (wd) {
          // the wind and drag at the sub-tile's edges' top and bottom levels
          // in this slice, of the slice's old state
          for (int e = threadIdx.x; e < 6 * core; e += blockDim.x) {
            const int ch = e / core, t = e - ch * core;
            const int r = by_ct.div(t), c = by_ct.mod(t, r);
            const int sw = (kFwdM + r) * fWi + kFwdI + c;
            if (r < own_r || c < own_c || (kMasked && !((live_s[sw] >> ch) & 1u))) continue;
            const int lv = fsm.lvl[ch * core + t];
            int lev[2];
            chunk_levels(lv, k0 + kb, kn, &lev[0], &lev[1]);
            for (int i = 0; i < 2; ++i) {
              const int kl = lev[i];
              if (kl < 0) continue;
              const T* v = cur + sw * ks + kl;
              const T he = T(0.5) * (v[ftp.hs[hex::nb_h(ch)]] + v[ftp.hs[hex::self_h(ch & 1)]]);
              T& o = kStrat ? upart[(ch * core + t) * kc + kb + kl]
                            : dst_u[(static_cast<size_t>(ch) * PS + psite[sw]) * K + k0 + kb +
                                    kl];
              o = o + a.dt * wind_drag(v[ftp.us[hex::self_u(ch)]], he, lv, k0 + kb + kl,
                                       fsm.wind + ch * core + t, fa.fc);
            }
          }
          __syncthreads();
        }
      }

      // ssh' = sum_k h' - rts over the ranks' partial sums, in rank order,
      // on the sub-tile's owned sites: every rank its own copy
      cluster.sync();
      for (int e = threadIdx.x; e < 2 * core; e += blockDim.x) {
        const int p = e >= core ? 1 : 0, x = e - p * core;
        const int r = by_ct.div(x), c = by_ct.mod(x, r);
        if (r < own_r || c < own_c) continue;
        T v[kMaxCluster];
#pragma unroll
        for (int rr = 0; rr < kMaxCluster; ++rr)
          if (rr < n_ranks) v[rr] = *cluster.map_shared_rank(fpart + e, rr);
        T sum = v[0];
#pragma unroll
        for (int rr = 1; rr < kMaxCluster; ++rr)
          if (rr < n_ranks) sum += v[rr];
        const int sw = (kFwdM + r) * fWi + kFwdI + c;
        dst_ssh[p * PS + psite[sw]] = sum - rts_s[p * fW + sw];
      }
      if (kStrat) {
        // Phi of the old state on the sub-tile grown by the gradient's
        // reach, from every rank's chunk of h, then the pressure
        for (int e = threadIdx.x; e < 2 * Fs; e += blockDim.x) {
          const int p = e >= Fs ? 1 : 0, x = e - p * Fs;
          const int r = by_fi.div(x), c = by_fi.mod(x, r);
          sshf[e] = fssh[p * fW + (kFwdM - 1 + r) * fWi + kFwdI - 1 + c];
        }
        __syncthreads();
        montgomery(fss, cluster, fss.fresh, sshf, 1 + fa.nr.m0, 1 + rt + fa.nr.m1, 1 + fa.nr.i0,
                   1 + ct + fa.nr.i1, Fi, Fs, a.kc_log2, kr, K, rank, n_ranks);
        for (int e = threadIdx.x; e < core * kc; e += blockDim.x) {
          const int t = e >> a.kc_log2, kl = e & (kc - 1);
          if (kl >= kr) continue;
          const int r = by_ct.div(t), c = by_ct.mod(t, r);
          if (r < own_r || c < own_c) continue;
          const int sf = (r + 1) * Fi + c + 1;
          const int sw = (kFwdM + r) * fWi + kFwdI + c;
          const unsigned lb = kMasked ? static_cast<unsigned>(live_s[sw]) : kAllLive;
          T* u_o = dst_u + static_cast<size_t>(psite[sw]) * K + k0 + kl;
#pragma unroll
          for (int ch = 0; ch < 6; ++ch) {
            const T* ph = fss.phi + (sf << a.kc_log2) + kl;
            const T grad =
                (ph[ftp.nb_p[ch] << a.kc_log2] - ph[(ch & 1) * (Fs << a.kc_log2)]) * a.inv_dc;
            const T v = upart[(ch * core + t) * kc + kl] + pg_scale * grad;
            u_o[static_cast<size_t>(ch) * PS * K] = (kMasked && !((lb >> ch) & 1u)) ? T(0) : v;
          }
        }
      }
      // no block overwrites its partial sums (or h chunk) while another can
      // still read them
      cluster.sync();
    }
  }

  // ---- the reverse: g_j on R_j, j = q - 1 .. 0
  if (kStrat) load_strat_rows(ssm, a.st.w, core, K, k0, kr, a.kc_log2);
  bool dw_first = a.st.first != 0;
  const T two_ske = T(2) * a.s_ke;
  const T grav = T(kGravity);
  const FastDiv by_ai(Ai), by_bi(Bi), by_ci(Ci);
  for (int j = q - 1; j >= 0; --j) {
    const int om = kWinM * j, oi = kWinI * j;
    const int nr = rt + 2 * om, nc = ct + 2 * oi;
    const int nbc = (nc + ct - 1) / ct, nb = ((nr + rt - 1) / rt) * nbc;
    // the primal state j: the superstep's start, or the recompute's
    const bool p_g = j == 0;
    const T* const p_b = p_g ? nullptr : pslot(j);
    const T* p_ssh = p_g ? a.ssh : p_b + 2LL * rank * PS;
    const T* p_h = p_g ? a.h : p_b + w.ssh_pad;
    const T* p_u = p_g ? a.u : p_h + 2LL * PS * K;
    const T* p_t = p_g ? a.at.tr : p_h + 8LL * PS * K;
    const int p_plane = p_g ? plane : PS;
    const int* p_site = p_g ? gsite : psite;
    // the cotangent at j + 1: the superstep's end, or the step's before
    const bool c_g = j == q - 1;
    const T* const c_b = c_g ? nullptr : cslot(j + 1);
    const T* c_gs = c_g ? a.gs : c_b + 2LL * rank * CS;
    const T* c_gh = c_g ? a.gh : c_b + w.cssh_pad;
    const T* c_gu = c_g ? a.gu : c_gh + 2LL * CS * K;
    const T* c_gt = c_g ? a.at.gtr : c_gh + 8LL * CS * K;
    const int c_plane = c_g ? plane : CS;
    const int* c_site = c_g ? gsite : csite;
    // the state j + 1, whose h' and T' the tracer arm reads
    const T* n_h = c_g ? a.at.h_next : pslot(j + 1) + w.ssh_pad;
    const T* n_t = c_g ? a.at.tr_next : n_h + 8LL * PS * K;
    const int n_plane = c_g ? plane : PS;
    const int* n_site = c_g ? gsite : psite;
    // the cotangent at j: the launch's output on the core, else the scratch
    const bool o_g = j == 0;
    T* const o_b = o_g ? nullptr : cslot(j);
    T* const o_ds = o_g ? a.ds : o_b + 2LL * rank * CS;
    T* const o_dh = o_g ? a.dh : o_b + w.cssh_pad;
    T* const o_du = o_g ? a.du : o_dh + 2LL * CS * K;
    T* const o_dt = o_g ? a.at.dtr : o_dh + 8LL * CS * K;
    const int o_plane = o_g ? plane : CS;
    const int* o_site = o_g ? gsite : csite;
    for (int b = 0; b < nb; ++b) {
      const int bi = b / nbc, bj = b - bi * nbc;
      const int r0 = min(bi * rt, nr - rt), c0 = min(bj * ct, nc - ct);
      const int own_r = bi * rt - r0, own_c = bj * ct - c0;
      const int m0 = r0 - om, i0 = c0 - oi;  // from the tile's first site
      // a sub-tile site (r, c): written by this sub-tile, and the core's
      const auto own = [&](int r, int c) { return r >= own_r && c >= own_c; };
      const auto in_core = [&](int r, int c) {
        return m0 + r >= 0 && m0 + r < rt && i0 + c >= 0 && i0 + c < ct;
      };
      window_tables(gsite, psite, csite, m0 - kWinM, i0 - kWinI, Wi, W, tm0, ti0, a.ny2, a.nx,
                    hpm, hpi, w.pc, hcm, hci, w.cc);
      __syncthreads();
      for (int s = threadIdx.x; s < W; s += blockDim.x) {
        const int g = gsite[s];
        for (int p = 0; p < 2; ++p) {
          copy_async(ssh_s + p * W + s, p_ssh + p * p_plane + p_site[s]);
          copy_async(gs_s + p * W + s, c_gs + p * c_plane + c_site[s]);
        }
        for (int x = 0; x < a.n_fv; ++x) copy_async(fv_s + x * W + s, a.fv + x * plane + g);
      }
      if (kMasked) load_live(live_s, gsite, a.live, W);
      __pipeline_commit();

      for (int sl = 0; sl < n_slices; ++sl) {
        const int kb = sl * ks;
        const int kn = min(ks, kr - kb);
        load_slice(st, p_site, p_h, p_u, W, a.ks_log2, a.vec_log2, k0 + kb, kn, K, p_plane);
        load_slice(cot, c_site, c_gh, c_gu, W, a.ks_log2, a.vec_log2, k0 + kb, kn, K, c_plane);
        if (kTracers) {
          load_tracers(st + 8 * WK, p_site, p_t, 2 * a.at.n, W, a.ks_log2, a.vec_log2, k0 + kb,
                       kn, K, p_plane);
          load_tracers(cot + 8 * WK, c_site, c_gt, 2 * a.at.n, W, a.ks_log2, a.vec_log2,
                       k0 + kb, kn, K, c_plane);
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();
        fold_ssh(cot, gs_s, W, Wi, 0, 0, rt + 2 * kWinM, Wi, ks, a.ks_log2, kn);
        if (kMasked) fold_live(cot + 2 * WK, live_s, W, ks, kn);
        __syncthreads();
        if (kTracers) {  // a = c gT' / h' and the h' feedback into G
          fold_tracers_from(cot, gsite, n_site, n_h, n_t, n_plane, a.at, W, ks, a.ks_log2,
                            k0 + kb, kn, K, plane);
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

        // stage B: dq_e, dF and Sg on ring B; on the core's owned sites, the
        // step's d(dt)
        for (int e = threadIdx.x; e < B * ks; e += blockDim.x) {
          const int d = e >> a.ks_log2, kl = e & lane_mask;
          if (kl >= kn) continue;
          const int r = by_bi.div(d), c = by_bi.mod(d, r);
          const int sw = (r + kWinM - kRingBm) * Wi + c + kWinI - kRingBi;
          const T* cv = cot + sw * ks + kl;
          const T* fa_ = pa + ((r + kRingAm - kRingBm) * Ai + c + kRingAi - kRingBi) * ks + kl;
          T gu[hex_adj::kGu], G[hex_adj::kG];
#pragma unroll
          for (int x = 0; x < hex_adj::kGu; ++x) gu[x] = cv[tp.adj.us[x]];
#pragma unroll
          for (int x = 0; x < hex_adj::kG; ++x) G[x] = cv[tp.adj.hs[x]];
          const int tr_ = r - kRingBm, tc_ = c - kRingBi;
          const bool on_tile = tr_ >= 0 && tr_ < rt && tc_ >= 0 && tc_ < ct && own(tr_, tc_) &&
                               in_core(tr_, tc_);
          T* out = pb + d * ks + kl;
          T part_dt = T(0);
#pragma unroll
          for (int ch = 0; ch < 6; ++ch) {
            T tf = T(0), tg = T(0), tgq = T(0);
#pragma unroll
            for (int x = 0; x < 8; ++x) {
              const int t2 = 8 * ch + x;
              const int src = hex_adj::tap_u(t2);
              const T c1 = tp.w[t2] * fa_[tp.b_f[hex::tap_u(t2)]];
              const T c2 = tp.adj.w[t2] * gu[src];
              const T c3 = tp.adj.w[t2] * (gu[src] * fa_[tp.b_q[src]]);
              tf = x == 0 ? c1 : tf + c1;
              tg = x == 0 ? c2 : tg + c2;
              tgq = x == 0 ? c3 : tgq + c3;
            }
            const T ta = a.dt * tg;
            const T Fc = fa_[ch * AK], qc = fa_[(6 + ch) * AK];
            const T ac = a.dt * gu[ch];
            const T dG = G[hex::nb_h(ch)] - G[ch & 1];
            out[ch * BK] = T(0.5) * (ac * tf + Fc * ta);
            T dF = dG * dt_div + T(0.5) * (a.dt * tgq + qc * ta);
            if (kTracers)
              dF += tracer_dflux(st + sw * ks + kl, cv, WK, tp.adj, a.at, ch, Fc, dt_div, a.inv_dc);
            out[(6 + ch) * BK] = dF;
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
          T* out = pcv + d * ks + kl;
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

        // stage D on the sub-tile: du, dh stored at its owned sites; each
        // slice's level sums of Sg added to the block's partial sums in order
        for (int e0 = 0; e0 < core * ks; e0 += blockDim.x) {
          const int e = e0 + threadIdx.x;
          const int t = e >> a.ks_log2, kl = e & lane_mask;
          const int tt = e < core * ks ? t : 0;
          const int r = by_ct.div(tt), c = by_ct.mod(tt, r);
          const bool on = e < core * ks && kl < kn;
          T sg[2] = {T(0), T(0)};
          if (on) {
            const int sw = (r + kWinM) * Wi + c + kWinI;
            const T* lv = st + sw * ks + kl;
            const T* cv = cot + sw * ks + kl;
            const T* qb = pb + ((r + kRingBm) * Bi + c + kRingBi) * ks + kl;
            const T* qc = pcv + ((r + kRingCm) * Ci + c + kRingCi) * ks + kl;
            const bool mine = own(r, c), counted = mine && in_core(r, c);
            const size_t o = static_cast<size_t>(o_site[sw]) * K + k0 + kb + kl;
            sg[0] = qb[12 * BK];
            sg[1] = qb[13 * BK];
            T trX[2] = {T(0), T(0)}, trY[2] = {T(0), T(0)};
            if (kTracers) {
              T trF[6];
              double trdd = 0.0;
              const unsigned live = kMasked ? static_cast<unsigned>(live_s[sw]) : 0u;
              const unsigned inc_live = kMasked ? adj_incoming_live(live_s, sw, tp.adj) : 0u;
              tracer_adjoint<T, kMasked>(
                  lv, cv, WK, tp.adj, a.at, live, inc_live, dt_div, a.s_div, a.inv_dc, trF, trX,
                  trY, &trdd,
                  [&](int i, T v) {
                    if (mine) o_dt[static_cast<size_t>(i) * o_plane * K + o] = v;
                  },
                  false);
              if (counted) share += trdd;
            }
            if (kStrat) {  // the sub-tile's S chunk, for the stratified pass
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
              for (int jj = 0; jj < 2; ++jj) {
                const int t2 = 2 * ch + jj;
                const T v = hex_vadj::curl_t(t2, 5) > 0 ? qc[tp.d_z[t2]] : -qc[tp.d_z[t2]];
                curl = jj == 0 ? v : curl + v;
              }
              du[ch] = ((cv[(2 + ch) * WK] + he * qb[(6 + ch) * BK]) + two_ske * uc * dke) + curl;
              if (kForced) {
                const T gue = cv[(2 + ch) * WK];
                du[ch] = du[ch] - dt_rayl * gue;
                if (counted)
                  s_rayl = fma(static_cast<double>(gue), static_cast<double>(uc), s_rayl);
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
              for (int jj = 0; jj < 6; ++jj) {
                const int t2 = 6 * p + jj;
                const T wgt = kMasked ? fv_s[(8 + hex_vadj::kite_t(t2, 5)) * W + sw + tp.d_kw[t2]]
                                      : tp.kw[hex_vadj::kite_t(t2, 5)];
                const T v = wgt * qc[tp.d_hv[t2]];
                kite = jj == 0 ? v : kite + v;
              }
              dh[p] = kTracers ? ((cv[p * WK] + T(0.5) * (flux + trX[p])) + kite) + trY[p]
                               : (cv[p * WK] + T(0.5) * flux) + kite;
            }
            if (mine) {
#pragma unroll
              for (int p = 0; p < 2; ++p) o_dh[static_cast<size_t>(p) * o_plane * K + o] = dh[p];
#pragma unroll
              for (int ch = 0; ch < 6; ++ch)
                o_du[static_cast<size_t>(ch) * o_plane * K + o] = du[ch];
            }
          }
          const T s0 = group_sum(sg[0], g_width), s1 = group_sum(sg[1], g_width);
          if (e < core * ks && kl == 0) {
            part[t] = sl == 0 ? s0 : part[t] + s0;
            part[core + t] = sl == 0 ? s1 : part[core + t] + s1;
          }
        }
        __syncthreads();

        if (wd) {
          // the wind and drag at the slice's top and bottom levels of the
          // sub-tile's owned edges and cells (adjoint_window.cuh's
          // wind_drag_adjoint and wind_drag_dhe, d(wind) and the shares the
          // core's only)
          for (int e = threadIdx.x; e < 6 * core; e += blockDim.x) {
            const int ch = e / core, t = e - ch * core;
            const int r = by_ct.div(t), c = by_ct.mod(t, r);
            if (!own(r, c)) continue;
            const bool counted = in_core(r, c);
            const int sw = (r + kWinM) * Wi + c + kWinI;
            const int g = gsite[sw];
            const int lv = a.fc.lvl[ch * plane + g];
            int lev[2];
            chunk_levels(lv, k0 + kb, kn, &lev[0], &lev[1]);
            for (int jj = 0; jj < 2; ++jj) {
              const int kl = lev[jj];
              if (kl < 0) continue;
              const T* v = st + sw * ks + kl;
              const T* gq = cot + sw * ks + kl;
              const int us = tp.adj.us[hex::self_u(ch)];
              const T he =
                  T(0.5) * (v[tp.adj.hs[hex::nb_h(ch)]] + v[tp.adj.hs[hex::self_h(ch & 1)]]);
              T du = T(0);
              double x_dd = 0.0, x_lin = 0.0, x_quad = 0.0;
              wind_drag_adjoint(gq[us], v[us], he, lv, k0 + kb + kl, a.fc.wind + ch * plane + g,
                                counted ? a.dwind + ch * plane + g : static_cast<T*>(nullptr),
                                a.fc, a.dt, &du, &x_dd, &x_lin, &x_quad);
              T& o = o_du[(static_cast<size_t>(ch) * o_plane + o_site[sw]) * K + k0 + kb + kl];
              o = o + du;
              if (counted) share += x_dd, s_lin += x_lin, s_quad += x_quad;
            }
          }
          for (int e = threadIdx.x; e < 2 * core; e += blockDim.x) {
            const int p = e >= core ? 1 : 0, t = e - p * core;
            const int r = by_ct.div(t), c = by_ct.mod(t, r);
            if (!own(r, c)) continue;
            const int sw = (r + kWinM) * Wi + c + kWinI;
            const int g = gsite[sw];
            // the 6 edges: owned i = f (channel 2f + p), incoming x = 3p + i - 3
            int lv[6], ew[6];
#pragma unroll
            for (int i = 0; i < 6; ++i) {
              ew[i] = i < 3 ? (2 * i + p) * plane + g
                            : tp.adj.inc_ch[3 * p + i - 3] * plane +
                                  gsite[sw + tp.adj.inc_off[3 * p + i - 3]];
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
              const T hc = v[tp.adj.hs[hex::self_h(p)]];
              T dhe = T(0);
#pragma unroll
              for (int f = 0; f < 3; ++f) {
                const int ch = 2 * f + p, us = tp.adj.us[hex::self_u(ch)];
                dhe += wind_drag_dhe(gq[us], v[us],
                                     T(0.5) * (v[tp.adj.hs[hex::nb_h(ch)]] + hc), lv[f],
                                     k0 + kb + kl, a.fc.wind + ew[f], a.fc, a.dt);
              }
#pragma unroll
              for (int x = 3 * p; x < 3 * p + 3; ++x) {
                const int us = tp.adj.us[hex::inc_u(x)];
                dhe += wind_drag_dhe(gq[us], v[us],
                                     T(0.5) * (v[tp.adj.hs[hex::inc_nb_h(x)]] +
                                               v[tp.adj.hs[hex::inc_self_h(x)]]),
                                     lv[x - 3 * p + 3], k0 + kb + kl, a.fc.wind + ew[x - 3 * p + 3],
                                     a.fc, a.dt);
              }
              T& o = o_dh[(static_cast<size_t>(p) * o_plane + o_site[sw]) * K + k0 + kb + kl];
              o = o + T(0.5) * dhe;
            }
          }
          __syncthreads();
        }
      }

      cluster.sync();
      if (kStrat) {
        // W dPhi into the stored dh at the owned sites, the core's d(W) rows
        // and d(dt)'s h @ W part (h read as 0 off the core); h from the
        // primal source
        strat_adjoint_pass(
            ssm, cluster,
            [&](int p, int r, int c, int kl) -> T {
              return own(r, c) && in_core(r, c)
                         ? p_h[(static_cast<size_t>(p) * p_plane +
                                p_site[(r + kWinM) * Wi + c + kWinI]) * K + k0 + kl]
                         : T(0);
            },
            a.st.acc + static_cast<size_t>(tile) * K * K, dw_first,
            [&](int p, int t, int kl) -> T* {
              const int r = by_ct.div(t), c = by_ct.mod(t, r);
              return own(r, c) ? o_dh + (static_cast<size_t>(p) * o_plane +
                                         o_site[(r + kWinM) * Wi + c + kWinI]) * K + k0 + kl
                               : nullptr;
            },
            core, ct, a.kc_log2, k0, kr, K, n_ranks, a.dt, a.inv_dc, &share);
        dw_first = false;
      }
      // ds = (g / dc) dt * the ranks' partial sums, in rank order, at the
      // owned sites: rank 0 into the output, every rank its own scratch copy
      if (!o_g || rank == 0) {
        for (int e = threadIdx.x; e < 2 * core; e += blockDim.x) {
          const int p = e >= core ? 1 : 0, x = e - p * core;
          const int r = by_ct.div(x), c = by_ct.mod(x, r);
          if (!own(r, c)) continue;
          T v = *cluster.map_shared_rank(part + e, 0);
          for (int rr = 1; rr < n_ranks; ++rr) v += *cluster.map_shared_rank(part + e, rr);
          o_ds[p * o_plane + o_site[(r + kWinM) * Wi + c + kWinI]] = a.ds_scale * v;
        }
      }
      // no block overwrites its partial sums or S chunk while another can
      // still read them
      cluster.sync();
    }
  }

  // the block's d(dt) share, and the forced arm's three more
  if (kForced) share -= static_cast<double>(a.fc.rayl) * s_rayl;
  share_warps(share, red);
  __syncthreads();
  if (threadIdx.x == 0) a.ddt_part[blockIdx.x] = share_total(red);
  if (kForced)
    write_forcing_shares(red, a.ddt_part + blockIdx.x, a.n_shares, s_lin, s_quad, s_rayl,
                         static_cast<double>(a.dt));
}

// Dynamic shared memory of one block (kernels/adjoint_step.nl_window_smem_bytes
// mirrors this): the warps' d(dt) sums and the window's four site tables
// (lattice, primal and cotangent scratch sites, live bits) at the reverse's
// window, then the larger of the reverse's layout (nl_adjoint_smem_bytes'
// values, its stratified arm's S chunk and W rows) and the recompute's
// (nl_step.cuh's FE layout with one state slice: the derived planes, the
// window's ssh, rts and vertex constants, the partial column sums; the
// stratified arm's pressure ssh, kept momentum and StratSmem with the h
// chunk; the forced arm's winds and levels on the tile).
inline size_t nl_window_smem_bytes(int rt, int ct, int ks, size_t itemsize, int n_tr, int kc,
                                   int strat_k, bool forced) {
  const long long W = static_cast<long long>(rt + 2 * kWinM) * (ct + 2 * kWinI);
  const long long A = static_cast<long long>(rt + 2 * kRingAm) * (ct + 2 * kRingAi);
  const long long B = static_cast<long long>(rt + 2 * kRingBm) * (ct + 2 * kRingBi);
  const long long C = static_cast<long long>(rt + 2 * kRingCm) * (ct + 2 * kRingCi);
  const long long fW = static_cast<long long>(rt + 2 * kFwdM) * (ct + 2 * kFwdI);
  const long long D = static_cast<long long>(rt + 2 * kFwdDr) * (ct + 2 * kFwdDc);
  const long long Fs = static_cast<long long>(rt + 2) * (ct + 2);
  const long long core = static_cast<long long>(rt) * ct;
  const long long n_pl = 8 + 2LL * n_tr;
  const size_t rev =
      itemsize * static_cast<size_t>((2 * n_pl * W + kAPlanes * A + kBPlanes * B + kCPlanes * C) *
                                         ks +
                                     (4 + hex_vert::kFv) * W + 2 * core) +
      (strat_k > 0 ? strat_adj_smem_bytes(static_cast<int>(core), kc, strat_k, itemsize) : 0);
  long long fvals = (n_pl * fW + hex_vert::kPlanes * D) * ks + (4 + hex_vert::kFv) * fW + 2 * core;
  if (strat_k > 0) fvals += 2 * Fs + 6 * core * kc;
  const size_t fwd = itemsize * static_cast<size_t>(fvals) +
                     (strat_k > 0 ? strat_smem_bytes(Fs, kc, strat_k, itemsize, true) : 0) +
                     (forced ? forcing_smem_bytes(core, 0, itemsize) : 0);
  return sizeof(double) * kRedDoubles + 4 * sizeof(int) * static_cast<size_t>(W) +
         (rev > fwd ? rev : fwd);
}

// One call's launch set-up.
template <typename T>
struct NlWinPlan {
  NlWinArgs<T> w;
  NlTaps<T> ftp;
  NlAdjTaps<T> tp;
  int n_ranks, n_tiles, max_smem;
  size_t smem;
};

template <typename T, bool kMasked, bool kForced, bool kTracers, bool kStrat>
int nl_win_prepare(int max_smem) {
  static bool done = false;
  if (done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(nl_window_adjoint_kernel<T, kMasked, kForced, kTracers, kStrat>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  done = e == cudaSuccess;
  return static_cast<int>(e);
}

// One launch of an arm's instantiation with the plan's operands; returns 0
// or the CUDA error. Each nl_window_adjoint_{f32,f64}{,_forced}.cu
// instantiates 8 of the 32 (MOT_NL_ADJ_ARMS's arms), and nl_window_adjoint.cu,
// which launches them, declares them extern.
template <typename T, bool kMasked, bool kForced, bool kTracers, bool kStrat>
int nl_win_launch(const NlWinPlan<T>& pl, cudaStream_t stream) {
  int err = nl_win_prepare<T, kMasked, kForced, kTracers, kStrat>(pl.max_smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = step_config(pl.n_ranks, pl.n_tiles, pl.smem, stream, attr);
  cudaError_t le = cudaLaunchKernelEx(
      &cfg, nl_window_adjoint_kernel<T, kMasked, kForced, kTracers, kStrat>, pl.w, pl.ftp, pl.tp);
  if (le == cudaSuccess) le = cudaGetLastError();
  return static_cast<int>(le);
}

#define MOT_NL_WIN_INSTANTIATE(T, M, F, TR, S) \
  template int nl_win_launch<T, M, F, TR, S>(const NlWinPlan<T>&, cudaStream_t);
#define MOT_NL_WIN_EXTERN(T, M, F, TR, S) \
  extern template int nl_win_launch<T, M, F, TR, S>(const NlWinPlan<T>&, cudaStream_t);

}  // namespace lattice
