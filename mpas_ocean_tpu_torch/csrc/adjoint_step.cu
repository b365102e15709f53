// Reverse (adjoint) of one forward-Euler step of the linear TRiSK
// shallow-water core on the parity-plane hex lattice, for NVIDIA Hopper
// (sm_90a).
//
// Replaces: _adjoint_segment_kernel
// (mpas_ocean_tpu/structured/pallas_model.py:1480), the arms with
// nl_terms=None, periodic (masks=None) and masked (a coastal channel: the
// vjp of _step_planes with masks, :1497-1501, 1545-1552), unforced and
// forced (the `forced` operands, :1514-1520, 1545-1590: d(wind) and
// d(coefs) beside d(dt)), without tracers and with them (the tracer
// cotangent gt_ref / gt_out, :1521-1528, 1561, 1573, 1599-1600),
// unstratified and stratified (W in sw_ref, :1506-1510, its cotangent dsw,
// :1576-1601), the last three in any combination. The TPU
// kernel recomputes a b-step segment in VMEM and runs an in-kernel jax.vjp of
// _step_planes per step. CUDA has no vjp, so the transpose is written out by
// hand here, and the recompute is the forward kernel's (fe_step.cu) filling
// a stack of states in device memory. One launch maps (primal state at step
// j, cotangent at step j + 1) to the cotangent at step j.
//
// For output cotangents (gs, gh, gu), with G = gh + gs (ssh' = sum_k h' - rts):
//   dG_e     = G[nbr(e)] - G[owner(e)]
//   dh_c     = G_c + 1/2 sum over the 6 edges e of c of u_e * dt * s_div * dG_e
//   du_e     = gu_e + 1/2 (h_owner + h_nbr) * dt * s_div * dG_e
//              + dt * f_e * (C^T gu)_e
//   ds_c     = (g dt / dc) * (sum_owned S_e - sum_incoming S_e), S_e = sum_k gu_e
//   d(dt)    = <G, tend_h> + <gu, tend_u>, summed per owned edge as
//              s_div dG_e u_e h_e + u_e f_e (C^T gu)_e - g grad(ssh)_e gu_e.
// C^T is the Coriolis stencil transposed (structured/stencils.py:
// transpose_coriolis_terms), packed in fe_step.cu's table layout.
//
// What bound the first design (PERF.md): 15% of the byte bound on an H100
// (35.5 us per launch at 64x64x100 f32 against 5.9). One 128-thread block
// per cell column (28 lanes idle at K = 100), each resolving the stencil
// tables again, ~45 L1/L2 loads per cell-level that neighbouring columns
// repeated, a runtime loop over the transposed taps, seven block
// reductions per column, and one d(dt) share per column that a one-block
// kernel then summed (6.2 ms of a 4000-step grad).
//
// This design, that of fe_step.cu (step_window.cuh) for the transpose. A
// thread-block cluster takes an rt x ct tile of lattice sites (both
// parities; any tile, sites past the lattice's edge skipped), its blocks
// split the levels in chunks of kc (a power of two, 16 at K = 100), and each
// block stages its chunk of the tile's window (the tile plus the transposed
// step's reach, 1 row and 2 columns per side, wrapped periodically) of the
// primal h, u, ssh and of the cotangent gh, gu, gs, and f_edge, by 16-byte
// async copies, so each value leaves L2 once per tile. gs is folded into gh
// in shared memory (G), since the transpose reads gh only through G. The
// transposed stencil is resolved once per call on the host into
// constant-bank offsets (adjoint_window.cuh, hex_adj::), so each of the 25 gu,
// 10 G, 7 h and 11 u values a site-level reads is loaded once and every loop
// is unrolled: the kernel takes the hex lattice's table only, and its entry
// refuses any other. Groups of min(16, kc) lanes take consecutive levels of
// one site. Each block's per-site partials of sum_owned S_e - sum_incoming
// S_e are a shuffle over the group, stored straight into rank 0's shared
// memory (once a split cluster barrier, whose wait the loads hide, has seen
// every block start); after a second cluster barrier rank 0 adds them in
// rank order and writes ds. Each block writes one d(dt) share (its threads'
// values summed by warps in order, in float64), and one small kernel per
// call adds the call's n_steps * tiles * ranks shares in a fixed order: no
// atomics, so f64 reruns are bitwise equal. The window leaves room for two
// 512-thread blocks per SM at the planner's tile
// (kernels/adjoint_step.adjoint_tile), and launches are programmatically
// dependent.
//
// The masked arm (kMasked, chosen by non-null live bits; the periodic arm
// keeps its code): a masked step ends u' = m * (u + dt tend_u), so its output
// cotangent gu enters as m * gu wherever gu appears (the taps of C^T gu,
// du's first term, S_e, d(dt)). The wall mask comes as one int of live bits
// per window site, copied with the window (step_window.cuh, load_live), and
// is folded into the staged gu once per window, beside the gs fold: a warp
// per site zeroes the chunks of its masked channels (adjoint_window.cuh,
// fold_live); the step body does not change. A first
// design staged the mask's six planes and folded them value by value: 20-22%
// more time per launch at 64x64x100 f32 (PERF.md has the designs tried).
//
// The forced arm (kForced, chosen by a non-null wind; the unforced arm keeps
// its code) adds the transpose of dt F (structured/adjoint.py,
// forcing_transpose), a = dt gu: Rayleigh's du -= dt lambda gu at every
// level, and its sum of gu u, from which each block's shares of d(lambda)
// and of d(dt)'s Rayleigh part come; at an edge's top and bottom level the
// wind and drag terms (adjoint_window.cuh, wind_drag_adjoint), among them
// the h_edge cotangent a (top w - bot Cd |u| u) (-inv_h^2), which joins the
// flux transpose's u dF, half to each of the edge's cells, so a site takes it
// on its 3 owned and its 3 incoming edges. Those terms run only in the
// ranks whose chunk holds some edge's top or bottom level, which stage the
// window's winds and packed levels (step_window.cuh, ForcingArgs), in two
// passes after the body, a thread an edge or a cell, not a level: over the
// tile's owned edges (the terms added to the stored du, d(wind), the
// shares; adjoint_window.cuh, wind_drag_adjoint_pass) and over its cells
// (at their edges' top and bottom levels, the h cotangent formed again with
// the h_edge cotangents in the flux transpose's sum; dh_pass). Each site adds a inv_h at its owned edges' top levels to
// d(wind) in place (one block owns each edge's top level: no atomics), and
// each block writes three more shares in double beside d(dt): d(r_lin),
// d(Cd) and d(lambda), summed in the same fixed order.
//
// The stratified arm (kStrat, chosen by a non-null W; the unstratified
// arms keep their code) adds the transpose of
// the Montgomery pressure's h @ W part (adjoint_window.cuh,
// strat_adjoint_pass): the body stores its chunk of S_c,k at the tile's
// cells in shared memory; after a cluster barrier each rank reads the
// others' chunks in place, adds (dt / dc) W dPhi at its levels to the
// stored dh, and forms its rows of d(W) in double into the tile's
// accumulator and d(dt)'s h @ W part into its share. Each rank stages its
// rows of W with the window, its shared memory after the forced arm's.
//
// The tracer arm (kTracers, chosen by a non-null tracer pointer; the
// tracer-free arms keep their code) adds the transpose of the tracer
// update (structured/adjoint.py, tracer_transpose). Each block stages its
// level chunk of the window's 2 nT primal tracer planes after the primal
// state's 8 and of their cotangent after the cotangent's 8, with the same
// async copies; then, once per window, a = c gT' / h' replaces the staged
// gT' and the h' feedback -sum_t a T' is folded into G beside the gs fold
// (adjoint_window.cuh, fold_tracers), reading h' and T' of state j + 1 from
// device memory (the stack's next slot, or the state after its last),
// since recomputing them would widen the window by a ring. In the body a
// site-level first forms the tracers' sums (tracer_adjoint: dT stored per
// tracer, the flux cotangent per owned edge, the h cotangent's terms, the
// share of d(dt)), which the linear transpose then adds where the JAX vjp
// adds them; its d(dt) takes <G, tend_h> per cell, as the plain reverse
// does, for the h' feedback makes those terms cancel. A tracer level needs
// only its own level: no column sum and no cluster traffic more. It runs one
// 512-thread block per SM (128 registers a thread), with the tile its
// planner sizes for one block's shared memory.
//
// The arms compose (every combination of kForced, kTracers and kStrat,
// 16 instantiations per dtype; adjoint_step_f64.cu holds the f64 ones):
// the forced passes run after the body with the tracer arm too, the h
// cotangent pass then adding the h_edge cotangents to the stored dh (which
// holds the tracers' terms) rather than forming it again (dh_pass<true>);
// the stratified pass runs last, on dh with every other term in it.
//
// What bounds it: about 3 state passes per step (read the primal h and u,
// read the cotangent, write the new one), 19.7 MB at 64x64x100 in f32, 5.9
// us at 3.35 TB/s. Measured (f32, NVIDIA H100 80GB HBM3 at 700 W; PERF.md
// section 5): 24% of that bound at 64x64x100 (25 us per launch, (4, 8)
// tiles) and 33% at 256x256x100 (287 against 94 us, (4, 12) tiles); the
// first design reached 15%.

#include "adjoint_window.cuh"

namespace {

using namespace lattice;

// f_edge [6] and ssh, gs [2 + 2] per window site
constexpr int kPlanes = 10;

template <typename T>
struct AdjArgs {
  const T* ssh;  // primal state j
  const T* h;
  const T* u;
  const T* gs;  // cotangent j + 1
  const T* gh;
  const T* gu;
  const T* f_edge;
  const int* live;  // the masked arm's live bits, (ny2, nx); null otherwise
  T* ds;  // cotangent j
  T* dh;
  T* du;
  double* ddt_part;  // one share per block: (tile, rank); the forced arm's
                     // three more kinds n_shares apart
  ForcingArgs<T> fc;  // the forced arm's operands; wind null otherwise
  T* dwind;           // the forced arm's d(wind) (6, ny2, nx), added to
  AdjTracers<T> at;   // the tracer arm's operands; tr null otherwise
  AdjStrat<T> st;     // the stratified arm's operands; w null otherwise
  T dt, inv_dc, s_div;
  int ny2, nx, K, rt, ct, hm, hi, kc_log2, vec_log2, n_tiles_i;
  long long n_shares;
};

// One block per SM for the tracer arm: at two (64 registers a thread) its
// f32 body spilled 388-408 bytes a thread, more than L1 holds beside two
// windows, and took 5.3x the tracer-free arm per launch at 256^2 (PERF.md).
template <typename T, bool kMasked, bool kForced, bool kTracers, bool kStrat>
__global__ void __launch_bounds__(kStepThreads, kTracers ? 1 : 2)
    adjoint_step_kernel(const AdjArgs<T> a, const AdjTaps<T> tp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int tile = blockIdx.x / n_ranks;
  const int tm = tile / a.n_tiles_i, ti = tile % a.n_tiles_i;
  const int Wi = a.ct + 2 * a.hi, W = (a.rt + 2 * a.hm) * Wi;
  const int kc = 1 << a.kc_log2, k0 = rank * kc, kr = min(kc, a.K - k0);
  const int plane = a.ny2 * a.nx;
  const int pk = W * kc;
  const int K = a.K;
  const int core = a.rt * a.ct;

  // the tracer arm's planes follow the state's, in the primal and the cotangent
  const int n_pl = kTracers ? 8 + 2 * a.at.n : 8;
  double* red = reinterpret_cast<double*>(smem_raw);  // [kRedDoubles]
  T* prim = reinterpret_cast<T*>(red + kRedDoubles);  // [n_pl][W][kc]: h p0, h p1, u c0..c5, T
  T* cot = prim + n_pl * pk;                          // [n_pl][W][kc]: G p0, G p1, gu c0..c5, a
  T* ssh_s = cot + n_pl * pk;                         // [2][W]
  T* gs_s = ssh_s + 2 * W;                            // [2][W]
  T* f_s = gs_s + 2 * W;                              // [6][W]
  T* recv = f_s + 6 * W;  // [n_ranks][2][core]: rank 0's are read
  int* gsite = reinterpret_cast<int*>(recv + n_ranks * 2 * core);  // [W]: lattice site
  int* live_s = gsite + W;  // [W]: the masked arm's live bits
  const ForcingSmem<T> fsm(live_s + W, W, 0);  // the forced arm's winds and levels
  // the stratified arm's S and W rows, after the forced arm's
  const StratAdjSmem<T> ssm(kForced ? static_cast<void*>(fsm.lvl + 6 * W) : live_s + W, core, kc);

  // The partial sums below go straight into rank 0's shared memory, which
  // only a cluster barrier guarantees to exist: its arrival here and its
  // wait after the loads, so that the loads hide it.
  cluster_arrive_relaxed();
  allow_next_grid();
  window_sites(gsite, tm * a.rt - a.hm, ti * a.ct - a.hi, Wi, W, a.ny2, a.nx, 0);
  __syncthreads();
  wait_previous_grid();
  for (int s = threadIdx.x; s < W; s += blockDim.x)
    for (int c6 = 0; c6 < 6; ++c6)
      copy_async(f_s + c6 * W + s, a.f_edge + c6 * plane + gsite[s]);
  load_chunk(prim, ssh_s, gsite, a.ssh, a.h, a.u, W, kc, a.kc_log2, a.vec_log2, k0, kr, K,
             plane);
  load_chunk(cot, gs_s, gsite, a.gs, a.gh, a.gu, W, kc, a.kc_log2, a.vec_log2, k0, kr, K,
             plane);
  if (kMasked) load_live(live_s, gsite, a.live, W);
  if (kForced) load_forcing(fsm, gsite, a.fc, W, plane, rank);
  if (kTracers) {
    load_tracers(prim + 8 * pk, gsite, a.at.tr, 2 * a.at.n, W, a.kc_log2, a.vec_log2, k0, kr,
                 K, plane);
    load_tracers(cot + 8 * pk, gsite, a.at.gtr, 2 * a.at.n, W, a.kc_log2, a.vec_log2, k0, kr,
                 K, plane);
  }
  if (kStrat) load_strat_rows(ssm, a.st.w, core, K, k0, kr, a.kc_log2);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  fold_ssh(cot, gs_s, W, Wi, 0, 0, a.rt + 2 * a.hm, Wi, kc, a.kc_log2, kr);
  if (kMasked) fold_live(cot + 2 * pk, live_s, W, kc, kr);
  __syncthreads();
  if (kTracers) {
    fold_tracers(cot, gsite, a.at, W, kc, a.kc_log2, k0, kr, K, plane);
    __syncthreads();
  }
  cluster_wait();

  const T dt_div = a.dt * a.s_div;
  const T grav = T(kGravity);
  T* const sums = cluster.map_shared_rank(recv, 0) + rank * 2 * core;
  // groups of G = min(16, kc) lanes, one site each, 32 / G sites per warp
  const int g_log2 = min(a.kc_log2, kLanesLog2), G = 1 << g_log2;
  const int lane = threadIdx.x & (G - 1), sub = (threadIdx.x & 31) >> g_log2;
  const int warp_sites = 32 >> g_log2;
  const int site_stride = static_cast<int>(blockDim.x >> 5) * warp_sites;
  const FastDiv by_ct(a.ct);
  double share = 0.0;
  // the forced arm: dt lambda; its threads' sums, in double, of gu u
  // (Rayleigh, each product in double) and of the d(r_lin) and d(Cd)
  // shares; its d(dt) terms summed in double too (each term rounds in T, the
  // sums do not)
  const T dt_rayl = a.dt * a.fc.rayl;
  double s_rayl = 0.0, s_lin = 0.0, s_quad = 0.0;
  for (int base = static_cast<int>(threadIdx.x >> 5) * warp_sites; base < core;
       base += site_stride) {
    const int t = base + sub;
    const int tt = t < core ? t : base;
    const int r = by_ct.div(tt), c = by_ct.mod(tt, r);
    const int gm = tm * a.rt + r, gi = ti * a.ct + c;
    const bool valid = t < core && gm < a.ny2 && gi < a.nx;  // a ragged tile's edge
    const int g = gm * a.nx + gi;
    const int s = (a.hm + r) * Wi + a.hi + c;
    // per site: the pressure gradient of the primal ssh and f on the 6 owned edges
    T grad[6], fo[6];
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) {
      grad[ch] = (ssh_s[s + tp.nb[ch]] - ssh_s[(ch & 1) * W + s]) * a.inv_dc;
      fo[ch] = f_s[ch * W + s];
    }
    // the masked tracer arm's live bits of the site's edges and incoming edges
    const unsigned live = kTracers && kMasked ? static_cast<unsigned>(live_s[s]) : 0u;
    const unsigned inc_live = kTracers && kMasked ? adj_incoming_live(live_s, s, tp) : 0u;
    T acc0 = T(0), acc1 = T(0);
    for (int kl = lane; kl < kc; kl += G) {
      if (!valid || kl >= kr) continue;
      const T* P = prim + s * kc + kl;
      const T* C = cot + s * kc + kl;
      // the tracer arm's sums, which the transpose below adds, and its
      // per-cell d(dt) terms, which replace the per-edge <G, tend_h>
      T trF[6], trX[2], trY[2];
      double trdd = 0.0;
      if (kTracers)
        tracer_adjoint<T, kMasked>(P, C, pk, tp, a.at, live, inc_live, dt_div, a.s_div,
                                   a.inv_dc, trF, trX, trY, &trdd, [&](int i, T v) {
                                     a.at.dtr[(static_cast<size_t>(i) * plane + g) * K + k0 +
                                              kl] = v;
                                   });
      // every source loaded once; the stores come last, so that no store
      // sits between two loads of a value
      T gu[hex_adj::kGu], Gv[hex_adj::kG], h[hex_adj::kH], u[hex_adj::kU];
#pragma unroll
      for (int x = 0; x < hex_adj::kGu; ++x) gu[x] = C[tp.us[x]];
#pragma unroll
      for (int x = 0; x < hex_adj::kG; ++x) Gv[x] = C[tp.hs[x]];
#pragma unroll
      for (int x = 0; x < hex_adj::kH; ++x) h[x] = P[tp.hs[x]];
#pragma unroll
      for (int x = 0; x < hex_adj::kU; ++x) u[x] = P[tp.us[x]];
      T dh[2], du[6], S[2];
      // d(dt)'s terms: in T, or in double for the forced arm
      std::conditional_t<kForced, double, T> part = 0;
      double rayl = 0.0;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const T Gc = Gv[hex::self_h(p)], hc = h[hex::self_h(p)];
        T flux = T(0);
#pragma unroll
        for (int f = 0; f < 3; ++f) {
          const int ch = f * 2 + p;
          const T dG = Gv[hex::nb_h(ch)] - Gc;
          const T gflux = kTracers ? dt_div * dG + trF[ch] : dt_div * dG;
          const T he = T(0.5) * (h[hex::nb_h(ch)] + hc);
          T ct = T(0);
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int t2 = 8 * ch + x;
            const T contrib = tp.w[t2] * gu[hex_adj::tap_u(t2)];
            ct = (x == 0) ? contrib : ct + contrib;
          }
          const T fct = fo[ch] * ct;
          const T gue = gu[hex::self_u(ch)], ue = u[hex::self_u(ch)];
          du[ch] = gue + he * gflux + a.dt * fct;
          if (kForced) {
            du[ch] = du[ch] - dt_rayl * gue;
            rayl = fma(static_cast<double>(gue), static_cast<double>(ue), rayl);
          }
          flux += ue * gflux;
          part += kTracers ? ue * fct - grav * grad[ch] * gue
                           : ue * (a.s_div * dG * he + fct) - grav * grad[ch] * gue;
        }
#pragma unroll
        for (int x = 3 * p; x < 3 * p + 3; ++x)
          flux += u[hex::inc_u(x)] * (dt_div * (Gc - Gv[hex::inc_self_h(x)]));
        dh[p] = kTracers ? Gc + T(0.5) * (flux + trX[p]) + trY[p] : Gc + T(0.5) * flux;
        S[p] = (gu[hex::self_u(p)] + gu[hex::self_u(2 + p)] + gu[hex::self_u(4 + p)]) -
               (gu[hex::inc_u(3 * p)] + gu[hex::inc_u(3 * p + 1)] + gu[hex::inc_u(3 * p + 2)]);
      }
      if (kStrat) {  // the tile's S chunk, for the stratified pass
        ssm.sl[(t << a.kc_log2) + kl] = S[0];
        ssm.sl[((core + t) << a.kc_log2) + kl] = S[1];
      }
      T* h_o = a.dh + g * K + k0 + kl;
      T* u_o = a.du + g * K + k0 + kl;
#pragma unroll
      for (int p = 0; p < 2; ++p) h_o[p * plane * K] = dh[p];
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) u_o[ch * plane * K] = du[ch];
      acc0 += S[0];
      acc1 += S[1];
      share += static_cast<double>(part);
      if (kTracers) share += trdd;
      if (kForced) s_rayl += rayl;
    }
    acc0 = group_sum(acc0, G);
    acc1 = group_sum(acc1, G);
    if (t < core && lane == 0) {
      sums[t] = acc0;
      sums[core + t] = acc1;
    }
  }
  if (kForced && ((a.fc.lvl_ranks >> rank) & 1u)) {
    // the wind and drag at the tile's owned edges' top and bottom levels in
    // this block's chunk (a rank that holds some edge's top or bottom
    // level): added to the stored du, d(wind) and the shares; then the h
    // cotangent at the tile's cells' top and bottom levels
    const auto core_site = [&](int t) {  // the tile's site t in the window, or -1
      const int r = by_ct.div(t), c = by_ct.mod(t, r);
      return tm * a.rt + r < a.ny2 && ti * a.ct + c < a.nx ? (a.hm + r) * Wi + a.hi + c : -1;
    };
    wind_drag_adjoint_pass(
        prim, cot, tp, fsm, core, core_site, [](int) { return true; },
        [&](int ch, int t, int, int kl) -> T& {
          const int r = by_ct.div(t), c = by_ct.mod(t, r);
          return a.du[(ch * plane + (tm * a.rt + r) * a.nx + ti * a.ct + c) * K + k0 + kl];
        },
        [&](int ch, int t) {
          const int r = by_ct.div(t), c = by_ct.mod(t, r);
          return a.dwind + ch * plane + (tm * a.rt + r) * a.nx + ti * a.ct + c;
        },
        W, kc, k0, kr, a.dt, a.fc, &share, &s_lin, &s_quad);
    dh_pass<kTracers>(prim, cot, tp, fsm, core, core_site,
            [&](int p, int t, int, int kl) -> T& {
              const int r = by_ct.div(t), c = by_ct.mod(t, r);
              return a.dh[(p * plane + (tm * a.rt + r) * a.nx + ti * a.ct + c) * K + k0 + kl];
            },
            W, kc, k0, kr, a.dt, dt_div, a.fc);
  }
  if (kStrat) {
    // W dPhi into the stored dh, the tile's d(W) rows and d(dt)'s h @ W
    // part, once every rank's S chunk is visible
    cluster.sync();
    strat_adjoint_pass(
        ssm, cluster, WindowH<T>{prim, a.hm, a.hi, Wi, pk, a.kc_log2},
        a.st.acc + static_cast<size_t>(tile) * K * K, a.st.first != 0,
        [&](int p, int t, int kl) -> T* {
          const int r = by_ct.div(t), c = by_ct.mod(t, r);
          const int gm = tm * a.rt + r, gi = ti * a.ct + c;
          return gm < a.ny2 && gi < a.nx ? a.dh + (p * plane + gm * a.nx + gi) * K + k0 + kl
                                         : nullptr;
        },
        core, a.ct, a.kc_log2, k0, kr, K, n_ranks, a.dt, a.inv_dc, &share);
  }
  // the forced arm's Rayleigh part of d(dt), -lambda sum gu u
  if (kForced) share -= static_cast<double>(a.fc.rayl) * s_rayl;
  share_warps(share, red);

  // ds = (g dt / dc) * the ranks' partial sums, added by rank 0 in rank
  // order (the barrier orders the remote stores above before rank 0's
  // reads; no block reads another's shared memory after it, so none waits
  // to leave); each block's d(dt) share, and the forced arm's three more
  cluster.sync();
  if (threadIdx.x == 0) a.ddt_part[blockIdx.x] = share_total(red);
  if (kForced)
    write_forcing_shares(red, a.ddt_part + blockIdx.x, a.n_shares, s_lin, s_quad, s_rayl,
                         static_cast<double>(a.dt));
  if (rank != 0) return;
  const T ds_scale = grav * a.dt * a.inv_dc;
  for (int e = threadIdx.x; e < 2 * core; e += blockDim.x) {
    const int p = e >= core ? 1 : 0, x = e - p * core;
    const int r = by_ct.div(x), c = by_ct.mod(x, r);
    const int gm = tm * a.rt + r, gi = ti * a.ct + c;
    if (gm >= a.ny2 || gi >= a.nx) continue;
    T v = recv[e];
    for (int rr = 1; rr < n_ranks; ++rr) v += recv[rr * 2 * core + e];
    a.ds[p * plane + gm * a.nx + gi] = ds_scale * v;
  }
}

template <typename T, bool kMasked, bool kForced, bool kTracers, bool kStrat>
int prepare(int max_smem) {
  static bool done = false;
  if (done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(adjoint_step_kernel<T, kMasked, kForced, kTracers, kStrat>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  done = e == cudaSuccess;
  return static_cast<int>(e);
}

// The warps' d(dt) sums, a window's primal and cotangent chunks, its ssh,
// gs and f_edge and sites, the ranks' partial sums, and the masked arm's
// live bits, reserved by the periodic arm too so that one plan serves both;
// the forced arm's winds and packed levels beyond, or the stratified arm's
// S chunk and W rows at k levels (strat_k > 0); the tracer arm's chunks of
// n_tr tracers' primal and cotangent planes (kernels/adjoint_step.
// smem_bytes mirrors this).
size_t smem_bytes(long long sites, int core, int kc, int n_ranks, size_t itemsize,
                  bool forced, int n_tr, int strat_k) {
  return sizeof(double) * kRedDoubles + step_smem_bytes(sites, kc, 2, kPlanes, itemsize) +
         itemsize * static_cast<size_t>(n_ranks) * 2 * core +
         sizeof(int) * static_cast<size_t>(sites) +
         (forced ? forcing_smem_bytes(sites, 0, itemsize) : 0) +
         (strat_k > 0 ? strat_adj_smem_bytes(core, kc, strat_k, itemsize) : 0) +
         itemsize * static_cast<size_t>(sites) * 2 * 2 * n_tr * kc;
}

// One call's launch set-up: the plan, the resolved stencil, the shared memory.
template <typename T>
struct AdjPlan {
  AdjArgs<T> a;
  AdjTaps<T> tp;
  int n_ranks, n_tiles, max_smem;
  size_t smem;
};

template <typename T>
int make_plan(AdjPlan<T>* pl, const T* f_edge, const int* live, const ForcingArgs<T>& fc,
              T* dwind, const AdjTracers<T>& at, const AdjStrat<T>& st, const int* table,
              const double* weights, double dt, double inv_dc, double s_div, int ny2, int nx,
              int k, int n_steps, int n_terms, int rt, int ct, bool vec) {
  if (!valid_shape(ny2, nx, k, n_steps, n_terms) || table[0] != n_terms)
    return cudaErrorInvalidValue;
  if (rt < 1 || ct < 1 || rt > ny2 || ct > nx) return cudaErrorInvalidValue;
  // the tracer arm: at least one tracer, the cell mask with the live bits
  if (at.tr != nullptr && (at.n < 1 || (live == nullptr) != (at.cmask == nullptr)))
    return cudaErrorInvalidValue;
  int hm = 0, hi = 0;
  adjoint_reach(table, &hm, &hi);
  const int kc = step_chunk(k);
  const int Wi = ct + 2 * hi, W = (rt + 2 * hm) * Wi;
  pl->n_ranks = (k + kc - 1) / kc;
  if (!resolve_adjoint_taps<T>(&pl->tp, table, weights, Wi, W, kc)) return kNotHexTable;
  int e = opt_in_smem(&pl->max_smem);
  if (e != 0) return e;
  pl->smem = smem_bytes(W, rt * ct, kc, pl->n_ranks, sizeof(T), fc.wind != nullptr,
                        at.tr != nullptr ? at.n : 0, st.w != nullptr ? k : 0);
  if (pl->smem > static_cast<size_t>(pl->max_smem)) return cudaErrorInvalidValue;
  const int n_ti = (nx + ct - 1) / ct;
  pl->n_tiles = ((ny2 + rt - 1) / rt) * n_ti;
  pl->a = AdjArgs<T>{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, f_edge, live,
                     nullptr, nullptr, nullptr, nullptr, fc, dwind, at, st, T(dt), T(inv_dc),
                     T(s_div),
                     ny2, nx, k, rt, ct, hm, hi, log2_exact(kc),
                     vec ? log2_exact(kc * static_cast<int>(sizeof(T)) / 16) : -1, n_ti,
                     static_cast<long long>(n_steps) * pl->n_tiles * pl->n_ranks};
  return 0;
}

// The kernel of a plan, and its attribute: masked or not, and any
// combination of forced, tracers and stratified.
template <typename T>
using AdjKernel = void (*)(AdjArgs<T>, AdjTaps<T>);
template <typename T>
struct AdjArm {
  AdjKernel<T> kernel;
  int (*prepare)(int);
};
template <typename T, bool kMasked, bool kForced, bool kTracers, bool kStrat>
constexpr AdjArm<T> arm() {
  return {adjoint_step_kernel<T, kMasked, kForced, kTracers, kStrat>,
          prepare<T, kMasked, kForced, kTracers, kStrat>};
}
template <typename T, bool kMasked>
AdjArm<T> arm_of(bool forced, bool tracers, bool strat) {
  static const AdjArm<T> arms[8] = {
      arm<T, kMasked, false, false, false>(), arm<T, kMasked, false, false, true>(),
      arm<T, kMasked, false, true, false>(),  arm<T, kMasked, false, true, true>(),
      arm<T, kMasked, true, false, false>(),  arm<T, kMasked, true, false, true>(),
      arm<T, kMasked, true, true, false>(),   arm<T, kMasked, true, true, true>()};
  return arms[(forced ? 4 : 0) + (tracers ? 2 : 0) + (strat ? 1 : 0)];
}
template <typename T>
AdjArm<T> arm_of(bool masked, bool forced, bool tracers, bool strat) {
  return masked ? arm_of<T, true>(forced, tracers, strat)
                : arm_of<T, false>(forced, tracers, strat);
}

template <typename T>
int launch_arm(AdjKernel<T> kernel, const AdjPlan<T>& pl, cudaStream_t stream) {
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = step_config(pl.n_ranks, pl.n_tiles, pl.smem, stream, attr);
  cudaError_t le = cudaLaunchKernelEx(&cfg, kernel, pl.a, pl.tp);
  if (le == cudaSuccess) le = cudaGetLastError();
  return static_cast<int>(le);
}

// n_steps reverse steps. The primal state of step j lies in slot j of the
// stacks (ssh (n, 2, ny2, nx), h (n, 2, ny2, nx, K), u (n, 6, ny2, nx, K));
// the cotangent at step n_steps comes in `g_in` and the one at step 0 goes
// out in `g_out`, through `g_tmp` as in fe_step.cu's fe_steps; `g_in` is left
// as it is. `part` holds n_steps * tiles * ranks doubles (kShares times as
// many for the forced arm); d(dt) of the n_steps steps is added to ddt[0],
// and the forced arm's d(wind) to dwind and d(r_lin, Cd, lambda) to
// dcoef[0 .. 2]. The tracer arm (at.tr the tracer stack (n, 2 nT, ny2, nx,
// K)) takes its cotangent in at.gtr and out in gtr_out through gtr_tmp
// alike, and reads h' and T' of step j from slot j + 1, and for the last
// step from h_end and tr_end. The stratified arm (st.w the W) keeps the
// tiles' d(W) in st.acc (tiles * K * K doubles) and adds their sum to
// dstrat (K, K).
template <typename T>
int adjoint_rollout(const T* f_edge, const int* live, const ForcingArgs<T>& fc, T* dwind,
                    double* dcoef, AdjTracers<T> at, T* gtr_out, T* gtr_tmp, const T* h_end,
                    const T* tr_end, AdjStrat<T> st, double* dstrat, const int* table,
                    const double* weights, const T* ssh_st,
                    const T* h_st, const T* u_st, const T* gs_in, const T* gh_in,
                    const T* gu_in, T* gs_out, T* gh_out, T* gu_out, T* gs_tmp, T* gh_tmp,
                    T* gu_tmp, double* part, double* ddt, double dt, double inv_dc,
                    double s_div, int ny2, int nx, int k, int n_steps, int n_terms, int rt,
                    int ct, cudaStream_t stream) {
  const int kc = step_chunk(k);
  const bool tracers = at.tr != nullptr;
  const bool vec = vector_loads(k, kc, sizeof(T), h_st, u_st) &&
                   vector_loads(k, kc, sizeof(T), gh_in, gu_in) &&
                   vector_loads(k, kc, sizeof(T), gh_out, gu_out) &&
                   vector_loads(k, kc, sizeof(T), gh_tmp, gu_tmp) &&
                   (!tracers || (vector_loads(k, kc, sizeof(T), at.tr, at.gtr) &&
                                 vector_loads(k, kc, sizeof(T), gtr_out, gtr_tmp)));
  AdjPlan<T> pl;
  int err = make_plan(&pl, f_edge, live, fc, dwind, at, st, table, weights, dt, inv_dc, s_div,
                      ny2, nx, k, n_steps, n_terms, rt, ct, vec);
  if (err != 0) return err;
  const bool masked = live != nullptr, forced = fc.wind != nullptr, strat = st.w != nullptr;
  const AdjArm<T> arm = arm_of<T>(masked, forced, tracers, strat);
  if ((err = arm.prepare(pl.max_smem)) != 0) return err;
  const size_t cells = 2ULL * ny2 * nx;
  const size_t hs = cells * k, us = 3 * cells * k, trs = tracers ? at.n * hs : 0;
  const size_t shares = static_cast<size_t>(pl.n_tiles) * pl.n_ranks;
  const T *gs = gs_in, *gh = gh_in, *gu = gu_in, *gt = at.gtr;
  for (int s = 0; s < n_steps; ++s) {
    const size_t j = n_steps - 1 - s;
    const bool to_out = ((n_steps - 1 - s) & 1) == 0;
    AdjArgs<T>& a = pl.a;
    a.ssh = ssh_st + j * cells, a.h = h_st + j * hs, a.u = u_st + j * us;
    a.gs = gs, a.gh = gh, a.gu = gu;
    a.ds = to_out ? gs_out : gs_tmp;
    a.dh = to_out ? gh_out : gh_tmp;
    a.du = to_out ? gu_out : gu_tmp;
    a.ddt_part = part + s * shares;
    a.st.first = s == 0;
    if (tracers) {
      const bool last = static_cast<int>(j) + 1 == n_steps;
      a.at.tr = at.tr + j * trs, a.at.gtr = gt;
      a.at.h_next = last ? h_end : h_st + (j + 1) * hs;
      a.at.tr_next = last ? tr_end : at.tr + (j + 1) * trs;
      a.at.dtr = to_out ? gtr_out : gtr_tmp;
      gt = a.at.dtr;
    }
    if ((err = launch_arm(arm.kernel, pl, stream)) != 0) return err;
    gs = a.ds, gh = a.dh, gu = a.du;
  }
  if (n_steps == 0) return 0;
  err = reduce_shares(part, pl.a.n_shares, ddt, forced ? dcoef : nullptr, stream);
  if (err == 0 && strat) err = strat_reduce(st.acc, pl.n_tiles, k, dstrat, stream);
  return err;
}

}  // namespace

// Returns 0, kNotHexTable for a transposed table that is not the hex
// lattice's, or the CUDA error of the first launch that failed
// (cudaErrorInvalidValue for a tile the card does not take). `table` and
// `weights` are host copies of the TRANSPOSED stencil; rt x ct is the tile;
// a null `live` (the wall mask's live bits, one int per site) runs the
// periodic arm, any other the masked one; a null `wind` the unforced arm,
// any other the forced one with `lvl`, the coefficients, and the
// accumulators `dwind` (6, ny2, nx) and `dcoef` (3 doubles); a null `tr_st`
// the tracer-free arm, any other the tracer arm with n_tr tracers (the
// tracer stack `tr_st` (n, 2 n_tr, ny2, nx, k), the cotangent planes
// `gtr_in`, `gtr_out`, `gtr_tmp`, the state after the stack's last slot
// `h_end`, `tr_end`, the live-cell mask `cmask` (non-null exactly when `live`
// is), kappa and upwind); a null `strat_w` the unstratified arm, any other
// (W, (k, k) row-major) the stratified one with the tiles' accumulators
// `dw_acc` (tiles * k * k doubles) and d(W) `dstrat` (k * k doubles, added
// to); the forced, tracer and stratified arms in any combination.
#define MOT_ADJOINT_ENTRY(T, SUFFIX)                                                          \
  extern "C" int mot_adjoint_rollout_##SUFFIX(                                                \
      const T* f_edge, const int* live, const T* wind, const int* lvl, T* dwind,              \
      double* dcoef, const int* table, const double* weights, const T* ssh_st,                \
      const T* h_st, const T* u_st, const T* gs_in, const T* gh_in, const T* gu_in,           \
      T* gs_out, T* gh_out, T* gu_out, T* gs_tmp, T* gh_tmp, T* gu_tmp, double* part,         \
      double* ddt, const T* tr_st, const T* gtr_in, T* gtr_out, T* gtr_tmp, const T* h_end,  \
      const T* tr_end, const T* cmask, const T* strat_w, double* dw_acc, double* dstrat,     \
      double dt, double inv_dc, double s_div, double dlin, double dquad, double rayl,         \
      double kappa, double upwind, int lvl_ranks, int wind_ranks, int ny2, int nx, int k,     \
      int n_steps, int n_terms, int rt, int ct, int n_tr, void* stream) {                     \
    const ForcingArgs<T> fc{wind, lvl, T(dlin), T(dquad), T(rayl),                            \
                            static_cast<unsigned>(lvl_ranks), static_cast<unsigned>(wind_ranks)}; \
    const AdjTracers<T> at{tr_st, gtr_in, nullptr, nullptr, cmask, nullptr, T(kappa),         \
                           T(0.5 * upwind), n_tr};                                            \
    const AdjStrat<T> st{strat_w, dw_acc, 1};                                                 \
    return adjoint_rollout<T>(f_edge, live, fc, dwind, dcoef, at, gtr_out, gtr_tmp, h_end,    \
                              tr_end, st, dstrat, table, weights, ssh_st, h_st, u_st, gs_in,  \
                              gh_in, gu_in, gs_out, gh_out, gu_out, gs_tmp, gh_tmp, gu_tmp,   \
                              part, ddt, dt, inv_dc, s_div, ny2, nx, k, n_steps, n_terms, rt, \
                              ct,                                                             \
                              static_cast<cudaStream_t>(stream));                             \
  }

// adjoint_step_f64.cu compiles this file with MOT_ADJOINT_STEP_F64 for the
// f64 entry, so that the two dtypes' instantiations compile in parallel.
#ifdef MOT_ADJOINT_STEP_F64
MOT_ADJOINT_ENTRY(double, f64)
#else
MOT_ADJOINT_ENTRY(float, f32)

// The launch adjoint_step makes for an rt x ct tile of an ny2 x nx x k f32
// lattice with the transposed stencil `table` (a host copy), with n_tr
// tracers (the periodic tracer arm), stratified (strat nonzero: the periodic
// stratified arm) or neither: out[0] the clusters (one per tile), out[1]
// the blocks per SM, out[2] one block's dynamic shared memory in bytes.
// Returns 0, kNotHexTable or the CUDA error.
extern "C" int mot_adjoint_plan(const int* table, int ny2, int nx, int k, int rt, int ct,
                                int n_tr, int strat, int* out) {
  double weights[kMaxTerms] = {};
  AdjPlan<float> pl;
  static const float dummy = 0.0f;
  AdjTracers<float> at{};
  if (n_tr > 0) at.tr = &dummy, at.n = n_tr;
  const AdjStrat<float> st{strat ? &dummy : nullptr, nullptr, 1};
  int e = make_plan<float>(&pl, nullptr, nullptr, ForcingArgs<float>{}, nullptr, at, st, table,
                           weights, 1.0, 1.0, 1.0, ny2, nx, k, 1, table[0], rt, ct, true);
  if (e != 0) return e;
  const AdjArm<float> arm = arm_of<float>(false, false, n_tr > 0, strat != 0);
  if ((e = arm.prepare(pl.max_smem)) != 0) return e;
  out[0] = pl.n_tiles;
  out[2] = static_cast<int>(pl.smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], arm.kernel, kStepThreads, pl.smem));
}
#endif  // MOT_ADJOINT_STEP_F64
