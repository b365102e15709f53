// Tiled, temporally blocked rollout of the linear TRiSK shallow-water core on
// the parity-plane hex lattice, forward Euler (FE) or forward-backward (FB),
// for NVIDIA Hopper (sm_90a).
//
// Replaces: _tiled_step_kernel (mpas_ocean_tpu/structured/pallas_model.py:852),
// the arms with the nonlinear terms off, halos read from the state (the
// single-chip rollout) or received from the neighbour slabs (the sharded
// superstep, structured/sharded.py:1640-1886, whose outermost halo blocks
// arrive by ppermute), periodic (masks off) and masked (a coastal channel culled from
// a periodic lattice: the mask operands of :875-877, 1287-1288, windowed as
// f_edge), unforced and forced (the wind and the level-index operands),
// without tracers and with them (the tracer and cell-mask operands of
// :892-946, 1180-1190), unstratified and stratified (the strat_w operand of
// :904-908, 1193-1194), the three in any combination. One launch
// advances the whole
// lattice by q steps of _window_steps (:802); the exported entry loops
// n_steps / q launches on the caller's stream.
//
// Layout (all contiguous, K innermost), as in fe_step.cu:
//   ssh (2, ny2, nx)   h (2, ny2, nx, K)   u (6, ny2, nx, K), channel f*2+p
//   f_edge (6, ny2, nx)   rts (2, ny2, nx)   live (ny2, nx) int, or null;
//   stencil table as in lattice.cuh. With received halos (ro = hm * q > 0)
//   every lattice operand holds ny2 + 2 ro rows instead, the slab's ny2
//   after ro halo rows (step_window.cuh, buffer_plane): the windows read
//   them unwrapped, and a launch writes the slab's ny2 rows of its outputs
//   and leaves their halo rows as they are, for the exchange to fill.
//
// Design. The lattice is cut into rt x ct tiles of sites. A tile's window
// is the tile plus q halos of (hm, hi) sites per side, hm = 1 (FE) or 2 (FB)
// rows and hi = 2 columns (slab.stencil_reach). Step j computes on the
// window less (j + 1) halos per side, so after q steps the tile's core is
// left. A site holds 8 values (2 h, 6 u) per level, so the levels are split
// over a thread-block cluster of up to 8 blocks (chunks of kc levels, a
// power of two; step_window.cuh). Levels couple only through the
// column sum ssh = sum_k h - rts: once per step each block writes its
// partial column sums, and after cluster.sync every block adds the ranks'
// partials in rank order through distributed shared memory. No atomics, so
// f64 reruns are bitwise equal. A tile reads its neighbours' pre-step sites,
// so nothing is updated in place: the entry ping-pongs between the output
// and a scratch set, as fe_step.cu does.
//
// What bound the first design (PERF.md): 11% of the byte bound at
// 256x256x100 f32 FB. Two window copies even at q = 1 (217 KB for the FB
// (8, 16) window) left one 512-thread block per SM; the window came in by
// one 4-byte cp.async per value behind two run-time divisions; every
// Coriolis tap was a 16-byte shared-memory load per edge-level.
//
// This design:
// - q = 1 keeps one window copy: the last step writes the core's new h and
//   u straight to the output buffers, and FB's momentum needs only the
//   fresh ssh, which stays in the small ssh planes. q > 1 keeps two copies.
// - Level chunks are powers of two (16 levels at K = 100), so every index
//   splits by shifts and masks, and where K * itemsize allows, each (site,
//   plane) chunk moves by 16-byte cp.async, neighbouring threads on
//   neighbouring vectors.
// - The stencil is resolved once per call on the host into a kernel
//   parameter (StepTaps), so every offset and weight is a constant-bank
//   operand, not a shared-memory load, and each of the 25 u and 10 h
//   values a cell-level reads is loaded once and each u * f product formed
//   once (step_window.cuh, hex::): the kernel takes the hex lattice's table
//   only, and its entry refuses any other.
// - The planner takes the largest tile whose window leaves room for a
//   second 512-thread block on the SM ((8, 8) for FB at K = 100 f32;
//   tiled_model.tile_plan), so one block's load overlaps the other's work.
// - Groups of min(16, kc) lanes take consecutive levels of one site:
//   conflict-free shared-memory reads, coalesced stores (64 bytes per group
//   in f32 at K = 100), and the block's partial column sum is a shuffle
//   over the group in a fixed order. The ranks' partials are read from
//   distributed shared memory all at once and then added in rank order.
// - Launches are programmatically dependent (step_window.cuh): the next
//   launch is scheduled while this one's last wave runs.
// Measured share of the byte bound (f32 FB, NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md section 5): 20% at 64x64x100 (19.7 us/step against 3.94) and 23%
// at 256x256x100 (276.5 against 63.1; 37% of the bound with the plan's halo
// reads and ring recompute).
//
// The masked arm (kMasked, chosen by non-null live bits; the periodic arm
// keeps its code) stages the wall mask as one int of live bits per window
// site with f_edge (step_window.cuh, load_live), holds a site's in one
// register through the level loop of each momentum update and writes u' = 0
// on masked channels, at every step of the window: FB takes h first with the
// old u, then u with the fresh ssh, and the mask last (pallas_model.py:
// 148-153, 257-259).
//
// The forced arm (kForced, chosen by a non-null wind; the unforced arm keeps
// its code), at every step of the window, adds dt F of the old u and the old
// h_edge to u' after the base update and before the wall mask (_step_slab's
// order, FE and FB alike: the forcing reads the old state even where FB's
// pressure gradient reads the fresh ssh): Rayleigh at every edge-level in the
// body, then the wind and drag at an edge's top and bottom level only, where
// alone the old h of the step's window copy is read and 1 / h_edge formed,
// in a pass of the ranks whose chunk holds such levels over the step's edges
// (step_window.cuh, ForcingArgs, wind_drag_pass).
//
// The tracer arm (kTracers, chosen by a non-null tracer pointer; the
// tracer-free arms keep their code) carries the block's chunk of the 2 nT
// tracer planes in each window copy after the 8 state planes, and at every
// step updates them where continuity updates h, on the same shrinking
// rings, in the lane group that forms the site's h': the tracer flux of
// the old state's six edge fluxes, FE and FB alike (FB's fresh ssh feeds
// only the momentum), over the fresh h' (step_window.cuh, tracer_step). On a
// channel the live-cell mask is read per window site from device memory.
// Measured (f32 FB, two tracers, NVIDIA H100 80GB HBM3 at 700 W; PERF.md
// section 5): 526.9 us/step at 256x256x100, x1.88 the tracer-free step: the
// tracer planes halve the two-block tile to (4, 8).
//
// The stratified arm (kStrat, chosen by a non-null W; the unstratified arms
// keep their code), at every step of the
// window, forms the Montgomery potential Phi = g ssh + h @ W at the block's
// levels on the momentum update's region grown by the gradient's reach
// (step_window.cuh, StratSmem, montgomery), after the column sums' barrier,
// and takes each level's pressure gradient from it with scale -dt. FE reads
// the window copy's old h and ssh. FB reads the fresh h' and ssh' of the
// continuity update: continuity also writes h'
// into a buffer of its own (StratSmem::fresh), because at the last step,
// and always at q = 1, h' goes only to the output, and there is no second
// window copy at q = 1. The ranks read each other's h, so a cluster barrier
// follows each step's Phi: without it, step j + 1's continuity could write
// the ping-pong copy (FE) or the fresh h' (FB) that a slower rank is still
// reading for step j's Phi. A barrier was chosen over a third buffer: it
// costs one cluster barrier per step and no shared memory.
//
// The arms compose (every combination of kForced, kTracers and kStrat is an
// instantiation), as in fe_step.cu: each window copy carries the tracer
// planes beside the state's, the stratified arm keeps its Phi, staging, W
// slice and (FB) fresh h' after the unforced layout, and the forced arm its
// winds and levels after those; the forcing and the tracers read the step's
// old window copy, which neither Phi nor the fresh h' overwrites.

#include "step_window.cuh"

namespace {

using namespace lattice;

constexpr int kPlanes = 16;  // ssh [2][2], partial sums [2][2], f_edge [6], rts [2]

template <typename T>
struct StepArgs {
  const T* ssh;
  const T* h;
  const T* u;
  const T* f_edge;
  const T* rts;
  const int* live;  // the masked arm's live bits, (ny2, nx); null otherwise
  T* ssh_out;
  T* h_out;
  T* u_out;
  ForcingArgs<T> fc;  // the forced arm's operands; wind null otherwise
  TracerArgs<T> tr;   // the tracer arm's operands; tr null otherwise
  const T* strat_w;   // the stratified arm's W (K, K); null otherwise
  NbrReach nr;        // the gradient's reach, which grows the momentum region to Phi's
  T dt, inv_dc, s_div;
  int ny2, nx, K, rt, ct, q, hm, hi, kc_log2, vec_log2, n_tiles_i;
  int ro;  // received halo rows per side (step_window.cuh, buffer_plane); 0 periodic
};

// Each distinct u and h value of a (site, level) is loaded once and each
// u * f product formed once (step_window.cuh, hex::).
template <typename T, bool FB, bool kMasked, bool kForced, bool kTracers, bool kStrat>
__global__ void __launch_bounds__(kStepThreads, 2)
    tiled_step_kernel(const StepArgs<T> a, const StepTaps<T> tp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int tile = blockIdx.x / n_ranks;
  const int tm = tile / a.n_tiles_i, ti = tile % a.n_tiles_i;
  const int Wm = a.rt + 2 * a.hm * a.q, Wi = a.ct + 2 * a.hi * a.q, W = Wm * Wi;
  const int kc = 1 << a.kc_log2, k0 = rank * kc, kr = min(kc, a.K - k0);
  const int plane = buffer_plane(a.ny2, a.nx, a.ro);
  const int pk = W * kc;  // one plane of a level chunk
  const int K = a.K;

  // planes per window copy: the state's 8, and the tracer arm's after them
  const int n_pl = kTracers ? 8 + 2 * a.tr.n : 8;
  T* buf = reinterpret_cast<T*>(smem_raw);  // [copies][n_pl][W][kc]: h p0, h p1, u c0..c5, tracers
  T* ssh_s = buf + (a.q > 1 ? 2 : 1) * n_pl * pk;  // [2][2][W], by step parity
  T* part = ssh_s + 4 * W;                   // [2][2][W], by step parity
  T* f_s = part + 4 * W;                     // [6][W]
  T* rts_s = f_s + 6 * W;                    // [2][W]
  int* gs = reinterpret_cast<int*>(rts_s + 2 * W);  // [W]: lattice site
  int* live_s = gs + W;                              // [W]: the masked arm's live bits
  const StratSmem<T> ssm(live_s + W, W, kc, K);      // the stratified arm's
  // the forced arm's winds and levels, after the stratified arm's
  const ForcingSmem<T> fsm(kStrat ? ssm.end(W, kc, FB) : static_cast<void*>(live_s + W), W, 0);

  allow_next_grid();
  const int m_base = tm * a.rt - a.hm * a.q, i_base = ti * a.ct - a.hi * a.q;
  window_sites(gs, m_base, i_base, Wi, W, a.ny2, a.nx, a.ro);
  __syncthreads();
  wait_previous_grid();
  load_consts(f_s, rts_s, gs, a.f_edge, a.rts, W, plane);
  load_state(buf, ssh_s, gs, a.ssh, a.h, a.u, W, a.kc_log2, a.vec_log2, k0, kr, K, plane);
  if (kMasked) load_live(live_s, gs, a.live, W);
  if (kForced) load_forcing(fsm, gs, a.fc, W, plane, rank);
  if (kTracers)
    load_tracers(buf + 8 * pk, gs, a.tr.tr, 2 * a.tr.n, W, a.kc_log2, a.vec_log2, k0, kr, K,
                 plane);
  if (kStrat) load_strat_w(ssm.wsl, a.strat_w, K, k0, kr, a.kc_log2);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const T dt_div = a.dt * a.s_div;
  const T pg_scale = kStrat ? -a.dt : T(-kGravity) * a.dt;
  const T dt_rayl = a.dt * a.fc.rayl;  // the forced arm's Rayleigh factor
  // the forced arm: whether this block's chunk holds some edge's top or
  // bottom level (then its window's levels are staged and its pass runs)
  const bool wd = kForced && ((a.fc.lvl_ranks >> rank) & 1u);
  // groups of G = min(16, kc) lanes, one site each, 32 / G sites per warp
  const int g_log2 = min(a.kc_log2, kLanesLog2), G = 1 << g_log2;
  const int lane = threadIdx.x & (G - 1), sub = (threadIdx.x & 31) >> g_log2;
  const int warp_sites = 32 >> g_log2;
  const int site_stride = static_cast<int>(blockDim.x >> 5) * warp_sites;
  const int r_core = a.hm * a.q, c_core = a.hi * a.q;
  for (int j = 0; j < a.q; ++j) {
    const bool last = j == a.q - 1;
    const T* cur = buf + (j & 1) * n_pl * pk;
    T* nxt = buf + ((j + 1) & 1) * n_pl * pk;  // read only when q > 1
    const T* ssh_cur = ssh_s + (j & 1) * 2 * W;
    T* ssh_nxt = ssh_s + ((j + 1) & 1) * 2 * W;
    // A rank writes this parity's partial sums again two steps on, past the
    // next barrier, which every rank reaches only once it has read them.
    T* part_j = part + (j & 1) * 2 * W;

    // continuity: h' on the window less j halos and one ring (FB: the
    // pressure gradient reads the fresh ssh one ring out) or j + 1 halos
    // (FE); the block's partial column sums. The last step writes the
    // core's h' to the output, earlier ones the next window copy.
    const int hr0 = FB ? a.hm * j + 1 : a.hm * (j + 1);
    const int hc0 = FB ? a.hi * j + 1 : a.hi * (j + 1);
    const int hnc = Wi - 2 * hc0, hn = (Wm - 2 * hr0) * hnc;
    const FastDiv by_hnc(hnc);
    for (int base = static_cast<int>(threadIdx.x >> 5) * warp_sites; base < hn;
         base += site_stride) {
      const int t = base + sub;
      const bool valid = t < hn;
      const int tt = valid ? t : base;
      const int r = by_hnc.div(tt), c = by_hnc.mod(tt, r);
      const int s = (hr0 + r) * Wi + hc0 + c;
      const int cr = hr0 + r - r_core, cc = hc0 + c - c_core;
      const bool out = last && cr >= 0 && cr < a.rt && cc >= 0 && cc < a.ct;
      const int g = buffer_site(tm * a.rt + cr, ti * a.ct + cc, a.nx, a.ro);
      // the tracer arm's live bits and live-cell mask of the site (a channel's)
      T cm[2] = {T(1), T(1)};
      unsigned live = 0u, inc_live = 0u;
      if (kTracers && kMasked && valid) {
        live = static_cast<unsigned>(live_s[s]);
        inc_live = incoming_live(live_s, s, a.tr);
        cm[0] = a.tr.cmask[gs[s]], cm[1] = a.tr.cmask[plane + gs[s]];
      }
      T acc0 = T(0), acc1 = T(0);
      for (int kl = lane; kl < kc; kl += G) {
        if (!valid || kl >= kr) continue;
        const int b = s * kc + kl;
        const T* lv = cur + b;
        T hnew[2];
        constexpr int kU = 11;  // the sources continuity reads: own and incoming edges
        T u[kU], h[hex::kH];
#pragma unroll
        for (int i = 0; i < kU; ++i) u[i] = lv[tp.us[i]];
#pragma unroll
        for (int i = 0; i < hex::kH; ++i) h[i] = lv[tp.hs[i]];
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const T hc = h[hex::self_h(p)];
          T total = T(0);
#pragma unroll
          for (int f = 0; f < 3; ++f) {
            const int ch = f * 2 + p;
            const T fl = u[hex::self_u(ch)] * (T(0.5) * (h[hex::nb_h(ch)] + hc));
            total = (f == 0) ? fl : total + fl;
          }
#pragma unroll
          for (int x = 3 * p; x < 3 * p + 3; ++x) {
            const T he = T(0.5) * (h[hex::inc_nb_h(x)] + h[hex::inc_self_h(x)]);
            total = total - u[hex::inc_u(x)] * he;
          }
          hnew[p] = hc - dt_div * total;
        }
        acc0 += hnew[0];
        acc1 += hnew[1];
        if (kStrat && FB) {  // the fresh h' that Phi reads
          ssm.fresh[b] = hnew[0];
          ssm.fresh[pk + b] = hnew[1];
        }
        if (!last) {
          nxt[b] = hnew[0];
          nxt[pk + b] = hnew[1];
        } else if (out) {
          a.h_out[g * K + k0 + kl] = hnew[0];
          a.h_out[(plane + g) * K + k0 + kl] = hnew[1];
        }
        if (kTracers && (!last || out))
          tracer_step<T, kMasked>(lv, pk, tp, u, h, hnew, cm, live, inc_live, a.tr, dt_div,
                                  a.inv_dc, [&](int i, T v) {
                                    if (!last)
                                      nxt[(8 + i) * pk + b] = v;
                                    else
                                      a.tr.tr_out[(i * plane + g) * K + k0 + kl] = v;
                                  });
      }
      acc0 = group_sum(acc0, G);
      acc1 = group_sum(acc1, G);
      if (valid && lane == 0) {
        part_j[s] = acc0;
        part_j[W + s] = acc1;
      }
    }

    // ssh' = sum_k h' - rts: the cluster's partial sums in rank order (all
    // ranks' values are loaded before the first add, so the remote loads
    // overlap)
    cluster.sync();
    for (int e = threadIdx.x; e < 2 * hn; e += blockDim.x) {
      const int p = e >= hn ? 1 : 0, t = e - p * hn;
      const int r = by_hnc.div(t), c = by_hnc.mod(t, r);
      const int x = p * W + (hr0 + r) * Wi + hc0 + c;
      T v[kMaxCluster];
#pragma unroll
      for (int rr = 0; rr < kMaxCluster; ++rr)
        if (rr < n_ranks) v[rr] = *cluster.map_shared_rank(part_j + x, rr);
      T sum = v[0];
#pragma unroll
      for (int rr = 1; rr < kMaxCluster; ++rr)
        if (rr < n_ranks) sum += v[rr];
      ssh_nxt[x] = sum - rts_s[x];
    }
    __syncthreads();

    // the momentum update's region: the window less j + 1 halos
    const int ur0 = a.hm * (j + 1), uc0 = a.hi * (j + 1);
    if (kStrat) {
      // Phi of the old state (FE) or of the fresh one (FB) on the momentum
      // region grown by the gradient's reach (inside the window less j
      // halos, FE, and the continuity region, FB), then the barrier that
      // keeps the next step's writes from the h being read here
      montgomery(ssm, cluster, FB ? ssm.fresh : cur, FB ? ssh_nxt : ssh_cur, ur0 + a.nr.m0,
                 Wm - ur0 + a.nr.m1, uc0 + a.nr.i0, Wi - uc0 + a.nr.i1, Wi, W, a.kc_log2, kr, K,
                 rank, n_ranks);
      cluster.sync();
    }

    // momentum: u' = u + dt * (TRiSK Coriolis of u * f) + pg_scale * grad,
    // grad of the old ssh (FE) or the fresh one (FB), on the window less
    // j + 1 halos (the core at the last step); the stratified arm's grad of
    // each level's Phi
    const T* pg = FB ? ssh_nxt : ssh_cur;
    const int unc = Wi - 2 * uc0, un = (Wm - 2 * ur0) * unc;
    const FastDiv by_unc(unc);
    for (int t = threadIdx.x >> g_log2; t < un; t += blockDim.x >> g_log2) {
      const int r = by_unc.div(t), c = by_unc.mod(t, r);
      const int s = (ur0 + r) * Wi + uc0 + c;
      // the core's site (last step)
      const int g = buffer_site(tm * a.rt + r, ti * a.ct + c, a.nx, a.ro);
      T grad[6];
      if (!kStrat) {
#pragma unroll
        for (int ch = 0; ch < 6; ++ch)
          grad[ch] = (pg[s + tp.nb[ch]] - pg[(ch & 1) * W + s]) * a.inv_dc;
      }
      const unsigned live = kMasked ? static_cast<unsigned>(live_s[s]) : 0u;
      for (int kl = lane; kl < kr; kl += G) {
        const int b = s * kc + kl;
        if (kStrat) {
          const T* ph = ssm.phi + b;
#pragma unroll
          for (int ch = 0; ch < 6; ++ch)
            grad[ch] = (ph[tp.nb[ch] << a.kc_log2] - ph[(ch & 1) * pk]) * a.inv_dc;
        }
        T v[6];
        T u[hex::kU];
#pragma unroll
        for (int i = 0; i < hex::kU; ++i) u[i] = cur[b + tp.us[i]];
        T uf[hex::kU];
#pragma unroll
        for (int i = 0; i < hex::kU; ++i) uf[i] = u[i] * f_s[s + tp.fs[i]];
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) {
          T acc = T(0);
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int t2 = 8 * ch + x;
            const T contrib = tp.w[t2] * uf[hex::tap_u(t2)];
            acc = (x == 0) ? contrib : acc + contrib;
          }
          v[ch] = u[hex::self_u(ch)] + a.dt * acc + pg_scale * grad[ch];
          if (kForced) v[ch] = v[ch] - dt_rayl * u[hex::self_u(ch)];
        }
        if (kMasked && live != kAllLive) {
#pragma unroll
          for (int ch = 0; ch < 6; ++ch)
            if (!((live >> ch) & 1u)) v[ch] = T(0);
        }
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) {
          if (last)
            a.u_out[(ch * plane + g) * K + k0 + kl] = v[ch];
          else
            nxt[(2 + ch) * pk + b] = v[ch];
        }
      }
    }
    __syncthreads();
    if (kForced && wd) {
      // the wind and drag at the step's edges' top and bottom levels in this
      // block's chunk, added to the stored u'
      wind_drag_pass<T, kMasked>(
          cur, tp, fsm, live_s, un,
          [&](int t) {
            const int r = by_unc.div(t);
            return (ur0 + r) * Wi + uc0 + by_unc.mod(t, r);
          },
          [&](int ch, int t, int s, int kl) -> T& {
            if (!last) return nxt[(2 + ch) * pk + s * kc + kl];
            const int r = by_unc.div(t), c = by_unc.mod(t, r);
            const int g = buffer_site(tm * a.rt + r, ti * a.ct + c, a.nx, a.ro);
            return a.u_out[(ch * plane + g) * K + k0 + kl];
          },
          W, kc, k0, kr, a.dt, a.fc);
      __syncthreads();
    }
  }

  // the tile's ssh, from rank 0
  if (rank == 0) {
    const T* ssh_fin = ssh_s + (a.q & 1) * 2 * W;
    const int core = a.rt * a.ct;
    const FastDiv by_ct(a.ct);
    for (int e = threadIdx.x; e < 2 * core; e += blockDim.x) {
      const int p = e >= core ? 1 : 0, x = e - p * core;
      const int r = by_ct.div(x), c = by_ct.mod(x, r);
      a.ssh_out[p * plane + buffer_site(tm * a.rt + r, ti * a.ct + c, a.nx, a.ro)] =
          ssh_fin[p * W + (r_core + r) * Wi + c_core + c];
    }
  }
  // no block may leave while another can still read its partial sums
  cluster.sync();
}

template <typename T, bool FB, bool kMasked, bool kForced, bool kTracers, bool kStrat>
int prepare(int max_smem) {
  static bool done = false;
  if (done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(tiled_step_kernel<T, FB, kMasked, kForced, kTracers, kStrat>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  done = e == cudaSuccess;
  return static_cast<int>(e);
}

template <typename T, bool FB, bool kMasked, bool kForced, bool kTracers, bool kStrat>
int launch(const StepArgs<T>& a, const StepTaps<T>& tp, int n_ranks, int n_tiles, size_t smem,
           cudaStream_t stream) {
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = step_config(n_ranks, n_tiles, smem, stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, tiled_step_kernel<T, FB, kMasked, kForced, kTracers, kStrat>, a, tp);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The window and, reserved by the periodic arm too so that one plan serves
// both, the masked arm's live bits; the forced arm's winds and packed levels
// beyond, or the stratified arm's Phi, staged h, W slice at k levels
// (strat_k > 0) and, for FB, the fresh h'; the tracer arm's 2 n_tr planes in
// each window copy (kernels/tiled_step.smem_bytes mirrors this).
size_t smem_bytes(long long sites, int kc, int q, size_t itemsize, bool forced, int n_tr,
                  int strat_k, bool fb) {
  return step_smem_bytes(sites, kc, q > 1 ? 2 : 1, kPlanes, itemsize) +
         sizeof(int) * static_cast<size_t>(sites) +
         (forced ? forcing_smem_bytes(sites, 0, itemsize) : 0) +
         (strat_k > 0 ? strat_smem_bytes(sites, kc, strat_k, itemsize, fb) : 0) +
         itemsize * static_cast<size_t>(sites) * 2 * n_tr * kc * (q > 1 ? 2 : 1);
}

template <typename T, bool FB, bool kMasked, bool kForced, bool kTracers, bool kStrat>
int run(StepArgs<T> a, const StepTaps<T>& tp, size_t smem, int n_ranks, int n_tiles,
        int n_steps, T* ssh_out, T* h_out, T* u_out, T* ssh_tmp, T* h_tmp, T* u_tmp,
        T* tr_out, T* tr_tmp, cudaStream_t stream) {
  int max_smem = 0;
  int err = opt_in_smem(&max_smem);
  if (err != 0) return err;
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  if ((err = prepare<T, FB, kMasked, kForced, kTracers, kStrat>(max_smem)) != 0) return err;
  const int n_launches = n_steps / a.q;
  for (int l = 0; l < n_launches; ++l) {
    const bool to_out = ((n_launches - 1 - l) & 1) == 0;
    a.ssh_out = to_out ? ssh_out : ssh_tmp;
    a.h_out = to_out ? h_out : h_tmp;
    a.u_out = to_out ? u_out : u_tmp;
    if (kTracers) a.tr.tr_out = to_out ? tr_out : tr_tmp;
    if ((err = launch<T, FB, kMasked, kForced, kTracers, kStrat>(a, tp, n_ranks, n_tiles,
                                                                 smem, stream)) != 0)
      return err;
    a.ssh = a.ssh_out, a.h = a.h_out, a.u = a.u_out;
    if (kTracers) a.tr.tr = a.tr.tr_out;
  }
  return 0;
}

// n_steps steps from `in` into `out`, q per launch. Launch l writes `out`
// when n_launches - 1 - l is even and `tmp` otherwise, so the last launch
// lands in `out`, no launch writes the buffers it reads, and `in` is left
// as it is. `table` and `weights` are host copies of the stencil.
template <typename T>
using RunFn = int (*)(StepArgs<T>, const StepTaps<T>&, size_t, int, int, int, T*, T*, T*, T*,
                      T*, T*, T*, T*, cudaStream_t);

// The instantiation of an arm: FE or FB, periodic or masked, and any
// combination of forced, tracers and stratified.
template <typename T, bool FB, bool kMasked>
RunFn<T> run_of_arm(bool forced, bool tracers, bool strat) {
  static const RunFn<T> runs[8] = {
      run<T, FB, kMasked, false, false, false>, run<T, FB, kMasked, false, false, true>,
      run<T, FB, kMasked, false, true, false>,  run<T, FB, kMasked, false, true, true>,
      run<T, FB, kMasked, true, false, false>,  run<T, FB, kMasked, true, false, true>,
      run<T, FB, kMasked, true, true, false>,   run<T, FB, kMasked, true, true, true>};
  return runs[(forced ? 4 : 0) + (tracers ? 2 : 0) + (strat ? 1 : 0)];
}
template <typename T>
RunFn<T> run_of(bool fb, bool masked, bool forced, bool tracers, bool strat) {
  return fb ? (masked ? run_of_arm<T, true, true>(forced, tracers, strat)
                      : run_of_arm<T, true, false>(forced, tracers, strat))
            : (masked ? run_of_arm<T, false, true>(forced, tracers, strat)
                      : run_of_arm<T, false, false>(forced, tracers, strat));
}

template <typename T>
int tiled_steps(const T* f_edge, const T* rts, const int* live, const ForcingArgs<T>& fc,
                TracerArgs<T> tr, T* tr_tmp, const T* strat_w, const int* table,
                const double* weights, const T* ssh_in, const T* h_in, const T* u_in,
                T* ssh_out, T* h_out, T* u_out, T* ssh_tmp, T* h_tmp, T* u_tmp, double dt,
                double inv_dc, double s_div, int ny2, int nx, int k, int n_steps, int n_terms,
                int rt, int ct, int q, int hm, int hi, int fb, int ro, cudaStream_t stream) {
  if (!valid_shape(ny2, nx, k, n_steps, n_terms) || table[0] != n_terms)
    return cudaErrorInvalidValue;
  if (rt < 1 || ct < 1 || q < 1 || hm < 1 || hi < 1 || ny2 % rt || nx % ct || n_steps % q)
    return cudaErrorInvalidValue;
  // received halos: the windows' q reaches of rows, and no more, around the slab
  if (ro != 0 && ro != hm * q) return cudaErrorInvalidValue;
  const bool tracers = tr.tr != nullptr;
  // the tracer arm: at least one tracer, the cell mask with the live bits
  if (tracers && (tr.n < 1 || (live == nullptr) != (tr.cmask == nullptr)))
    return cudaErrorInvalidValue;
  const bool strat = strat_w != nullptr;
  const int kc = step_chunk(k);
  const int n_ranks = (k + kc - 1) / kc;
  const int Wm = rt + 2 * hm * q, Wi = ct + 2 * hi * q;
  const long long sites = static_cast<long long>(Wm) * Wi;
  StepTaps<T> tp;
  if (!resolve_taps<T>(&tp, table, weights, Wi, static_cast<int>(sites), kc))
    return kNotHexTable;
  const bool vec = vector_loads(k, kc, sizeof(T), h_in, u_in) &&
                   vector_loads(k, kc, sizeof(T), h_out, u_out) &&
                   vector_loads(k, kc, sizeof(T), h_tmp, u_tmp) &&
                   (!tracers || (vector_loads(k, kc, sizeof(T), tr.tr, tr.tr_out) &&
                                 vector_loads(k, kc, sizeof(T), tr_tmp, tr_tmp)));
  T* tr_out = tr.tr_out;
  if (tracers) resolve_tracer_taps(&tr, table, Wi);
  const StepArgs<T> a{ssh_in, h_in, u_in, f_edge, rts, live, nullptr, nullptr, nullptr,
                      fc, tr, strat_w, nbr_reach(table), T(dt), T(inv_dc), T(s_div), ny2, nx,
                      k, rt, ct, q, hm, hi, log2_exact(kc),
                      vec ? log2_exact(kc * static_cast<int>(sizeof(T)) / 16) : -1, nx / ct,
                      ro};
  const size_t smem = smem_bytes(sites, kc, q, sizeof(T), fc.wind != nullptr,
                                 tracers ? tr.n : 0, strat ? k : 0, fb != 0);
  const int n_tiles = (ny2 / rt) * (nx / ct);
  return run_of<T>(fb, live != nullptr, fc.wind != nullptr, tracers, strat)(
      a, tp, smem, n_ranks, n_tiles, n_steps, ssh_out, h_out, u_out, ssh_tmp, h_tmp, u_tmp,
      tr_out, tr_tmp, stream);
}

}  // namespace

// Returns 0, kNotHexTable for a stencil that is not the hex lattice's, or
// the CUDA error of the first launch that failed (cudaErrorInvalidValue for
// a plan the lattice or the card does not take). A null `live` (the wall
// mask's live bits, one int per site) runs the periodic arm, any other the
// masked one; a null `wind` the unforced arm, any other the forced one with
// `lvl` (the packed levels) and the coefficients; a null `tr_in` the
// tracer-free arm, any other the tracer arm with n_tr tracers (planes
// (2 n_tr, ny2, nx, k) in `tr_in`, `tr_out`, `tr_tmp`), the live-cell mask
// `cmask` (non-null exactly when `live` is), kappa and upwind; a null
// `strat_w` the unstratified arm, any other (W, (k, k) row-major) the
// stratified one; the forced, tracer and stratified arms in any
// combination. `ro` = 0 reads the rows periodically; ro = hm * q > 0 takes
// every lattice operand as a slab of ny2 rows with ro received halo rows
// per side (see Layout).
#define MOT_TILED_ENTRY(T, SUFFIX)                                                            \
  extern "C" int mot_tiled_steps_##SUFFIX(                                                    \
      const T* f_edge, const T* rts, const int* live, const T* wind, const int* lvl,          \
      const int* table, const double* weights, const T* ssh_in, const T* h_in,                \
      const T* u_in, T* ssh_out, T* h_out, T* u_out, T* ssh_tmp, T* h_tmp, T* u_tmp,          \
      const T* tr_in, T* tr_out, T* tr_tmp, const T* cmask, const T* strat_w, double dt,      \
      double inv_dc, double s_div, double kappa, double upwind, double dlin, double dquad,    \
      double rayl, int lvl_ranks, int wind_ranks, int ny2, int nx, int k, int n_steps,        \
      int n_terms, int ro, int rt, int ct, int q, int hm, int hi, int fb, int n_tr,           \
      void* stream) {                                                                         \
    const ForcingArgs<T> fc{wind, lvl, T(dlin), T(dquad), T(rayl),                            \
                            static_cast<unsigned>(lvl_ranks), static_cast<unsigned>(wind_ranks)}; \
    const TracerArgs<T> tr{tr_in, tr_out, cmask, T(kappa), T(0.5 * upwind), n_tr, {}, {}};   \
    return tiled_steps<T>(f_edge, rts, live, fc, tr, tr_tmp, strat_w, table, weights,        \
                          ssh_in, h_in, u_in, ssh_out, h_out, u_out, ssh_tmp, h_tmp, u_tmp,   \
                          dt, inv_dc, s_div, ny2, nx, k, n_steps, n_terms, rt, ct, q, hm, hi, \
                          fb, ro, static_cast<cudaStream_t>(stream));                         \
  }

// tiled_step_f64.cu compiles this file with MOT_TILED_STEP_F64 for the f64
// entry, so that the two dtypes' instantiations compile in parallel.
#ifdef MOT_TILED_STEP_F64
MOT_TILED_ENTRY(double, f64)
#else
MOT_TILED_ENTRY(float, f32)

// The launch of an f32 plan (FE or FB) with a window of `sites` sites and k
// levels, of the unstratified arm or (strat nonzero) the stratified one:
// out[0] the clusters the card holds at once, out[1] the blocks per SM.
// Returns 0 or the CUDA error.
extern "C" int mot_tiled_occupancy(int sites, int k, int q, int fb, int strat, int* out) {
  int max_smem = 0;
  int e = opt_in_smem(&max_smem);
  if (e != 0) return e;
  const int kc = step_chunk(k);
  const size_t smem = smem_bytes(sites, kc, q, sizeof(float), false, 0, strat ? k : 0, fb != 0);
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  auto kernel = strat ? (fb ? tiled_step_kernel<float, true, false, false, false, true>
                            : tiled_step_kernel<float, false, false, false, false, true>)
                      : (fb ? tiled_step_kernel<float, true, false, false, false, false>
                            : tiled_step_kernel<float, false, false, false, false, false>);
  e = strat ? (fb ? prepare<float, true, false, false, false, true>(max_smem)
                  : prepare<float, false, false, false, false, true>(max_smem))
            : (fb ? prepare<float, true, false, false, false, false>(max_smem)
                  : prepare<float, false, false, false, false, false>(max_smem));
  if (e != 0) return e;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = step_config((k + kc - 1) / kc, 1, smem, nullptr, attr);
  cfg.numAttrs = 1;  // the cluster shape only
  cudaError_t err = cudaOccupancyMaxActiveClusters(&out[0], kernel, &cfg);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, kStepThreads, smem);
  return static_cast<int>(err);
}
#endif  // MOT_TILED_STEP_F64
