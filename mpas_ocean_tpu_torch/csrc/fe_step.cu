// Forward-Euler rollout of the linear TRiSK shallow-water core on the
// parity-plane hex lattice, for NVIDIA Hopper (sm_90a).
//
// Replaces: _rollout_kernel (mpas_ocean_tpu/structured/pallas_model.py:320),
// the arms with nl=None and fb=False, periodic
// (masks=None) and masked (a coastal channel culled from a periodic
// lattice: u_new *= masks[c], :257-259), unforced (forc=None) and forced
// (momentum forcing, :248-256), without tracers (tr=None) and with them
// (:261-298; the tracer planes :362-400, operand :446-451), unstratified
// (strat_w=None) and stratified (the Montgomery potential, :154-165; operand
// :436-437), the three in any combination. One
// launch is one step of
// _step_planes (:91-299); the exported entries loop n_steps launches on the
// caller's stream.
//
// Layout (all contiguous, K innermost):
//   ssh (2, ny2, nx)   h (2, ny2, nx, K)   u (6, ny2, nx, K), channel f*2+p
//   f_edge (6, ny2, nx)   rts (2, ny2, nx)   live (ny2, nx) int, or null
// No in-place update: blocks run in parallel and in no order, so a step
// reads one buffer set and writes another: mot_fe_steps_* alternates between
// the caller's output and one scratch set, mot_fe_stack_* writes each step
// into the next slot of a stack of states (the reverse sweep's rebuilt
// group). Offsets are 32-bit, so u may hold at most 2^31 - 1 values.
//
// What bound the first design (PERF.md): 14-16% of the byte bound
// on an H100. One 128-thread block per cell column (28 of 128 lanes idle at
// K = 100), each repeating a prologue of three dependent memory round trips
// (the table, ~50 wrapped tap sources, f_edge at them) before its 100 levels
// of work, and ~40 L1/L2 loads per cell-level that no neighbouring column's
// block shared (each h value read by ~4 blocks, each u value by ~9). The
// time per cell-level was the same with the state in L2 (64x64) and beyond
// it (256x256): latency, not bandwidth.
//
// This design. A thread-block cluster takes an rt x ct tile of lattice sites
// (both parities; (4, 16) at K = 100 f32, kernels/fe_step.fe_tile), its
// blocks split the levels in chunks of kc (a power of two, 16 at K = 100;
// step_window.cuh), and each block stages its chunk of the tile's window
// (the tile plus the FE reach, 1 row and 2 columns per side, wrapped
// periodically) of h, u, ssh, f_edge and rts in shared memory by 16-byte
// async copies, so each value leaves L2 once per tile and not 4-9 times.
// The stencil is resolved once per call on the host into constant-bank
// offsets; only the window's sites wrap. Each of the 25 u and 10 h values
// a cell-level reads is loaded once, and each u * f product formed once
// (step_window.cuh, hex::): the kernel takes the hex lattice's table only,
// and its entries refuse any other. Groups of min(16, kc)
// lanes take consecutive levels of one site and compute its h' and u' in
// one pass (FE reads only the old state); each block's partial column sums
// are a shuffle over the group, stored straight into rank 0's shared
// memory (once a split cluster barrier, whose wait the window's loads
// hide, has seen every block of the cluster start), and after a second
// cluster barrier rank 0 adds them in rank order
// (fixed order, no atomics: f64 reruns are bitwise equal). The window
// takes at most half an SM's shared memory, so two 512-thread blocks share
// an SM. Tiles need not divide the lattice: sites past its edge are
// skipped. Launches are programmatically dependent, so the next step's
// blocks are scheduled while this step's last wave runs.
// Measured share of the byte bound (f32, NVIDIA H100 80GB HBM3 at 700 W;
// PERF.md section 5): 29% at 64x64x100 (13.8 us/step against 3.94) and 34%
// at 256x256x100 (184.6 against 63.1); the first design reached 14-16%.
//
// The masked arm (kMasked, chosen by non-null live bits; the periodic arm
// keeps its code) stages the wall mask as one int of live bits per window
// site with f_edge (step_window.cuh, load_live), holds a site's in one
// register through the level loop and stores u' = 0 on masked channels. A
// first design staged the mask's six planes: 12% more copies per block and
// 5.7-7.3% more time per step at 64x64x100 f32; a second read the bits from
// device memory before the window's loads, which cost 7.7% at 256x256x100,
// one memory round trip per wave of blocks (PERF.md). Culled
// cells hold h = 0 and rts = 0, and every edge of theirs is masked, so they
// stay so; nothing divides by h.
//
// The forced arm (kForced, chosen by a non-null wind; the unforced arm keeps
// its code) adds dt F of the old state to u' after the base update and
// before the wall mask, the JAX kernel's order: Rayleigh, -dt lambda u, at
// every edge-level in the body, then the wind and drag at an edge's top and
// bottom level only, where alone 1 / h_edge is formed from the window's old
// h, in a pass of the ranks whose chunk holds such levels, over the tile's
// edges (step_window.cuh, ForcingArgs, wind_drag_pass).
//
// The tracer arm (kTracers, chosen by a non-null tracer pointer; the
// tracer-free arms keep their code) stages the block's chunk of the
// window's 2 nT tracer planes after the 8 state planes and, in the lane
// group that forms a site's h', carries every tracer by the old state's six
// edge fluxes and divides its new content by h' (step_window.cuh,
// TracerArgs, tracer_step); on a channel the live-cell mask, read per site
// from device memory, guards the division. A tracer level needs only its
// own level, so the arm adds no column sum and no cluster traffic, only the
// 2 nT tracer planes beside the state's 8. Measured (f32, two tracers,
// NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 5): 21.8 us/step at
// 64x64x100, x1.52 the tracer-free step, and 290.4 at 256x256x100, x1.57,
// 14% and 32% of the byte bound.
//
// The stratified arm (kStrat, chosen by a non-null W; the unstratified arms
// keep their code) forms the Montgomery
// potential Phi = g ssh + h @ W of the old state at the block's levels on
// the tile grown by the gradient's reach (5 x 18 sites for a (4, 16) tile)
// before the body (step_window.cuh, StratSmem, montgomery: the other ranks'
// h chunks gathered through distributed shared memory, in rank order), and
// the body takes each level's pressure
// gradient from Phi with scale -dt. The ranks meet at a full cluster
// barrier after their loads, in place of the split one, because each reads
// the others' h.
//
// The arms compose (every combination of kForced, kTracers and kStrat is an
// instantiation): they touch disjoint parts of the step (Rayleigh and the
// pass after the body add to u', the tracers follow h', Phi replaces the
// gradient's ssh), all read the old state of the window, and each has its
// own shared memory after the unforced layout, the stratified arm's first
// and the forced arm's after it.
//
// The stencil table's layout is in lattice.cuh.

#include <algorithm>
#include <cstdlib>

#include "step_window.cuh"

namespace {

using namespace lattice;

constexpr int kPlanes = 10;  // ssh [2], f_edge [6], rts [2]

template <typename T>
struct FeArgs {
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
  NbrReach nr;        // the gradient's reach, which grows the core to Phi's region
  T dt, inv_dc, s_div;
  int ny2, nx, K, rt, ct, hm, hi, kc_log2, vec_log2, n_tiles_i;
};

// Each distinct u and h value of a (site, level) is loaded once and each
// u * f product formed once (step_window.cuh, hex::).
template <typename T, bool kMasked, bool kForced, bool kTracers, bool kStrat>
__global__ void __launch_bounds__(kStepThreads, 2)
    fe_step_kernel(const FeArgs<T> a, const StepTaps<T> tp) {
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

  // the tracer arm's planes follow the state's
  const int n_pl = kTracers ? 8 + 2 * a.tr.n : 8;
  T* buf = reinterpret_cast<T*>(smem_raw);  // [n_pl][W][kc]: h p0, h p1, u c0..c5, tracers
  T* ssh_s = buf + n_pl * pk;               // [2][W]
  T* f_s = ssh_s + 2 * W;                   // [6][W]
  T* rts_s = f_s + 6 * W;                   // [2][W]
  T* recv = rts_s + 2 * W;                  // [n_ranks][2][core]: rank 0's are read
  int* gs = reinterpret_cast<int*>(recv + n_ranks * 2 * core);  // [W]: lattice site
  int* live_s = gs + W;                     // [W]: the masked arm's live bits
  const StratSmem<T> ssm(live_s + W, W, kc, K);  // the stratified arm's
  // the forced arm's winds and levels, after the stratified arm's
  const ForcingSmem<T> fsm(kStrat ? ssm.end(W, kc, false) : static_cast<void*>(live_s + W), W,
                           0);

  // The partial column sums below go straight into rank 0's shared memory,
  // which only a cluster barrier guarantees to exist: its arrival here and
  // its wait after the loads, so that the loads hide it. The stratified arm
  // reads the other ranks' h, so it waits for their loads at a full barrier.
  if (!kStrat) cluster_arrive_relaxed();
  allow_next_grid();
  window_sites(gs, tm * a.rt - a.hm, ti * a.ct - a.hi, Wi, W, a.ny2, a.nx, 0);
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
  if (kStrat) {
    cluster.sync();
    // Phi of the old state on the core grown by the gradient's reach (FE)
    montgomery(ssm, cluster, buf, ssh_s, a.hm + a.nr.m0, a.hm + a.rt + a.nr.m1, a.hi + a.nr.i0,
               a.hi + a.ct + a.nr.i1, Wi, W, a.kc_log2, kr, K, rank, n_ranks);
  } else {
    cluster_wait();
  }

  const T dt_div = a.dt * a.s_div;
  const T pg_scale = kStrat ? -a.dt : T(-kGravity) * a.dt;
  const T dt_rayl = a.dt * a.fc.rayl;  // the forced arm's Rayleigh factor
  T* const sums = cluster.map_shared_rank(recv, 0) + rank * 2 * core;
  // groups of G = min(16, kc) lanes, one site each, 32 / G sites per warp
  const int g_log2 = min(a.kc_log2, kLanesLog2), G = 1 << g_log2;
  const int lane = threadIdx.x & (G - 1), sub = (threadIdx.x & 31) >> g_log2;
  const int warp_sites = 32 >> g_log2;
  const int site_stride = static_cast<int>(blockDim.x >> 5) * warp_sites;
  const FastDiv by_ct(a.ct);
  for (int base = static_cast<int>(threadIdx.x >> 5) * warp_sites; base < core;
       base += site_stride) {
    const int t = base + sub;
    const int tt = t < core ? t : base;
    const int r = by_ct.div(tt), c = by_ct.mod(tt, r);
    const int gm = tm * a.rt + r, gi = ti * a.ct + c;
    const bool valid = t < core && gm < a.ny2 && gi < a.nx;  // a ragged tile's edge
    const int g = gm * a.nx + gi;
    const int s = (a.hm + r) * Wi + a.hi + c;
    // FE: the pressure gradient of the old ssh (the stratified arm's, of
    // each level's Phi, below)
    T grad[6];
    if (!kStrat) {
#pragma unroll
      for (int ch = 0; ch < 6; ++ch)
        grad[ch] = (ssh_s[s + tp.nb[ch]] - ssh_s[(ch & 1) * W + s]) * a.inv_dc;
    }
    const unsigned live = kMasked ? static_cast<unsigned>(live_s[s]) : 0u;
    // the tracer arm's live-cell mask of the site's two cells (a channel's)
    T cm[2] = {T(1), T(1)};
    unsigned inc_live = 0u;
    if (kTracers && kMasked && valid) {
      cm[0] = a.tr.cmask[g], cm[1] = a.tr.cmask[plane + g];
      inc_live = incoming_live(live_s, s, a.tr);
    }
    T acc0 = T(0), acc1 = T(0);
    for (int kl = lane; kl < kc; kl += G) {
      if (!valid || kl >= kr) continue;
      const T* lv = buf + s * kc + kl;
      T* h_o = a.h_out + g * K + k0 + kl;
      T* u_o = a.u_out + g * K + k0 + kl;
      // thickness flux u * 0.5 (h_nbr + h_self): owned edges out, incoming in;
      // u' = u + dt * (TRiSK Coriolis of u * f) + pg_scale * grad(ssh). The
      // stores come last, so that no store sits between two loads of a value
      // (a store through a generic pointer may alias shared memory).
      T hnew[2], unew[6];
      T u[hex::kU], h[hex::kH];
#pragma unroll
      for (int x = 0; x < hex::kU; ++x) u[x] = lv[tp.us[x]];
#pragma unroll
      for (int x = 0; x < hex::kH; ++x) h[x] = lv[tp.hs[x]];
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
      if (kStrat) {
        const T* ph = ssm.phi + s * kc + kl;
#pragma unroll
        for (int ch = 0; ch < 6; ++ch)
          grad[ch] = (ph[tp.nb[ch] << a.kc_log2] - ph[(ch & 1) * pk]) * a.inv_dc;
      }
      T uf[hex::kU];
#pragma unroll
      for (int x = 0; x < hex::kU; ++x) uf[x] = u[x] * f_s[s + tp.fs[x]];
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) {
        T acc = T(0);
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int t2 = 8 * ch + x;
          const T contrib = tp.w[t2] * uf[hex::tap_u(t2)];
          acc = (x == 0) ? contrib : acc + contrib;
        }
        unew[ch] = u[hex::self_u(ch)] + a.dt * acc + pg_scale * grad[ch];
        if (kForced) unew[ch] = unew[ch] - dt_rayl * u[hex::self_u(ch)];
      }
      if (kMasked && live != kAllLive) {
#pragma unroll
        for (int ch = 0; ch < 6; ++ch)
          if (!((live >> ch) & 1u)) unew[ch] = T(0);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) h_o[p * plane * K] = hnew[p];
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) u_o[ch * plane * K] = unew[ch];
      if (kTracers)
        tracer_step<T, kMasked>(lv, pk, tp, u, h, hnew, cm, live, inc_live, a.tr, dt_div,
                                a.inv_dc, [&](int i, T v) {
                                  a.tr.tr_out[(i * plane + g) * K + k0 + kl] = v;
                                });
      acc0 += hnew[0];
      acc1 += hnew[1];
    }
    acc0 = group_sum(acc0, G);
    acc1 = group_sum(acc1, G);
    if (t < core && lane == 0) {
      sums[t] = acc0;
      sums[core + t] = acc1;
    }
  }

  // the forced arm: the wind and drag at the tile's edges' top and bottom
  // levels in this block's chunk, added to the stored u'
  if (kForced && ((a.fc.lvl_ranks >> rank) & 1u)) {
    __syncthreads();
    wind_drag_pass<T, kMasked>(
        buf, tp, fsm, live_s, core,
        [&](int t) {
          const int r = by_ct.div(t), c = by_ct.mod(t, r);
          return tm * a.rt + r < a.ny2 && ti * a.ct + c < a.nx ? (a.hm + r) * Wi + a.hi + c : -1;
        },
        [&](int ch, int t, int, int kl) -> T& {
          const int r = by_ct.div(t), c = by_ct.mod(t, r);
          return a.u_out[(ch * plane + (tm * a.rt + r) * a.nx + ti * a.ct + c) * K + k0 + kl];
        },
        W, kc, k0, kr, a.dt, a.fc);
  }

  // ssh' = sum_k h' - rts: rank 0 adds the ranks' partial sums in rank order
  // (the barrier orders the remote stores above before rank 0's reads; no
  // block reads another's shared memory after it, so none waits to leave)
  cluster.sync();
  if (rank != 0) return;
  for (int e = threadIdx.x; e < 2 * core; e += blockDim.x) {
    const int p = e >= core ? 1 : 0, x = e - p * core;
    const int r = by_ct.div(x), c = by_ct.mod(x, r);
    const int gm = tm * a.rt + r, gi = ti * a.ct + c;
    if (gm >= a.ny2 || gi >= a.nx) continue;
    T v = recv[e];
    for (int rr = 1; rr < n_ranks; ++rr) v += recv[rr * 2 * core + e];
    a.ssh_out[p * plane + gm * a.nx + gi] = v - rts_s[p * W + (a.hm + r) * Wi + a.hi + c];
  }
}

template <typename T, bool kMasked, bool kForced, bool kTracers, bool kStrat>
int prepare(int max_smem) {
  static bool done = false;
  if (done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(fe_step_kernel<T, kMasked, kForced, kTracers, kStrat>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  done = e == cudaSuccess;
  return static_cast<int>(e);
}

// A window's state chunk, ssh, f_edge, rts and sites, the ranks' partial
// sums, and the masked arm's live bits, reserved by the periodic arm too so
// that one plan serves both; the forced arm's winds and packed levels
// beyond, or the stratified arm's Phi, staged h and W slice at k levels
// (strat_k > 0); the tracer arm's chunk of n_tr tracers' planes
// (kernels/fe_step.smem_bytes mirrors this).
size_t smem_bytes(long long sites, int core, int kc, int n_ranks, size_t itemsize,
                  bool forced, int n_tr, int strat_k) {
  return step_smem_bytes(sites, kc, 1, kPlanes, itemsize) +
         itemsize * static_cast<size_t>(n_ranks) * 2 * core +
         sizeof(int) * static_cast<size_t>(sites) +
         (forced ? forcing_smem_bytes(sites, 0, itemsize) : 0) +
         (strat_k > 0 ? strat_smem_bytes(sites, kc, strat_k, itemsize, false) : 0) +
         itemsize * static_cast<size_t>(sites) * 2 * n_tr * kc;
}

// The rows and columns one FE step reads per side, from the table (host
// copy): the neighbour and incoming-edge taps and the Coriolis taps
// (slab.stencil_reach with fb=False).
void fe_reach(const int* table, int* hm, int* hi) {
  *hm = 0, *hi = 0;
  auto take = [&](int dm, int di) {
    *hm = std::max(*hm, std::abs(dm));
    *hi = std::max(*hi, std::abs(di));
  };
  for (int c = 0; c < 6; ++c) take(table[kNbr + 3 * c + 1], table[kNbr + 3 * c + 2]);
  for (int x = 0; x < 6; ++x) {
    const int* tc = table + kInc + 3 * x;
    const int* te = table + kNbr + 3 * tc[0];
    take(tc[1], tc[2]);
    take(tc[1] + te[1], tc[2] + te[2]);
  }
  for (int t = 0; t < table[0]; ++t) take(table[kHeader + 3 * t + 1], table[kHeader + 3 * t + 2]);
}

// One call's launch set-up: the plan, the resolved stencil, the shared memory.
template <typename T>
struct FePlan {
  FeArgs<T> a;
  StepTaps<T> tp;
  int n_ranks, n_tiles, max_smem;
  size_t smem;
};

template <typename T>
int make_plan(FePlan<T>* pl, const T* f_edge, const T* rts, const int* live,
              const ForcingArgs<T>& fc, TracerArgs<T> tr, const T* strat_w, const int* table,
              const double* weights, double dt, double inv_dc, double s_div, int ny2, int nx,
              int k, int n_steps, int n_terms, int rt, int ct, bool vec) {
  if (!valid_shape(ny2, nx, k, n_steps, n_terms) || table[0] != n_terms)
    return cudaErrorInvalidValue;
  if (rt < 1 || ct < 1 || rt > ny2 || ct > nx) return cudaErrorInvalidValue;
  // the tracer arm: at least one tracer, the cell mask with the live bits
  if (tr.tr != nullptr && (tr.n < 1 || (live == nullptr) != (tr.cmask == nullptr)))
    return cudaErrorInvalidValue;
  int hm = 0, hi = 0;
  fe_reach(table, &hm, &hi);
  hm = std::max(hm, 1), hi = std::max(hi, 1);
  const int kc = step_chunk(k);
  const int Wi = ct + 2 * hi, W = (rt + 2 * hm) * Wi;
  pl->n_ranks = (k + kc - 1) / kc;
  if (!resolve_taps<T>(&pl->tp, table, weights, Wi, W, kc)) return kNotHexTable;
  resolve_tracer_taps(&tr, table, Wi);
  int e = opt_in_smem(&pl->max_smem);
  if (e != 0) return e;
  pl->smem = smem_bytes(W, rt * ct, kc, pl->n_ranks, sizeof(T), fc.wind != nullptr,
                        tr.tr != nullptr ? tr.n : 0, strat_w != nullptr ? k : 0);
  if (pl->smem > static_cast<size_t>(pl->max_smem)) return cudaErrorInvalidValue;
  const int n_ti = (nx + ct - 1) / ct;
  pl->n_tiles = ((ny2 + rt - 1) / rt) * n_ti;
  pl->a = FeArgs<T>{nullptr, nullptr, nullptr, f_edge, rts, live, nullptr, nullptr, nullptr,
                    fc, tr, strat_w, nbr_reach(table), T(dt), T(inv_dc), T(s_div), ny2, nx, k,
                    rt, ct, hm, hi,
                    log2_exact(kc),
                    vec ? log2_exact(kc * static_cast<int>(sizeof(T)) / 16) : -1, n_ti};
  return 0;
}

template <typename T, bool kMasked, bool kForced, bool kTracers = false, bool kStrat = false>
int launch_arm(const FePlan<T>* pl, cudaStream_t stream) {
  const int err = prepare<T, kMasked, kForced, kTracers, kStrat>(pl->max_smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg =
      step_config(pl->n_ranks, pl->n_tiles, pl->smem, stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, fe_step_kernel<T, kMasked, kForced, kTracers, kStrat>, pl->a, pl->tp);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of the plan's arm: periodic or masked, and any
// combination of forced, tracers and stratified.
template <typename T, bool kMasked, bool kForced, bool kTracers>
int launch_strat(const FePlan<T>* pl, cudaStream_t stream) {
  return pl->a.strat_w != nullptr ? launch_arm<T, kMasked, kForced, kTracers, true>(pl, stream)
                                  : launch_arm<T, kMasked, kForced, kTracers, false>(pl, stream);
}
template <typename T, bool kMasked, bool kForced>
int launch_tracers(const FePlan<T>* pl, cudaStream_t stream) {
  return pl->a.tr.tr != nullptr ? launch_strat<T, kMasked, kForced, true>(pl, stream)
                                : launch_strat<T, kMasked, kForced, false>(pl, stream);
}
template <typename T, bool kMasked>
int launch_forced(const FePlan<T>* pl, cudaStream_t stream) {
  return pl->a.fc.wind != nullptr ? launch_tracers<T, kMasked, true>(pl, stream)
                                  : launch_tracers<T, kMasked, false>(pl, stream);
}

template <typename T>
int launch_step(FePlan<T>* pl, const T* ssh, const T* h, const T* u, T* ssh_out, T* h_out,
                T* u_out, cudaStream_t stream, const T* tr = nullptr, T* tr_out = nullptr) {
  pl->a.ssh = ssh, pl->a.h = h, pl->a.u = u;
  pl->a.ssh_out = ssh_out, pl->a.h_out = h_out, pl->a.u_out = u_out;
  if (pl->a.tr.tr != nullptr) pl->a.tr.tr = tr, pl->a.tr.tr_out = tr_out;
  return pl->a.live != nullptr ? launch_forced<T, true>(pl, stream)
                               : launch_forced<T, false>(pl, stream);
}

// n_steps steps from `in` into `out`. Step s writes `out` when
// n_steps - 1 - s is even and `tmp` otherwise, so the last step lands in
// `out`, no step writes the buffer it reads, and `in` is left as it is; the
// tracer arm's planes (tr.tr non-null) alike.
template <typename T>
int fe_steps(const T* f_edge, const T* rts, const int* live, const ForcingArgs<T>& fc,
             const TracerArgs<T>& tr, T* tr_tmp, const T* strat_w, const int* table,
             const double* weights,
             const T* ssh_in, const T* h_in, const T* u_in, T* ssh_out, T* h_out, T* u_out,
             T* ssh_tmp, T* h_tmp, T* u_tmp, double dt, double inv_dc, double s_div, int ny2,
             int nx, int k, int n_steps, int n_terms, int rt, int ct, cudaStream_t stream) {
  const int kc = step_chunk(k);
  const bool vec = vector_loads(k, kc, sizeof(T), h_in, u_in) &&
                   vector_loads(k, kc, sizeof(T), h_out, u_out) &&
                   vector_loads(k, kc, sizeof(T), h_tmp, u_tmp) &&
                   (tr.tr == nullptr || (vector_loads(k, kc, sizeof(T), tr.tr, tr.tr_out) &&
                                             vector_loads(k, kc, sizeof(T), tr_tmp, tr_tmp)));
  FePlan<T> pl;
  int err = make_plan(&pl, f_edge, rts, live, fc, tr, strat_w, table, weights, dt, inv_dc,
                      s_div, ny2, nx, k, n_steps, n_terms, rt, ct, vec);
  if (err != 0) return err;
  const T *ssh = ssh_in, *h = h_in, *u = u_in, *t = tr.tr;
  for (int s = 0; s < n_steps; ++s) {
    const bool to_out = ((n_steps - 1 - s) & 1) == 0;
    T* ssh_d = to_out ? ssh_out : ssh_tmp;
    T* h_d = to_out ? h_out : h_tmp;
    T* u_d = to_out ? u_out : u_tmp;
    T* t_d = to_out ? tr.tr_out : tr_tmp;
    err = launch_step<T>(&pl, ssh, h, u, ssh_d, h_d, u_d, stream, t, t_d);
    if (err != 0) return err;
    ssh = ssh_d, h = h_d, u = u_d, t = t_d;
  }
  return 0;
}

// n_steps steps through a stack of states: slot s + 1 = step(slot s); the
// tracer arm's planes (tr.tr the tracer stack (S, 2 nT, ny2, nx, K)) alike,
// and the stratified arm with strat_w, by the launches of fe_steps, so that
// the rebuilt states are the forward path's own bit for bit.
template <typename T>
int fe_stack(const T* f_edge, const T* rts, const int* live, const ForcingArgs<T>& fc,
             const TracerArgs<T>& tr, const T* strat_w, const int* table,
             const double* weights, T* ssh, T* h, T* u, double dt, double inv_dc, double s_div,
             int ny2, int nx, int k, int n_steps, int n_terms, int rt, int ct,
             cudaStream_t stream) {
  const int kc = step_chunk(k);
  FePlan<T> pl;
  int err = make_plan(&pl, f_edge, rts, live, fc, tr, strat_w, table,
                      weights, dt, inv_dc, s_div, ny2, nx, k, n_steps, n_terms, rt, ct,
                      vector_loads(k, kc, sizeof(T), h, u) &&
                          (tr.tr == nullptr || vector_loads(k, kc, sizeof(T), tr.tr, tr.tr)));
  if (err != 0) return err;
  const size_t cells = 2ULL * ny2 * nx;
  const size_t hs = cells * k, us = 3 * cells * k, trs = tr.tr != nullptr ? tr.n * hs : 0;
  T* t = const_cast<T*>(tr.tr);
  for (int s = 0; s < n_steps; ++s) {
    err = launch_step<T>(&pl, ssh + s * cells, h + s * hs, u + s * us, ssh + (s + 1) * cells,
                         h + (s + 1) * hs, u + (s + 1) * us, stream,
                         t ? t + s * trs : nullptr, t ? t + (s + 1) * trs : nullptr);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// Each entry returns 0, kNotHexTable for a stencil that is not the hex
// lattice's, or the CUDA error of the first launch that failed
// (cudaErrorInvalidValue for a tile the card does not take). `table` and
// `weights` are host copies of the stencil; rt x ct is the tile; a null
// `live` (the wall mask's live bits, one int per site) runs the periodic
// arm, any other the masked one; a null `wind` runs the unforced arm, any
// other the forced one with `lvl` (the packed levels) and the coefficients;
// a null `tr_in` runs the tracer-free arm, any other the tracer arm with
// n_tr tracers (planes (2 n_tr, ny2, nx, k) in `tr_in`, `tr_out`,
// `tr_tmp`), the live-cell mask `cmask` (non-null exactly when `live` is),
// kappa and upwind; the stack entry's tracer arm takes the tracer stack
// (S, 2 n_tr, ny2, nx, k) in `tr`; a null `strat_w` runs the unstratified
// arm, any other (W, (k, k) row-major) the stratified one, in either entry;
// the forced, tracer and stratified arms in any combination.
#define MOT_FE_ENTRIES(T, SUFFIX)                                                             \
  extern "C" int mot_fe_steps_##SUFFIX(                                                       \
      const T* f_edge, const T* rts, const int* live, const T* wind, const int* lvl,          \
      const int* table, const double* weights, const T* ssh_in, const T* h_in,                \
      const T* u_in, T* ssh_out, T* h_out, T* u_out, T* ssh_tmp, T* h_tmp, T* u_tmp,          \
      const T* tr_in, T* tr_out, T* tr_tmp, const T* cmask, const T* strat_w, double dt,      \
      double inv_dc, double s_div, double kappa, double upwind, double dlin, double dquad,    \
      double rayl, int lvl_ranks, int wind_ranks, int ny2, int nx, int k, int n_steps,        \
      int n_terms, int rt, int ct, int n_tr, void* stream) {                                  \
    const ForcingArgs<T> fc{wind, lvl, T(dlin), T(dquad), T(rayl),                            \
                            static_cast<unsigned>(lvl_ranks), static_cast<unsigned>(wind_ranks)}; \
    const TracerArgs<T> tr{tr_in, tr_out, cmask, T(kappa), T(0.5 * upwind), n_tr, {}, {}};   \
    return fe_steps<T>(f_edge, rts, live, fc, tr, tr_tmp, strat_w, table, weights, ssh_in,    \
                       h_in, u_in, ssh_out, h_out, u_out, ssh_tmp, h_tmp, u_tmp, dt, inv_dc,  \
                       s_div, ny2, nx, k, n_steps, n_terms, rt, ct,                           \
                       static_cast<cudaStream_t>(stream));                                    \
  }                                                                                           \
  extern "C" int mot_fe_stack_##SUFFIX(                                                       \
      const T* f_edge, const T* rts, const int* live, const T* wind, const int* lvl,          \
      const int* table, const double* weights, T* ssh, T* h, T* u, T* tr, const T* cmask,    \
      const T* strat_w, double dt, double inv_dc, double s_div, double kappa, double upwind,  \
      double dlin, double dquad, double rayl, int lvl_ranks, int wind_ranks, int ny2, int nx, \
      int k, int n_steps, int n_terms, int rt, int ct, int n_tr, void* stream) {              \
    const ForcingArgs<T> fc{wind, lvl, T(dlin), T(dquad), T(rayl),                            \
                            static_cast<unsigned>(lvl_ranks), static_cast<unsigned>(wind_ranks)}; \
    const TracerArgs<T> trs{tr, nullptr, cmask, T(kappa), T(0.5 * upwind), n_tr, {}, {}};    \
    return fe_stack<T>(f_edge, rts, live, fc, trs, strat_w, table, weights, ssh, h, u, dt,    \
                       inv_dc, s_div, ny2, nx, k, n_steps, n_terms, rt, ct,                   \
                       static_cast<cudaStream_t>(stream));                                    \
  }

// fe_step_f64.cu compiles this file with MOT_FE_STEP_F64 for the f64
// entries, so that the two dtypes' instantiations compile in parallel.
#ifdef MOT_FE_STEP_F64
MOT_FE_ENTRIES(double, f64)
#else
MOT_FE_ENTRIES(float, f32)

// The launch fe_step makes for an rt x ct tile of an ny2 x nx x k f32
// lattice with the stencil `table` (a host copy), of the periodic arm with
// n_tr tracers (none: 0), stratified (strat nonzero) or not: out[0] the
// clusters (one per tile), out[1] the blocks per SM. Returns 0,
// kNotHexTable or the CUDA error.
template <bool kTracers, bool kStrat>
int plan_query(const FePlan<float>& pl, int* out) {
  const int e = prepare<float, false, false, kTracers, kStrat>(pl.max_smem);
  if (e != 0) return e;
  out[0] = pl.n_tiles;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], fe_step_kernel<float, false, false, kTracers, kStrat>, kStepThreads, pl.smem));
}

extern "C" int mot_fe_plan(const int* table, int ny2, int nx, int k, int rt, int ct, int n_tr,
                           int strat, int* out) {
  double weights[kMaxTerms] = {};
  FePlan<float> pl;
  static const float dummy = 0.0f;
  TracerArgs<float> tr{};
  if (n_tr > 0) tr.tr = &dummy, tr.n = n_tr;
  int e = make_plan<float>(&pl, nullptr, nullptr, nullptr, ForcingArgs<float>{}, tr,
                           strat ? &dummy : nullptr, table, weights, 1.0, 1.0, 1.0, ny2, nx, k,
                           1, table[0], rt, ct, true);
  if (e != 0) return e;
  return n_tr > 0 ? (strat ? plan_query<true, true>(pl, out) : plan_query<true, false>(pl, out))
                  : (strat ? plan_query<false, true>(pl, out) : plan_query<false, false>(pl, out));
}
#endif  // MOT_FE_STEP_F64
