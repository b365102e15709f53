// Tiled reverse (adjoint) of the q-step superstep of the linear TRiSK
// shallow-water core on the parity-plane hex lattice, forward Euler, for
// NVIDIA Hopper (sm_90a).
//
// Replaces: _tiled_adjoint_kernel (mpas_ocean_tpu/structured/pallas_model.py:
// 1979), the arm with masks, nl_terms, tracers, cell masks, stratification
// and forcing off (fb=False is fixed there). The TPU kernel traces jax.vjp of
// _window_steps in-kernel and emits the cotangent of the whole padded window,
// which its caller overlap-adds (_halo_unscatter). CUDA has no vjp, so the
// transpose is written out by hand, as in adjoint_step.cu; and it is taken in
// gather form: a tile computes the cotangent of its own core only, from the
// end cotangent read with halos, so there is no overlap-add pass and no
// atomics. One launch maps (primal state at the superstep start, cotangent at
// its end) to (cotangent at its start, the tiles' shares of d(dt)).
//
// Layout as in tiled_step.cu; the stack holds the primal state of superstep
// s in slot s: ssh (S, 2, ny2, nx), h (S, 2, ny2, nx, K), u (S, 6, ny2, nx, K).
//
// Design. reach = (hm, hi) sites per side is what one step reads (the
// forward step's and the transposed step's tables both reach (1, 2):
// slab.stencil_reach, slab.adjoint_stencil_reach). Let R_j be the tile's core
// grown by j reaches per side. The cotangent at step j on R_j needs the
// cotangent at step j + 1 on R_{j+1} and the primal state j on R_{j+1}. So a
// tile reads the end cotangent on R_q and the start primal on the window
// R_{2q-1}; for q > 1 it first recomputes the primal states 1 .. q - 1 forward
// in shared memory (fe_window_step, tiled_step.cu's FE step), then runs the q
// reverse steps on the shrinking R_j. At q = 1 there is no recompute and both
// are the core plus one reach. For output cotangents
// (gs, gh, gu) at step j + 1, with G = gh + gs and dG_e = G[nbr(e)] - G[own(e)]:
//   dh_c  = G_c + 1/2 sum over the 6 edges e of c of u_e * dt * s_div * dG_e
//   du_e  = gu_e + h_e * dt * s_div * dG_e + dt * f_e * (C^T gu)_e
//   ds_c  = (g dt / dc) * (sum_owned S_e - sum_incoming S_e), S_e = sum_k gu_e
//   d(dt) = per owned edge of the core: s_div dG_e u_e h_e
//           + u_e f_e (C^T gu)_e - g grad(ssh)_e gu_e
// (structured/adjoint.py, the plain reverse step on the whole lattice).
//
// Levels couple twice: S_e, and the d(dt) share. A thread-block cluster of up
// to 8 blocks holds one tile and splits the levels, as in tiled_step.cu. Each
// block writes its partial of sum_owned S_e - sum_incoming S_e per cell (two
// values per site rather than six S_e, so fewer reads across the cluster);
// after cluster.sync every block adds the ranks' partials in rank order and
// holds ds on R_j, which the next reverse step's G needs. Each block reduces
// its d(dt) share in a fixed order (threads, then warps in order) into a row
// per (superstep, tile, rank), and one more small kernel
// (lattice.cuh's ddt_reduce_kernel) sums the call's rows in a fixed order. No
// atomics: f64 reruns are bitwise equal. The launch writes only its tiles'
// cores into buffers it does not read (the entry ping-pongs).
//
// Shared memory per block (kernels/tiled_adjoint.smem_bytes): q primal states
// and min(q, 2) cotangents of 8 planes of its level chunk over the window, the
// window's ssh per primal state, two ds planes, two partial-sum planes,
// f_edge, rts, both tap tables, the lattice sites, the small tables. At q = 1
// an (8, 16) tile has a (10 x 20) window: 166 KB for 13 f32 levels, 186 KB in
// all, so one block per SM, as the forward.
//
// What bounds it on this card. A reverse step reads the primal state and the
// end cotangent and writes the start cotangent: three state passes, 94 us at
// 256x256x100 f32 at 3.35 TB/s, plus the halo re-reads (the (10 x 20) window
// is 1.56x the (8 x 16) core, for two of the three passes). Measured on an
// H100 (PERF.md), a launch takes 557-577 us there, 17% of that bound: like
// the forward tiled kernel it is held by its shared-memory loads (~50 per
// cell-level: G, h, u, gu at owned and incoming edges and 24 transposed taps)
// and by phases that do not overlap at one block per SM. Making it fast is
// later work.

#include "tiled_window.cuh"

namespace {

using namespace lattice;

constexpr int kTableInts = 31;  // of kSmallInts, the ones load_tables fills

// The forward step below is the arithmetic of tiled_step.cu's own step loop,
// which keeps its inline copy: built from one shared function, the forward
// kernel's f32 FB arm ran 11% slower on an H100 (617.6 against 553.7 us per
// step at 256x256x100, PERF.md).

// The stencil tables resolved to window offsets (in shared memory).
template <typename T>
struct WindowTables {
  const Tap<T>* taps;    // Coriolis taps, grouped by output channel
  const int* nb;         // per channel: neighbour cell (site offset)
  const int* inc_u;      // per (p, j) = 3p + j, in level-chunk units: incoming edge,
  const int* inc_self;   //   that edge's own cell,
  const int* inc_nb;     //   and that edge's neighbour cell
  const int* off;        // first tap of each channel (7)
};

// Fills the tables of a window of width Wi and W sites from the packed
// stencil (lattice.cuh's layout). taps has kMaxTerms slots; small has
// kTableInts ints (nb, inc_u, inc_self, inc_nb: 6 each; off: 7).
template <typename T>
__device__ WindowTables<T> load_tables(const int* table, const T* weights, Tap<T>* taps,
                                       int* small, int W, int Wi, int kc) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int* nb = small;
  int* inc_u = nb + 6;
  int* inc_self = nb + 12;
  int* inc_nb = nb + 18;
  int* off = nb + 24;
  const int n_terms = table[0];
  for (int t = tid; t < n_terms; t += nt) {
    const int* tt = table + kHeader + 3 * t;
    taps[t].u = ((2 + tt[0]) * W + tt[1] * Wi + tt[2]) * kc;
    taps[t].f = tt[0] * W + tt[1] * Wi + tt[2];
    taps[t].w = weights[t];
  }
  if (tid < 6) {
    const int* tn = table + kNbr + 3 * tid;
    nb[tid] = tn[0] * W + tn[1] * Wi + tn[2];
    const int* tc = table + kInc + 3 * tid;  // p = tid / 3, j = tid % 3
    const int* te = table + kNbr + 3 * tc[0];
    const int d = tc[1] * Wi + tc[2];
    inc_u[tid] = ((2 + tc[0]) * W + d) * kc;
    inc_self[tid] = ((tc[0] & 1) * W + d) * kc;
    inc_nb[tid] = (te[0] * W + d + te[1] * Wi + te[2]) * kc;
  }
  if (tid < 7) off[tid] = table[kOff + tid];
  return {taps, nb, inc_u, inc_self, inc_nb, off};
}

// One FE step of the linear core on a window: from the state `cur` (8 planes
// of [W][kc]) and its ssh `ssh_cur` ([2][W]) to `nxt` and `ssh_nxt`, on the
// window less j + 1 halos of (hm, hi) sites per side. The cluster's blocks
// hold the level chunks; `part` ([2][W]) takes this block's partial column
// sums, which every block adds in rank order after cluster.sync (a caller
// alternates two `part` arrays between steps). Ends with __syncthreads.
template <typename T>
__device__ __forceinline__ void fe_window_step(cg::cluster_group& cluster, const T* cur, T* nxt,
                                               const T* ssh_cur, T* ssh_nxt, T* part,
                                               const T* f_s, const T* rts_s,
                                               const WindowTables<T>& tb, T dt, T inv_dc,
                                               T s_div, int j, int hm, int hi, int Wm, int Wi,
                                               int kc, int kr, int n_ranks) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int W = Wm * Wi, pk = W * kc;
  const FastDiv by_kr(kr);
  const T dt_div = dt * s_div;
  const T pg_scale = T(-kGravity) * dt;

  // continuity: h' on the window less j + 1 halos
  const int hr0 = hm * (j + 1), hc0 = hi * (j + 1);
  const int hnc = Wi - 2 * hc0, hn = (Wm - 2 * hr0) * hnc;
  const FastDiv by_hnc(hnc), by_hn(hn);
  {
    int nbk[6], iu[6], isf[6], inb[6];
    for (int x = 0; x < 6; ++x) {
      nbk[x] = tb.nb[x] * kc;
      iu[x] = tb.inc_u[x], isf[x] = tb.inc_self[x], inb[x] = tb.inc_nb[x];
    }
    for (int e = tid; e < hn * kr; e += nt) {
      const int t = by_kr.div(e), kl = by_kr.mod(e, t);
      const int r = by_hnc.div(t), c = by_hnc.mod(t, r);
      const int base = ((hr0 + r) * Wi + hc0 + c) * kc + kl;
      const T* lv = cur + base;
      for (int p = 0; p < 2; ++p) {
        const T hc = lv[p * pk];
        T total = T(0);
        for (int f = 0; f < 3; ++f) {
          const int ch = f * 2 + p;
          const T he = T(0.5) * (lv[nbk[ch]] + hc);
          const T fl = lv[(2 + ch) * pk] * he;
          total = (f == 0) ? fl : total + fl;
        }
        for (int x = 3 * p; x < 3 * p + 3; ++x) {
          const T he = T(0.5) * (lv[inb[x]] + lv[isf[x]]);
          total = total - lv[iu[x]] * he;
        }
        nxt[p * pk + base] = hc - dt_div * total;
      }
    }
  }
  __syncthreads();

  // ssh' = sum_k h' - rts: this block's levels in order, then the
  // cluster's partial sums in rank order
  for (int e = tid; e < 2 * hn; e += nt) {
    const int p = by_hn.div(e), t = by_hn.mod(e, p);
    const int r = by_hnc.div(t), c = by_hnc.mod(t, r);
    const T* col = nxt + p * pk + ((hr0 + r) * Wi + hc0 + c) * kc;
    T acc = col[0];
    for (int kl = 1; kl < kr; ++kl) acc += col[kl];
    part[p * W + (hr0 + r) * Wi + hc0 + c] = acc;
  }
  cluster.sync();
  for (int e = tid; e < 2 * hn; e += nt) {
    const int p = by_hn.div(e), t = by_hn.mod(e, p);
    const int r = by_hnc.div(t), c = by_hnc.mod(t, r);
    const int x = p * W + (hr0 + r) * Wi + hc0 + c;
    T v = *cluster.map_shared_rank(part + x, 0);
    for (int rr = 1; rr < n_ranks; ++rr) v += *cluster.map_shared_rank(part + x, rr);
    ssh_nxt[x] = v - rts_s[x];
  }
  __syncthreads();

  // momentum: u' = u + dt * (TRiSK Coriolis of u * f) + pg_scale * grad of
  // the old ssh, on the same region
  for (int e = tid; e < hn * kr; e += nt) {
    const int t = by_kr.div(e), kl = by_kr.mod(e, t);
    const int r = by_hnc.div(t), c = by_hnc.mod(t, r);
    const int s = (hr0 + r) * Wi + hc0 + c;
    const int base = s * kc + kl;
    for (int ch = 0; ch < 6; ++ch) {
      const int t0 = tb.off[ch], t1 = tb.off[ch + 1];
      T acc = T(0);
      for (int t2 = t0; t2 < t1; ++t2) {
        const Tap<T> tp = tb.taps[t2];
        const T contrib = tp.w * (cur[base + tp.u] * f_s[s + tp.f]);
        acc = (t2 == t0) ? contrib : acc + contrib;
      }
      const T grad = (ssh_cur[s + tb.nb[ch]] - ssh_cur[(ch & 1) * W + s]) * inv_dc;
      const int o = (2 + ch) * pk + base;
      nxt[o] = cur[o] + dt * acc + pg_scale * grad;
    }
  }
  __syncthreads();
}

// Dynamic shared memory of one block (kernels/tiled_adjoint.smem_bytes):
// two tap tables; primal [q][8][sites][kc], cotangent [min(q,2)][8][sites][kc],
// primal ssh [q][2][sites], ds [2][2][sites], partials [2][2][sites],
// f_edge [6][sites], rts [2][sites]; the lattice sites and the small tables.
size_t smem_bytes(long long sites, int kc, int q, size_t itemsize) {
  const size_t states = 8 * static_cast<size_t>(q + (q < 2 ? q : 2));
  return 2 * sizeof(Tap<double>) * kMaxTerms +
         itemsize * static_cast<size_t>(sites) * (states * kc + 2 * q + 16) +
         sizeof(int) * (static_cast<size_t>(sites) + kSmallInts);
}

template <typename T>
struct AdjArgs {
  const T* ssh;  // primal state at the superstep start
  const T* h;
  const T* u;
  const T* gs;  // cotangent at its end
  const T* gh;
  const T* gu;
  const T* f_edge;
  const T* rts;
  const int* table;  // the Coriolis stencil and its transpose, packed
  const T* weights;
  const int* adj_table;
  const T* adj_weights;
  T* ds;  // cotangent at its start
  T* dh;
  T* du;
  T* ddt_part;  // one value per (tile, rank)
  T dt, inv_dc, s_div;
  int ny2, nx, K, rt, ct, q, hm, hi, kc, n_tiles_i;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) tiled_adjoint_kernel(const AdjArgs<T> a) {
  // no static shared memory: the dynamic share may take the opt-in maximum
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int tile = blockIdx.x / n_ranks;
  const int tm = tile / a.n_tiles_i, ti = tile % a.n_tiles_i;
  const int q = a.q, span = 2 * q - 1;  // the window is R_span
  const int Wm = a.rt + 2 * a.hm * span, Wi = a.ct + 2 * a.hi * span, W = Wm * Wi;
  const int kc = a.kc, k0 = rank * kc, kr = min(kc, a.K - k0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int plane = a.ny2 * a.nx;
  const int pk = W * kc;  // one plane of a level chunk
  const int n_cot = q < 2 ? q : 2;
  const FastDiv by_kr(kr), by_w(W), by_wi(Wi);

  Tap<T>* taps = reinterpret_cast<Tap<T>*>(smem_raw);  // [kMaxTerms] forward
  Tap<T>* ataps = taps + kMaxTerms;                     // [kMaxTerms] transposed
  T* prim = reinterpret_cast<T*>(ataps + kMaxTerms);    // [q][8][W][kc]
  T* cot = prim + 8 * q * pk;                           // [n_cot][8][W][kc]
  T* ssh_s = cot + 8 * n_cot * pk;                      // [q][2][W]
  T* gs_s = ssh_s + 2 * q * W;                          // [2][2][W]
  T* part = gs_s + 4 * W;                               // [2][2][W], by exchange parity
  T* f_s = part + 4 * W;                                // [6][W]
  T* rts_s = f_s + 6 * W;                               // [2][W]
  int* gsite = reinterpret_cast<int*>(rts_s + 2 * W);   // [W]: lattice site
  int* small = gsite + W;
  const WindowTables<T> tb = load_tables(a.table, a.weights, taps, small, W, Wi, kc);
  int* inc_cell = small + kTableInts;  // per (p, j): the incoming edge's own cell
  int* aoff = inc_cell + 6;            // first transposed tap of each channel (7)
  {
    const int n_terms = a.adj_table[0];
    for (int t = tid; t < n_terms; t += nt) {
      const int* tt = a.adj_table + kHeader + 3 * t;
      ataps[t].u = ((2 + tt[0]) * W + tt[1] * Wi + tt[2]) * kc;
      ataps[t].f = 0;
      ataps[t].w = a.adj_weights[t];
    }
    if (tid < 6) {
      const int* tc = a.table + kInc + 3 * tid;
      inc_cell[tid] = (tc[0] & 1) * W + tc[1] * Wi + tc[2];
    }
    if (tid < 7) aoff[tid] = a.adj_table[kOff + tid];
  }

  // the window, wrapped periodically, by async copies: the primal ssh, f_edge
  // and rts on all of it, the end cotangent's ssh on R_q
  const int m_base = tm * a.rt - a.hm * span, i_base = ti * a.ct - a.hi * span;
  const int cr0 = a.hm * (q - 1), cc0 = a.hi * (q - 1);  // R_q within the window
  for (int s = tid; s < W; s += nt) {
    const int r = by_wi.div(s), c = by_wi.mod(s, r);
    const int g = wrap(m_base + r, a.ny2) * a.nx + wrap(i_base + c, a.nx);
    gsite[s] = g;
    const bool in_rq = r >= cr0 && r < Wm - cr0 && c >= cc0 && c < Wi - cc0;
    for (int p = 0; p < 2; ++p) {
      copy_async(ssh_s + p * W + s, a.ssh + p * plane + g);
      copy_async(rts_s + p * W + s, a.rts + p * plane + g);
      if (in_rq) copy_async(gs_s + p * W + s, a.gs + p * plane + g);
    }
    for (int c6 = 0; c6 < 6; ++c6) copy_async(f_s + c6 * W + s, a.f_edge + c6 * plane + g);
  }
  __syncthreads();
  // this block's levels: the primal h and u on the window, the cotangent on R_q
  for (int e = tid; e < 8 * W * kr; e += nt) {
    const int t = by_kr.div(e), kl = by_kr.mod(e, t);
    const int ch = by_w.div(t), s = by_w.mod(t, ch);
    const int g = gsite[s];
    copy_async(prim + ch * pk + s * kc + kl,
               ch < 2 ? a.h + (ch * plane + g) * a.K + k0 + kl
                      : a.u + ((ch - 2) * plane + g) * a.K + k0 + kl);
  }
  {
    const int cnc = Wi - 2 * cc0, cn = (Wm - 2 * cr0) * cnc;
    const FastDiv by_cnc(cnc), by_cn(cn);
    for (int e = tid; e < 8 * cn * kr; e += nt) {
      const int t = by_kr.div(e), kl = by_kr.mod(e, t);
      const int ch = by_cn.div(t), x = by_cn.mod(t, ch);
      const int r = by_cnc.div(x), c = by_cnc.mod(x, r);
      const int s = (cr0 + r) * Wi + cc0 + c;
      const int g = gsite[s];
      copy_async(cot + ch * pk + s * kc + kl,
                 ch < 2 ? a.gh + (ch * plane + g) * a.K + k0 + kl
                        : a.gu + ((ch - 2) * plane + g) * a.K + k0 + kl);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // the primal states 1 .. q - 1, forward on the shrinking window
  int xchg = 0;  // exchanges through `part` so far: its parity picks the array
  for (int j = 0; j + 1 < q; ++j, ++xchg)
    fe_window_step<T>(cluster, prim + j * 8 * pk, prim + (j + 1) * 8 * pk,
                      ssh_s + j * 2 * W, ssh_s + (j + 1) * 2 * W, part + (xchg & 1) * 2 * W,
                      f_s, rts_s, tb, a.dt, a.inv_dc, a.s_div, j, a.hm, a.hi, Wm, Wi, kc,
                      kr, n_ranks);

  // the reverse steps j = q - 1 .. 0: the cotangent on R_j from the one on
  // R_{j+1}; step 0 writes the core (R_0) into the output buffers
  const T dt_div = a.dt * a.s_div;
  const T grav = T(kGravity);
  const T ds_scale = grav * a.dt * a.inv_dc;
  const int core_r = a.hm * span, core_c = a.hi * span;
  T ddt = T(0);
  for (int j = q - 1; j >= 0; --j, ++xchg) {
    const T* P = prim + j * 8 * pk;  // primal state j
    const T* ssh_p = ssh_s + j * 2 * W;
    const T* C = cot + ((q - 1 - j) & 1) * 8 * pk;  // cotangent j + 1
    T* Cn = cot + ((q - j) & 1) * 8 * pk;           // cotangent j (j > 0)
    const T* gs_in = gs_s + ((q - 1 - j) & 1) * 2 * W;
    T* gs_out = gs_s + ((q - j) & 1) * 2 * W;
    T* part_j = part + (xchg & 1) * 2 * W;
    const int r0 = a.hm * (span - j), c0 = a.hi * (span - j);  // R_j
    const int nc = Wi - 2 * c0, n = (Wm - 2 * r0) * nc;
    const FastDiv by_nc(nc), by_n(n);

    // this block's partial of sum_owned S_e - sum_incoming S_e per cell
    for (int e = tid; e < 2 * n; e += nt) {
      const int p = by_n.div(e), t = by_n.mod(e, p);
      const int r = by_nc.div(t), c = by_nc.mod(t, r);
      const int s = (r0 + r) * Wi + c0 + c;
      const T* lv = C + s * kc;
      T S[6];
      for (int f = 0; f < 3; ++f) {
        const T* col = lv + (2 + f * 2 + p) * pk;
        T acc = col[0];
        for (int kl = 1; kl < kr; ++kl) acc += col[kl];
        S[f] = acc;
      }
      for (int x = 0; x < 3; ++x) {
        const T* col = lv + tb.inc_u[3 * p + x];
        T acc = col[0];
        for (int kl = 1; kl < kr; ++kl) acc += col[kl];
        S[3 + x] = acc;
      }
      part_j[p * W + s] = (S[0] + S[1] + S[2]) - (S[3] + S[4] + S[5]);
    }
    cluster.sync();

    // dh and du on R_j for this block's levels, and d(dt) on the core
    for (int e = tid; e < n * kr; e += nt) {
      const int t = by_kr.div(e), kl = by_kr.mod(e, t);
      const int r = by_nc.div(t), c = by_nc.mod(t, r);
      const int wr = r0 + r, wc = c0 + c;
      const int s = wr * Wi + wc;
      const int base = s * kc + kl;
      const bool in_core = wr >= core_r && wr < core_r + a.rt && wc >= core_c &&
                           wc < core_c + a.ct;
      const int g = (tm * a.rt + r) * a.nx + ti * a.ct + c;  // for j = 0 (R_0 = core)
      const T* Pl = P + base;
      const T* Cl = C + base;
      for (int p = 0; p < 2; ++p) {
        const T Gc = Cl[p * pk] + gs_in[p * W + s];
        T flux = T(0);
        for (int f = 0; f < 3; ++f) {
          const int ch = f * 2 + p;
          const int nbo = tb.nb[ch];
          const T dG = Cl[nbo * kc] + gs_in[s + nbo] - Gc;
          const T gflux = dt_div * dG;
          const T he = T(0.5) * (Pl[nbo * kc] + Pl[p * pk]);
          T ct = T(0);
          for (int t2 = aoff[ch]; t2 < aoff[ch + 1]; ++t2) {
            const Tap<T> tp = ataps[t2];
            ct += tp.w * Cl[tp.u];
          }
          const T fct = f_s[ch * W + s] * ct;
          const T gue = Cl[(2 + ch) * pk];
          const T ue = Pl[(2 + ch) * pk];
          const T du = gue + he * gflux + a.dt * fct;
          if (j == 0)
            a.du[(ch * plane + g) * a.K + k0 + kl] = du;
          else
            Cn[(2 + ch) * pk + base] = du;
          flux += ue * gflux;
          if (in_core) {
            const T grad = (ssh_p[s + nbo] - ssh_p[p * W + s]) * a.inv_dc;
            ddt += ue * (a.s_div * dG * he + fct) - grav * grad * gue;
          }
        }
        for (int x = 3 * p; x < 3 * p + 3; ++x) {
          const T dG = Gc - (Cl[tb.inc_self[x]] + gs_in[s + inc_cell[x]]);
          flux += Pl[tb.inc_u[x]] * (dt_div * dG);
        }
        const T dh = Gc + T(0.5) * flux;
        if (j == 0)
          a.dh[(p * plane + g) * a.K + k0 + kl] = dh;
        else
          Cn[p * pk + base] = dh;
      }
    }

    // ds on R_j: the ranks' partials in rank order
    if (j > 0 || rank == 0) {
      for (int e = tid; e < 2 * n; e += nt) {
        const int p = by_n.div(e), t = by_n.mod(e, p);
        const int r = by_nc.div(t), c = by_nc.mod(t, r);
        const int x = p * W + (r0 + r) * Wi + c0 + c;
        T v = *cluster.map_shared_rank(part_j + x, 0);
        for (int rr = 1; rr < n_ranks; ++rr) v += *cluster.map_shared_rank(part_j + x, rr);
        if (j == 0)
          a.ds[p * plane + (tm * a.rt + r) * a.nx + ti * a.ct + c] = ds_scale * v;
        else
          gs_out[x] = ds_scale * v;
      }
    }
    __syncthreads();
  }

  // this block's d(dt) share: threads, then warps in order, through the
  // cotangent buffers, which no step reads any more (other blocks read only
  // `part`)
  T* s_red = cot;  // [kThreads / 32]
  const int lane = tid & 31, warp = tid >> 5;
  const T w_sum = warp_sum(ddt);
  if (lane == 0) s_red[warp] = w_sum;
  __syncthreads();
  if (tid == 0) {
    T tot = s_red[0];
    for (int w = 1; w < (nt + 31) / 32; ++w) tot += s_red[w];
    a.ddt_part[tile * n_ranks + rank] = tot;
  }
  // no block may leave while another can still read its partial sums
  cluster.sync();
}

// The kernel's attribute, set once per instantiation: dynamic shared memory
// up to the device's opt-in limit.
template <typename T>
int prepare(int max_smem) {
  static bool done = false;
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      tiled_adjoint_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  done = e == cudaSuccess;
  return static_cast<int>(e);
}

// n_ss reverse supersteps through the stack's slots n_ss - 1 .. 0, from the
// cotangent `g_in` at the end into `g_out`, through `g_tmp` as in
// tiled_step.cu (`g_in` is left as it is). `part` holds
// n_ss * n_tiles * n_ranks scratch values; d(dt) is added to ddt[0].
template <typename T>
int tiled_adjoint(const T* f_edge, const T* rts, const int* table, const T* weights,
                  const int* adj_table, const T* adj_weights, const T* ssh_st,
                  const T* h_st, const T* u_st, const T* gs_in, const T* gh_in,
                  const T* gu_in, T* gs_out, T* gh_out, T* gu_out, T* gs_tmp, T* gh_tmp,
                  T* gu_tmp, T* part, double* ddt, double dt, double inv_dc, double s_div,
                  int ny2, int nx, int k, int n_ss, int n_terms, int rt, int ct, int q,
                  int hm, int hi, int kc, cudaStream_t stream) {
  if (!valid_shape(ny2, nx, k, n_ss, n_terms) || n_ss < 1) return cudaErrorInvalidValue;
  if (rt < 1 || ct < 1 || q < 1 || hm < 1 || hi < 1 || kc < 1 || ny2 % rt || nx % ct)
    return cudaErrorInvalidValue;
  const int n_ranks = (k + kc - 1) / kc;  // no block without levels
  if (n_ranks > kMaxCluster) return cudaErrorInvalidValue;
  const long long sites =
      static_cast<long long>(rt + 2 * hm * (2 * q - 1)) * (ct + 2 * hi * (2 * q - 1));
  const size_t smem = smem_bytes(sites, kc, q, sizeof(T));
  int max_smem = 0;
  const int e = opt_in_smem(&max_smem);
  if (e != 0) return e;
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  const int err = prepare<T>(max_smem);
  if (err != 0) return err;
  const int n_tiles = (ny2 / rt) * (nx / ct);
  const size_t cells = 2ULL * ny2 * nx;
  const size_t hs = cells * k, us = 3 * cells * k;
  AdjArgs<T> a{nullptr, nullptr, nullptr, gs_in, gh_in, gu_in, f_edge, rts,
               table, weights, adj_table, adj_weights, nullptr, nullptr, nullptr, nullptr,
               T(dt), T(inv_dc), T(s_div), ny2, nx, k, rt, ct, q, hm, hi, kc, nx / ct};
  for (int s = 0; s < n_ss; ++s) {
    const size_t j = n_ss - 1 - s;
    const bool to_out = ((n_ss - 1 - s) & 1) == 0;
    a.ssh = ssh_st + j * cells, a.h = h_st + j * hs, a.u = u_st + j * us;
    a.ds = to_out ? gs_out : gs_tmp;
    a.dh = to_out ? gh_out : gh_tmp;
    a.du = to_out ? gu_out : gu_tmp;
    a.ddt_part = part + static_cast<size_t>(s) * n_tiles * n_ranks;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cluster_config(n_ranks, n_tiles, smem, stream, attr);
    cudaError_t le = cudaLaunchKernelEx(&cfg, tiled_adjoint_kernel<T>, a);
    if (le == cudaSuccess) le = cudaGetLastError();
    if (le != cudaSuccess) return static_cast<int>(le);
    a.gs = a.ds, a.gh = a.dh, a.gu = a.du;
  }
  return reduce_ddt(part, static_cast<long long>(n_ss) * n_tiles * n_ranks, ddt, stream);
}

}  // namespace

// Returns 0 or the CUDA error of the first launch that failed
// (cudaErrorInvalidValue for a plan the lattice or the card does not take).
#define MOT_TILED_ADJOINT_ENTRY(T, SUFFIX)                                                  \
  extern "C" int mot_tiled_adjoint_##SUFFIX(                                                \
      const T* f_edge, const T* rts, const int* table, const T* weights,                    \
      const int* adj_table, const T* adj_weights, const T* ssh_st, const T* h_st,           \
      const T* u_st, const T* gs_in, const T* gh_in, const T* gu_in, T* gs_out, T* gh_out,  \
      T* gu_out, T* gs_tmp, T* gh_tmp, T* gu_tmp, T* part, double* ddt, double dt,          \
      double inv_dc, double s_div, int ny2, int nx, int k, int n_ss, int n_terms, int rt,   \
      int ct, int q, int hm, int hi, int kc, void* stream) {                                \
    return tiled_adjoint<T>(f_edge, rts, table, weights, adj_table, adj_weights, ssh_st,    \
                            h_st, u_st, gs_in, gh_in, gu_in, gs_out, gh_out, gu_out,        \
                            gs_tmp, gh_tmp, gu_tmp, part, ddt, dt, inv_dc, s_div, ny2, nx,  \
                            k, n_ss, n_terms, rt, ct, q, hm, hi, kc,                        \
                            static_cast<cudaStream_t>(stream));                             \
  }

MOT_TILED_ADJOINT_ENTRY(float, f32)
MOT_TILED_ADJOINT_ENTRY(double, f64)
