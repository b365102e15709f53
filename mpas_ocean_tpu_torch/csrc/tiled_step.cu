// Tiled, temporally blocked rollout of the linear TRiSK shallow-water core on
// the parity-plane hex lattice, forward Euler (FE) or forward-backward (FB),
// for NVIDIA Hopper (sm_90a).
//
// Replaces: _tiled_step_kernel (mpas_ocean_tpu/structured/pallas_model.py:852),
// the arm with masks, forcing, tracers, cell masks, stratification and the
// nonlinear terms off, halos read from the periodic state. One launch advances
// the whole lattice by q steps of _window_steps (:802); the exported entry
// loops n_steps / q launches on the caller's stream.
//
// Layout (all contiguous, K innermost), as in fe_step.cu:
//   ssh (2, ny2, nx)   h (2, ny2, nx, K)   u (6, ny2, nx, K), channel f*2+p
//   f_edge (6, ny2, nx)   rts (2, ny2, nx); stencil table as in lattice.cuh.
//
// Design. The lattice is cut into rt x ct tiles of sites. A tile's window
// is the tile plus q halos of (hm, hi) sites per side, hm = 1 (FE) or 2 (FB)
// rows and hi = 2 columns (the Coriolis stencil reaches two columns; the
// Python side derives both from the tables, slab.stencil_reach). Step j
// computes on the window less (j + 1) halos per side, so after q steps the
// tile's core is left, and only the core is written, into buffers the launch
// does not read (a tile reads its neighbours' pre-step sites, so there is no
// in-place update: the entry ping-pongs between the output and a scratch
// set, as fe_step.cu does).
//
// The window does not fit one block: a site holds 8 values (2 h, 6 u) per
// level, 3.2 KB at K = 100 in f32, and the smallest FE q = 2 window around
// an 8 x 8 tile has 192 sites. Levels are coupled only through the column
// sum ssh = sum_k h - rts, so the tile is given to a thread-block cluster of
// up to 8 blocks that split the levels. Each block keeps its level chunk of
// the window in shared memory, two copies (step j and j + 1), and runs all q
// steps there. Once per step the blocks exchange their partial column sums
// through distributed shared memory (cluster.sync, then each block adds the
// ranks' partials in rank order), so every block holds the window's new
// ssh. The other candidates: a per-block scratch window in device memory
// would be written and read back through L2 once per step; a tile small
// enough for one block to hold all its levels (~70 window sites at K = 100
// in f32) would read 2-3 halo sites per core site even at q = 1.
//
// Sums run in a fixed order (levels in order within a block, then blocks in
// rank order), with no atomics, so f64 reruns are bitwise equal. Offsets
// are 32-bit (as in fe_step.cu). Every launch is checked with
// cudaGetLastError(): a launch refused for its shared memory or its cluster
// never runs, and a later synchronize would not say so.
//
// What bounds it on this card. Per launch the state is read once and written
// once, plus the halo re-reads, so the byte bound per step falls as 1/q
// (63 us / q at 256x256x100 f32 on an H100). Measured (PERF.md), the kernel
// is 8x slower than that bound and no q = 2 or 4 plan is the fastest: the
// largest windows fill a block's shared memory, so one 512-thread block runs
// per SM and its phases (load the window, continuity, column sums, momentum
// with ~25 shared loads per edge and level for its 8 Coriolis taps, store the
// core) do not overlap; and the halo rings that q > 1 recomputes cost more
// than the state passes it saves.

#include "tiled_window.cuh"

namespace {

using namespace lattice;

// Dynamic shared memory of one block (kernels/tiled_step.smem_bytes):
// state [2][8][sites][kc], ssh [2][2][sites], partial sums [2][2][sites],
// f_edge [6][sites], rts [2][sites]; the taps; the window's lattice sites and
// the small tables.
size_t smem_bytes(long long sites, int kc, size_t itemsize) {
  return itemsize * static_cast<size_t>(sites) * (16 * kc + 16) + 16 * kMaxTerms +
         sizeof(int) * (static_cast<size_t>(sites) + kSmallInts);
}

template <typename T>
struct TiledArgs {
  const T* ssh;
  const T* h;
  const T* u;
  const T* f_edge;
  const T* rts;
  const int* table;
  const T* weights;
  T* ssh_out;
  T* h_out;
  T* u_out;
  T dt, inv_dc, s_div;
  int ny2, nx, K, rt, ct, q, hm, hi, kc, n_tiles_i;
};

template <typename T, bool FB>
__global__ void __launch_bounds__(kThreads) tiled_step_kernel(const TiledArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int tile = blockIdx.x / n_ranks;
  const int tm = tile / a.n_tiles_i, ti = tile % a.n_tiles_i;
  const int Wm = a.rt + 2 * a.hm * a.q, Wi = a.ct + 2 * a.hi * a.q, W = Wm * Wi;
  const int kc = a.kc, k0 = rank * kc, kr = min(kc, a.K - k0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int plane = a.ny2 * a.nx;
  const int pk = W * kc;  // one plane of a level chunk
  const FastDiv by_kr(kr), by_w(W), by_wi(Wi);

  T* buf = reinterpret_cast<T*>(smem_raw);  // [2][8][W][kc]: h p0, h p1, u c0..c5
  T* ssh_s = buf + 16 * pk;                 // [2][2][W]
  T* part = ssh_s + 4 * W;                  // [2][2][W], by step parity
  T* f_s = part + 4 * W;                    // [6][W]
  T* rts_s = f_s + 6 * W;                   // [2][W]
  Tap<T>* taps = reinterpret_cast<Tap<T>*>(rts_s + 2 * W);  // [kMaxTerms]
  int* gs = reinterpret_cast<int*>(taps + kMaxTerms);      // [W]: lattice site
  int* nb = gs + W;         // per channel: neighbour cell (site offset)
  int* inc_u = nb + 6;      // per (p, j) = 3p + j, in level-chunk units: incoming edge,
  int* inc_self = nb + 12;  //   that edge's own cell,
  int* inc_nb = nb + 18;    //   and that edge's neighbour cell
  int* off = nb + 24;       // first tap of each channel (7)

  const int n_terms = a.table[0];
  for (int t = tid; t < n_terms; t += nt) {
    const int* tt = a.table + kHeader + 3 * t;
    taps[t].u = ((2 + tt[0]) * W + tt[1] * Wi + tt[2]) * kc;
    taps[t].f = tt[0] * W + tt[1] * Wi + tt[2];
    taps[t].w = a.weights[t];
  }
  if (tid < 6) {
    const int* tn = a.table + kNbr + 3 * tid;
    nb[tid] = tn[0] * W + tn[1] * Wi + tn[2];
    const int* tc = a.table + kInc + 3 * tid;  // p = tid / 3, j = tid % 3
    const int* te = a.table + kNbr + 3 * tc[0];
    const int d = tc[1] * Wi + tc[2];
    inc_u[tid] = ((2 + tc[0]) * W + d) * kc;
    inc_self[tid] = ((tc[0] & 1) * W + d) * kc;
    inc_nb[tid] = (te[0] * W + d + te[1] * Wi + te[2]) * kc;
  }
  if (tid < 7) off[tid] = a.table[kOff + tid];

  // the window, wrapped periodically, by async copies: this block's levels
  // of h and u, and ssh, f_edge and rts
  const int m_base = tm * a.rt - a.hm * a.q, i_base = ti * a.ct - a.hi * a.q;
  for (int s = tid; s < W; s += nt) {
    const int r = by_wi.div(s), c = by_wi.mod(s, r);
    const int g = wrap(m_base + r, a.ny2) * a.nx + wrap(i_base + c, a.nx);
    gs[s] = g;
    for (int p = 0; p < 2; ++p) {
      copy_async(ssh_s + p * W + s, a.ssh + p * plane + g);
      copy_async(rts_s + p * W + s, a.rts + p * plane + g);
    }
    for (int c6 = 0; c6 < 6; ++c6) copy_async(f_s + c6 * W + s, a.f_edge + c6 * plane + g);
  }
  __syncthreads();
  for (int e = tid; e < 8 * W * kr; e += nt) {
    const int t = by_kr.div(e), kl = by_kr.mod(e, t);
    const int ch = by_w.div(t), s = by_w.mod(t, ch);
    const int g = gs[s];
    copy_async(buf + ch * pk + s * kc + kl,
               ch < 2 ? a.h + (ch * plane + g) * a.K + k0 + kl
                      : a.u + ((ch - 2) * plane + g) * a.K + k0 + kl);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  const T dt_div = a.dt * a.s_div;
  const T pg_scale = T(-kGravity) * a.dt;
  for (int j = 0; j < a.q; ++j) {
    const T* cur = buf + (j & 1) * 8 * pk;
    T* nxt = buf + ((j + 1) & 1) * 8 * pk;
    const T* ssh_cur = ssh_s + (j & 1) * 2 * W;
    T* ssh_nxt = ssh_s + ((j + 1) & 1) * 2 * W;
    T* part_j = part + (j & 1) * 2 * W;

    // continuity: h' on the window less j halos and one ring (FB: the
    // pressure gradient reads the fresh ssh one ring out) or j + 1 halos (FE)
    const int hr0 = FB ? a.hm * j + 1 : a.hm * (j + 1);
    const int hc0 = FB ? a.hi * j + 1 : a.hi * (j + 1);
    const int hnc = Wi - 2 * hc0, hn = (Wm - 2 * hr0) * hnc;
    const FastDiv by_hnc(hnc), by_hn(hn);
    {
      int nbk[6], iu[6], isf[6], inb[6];
      for (int x = 0; x < 6; ++x) {
        nbk[x] = nb[x] * kc;
        iu[x] = inc_u[x], isf[x] = inc_self[x], inb[x] = inc_nb[x];
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
      part_j[p * W + (hr0 + r) * Wi + hc0 + c] = acc;
    }
    cluster.sync();
    for (int e = tid; e < 2 * hn; e += nt) {
      const int p = by_hn.div(e), t = by_hn.mod(e, p);
      const int r = by_hnc.div(t), c = by_hnc.mod(t, r);
      const int x = p * W + (hr0 + r) * Wi + hc0 + c;
      T v = *cluster.map_shared_rank(part_j + x, 0);
      for (int rr = 1; rr < n_ranks; ++rr) v += *cluster.map_shared_rank(part_j + x, rr);
      ssh_nxt[x] = v - rts_s[x];
    }
    __syncthreads();

    // momentum: u' = u + dt * (TRiSK Coriolis of u * f) + pg_scale * grad,
    // grad of the old ssh (FE) or the fresh one (FB), on the window less
    // j + 1 halos
    const T* pg = FB ? ssh_nxt : ssh_cur;
    const int ur0 = a.hm * (j + 1), uc0 = a.hi * (j + 1);
    const int unc = Wi - 2 * uc0, un = (Wm - 2 * ur0) * unc;
    const FastDiv by_unc(unc);
    for (int e = tid; e < un * kr; e += nt) {
      const int t = by_kr.div(e), kl = by_kr.mod(e, t);
      const int r = by_unc.div(t), c = by_unc.mod(t, r);
      const int s = (ur0 + r) * Wi + uc0 + c;
      const int base = s * kc + kl;
      for (int ch = 0; ch < 6; ++ch) {
        const int t0 = off[ch], t1 = off[ch + 1];
        T acc = T(0);
        for (int t2 = t0; t2 < t1; ++t2) {
          const Tap<T> tp = taps[t2];
          const T contrib = tp.w * (cur[base + tp.u] * f_s[s + tp.f]);
          acc = (t2 == t0) ? contrib : acc + contrib;
        }
        const T grad = (pg[s + nb[ch]] - pg[(ch & 1) * W + s]) * a.inv_dc;
        const int o = (2 + ch) * pk + base;
        nxt[o] = cur[o] + a.dt * acc + pg_scale * grad;
      }
    }
    __syncthreads();
  }

  // the tile's core, into the output buffers
  const T* fin = buf + (a.q & 1) * 8 * pk;
  const T* ssh_fin = ssh_s + (a.q & 1) * 2 * W;
  const int r0 = a.hm * a.q, c0 = a.hi * a.q, core = a.rt * a.ct;
  const FastDiv by_core(core), by_ct(a.ct);
  for (int e = tid; e < 8 * core * kr; e += nt) {
    const int t = by_kr.div(e), kl = by_kr.mod(e, t);
    const int ch = by_core.div(t), x = by_core.mod(t, ch);
    const int r = by_ct.div(x), c = by_ct.mod(x, r);
    const int g = (tm * a.rt + r) * a.nx + ti * a.ct + c;
    const T v = fin[ch * pk + ((r0 + r) * Wi + c0 + c) * kc + kl];
    if (ch < 2)
      a.h_out[(ch * plane + g) * a.K + k0 + kl] = v;
    else
      a.u_out[((ch - 2) * plane + g) * a.K + k0 + kl] = v;
  }
  if (rank == 0) {
    for (int e = tid; e < 2 * core; e += nt) {
      const int p = by_core.div(e), x = by_core.mod(e, p);
      const int r = by_ct.div(x), c = by_ct.mod(x, r);
      a.ssh_out[p * plane + (tm * a.rt + r) * a.nx + ti * a.ct + c] =
          ssh_fin[p * W + (r0 + r) * Wi + c0 + c];
    }
  }
  // no block may leave while another can still read its partial sums
  cluster.sync();
}

// The kernel's attribute, set once per instantiation: dynamic shared memory
// up to the device's opt-in limit.
template <typename T, bool FB>
int prepare(int max_smem) {
  static bool done = false;
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      tiled_step_kernel<T, FB>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  done = e == cudaSuccess;
  return static_cast<int>(e);
}

template <typename T, bool FB>
int launch(const TiledArgs<T>& a, int n_ranks, int n_tiles, size_t smem, int max_smem,
           cudaStream_t stream) {
  const int err = prepare<T, FB>(max_smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(n_ranks, n_tiles, smem, stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, tiled_step_kernel<T, FB>, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of one plan the device holds at once.
template <typename T, bool FB>
int active_clusters(int n_ranks, size_t smem, int max_smem, int* out) {
  const int err = prepare<T, FB>(max_smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(n_ranks, 1, smem, nullptr, attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, tiled_step_kernel<T, FB>, &cfg));
}

// n_steps steps from `in` into `out`, q per launch. Launch l writes `out`
// when n_launches - 1 - l is even and `tmp` otherwise, so the last launch
// lands in `out`, no launch writes the buffers it reads, and `in` is left
// as it is.
template <typename T>
int tiled_steps(const T* f_edge, const T* rts, const int* table, const T* weights,
                const T* ssh_in, const T* h_in, const T* u_in, T* ssh_out, T* h_out,
                T* u_out, T* ssh_tmp, T* h_tmp, T* u_tmp, double dt, double inv_dc,
                double s_div, int ny2, int nx, int k, int n_steps, int n_terms, int rt,
                int ct, int q, int hm, int hi, int kc, int fb, cudaStream_t stream) {
  if (!valid_shape(ny2, nx, k, n_steps, n_terms)) return cudaErrorInvalidValue;
  if (rt < 1 || ct < 1 || q < 1 || hm < 1 || hi < 1 || kc < 1 || ny2 % rt || nx % ct ||
      n_steps % q)
    return cudaErrorInvalidValue;
  const int n_ranks = (k + kc - 1) / kc;  // no block without levels
  if (n_ranks > kMaxCluster) return cudaErrorInvalidValue;
  const long long sites = static_cast<long long>(rt + 2 * hm * q) * (ct + 2 * hi * q);
  const size_t smem = smem_bytes(sites, kc, sizeof(T));
  int max_smem = 0;
  const int e = opt_in_smem(&max_smem);
  if (e != 0) return e;
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  const int n_tiles = (ny2 / rt) * (nx / ct);
  TiledArgs<T> a{nullptr, nullptr, nullptr, f_edge, rts, table, weights,
                 nullptr, nullptr, nullptr, T(dt), T(inv_dc), T(s_div),
                 ny2, nx, k, rt, ct, q, hm, hi, kc, nx / ct};
  a.ssh = ssh_in, a.h = h_in, a.u = u_in;
  const int n_launches = n_steps / q;
  for (int l = 0; l < n_launches; ++l) {
    const bool to_out = ((n_launches - 1 - l) & 1) == 0;
    a.ssh_out = to_out ? ssh_out : ssh_tmp;
    a.h_out = to_out ? h_out : h_tmp;
    a.u_out = to_out ? u_out : u_tmp;
    const int err = fb ? launch<T, true>(a, n_ranks, n_tiles, smem, max_smem, stream)
                       : launch<T, false>(a, n_ranks, n_tiles, smem, max_smem, stream);
    if (err != 0) return err;
    a.ssh = a.ssh_out, a.h = a.h_out, a.u = a.u_out;
  }
  return 0;
}

}  // namespace

// Returns 0 or the CUDA error of the first launch that failed
// (cudaErrorInvalidValue for a plan the lattice or the card does not take).
#define MOT_TILED_ENTRY(T, SUFFIX)                                                          \
  extern "C" int mot_tiled_steps_##SUFFIX(                                                  \
      const T* f_edge, const T* rts, const int* table, const T* weights, const T* ssh_in,   \
      const T* h_in, const T* u_in, T* ssh_out, T* h_out, T* u_out, T* ssh_tmp, T* h_tmp,   \
      T* u_tmp, double dt, double inv_dc, double s_div, int ny2, int nx, int k,             \
      int n_steps, int n_terms, int rt, int ct, int q, int hm, int hi, int kc, int fb,      \
      void* stream) {                                                                       \
    return tiled_steps<T>(f_edge, rts, table, weights, ssh_in, h_in, u_in, ssh_out, h_out,  \
                          u_out, ssh_tmp, h_tmp, u_tmp, dt, inv_dc, s_div, ny2, nx, k,      \
                          n_steps, n_terms, rt, ct, q, hm, hi, kc, fb,                      \
                          static_cast<cudaStream_t>(stream));                               \
  }

MOT_TILED_ENTRY(float, f32)
MOT_TILED_ENTRY(double, f64)

// How many clusters of a plan (f32, FE) the device holds at once, into *out;
// returns 0 or the CUDA error.
extern "C" int mot_tiled_active_clusters(int sites, int kc, int n_ranks, int* out) {
  int max_smem = 0;
  const int e = opt_in_smem(&max_smem);
  if (e != 0) return e;
  const size_t smem = smem_bytes(sites, kc, sizeof(float));
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  return active_clusters<float, false>(n_ranks, smem, max_smem, out);
}
