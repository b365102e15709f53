// Tiled reverse (adjoint) of the q-step superstep of the linear TRiSK
// shallow-water core on the parity-plane hex lattice, forward Euler, for
// NVIDIA Hopper (sm_90a).
//
// Replaces: _tiled_adjoint_kernel (mpas_ocean_tpu/structured/pallas_model.py:
// 1979), the arms with nl_terms off (fb=False is fixed there), periodic
// (masks off) and masked (a coastal channel: the vjp of _window_steps with
// masks_full, :2001-2006, 2063), unforced and forced (the wind and
// level-index windows, whose cotangents d(wind) and dscal[3:6] it returns,
// :2938-2941), without tracers and with them (the tracer blocks and the cell
// mask, :2017-2104), unstratified and stratified (W whole, :2022-2035, its
// per-tile d(W), :2113-2118, 2143-2146, 2235-2238), in any combination and
// at any q (the JAX kernel's q=, :2284). The TPU kernel traces jax.vjp of
// _window_steps in-kernel and emits the cotangent of the whole padded window,
// which its caller overlap-adds (_halo_unscatter). CUDA has no vjp, so the
// transpose is written out by hand, as in adjoint_step.cu; and it is taken in
// gather form: a tile computes the cotangent of its own core only, from the
// end cotangent read with halos, so there is no overlap-add pass and no
// atomics. One launch maps (primal state at the superstep start, cotangent at
// its end) to (cotangent at its start, the blocks' shares of d(dt)).
//
// Layout as in tiled_step.cu; the stack holds the primal state of superstep
// s in slot s: ssh (S, 2, ny2, nx), h (S, 2, ny2, nx, K), u (S, 6, ny2, nx, K).
//
// Scheme. reach = (hm, hi) sites per side is what one step reads (the
// forward step's and the transposed step's tables both reach (1, 2):
// slab.stencil_reach, slab.adjoint_stencil_reach). Let R_j be the tile's core
// grown by j reaches per side. The cotangent at step j on R_j needs the
// cotangent at step j + 1 on R_{j+1} and the primal state j on R_{j+1}. So a
// tile reads the start primal on the window R_{2q-1} and the end cotangent
// (on all of it); for q > 1 it first recomputes the primal states 1 .. q - 1
// forward in shared memory (tiled_step.cu's FE step), then runs the q reverse
// steps on the shrinking R_j. At q = 1 there is no recompute, and the launch
// computes what adjoint_step.cu's does, on tiles that divide the lattice.
// The transpose is adjoint_step.cu's (there with its formulas).
//
// What bound the first design (PERF.md): 17% of the byte bound on an H100
// (551 us per launch at 256x256x100 f32 against 94.5): one block per SM (a
// 186 KB window at (8, 16)), a staging by 4-byte copies with three divisions
// each, a 16-byte tap record read from shared memory per tap in a runtime
// loop, and phases split by barriers with nothing to overlap them.
//
// This design, adjoint_step.cu's with q steps. A thread-block cluster holds
// a tile and its blocks split the levels: in power-of-two chunks at q = 1 (16
// at K = 100, moved by 16-byte async copies), and in the fewest levels per
// block at q > 1 (13 at K = 100), whose window holds q primal copies and two
// cotangent copies (kernels/tiled_adjoint.level_split). The forward and the
// transposed stencils are resolved on the host into constant-bank offsets
// (step_window.cuh's hex::, adjoint_window.cuh's hex_adj::): each source is
// loaded once and every tap loop is unrolled; the entry refuses any other
// table. Groups of lanes take consecutive levels of one site. Levels couple
// through ssh in the recompute and through S_e in the reverse: each block
// stores its per-site partial sums, and the cluster adds them in rank order.
// Between steps every block gathers them from every rank's shared memory
// (behind a cluster barrier, two arrays in turn); after the last step rank 0
// alone needs them, and each block stores them into rank 0's shared memory.
// gs is folded into gh (G) where it enters. Each block writes one d(dt) share
// (float64, a fixed order), summed per call by one small kernel: no atomics,
// so f64 reruns are bitwise equal. At q = 1 the window leaves room for two
// 512-thread blocks per SM at the planner's tile (structured/tiled_diff.py),
// and launches are programmatically dependent. Each kernel keeps its own
// step body: one shared forward step function cost tiled_step's FB arm 11.5%
// (PERF.md).
//
// The masked arm (kMasked, chosen by non-null live bits; the periodic arm
// keeps its code) takes the wall mask as one int of live bits per window
// site, copied with the window (step_window.cuh, load_live). It folds them
// into the staged end cotangent's gu once (adjoint_window.cuh, fold_live: a
// masked step's output cotangent enters as m * gu), the recompute writes
// u' = 0 on masked channels as tiled_step.cu does, and each reverse step
// stores its cotangent's gu so folded for the next step to read.
//
// The forced arm (kForced, chosen by a non-null wind; the unforced arm keeps
// its code) forces the recompute's steps as tiled_step.cu does and
// transposes dt F in every reverse step as adjoint_step.cu does, on R_j's
// sites; the ranks whose chunk holds some edge's top or bottom level stage
// the window's winds and packed levels and run the wind and drag terms in
// passes over the edges and cells (step_window.cuh, wind_drag_pass;
// adjoint_window.cuh, wind_drag_adjoint_pass and dh_pass). Of the cotangents of the forcing's
// inputs a tile adds its core's only: d(wind) at its core edges' top levels,
// in place over its q steps (one block owns each edge's top level; the
// steps are apart by barriers), and its blocks' shares of d(r_lin), d(Cd)
// and d(lambda) in double beside d(dt).
//
// The tracer arm (kTracers, chosen by a non-null tracer pointer; the
// tracer-free arms keep their code) is adjoint_step.cu's: the tracer planes
// staged after the state's in the primal and the cotangent chunks, a and the
// h' feedback folded once per window from h' and T' of the superstep's end
// state (adjoint_window.cuh, fold_tracers), and the tracer transpose's sums
// added in the body (tracer_adjoint), one block per SM as there. At q > 1
// the recompute carries the tracer planes (tiled_step.cu's tracer_step), a
// reverse step j > 0 stores the tracers' cotangent in cotangent j's planes,
// and after its gs fold a and the h' feedback of cotangent j are folded
// from the primal state j, h' and T' of the step before it, which the block
// holds (fold_tracers_window).
//
// The stratified arm (kStrat, chosen by a non-null W; the unstratified arms
// keep their code) is adjoint_step.cu's: the body stores its S chunk at the
// core's cells, and after a cluster barrier the pass of adjoint_window.cuh
// (strat_adjoint_pass) adds W dPhi to the stored dh, forms the tile's d(W)
// rows in double into its accumulator and d(dt)'s h @ W part. At q > 1 the
// recompute's pressure is the gradient of Phi of the old state, formed at
// each step from every rank's h chunk in place (chunk_phi, into the second
// cotangent chunk, free until the reverse steps), and each reverse step j
// stores S on R_j and runs the pass on R_j after its body
// (strat_region_pass): W dPhi into R_j's dh, before cotangent j is folded
// and read, and d(W) and d(dt) over the core's cells only, each cell
// counted by the tile that owns it.
//
// Shared memory at q > 1 with tracers. A block holds q primal chunks and
// two cotangent chunks of 8 + 2 nT planes, (8 + 2 nT)(q + 2) kc values per
// window site. At q = 2 with two tracers, K = 100 f32 and the 8-block
// split's 13 levels a block, even the (1, 1) tile's window (R_3, 7 x 13
// sites) takes 234608 bytes, and with forcing and stratification 247328,
// more than a block's 232448 (kernels/tiled_adjoint.smem_bytes mirrors
// smem_bytes). So at q > 1 the tracer arm splits the levels over up to
// kMaxWideCluster blocks (H100's non-portable cluster size; 15 blocks of 7
// levels at K = 100), which fits the FTS arm's (2, 4) tile in 194784 bytes.
// Chunks are then not powers of two, which chunk_phi, fold_tracers_window,
// load_tracer_chunk and strat_region_pass take. The other choice, keeping
// the recomputed states in device memory and one primal chunk here, saves a
// quarter of the chunks at q = 2: the FTS arm would fit the (1, 1) tile
// only, with a second copy of each state through device memory.
//
// The forced, tracer and stratified arms compose in any combination as in
// adjoint_step.cu, at q = 1 and at q > 1 (16 instantiations per dtype each;
// tiled_adjoint_f64.cu holds the f64 ones).
//
// What bounds it: a reverse step reads the primal state and the end
// cotangent and writes the start cotangent, three state passes, 94 us at
// 256x256x100 f32 at 3.35 TB/s, plus the halo re-reads. Measured (f32,
// NVIDIA H100 80GB HBM3 at 700 W; PERF.md section 5): 28% of that bound at
// 256x256x100 (331 us per launch at the planner's (4, 8, 1)), as
// adjoint_step.cu on the same tile; the first design reached 17%.

#include "adjoint_window.cuh"

namespace {

using namespace lattice;

template <typename T>
struct TiledArgs {
  const T* ssh;  // primal state at the superstep start
  const T* h;
  const T* u;
  const T* gs;  // cotangent at its end
  const T* gh;
  const T* gu;
  const T* f_edge;
  const T* rts;
  const int* live;  // the masked arm's live bits, (ny2, nx); null otherwise
  T* ds;  // cotangent at its start
  T* dh;
  T* du;
  double* ddt_part;  // one share per block: (tile, rank); the forced arm's
                     // three more kinds n_shares apart
  ForcingArgs<T> fc;  // the forced arm's operands; wind null otherwise
  T* dwind;           // the forced arm's d(wind) (6, ny2, nx), added to
  AdjTracers<T> at;   // the tracer arm's operands; tr null otherwise
  AdjStrat<T> st;     // the stratified arm's operands; w null otherwise
  NbrReach nr;        // the pressure gradient's reach (the recompute's Phi, q > 1)
  T dt, inv_dc, s_div;
  int ny2, nx, K, rt, ct, q, hm, hi, kc, kp_log2, vec_log2, n_tiles_i;
  long long n_shares;
};

// Most blocks in a cluster of the tracer arm at q > 1, whose q + 2 chunks of
// 8 + 2 nT planes take the fewest levels per block: H100's non-portable
// cluster size (kernels/tiled_adjoint.WIDE_CLUSTER).
constexpr int kMaxWideCluster = 16;

// Per-window-site planes besides the level chunks: f_edge [6], gs [2], and
// per primal state its ssh [2]; at q > 1 also rts [2] and two arrays of
// partial sums [2][2].
inline int site_planes(int q) { return 8 + 2 * q + (q > 1 ? 6 : 0); }

// Dynamic shared memory of one block (kernels/tiled_adjoint.smem_bytes
// mirrors this): the warps' d(dt) sums; q primal chunks and one cotangent
// chunk (two at q > 1) [8][sites][kc], with the tracer arm's 2 n_tr planes
// after each chunk's 8; the per-site planes; the ranks' partial sums of the
// core for rank 0 [n_ranks][2][core]; the sites and the masked arm's live
// bits, reserved by the periodic arm too so that one plan serves both; the
// forced arm's winds and packed levels beyond, then the stratified arm's S
// chunk on s_cells cells (the core at q = 1, R_{q-1} at q > 1) and W rows
// at k levels (strat_k > 0), in chunks of 2^kc_log2 >= kc levels.
size_t smem_bytes(long long sites, int core, int s_cells, int kc, int kc_log2, int q,
                  int n_ranks, size_t itemsize, bool forced, int n_tr, int strat_k) {
  const size_t chunks =
      static_cast<size_t>(8 + 2 * n_tr) * static_cast<size_t>(q + (q > 1 ? 2 : 1)) * kc;
  return sizeof(double) * kRedDoubles +
         itemsize * (static_cast<size_t>(sites) * (chunks + site_planes(q)) +
                     static_cast<size_t>(n_ranks) * 2 * core) +
         sizeof(int) * static_cast<size_t>(sites) * 2 +  // sites, live bits
         (forced ? forcing_smem_bytes(sites, 0, itemsize) : 0) +
         (strat_k > 0 ? strat_adj_smem_bytes(s_cells, 1 << kc_log2, strat_k, itemsize) : 0);
}

// Sum over the `width` lanes of a group (a power of two <= 32) in lane
// order, each lane's value added to the sum of the lanes before it: with one
// level per lane, the levels in order, as the plain version's column sum
// runs. Every lane gets the sum. The recompute's ssh = sum_k h - rts is a
// small difference of two large sums, whose rounding grad(ssh) carries into
// d(dt); this keeps it that of a sum level by level.
template <typename T>
__device__ __forceinline__ T ordered_group_sum(T v, int width) {
  T sum = __shfl_sync(0xffffffffu, v, 0, width);
  for (int l = 1; l < width; ++l) sum += __shfl_sync(0xffffffffu, v, l, width);
  return sum;
}

// Where a step's region of a window lies: rows r0 .. r0 + nr - 1, columns
// c0 .. c0 + nc - 1, n = nr * nc sites.
struct Region {
  int r0, c0, nr, nc, n;
};

__device__ __forceinline__ Region shrunk(int Wm, int Wi, int dr, int dc) {
  return {dr, dc, Wm - 2 * dr, Wi - 2 * dc, (Wm - 2 * dr) * (Wi - 2 * dc)};
}

// ssh of a new primal state, or gs of a cotangent, on a region: every
// block's partials `part` (stored by each block into its own shared memory,
// [2][W]) added in rank order after a cluster barrier; dst = scale * sum -
// sub (sub may be null). Ends with __syncthreads.
template <typename T>
__device__ __forceinline__ void gather(cg::cluster_group& cluster, T* part, T* dst,
                                       const T* sub, T scale, const Region& rg, int W, int Wi,
                                       int n_ranks) {
  cluster.sync();
  const FastDiv by_nc(rg.nc);
  for (int e = threadIdx.x; e < 2 * rg.n; e += blockDim.x) {
    const int p = e >= rg.n ? 1 : 0, t = e - p * rg.n;
    const int r = by_nc.div(t), c = by_nc.mod(t, r);
    const int x = p * W + (rg.r0 + r) * Wi + rg.c0 + c;
    T v = *cluster.map_shared_rank(part + x, 0);
    for (int rr = 1; rr < n_ranks; ++rr) v += *cluster.map_shared_rank(part + x, rr);
    dst[x] = sub ? scale * v - sub[x] : scale * v;
  }
  __syncthreads();
}

// The recompute's Phi = g ssh + h @ W at this block's kr levels on a region
// of the window, into phi [2][W][kc], from every rank's chunk of the primal
// h ([2][W][kc], at the same offset in every rank's shared memory) read in
// place through distributed shared memory, in rank and level order (the
// sum over l in level order 0 .. K-1, as montgomery's), W (K, K) read from
// device memory. Chunks of any width (montgomery's are powers of two).
// Needs every rank's h visible (a cluster barrier after its last write);
// ends with a block barrier.
template <typename T>
__device__ __forceinline__ void chunk_phi(T* phi, cg::cluster_group& cluster, const T* h,
                                          const T* ssh, const T* w, const Region& rg, int W,
                                          int Wi, int kc, int kr, int k0, int K, int n_ranks) {
  const int pk = W * kc;
  const FastDiv by_nc(rg.nc), by_kc(kc);
  for (int e = threadIdx.x; e < 2 * rg.n * kc; e += blockDim.x) {
    const int pt = by_kc.div(e), kl = by_kc.mod(e, pt);
    if (kl >= kr) continue;
    const int p = pt >= rg.n ? 1 : 0, t = pt - p * rg.n;
    const int r = by_nc.div(t), c = by_nc.mod(t, r);
    const int s = (rg.r0 + r) * Wi + rg.c0 + c;
    const T* wc = w + k0 + kl;
    T sum = T(0);
    for (int rr = 0; rr < n_ranks; ++rr) {
      const T* src = cluster.map_shared_rank(const_cast<T*>(h), rr) + p * pk + s * kc;
      const int kr2 = min(kc, K - rr * kc);
      for (int l = 0; l < kr2; ++l) sum += src[l] * wc[(rr * kc + l) * K];
    }
    phi[p * pk + s * kc + kl] = T(kGravity) * ssh[p * W + s] + sum;
  }
  __syncthreads();
}

// The tracer transpose's first half on a region (fold_tracers' arithmetic)
// at q > 1, for the cotangent of a state j > 0 that the superstep holds:
// h' and T' are the primal state j's, in shared memory (`prim`, its tracer
// planes after its 8).
template <typename T>
__device__ __forceinline__ void fold_tracers_window(T* cot, const T* prim, const int* gsite,
                                                    const AdjTracers<T>& at, const Region& rg,
                                                    int W, int Wi, int kc, int kr, int plane) {
  const int pk = W * kc;
  const FastDiv by_nc(rg.nc), by_kc(kc);
  for (int e = threadIdx.x; e < 2 * rg.n * kc; e += blockDim.x) {
    const int pt = by_kc.div(e), kl = by_kc.mod(e, pt);
    if (kl >= kr) continue;
    const int p = pt >= rg.n ? 1 : 0, t = pt - p * rg.n;
    const int r = by_nc.div(t), c = by_nc.mod(t, r);
    const int s = (rg.r0 + r) * Wi + rg.c0 + c;
    const int b = s * kc + kl;
    const T hn = prim[p * pk + b];
    const bool live = at.cmask == nullptr || at.cmask[p * plane + gsite[s]] > T(0);
    T corr = T(0);
    for (int t2 = 0; t2 < at.n; ++t2) {
      T* ap = cot + (8 + 2 * t2 + p) * pk + b;
      const T a = live ? *ap / hn : T(0);
      *ap = a;
      corr += a * prim[(8 + 2 * t2 + p) * pk + b];
    }
    cot[p * pk + b] -= corr;
  }
}

// The stratified arm's pass of a reverse step at q > 1: strat_adjoint_pass's
// arithmetic on the step's region R_j, whose S chunk the body stored (sl
// [2][R_j][2^kc_log2], W's rows of the block's levels in wt [K][2^kc_log2]),
// between the same cluster barriers. dh += (dt / dc) sum_k W[k0 + kl][k]
// S[k] at R_j's cells (`dh(p, t, kl)`: R_j's cell t's stored cotangent, in
// shared memory or, at j = 0, the output); over the core's cells only (each
// cell counted by the tile that owns it), d(W)'s rows of the block's levels
// into the tile's accumulator `acc` in double and d(dt)'s h @ W part into
// *share, h the primal state j's chunk `P` [2][W][kc]. Level k lies in rank
// k / kc's chunk, which need not be a power of two.
template <typename T, typename Dh>
__device__ __forceinline__ void strat_region_pass(const StratAdjSmem<T>& sm,
                                                  cg::cluster_group& cluster, const T* P,
                                                  const Region& rg, int core_r, int core_c,
                                                  int rt, int ct, double* acc, bool first,
                                                  Dh dh, int W, int Wi, int kc, int kc_log2,
                                                  int k0, int kr, int K, int n_ranks, T dt,
                                                  T inv_dc, double* share) {
  const int kp = 1 << kc_log2, pk = W * kc;
  const T dt_inv_dc = dt * inv_dc;
  for (int e = threadIdx.x; e < (2 * rg.n << kc_log2); e += blockDim.x) {
    const int kl = e & (kp - 1), pt = e >> kc_log2;
    if (kl >= kr) continue;
    const int p = pt >= rg.n ? 1 : 0;
    T* d = dh(p, pt - p * rg.n, kl);
    T sum = T(0);
    for (int rr = 0; rr < n_ranks; ++rr) {
      const T* src = cluster.map_shared_rank(sm.sl, rr) + (pt << kc_log2);
      const T* wr = sm.wt + ((rr * kc) << kc_log2) + kl;
      const int kr2 = min(kc, K - rr * kc);
      for (int kk = 0; kk < kr2; ++kk) sum += wr[kk << kc_log2] * src[kk];
    }
    *d = *d + dt_inv_dc * sum;
  }
  const double s_dw = static_cast<double>(dt) * static_cast<double>(inv_dc);
  const double s_dd = static_cast<double>(inv_dc);
  for (int e = threadIdx.x; e < (K << kc_log2); e += blockDim.x) {
    const int kl = e & (kp - 1), k = e >> kc_log2;
    if (kl >= kr) continue;
    const int rk = k / kc;
    const T* src = cluster.map_shared_rank(sm.sl, rk) + (k - rk * kc);
    double sum = 0.0;
    for (int p = 0; p < 2; ++p)
      for (int r = 0; r < rt; ++r)
        for (int c = 0; c < ct; ++c) {
          const int t = (core_r - rg.r0 + r) * rg.nc + core_c - rg.c0 + c;
          const int sw = (core_r + r) * Wi + core_c + c;
          sum = fma(static_cast<double>(P[p * pk + sw * kc + kl]),
                    static_cast<double>(src[(p * rg.n + t) << kc_log2]), sum);
        }
    double* a = acc + static_cast<size_t>(k) * K + k0 + kl;
    *a = first ? s_dw * sum : *a + s_dw * sum;
    *share += s_dd * static_cast<double>(sm.wt[e]) * sum;
  }
}

// The block's level chunk of n_planes tracer planes over the window into
// dst [n_planes][W][kc], one value per async copy (load_tracers' layout at
// chunks of any width).
template <typename T>
__device__ __forceinline__ void load_tracer_chunk(T* dst, const int* gs, const T* tr,
                                                  int n_planes, int W, int kc, int k0, int kr,
                                                  int K, int plane) {
  const FastDiv by_kc(kc);
  for (int e = threadIdx.x; e < n_planes * W * kc; e += blockDim.x) {
    const int q = by_kc.div(e), kl = by_kc.mod(e, q);
    if (kl >= kr) continue;
    const int ch = q / W, s = q - ch * W;
    copy_async(dst + e, tr + (static_cast<size_t>(ch) * plane + gs[s]) * K + k0 + kl);
  }
}

// kMulti: q > 1. The q = 1 instantiation compiles without the recompute and
// the exchanges between steps, which cost one body for all q 11% at q = 1
// (PERF.md). kMasked: the masked arm. kForced: the forced arm. kTracers: the
// tracer arm. kStrat: the stratified arm.
template <typename T, bool kMulti, bool kMasked, bool kForced, bool kTracers, bool kStrat>
__global__ void __launch_bounds__(kStepThreads, kTracers ? 1 : 2)
    tiled_adjoint_kernel(const TiledArgs<T> a, const AdjTaps<T> tp, const StepTaps<T> fw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int tile = blockIdx.x / n_ranks;
  const int tm = tile / a.n_tiles_i, ti = tile % a.n_tiles_i;
  const int q = kMulti ? a.q : 1, span = 2 * q - 1;  // the window is R_span
  const int Wm = a.rt + 2 * a.hm * span, Wi = a.ct + 2 * a.hi * span, W = Wm * Wi;
  const int kc = a.kc, k0 = rank * kc, kr = min(kc, a.K - k0);
  const int plane = a.ny2 * a.nx;
  const int pk = W * kc;  // one plane of a level chunk
  const int K = a.K;
  const int core = a.rt * a.ct;
  const int n_cot = kMulti ? 2 : 1;
  // the tracer arm's planes follow the state's, in the primal and the cotangent
  const int n_pl = kTracers ? 8 + 2 * a.at.n : 8;
  // the stratified arm's S cells: the core, or at q > 1 R_{q-1}, the
  // largest region a reverse step stores
  const int s_cells = (a.rt + 2 * a.hm * (q - 1)) * (a.ct + 2 * a.hi * (q - 1));

  double* red = reinterpret_cast<double*>(smem_raw);  // [kRedDoubles]
  T* prim = reinterpret_cast<T*>(red + kRedDoubles);  // [q][n_pl][W][kc]
  T* cot = prim + q * n_pl * pk;                      // [n_cot][n_pl][W][kc]: G, gu, a
  T* ssh_s = cot + n_cot * n_pl * pk;                 // [q][2][W]
  T* gs_s = ssh_s + q * 2 * W;                        // [2][W]
  T* f_s = gs_s + 2 * W;                              // [6][W]
  T* rts_s = f_s + 6 * W;                             // [2][W], q > 1
  T* part = rts_s + (kMulti ? 2 * W : 0);             // [2][2][W], q > 1
  T* recv = part + (kMulti ? 4 * W : 0);              // [n_ranks][2][core]: rank 0's
  int* gsite = reinterpret_cast<int*>(recv + n_ranks * 2 * core);  // [W]: lattice site
  int* live_s = gsite + W;                            // [W]: the masked arm's live bits
  const ForcingSmem<T> fsm(live_s + W, W, 0);        // the forced arm's winds and levels
  // the stratified arm's S and W rows, after the forced arm's
  const StratAdjSmem<T> ssm(kForced ? static_cast<void*>(fsm.lvl + 6 * W) : live_s + W,
                            kMulti ? s_cells : core, kMulti ? 1 << a.kp_log2 : kc);

  cluster_arrive_relaxed();
  allow_next_grid();
  window_sites(gsite, tm * a.rt - a.hm * span, ti * a.ct - a.hi * span, Wi, W, a.ny2, a.nx,
               0);
  __syncthreads();
  wait_previous_grid();
  for (int s = threadIdx.x; s < W; s += blockDim.x) {
    const int g = gsite[s];
    for (int c6 = 0; c6 < 6; ++c6) copy_async(f_s + c6 * W + s, a.f_edge + c6 * plane + g);
    if (kMulti)
      for (int p = 0; p < 2; ++p) copy_async(rts_s + p * W + s, a.rts + p * plane + g);
  }
  load_chunk(prim, ssh_s, gsite, a.ssh, a.h, a.u, W, kc, a.kp_log2, a.vec_log2, k0, kr, K,
             plane);
  load_chunk(cot, gs_s, gsite, a.gs, a.gh, a.gu, W, kc, a.kp_log2, a.vec_log2, k0, kr, K,
             plane);
  if (kMasked) load_live(live_s, gsite, a.live, W);
  if (kForced) load_forcing(fsm, gsite, a.fc, W, plane, rank);
  if (kTracers && !kMulti) {
    load_tracers(prim + 8 * pk, gsite, a.at.tr, 2 * a.at.n, W, a.kp_log2, a.vec_log2, k0, kr,
                 K, plane);
    load_tracers(cot + 8 * pk, gsite, a.at.gtr, 2 * a.at.n, W, a.kp_log2, a.vec_log2, k0, kr,
                 K, plane);
  }
  if (kTracers && kMulti) {  // chunks of any width
    load_tracer_chunk(prim + 8 * pk, gsite, a.at.tr, 2 * a.at.n, W, kc, k0, kr, K, plane);
    load_tracer_chunk(cot + 8 * pk, gsite, a.at.gtr, 2 * a.at.n, W, kc, k0, kr, K, plane);
  }
  if (kStrat) load_strat_rows(ssm, a.st.w, kMulti ? s_cells : core, K, k0, kr, a.kp_log2);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  fold_ssh(cot, gs_s, W, Wi, 0, 0, Wm, Wi, kc, a.kp_log2, kr);
  if (kMasked) fold_live(cot + 2 * pk, live_s, W, kc, kr);
  __syncthreads();
  if (kTracers) {
    fold_tracers(cot, gsite, a.at, W, kc, a.kp_log2, k0, kr, K, plane);
    __syncthreads();
  }
  cluster_wait();
  // the recompute's Phi reads every rank's primal h chunk
  if (kMulti && kStrat) cluster.sync();

  const T dt_div = a.dt * a.s_div;
  const T grav = T(kGravity);
  const T pg_scale = -grav * a.dt;
  const T ds_scale = grav * a.dt * a.inv_dc;
  const T dt_rayl = a.dt * a.fc.rayl;  // the forced arm's Rayleigh factor
  // the forced arm: whether this block's chunk holds some edge's top or
  // bottom level (then its window's levels are staged and its passes run)
  const bool wd = kForced && ((a.fc.lvl_ranks >> rank) & 1u);
  // groups of G = min(16, 2^kp_log2) lanes, one site each, 32 / G sites per warp
  const int g_log2 = min(a.kp_log2, kLanesLog2), G = 1 << g_log2;
  const int lane = threadIdx.x & (G - 1), sub = (threadIdx.x & 31) >> g_log2;
  const int warp_sites = 32 >> g_log2;
  const int site_stride = static_cast<int>(blockDim.x >> 5) * warp_sites;
  const int warp_base = static_cast<int>(threadIdx.x >> 5) * warp_sites;
  int xchg = 0;  // exchanges through `part` so far: its parity picks the array

  // the primal states 1 .. q - 1, forward on the window less j + 1 reaches
  // (the tracer arm's planes carried as tiled_step.cu's; the stratified
  // arm's pressure the gradient of Phi, formed first into the second
  // cotangent chunk, which the reverse steps do not use yet)
  const T pg_rec = kStrat ? -a.dt : pg_scale;
  T* phi = cot + n_pl * pk;
  for (int j = 0; kMulti && j + 1 < q; ++j, ++xchg) {
    const T* cur = prim + j * n_pl * pk;
    T* nxt = prim + (j + 1) * n_pl * pk;
    const T* ssh_c = ssh_s + j * 2 * W;
    T* sums = part + (xchg & 1) * 2 * W;
    const Region rg = shrunk(Wm, Wi, a.hm * (j + 1), a.hi * (j + 1));
    const FastDiv by_nc(rg.nc);
    if (kStrat) {
      const Region pr{rg.r0 + a.nr.m0, rg.c0 + a.nr.i0, rg.nr + a.nr.m1 - a.nr.m0,
                      rg.nc + a.nr.i1 - a.nr.i0,
                      (rg.nr + a.nr.m1 - a.nr.m0) * (rg.nc + a.nr.i1 - a.nr.i0)};
      chunk_phi(phi, cluster, cur, ssh_c, a.st.w, pr, W, Wi, kc, kr, k0, K, n_ranks);
    }
    for (int b = warp_base; b < rg.n; b += site_stride) {
      const int t = b + sub;
      const int tt = t < rg.n ? t : b;
      const int r = by_nc.div(tt), c = by_nc.mod(tt, r);
      const int s = (rg.r0 + r) * Wi + rg.c0 + c;
      T grad[6];
      if (!kStrat) {
#pragma unroll
        for (int ch = 0; ch < 6; ++ch)
          grad[ch] = (ssh_c[s + fw.nb[ch]] - ssh_c[(ch & 1) * W + s]) * a.inv_dc;
      }
      const unsigned live = kMasked ? static_cast<unsigned>(live_s[s]) : 0u;
      // the tracer arm's live bits of the incoming edges and live-cell mask
      T cm[2] = {T(1), T(1)};
      unsigned inc_live = 0u;
      if (kTracers && kMasked && t < rg.n) {
        inc_live = adj_incoming_live(live_s, s, tp);
        cm[0] = a.at.cmask[gsite[s]], cm[1] = a.at.cmask[plane + gsite[s]];
      }
      T acc0 = T(0), acc1 = T(0);
      for (int kl = lane; kl < kc; kl += G) {
        if (t >= rg.n || kl >= kr) continue;
        const T* lv = cur + s * kc + kl;
        T* o = nxt + s * kc + kl;
        if (kStrat) {
          const T* ph = phi + s * kc + kl;
#pragma unroll
          for (int ch = 0; ch < 6; ++ch)
            grad[ch] = (ph[fw.nb[ch] * kc] - ph[(ch & 1) * pk]) * a.inv_dc;
        }
        T hnew[2], unew[6];
        T u[hex::kU], h[hex::kH];
#pragma unroll
        for (int x = 0; x < hex::kU; ++x) u[x] = lv[fw.us[x]];
#pragma unroll
        for (int x = 0; x < hex::kH; ++x) h[x] = lv[fw.hs[x]];
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
        T uf[hex::kU];
#pragma unroll
        for (int x = 0; x < hex::kU; ++x) uf[x] = u[x] * f_s[s + fw.fs[x]];
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) {
          T acc = T(0);
#pragma unroll
          for (int x = 0; x < 8; ++x) {
            const int t2 = 8 * ch + x;
            const T contrib = fw.w[t2] * uf[hex::tap_u(t2)];
            acc = (x == 0) ? contrib : acc + contrib;
          }
          unew[ch] = u[hex::self_u(ch)] + a.dt * acc + pg_rec * grad[ch];
          if (kForced) unew[ch] = unew[ch] - dt_rayl * u[hex::self_u(ch)];
        }
        if (kMasked && live != kAllLive) {
#pragma unroll
          for (int ch = 0; ch < 6; ++ch)
            if (!((live >> ch) & 1u)) unew[ch] = T(0);
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) o[p * pk] = hnew[p];
#pragma unroll
        for (int ch = 0; ch < 6; ++ch) o[(2 + ch) * pk] = unew[ch];
        if (kTracers) {
          const TracerArgs<T> ftr{nullptr, nullptr, a.at.cmask, a.at.kappa, a.at.half_up,
                                  a.at.n, {}, {}};
          tracer_step<T, kMasked>(lv, pk, fw, u, h, hnew, cm, live, inc_live, ftr, dt_div,
                                  a.inv_dc, [&](int i, T v) { o[(8 + i) * pk] = v; });
        }
        acc0 += hnew[0];
        acc1 += hnew[1];
      }
      acc0 = ordered_group_sum(acc0, G);
      acc1 = ordered_group_sum(acc1, G);
      if (t < rg.n && lane == 0) {
        sums[s] = acc0;
        sums[W + s] = acc1;
      }
    }
    gather(cluster, sums, ssh_s + (j + 1) * 2 * W, rts_s, T(1), rg, W, Wi, n_ranks);
    if (kForced && wd) {
      // the wind and drag at the step's edges' top and bottom levels in this
      // block's chunk, added to the stored u'
      wind_drag_pass<T, kMasked>(
          cur, fw, fsm, live_s, rg.n,
          [&](int t) {
            const int r = by_nc.div(t);
            return (rg.r0 + r) * Wi + rg.c0 + by_nc.mod(t, r);
          },
          [&](int ch, int, int s, int kl) -> T& { return nxt[(2 + ch) * pk + s * kc + kl]; },
          W, kc, k0, kr, a.dt, a.fc);
      __syncthreads();
    }
  }

  // the reverse steps j = q - 1 .. 0: the cotangent on R_j from the one on
  // R_{j+1}; step 0 writes the core (R_0) into the output buffers
  const int core_r = a.hm * span, core_c = a.hi * span;
  double share = 0.0;
  // the forced arm's sums over the core's edges, in double, of gu u
  // (Rayleigh) and of the d(r_lin) and d(Cd) shares
  double s_rayl = 0.0, s_lin = 0.0, s_quad = 0.0;
  for (int j = q - 1; j >= 0; --j, ++xchg) {
    const T* P = prim + j * n_pl * pk;  // primal state j
    const T* ssh_p = ssh_s + j * 2 * W;
    const T* Cb = cot + ((q - 1 - j) & 1) * n_pl * pk;  // cotangent j + 1 (G, gu, a)
    T* Cn = cot + ((q - j) & 1) * n_pl * pk;            // cotangent j, for j > 0
    const Region rg = shrunk(Wm, Wi, a.hm * (span - j), a.hi * (span - j));
    const FastDiv by_nc(rg.nc);
    T* sums = j > 0 ? part + (xchg & 1) * 2 * W
                    : cluster.map_shared_rank(recv, 0) + rank * 2 * core;

    for (int b = warp_base; b < rg.n; b += site_stride) {
      const int t = b + sub;
      const int tt = t < rg.n ? t : b;
      const int r = by_nc.div(tt), c = by_nc.mod(tt, r);
      const int wr = rg.r0 + r, wc = rg.c0 + c;
      const int s = wr * Wi + wc;
      const bool in_core = wr >= core_r && wr < core_r + a.rt && wc >= core_c &&
                           wc < core_c + a.ct;
      const int g = (tm * a.rt + r) * a.nx + ti * a.ct + c;  // for j = 0 (R_0 = core)
      // the cotangent j's gu is stored as m * gu for step j - 1 to read
      const unsigned live = kMasked ? static_cast<unsigned>(live_s[s]) : 0u;
      // the masked tracer arm's live bits of the site's incoming edges
      const unsigned inc_live = kTracers && kMasked ? adj_incoming_live(live_s, s, tp) : 0u;
      T grad[6], fo[6];
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) {
        grad[ch] = (ssh_p[s + tp.nb[ch]] - ssh_p[(ch & 1) * W + s]) * a.inv_dc;
        fo[ch] = f_s[ch * W + s];
      }
      T acc0 = T(0), acc1 = T(0);
      for (int kl = lane; kl < kc; kl += G) {
        if (t >= rg.n || kl >= kr) continue;
        const T* Pl = P + s * kc + kl;
        const T* Cl = Cb + s * kc + kl;
        // the tracer arm's sums, which the transpose below adds, and its
        // per-cell d(dt) terms, which replace the per-edge <G, tend_h>; the
        // tracers' cotangent j to the output (j = 0, the core) or to
        // cotangent j's tracer planes
        T trF[6], trX[2], trY[2];
        double trdd = 0.0;
        if (kTracers)
          tracer_adjoint<T, kMasked>(Pl, Cl, pk, tp, a.at, live, inc_live, dt_div, a.s_div,
                                     a.inv_dc, trF, trX, trY, &trdd, [&](int i, T v) {
                                       if (j == 0)
                                         a.at.dtr[(static_cast<size_t>(i) * plane + g) * K + k0 +
                                                  kl] = v;
                                       else
                                         Cn[(8 + i) * pk + s * kc + kl] = v;
                                     });
        T gu[hex_adj::kGu], Gv[hex_adj::kG], h[hex_adj::kH], u[hex_adj::kU];
#pragma unroll
        for (int x = 0; x < hex_adj::kGu; ++x) gu[x] = Cl[tp.us[x]];
#pragma unroll
        for (int x = 0; x < hex_adj::kG; ++x) Gv[x] = Cl[tp.hs[x]];
#pragma unroll
        for (int x = 0; x < hex_adj::kH; ++x) h[x] = Pl[tp.hs[x]];
#pragma unroll
        for (int x = 0; x < hex_adj::kU; ++x) u[x] = Pl[tp.us[x]];
        T dh[2], du[6], S[2];
        // d(dt)'s terms: in T, or in double for the forced arm
        std::conditional_t<kForced, double, T> dd = 0;
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
            T ctr = T(0);
#pragma unroll
            for (int x = 0; x < 8; ++x) {
              const int t2 = 8 * ch + x;
              const T contrib = tp.w[t2] * gu[hex_adj::tap_u(t2)];
              ctr = (x == 0) ? contrib : ctr + contrib;
            }
            const T fct = fo[ch] * ctr;
            const T gue = gu[hex::self_u(ch)], ue = u[hex::self_u(ch)];
            du[ch] = gue + he * gflux + a.dt * fct;
            if (kForced) {
              du[ch] = du[ch] - dt_rayl * gue;
              rayl = fma(static_cast<double>(gue), static_cast<double>(ue), rayl);
            }
            flux += ue * gflux;
            dd += kTracers ? ue * fct - grav * grad[ch] * gue
                           : ue * (a.s_div * dG * he + fct) - grav * grad[ch] * gue;
          }
#pragma unroll
          for (int x = 3 * p; x < 3 * p + 3; ++x)
            flux += u[hex::inc_u(x)] * (dt_div * (Gc - Gv[hex::inc_self_h(x)]));
          dh[p] = kTracers ? Gc + T(0.5) * (flux + trX[p]) + trY[p] : Gc + T(0.5) * flux;
          S[p] = (gu[hex::self_u(p)] + gu[hex::self_u(2 + p)] + gu[hex::self_u(4 + p)]) -
                 (gu[hex::inc_u(3 * p)] + gu[hex::inc_u(3 * p + 1)] + gu[hex::inc_u(3 * p + 2)]);
        }
        if (kStrat) {  // the S chunk of R_j (q = 1: the core) for the stratified pass
          ssm.sl[(t << a.kp_log2) + kl] = S[0];
          ssm.sl[(((kMulti ? rg.n : core) + t) << a.kp_log2) + kl] = S[1];
        }
        if (j == 0) {
          T* h_o = a.dh + g * K + k0 + kl;
          T* u_o = a.du + g * K + k0 + kl;
#pragma unroll
          for (int p = 0; p < 2; ++p) h_o[p * plane * K] = dh[p];
#pragma unroll
          for (int ch = 0; ch < 6; ++ch) u_o[ch * plane * K] = du[ch];
        } else {
          if (kMasked && live != kAllLive) {
#pragma unroll
            for (int ch = 0; ch < 6; ++ch)
              if (!((live >> ch) & 1u)) du[ch] = T(0);
          }
          T* o = Cn + s * kc + kl;
#pragma unroll
          for (int p = 0; p < 2; ++p) o[p * pk] = dh[p];
#pragma unroll
          for (int ch = 0; ch < 6; ++ch)
            o[(2 + ch) * pk] = du[ch];
        }
        acc0 += S[0];
        acc1 += S[1];
        if (in_core) {
          share += static_cast<double>(dd);
          if (kTracers) share += trdd;
          if (kForced) {
            s_rayl += rayl;
          }
        }
      }
      acc0 = group_sum(acc0, G);
      acc1 = group_sum(acc1, G);
      if (t < rg.n && lane == 0) {
        const int x = j > 0 ? s : t;
        const int off = j > 0 ? W : core;
        sums[x] = acc0;
        sums[off + x] = acc1;
      }
    }
    if (kForced && wd) {
      // the wind and drag at R_j's owned edges' top and bottom levels in this
      // block's chunk: added to the stored du and, on the core, d(wind) and
      // the shares; then the h cotangent at R_j's cells' top and bottom levels
      // R_j's window sites, and a core site's lattice site
      const auto region_site = [&](int t) {
        const int r = by_nc.div(t);
        return (rg.r0 + r) * Wi + rg.c0 + by_nc.mod(t, r);
      };
      const auto core_site = [&](int t) {
        const int r = by_nc.div(t), c = by_nc.mod(t, r);
        return (tm * a.rt + rg.r0 + r - core_r) * a.nx + ti * a.ct + rg.c0 + c - core_c;
      };
      wind_drag_adjoint_pass(
          P, Cb, tp, fsm, rg.n, region_site,
          [&](int t) {
            const int r = by_nc.div(t), c = by_nc.mod(t, r);
            const int wr = rg.r0 + r, wc = rg.c0 + c;
            return wr >= core_r && wr < core_r + a.rt && wc >= core_c && wc < core_c + a.ct;
          },
          [&](int ch, int t, int s, int kl) -> T& {
            return j > 0 ? Cn[(2 + ch) * pk + s * kc + kl]
                         : a.du[(ch * plane + core_site(t)) * K + k0 + kl];
          },
          [&](int ch, int t) { return a.dwind + ch * plane + core_site(t); },
          W, kc, k0, kr, a.dt, a.fc, &share, &s_lin, &s_quad);
      dh_pass<kTracers>(P, Cb, tp, fsm, rg.n, region_site,
              [&](int p, int t, int s, int kl) -> T& {
                return j > 0 ? Cn[p * pk + s * kc + kl]
                             : a.dh[(p * plane + core_site(t)) * K + k0 + kl];
              },
              W, kc, k0, kr, a.dt, dt_div, a.fc);
      __syncthreads();
    }
    if (kMulti && kStrat) {
      // W dPhi into R_j's stored dh, the core's d(W) rows and d(dt)'s h @ W
      // part, once every rank's S chunk of R_j is visible
      cluster.sync();
      strat_region_pass(ssm, cluster, P, rg, core_r, core_c, a.rt, a.ct,
                        a.st.acc + static_cast<size_t>(tile) * K * K,
                        a.st.first != 0 && j == q - 1,
                        [&](int p, int t, int kl) -> T* {
                          const int r = by_nc.div(t), c = by_nc.mod(t, r);
                          if (j > 0)
                            return Cn + (p * W + (rg.r0 + r) * Wi + rg.c0 + c) * kc + kl;
                          return a.dh + (static_cast<size_t>(p) * plane +
                                         (tm * a.rt + r) * a.nx + ti * a.ct + c) * K + k0 + kl;
                        },
                        W, Wi, kc, a.kp_log2, k0, kr, K, n_ranks, a.dt, a.inv_dc, &share);
    }
    if (kMulti && j > 0) {
      // gs of cotangent j on R_j, then folded into its gh (G); the tracer
      // arm's a and h' feedback from the primal state j
      gather(cluster, sums, gs_s, static_cast<const T*>(nullptr), ds_scale, rg, W, Wi,
             n_ranks);
      fold_ssh(Cn, gs_s, W, Wi, rg.r0, rg.c0, rg.nr, rg.nc, kc, a.kp_log2, kr);
      __syncthreads();
      if (kTracers) {
        fold_tracers_window(Cn, P, gsite, a.at, rg, W, Wi, kc, kr, plane);
        __syncthreads();
      }
    }
  }
  if (kStrat && !kMulti) {
    // W dPhi into the stored dh, the tile's d(W) rows and d(dt)'s h @ W
    // part, once every rank's S chunk is visible
    cluster.sync();
    const FastDiv by_ct(a.ct);
    strat_adjoint_pass(
        ssm, cluster, WindowH<T>{prim, a.hm, a.hi, Wi, pk, a.kp_log2},
        a.st.acc + static_cast<size_t>(tile) * K * K, a.st.first != 0,
        [&](int p, int t, int kl) -> T* {
          const int r = by_ct.div(t), c = by_ct.mod(t, r);
          return a.dh + (p * plane + (tm * a.rt + r) * a.nx + ti * a.ct + c) * K + k0 + kl;
        },
        core, a.ct, a.kp_log2, k0, kr, K, n_ranks, a.dt, a.inv_dc, &share);
  }
  // the forced arm's Rayleigh part of d(dt), -lambda sum gu u
  if (kForced) share -= static_cast<double>(a.fc.rayl) * s_rayl;
  share_warps(share, red);

  // ds on the core: rank 0 adds the ranks' partial sums in rank order (the
  // barrier orders the remote stores above, and every block's gathers,
  // before it; no block reads another's shared memory after it, so none
  // waits to leave); each block's d(dt) share, and the forced arm's three more
  cluster.sync();
  if (threadIdx.x == 0) a.ddt_part[blockIdx.x] = share_total(red);
  if (kForced)
    write_forcing_shares(red, a.ddt_part + blockIdx.x, a.n_shares, s_lin, s_quad, s_rayl,
                         static_cast<double>(a.dt));
  if (rank != 0) return;
  const FastDiv by_ct(a.ct);
  for (int e = threadIdx.x; e < 2 * core; e += blockDim.x) {
    const int p = e >= core ? 1 : 0, x = e - p * core;
    const int r = by_ct.div(x), c = by_ct.mod(x, r);
    T v = recv[e];
    for (int rr = 1; rr < n_ranks; ++rr) v += recv[rr * 2 * core + e];
    a.ds[p * plane + (tm * a.rt + r) * a.nx + ti * a.ct + c] = ds_scale * v;
  }
}

// The kernel's attributes, set once per instantiation: dynamic shared memory
// up to the device's opt-in limit, and for the tracer arm at q > 1 clusters
// of up to kMaxWideCluster blocks.
template <typename T, bool kMulti, bool kMasked, bool kForced, bool kTracers, bool kStrat>
int prepare(int max_smem) {
  static bool done = false;
  if (done) return 0;
  const auto kernel = tiled_adjoint_kernel<T, kMulti, kMasked, kForced, kTracers, kStrat>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (e == cudaSuccess && kMulti && kTracers)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done = e == cudaSuccess;
  return static_cast<int>(e);
}

// The kernel of a plan, and its attribute: q > 1 or not, masked or not,
// forced or not, with tracers or not and stratified or not.
template <typename T>
using TiledKernel = void (*)(TiledArgs<T>, AdjTaps<T>, StepTaps<T>);
template <typename T>
struct TiledArm {
  TiledKernel<T> kernel;
  int (*prepare)(int);
};
template <typename T, bool kMulti, bool kMasked, bool kForced, bool kTracers = false,
          bool kStrat = false>
constexpr TiledArm<T> arm() {
  return {tiled_adjoint_kernel<T, kMulti, kMasked, kForced, kTracers, kStrat>,
          prepare<T, kMulti, kMasked, kForced, kTracers, kStrat>};
}
template <typename T, bool kMasked>
TiledArm<T> arm_of(bool multi, bool forced, bool tracers, bool strat) {
  static const TiledArm<T> multi_arms[8] = {
      arm<T, true, kMasked, false, false, false>(), arm<T, true, kMasked, false, false, true>(),
      arm<T, true, kMasked, false, true, false>(),  arm<T, true, kMasked, false, true, true>(),
      arm<T, true, kMasked, true, false, false>(),  arm<T, true, kMasked, true, false, true>(),
      arm<T, true, kMasked, true, true, false>(),   arm<T, true, kMasked, true, true, true>()};
  if (multi) return multi_arms[(forced ? 4 : 0) + (tracers ? 2 : 0) + (strat ? 1 : 0)];
  static const TiledArm<T> arms[8] = {
      arm<T, false, kMasked, false, false, false>(), arm<T, false, kMasked, false, false, true>(),
      arm<T, false, kMasked, false, true, false>(),  arm<T, false, kMasked, false, true, true>(),
      arm<T, false, kMasked, true, false, false>(),  arm<T, false, kMasked, true, false, true>(),
      arm<T, false, kMasked, true, true, false>(),   arm<T, false, kMasked, true, true, true>()};
  return arms[(forced ? 4 : 0) + (tracers ? 2 : 0) + (strat ? 1 : 0)];
}
template <typename T>
TiledArm<T> arm_of(bool multi, bool masked, bool forced, bool tracers, bool strat) {
  return masked ? arm_of<T, true>(multi, forced, tracers, strat)
                : arm_of<T, false>(multi, forced, tracers, strat);
}

// n_ss reverse supersteps through the stack's slots n_ss - 1 .. 0, from the
// cotangent `g_in` at the end into `g_out`, through `g_tmp` as in
// tiled_step.cu (`g_in` is left as it is). `part` holds
// n_ss * n_tiles * n_ranks doubles (kShares times as many for the forced
// arm); d(dt) is added to ddt[0], and the forced arm's d(wind) to dwind and
// d(r_lin, Cd, lambda) to dcoef[0 .. 2]. The stencils (`table`, `weights`
// and their transposes) are host copies; kc is the chunk of levels per
// block (kernels/tiled_adjoint.level_split). The tracer arm (at.tr the
// tracer stack) and the stratified arm (st.w the W; d(W) added to dstrat) as
// adjoint_step.cu's adjoint_rollout, at any q.
template <typename T>
int tiled_adjoint(const T* f_edge, const T* rts, const int* live, const ForcingArgs<T>& fc,
                  T* dwind, double* dcoef, AdjTracers<T> at, T* gtr_out, T* gtr_tmp,
                  const T* h_end, const T* tr_end, AdjStrat<T> st, double* dstrat,
                  const int* table, const double* weights,
                  const int* adj_table, const double* adj_weights, const T* ssh_st,
                  const T* h_st, const T* u_st, const T* gs_in, const T* gh_in,
                  const T* gu_in, T* gs_out, T* gh_out, T* gu_out, T* gs_tmp, T* gh_tmp,
                  T* gu_tmp, double* part, double* ddt, double dt, double inv_dc, double s_div,
                  int ny2, int nx, int k, int n_ss, int n_terms, int rt, int ct, int q,
                  int hm, int hi, int kc, cudaStream_t stream) {
  if (!valid_shape(ny2, nx, k, n_ss, n_terms) || n_ss < 1 || table[0] != n_terms ||
      adj_table[0] != n_terms)
    return cudaErrorInvalidValue;
  if (rt < 1 || ct < 1 || q < 1 || hm < 1 || hi < 1 || kc < 1 || ny2 % rt || nx % ct)
    return cudaErrorInvalidValue;
  // the tracer arm: at least one tracer, the cell mask with the live bits
  const bool tracers = at.tr != nullptr;
  if (tracers && (at.n < 1 || (live == nullptr) != (at.cmask == nullptr)))
    return cudaErrorInvalidValue;
  const bool strat = st.w != nullptr;
  const int n_ranks = (k + kc - 1) / kc;  // no block without levels
  if (n_ranks > (q > 1 && tracers ? kMaxWideCluster : kMaxCluster)) return cudaErrorInvalidValue;
  const int span = 2 * q - 1;
  const int Wi = ct + 2 * hi * span, W = (rt + 2 * hm * span) * Wi;
  StepTaps<T> fw;
  AdjTaps<T> tp;
  if (!resolve_taps<T>(&fw, table, weights, Wi, W, kc) ||
      !resolve_adjoint_taps<T>(&tp, adj_table, adj_weights, Wi, W, kc))
    return kNotHexTable;
  const bool forced = fc.wind != nullptr;
  const int s_cells = q > 1 ? (rt + 2 * hm * (q - 1)) * (ct + 2 * hi * (q - 1)) : rt * ct;
  const size_t smem = smem_bytes(W, rt * ct, s_cells, kc, log2_exact(kc), q, n_ranks, sizeof(T),
                                 forced, tracers ? at.n : 0, strat ? k : 0);
  int max_smem = 0;
  int err = opt_in_smem(&max_smem);
  if (err != 0) return err;
  if (smem > static_cast<size_t>(max_smem)) return cudaErrorInvalidValue;
  const TiledArm<T> arm = arm_of<T>(q > 1, live != nullptr, forced, tracers, strat);
  if ((err = arm.prepare(max_smem)) != 0) return err;
  const int kp_log2 = log2_exact(kc);
  const bool vec = (1 << kp_log2) == kc && vector_loads(k, kc, sizeof(T), h_st, u_st) &&
                   vector_loads(k, kc, sizeof(T), gh_in, gu_in) &&
                   vector_loads(k, kc, sizeof(T), gh_out, gu_out) &&
                   vector_loads(k, kc, sizeof(T), gh_tmp, gu_tmp) &&
                   (!tracers || (vector_loads(k, kc, sizeof(T), at.tr, at.gtr) &&
                                 vector_loads(k, kc, sizeof(T), gtr_out, gtr_tmp)));
  const int n_tiles = (ny2 / rt) * (nx / ct);
  const size_t cells = 2ULL * ny2 * nx;
  const size_t hs = cells * k, us = 3 * cells * k, trs = tracers ? at.n * hs : 0;
  const long long n_shares = static_cast<long long>(n_ss) * n_tiles * n_ranks;
  TiledArgs<T> a{nullptr, nullptr, nullptr, gs_in, gh_in, gu_in, f_edge, rts, live, nullptr,
                 nullptr, nullptr, nullptr, fc, dwind, at, st, nbr_reach(table), T(dt), T(inv_dc),
                 T(s_div), ny2, nx,
                 k, rt, ct, q, hm, hi, kc, kp_log2,
                 vec ? log2_exact(kc * static_cast<int>(sizeof(T)) / 16) : -1, nx / ct,
                 n_shares};
  for (int s = 0; s < n_ss; ++s) {
    const size_t j = n_ss - 1 - s;
    const bool to_out = ((n_ss - 1 - s) & 1) == 0;
    a.ssh = ssh_st + j * cells, a.h = h_st + j * hs, a.u = u_st + j * us;
    a.ds = to_out ? gs_out : gs_tmp;
    a.dh = to_out ? gh_out : gh_tmp;
    a.du = to_out ? gu_out : gu_tmp;
    a.ddt_part = part + static_cast<size_t>(s) * n_tiles * n_ranks;
    a.st.first = s == 0;
    if (tracers) {
      const bool last = static_cast<int>(j) + 1 == n_ss;
      a.at.tr = at.tr + j * trs;
      a.at.h_next = last ? h_end : h_st + (j + 1) * hs;
      a.at.tr_next = last ? tr_end : at.tr + (j + 1) * trs;
      a.at.dtr = to_out ? gtr_out : gtr_tmp;
    }
    cudaLaunchAttribute attr[2];
    const cudaLaunchConfig_t cfg = step_config(n_ranks, n_tiles, smem, stream, attr);
    cudaError_t le = cudaLaunchKernelEx(&cfg, arm.kernel, a, tp, fw);
    if (le == cudaSuccess) le = cudaGetLastError();
    if (le != cudaSuccess) return static_cast<int>(le);
    a.gs = a.ds, a.gh = a.dh, a.gu = a.du, a.at.gtr = a.at.dtr;
  }
  err = reduce_shares(part, n_shares, ddt, forced ? dcoef : nullptr, stream);
  if (err == 0 && strat) err = strat_reduce(st.acc, n_tiles, k, dstrat, stream);
  return err;
}

}  // namespace

// Returns 0, kNotHexTable for a stencil that is not the hex lattice's, or
// the CUDA error of the first launch that failed (cudaErrorInvalidValue for
// a plan the lattice or the card does not take). A null `live` (the wall
// mask's live bits, one int per site) runs the periodic arm, any other the
// masked one; a null `wind` the unforced arm, any other the forced one with
// `lvl`, the coefficients, and the accumulators `dwind` (6, ny2, nx) and
// `dcoef` (3 doubles); a null `tr_st` the tracer-free arm, any other the
// tracer arm with its operands as adjoint_step.cu's entry takes them; a
// null `strat_w` the unstratified arm, any other the stratified one with
// `dw_acc` and `dstrat` as adjoint_step.cu's entry takes them; the forced,
// tracer and stratified arms in any combination, at any q.
#define MOT_TILED_ADJOINT_ENTRY(T, SUFFIX)                                                    \
  extern "C" int mot_tiled_adjoint_##SUFFIX(                                                  \
      const T* f_edge, const T* rts, const int* live, const T* wind, const int* lvl,          \
      T* dwind, double* dcoef, const int* table, const double* weights,                       \
      const int* adj_table, const double* adj_weights, const T* ssh_st, const T* h_st,        \
      const T* u_st, const T* gs_in, const T* gh_in, const T* gu_in, T* gs_out, T* gh_out,    \
      T* gu_out, T* gs_tmp, T* gh_tmp, T* gu_tmp, double* part, double* ddt,                  \
      const T* tr_st, const T* gtr_in, T* gtr_out, T* gtr_tmp, const T* h_end,               \
      const T* tr_end, const T* cmask, const T* strat_w, double* dw_acc, double* dstrat,     \
      double dt, double inv_dc, double s_div, double dlin, double dquad, double rayl,         \
      double kappa, double upwind, int lvl_ranks, int wind_ranks, int ny2, int nx, int k,     \
      int n_ss, int n_terms, int rt, int ct, int q, int hm, int hi, int kc, int n_tr,         \
      void* stream) {                                                                         \
    const ForcingArgs<T> fc{wind, lvl, T(dlin), T(dquad), T(rayl),                            \
                            static_cast<unsigned>(lvl_ranks), static_cast<unsigned>(wind_ranks)}; \
    const AdjTracers<T> at{tr_st, gtr_in, nullptr, nullptr, cmask, nullptr, T(kappa),         \
                           T(0.5 * upwind), n_tr};                                            \
    const AdjStrat<T> st{strat_w, dw_acc, 1};                                                 \
    return tiled_adjoint<T>(f_edge, rts, live, fc, dwind, dcoef, at, gtr_out, gtr_tmp, h_end, \
                            tr_end, st, dstrat, table, weights, adj_table, adj_weights,       \
                            ssh_st, h_st, u_st, gs_in, gh_in, gu_in, gs_out, gh_out, gu_out,  \
                            gs_tmp, gh_tmp, gu_tmp, part, ddt, dt, inv_dc, s_div, ny2, nx, k, \
                            n_ss,                                                             \
                            n_terms, rt, ct, q, hm, hi, kc, static_cast<cudaStream_t>(stream)); \
  }

// tiled_adjoint_f64.cu compiles this file with MOT_TILED_ADJOINT_F64 for the
// f64 entry, so that the two dtypes' instantiations compile in parallel.
#ifdef MOT_TILED_ADJOINT_F64
MOT_TILED_ADJOINT_ENTRY(double, f64)
#else
MOT_TILED_ADJOINT_ENTRY(float, f32)

// One block's dynamic shared memory (bytes) and the blocks one SM holds, for
// an f32 plan with n_ranks blocks of kc levels per cluster, with n_tr
// tracers (the periodic tracer arm), stratified at k levels (strat_k > 0:
// the periodic stratified arm), both or neither; returns 0 or the CUDA
// error.
extern "C" int mot_tiled_adjoint_occupancy(int rt, int ct, int q, int hm, int hi, int kc,
                                           int n_ranks, int n_tr, int strat_k, int* out) {
  const int span = 2 * q - 1;
  const long long sites = static_cast<long long>(rt + 2 * hm * span) * (ct + 2 * hi * span);
  const int s_cells = q > 1 ? (rt + 2 * hm * (q - 1)) * (ct + 2 * hi * (q - 1)) : rt * ct;
  const size_t smem = smem_bytes(sites, rt * ct, s_cells, kc, log2_exact(kc), q, n_ranks,
                                 sizeof(float), false, n_tr, strat_k);
  int max_smem = 0;
  const TiledArm<float> arm = arm_of<float>(q > 1, false, false, n_tr > 0, strat_k > 0);
  int e = opt_in_smem(&max_smem);
  if (e == 0) e = arm.prepare(max_smem);
  if (e != 0) return e;
  out[0] = static_cast<int>(smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], arm.kernel, kStepThreads, smem));
}
#endif  // MOT_TILED_ADJOINT_F64
