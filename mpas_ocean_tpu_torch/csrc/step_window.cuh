// Shared staging of the two forward window kernels (tiled_step.cu, fe_step.cu):
// the stencil resolved on the host into kernel parameters, the level split,
// the window loader with 16-byte async copies, the programmatic-dependent
// cluster launch. Each kernel keeps its own step body (PERF.md: one shared
// inline step function cost tiled_step's FB arm 11.5%).
//
// A window is Wm x Wi lattice sites, flattened s = r * Wi + c. A block keeps
// its level chunk (kc levels, a power of two; kr of them real) of 8 planes
// per state: h of parity 0 and 1, then u of channels 0..5, each plane
// [W][kc]. Threads work in groups of G = min(16, kc) lanes: the lanes of a
// group take G consecutive levels of one site (and loop over the chunk), so
// a group reads consecutive values of a plane (no bank conflicts) and its
// column sum is a G-lane shuffle.

#pragma once

#include <cstdint>

#include "tiled_window.cuh"

namespace lattice {

constexpr int kStepThreads = 512;
constexpr int kLanesLog2 = 4;  // at most 16 lanes (a half-warp) per site

// The hex lattice's stencil (structured/stencils.py, packed by
// kernels/fe_step.pack_stencil) reads, per (site, level), 25 distinct u
// values and 10 distinct h values through its 48 Coriolis taps and its
// continuity taps. Listed once ("sources", numbered in the order of first
// use below: the site's own channels, the incoming edges, the taps), each is
// one shared-memory load, and each source's u * f product is formed once.
// The maps are constants, so with the loops unrolled every index folds away.
// The forward kernels take only a table whose sources number and map exactly
// so (resolve_taps): every uniform hex lattice's, in f32 and f64.
namespace hex {
constexpr int kTaps = 48;  // Coriolis taps, 8 per output channel
constexpr int kU = 25;     // u sources
constexpr int kH = 10;     // h sources
// u source of: the site's channel c; incoming edge x = 3p + j; Coriolis tap t
__host__ __device__ constexpr int self_u(int c) { return c; }
__host__ __device__ constexpr int inc_u(int x) {
  constexpr int m[6] = {6, 7, 8, 9, 2, 10};
  return m[x];
}
__host__ __device__ constexpr int tap_u(int t) {
  constexpr int m[48] = {2,  4, 7,  8,  11, 12, 13, 10, 3, 5,  2,  10, 13, 14, 15, 16,
                         4,  6, 8,  0,  10, 1,  5,  9,  5, 9,  10, 1,  16, 17, 18, 19,
                         6,  7, 0,  2,  9,  20, 21, 22, 9, 2,  1,  3,  19, 23, 24, 20};
  return m[t];
}
// h source of: the site's plane p; the cell across channel c's owned edge;
// incoming edge x's own cell and its neighbour cell
__host__ __device__ constexpr int self_h(int p) { return p; }
__host__ __device__ constexpr int nb_h(int c) {
  constexpr int m[6] = {2, 3, 1, 4, 5, 6};
  return m[c];
}
__host__ __device__ constexpr int inc_self_h(int x) {
  constexpr int m[6] = {7, 8, 9, 5, 0, 2};
  return m[x];
}
__host__ __device__ constexpr int inc_nb_h(int x) {
  constexpr int m[6] = {0, 0, 0, 1, 1, 1};
  return m[x];
}
}  // namespace hex

// What the kernels' entries return for a table that is not the hex
// lattice's (kernels/fe_step.NOT_HEX_TABLE).
constexpr int kNotHexTable = -1;

// The stencil as offsets into one block's window, resolved once per call on
// the host from the packed table (layout in lattice.cuh), and passed as a
// kernel parameter: it lives in the constant bank for the whole launch, and
// with the loops unrolled every offset and weight is an operand.
template <typename T>
struct StepTaps {
  T w[hex::kTaps];  // Coriolis weights, 8 per output channel
  int nb[6];        // per channel: neighbour cell across the owned edge, site units
  int us[hex::kU];  // the u sources, state units
  int fs[hex::kU];  //   their f_edge values, [6][W] units
  int hs[hex::kH];  // the h sources, state units
};

// The table (host copy) resolved into *s for a window of Wm x Wi = W sites
// and kc levels. Its sources, numbered in order of first use, must number
// and map as hex:: lists them; false otherwise. A source is a (plane, dm, di)
// read, found by its state offset (unique in the window).
template <typename T>
inline bool resolve_taps(StepTaps<T>* s, const int* table, const double* weights, int Wi,
                         int W, int kc) {
  if (table[0] != hex::kTaps) return false;
  for (int c = 0; c < 7; ++c)
    if (table[kOff + c] != 8 * c) return false;
  int u_src[hex::kU], n_u = 0, h_src[hex::kH], n_h = 0;
  // the source's number, a new one numbered next; -1 past the list's end
  auto find = [](int* src, int* n, int cap, int off) {
    for (int i = 0; i < *n; ++i)
      if (src[i] == off) return i;
    if (*n == cap) return -1;
    src[(*n)++] = off;
    return *n - 1;
  };
  auto u_of = [&](int off) { return find(u_src, &n_u, hex::kU, off); };
  auto h_of = [&](int off) { return find(h_src, &n_h, hex::kH, off); };
  bool ok = true;
  for (int c = 0; c < 6; ++c) {
    const int* tn = table + kNbr + 3 * c;
    s->nb[c] = tn[0] * W + tn[1] * Wi + tn[2];
    ok = ok && u_of((2 + c) * W * kc) == hex::self_u(c);
  }
  for (int x = 0; x < 6; ++x) {  // x = 3p + j
    const int* tc = table + kInc + 3 * x;
    ok = ok && u_of(((2 + tc[0]) * W + tc[1] * Wi + tc[2]) * kc) == hex::inc_u(x);
  }
  for (int t = 0; t < hex::kTaps; ++t) {
    const int* tt = table + kHeader + 3 * t;
    const int f = tt[0] * W + tt[1] * Wi + tt[2];
    ok = ok && u_of((2 * W + f) * kc) == hex::tap_u(t);
    if (ok) s->fs[hex::tap_u(t)] = f;
    s->w[t] = static_cast<T>(weights[t]);
  }
  for (int p = 0; p < 2; ++p) ok = ok && h_of(p * W * kc) == hex::self_h(p);
  for (int c = 0; c < 6; ++c) ok = ok && h_of(s->nb[c] * kc) == hex::nb_h(c);
  for (int x = 0; x < 6; ++x) {
    const int* tc = table + kInc + 3 * x;
    const int* te = table + kNbr + 3 * tc[0];
    const int d = tc[1] * Wi + tc[2];
    ok = ok && h_of(((tc[0] & 1) * W + d) * kc) == hex::inc_self_h(x) &&
         h_of((te[0] * W + d + te[1] * Wi + te[2]) * kc) == hex::inc_nb_h(x);
  }
  if (!ok || n_u != hex::kU || n_h != hex::kH) return false;
  for (int i = 0; i < hex::kU; ++i) s->us[i] = u_src[i];
  for (int i = 0; i < hex::kH; ++i) s->hs[i] = h_src[i];
  return true;
}

// Levels per block: the least power of two that splits k over at most
// kMaxCluster blocks, so that every index below is a shift (and, from 4 f32
// or 2 f64 levels up, a chunk is whole 16-byte vectors).
inline int step_chunk(int k) {
  const int per = (k + kMaxCluster - 1) / kMaxCluster;
  int kc = 1;
  while (kc < per) kc *= 2;
  return kc;
}

inline int log2_exact(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// Dynamic shared memory of one block: `copies` state copies [8][sites][kc],
// `planes` per-site values (ssh, partial column sums, f_edge, rts) and the
// window's lattice sites (kernels/tiled_step.smem_bytes, fe_step.smem_bytes).
inline size_t step_smem_bytes(long long sites, int kc, int copies, int planes,
                              size_t itemsize) {
  return itemsize * static_cast<size_t>(sites) * (8 * copies * kc + planes) +
         sizeof(int) * static_cast<size_t>(sites);
}

// 16-byte async copy into shared memory
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  __pipeline_memcpy_async(dst, src, 16);
}

// Programmatic dependent launch: let the next kernel on the stream be
// scheduled once every block of this one has started, and wait until the
// previous kernel has finished and its writes are visible. Only index
// arithmetic may come before the wait: any input may have been written by
// the previous kernel.
__device__ __forceinline__ void allow_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_previous_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// A cluster barrier in two halves, every thread of every block taking part:
// after the wait, every block of the cluster has started, so its shared
// memory may be written through distributed shared memory. The arrival
// orders no memory.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The window's lattice sites, periodic (one division per site).
__device__ __forceinline__ void window_sites(int* gs, int m_base, int i_base, int Wi, int W,
                                             int ny2, int nx) {
  const FastDiv by_wi(Wi);
  for (int s = threadIdx.x; s < W; s += blockDim.x) {
    const int r = by_wi.div(s), c = by_wi.mod(s, r);
    gs[s] = wrap(m_base + r, ny2) * nx + wrap(i_base + c, nx);
  }
}

// f_edge and rts over the window, by async copies (needs gs[]).
template <typename T>
__device__ __forceinline__ void load_consts(T* f_s, T* rts_s, const int* gs, const T* f_edge,
                                            const T* rts, int W, int plane) {
  for (int s = threadIdx.x; s < W; s += blockDim.x) {
    const int g = gs[s];
    for (int p = 0; p < 2; ++p) copy_async(rts_s + p * W + s, rts + p * plane + g);
    for (int c6 = 0; c6 < 6; ++c6) copy_async(f_s + c6 * W + s, f_edge + c6 * plane + g);
  }
}

// The masked arms' live bits of the window's sites, by async copies (needs
// gs[]): `live` is the wall mask packed as one int per lattice site, bit c
// set where the mask of channel c is not 0 (kernels/fe_step.live_bits). The
// mask is 0 or 1 (StructMesh.edge_mask), so the plain version's u' * m is u'
// on a live channel and 0 on a masked one; the masked arms store +0 there
// (u' * 0 may carry the sign of u'). One copy per window site brings what
// the mask's six planes would, and one register per site holds it through a
// level loop, where a site with every bit set (most of a channel's) skips
// the masking.
constexpr unsigned kAllLive = 0x3f;  // a site none of whose six channels is masked

__device__ __forceinline__ void load_live(int* live_s, const int* gs, const int* live, int W) {
  for (int s = threadIdx.x; s < W; s += blockDim.x) copy_async(live_s + s, live + gs[s]);
}

// This block's level chunk of h and u over the window, and ssh. With
// vec_log2 >= 0 (K * itemsize, the chunk and the pointers 16-byte aligned) each
// (site, plane) chunk moves as 2^vec_log2 16-byte vectors, neighbouring
// threads on neighbouring vectors; otherwise one value per copy. Either way
// the index of a copy splits by shifts and masks. Needs gs[] written and a
// __syncthreads() before.
template <typename T>
__device__ __forceinline__ void load_state(T* buf, T* ssh_s, const int* gs, const T* ssh,
                                           const T* h, const T* u, int W, int kc_log2,
                                           int vec_log2, int k0, int kr, int K, int plane) {
  const int kc = 1 << kc_log2;
  for (int s = threadIdx.x; s < W; s += blockDim.x)
    for (int p = 0; p < 2; ++p) copy_async(ssh_s + p * W + s, ssh + p * plane + gs[s]);
  if (vec_log2 >= 0) {
    constexpr int per = 16 / sizeof(T);  // values per vector
    const int vr = kr / per;             // real vectors (kr * itemsize % 16 == 0)
    const int n = (W * 8) << vec_log2;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int v = e & ((1 << vec_log2) - 1);
      const int q = e >> vec_log2;
      const int ch = q & 7, s = q >> 3;
      if (v >= vr) continue;
      const int g = gs[s];
      const T* src = ch < 2 ? h + (ch * plane + g) * K : u + ((ch - 2) * plane + g) * K;
      copy_async16(buf + (ch * W + s) * kc + v * per, src + k0 + v * per);
    }
  } else {
    const int n = (W * 8) << kc_log2;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int kl = e & (kc - 1);
      const int q = e >> kc_log2;
      const int ch = q & 7, s = q >> 3;
      if (kl >= kr) continue;
      const int g = gs[s];
      const T* src = ch < 2 ? h + (ch * plane + g) * K : u + ((ch - 2) * plane + g) * K;
      copy_async(buf + (ch * W + s) * kc + kl, src + k0 + kl);
    }
  }
}

// Sum over the `width` lanes of a group (a power of two <= 32), in a fixed
// order; all 32 lanes of the warp take part, and each group's first lane
// holds its group's sum.
template <typename T>
__device__ __forceinline__ T group_sum(T v, int width) {
  for (int off = width >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, width);
  return v;
}

// Whether the shape and the state pointers allow 16-byte copies of whole
// level chunks.
inline bool vector_loads(int k, int kc, size_t itemsize, const void* h, const void* u) {
  return (static_cast<size_t>(k) * itemsize) % 16 == 0 &&
         (static_cast<size_t>(kc) * itemsize) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(h) % 16 == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0;
}

// A launch of n_clusters clusters of n_ranks blocks of kStepThreads threads,
// which may start while the previous kernel on the stream finishes
// (programmatic dependent launch): the kernel waits in
// wait_previous_grid() before it reads what that kernel wrote.
inline cudaLaunchConfig_t step_config(int n_ranks, int n_clusters, size_t smem,
                                      cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_clusters * n_ranks);
  cfg.blockDim = dim3(kStepThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cfg;
}

}  // namespace lattice
