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
constexpr int kEdgeU = 11; // of them, the site's own and incoming edges' (continuity's)
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

// The rows of the buffers a window kernel reads and writes. ro = 0: the
// periodic lattice, ny2 rows that wrap. ro > 0: a row slab with received
// halos (structured/sharded.py), its ny2 rows stored after ro halo rows and
// before ro more, ny2 + 2 ro rows in all, which a window reads unwrapped
// (each window's rows lie inside them: the halo holds q reaches); columns
// wrap either way. Lattice row gm of the slab is buffer row gm + ro.
__host__ __device__ __forceinline__ int buffer_plane(int ny2, int nx, int ro) {
  return (ny2 + 2 * ro) * nx;
}
__device__ __forceinline__ int buffer_site(int gm, int gi, int nx, int ro) {
  return (gm + ro) * nx + gi;
}

// The window's lattice sites, as buffer sites (one division per site).
__device__ __forceinline__ void window_sites(int* gs, int m_base, int i_base, int Wi, int W,
                                             int ny2, int nx, int ro) {
  const FastDiv by_wi(Wi);
  for (int s = threadIdx.x; s < W; s += blockDim.x) {
    const int r = by_wi.div(s), c = by_wi.mod(s, r);
    const int m = m_base + r;
    gs[s] = (ro > 0 ? m + ro : wrap(m, ny2)) * nx + wrap(i_base + c, nx);
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

// The forced arms' operands (kForced, chosen by a non-null wind pointer;
// structured/fused_model.kernel_forcing): per lattice site and edge channel
// (6, ny2, nx) the kinematic normal wind stress w = tau.n / rho0 and the
// edge's packed levels, bits 0-15 the top level + 1 and bits 16-31 the
// bottom level + 1, 0 for an edge with no active level (fused_model.
// pack_levels); the drag and Rayleigh coefficients rounded once to T; and
// two masks of a cluster's ranks (kernels/fe_step.forcing_ranks): bit r of
// lvl_ranks set where rank r's level chunk holds the top or the bottom level
// of some edge, of wind_ranks where it holds some edge's top level. The
// one-hot level masks of the plain version are never staged: two of them per
// edge would cost twice the bytes of u.
//
// How the forced arms use them. Rayleigh, -lambda u, acts at every
// edge-level and needs no operand: one FMA in the unforced body. The wind
// and the drag act at an edge's top and bottom level, two levels of K, which
// one configuration's forcing puts in few chunks (make_forcing's uniform
// levels: the first and the last). Only a rank in lvl_ranks stages the
// window's packed levels (and in wind_ranks its winds) by cp.async with the
// state, and it adds the wind and drag in a pass of its own over the edges,
// a thread an edge (wind_drag_pass), not in the body, whose threads are
// levels: most levels are no edge's top or bottom, yet every warp of the
// body would have tested its 6 (or, reversed, 12) edges at every level. The
// forced arms take their shared memory beyond the unforced layout's.
// Measured designs (PERF.md, section 6): staging every rank and testing every
// level in the body cost fe_step x1.17-1.18 and the reverse arms x1.8-2.2;
// reading the operands from device memory, x1.32-1.59 and x1.72-2.32.
template <typename T>
struct ForcingArgs {
  const T* wind;   // null: the unforced arm
  const int* lvl;
  T dlin, dquad, rayl;
  unsigned lvl_ranks, wind_ranks;
};

// The forced arm's shared memory beyond the unforced layout, which starts
// at `end`: 16-byte aligned, the winds [6][W] and `extra` more values of T,
// then the packed levels [6][W]; what forcing_smem_bytes reckons.
template <typename T>
struct ForcingSmem {
  T* wind;
  T* extra;
  int* lvl;
  __device__ ForcingSmem(void* end, int W, int extra_values) {
    const uintptr_t at = (reinterpret_cast<uintptr_t>(end) + 15) & ~static_cast<uintptr_t>(15);
    wind = reinterpret_cast<T*>(at);
    extra = wind + 6 * W;
    lvl = reinterpret_cast<int*>(extra + extra_values);
  }
};
inline size_t forcing_smem_bytes(long long sites, long long extra_values, size_t itemsize) {
  return 16 + itemsize * static_cast<size_t>(6 * sites + extra_values) +
         sizeof(int) * static_cast<size_t>(6 * sites);
}

// The staged planes of a forced block: its window's packed levels [6][W] if
// its rank is in lvl_ranks, its winds [6][W] if in wind_ranks, by async
// copies with the window (needs gs[]).
template <typename T>
__device__ __forceinline__ void load_forcing(const ForcingSmem<T>& fs, const int* gs,
                                             const ForcingArgs<T>& fc, int W, int plane,
                                             int rank) {
  const bool lvl = (fc.lvl_ranks >> rank) & 1u, wind = (fc.wind_ranks >> rank) & 1u;
  if (!lvl) return;
  for (int s = threadIdx.x; s < W; s += blockDim.x) {
    const int g = gs[s];
    for (int c6 = 0; c6 < 6; ++c6) {
      copy_async(fs.lvl + c6 * W + s, fc.lvl + c6 * plane + g);
      if (wind) copy_async(fs.wind + c6 * W + s, fc.wind + c6 * plane + g);
    }
  }
}

// Whether level k is the top (wind) or the bottom (drag) level of an edge
// whose packed levels are lv.
__device__ __forceinline__ bool top_level(int lv, int k) { return (lv & 0xffff) == k + 1; }
__device__ __forceinline__ bool bottom_level(int lv, int k) { return (lv >> 16) == k + 1; }

// The chunk levels (from k0, kr of them) of an edge's top and bottom level,
// -1 where outside the chunk; the bottom's -1 too where it is the top.
__device__ __forceinline__ void chunk_levels(int lv, int k0, int kr, int* top, int* bot) {
  const int t = (lv & 0xffff) - 1 - k0, b = (lv >> 16) - 1 - k0;  // -1 - k0: none
  *top = t >= 0 && t < kr ? t : -1;
  *bot = b >= 0 && b < kr && b != t ? b : -1;
}

// 1 / h_edge, 1 where h_edge <= 0 (a dead slot; its masks are 0 there):
// the one reciprocal the wind and the quadratic drag share.
template <typename T>
__device__ __forceinline__ T inv_edge(T he) {
  return T(1) / (he > T(0) ? he : T(1));
}

// The wind and drag part of the forcing tendency F of one edge-level
// (models/forcing.py: forcing_tendency, term by term, without Rayleigh):
// top w / he - bot (r u + Cd |u| u / he), of the old u and the old state's
// h_edge; 0 away from the edge's top and bottom level. lv is the edge's
// packed levels, w its staged wind.
template <typename T>
__device__ __forceinline__ T wind_drag(T u, T he, int lv, int k, const T* w,
                                       const ForcingArgs<T>& fc) {
  T t = T(0);
  const bool top = top_level(lv, k), bot = bottom_level(lv, k);
  if (top || bot) {
    const T inv_h = inv_edge(he);
    if (top) t = *w * inv_h;
    if (bot) t = t - (fc.dlin * u + fc.dquad * fabs(u) * u * inv_h);
  }
  return t;
}

// The forward forced arms' wind and drag pass, after the body has stored u'
// (with Rayleigh, masked) on a region of n window sites: a thread takes an
// (edge channel, site) and, at the edge's top and bottom level where they lie
// in the block's chunk, adds dt times the wind and drag of the old state
// (`old`, [8][W][kc], read through the taps `tp`) to the stored u', which
// `out(ch, t, s, kl)` returns (a reference). `site(t)` gives the window site
// of region site t, or -1 off the lattice; masked channels keep their 0.
template <typename T, bool kMasked, typename Site, typename Out>
__device__ __forceinline__ void wind_drag_pass(const T* old, const StepTaps<T>& tp,
                                               const ForcingSmem<T>& fs, const int* live_s,
                                               int n, Site site, Out out, int W, int kc,
                                               int k0, int kr, T dt, const ForcingArgs<T>& fc) {
  for (int e = threadIdx.x; e < 6 * n; e += blockDim.x) {
    const int ch = e / n, t = e - ch * n;
    const int s = site(t);
    if (s < 0 || (kMasked && !((live_s[s] >> ch) & 1u))) continue;
    const int lv = fs.lvl[ch * W + s];
    int lev[2];
    chunk_levels(lv, k0, kr, &lev[0], &lev[1]);
    for (int i = 0; i < 2; ++i) {
      const int kl = lev[i];
      if (kl < 0) continue;
      const T* v = old + s * kc + kl;
      const T he = T(0.5) * (v[tp.hs[hex::nb_h(ch)]] + v[tp.hs[hex::self_h(ch & 1)]]);
      T& o = out(ch, t, s, kl);
      o = o + dt * wind_drag(v[tp.us[hex::self_u(ch)]], he, lv, k0 + kl, fs.wind + ch * W + s,
                             fc);
    }
  }
}

// The tracer arms' operands (kTracers, chosen by a non-null tracer pointer;
// structured/fused_model.kernel_tracers): the tracers as planes t * 2 + p
// (2 nT, ny2, nx, K), each laid out as h; on a channel the live-cell mask
// (2, ny2, nx) in T, which guards the division by h'; kappa and upwind / 2,
// rounded once to T on the host (fused_model.tracer_opts); and, resolved on
// the host from the stencil table, each incoming edge's channel and the
// window offset of the site that owns it, whose live bit masks its
// diffusive flux.
//
// How the arms use them. A tracer at level k needs only level k, so the arm
// adds no column sum and no cluster traffic: each block stages its level
// chunk of the window's 2 nT tracer planes after its 8 state planes, with
// the same async copies, and the lane group that forms a site's h' then
// loops over the tracers. T is read at the h sources (hex::self_h, nb_h,
// inc_self_h, inc_nb_h), and the six edge fluxes F = u h_e of the old state,
// those continuity has just formed, carry each tracer (tracer_edge_flux).
template <typename T>
struct TracerArgs {
  const T* tr;      // null: the tracer-free arm
  T* tr_out;
  const T* cmask;   // the masked arm's live-cell mask; null otherwise
  T kappa, half_up;
  int n;            // tracers
  int inc_ch[6];    // incoming edge x = 3p + j: its channel
  int inc_site[6];  //   and its owner's window offset, in sites
};

// The incoming edges' channels and owners' window offsets (window rows of
// Wi sites) from the table (host copy; layout in lattice.cuh).
template <typename T>
inline void resolve_tracer_taps(TracerArgs<T>* tr, const int* table, int Wi) {
  for (int x = 0; x < 6; ++x) {
    const int* tc = table + kInc + 3 * x;
    tr->inc_ch[x] = tc[0];
    tr->inc_site[x] = tc[1] * Wi + tc[2];
  }
}

// The tracer flux G = F T_e - kappa h_e (T_n - T_p) / dc of one edge-level
// (pallas_model.py:362-383, term by term): T_e = (T_n + T_p) / 2 minus
// (upwind / 2) sign(F) (T_n - T_p), sign(0) = 0 as jnp.sign's; the
// diffusive term only on a live edge. A zero kappa or upwind skips its term,
// as the JAX kernel's static ones do.
template <typename T>
__device__ __forceinline__ T tracer_edge_flux(T flux, T he, T tn, T tp, bool live,
                                              const TracerArgs<T>& tr, T inv_dc) {
  T te = T(0.5) * (tn + tp);
  if (tr.half_up != T(0)) {
    const T sg = static_cast<T>((flux > T(0)) - (flux < T(0)));
    te = te - tr.half_up * sg * (tn - tp);
  }
  T g = flux * te;
  if (tr.kappa != T(0) && live) g = g - tr.kappa * he * ((tn - tp) * inv_dc);
  return g;
}

// The block's level chunk of the 2 nT tracer planes over the window, into
// `dst` ([2 nT][W][kc], after the state's 8 planes), as load_state copies h.
template <typename T>
__device__ __forceinline__ void load_tracers(T* dst, const int* gs, const T* tr, int n_planes,
                                             int W, int kc_log2, int vec_log2, int k0, int kr,
                                             int K, int plane) {
  const int kc = 1 << kc_log2;
  if (vec_log2 >= 0) {
    constexpr int per = 16 / sizeof(T);
    const int vr = kr / per;
    const int n = (W * n_planes) << vec_log2;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int v = e & ((1 << vec_log2) - 1);
      const int q = e >> vec_log2;
      const int ch = q % n_planes, s = q / n_planes;
      if (v >= vr) continue;
      copy_async16(dst + (ch * W + s) * kc + v * per,
                   tr + (ch * plane + gs[s]) * K + k0 + v * per);
    }
  } else {
    const int n = (W * n_planes) << kc_log2;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int kl = e & (kc - 1);
      const int q = e >> kc_log2;
      const int ch = q % n_planes, s = q / n_planes;
      if (kl >= kr) continue;
      copy_async(dst + (ch * W + s) * kc + kl, tr + (ch * plane + gs[s]) * K + k0 + kl);
    }
  }
}

// The live bits of a site's six incoming edges (bit x = 3p + j), each its
// owner's bit of its channel, from the window's live bits `live_s`: read once
// per site, outside the level loop.
template <typename T>
__device__ __forceinline__ unsigned incoming_live(const int* live_s, int s,
                                                  const TracerArgs<T>& tr) {
  unsigned bits = 0u;
#pragma unroll
  for (int x = 0; x < 6; ++x)
    bits |= ((static_cast<unsigned>(live_s[s + tr.inc_site[x]]) >> tr.inc_ch[x]) & 1u) << x;
  return bits;
}

// The new concentrations of one (site, level) for every tracer
// (pallas_model.py:384-399): per parity p, the content h T - dt (dv / A) (the
// owned edges' G - the incoming edges' G) over h', or 0 on a culled cell of a
// channel (cm[p] = 0). `lv` is the site's level in the window copy of the
// state ([8 + 2 nT][W][kc] from its planes), `pk` one plane, `tp.hs` the h
// sources' offsets in it (StepTaps, or the nonlinear arms' NlTaps), `u` and `h` the
// site's u and h sources as the step loaded them (u indexed as hex::),
// `hnew` its h', `live` its live bits and `inc_live` its incoming edges'
// (incoming_live; masked arm); `store(i, v)` writes plane i's new value.
template <typename T, bool kMasked, typename Taps, typename Store>
__device__ __forceinline__ void tracer_step(const T* lv, int pk, const Taps& tp,
                                            const T* u, const T* h, const T* hnew,
                                            const T* cm, unsigned live, unsigned inc_live,
                                            const TracerArgs<T>& tr, T dt_div, T inv_dc,
                                            Store store) {
  for (int t = 0; t < tr.n; ++t) {
    const T* tv = lv + (8 + 2 * t) * pk;
    T c[hex::kH];
#pragma unroll
    for (int x = 0; x < hex::kH; ++x) c[x] = tv[tp.hs[x]];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      T total = T(0);
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const int ch = f * 2 + p;
        const T he = T(0.5) * (h[hex::nb_h(ch)] + h[hex::self_h(p)]);
        const bool on = !kMasked || ((live >> ch) & 1u);
        const T g = tracer_edge_flux(u[hex::self_u(ch)] * he, he, c[hex::nb_h(ch)],
                                     c[hex::self_h(p)], on, tr, inv_dc);
        total = (f == 0) ? g : total + g;
      }
#pragma unroll
      for (int x = 3 * p; x < 3 * p + 3; ++x) {
        const T he = T(0.5) * (h[hex::inc_nb_h(x)] + h[hex::inc_self_h(x)]);
        const bool on = !kMasked || ((inc_live >> x) & 1u);
        total = total - tracer_edge_flux(u[hex::inc_u(x)] * he, he, c[hex::inc_nb_h(x)],
                                         c[hex::inc_self_h(x)], on, tr, inv_dc);
      }
      const T content = h[hex::self_h(p)] * c[hex::self_h(p)] - dt_div * total;
      store(2 * t + p, kMasked && !(cm[p] > T(0)) ? T(0) : content / hnew[p]);
    }
  }
}

// The stratified arms' operand (kStrat, chosen by a non-null W; structured/
// fused_model.kernel_strat): W (K, K) row-major in T, any dense matrix (the
// JAX kernel takes it as a dense operand, pallas_model.py:159-163), so that
// each layer's pressure is the gradient of its Montgomery potential
// Phi_k = g ssh + sum_l h_l W[l][k] (models/stratification.py), with scale
// -dt in place of -g dt.
//
// How the arms form Phi. Phi_k of a site needs h at every level of that
// site, and the cluster's ranks hold the levels in chunks. Each rank keeps
// its chunk's columns of W ([K][kc], by async copies with the window) and
// gathers the other ranks' h chunks through distributed shared memory, one
// rank at a time, in rank order: a chunk of 2 planes [2][W][kc] is copied
// from the owner's shared memory into a staging buffer by 16-byte loads,
// then every (site, level) of the block's chunk adds that chunk's levels'
// products in level order (the block's own chunk is read in place). The
// sum over l is then in level order 0 .. K-1, with no atomics: f64 reruns
// are bitwise equal. A gather was chosen over scattering partial products
// to the owning ranks: a scatter sends K values per site and rank (the
// partial products of every destination level), a gather 2 kc per site
// and rank, and it needs no receive buffer per source rank. Staging was
// chosen over reading the other ranks' h in place with each thread's sums
// in registers across ranks (no staging buffer, one block barrier): that
// took x1.00-1.10 this design's time on an H100 (tools/strat_timing.py,
// PERF.md section 6).
//
// The hazards: a rank reads another's h only after a full cluster barrier
// that follows every rank's loads (fe_step) or writes (tiled_step), and no
// rank writes h planes that another may be reading, or leaves, before a
// cluster barrier that follows every rank's last read.
template <typename T>
struct StratSmem {
  T* phi;    // [2][W][kc]: Phi at this block's levels
  T* stage;  // [2][W][kc]: another rank's h chunk
  T* wsl;    // [K][kc]: W[l][k0 + kl]
  T* fresh;  // [2][W][kc]: FB's fresh h' (tiled_step's FB arm), the nonlinear arms' h chunk
  __device__ StratSmem(void* end, int W, int kc, int K) {
    const uintptr_t at = (reinterpret_cast<uintptr_t>(end) + 15) & ~static_cast<uintptr_t>(15);
    phi = reinterpret_cast<T*>(at);
    stage = phi + 2 * W * kc;
    wsl = stage + 2 * W * kc;
    fresh = wsl + K * kc;
  }
  // the end of the arm's layout, with or without the fresh h' (whose
  // planes follow the W slice), where another arm's may start
  __device__ void* end(int W, int kc, bool with_fresh) const {
    return fresh + (with_fresh ? 2 * W * kc : 0);
  }
};
// The stratified arm's shared memory beyond the unstratified layout: what
// StratSmem takes, with (fresh) or without FB's fresh h'.
inline size_t strat_smem_bytes(long long sites, int kc, int k, size_t itemsize, bool fresh) {
  return 16 + itemsize * (static_cast<size_t>((fresh ? 6 : 4) * sites * kc) +
                          static_cast<size_t>(k) * kc);
}

// The block's columns of W, wsl[l][kl] = W[l][k0 + kl] for kl < kr, by
// async copies.
template <typename T>
__device__ __forceinline__ void load_strat_w(T* wsl, const T* w, int K, int k0, int kr,
                                             int kc_log2) {
  const int kc = 1 << kc_log2;
  for (int e = threadIdx.x; e < (K << kc_log2); e += blockDim.x) {
    const int kl = e & (kc - 1);
    if (kl < kr) copy_async(wsl + e, w + (e >> kc_log2) * K + k0 + kl);
  }
}

// The rows and columns the pressure gradient reads around a site, from the
// table (host copy): the neighbour taps' least and greatest (dm, di), the
// site's own (0, 0) among them. The stratified arms form Phi on the region
// they grow the momentum update's region by.
struct NbrReach {
  int m0, m1, i0, i1;
};
inline NbrReach nbr_reach(const int* table) {
  NbrReach r{0, 0, 0, 0};
  for (int c = 0; c < 6; ++c) {
    const int dm = table[kNbr + 3 * c + 1], di = table[kNbr + 3 * c + 2];
    r.m0 = dm < r.m0 ? dm : r.m0, r.m1 = dm > r.m1 ? dm : r.m1;
    r.i0 = di < r.i0 ? di : r.i0, r.i1 = di > r.i1 ? di : r.i1;
  }
  return r;
}

// 16 bytes of shared memory as values of T (the address 16-byte aligned).
__device__ __forceinline__ void load16(float (&d)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  d[0] = q.x, d[1] = q.y, d[2] = q.z, d[3] = q.w;
}
__device__ __forceinline__ void load16(double (&d)[2], const double* p) {
  const double2 q = *reinterpret_cast<const double2*>(p);
  d[0] = q.x, d[1] = q.y;
}

// Phi = g ssh + h @ W at this block's kr levels of the window rows [r0, r1)
// and columns [c0, c1) (window rows of Wi sites), into sm.phi [2][W][kc].
// `h` points at the h planes [2][W][kc] of a window copy, at the same offset
// in every rank's shared memory; `ssh` at the matching ssh planes [2][W].
// A thread takes one level and kSites sites (8 sums, both parities) at a
// time, reads W once per level for all of them and h by 16-byte vectors
// where a chunk is whole vectors (each h value read once per thread, 16
// lanes reading it at once). Ends with a block barrier; the caller provides
// the cluster barriers (the hazards above).
template <typename T>
__device__ __forceinline__ void montgomery(const StratSmem<T>& sm, cg::cluster_group& cluster,
                                           const T* h, const T* ssh, int r0, int r1, int c0,
                                           int c1, int Wi, int W, int kc_log2, int kr, int K,
                                           int rank, int n_ranks) {
  constexpr int kSites = 4;
  constexpr int V = 16 / sizeof(T);  // values per 16-byte vector
  const int kc = 1 << kc_log2, pk = W << kc_log2;
  const T g = T(kGravity);
  const int kl = threadIdx.x & (kc - 1);
  const int slot = threadIdx.x >> kc_log2, slots = blockDim.x >> kc_log2;
  const int nc = c1 - c0, n = (r1 - r0) * nc;
  const FastDiv by_nc(nc);
  const bool vec = (kc * sizeof(T)) % 16 == 0;  // every h row whole vectors, aligned
  for (int rr = 0; rr < n_ranks; ++rr) {
    const T* src = h;
    if (rr != rank) {
      const T* far = cluster.map_shared_rank(const_cast<T*>(h), rr);
      const bool v16 = (2 * pk * sizeof(T)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(far) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(sm.stage) % 16 == 0;
      if (v16) {
        const int n16 = static_cast<int>(2 * pk * sizeof(T) / 16);
        for (int e = threadIdx.x; e < n16; e += blockDim.x)
          reinterpret_cast<uint4*>(sm.stage)[e] = reinterpret_cast<const uint4*>(far)[e];
      } else {
        for (int e = threadIdx.x; e < 2 * pk; e += blockDim.x) sm.stage[e] = far[e];
      }
      __syncthreads();
      src = sm.stage;
    }
    const int kr2 = min(kc, K - rr * kc);  // the source chunk's real levels
    const int kv = vec ? kr2 / V * V : 0;  // of them read by vectors
    const T* w = sm.wsl + (rr * kc << kc_log2) + kl;  // W[rr kc + l][k0 + kl] at l << kc_log2
    const bool first = rr == 0, last = rr == n_ranks - 1;
    for (int base = slot; kl < kr && base < n; base += kSites * slots) {
      int s[kSites];
      bool on[kSites];
      T a0[kSites], a1[kSites];
#pragma unroll
      for (int j = 0; j < kSites; ++j) {
        const int t = base + j * slots;
        on[j] = t < n;
        const int tt = on[j] ? t : base;
        const int r = by_nc.div(tt);
        s[j] = (r0 + r) * Wi + c0 + by_nc.mod(tt, r);
        a0[j] = first ? T(0) : sm.phi[(s[j] << kc_log2) + kl];
        a1[j] = first ? T(0) : sm.phi[(s[j] << kc_log2) + kl + pk];
      }
      for (int l = 0; l < kv; l += V) {
        T wv[V];
#pragma unroll
        for (int v = 0; v < V; ++v) wv[v] = w[(l + v) << kc_log2];
#pragma unroll
        for (int j = 0; j < kSites; ++j) {
          T x0[V], x1[V];
          load16(x0, src + (s[j] << kc_log2) + l);
          load16(x1, src + (s[j] << kc_log2) + l + pk);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            a0[j] += x0[v] * wv[v];
            a1[j] += x1[v] * wv[v];
          }
        }
      }
      for (int l = kv; l < kr2; ++l) {
        const T wv = w[l << kc_log2];
#pragma unroll
        for (int j = 0; j < kSites; ++j) {
          a0[j] += src[(s[j] << kc_log2) + l] * wv;
          a1[j] += src[(s[j] << kc_log2) + l + pk] * wv;
        }
      }
#pragma unroll
      for (int j = 0; j < kSites; ++j) {
        if (!on[j]) continue;
        if (last) {  // the JAX order: g * ssh + hw
          a0[j] = g * ssh[s[j]] + a0[j];
          a1[j] = g * ssh[W + s[j]] + a1[j];
        }
        sm.phi[(s[j] << kc_log2) + kl] = a0[j];
        sm.phi[(s[j] << kc_log2) + kl + pk] = a1[j];
      }
    }
    __syncthreads();
  }
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
