// Shared pieces of the two reverse window kernels (adjoint_step.cu,
// tiled_adjoint.cu): the transposed hex stencil's source map, the stencil
// resolved on the host into kernel parameters, the loader of a level chunk
// of any width, the fold of ssh's cotangent into h's, and the block's d(dt)
// share. Each kernel keeps its own step body, as the forward kernels do
// (step_window.cuh).
//
// A window is Wm x Wi lattice sites, flattened s = r * Wi + c, as in
// step_window.cuh. A block keeps its level chunk (kc levels, kr of them real)
// of two states of 8 planes each: the primal state (h of parity 0 and 1, u of
// channels 0..5) and the cotangent (gh, gu), each plane [W][kc].

#pragma once

#include <algorithm>
#include <cstdlib>

#include "step_window.cuh"

namespace lattice {

// One reverse step reads, per (site, level), the cotangent gu at 25 distinct
// edges (the site's 6 channels, its 6 incoming edges and the 48 transposed
// Coriolis taps; 16 per parity), G = gh + gs at the 10 cells hex:: numbers
// (the site's 2, the 6 across its owned edges, the owners of its incoming
// edges), the primal h at the first 7 of them (no incoming edge's h enters
// the transpose) and the primal u at the first 11 u sources of hex:: (own
// channels and incoming edges). The gu sources are numbered as hex:: numbers
// u: own channels, incoming edges, then the taps of the transposed table
// (structured/stencils.py: transpose_coriolis_terms, packed by
// kernels/fe_step.pack_stencil) in order of first use. The reverse kernels
// take only a table whose sources number and map so (resolve_adjoint_taps):
// every uniform hex lattice's, in f32 and f64.
namespace hex_adj {
constexpr int kTaps = 48;  // transposed Coriolis taps, 8 per output channel
constexpr int kGu = 25;    // gu sources
constexpr int kG = 10;     // G sources (hex::kH)
constexpr int kH = 7;      // primal h sources: hex:: h numbers 0 .. 6
constexpr int kU = 11;     // primal u sources: hex:: u numbers 0 .. 10
// gu source of transposed tap t; own channels and incoming edges as hex::
__host__ __device__ constexpr int tap_u(int t) {
  constexpr int m[48] = {11, 2,  7,  12, 10, 4,  8,  13, 2,  11, 14, 3,  10, 15, 16, 5,
                         0,  6,  1,  9,  4,  10, 5,  8,  17, 18, 1,  9,  19, 10, 5,  16,
                         0,  6,  9,  20, 2,  21, 22, 7,  18, 23, 1,  9,  24, 2,  3,  22};
  return m[t];
}
}  // namespace hex_adj

// The transposed stencil as offsets into one block's window, resolved once
// per call on the host, passed as a kernel parameter (the constant bank).
template <typename T>
struct AdjTaps {
  T w[hex_adj::kTaps];     // transposed Coriolis weights, 8 per output channel
  int nb[6];               // per channel: neighbour cell across the owned edge, site units
  int us[hex_adj::kGu];    // the gu (and, for the first 11, u) sources, state units
  int hs[hex_adj::kG];     // the G (and, for the first 7, h) sources, state units
};

// The transposed table (host copy) resolved into *s for a window of width
// Wi and W sites, and a chunk stride of kc levels. Its sources, numbered in
// order of first use, must number and map as hex:: and hex_adj:: list them;
// false otherwise. A source is found by its offset (unique in the window).
template <typename T>
inline bool resolve_adjoint_taps(AdjTaps<T>* s, const int* table, const double* weights,
                                 int Wi, int W, int kc) {
  if (table[0] != hex_adj::kTaps) return false;
  for (int c = 0; c < 7; ++c)
    if (table[kOff + c] != 8 * c) return false;
  int u_src[hex_adj::kGu], n_u = 0, h_src[hex_adj::kG], n_h = 0;
  // the source's number, a new one numbered next; -1 past the list's end
  auto find = [](int* src, int* n, int cap, int off) {
    for (int i = 0; i < *n; ++i)
      if (src[i] == off) return i;
    if (*n == cap) return -1;
    src[(*n)++] = off;
    return *n - 1;
  };
  auto u_of = [&](int off) { return find(u_src, &n_u, hex_adj::kGu, off); };
  auto h_of = [&](int off) { return find(h_src, &n_h, hex_adj::kG, off); };
  bool ok = true;
  for (int c = 0; c < 6; ++c) {
    const int* tn = table + kNbr + 3 * c;
    s->nb[c] = tn[0] * W + tn[1] * Wi + tn[2];
    ok = ok && u_of((2 + c) * W) == hex::self_u(c);
  }
  for (int x = 0; x < 6; ++x) {  // x = 3p + j
    const int* tc = table + kInc + 3 * x;
    ok = ok && u_of((2 + tc[0]) * W + tc[1] * Wi + tc[2]) == hex::inc_u(x);
  }
  for (int t = 0; t < hex_adj::kTaps; ++t) {
    const int* tt = table + kHeader + 3 * t;
    ok = ok && u_of((2 + tt[0]) * W + tt[1] * Wi + tt[2]) == hex_adj::tap_u(t);
    s->w[t] = static_cast<T>(weights[t]);
  }
  for (int p = 0; p < 2; ++p) ok = ok && h_of(p * W) == hex::self_h(p);
  for (int c = 0; c < 6; ++c) ok = ok && h_of(s->nb[c]) == hex::nb_h(c);
  for (int x = 0; x < 6; ++x) {
    const int* tc = table + kInc + 3 * x;
    ok = ok && h_of((tc[0] & 1) * W + tc[1] * Wi + tc[2]) == hex::inc_self_h(x);
  }
  if (!ok || n_u != hex_adj::kGu || n_h != hex_adj::kG) return false;
  for (int i = 0; i < hex_adj::kGu; ++i) s->us[i] = u_src[i] * kc;
  for (int i = 0; i < hex_adj::kG; ++i) s->hs[i] = h_src[i] * kc;
  return true;
}

// The rows and columns one reverse step reads per side, from the transposed
// table (host copy): the owned edges' far cells, the incoming edges and the
// transposed Coriolis taps (slab.adjoint_stencil_reach).
inline void adjoint_reach(const int* table, int* hm, int* hi) {
  *hm = 1, *hi = 1;
  auto take = [&](int dm, int di) {
    *hm = std::max(*hm, std::abs(dm));
    *hi = std::max(*hi, std::abs(di));
  };
  for (int c = 0; c < 6; ++c) take(table[kNbr + 3 * c + 1], table[kNbr + 3 * c + 2]);
  for (int x = 0; x < 6; ++x) take(table[kInc + 3 * x + 1], table[kInc + 3 * x + 2]);
  for (int t = 0; t < table[0]; ++t) take(table[kHeader + 3 * t + 1], table[kHeader + 3 * t + 2]);
}

// Doubles at the start of a reverse kernel's dynamic shared memory: the
// warps' d(dt) sums (a multiple of 16 bytes, so what follows stays aligned).
constexpr int kRedDoubles = kStepThreads / 32;

// This block's level chunk of (h, u) into buf [8][W][kc] and of ssh into
// ssh_s [2][W], by async copies. Chunks are kc values apart; a copy's index
// splits by 2^kp_log2 >= kc. With vec_log2 >= 0 (kc a power of two,
// kc * itemsize and K * itemsize multiples of 16, the pointers 16-byte
// aligned) each (site, plane) chunk moves as 2^vec_log2 16-byte vectors;
// otherwise one value per copy. Needs gs[] written and a __syncthreads()
// before.
template <typename T>
__device__ __forceinline__ void load_chunk(T* buf, T* ssh_s, const int* gs, const T* ssh,
                                           const T* h, const T* u, int W, int kc, int kp_log2,
                                           int vec_log2, int k0, int kr, int K, int plane) {
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
    const int n = (W * 8) << kp_log2;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int kl = e & ((1 << kp_log2) - 1);
      const int q = e >> kp_log2;
      const int ch = q & 7, s = q >> 3;
      if (kl >= kr) continue;
      const int g = gs[s];
      const T* src = ch < 2 ? h + (ch * plane + g) * K : u + ((ch - 2) * plane + g) * K;
      copy_async(buf + (ch * W + s) * kc + kl, src + k0 + kl);
    }
  }
}

// G = gh + gs in place, on the window sites s of a region: rows r0 ..
// r0 + nr - 1 and columns c0 .. c0 + nc - 1 of a window of width Wi. Every
// use of gh in the transpose is through G, so a step reads one value where
// it would read two.
template <typename T>
__device__ __forceinline__ void fold_ssh(T* gh, const T* gs_s, int W, int Wi, int r0, int c0,
                                         int nr, int nc, int kc, int kp_log2, int kr) {
  const FastDiv by_nc(nc);
  const int n = (2 * nr * nc) << kp_log2;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int kl = e & ((1 << kp_log2) - 1);
    const int q = e >> kp_log2;
    if (kl >= kr) continue;
    const int p = q >= nr * nc ? 1 : 0, t = q - p * nr * nc;
    const int r = by_nc.div(t), c = by_nc.mod(t, r);
    const int s = (r0 + r) * Wi + c0 + c;
    gh[(p * W + s) * kc + kl] += gs_s[p * W + s];
  }
}

// gu = 0 on the masked channels of the window's sites (gu [6][W][kc], the
// live bits live_s [W]: step_window.cuh, load_live), in place. A masked step
// ends u' = m * u', so its output cotangent enters the transpose as m * gu:
// folded once here, every read of gu in the taps, in S_e and in d(dt) reads
// m * gu. A warp takes a site at a time: where every bit is set (most of a
// channel's sites) it goes on at once, else its lanes zero the site's
// masked chunks together (one thread per site, zeroing up to 6 kc values
// alone, cost adjoint_step 8-9% at 64x64x100 f32, PERF.md). Not inlined:
// inlined, it cost the step body registers, and the masked arm 1.10x the
// periodic one's time there against 1.06x.
template <typename T>
__device__ __noinline__ void fold_live(T* gu, const int* live_s, int W, int kc, int kr) {
  const int lane = threadIdx.x & 31;
  const int n_warps = static_cast<int>(blockDim.x >> 5);
  for (int s = static_cast<int>(threadIdx.x >> 5); s < W; s += n_warps) {
    const unsigned bits = static_cast<unsigned>(live_s[s]);
    if (bits == kAllLive) continue;  // the same for the whole warp
    for (int e = lane; e < 6 * kc; e += 32) {
      const int ch = e / kc, kl = e - ch * kc;
      if (kl < kr && !((bits >> ch) & 1u)) gu[(ch * W + s) * kc + kl] = T(0);
    }
  }
}

// The block's d(dt) share, in two halves around a barrier of every thread:
// each warp's sum of its threads' values into red[warp]; after the barrier,
// thread 0 adds the warps' sums in order. A fixed order, no atomics.
__device__ __forceinline__ void share_warps(double v, double* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
}
__device__ __forceinline__ double share_total(const double* red) {
  double v = red[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) v += red[w];
  return v;
}

}  // namespace lattice
