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
#include <type_traits>

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
  int inc_ch[6];           // incoming edge x = 3p + j: its channel,
  int inc_off[6];          //   and its owner's window site, from the site's (site units)
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
    s->inc_ch[x] = tc[0];
    s->inc_off[x] = tc[1] * Wi + tc[2];
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
// The shares a block of a forced reverse arm writes, each summed by
// ddt_reduce in a fixed order: d(dt), then d(r_lin), d(Cd) and d(lambda).
constexpr int kShares = 4;

// The wind and drag part of the transpose of dt F (step_window.cuh,
// wind_drag) at one owned edge-level, for the output cotangent gu (m gu on a
// channel), a = dt gu (structured/adjoint.py, forcing_transpose): nothing
// away from the edge's top and bottom level; there, adds to *du the drag's
// a (-(r + 2 Cd |u| inv_h)) (Rayleigh's -dt lambda gu the body adds at every
// level), to *dd gu times the wind and drag part of F (d(dt)), at the top
// level a inv_h to *dwind (none where dwind is null), and at the bottom level
// -a u and -a |u| u inv_h to the d(r_lin) and d(Cd) shares. lv is the edge's
// packed levels, w its staged wind, he its old h_edge. The shares are
// doubles: each term rounds in T, the sums do not.
template <typename T>
__device__ __forceinline__ void wind_drag_adjoint(T gu, T u, T he, int lv, int k, const T* w,
                                                  T* dwind, const ForcingArgs<T>& fc, T dt,
                                                  T* du, double* dd, double* d_lin,
                                                  double* d_quad) {
  const bool top = top_level(lv, k), bot = bottom_level(lv, k);
  if (!(top || bot)) return;
  const T a = dt * gu;
  const T inv_h = inv_edge(he);
  const T au = fabs(u);
  T f = T(0);
  if (top) {
    f = *w * inv_h;
    if (dwind) *dwind += a * inv_h;
  }
  if (bot) {
    f = f - (fc.dlin * u + fc.dquad * au * u * inv_h);
    *du += a * (-(fc.dlin + T(2) * fc.dquad * au * inv_h));
    *d_lin -= static_cast<double>(a * u);
    *d_quad -= static_cast<double>(a * au * u * inv_h);
  }
  *dd += static_cast<double>(gu * f);
}

// The h_edge cotangent of dt F at one edge-level (owned or incoming):
// a (top w - bot Cd |u| u) (-inv_h^2), 0 where h_edge <= 0 and away from the
// edge's top and bottom level; it joins the flux transpose's u dF, half to
// each of the edge's cells.
template <typename T>
__device__ __forceinline__ T wind_drag_dhe(T gu, T u, T he, int lv, int k, const T* w,
                                           const ForcingArgs<T>& fc, T dt) {
  const bool top = top_level(lv, k), bot = bottom_level(lv, k);
  if (!(top || bot) || !(he > T(0))) return T(0);
  const T inv_h = T(1) / he;
  T x = top ? *w : T(0);
  if (bot) x = x - fc.dquad * fabs(u) * u;
  return dt * gu * x * (-inv_h * inv_h);
}

// The reverse forced arms' pass over the cells of a region of n window
// sites, after the body has stored its h cotangent: a thread takes a cell
// (region site t, parity p) and, at each level of the block's chunk that is
// the top or bottom level of one of its 6 edges (3 owned, 3 incoming), forms
// its h cotangent again, G + 1/2 (the flux transpose's sum over the 6 edges
// + their h_edge cotangents there, wind_drag_dhe), and stores it through
// `out(p, t, s, kl)`: the body's sum and this one in one order, so that no
// cotangent of G's size rounds the forcing's terms twice. With kAdd (the
// forced tracer arms, whose body adds the tracers' terms to dh) it adds
// 1/2 the h_edge cotangents to the stored value instead. `prim` and `cot`
// are the window's primal and (folded) cotangent chunks; `site(t)` the
// window site of t, or -1 off the lattice.
template <bool kAdd, typename T, typename Site, typename Out>
__device__ __forceinline__ void dh_pass(const T* prim, const T* cot, const AdjTaps<T>& tp,
                                        const ForcingSmem<T>& fs, int n, Site site, Out out,
                                        int W, int kc, int k0, int kr, T dt, T dt_div,
                                        const ForcingArgs<T>& fc) {
  for (int e = threadIdx.x; e < 2 * n; e += blockDim.x) {
    const int p = e >= n ? 1 : 0, t = e - p * n;
    const int s = site(t);
    if (s < 0) continue;
    // the 6 edges: owned i = f (channel 2f + p), incoming x = 3p + i - 3
    int es[6], lv[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      es[i] = i < 3 ? (2 * i + p) * W + s : tp.inc_ch[3 * p + i - 3] * W + s + tp.inc_off[3 * p + i - 3];
      lv[i] = fs.lvl[es[i]];
    }
    for (int m = 0; m < 12; ++m) {
      int lev[2];
      chunk_levels(lv[m >> 1], k0, kr, &lev[0], &lev[1]);
      const int kl = lev[m & 1];
      if (kl < 0) continue;
      bool seen = false;  // the level of an earlier (edge, end)
      for (int m2 = 0; m2 < m; ++m2) {
        int l2[2];
        chunk_levels(lv[m2 >> 1], k0, kr, &l2[0], &l2[1]);
        seen = seen || l2[m2 & 1] == kl;
      }
      if (seen) continue;
      const T* v = prim + s * kc + kl;
      const T* g = cot + s * kc + kl;
      const T Gc = g[tp.hs[hex::self_h(p)]], hc = v[tp.hs[hex::self_h(p)]];
      T flux = T(0), dhe = T(0);
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const int ch = 2 * f + p, us = tp.us[hex::self_u(ch)];
        if (!kAdd) flux += v[us] * (dt_div * (g[tp.hs[hex::nb_h(ch)]] - Gc));
        dhe += wind_drag_dhe(g[us], v[us], T(0.5) * (v[tp.hs[hex::nb_h(ch)]] + hc), lv[f],
                             k0 + kl, fs.wind + es[f], fc, dt);
      }
#pragma unroll
      for (int x = 3 * p; x < 3 * p + 3; ++x) {
        const int us = tp.us[hex::inc_u(x)];
        if (!kAdd) flux += v[us] * (dt_div * (Gc - g[tp.hs[hex::inc_self_h(x)]]));
        dhe += wind_drag_dhe(g[us], v[us],
                             T(0.5) * (v[tp.hs[hex::inc_nb_h(x)]] + v[tp.hs[hex::inc_self_h(x)]]),
                             lv[x - 3 * p + 3], k0 + kl, fs.wind + es[x - 3 * p + 3], fc, dt);
      }
      T& o = out(p, t, s, kl);
      o = kAdd ? o + T(0.5) * dhe : Gc + T(0.5) * (flux + dhe);
    }
  }
}

// The reverse forced arms' last pass, after the body has stored the
// cotangent on a region of n window sites: a thread takes an owned edge
// (channel ch of region site t) and, at its top and bottom level in the
// block's chunk, adds the wind and drag terms (wind_drag_adjoint) to the
// stored du that `out(ch, t, s, kl)` returns, and, where `own(t)` (the
// site's edges are the tile's: its shares and d(wind) are this tile's to
// add), a inv_h to d(wind) at `dwind(ch, t)` and the d(dt), d(r_lin) and
// d(Cd) terms to the shares.
template <typename T, typename Site, typename Own, typename Out, typename Dwind>
__device__ __forceinline__ void wind_drag_adjoint_pass(
    const T* prim, const T* cot, const AdjTaps<T>& tp, const ForcingSmem<T>& fs, int n,
    Site site, Own own, Out out, Dwind dwind, int W, int kc, int k0, int kr, T dt,
    const ForcingArgs<T>& fc, double* dd, double* d_lin, double* d_quad) {
  __syncthreads();
  for (int e = threadIdx.x; e < 6 * n; e += blockDim.x) {
    const int ch = e / n, t = e - ch * n;
    const int s = site(t);
    if (s < 0) continue;
    const int lv = fs.lvl[ch * W + s];
    int lev[2];
    chunk_levels(lv, k0, kr, &lev[0], &lev[1]);
    const bool mine = own(t);
    for (int j = 0; j < 2; ++j) {
      const int kl = lev[j];
      if (kl < 0) continue;
      const T* v = prim + s * kc + kl;
      const T* g = cot + s * kc + kl;
      const int us = tp.us[hex::self_u(ch)];
      const T he = T(0.5) * (v[tp.hs[hex::nb_h(ch)]] + v[tp.hs[hex::self_h(ch & 1)]]);
      T du = T(0);
      double x_dd = 0.0, x_lin = 0.0, x_quad = 0.0;
      wind_drag_adjoint(g[us], v[us], he, lv, k0 + kl, fs.wind + ch * W + s,
                        mine ? dwind(ch, t) : static_cast<T*>(nullptr), fc, dt, &du, &x_dd,
                        &x_lin, &x_quad);
      T& o = out(ch, t, s, kl);
      o = o + du;
      if (mine) *dd += x_dd, *d_lin += x_lin, *d_quad += x_quad;
    }
  }
}

// The reverse tracer arms' operands (kTracers, chosen by a non-null `tr`;
// structured/fused_model.kernel_tracers' planes t * 2 + p, (2 nT, ny2, nx,
// K), laid out as h): the primal tracers of state j, their cotangent at
// j + 1, the h and tracers of state j + 1 (the stack's next slot, or the
// state after the stack's last: what the forward kernel computed, bit for
// bit), on a channel the live-cell mask (2, ny2, nx) in T, the cotangent at
// j (out), and kappa and upwind / 2 rounded once to T on the host.
//
// Why h' and T' are read and not recomputed: the transpose at a site needs
// a = c gT' / h' and T' at its 10 G sources (hex_adj::kG, one ring), and
// recomputing h' and T' there reads h, u and T two rings out, a window one
// row wider per side (8 rows for the (4, x) tiles, not 6) and a second
// forward tracer pass. Reading them costs 2 + 2 nT K-planes per site pair
// from device memory, 6 of 42 with two tracers (PERF.md).
template <typename T>
struct AdjTracers {
  const T* tr;       // primal planes of state j; null: the tracer-free arm
  const T* gtr;      // cotangent planes at j + 1
  const T* h_next;   // h of state j + 1
  const T* tr_next;  // tracer planes of state j + 1
  const T* cmask;    // the masked arm's live-cell mask; null otherwise
  T* dtr;            // cotangent planes at j
  T kappa, half_up;
  int n;             // tracers
};

// The tracer transpose's first half, once per window after the loads: for
// each site, parity and level of the chunk, a = c gT' / h' (0 on a culled
// cell) in place of each staged gT', and the h' feedback -sum_t a T' folded
// into G = gh + gs (cot's planes 0 and 1), where the continuity transpose
// reads it at the neighbours (structured/adjoint.py, tracer_transpose).
// `cot` is the window's cotangent chunk, its tracer planes after the state's
// 8; h' and T' are read from device memory, a level per thread, neighbouring
// threads on neighbouring levels. Chunks are kc values apart, and an index
// splits by 2^kc_log2 >= kc.
template <typename T>
__device__ __forceinline__ void fold_tracers(T* cot, const int* gsite, const AdjTracers<T>& at,
                                             int W, int kc, int kc_log2, int k0, int kr, int K,
                                             int plane) {
  const int pk = W * kc;
  const int n = (2 * W) << kc_log2;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int kl = e & ((1 << kc_log2) - 1);
    const int q = e >> kc_log2;
    if (kl >= kr) continue;
    const int p = q >= W ? 1 : 0, s = q - p * W;
    const int g = p * plane + gsite[s];
    const T hn = at.h_next[static_cast<size_t>(g) * K + k0 + kl];
    const bool live = at.cmask == nullptr || at.cmask[g] > T(0);
    T corr = T(0);
    for (int t = 0; t < at.n; ++t) {
      T* ap = cot + (8 + 2 * t + p) * pk + s * kc + kl;
      const T a = live ? *ap / hn : T(0);
      *ap = a;
      corr += a * at.tr_next[(static_cast<size_t>(2 * t * plane) + g) * K + k0 + kl];
    }
    cot[(p * W + s) * kc + kl] -= corr;
  }
}

// The live bits of a site's six incoming edges (bit x = 3p + j), each its
// owner's bit of its channel, from the window's live bits: the masked
// tracer arm's, read once per site.
template <typename T>
__device__ __forceinline__ unsigned adj_incoming_live(const int* live_s, int s,
                                                      const AdjTaps<T>& tp) {
  unsigned bits = 0u;
#pragma unroll
  for (int x = 0; x < 6; ++x)
    bits |= ((static_cast<unsigned>(live_s[s + tp.inc_off[x]]) >> tp.inc_ch[x]) & 1u) << x;
  return bits;
}

// The transpose of one edge's tracer flux g = F te - kappa h_e (T_n - T_o) /
// dc (step_window.cuh, tracer_edge_flux) for dg = dt s_div (a_n - a_o), the
// sign of F held fixed: dF = dg te, the cotangents of T_n and T_o, the
// h_edge cotangent of the kappa term (on a live edge), and g itself (for
// d(dt)).
template <typename T>
__device__ __forceinline__ void tracer_edge_adjoint(T F, T he, T tn, T to, T dg, bool live,
                                                    const AdjTracers<T>& at, T inv_dc, T* dF,
                                                    T* dtn, T* dto, T* dhe, T* g) {
  T te = T(0.5) * (tn + to), wn = T(0.5), wo = T(0.5);
  if (at.half_up != T(0)) {
    const T sg = static_cast<T>((F > T(0)) - (F < T(0)));
    te = te - at.half_up * sg * (tn - to);
    wn = wn - at.half_up * sg;
    wo = wo + at.half_up * sg;
  }
  const T dte = dg * F;
  *dF = dg * te;
  *dtn = dte * wn;
  *dto = dte * wo;
  *g = F * te;
  *dhe = T(0);
  if (at.kappa != T(0) && live) {
    const T grad = (tn - to) * inv_dc;
    const T kd = at.kappa * he * inv_dc * dg;
    *dtn = *dtn - kd;
    *dto = *dto + kd;
    *dhe = -dg * at.kappa * grad;
    *g = *g - at.kappa * he * grad;
  }
}

// The tracer transpose's second half at one (site, level), before the
// linear transpose that reads its sums: P and C point at the site-level in
// the window's primal and cotangent chunks (planes of pk values; the
// tracers' after the state's 8, the cotangent's holding a from
// fold_tracers and G with the h' feedback). For every tracer it stores dT =
// a h plus the edge terms through `store(plane, v)`, and it returns per
// owned channel the flux cotangent the tracers add (trF, joined to the
// continuity's), per parity the incoming edges' u dF and every edge's
// kappa h_edge cotangent (trX, joined to the flux sum of dh, halved there)
// and sum_t a T (trY, added to dh), and in *dd the d(dt) terms that the
// h' feedback makes cancel, <G, tend_h> and sum_t <a, tend_T>, per cell as
// the plain reverse forms them (a cell's G or a times its divergence, in
// the forward's order), each term in T and their sum in double. `live` and
// `inc_live` are the site's and its incoming edges' live bits (masked
// arm). Without `inc_flux` trX leaves out the incoming edges' u dF: the
// nonlinear reverse adds the tracers' dF to its stored flux cotangent on a
// ring around the tile (nl_adjoint.cuh), where the incoming edges read it.
template <typename T, bool kMasked, typename Store>
__device__ __forceinline__ void tracer_adjoint(const T* P, const T* C, int pk,
                                               const AdjTaps<T>& tp, const AdjTracers<T>& at,
                                               unsigned live, unsigned inc_live, T dt_div,
                                               T s_div, T inv_dc, T* trF, T* trX, T* trY,
                                               double* dd, Store store, bool inc_flux = true) {
  T h[hex_adj::kG], u[hex_adj::kU];
#pragma unroll
  for (int x = 0; x < hex_adj::kG; ++x) h[x] = P[tp.hs[x]];
#pragma unroll
  for (int x = 0; x < hex_adj::kU; ++x) u[x] = P[tp.us[x]];
#pragma unroll
  for (int i = 0; i < 6; ++i) trF[i] = T(0);
  trX[0] = trX[1] = trY[0] = trY[1] = T(0);
  *dd = 0.0;
  // <G, tend_h>: tend_h = -s_div (the owned edges' F - the incoming ones')
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int o = hex::self_h(p);
    T total = T(0);
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const int ch = f * 2 + p;
      const T fl = u[hex::self_u(ch)] * (T(0.5) * (h[hex::nb_h(ch)] + h[o]));
      total = (f == 0) ? fl : total + fl;
    }
#pragma unroll
    for (int x = 3 * p; x < 3 * p + 3; ++x)
      total = total - u[hex::inc_u(x)] * (T(0.5) * (h[hex::inc_nb_h(x)] + h[hex::inc_self_h(x)]));
    *dd += static_cast<double>(C[tp.hs[o]] * -(total * s_div));
  }
  for (int t = 0; t < at.n; ++t) {
    const T* tv = P + (8 + 2 * t) * pk;
    const T* av = C + (8 + 2 * t) * pk;
    T c[hex_adj::kG], a[hex_adj::kG];
#pragma unroll
    for (int x = 0; x < hex_adj::kG; ++x) c[x] = tv[tp.hs[x]], a[x] = av[tp.hs[x]];
    T dT[2];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int o = hex::self_h(p);
      T d = a[o] * h[o];
      trY[p] += a[o] * c[o];
      T total = T(0);  // the owned edges' tracer flux - the incoming ones'
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        const int ch = f * 2 + p, nb = hex::nb_h(ch);
        const T he = T(0.5) * (h[nb] + h[o]);
        const bool on = !kMasked || ((live >> ch) & 1u);
        T dF, dtn, dto, dhe, g;
        tracer_edge_adjoint(u[hex::self_u(ch)] * he, he, c[nb], c[o], dt_div * (a[nb] - a[o]),
                            on, at, inv_dc, &dF, &dtn, &dto, &dhe, &g);
        trF[ch] += dF;
        trX[p] += dhe;
        d += dto;
        total = (f == 0) ? g : total + g;
      }
#pragma unroll
      for (int x = 3 * p; x < 3 * p + 3; ++x) {
        const int ow = hex::inc_self_h(x), nb = hex::inc_nb_h(x);
        const T he = T(0.5) * (h[nb] + h[ow]);
        const T ue = u[hex::inc_u(x)];
        const bool on = !kMasked || ((inc_live >> x) & 1u);
        T dF, dtn, dto, dhe, g;
        tracer_edge_adjoint(ue * he, he, c[nb], c[ow], dt_div * (a[nb] - a[ow]), on, at,
                            inv_dc, &dF, &dtn, &dto, &dhe, &g);
        trX[p] += inc_flux ? ue * dF + dhe : dhe;
        d += dtn;
        total = total - g;
      }
      *dd += static_cast<double>(a[o] * -(total * s_div));
      dT[p] = d;
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) store(2 * t + p, dT[p]);
  }
}

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

// The forced arms' extra shares of a block, each in the warps' sums `red`
// (one kind at a time, behind block barriers) and written by thread 0 at
// part[i * n_shares] for i = 1, 2, 3: d(r_lin), d(Cd), and -dt times the
// Rayleigh sum, d(lambda). Every thread of the block calls it.
__device__ __forceinline__ void write_forcing_shares(double* red, double* part, long long n_shares,
                                                     double d_lin, double d_quad, double rayl,
                                                     double dt) {
  const double v[3] = {d_lin, d_quad, -dt * rayl};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    __syncthreads();
    share_warps(v[i], red);
    __syncthreads();
    if (threadIdx.x == 0) part[(i + 1) * n_shares] = share_total(red);
  }
}

// Adds the call's kShares * n shares, [kShares][n], to acc[0] (d(dt)) and
// the last three to coef[0 .. 2] (d(r_lin), d(Cd), d(lambda)), each in a
// fixed order; coef null: the unforced arm's one share per block.
static inline int reduce_shares(const double* part, long long n, double* acc, double* coef,
                                cudaStream_t stream) {
  int err = reduce_ddt(part, n, acc, stream);
  for (int i = 1; coef != nullptr && err == 0 && i < kShares; ++i)
    err = reduce_ddt(part + i * n, n, coef + i - 1, stream);
  return err;
}


// The stratified reverse arms (kStrat, chosen by a non-null W; unforced and
// tracer-free; structured/adjoint.py, pressure_transpose). The forward's
// pressure is -grad Phi, Phi = g ssh + h @ W of the old state, so with
// S_c,k = sum_owned gu_k - sum_incoming gu_k (gu folded with the wall mask)
// and dPhi = (dt / dc) S, the transpose adds dh[c, l] += sum_k W[l, k]
// dPhi[c, k], d(W)[l, k] += sum_c h[c, l] dPhi[c, k], and to d(dt)
// <gu, -grad(h @ W)> = (1 / dc) sum_{l, k} W[l, k] sum_c h[c, l] S[c, k]
// (the g ssh part is the unstratified body's). ds is unchanged.
//
// Where the levels meet. Each rank holds a chunk of levels, so both sums
// over k need every rank's S. The body stores its chunk of S at the tile's
// cells in shared memory (StratAdjSmem::sl); after a cluster barrier every
// rank reads the others' chunks in place through distributed shared
// memory, in rank order, and owns the W rows and the d(W) rows of its own
// levels (wt holds W[k0 + kl][k]): W dPhi at its levels needs S at all
// levels and h only at its own, and so does d(W)'s row. One exchange, of
// S (2 core kc values per rank), serves both: a rank owning d(W)'s columns
// would need every rank's h as well.
//
// d(W) in double, with no atomics. A tile's d(W) is a full K x K matrix
// (its cells' h against their S), so each tile keeps an accumulator of its
// own in device memory, [n_tiles][K][K] (k-major: a rank's threads write a
// row of its levels at consecutive addresses), written at a call's first
// launch and added to at each later one (the launches of a call run in
// order; a block reads its accumulator after wait_previous_grid); at the
// call's end one small kernel adds the tiles' accumulators in tile order to
// d(W) (strat_reduce). Every sum runs in a fixed order, so f64 reruns are
// bitwise equal. The accumulators take 8 K^2 bytes a tile: 5.1 MB at
// 64x64x100 on (4, 8) tiles, inside L2; 82 MB at 256x256x100 on (4, 8)
// tiles, read and written once a launch from device memory (PERF.md).
template <typename T>
struct AdjStrat {
  const T* w;      // W (K, K) row-major in T; null: the unstratified arm
  double* acc;     // the tiles' d(W) accumulators [n_tiles][K][K], k-major
  int first;       // nonzero at a call's first launch: acc is written, not added to
};

// The stratified arm's shared memory beyond the unstratified layout: S at
// the tile's cells and this block's levels [2][core][kc] (zero off the
// lattice and past the chunk's real levels), and W's rows of those levels,
// wt[k][kl] = W[k0 + kl][k], [K][kc].
template <typename T>
struct StratAdjSmem {
  T* sl;
  T* wt;
  __device__ StratAdjSmem(void* end, int core, int kc) {
    const uintptr_t at = (reinterpret_cast<uintptr_t>(end) + 15) & ~static_cast<uintptr_t>(15);
    sl = reinterpret_cast<T*>(at);
    wt = sl + 2 * core * kc;
  }
};
inline size_t strat_adj_smem_bytes(int core, int kc, int k, size_t itemsize) {
  return 16 + itemsize * (static_cast<size_t>(2 * core * kc) + static_cast<size_t>(k) * kc);
}

// W's rows of the block's levels into wt by async copies, and S's chunk
// zeroed (the body stores the tile's lattice sites' real levels).
template <typename T>
__device__ __forceinline__ void load_strat_rows(const StratAdjSmem<T>& sm, const T* w, int core,
                                                int K, int k0, int kr, int kc_log2) {
  const int kc = 1 << kc_log2;
  for (int e = threadIdx.x; e < (K << kc_log2); e += blockDim.x) {
    const int kl = e & (kc - 1);
    if (kl < kr) copy_async(sm.wt + e, w + (k0 + kl) * K + (e >> kc_log2));
  }
  for (int e = threadIdx.x; e < 2 * core * kc; e += blockDim.x) sm.sl[e] = T(0);
}

// The stratified arm's pass, after the body has stored the tile's
// cotangent and its S chunk, behind a cluster barrier (every rank's S
// visible), and before a cluster barrier that keeps every rank's shared
// memory alive until the last read. `h(p, r, c, kl)` is the primal h of the
// tile's cell (row r, column c, parity p) at level k0 + kl (0 off the
// lattice): the window's chunk (window_h), or for the nonlinear reverse,
// which holds one slice at a time, device memory; the tile's site t is
// (t / ct, t % ct); `dh(p, t, kl)` returns the stored h cotangent of cell
// (t, p) at level k0 + kl, or null off the lattice; `acc` is the tile's
// accumulator. Adds the h @ W part of d(dt) to *share.
template <typename T, typename Hv, typename Dh>
__device__ __forceinline__ void strat_adjoint_pass(const StratAdjSmem<T>& sm,
                                                   cg::cluster_group& cluster, Hv h,
                                                   double* acc, bool first, Dh dh, int core,
                                                   int ct, int kc_log2, int k0, int kr, int K,
                                                   int n_ranks, T dt, T inv_dc, double* share) {
  const int kc = 1 << kc_log2;
  const T dt_inv_dc = dt * inv_dc;
  // dh += (dt / dc) sum_k W[k0 + kl][k] S[k], k in rank order: a thread per
  // (cell, level), neighbouring threads on neighbouring levels
  for (int e = threadIdx.x; e < (2 * core << kc_log2); e += blockDim.x) {
    const int kl = e & (kc - 1), pt = e >> kc_log2;
    if (kl >= kr) continue;
    const int p = pt >= core ? 1 : 0;
    T* d = dh(p, pt - p * core, kl);
    if (d == nullptr) continue;
    T sum = T(0);
    for (int rr = 0; rr < n_ranks; ++rr) {
      const T* src = cluster.map_shared_rank(sm.sl, rr) + (pt << kc_log2);
      const T* wr = sm.wt + ((rr * kc) << kc_log2) + kl;
      const int kr2 = min(kc, K - rr * kc);
#pragma unroll 4
      for (int kk = 0; kk < kr2; ++kk) sum += wr[kk << kc_log2] * src[kk];
    }
    *d = *d + dt_inv_dc * sum;
  }
  // d(W)[k0 + kl][k] = (dt / dc) sum over the tile's cells of h[kl] S[k], in
  // double, and d(dt)'s (1 / dc) W[k0 + kl][k] times that sum: a thread per
  // (k, kl), neighbouring threads on neighbouring levels of one k
  const double s_dw = static_cast<double>(dt) * static_cast<double>(inv_dc);
  const double s_dd = static_cast<double>(inv_dc);
  for (int e = threadIdx.x; e < (K << kc_log2); e += blockDim.x) {
    const int kl = e & (kc - 1), k = e >> kc_log2;
    if (kl >= kr) continue;
    const T* src = cluster.map_shared_rank(sm.sl, k >> kc_log2) + (k & (kc - 1));
    double sum = 0.0;
    for (int p = 0; p < 2; ++p) {
      const T* sp = src + ((p * core) << kc_log2);
      int t = 0;
      for (int r = 0; t < core; ++r)
        for (int c = 0; c < ct; ++c, ++t)
          sum = fma(static_cast<double>(h(p, r, c, kl)), static_cast<double>(sp[t << kc_log2]),
                    sum);
    }
    double* a = acc + static_cast<size_t>(k) * K + k0 + kl;
    *a = first ? s_dw * sum : *a + s_dw * sum;
    *share += s_dd * static_cast<double>(sm.wt[e]) * sum;
  }
}

// strat_adjoint_pass's h from a window's primal h chunk [2][W][kc] (the
// linear reverses'), the tile's site (r, c) at window site (hm + r) * Wi +
// hi + c.
template <typename T>
struct WindowH {
  const T* h;
  int hm, hi, Wi, pk, kc_log2;
  __device__ T operator()(int p, int r, int c, int kl) const {
    return h[p * pk + (((hm + r) * Wi + hi + c) << kc_log2) + kl];
  }
};

// d(W)[l][k] += the sum over the tiles of acc[tile][k][l], in tile order
// (a thread per entry). A template, as ddt_reduce_kernel, so that a source
// that does not launch it compiles none.
template <typename T>
static __global__ void strat_reduce_kernel(const T* __restrict__ acc, int n_tiles, int K,
                                           T* __restrict__ dw) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int kk = K * K;
  if (idx >= kk) return;
  T v = 0;
  for (int t = 0; t < n_tiles; ++t) v += acc[static_cast<size_t>(t) * kk + idx];
  const int k = idx / K, l = idx - k * K;
  dw[l * K + k] += v;
}

// Launches strat_reduce_kernel; returns 0 or the CUDA error of the launch.
static inline int strat_reduce(const double* acc, int n_tiles, int K, double* dw,
                               cudaStream_t stream) {
  const int threads = 256;
  strat_reduce_kernel<double>
      <<<(K * K + threads - 1) / threads, threads, 0, stream>>>(acc, n_tiles, K, dw);
  return static_cast<int>(cudaGetLastError());
}

// ---- the nonlinear reverse's stratified pass -----------------------------
//
// The h @ W part of the stratified pressure's transpose for the nonlinear
// reverse at q = 1 (nl_adjoint.cu launches it after each step's stencil
// launch): the stencil kernel stores S = Sg at every cell and level in a
// device scratch [cells][K], and this kernel, one launch a step, adds
// (dt / dc) W S to the stored dh, forms the step's d(W) = (dt / dc) sum over
// the cells of h (x) S in double, and d(dt)'s W part (1 / dc) sum W (.) that
// sum. It replaces the in-kernel jnp.dot of the JAX step at HIGHEST
// precision (mpas_ocean_tpu/structured/pallas_model.py:159-163, the TPU's
// matrix unit) transposed inside kernel 3 (_adjoint_segment_kernel, :1480);
// its plain version is structured/adjoint.strat_pass.
//
// Design. The cells fall in a fixed set of groups (one per 64 cells, at
// most 64: kernels/adjoint_step.strat_pass_groups; a fixed range of cells
// each) and the levels l of dh and of d(W)'s rows in
// kPassSplits halves (8-aligned): a block per (group, half), walking its
// group's cells in sub-chunks of cb, staged in shared memory transposed
// (S [k][cell] at every level, h [l][cell] at the half's), with the half's
// rows of W transposed (wt[k][l]), all K of its columns at once where they
// fit (K = 100) and kb at a time where they do not:
//   W S: a thread a 4-cell x 4-level register tile (at most one a thread:
//     strat_pass_fit sizes cb so), the K-term sums in T in level order
//     across W's column chunks (FP32 register tiles in f32), vector loads
//     of S and W;
//   d(W): the FP64 tensor cores (mma.sync m8n8k4 f64), D[l][k] += h[c][l]
//     S[c][k] four cells a step, each warp holding up to kPassTiles 8 x 8
//     tiles of the half's rows in registers over the group's range (more
//     tiles in batches that walk the range again);
//   after the range, d(dt)'s share (1 / dc) sum W (.) D over the block's
//     tiles (the warps' sums in order), and (dt / dc) D written into its
//     rows of the group's partial [groups][K][K] (k-major) at a call's
//     first launch and added to at every later one; strat_reduce adds the
//     partials in group order once per call. No atomics: f64 reruns are
//     bitwise equal.
// What bounds it: 2 K^2 operations per cell for each product (82 MFLOP at
// 64x64x100, 1.3 GFLOP at 256x256x100) against h, S and dh read once and dh
// written once (S is read by both halves); the partials take groups K^2
// doubles (5.1 MB at K = 100). Shared memory grows with K through the
// staged S and h only: the pass takes up to 1312 levels in f64 and 2048 in
// f32 (strat_pass_fit; W's columns in chunks from 113 and 250 levels).
template <typename T>
struct StratPassArgs {
  const T* h;      // the step's primal h, [cells][K]
  const T* s;      // the step's S (the stencil's scratch), [cells][K]
  const T* w;      // W (K, K), row-major
  T* dh;           // the step's h cotangent, [cells][K], added to
  double* acc;     // the groups' d(W) partials [groups][K][K], k-major
  double* share;   // this launch's d(dt) shares, one per block
  T dtdc;          // dt / dc in T (the W S product's scale)
  double s_dw, s_dd;  // dt / dc and 1 / dc in double (d(W)'s and d(dt)'s)
  int cells, K, chunk, cb, kb, first;  // cells a group (a multiple of cb); cells a
                                       // sub-chunk; W's columns staged at once
};

constexpr int kPassThreads = 512;
constexpr int kPassWarps = kPassThreads / 32;
constexpr int kPassTiles = 8;   // most d(W) tiles a warp holds at once
constexpr int kPassSplits = 2;  // level halves: blocks per group

// The pass's strides for K levels and sub-chunks of cb cells: a half's
// levels kh (8-aligned), the K rows padded to 8 (kp), the staged rows'
// width (cb + 4: 16-byte rows, the tensor cores' fragments across banks).
struct StratPassShape {
  int kh, kp, cbp;
  __host__ __device__ StratPassShape(int K, int cb) {
    kh = (K + 8 * kPassSplits - 1) / (8 * kPassSplits) * 8;
    kp = (K + 7) / 8 * 8;
    cbp = cb + 4;
  }
};

inline size_t strat_pass_smem_bytes(int K, int cb, int kb, size_t itemsize) {
  const StratPassShape sh(K, cb);
  return itemsize * (static_cast<size_t>(kb) * sh.kh +
                     static_cast<size_t>(sh.kp + sh.kh) * sh.cbp) +
         sizeof(double) * kPassWarps;
}

// The pass's staging at K levels in `max_smem` bytes: the sub-chunk cb, the
// largest of 128, 64, 32, 16 and 8 cells whose W S tiles are at most one a
// thread and whose S and h leave room for 8 of W's columns (all of them
// below 8), then kb, the most of W's columns that fit: all K, else a
// multiple of 8. False where no sub-chunk fits.
inline bool strat_pass_fit(int K, size_t itemsize, int max_smem, int* cb, int* kb) {
  for (int c = 128; c >= 8; c /= 2) {
    const StratPassShape sh(K, c);
    if ((sh.kh / 4) * (c / 4) > kPassThreads) continue;
    const size_t base = strat_pass_smem_bytes(K, c, 0, itemsize), col = itemsize * sh.kh;
    if (base + col * min(K, 8) > static_cast<size_t>(max_smem)) continue;
    const int room = static_cast<int>((static_cast<size_t>(max_smem) - base) / col);
    *cb = c;
    *kb = room >= K ? K : room / 8 * 8;
    return true;
  }
  return false;
}

// D += A B on the FP64 tensor cores, an 8 x 8 x 4 product per warp: a the
// lane's element of A (row lane / 4, column lane % 4), b of B (row lane % 4,
// column lane / 4), d0, d1 of D (row lane / 4, columns 2 (lane % 4) + 0, 1).
__device__ __forceinline__ void mma_f64(double& d0, double& d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
               : "+d"(d0), "+d"(d1)
               : "d"(a), "d"(b));
}

// Four consecutive values from 16-byte aligned shared memory.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  const double2 y = *reinterpret_cast<const double2*>(p + 2);
  v[0] = x.x, v[1] = x.y, v[2] = y.x, v[3] = y.y;
}

template <typename T>
__global__ void __launch_bounds__(kPassThreads, 1) strat_pass_kernel(const StratPassArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* red = reinterpret_cast<double*>(smem_raw);  // [kPassWarps]
  T* wt = reinterpret_cast<T*>(red + kPassWarps);     // [kb][kh]: the half's W rows, transposed
  const int K = a.K, cb = a.cb, kb = a.kb;
  const StratPassShape sh(K, cb);
  T* st = wt + kb * sh.kh;      // [kp][cbp]: the sub-chunk's S, transposed
  T* ht = st + sh.kp * sh.cbp;  // [kh][cbp]: its h at the half's levels
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = blockIdx.x / kPassSplits;
  const int l0 = (blockIdx.x % kPassSplits) * sh.kh, nl = min(sh.kh, K - l0);
  const int begin = group * a.chunk, end = min(begin + a.chunk, a.cells);
  const int lt_n = sh.kh / 8, kt_n = sh.kp / 8, n_tiles = nl > 0 ? lt_n * kt_n : 0;
  const int per_batch = kPassWarps * kPassTiles;
  const int n_batches = (n_tiles + per_batch - 1) / per_batch;
  const int jg_n = sh.kh / 4, n_items = jg_n * (cb / 4);  // W S tiles: 4 levels x 4 cells
  const int jg = tid % jg_n, cg = tid / jg_n;             // this thread's (tid < n_items)
  const int cb_log2 = 31 - __clz(cb);
  const bool whole = kb >= K;  // all of W's columns staged once
  // W's columns k0 .. k0 + kb of the half's rows, transposed (rows past the
  // half's levels 0)
  auto stage_w = [&](int k0) {
    const int n = min(kb, K - k0) * sh.kh;
    for (int e = tid; e < n; e += kPassThreads) {
      const int k = e / sh.kh, j = e - k * sh.kh;
      wt[e] = j < nl ? a.w[(l0 + j) * K + k0 + k] : T(0);
    }
  };

  allow_next_grid();
  wait_previous_grid();
  if (nl <= 0) {  // a half with no levels (K <= 8)
    if (tid == 0) a.share[blockIdx.x] = 0.0;
    return;
  }
  if (whole) stage_w(0);
  for (int e = tid; e < (sh.kp + sh.kh) * sh.cbp; e += kPassThreads) st[e] = T(0);
  double dd = 0.0;
  for (int batch = 0; batch < n_batches; ++batch) {
    // the warp's tiles: offsets of their fragments in ht and st
    int ao[kPassTiles], bo[kPassTiles];
#pragma unroll
    for (int m = 0; m < kPassTiles; ++m) {
      const int t = min(batch * per_batch + m * kPassWarps + warp, n_tiles - 1);
      const int lt = t / kt_n, kt = t - lt * kt_n;
      ao[m] = (lt * 8 + (lane >> 2)) * sh.cbp + (lane & 3);
      bo[m] = (kt * 8 + (lane >> 2)) * sh.cbp + (lane & 3);
    }
    double d[kPassTiles][2];
#pragma unroll
    for (int m = 0; m < kPassTiles; ++m) d[m][0] = d[m][1] = 0.0;
    for (int c0 = begin; c0 < end; c0 += cb) {
      __syncthreads();
      // the sub-chunk, transposed (rows past K and past the half's levels
      // stay 0), a thread a cell of a row, eight loads in flight a thread
      const int n_s = cb * K, n_h = cb * nl;
      for (int e0 = tid; e0 < n_s + n_h; e0 += 8 * kPassThreads) {
        T v[8];
        int dst[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = e0 + i * kPassThreads;
          const int x = e < n_s ? e : e - n_s;
          const int c = x & (cb - 1), k = x >> cb_log2;
          dst[i] = e < n_s ? k * sh.cbp + c : e < n_s + n_h ? (sh.kp + k) * sh.cbp + c : -1;
          v[i] = T(0);
          if (dst[i] >= 0 && c0 + c < end)
            v[i] = e < n_s ? a.s[static_cast<size_t>(c0 + c) * K + k]
                           : a.h[static_cast<size_t>(c0 + c) * K + l0 + k];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (dst[i] >= 0) st[dst[i]] = v[i];
      }
      __syncthreads();
      // d(W): four cells a step, the warp's tiles in order
      for (int c4 = 0; c4 < cb; c4 += 4) {
#pragma unroll
        for (int m = 0; m < kPassTiles; ++m)
          if (batch * per_batch + m * kPassWarps + warp < n_tiles)
            mma_f64(d[m][0], d[m][1], static_cast<double>(ht[ao[m] + c4]),
                    static_cast<double>(st[bo[m] + c4]));
      }
      if (batch > 0) continue;
      // W S into dh: the K-term sums in T, in level order, across W's
      // column chunks
      T acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
      for (int k0 = 0; k0 < K; k0 += kb) {
        if (!whole) {
          __syncthreads();
          stage_w(k0);
          __syncthreads();
        }
        const int k1 = min(k0 + kb, K);
        if (tid < n_items)
          for (int k = k0; k < k1; ++k) {
            T sv[4], wv[4];
            load4(st + k * sh.cbp + 4 * cg, sv);
            load4(wt + (k - k0) * sh.kh + 4 * jg, wv);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] += wv[j] * sv[i];
          }
      }
      if (tid < n_items) {
        T old[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + 4 * cg + i, l = 4 * jg + j;
            old[i][j] = c < end && l < nl ? a.dh[static_cast<size_t>(c) * K + l0 + l] : T(0);
          }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + 4 * cg + i, l = 4 * jg + j;
            if (c < end && l < nl)
              a.dh[static_cast<size_t>(c) * K + l0 + l] = old[i][j] + a.dtdc * acc[i][j];
          }
      }
    }
    // the group's d(W) partial at the half's rows, and d(dt)'s terms
#pragma unroll
    for (int m = 0; m < kPassTiles; ++m) {
      const int t = batch * per_batch + m * kPassWarps + warp;
      if (t >= n_tiles) continue;
      const int lt = t / kt_n, kt = t - lt * kt_n;
      const int j = lt * 8 + (lane >> 2);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = kt * 8 + 2 * (lane & 3) + i;
        if (j >= nl || k >= K) continue;
        dd += static_cast<double>(a.w[(l0 + j) * K + k]) * d[m][i];
        double* o = a.acc + (static_cast<size_t>(group) * K + k) * K + l0 + j;
        *o = a.first ? a.s_dw * d[m][i] : *o + a.s_dw * d[m][i];
      }
    }
  }
  dd = warp_sum(dd);
  if (lane == 0) red[warp] = dd;
  __syncthreads();
  if (tid == 0) {
    double v = red[0];
    for (int w = 1; w < kPassWarps; ++w) v += red[w];
    a.share[blockIdx.x] = a.s_dd * v;
  }
}

// One launch of the pass over `groups` groups (kPassSplits blocks each)
// with `smem` bytes a block (after the previous kernel on the stream, which
// it may overlap until its wait_previous_grid); returns 0 or the CUDA error.
template <typename T>
int launch_strat_pass(const StratPassArgs<T>& a, int groups, size_t smem, int max_smem,
                      cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        strat_pass_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * kPassSplits);
  cfg.blockDim = dim3(kPassThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t le = cudaLaunchKernelEx(&cfg, strat_pass_kernel<T>, a);
  if (le == cudaSuccess) le = cudaGetLastError();
  return static_cast<int>(le);
}

// The pass's operands for one call: `groups` groups over `cells` cells,
// each a range of a multiple of cb cells; false where no sub-chunk fits.
template <typename T>
inline bool strat_pass_setup(StratPassArgs<T>* p, size_t* smem, int cells, int K, int groups,
                             int max_smem, const T* w, double* acc, double dt, double inv_dc) {
  int cb = 0, kb = 0;
  if (!strat_pass_fit(K, sizeof(T), max_smem, &cb, &kb) || groups < 1) return false;
  const int per = (cells + groups - 1) / groups;
  *p = StratPassArgs<T>{nullptr, nullptr, w, nullptr, acc, nullptr, T(dt) * T(inv_dc),
                        static_cast<double>(T(dt)) * static_cast<double>(T(inv_dc)),
                        static_cast<double>(T(inv_dc)), cells, K, (per + cb - 1) / cb * cb, cb,
                        kb, 1};
  *smem = strat_pass_smem_bytes(K, cb, kb, sizeof(T));
  return true;
}

}  // namespace lattice
