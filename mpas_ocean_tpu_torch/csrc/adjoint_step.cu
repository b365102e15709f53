// Reverse (adjoint) of one forward-Euler step of the linear TRiSK
// shallow-water core on the parity-plane hex lattice, for NVIDIA Hopper
// (sm_90a).
//
// Replaces: _adjoint_segment_kernel
// (mpas_ocean_tpu/structured/pallas_model.py:1480), the arm with masks=None,
// nl_terms=None, n_tracers=0, stratified=False and forced=False. The TPU
// kernel recomputes a b-step segment in VMEM and runs an in-kernel jax.vjp of
// _step_planes per step. CUDA has no vjp, so the transpose is written out by
// hand here, and the recompute is the forward kernel's (fe_step.cu) filling
// a stack of states in device memory. One launch maps (primal state at step
// j, cotangent at step j + 1) to the cotangent at step j.
//
// Layout and block shape as in fe_step.cu: one block per cell column
// (p, m, i), threads over the levels k, 32-bit offsets, the stencil tables
// resolved into shared memory. For output cotangents (gs, gh, gu):
//   G        = gh + gs                       (ssh' = sum_k h' - rts)
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
// Two sums cross the level axis: S_e for the cell's 6 edges (the 3 incoming
// ones are other blocks' columns, read here, never waited on) and the block's
// share of d(dt). Both are block reductions in a fixed order. The d(dt)
// shares go to a scratch row per step, and one more small kernel sums all
// rows of a call in a fixed order into a float64 accumulator: no atomics, so
// an f64 run repeats bit for bit.
//
// What bounds it on this card: about 3 state passes per step (read the
// primal h and u, read the cotangent, write the new one), 19.7 MB at
// 64x64x100 in f32, 5.9 us at 3.35 TB/s. Like fe_step.cu it does ~45 loads
// per cell-level that the neighbouring blocks repeat (7 of G, 4 of h, 6 of u,
// 6 edge columns of gu and 24 transposed Coriolis taps), so load latency,
// not bandwidth, is expected to bound it. Making it fast is later work.

#include "lattice.cuh"

namespace {

using namespace lattice;

template <typename T>
__global__ void adjoint_step_kernel(const T* __restrict__ ssh, const T* __restrict__ h,
                                    const T* __restrict__ u, const T* __restrict__ f_edge,
                                    const int* __restrict__ table,
                                    const T* __restrict__ weights, const T* __restrict__ gs,
                                    const T* __restrict__ gh, const T* __restrict__ gu,
                                    T* __restrict__ ds, T* __restrict__ dh,
                                    T* __restrict__ du, T* __restrict__ ddt_part, T dt,
                                    T inv_dc, T s_div, int ny2, int nx, int K) {
  __shared__ int s_tab[kHeader];
  __shared__ int s_src[kMaxTerms];  // channel * plane + site of each transposed tap
  __shared__ T s_w[kMaxTerms];
  __shared__ T s_part[7][32];  // per warp: S_e of the 6 edges, then d(dt)

  const int plane = ny2 * nx;
  const int site = blockIdx.x;  // p * plane + m * nx + i
  const int p = site / plane;
  const int m = (site / nx) % ny2;
  const int i = site % nx;
  const int cell = m * nx + i;

  auto at = [&](int dm, int di) { return wrap(m + dm, ny2) * nx + wrap(i + di, nx); };

  const int n_terms = table[0];
  for (int t = threadIdx.x; t < kHeader; t += blockDim.x) s_tab[t] = table[t];
  for (int t = threadIdx.x; t < n_terms; t += blockDim.x) {
    const int* tt = table + kHeader + 3 * t;
    s_src[t] = tt[0] * plane + at(tt[1], tt[2]);
    s_w[t] = weights[t];
  }
  __syncthreads();

  // owned edges: the edge itself, the neighbour across it, its G and grad(ssh)
  const T gs_c = gs[site];
  const T ssh_c = ssh[site];
  int own[3], nbr[3];
  T gs_nbr[3], grad[3], f_own[3];
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const int* t = s_tab + kNbr + 3 * (f * 2 + p);
    nbr[f] = t[0] * plane + at(t[1], t[2]);
    own[f] = (f * 2 + p) * plane + cell;
    gs_nbr[f] = gs[nbr[f]];
    grad[f] = (ssh[nbr[f]] - ssh_c) * inv_dc;
    f_own[f] = f_edge[own[f]];
  }
  // incoming edges: the edge (channel, site) and its owner cell
  int inc_u[3], inc_own[3];
  T gs_inc[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int* t = s_tab + kInc + 9 * p + 3 * j;
    const int ch = t[0];
    const int s = at(t[1], t[2]);
    inc_u[j] = ch * plane + s;
    inc_own[j] = (ch & 1) * plane + s;
    gs_inc[j] = gs[inc_own[j]];
  }

  const T dt_div = dt * s_div;
  const T grav = T(kGravity);
  const int self_col = site * K;
  T S[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  T part = T(0);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const T hc = h[self_col + k];
    const T Gc = gh[self_col + k] + gs_c;
    T flux = T(0);  // sum over the cell's 6 edges of u * d(flux)
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const int c = f * 2 + p;
      const int e = own[f] * K + k;
      const T ue = u[e];
      const T gue = gu[e];
      const T dG = gh[nbr[f] * K + k] + gs_nbr[f] - Gc;
      const T gflux = dt_div * dG;
      const T he = T(0.5) * (h[nbr[f] * K + k] + hc);
      const int t0 = s_tab[kOff + c], t1 = s_tab[kOff + c + 1];
      T ct = T(0);
      for (int t = t0; t < t1; ++t) ct += s_w[t] * gu[s_src[t] * K + k];
      const T fct = f_own[f] * ct;
      du[e] = gue + he * gflux + dt * fct;
      flux += ue * gflux;
      S[f] += gue;
      part += ue * (s_div * dG * he + fct) - grav * grad[f] * gue;
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int e = inc_u[j] * K + k;
      const T dG = Gc - (gh[inc_own[j] * K + k] + gs_inc[j]);
      flux += u[e] * (dt_div * dG);
      S[3 + j] += gu[e];
    }
    dh[self_col + k] = Gc + T(0.5) * flux;
  }

  // column sums: warp shuffles, then one thread over the warps in order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const T v = warp_sum(S[q]);
    if (lane == 0) s_part[q][warp] = v;
  }
  {
    const T v = warp_sum(part);
    if (lane == 0) s_part[6][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int n_warps = (blockDim.x + 31) / 32;
    T tot[7];
    for (int q = 0; q < 7; ++q) {
      tot[q] = s_part[q][0];
      for (int w = 1; w < n_warps; ++w) tot[q] += s_part[q][w];
    }
    ds[site] = (grav * dt * inv_dc) * ((tot[0] + tot[1] + tot[2]) - (tot[3] + tot[4] + tot[5]));
    ddt_part[site] = tot[6];
  }
}

// n_steps reverse steps. The primal state of step j lies in slot j of the
// stacks (ssh (n, 2, ny2, nx), h (n, 2, ny2, nx, K), u (n, 6, ny2, nx, K));
// the cotangent at step n_steps comes in `g_in` and the one at step 0 goes
// out in `g_out`, through `g_tmp` as in fe_step.cu's fe_steps; `g_in` is left
// as it is. `part` holds n_steps * 2 * ny2 * nx scratch values; d(dt) of the
// n_steps steps is added to ddt[0].
template <typename T>
int adjoint_rollout(const T* f_edge, const int* table, const T* weights, const T* ssh_st,
                    const T* h_st, const T* u_st, const T* gs_in, const T* gh_in,
                    const T* gu_in, T* gs_out, T* gh_out, T* gu_out, T* gs_tmp, T* gh_tmp,
                    T* gu_tmp, T* part, double* ddt, double dt, double inv_dc, double s_div,
                    int ny2, int nx, int k, int n_steps, int n_terms, cudaStream_t stream) {
  if (!valid_shape(ny2, nx, k, n_steps, n_terms)) return cudaErrorInvalidValue;
  const size_t cells = 2ULL * ny2 * nx;
  const size_t hs = cells * k, us = 3 * cells * k;
  const T *gs = gs_in, *gh = gh_in, *gu = gu_in;
  for (int s = 0; s < n_steps; ++s) {
    const size_t j = n_steps - 1 - s;
    const bool to_out = ((n_steps - 1 - s) & 1) == 0;
    T* ds = to_out ? gs_out : gs_tmp;
    T* dh = to_out ? gh_out : gh_tmp;
    T* du = to_out ? gu_out : gu_tmp;
    adjoint_step_kernel<T><<<static_cast<int>(cells), column_threads(k), 0, stream>>>(
        ssh_st + j * cells, h_st + j * hs, u_st + j * us, f_edge, table, weights, gs, gh, gu,
        ds, dh, du, part + s * cells, T(dt), T(inv_dc), T(s_div), ny2, nx, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    gs = ds, gh = dh, gu = du;
  }
  if (n_steps == 0) return 0;
  return reduce_ddt(part, static_cast<long long>(n_steps) * static_cast<long long>(cells), ddt,
                    stream);
}

}  // namespace

// Returns 0 or the CUDA error of the first launch that failed.
#define MOT_ADJOINT_ENTRY(T, SUFFIX)                                                        \
  extern "C" int mot_adjoint_rollout_##SUFFIX(                                              \
      const T* f_edge, const int* table, const T* weights, const T* ssh_st, const T* h_st,  \
      const T* u_st, const T* gs_in, const T* gh_in, const T* gu_in, T* gs_out, T* gh_out,  \
      T* gu_out, T* gs_tmp, T* gh_tmp, T* gu_tmp, T* part, double* ddt, double dt,          \
      double inv_dc, double s_div, int ny2, int nx, int k, int n_steps, int n_terms,        \
      void* stream) {                                                                       \
    return adjoint_rollout<T>(f_edge, table, weights, ssh_st, h_st, u_st, gs_in, gh_in,     \
                              gu_in, gs_out, gh_out, gu_out, gs_tmp, gh_tmp, gu_tmp, part,  \
                              ddt, dt, inv_dc, s_div, ny2, nx, k, n_steps, n_terms,         \
                              static_cast<cudaStream_t>(stream));                           \
  }

MOT_ADJOINT_ENTRY(float, f32)
MOT_ADJOINT_ENTRY(double, f64)
