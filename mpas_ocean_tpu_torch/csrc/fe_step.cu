// Forward-Euler rollout of the linear TRiSK shallow-water core on the
// parity-plane hex lattice, for NVIDIA Hopper (sm_90a).
//
// Replaces: _rollout_kernel (mpas_ocean_tpu/structured/pallas_model.py:320),
// the arm with masks=None, nl=None, tr=None, strat_w=None, fb=False and
// forc=None. One launch is one step of _step_planes (:91-299); the exported
// entry loops n_steps launches on the caller's stream.
//
// Layout (all contiguous, K innermost):
//   ssh (2, ny2, nx)   h (2, ny2, nx, K)   u (6, ny2, nx, K), channel f*2+p
//   f_edge (6, ny2, nx)   rts (2, ny2, nx)
// Block = one cell column (p, m, i); its threads stride over the levels k,
// so every load of a neighbour column is contiguous. Each block writes its
// column of h, its three owned edges of u and its ssh value. Offsets are
// 32-bit, so u may hold at most 2^31 - 1 values: 64-bit address arithmetic
// doubled the registers (128 against 72) and cost 22-34% of the step time on
// an H100.
//
// No in-place update: the TPU kernel rewrites its VMEM state in place, which
// is safe there only because each step reads whole planes first. Blocks here
// run in parallel and in no order, so a step reads one buffer set and writes
// the other, and the entry ping-pongs between the two.
//
// What bounds it on this card: the compulsory traffic is about 2 state passes
// per step (read h and u, write h and u), 13 MB at 64x64x100 in f32, which
// fits the 50 MB L2, so launch latency could rival the work. Measured on an
// H100 (700 W), it does not: the time per cell-level is the same at
// 64x64x100 and at 256x256x100 (state beyond L2), about 10% of the HBM rate
// for the compulsory bytes. What bounds it is the latency of ~40 L1/L2 loads
// per cell-level (10 of h, 6 of u for the fluxes, 24 Coriolis taps), none of
// them shared with the neighbouring columns' blocks. Staging halo tiles in
// shared memory, capturing the step loop in a graph or a persistent kernel,
// and temporal blocking over q steps are later work.
//
// Stencil table (int32, built by kernels/fe_step.py:pack_stencil):
//   [0]                 n_terms
//   [1 .. 18]           neighbour across each owned edge, per channel c:
//                       (plane_in, dm, di)
//   [19 .. 36]          incoming-edge taps of the divergence, per plane p,
//                       3 taps: (channel_in, dm, di)
//   [37 .. 43]          first term of each output channel (7 offsets)
//   [44 ..]             Coriolis terms grouped by output channel:
//                       (channel_in, dm, di); weights alongside, in T.
// A tap (dm, di) reads (m + dm, i + di), periodic.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTerms = 128;
constexpr int kHeader = 44;
constexpr int kNbr = 1;
constexpr int kInc = 19;
constexpr int kOff = 37;
constexpr double kGravity = 9.80616;
constexpr long long kMaxIndex = 2147483647LL;  // largest u offset + 1 that fits int

__device__ __forceinline__ int wrap(int x, int n) {
  x %= n;
  return x < 0 ? x + n : x;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void fe_step_kernel(const T* __restrict__ ssh, const T* __restrict__ h,
                               const T* __restrict__ u, const T* __restrict__ f_edge,
                               const T* __restrict__ rts, const int* __restrict__ table,
                               const T* __restrict__ weights, T* __restrict__ ssh_out,
                               T* __restrict__ h_out, T* __restrict__ u_out, T dt,
                               T inv_dc, T s_div, int ny2, int nx, int K) {
  __shared__ int s_tab[kHeader];
  __shared__ int s_src[kMaxTerms];  // channel * plane + site of each Coriolis tap
  __shared__ T s_w[kMaxTerms];
  __shared__ T s_f[kMaxTerms];  // f_edge at that tap
  __shared__ T s_part[32];

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
    const int src = tt[0] * plane + at(tt[1], tt[2]);
    s_src[t] = src;
    s_f[t] = f_edge[src];
    s_w[t] = weights[t];
  }
  __syncthreads();

  // the cell's neighbour across each owned edge: plane * plane + (m', i')
  int nbr[3];
  for (int f = 0; f < 3; ++f) {
    const int* t = s_tab + kNbr + 3 * (f * 2 + p);
    nbr[f] = t[0] * plane + at(t[1], t[2]);
  }
  // incoming edges: channel, site, and that edge's own neighbour cell
  int inc_u[3], inc_self[3], inc_nbr[3];
  for (int j = 0; j < 3; ++j) {
    const int* t = s_tab + kInc + 9 * p + 3 * j;
    const int ch = t[0];
    const int s = at(t[1], t[2]);
    const int p_in = ch & 1;
    const int* tn = s_tab + kNbr + 3 * ch;
    const int ms = s / nx, is = s % nx;
    inc_u[j] = ch * plane + s;
    inc_self[j] = p_in * plane + s;
    inc_nbr[j] = tn[0] * plane + wrap(ms + tn[1], ny2) * nx + wrap(is + tn[2], nx);
  }
  // FE: the pressure gradient reads the old ssh
  const T ssh_c = ssh[site];
  T grad[3];
  for (int f = 0; f < 3; ++f) grad[f] = (ssh[nbr[f]] - ssh_c) * inv_dc;

  const T dt_div = dt * s_div;
  const T pg_scale = T(-kGravity) * dt;
  const int Kz = K;
  const int self_col = site * Kz;

  T col = T(0);
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const T hc = h[self_col + k];
    // thickness flux u * 0.5 (h_nbr + h_self): owned edges out, incoming in
    T total = T(0);
    for (int f = 0; f < 3; ++f) {
      const T he = T(0.5) * (h[nbr[f] * Kz + k] + hc);
      const T fl = u[((f * 2 + p) * plane + cell) * Kz + k] * he;
      total = (f == 0) ? fl : total + fl;
    }
    for (int j = 0; j < 3; ++j) {
      const T he = T(0.5) * (h[inc_nbr[j] * Kz + k] + h[inc_self[j] * Kz + k]);
      total = total - u[inc_u[j] * Kz + k] * he;
    }
    const T hn = hc - dt_div * total;
    h_out[self_col + k] = hn;
    col += hn;

    // u' = u + dt * (TRiSK Coriolis of u * f) + pg_scale * grad(ssh)
    for (int f = 0; f < 3; ++f) {
      const int c = f * 2 + p;
      const int t0 = s_tab[kOff + c], t1 = s_tab[kOff + c + 1];
      T acc = T(0);
      for (int t = t0; t < t1; ++t) {
        const T contrib = s_w[t] * (u[s_src[t] * Kz + k] * s_f[t]);
        acc = (t == t0) ? contrib : acc + contrib;
      }
      const int dst = (c * plane + cell) * Kz + k;
      u_out[dst] = u[dst] + dt * acc + pg_scale * grad[f];
    }
  }

  // ssh' = sum_k h' - rts: block reduction over the column
  col = warp_sum(col);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) s_part[warp] = col;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = s_part[0];
    for (int w = 1; w < (blockDim.x + 31) / 32; ++w) s += s_part[w];
    ssh_out[site] = s - rts[site];
  }
}

template <typename T>
int fe_rollout(const T* f_edge, const T* rts, const int* table, const T* weights,
               T* ssh0, T* h0, T* u0, T* ssh1, T* h1, T* u1, double dt, double inv_dc,
               double s_div, int ny2, int nx, int k, int n_steps, int n_terms,
               cudaStream_t stream) {
  if (ny2 <= 0 || nx <= 0 || k <= 0 || n_steps < 0) return cudaErrorInvalidValue;
  if (n_terms < 0 || n_terms > kMaxTerms) return cudaErrorInvalidValue;
  // offsets are 32-bit (half the registers of 64-bit address arithmetic)
  if (6LL * ny2 * nx * k > kMaxIndex) return cudaErrorInvalidValue;
  const int threads = k >= 256 ? 256 : ((k + 31) / 32) * 32;
  const int blocks = 2 * ny2 * nx;
  T* ssh[2] = {ssh0, ssh1};
  T* h[2] = {h0, h1};
  T* u[2] = {u0, u1};
  for (int s = 0; s < n_steps; ++s) {
    const int a = s & 1, b = a ^ 1;
    fe_step_kernel<T><<<blocks, threads, 0, stream>>>(
        ssh[a], h[a], u[a], f_edge, rts, table, weights, ssh[b], h[b], u[b], T(dt),
        T(inv_dc), T(s_div), ny2, nx, k);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Runs n_steps forward-Euler steps. Buffer set 0 holds the initial state;
// after the call the result is in set (n_steps % 2). Returns 0 or the CUDA
// error of the first launch that failed.
extern "C" int mot_fe_rollout_f32(const float* f_edge, const float* rts, const int* table,
                                  const float* weights, float* ssh0, float* h0, float* u0,
                                  float* ssh1, float* h1, float* u1, double dt,
                                  double inv_dc, double s_div, int ny2, int nx, int k,
                                  int n_steps, int n_terms, void* stream) {
  return fe_rollout<float>(f_edge, rts, table, weights, ssh0, h0, u0, ssh1, h1, u1, dt,
                           inv_dc, s_div, ny2, nx, k, n_steps, n_terms,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int mot_fe_rollout_f64(const double* f_edge, const double* rts, const int* table,
                                  const double* weights, double* ssh0, double* h0,
                                  double* u0, double* ssh1, double* h1, double* u1,
                                  double dt, double inv_dc, double s_div, int ny2, int nx,
                                  int k, int n_steps, int n_terms, void* stream) {
  return fe_rollout<double>(f_edge, rts, table, weights, ssh0, h0, u0, ssh1, h1, u1, dt,
                            inv_dc, s_div, ny2, nx, k, n_steps, n_terms,
                            static_cast<cudaStream_t>(stream));
}
