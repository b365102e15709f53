// Forward-Euler rollout of the linear TRiSK shallow-water core on the
// parity-plane hex lattice, for NVIDIA Hopper (sm_90a).
//
// Replaces: _rollout_kernel (mpas_ocean_tpu/structured/pallas_model.py:320),
// the arm with masks=None, nl=None, tr=None, strat_w=None, fb=False and
// forc=None. One launch is one step of _step_planes (:91-299); the exported
// entries loop n_steps launches on the caller's stream.
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
// another: mot_fe_steps_* alternates between the caller's output and one
// scratch set, mot_fe_stack_* writes each step into the next slot of a stack
// of states (the reverse sweep's rebuilt group).
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
// The stencil table's layout is in lattice.cuh.

#include "lattice.cuh"

namespace {

using namespace lattice;

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
int launch_step(const T* f_edge, const T* rts, const int* table, const T* weights,
                const T* ssh, const T* h, const T* u, T* ssh_out, T* h_out, T* u_out,
                double dt, double inv_dc, double s_div, int ny2, int nx, int k,
                cudaStream_t stream) {
  fe_step_kernel<T><<<2 * ny2 * nx, column_threads(k), 0, stream>>>(
      ssh, h, u, f_edge, rts, table, weights, ssh_out, h_out, u_out, T(dt), T(inv_dc),
      T(s_div), ny2, nx, k);
  return static_cast<int>(cudaGetLastError());
}

// n_steps steps from `in` into `out`. Step s writes `out` when
// n_steps - 1 - s is even and `tmp` otherwise, so the last step lands in
// `out`, no step writes the buffer it reads, and `in` is left as it is.
template <typename T>
int fe_steps(const T* f_edge, const T* rts, const int* table, const T* weights,
             const T* ssh_in, const T* h_in, const T* u_in, T* ssh_out, T* h_out, T* u_out,
             T* ssh_tmp, T* h_tmp, T* u_tmp, double dt, double inv_dc, double s_div, int ny2,
             int nx, int k, int n_steps, int n_terms, cudaStream_t stream) {
  if (!valid_shape(ny2, nx, k, n_steps, n_terms)) return cudaErrorInvalidValue;
  const T *ssh = ssh_in, *h = h_in, *u = u_in;
  for (int s = 0; s < n_steps; ++s) {
    const bool to_out = ((n_steps - 1 - s) & 1) == 0;
    T* ssh_d = to_out ? ssh_out : ssh_tmp;
    T* h_d = to_out ? h_out : h_tmp;
    T* u_d = to_out ? u_out : u_tmp;
    const int err = launch_step<T>(f_edge, rts, table, weights, ssh, h, u, ssh_d, h_d, u_d,
                                   dt, inv_dc, s_div, ny2, nx, k, stream);
    if (err != 0) return err;
    ssh = ssh_d, h = h_d, u = u_d;
  }
  return 0;
}

// n_steps steps through a stack of states: slot s + 1 = step(slot s).
template <typename T>
int fe_stack(const T* f_edge, const T* rts, const int* table, const T* weights, T* ssh,
             T* h, T* u, double dt, double inv_dc, double s_div, int ny2, int nx, int k,
             int n_steps, int n_terms, cudaStream_t stream) {
  if (!valid_shape(ny2, nx, k, n_steps, n_terms)) return cudaErrorInvalidValue;
  const size_t cells = 2ULL * ny2 * nx;
  const size_t hs = cells * k, us = 3 * cells * k;
  for (int s = 0; s < n_steps; ++s) {
    const int err = launch_step<T>(f_edge, rts, table, weights, ssh + s * cells, h + s * hs,
                                   u + s * us, ssh + (s + 1) * cells, h + (s + 1) * hs,
                                   u + (s + 1) * us, dt, inv_dc, s_div, ny2, nx, k, stream);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace

// Each entry returns 0 or the CUDA error of the first launch that failed.
#define MOT_FE_ENTRIES(T, SUFFIX)                                                          \
  extern "C" int mot_fe_steps_##SUFFIX(                                                    \
      const T* f_edge, const T* rts, const int* table, const T* weights, const T* ssh_in,  \
      const T* h_in, const T* u_in, T* ssh_out, T* h_out, T* u_out, T* ssh_tmp, T* h_tmp,  \
      T* u_tmp, double dt, double inv_dc, double s_div, int ny2, int nx, int k,            \
      int n_steps, int n_terms, void* stream) {                                            \
    return fe_steps<T>(f_edge, rts, table, weights, ssh_in, h_in, u_in, ssh_out, h_out,    \
                       u_out, ssh_tmp, h_tmp, u_tmp, dt, inv_dc, s_div, ny2, nx, k,        \
                       n_steps, n_terms, static_cast<cudaStream_t>(stream));               \
  }                                                                                        \
  extern "C" int mot_fe_stack_##SUFFIX(                                                    \
      const T* f_edge, const T* rts, const int* table, const T* weights, T* ssh, T* h,     \
      T* u, double dt, double inv_dc, double s_div, int ny2, int nx, int k, int n_steps,   \
      int n_terms, void* stream) {                                                         \
    return fe_stack<T>(f_edge, rts, table, weights, ssh, h, u, dt, inv_dc, s_div, ny2, nx, \
                       k, n_steps, n_terms, static_cast<cudaStream_t>(stream));            \
  }

MOT_FE_ENTRIES(float, f32)
MOT_FE_ENTRIES(double, f64)
