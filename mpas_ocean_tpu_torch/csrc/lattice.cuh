// Shared pieces of the parity-plane lattice kernels (fe_step.cu,
// adjoint_step.cu, tiled_step.cu, tiled_adjoint.cu): the stencil table's
// layout, periodic wrap, warp sums, the fixed-order d(dt) sum.
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

#pragma once

#include <cuda_runtime.h>

namespace lattice {

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

// Arguments every entry checks before it launches.
inline bool valid_shape(int ny2, int nx, int k, int n_steps, int n_terms) {
  if (ny2 <= 0 || nx <= 0 || k <= 0 || n_steps < 0) return false;
  if (n_terms < 0 || n_terms > kMaxTerms) return false;
  // offsets are 32-bit (half the registers of 64-bit address arithmetic)
  return 6LL * ny2 * nx * k <= kMaxIndex;
}

constexpr int kReduceThreads = 1024;

// acc[0] += the sum of part[0 .. n), in a fixed order (one block). Static:
// each source that includes this header keeps its own copy of the kernel.
template <typename T>
static __global__ void ddt_reduce_kernel(const T* __restrict__ part, long long n,
                                         double* __restrict__ acc) {
  __shared__ double s[kReduceThreads];
  double v = 0.0;
  for (long long idx = threadIdx.x; idx < n; idx += blockDim.x) v += static_cast<double>(part[idx]);
  s[threadIdx.x] = v;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) acc[0] += s[0];
}

// Launches ddt_reduce_kernel; returns 0 or the CUDA error of the launch.
template <typename T>
static int reduce_ddt(const T* part, long long n, double* acc, cudaStream_t stream) {
  ddt_reduce_kernel<T><<<1, kReduceThreads, 0, stream>>>(part, n, acc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lattice
