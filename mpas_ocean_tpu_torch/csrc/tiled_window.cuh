// Shared pieces of the window kernels (every kernel, through step_window.cuh):
// the cluster's size, division by a run-time divisor, async copies into
// shared memory, the device's shared-memory limit.

#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "lattice.cuh"

namespace lattice {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;  // blocks per cluster (the portable maximum)

// Division of 0 <= n < 2^31 by a divisor fixed at run time, by a multiply
// and a shift (the round-up method CUTLASS's FastDivmod uses): the index
// arithmetic of every loop below would otherwise spend more instructions in
// integer division than in the stencil.
struct FastDiv {
  int d;
  unsigned mul, shr;
  __device__ explicit FastDiv(int d_) : d(d_), mul(0), shr(0) {
    if (d != 1) {
      const int log2_up = (31 - __clz(d)) + ((d & (d - 1)) != 0);
      const unsigned p = 31 + log2_up;
      mul = static_cast<unsigned>(((1ull << p) + static_cast<unsigned>(d) - 1) /
                                  static_cast<unsigned>(d));
      shr = p - 32;
    }
  }
  __device__ __forceinline__ int div(int n) const {
    return d != 1 ? static_cast<int>(__umulhi(static_cast<unsigned>(n), mul) >> shr) : n;
  }
  __device__ __forceinline__ int mod(int n, int quo) const { return n - quo * d; }
};

// async copy of one value from device memory into shared memory
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  __pipeline_memcpy_async(dst, src, sizeof(T));
}

// The device's opt-in limit of dynamic shared memory per block.
inline int opt_in_smem(int* max_smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(e);
}

}  // namespace lattice
