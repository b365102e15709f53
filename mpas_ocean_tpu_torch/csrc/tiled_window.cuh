// Shared pieces of the tiled window kernels (tiled_step.cu, tiled_adjoint.cu):
// Coriolis taps, division by a run-time divisor, async copies into shared
// memory, the cluster launch.
//
// A window is Wm x Wi lattice sites, flattened s = r * Wi + c. A block keeps
// its level chunk (kc levels, kr of them real) of 8 planes per state: h of
// parity 0 and 1, then u of channels 0..5, each plane [W][kc].

#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "lattice.cuh"

namespace lattice {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 8;  // blocks per cluster (the portable maximum)
constexpr int kThreads = 512;
constexpr int kSmallInts = 64;  // neighbour / incoming offsets and channel starts

// A Coriolis tap: the offset of its u value from the reading thread's
// (site, level), its f_edge's offset from the site, and its weight.
template <typename T>
struct alignas(16) Tap {
  int u, f;
  T w;
};

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

// A launch of n_tiles clusters of n_ranks blocks of kThreads threads.
inline cudaLaunchConfig_t cluster_config(int n_ranks, int n_tiles, size_t smem,
                                         cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * n_ranks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace lattice
