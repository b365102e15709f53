// Measured peaks of the card, the ceilings of the port's roofline, for
// NVIDIA Hopper (sm_90a).
//
// Replaces: measure_vpu_peak's kernel (bench.py:267, pallas_call :276), a
// streaming FMA o = o * a + x over an array S = (8, 1024, 128) f32 held in
// the TPU core's VMEM, T times, 2 |S| T FLOP; and the XLA loop of
// measure_hbm_bw (bench.py:293-310), b = b + 1 over a 256 MB f32 array, T
// passes, 2 n 4 T bytes. Every bound that chip_smoke.py prints divides by the
// rates these kernels measure, not by the data sheet's.
//
// fma_stream_kernel: each block copies its slice of o and x into shared
// memory (the counterpart of VMEM) and applies o = fma(o, a, x) to it T
// times, reading and writing shared memory at every step (a compiler
// barrier per step, so nothing stays in registers), then writes the slice
// back once. What bounds it is shared memory's bandwidth: 2 loads and a
// store per 2 FLOP, the regime of the lattice kernels' staged windows.
//
// fma_reg_kernel: each thread keeps kChains = 8 independent chains of the
// same recurrence in registers, so that the FMA pipes, not their latency or
// any memory, bound it: the card's FP32 (or FP64) FMA ceiling, the compute
// side of the roofline. `a` is a run-time argument, so no loop folds.
//
// stream_kernel: b = b + 1 by 16-byte loads and stores that bypass L1
// (ld.global.cg / st.global.cg, or the evict-first .cs), each thread over
// a fixed set of vectors (block-contiguous chunks or a grid stride),
// `passes` passes per launch. One pass per launch over a 256 MB array
// streams device memory; many passes per launch over an array the size of
// the 64x64x100 f32 state (6.6 MB, 13 MB moved per pass) stream L2, where a
// launch per pass would time the launches. tools/peaks.py's sweep_stream
// times the layouts, hints and grids; its HBM_LAYOUT and L2_LAYOUT are the
// fastest.
//
// The plain versions are the same recurrences in PyTorch
// (mpas_ocean_tpu_torch/tools/peaks.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kChains = 8;
constexpr int kUnroll = 4;  // vectors in flight per thread in stream_kernel

template <typename T>
__device__ __forceinline__ T fma_t(T x, T y, T z);
template <>
__device__ __forceinline__ float fma_t(float x, float y, float z) {
  return fmaf(x, y, z);
}
template <>
__device__ __forceinline__ double fma_t(double x, double y, double z) {
  return fma(x, y, z);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fma_stream_kernel(T* __restrict__ o, const T* __restrict__ x, long long n, int slice,
                      int steps, T a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* os = reinterpret_cast<T*>(smem_raw);
  T* xs = os + slice;
  const long long base = static_cast<long long>(blockIdx.x) * slice;
  const int len = static_cast<int>(min(static_cast<long long>(slice), n - base));
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    os[i] = o[base + i];
    xs[i] = x[base + i];
  }
  __syncthreads();
  // Each thread steps its own elements (no other thread reads them). The
  // compiler barrier makes every step load o and x from shared memory and
  // store o back, as the TPU kernel does VMEM, while the loads of one step
  // may still all be in flight at once.
  for (int t = 0; t < steps; ++t) {
    for (int i = threadIdx.x; i < len; i += blockDim.x) os[i] = fma_t<T>(os[i], a, xs[i]);
    asm volatile("" ::: "memory");
  }
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += blockDim.x) o[base + i] = os[i];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fma_reg_kernel(T* __restrict__ o, const T* __restrict__ x, long long n, int steps, T a) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kChains;
  if (i0 >= n) return;  // n is a multiple of kChains
  T r[kChains], xr[kChains];
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    r[c] = o[i0 + c];
    xr[c] = x[i0 + c];
  }
#pragma unroll 16
  for (int t = 0; t < steps; ++t) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) r[c] = fma_t<T>(r[c], a, xr[c]);
  }
#pragma unroll
  for (int c = 0; c < kChains; ++c) o[i0 + c] = r[c];
}

// kContiguous: each block streams chunks of kThreads * kUnroll contiguous
// vectors (thread t the vectors t, t + kThreads, ...), chunk c, c + grid,
// ...; else each thread streams the vectors i, i + stride, ... of a grid
// stride over the whole array, kUnroll in flight. kEvictFirst: loads and
// stores marked evict-first (ld.global.cs / st.global.cs) in place of
// L2-only (.cg). Each thread owns the same vectors in every pass, so the
// passes of one launch need no barrier.
template <bool kContiguous, bool kEvictFirst>
__global__ void __launch_bounds__(kThreads)
    stream_kernel(float4* __restrict__ b, long long n4, int passes) {
  const long long grid = static_cast<long long>(gridDim.x);
  const long long stride = kContiguous ? grid * kThreads * kUnroll : grid * kThreads;
  const long long i0 = kContiguous
                           ? static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x
                           : static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long step = kContiguous ? kThreads : stride;  // between a thread's vectors
  const long long sweep = kContiguous ? stride : kUnroll * stride;
  for (int p = 0; p < passes; ++p) {
    for (long long i = i0; i < n4; i += sweep) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (i + u * step < n4) v[u] = kEvictFirst ? __ldcs(b + i + u * step) : __ldcg(b + i + u * step);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i + u * step >= n4) continue;
        v[u].x += 1.0f, v[u].y += 1.0f, v[u].z += 1.0f, v[u].w += 1.0f;
        if (kEvictFirst)
          __stcs(b + i + u * step, v[u]);
        else
          __stcg(b + i + u * step, v[u]);
      }
    }
  }
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

// Shared memory of one fma_stream_kernel block: its slices of o and x.
template <typename T>
size_t stream_smem(int slice) {
  return 2 * sizeof(T) * static_cast<size_t>(slice);
}

template <typename T>
int fma_probe(T* o, const T* x, long long n, int steps, double a, int slice, int in_registers,
              cudaStream_t stream) {
  if (n <= 0 || steps < 0) return cudaErrorInvalidValue;
  if (in_registers) {
    if (n % kChains) return cudaErrorInvalidValue;
    const long long threads = n / kChains;
    const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    fma_reg_kernel<T><<<blocks, kThreads, 0, stream>>>(o, x, n, steps, static_cast<T>(a));
    return last_error();
  }
  if (slice <= 0) return cudaErrorInvalidValue;
  const size_t smem = stream_smem<T>(slice);
  const cudaError_t e = cudaFuncSetAttribute(
      fma_stream_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = static_cast<unsigned>((n + slice - 1) / slice);
  fma_stream_kernel<T><<<blocks, kThreads, smem, stream>>>(o, x, n, slice, steps,
                                                           static_cast<T>(a));
  return last_error();
}

}  // namespace

// o = fma(o, a, x), `steps` times, over n values: in shared memory, `slice`
// values of o and of x per block (in_registers = 0), or in registers,
// kChains chains per thread (in_registers = 1, n a multiple of kChains).
// One launch; returns 0 or the CUDA error of the launch.
extern "C" int mot_fma_probe_f32(float* o, const float* x, long long n, int steps, double a,
                                 int slice, int in_registers, void* stream) {
  return fma_probe<float>(o, x, n, steps, a, slice, in_registers,
                          static_cast<cudaStream_t>(stream));
}
extern "C" int mot_fma_probe_f64(double* o, const double* x, long long n, int steps, double a,
                                 int slice, int in_registers, void* stream) {
  return fma_probe<double>(o, x, n, steps, a, slice, in_registers,
                           static_cast<cudaStream_t>(stream));
}

// b = b + 1, `passes` passes over n float values (n a multiple of 4, b
// 16-byte aligned) in one launch of `blocks` blocks, in the layout
// `contiguous` (1) or grid-strided (0), with evict-first hints
// (`evict_first` 1) or L2-only ones (0); returns 0 or the CUDA error of the
// launch.
extern "C" int mot_stream_probe(float* b, long long n, int passes, int blocks, int contiguous,
                                int evict_first, void* stream) {
  if (n <= 0 || n % 4 || passes < 0 || blocks < 1 ||
      reinterpret_cast<unsigned long long>(b) % 16)
    return cudaErrorInvalidValue;
  auto* b4 = reinterpret_cast<float4*>(b);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (contiguous && evict_first)
    stream_kernel<true, true><<<blocks, kThreads, 0, s>>>(b4, n / 4, passes);
  else if (contiguous)
    stream_kernel<true, false><<<blocks, kThreads, 0, s>>>(b4, n / 4, passes);
  else if (evict_first)
    stream_kernel<false, true><<<blocks, kThreads, 0, s>>>(b4, n / 4, passes);
  else
    stream_kernel<false, false><<<blocks, kThreads, 0, s>>>(b4, n / 4, passes);
  return last_error();
}

// The SMs of the current device (the stream probe's grid is a multiple).
extern "C" int mot_sm_count(int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(e);
}
