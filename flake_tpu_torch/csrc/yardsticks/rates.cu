// The card's own rates for the operations the sweeps and the
// autocorrelation are built from, measured rather than read off a data
// sheet: the 32x32 -> 64-bit integer multiply-add (mad.wide.s32, one per
// tap in K2 and in K4's integer form), the 32-bit integer multiply-add,
// and the float64 FMA (one per sample and lag in K1, one per tap in K4).
// Every thread runs eight independent chains of `iters` x 16 operations,
// so neither latency nor memory limits the count. Each operation takes
// its chain's own last result as an operand that it multiplies, so the
// compiler cannot lift a product out of the loop (with loop-invariant
// factors it does, and the loop then times 64-bit adds). Beside them, an
// empty kernel: the fixed cost of a launch, timed back to back like the
// short kernels it stands beside (the zero floor); and the latencies of
// the operations on the dependent chain of the LPC stage, L, each from one
// warp's chain of them: a float64 and a float32 add, a correctly rounded
// division (__ddiv_rn, __fdiv_rn: a sequence with a slow path, not one
// instruction), a truncation followed by an add (the quantizer's step; the
// add's own latency is taken off by the reader) and a float64 shuffle
// round trip (__shfl_xor_sync, two 32-bit shuffles), which L's chain bound
// does not count but its first design paid. No path of the package calls
// these; chip_smoke.py times them beside the kernels.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long mad_wide(int a, int b, long long acc) {
  long long d;
  asm volatile("mad.wide.s32 %0, %1, %2, %3;"
               : "=l"(d) : "r"(a), "r"(b), "l"(acc));
  return d;
}

__global__ void mad_wide_kernel(long long* out, int iters, int seed) {
  long long a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = seed + 3 * k + threadIdx.x;
  const int c = seed ^ blockIdx.x;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        a[k] = mad_wide(c, static_cast<int>(a[k]), a[k]);
  }
  long long s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += a[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void imad_kernel(int* out, int iters, int seed) {
  int a[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) a[k] = seed + 3 * k + threadIdx.x;
  const int c = seed ^ blockIdx.x;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u)
#pragma unroll
      for (int k = 0; k < 8; ++k) a[k] = a[k] * c + a[k];
  }
  int s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += a[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void dfma_kernel(double* out, int iters, double seed) {
  double a[8], b[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    a[k] = threadIdx.x + k;
    b[k] = seed + 0.125 * k;
  }
  const double c = 1.0 - 1e-9 * blockIdx.x;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u)
#pragma unroll
      for (int k = 0; k < 8; ++k) a[k] = fma(a[k], c, b[k]);
  }
  double s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += a[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void empty_kernel() {}

__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double trunc_of(double a) { return ::trunc(a); }
__device__ __forceinline__ float trunc_of(float a) { return truncf(a); }

// one chain of iters x 16 dependent adds a thread
template <typename T>
__global__ void add_chain_kernel(T* out, int iters, T c) {
  T a = static_cast<T>(threadIdx.x);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u) a = add_rn(a, c);
  }
  out[threadIdx.x] = a;
}

// one chain of iters x 16 dependent divisions a thread, c / a: the values
// alternate between a and c / a and stay normal (no slow path)
template <typename T>
__global__ void div_chain_kernel(T* out, int iters, T c) {
  T a = static_cast<T>(1.25) + static_cast<T>(threadIdx.x) / 1024;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u) a = div_rn(c, a);
  }
  out[threadIdx.x] = a;
}

// one chain of iters x 16 dependent (truncation, add) pairs a thread
template <typename T>
__global__ void trunc_chain_kernel(T* out, int iters, T c) {
  T a = static_cast<T>(threadIdx.x);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u) a = add_rn(trunc_of(a), c);
  }
  out[threadIdx.x] = a;
}

// one chain of iters x 16 dependent float64 shuffles a lane
__global__ void shfl_chain_kernel(double* out, int iters) {
  double a = threadIdx.x;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < 16; ++u) a = __shfl_xor_sync(0xffffffffu, a, 1);
  }
  out[threadIdx.x] = a;
}

}  // namespace

// blocks x threads threads, each 8 * 16 * iters operations; out has one
// element a thread
extern "C" int flake_rate_mad_wide(long long* out, int blocks, int threads,
                                   int iters, cudaStream_t stream) {
  mad_wide_kernel<<<blocks, threads, 0, stream>>>(out, iters, 7);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flake_rate_imad(int* out, int blocks, int threads, int iters,
                               cudaStream_t stream) {
  imad_kernel<<<blocks, threads, 0, stream>>>(out, iters, 7);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flake_rate_dfma(double* out, int blocks, int threads,
                               int iters, cudaStream_t stream) {
  dfma_kernel<<<blocks, threads, 0, stream>>>(out, iters, 0.5);
  return static_cast<int>(cudaGetLastError());
}

// an empty kernel of blocks x threads threads
extern "C" int flake_launch_floor(int blocks, int threads,
                                  cudaStream_t stream) {
  empty_kernel<<<blocks, threads, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}

// one warp, each lane a chain of 16 x iters dependent float64 (float32)
// adds; out has 32 elements
extern "C" int flake_latency_dadd(double* out, int iters,
                                  cudaStream_t stream) {
  add_chain_kernel<double><<<1, 32, 0, stream>>>(out, iters, 1e-9);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flake_latency_fadd(float* out, int iters,
                                  cudaStream_t stream) {
  add_chain_kernel<float><<<1, 32, 0, stream>>>(out, iters, 1e-3f);
  return static_cast<int>(cudaGetLastError());
}

// one warp, each lane a chain of 16 x iters dependent float64 (float32)
// divisions; out has 32 elements
extern "C" int flake_latency_ddiv(double* out, int iters,
                                  cudaStream_t stream) {
  div_chain_kernel<double><<<1, 32, 0, stream>>>(out, iters, 1.7);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flake_latency_fdiv(float* out, int iters,
                                  cudaStream_t stream) {
  div_chain_kernel<float><<<1, 32, 0, stream>>>(out, iters, 1.7f);
  return static_cast<int>(cudaGetLastError());
}

// one warp, each lane a chain of 16 x iters dependent float64 (float32)
// truncations, each followed by an add; out has 32 elements
extern "C" int flake_latency_dtrunc(double* out, int iters,
                                    cudaStream_t stream) {
  trunc_chain_kernel<double><<<1, 32, 0, stream>>>(out, iters, 0.75);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flake_latency_ftrunc(float* out, int iters,
                                    cudaStream_t stream) {
  trunc_chain_kernel<float><<<1, 32, 0, stream>>>(out, iters, 0.75f);
  return static_cast<int>(cudaGetLastError());
}

// one warp, each lane a chain of 16 x iters dependent float64 shuffles;
// out has 32 elements
extern "C" int flake_latency_shfl(double* out, int iters,
                                  cudaStream_t stream) {
  shfl_chain_kernel<<<1, 32, 0, stream>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
