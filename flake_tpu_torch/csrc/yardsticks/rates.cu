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
// short kernels it stands beside (the zero floor). No path of the package
// calls these; chip_smoke.py times them beside the kernels.

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
