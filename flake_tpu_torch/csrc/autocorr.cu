// K1: Welch-windowed autocorrelation, lags 0..max_order, float64.
//
// Replaces the TPU kernel flake_tpu/ops/pallas_autocorr.py:
// autocorr_dd_pallas (_autocorr_kernel). The TPU has no native float64,
// so that kernel carried double-float f32 pairs with TwoProd/TwoSum.
// Hopper has native FP64 (34 TFLOP/s outside the tensor cores on an
// H100 SXM at 700 W, NVIDIA's data sheet), so d = x*w
// is formed in float64 and every lag is a plain FMA accumulation.
//
// What bounds it on the card: per stream of B samples the kernel reads
// 4*B bytes of samples and 8*B of window and does B*(max_order+1) FMAs,
// about 13 FMAs per 12 bytes at level 8, so it sits near the memory
// roofline with FP64 to spare. Design: one block per stream walks B in
// shared-memory chunks with a max_order halo (any B up to 65535 works);
// each thread accumulates every lag over a fixed set of samples, then a
// fixed-shape tree (warp shuffles, then the eight warp sums in order)
// reduces them. There are no float atomics, so the result does not
// depend on scheduling. The +2.0 bias per lag (lpc.c:57-67) is added
// here, matching flake_tpu_torch.ops.lpc.autocorr.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;   // samples per shared-memory chunk
constexpr int kMaxLags = 33;   // max_order <= 32

__global__ void __launch_bounds__(kThreads)
autocorr_kernel(const int* __restrict__ x, const double* __restrict__ w,
                double* __restrict__ out, int B, int lags) {
  __shared__ double d[kChunk + kMaxLags];
  __shared__ double warp_sum[kThreads / 32][kMaxLags];
  const int* xs = x + static_cast<size_t>(blockIdx.x) * B;

  double acc[kMaxLags];
#pragma unroll
  for (int l = 0; l < kMaxLags; ++l) acc[l] = 0.0;

  for (int c0 = 0; c0 < B; c0 += kChunk) {
    // d[c0 .. c0 + kChunk + lags - 1), zero past the end of the stream
    for (int i = threadIdx.x; i < kChunk + lags - 1; i += kThreads) {
      const int g = c0 + i;
      d[i] = g < B ? static_cast<double>(xs[g]) * w[g] : 0.0;
    }
    __syncthreads();
    const int cn = min(kChunk, B - c0);
    for (int i = threadIdx.x; i < cn; i += kThreads) {
      const double a = d[i];
#pragma unroll
      for (int l = 0; l < kMaxLags; ++l)
        if (l < lags) acc[l] = fma(a, d[i + l], acc[l]);
    }
    __syncthreads();
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int l = 0; l < kMaxLags; ++l) {
    if (l < lags) {  // uniform over the block
      double v = acc[l];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) warp_sum[warp][l] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < lags) {
    double s = 0.0;
    for (int k = 0; k < kThreads / 32; ++k) s += warp_sum[k][threadIdx.x];
    out[static_cast<size_t>(blockIdx.x) * lags + threadIdx.x] = s + 2.0;
  }
}

}  // namespace

// x int32 [N, B], window float64 [B] -> out float64 [N, max_order + 1]
extern "C" int flake_autocorr(const int* x, const double* window,
                              double* out, int N, int B, int max_order,
                              cudaStream_t stream) {
  if (N > 0 && B > 0)
    autocorr_kernel<<<N, kThreads, 0, stream>>>(x, window, out, B,
                                                max_order + 1);
  return static_cast<int>(cudaGetLastError());
}
