// K2: for every candidate LPC order, the zigzag residual's partition sums.
//
// Replaces the TPU kernel flake_tpu/ops/pallas_sweep3.py:
// sweep_partition_limbs3 (_sweep3_kernel). For each order o in
// 1..max_order and each sample i >= o of a stream:
//   pred = (sum_j c[o][j] * x[i-1-j]) >> shift[o]   (int64, arithmetic)
//   r    = wrap32(x[i] - pred)
//   z    = (2r) ^ (r >> 31) as uint32
// and z is added to partition i / psize of order o. The TPU kernel split
// coefficients and sums into 16-bit limbs to stay in int32 and gated
// itself off for bps > 16; here the accumulation is int64 and the sums
// are exact for every bit depth and order up to 32, with no limbs.
//
// What bounds it on the card: integer multiply-adds, about
// B*max_order*(max_order+1)/2 64-bit products per stream (78 per sample
// at level 8) against 4 bytes read per sample, so it is bound by the
// integer pipes, not memory. Design: one block per stream walks B in
// shared-memory chunks with a max_order halo; each thread takes one
// sample per step and computes every order from the shared window.
// Lanes of a warp hold consecutive samples, so partition ids are
// non-decreasing across lanes: a segmented warp sum gives each partition
// run's total to its first lane, which adds it into a shared per-(order,
// partition) accumulator with a 64-bit integer atomic. Integer addition
// is associative, so the sums do not depend on scheduling.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;     // samples per shared-memory chunk
constexpr int kMaxOrder = 32;

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const int* __restrict__ x, const int* __restrict__ coefs,
             const int* __restrict__ shifts,
             unsigned long long* __restrict__ out, int B, int max_order,
             int parts, int psize) {
  extern __shared__ unsigned long long acc[];   // [max_order][parts]
  __shared__ int xs[kMaxOrder + kChunk];        // halo, then the chunk
  __shared__ int c[kMaxOrder * kMaxOrder];      // [order-1][tap]
  __shared__ int sh[kMaxOrder];

  const size_t n = blockIdx.x;
  const int* xr = x + n * B;
  const int mo2 = max_order * max_order;
  for (int i = threadIdx.x; i < mo2; i += kThreads) c[i] = coefs[n * mo2 + i];
  for (int i = threadIdx.x; i < max_order; i += kThreads)
    sh[i] = shifts[n * max_order + i];
  for (int i = threadIdx.x; i < max_order * parts; i += kThreads)
    acc[i] = 0ull;

  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < B; c0 += kChunk) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < kMaxOrder + kChunk; i += kThreads) {
      const int g = c0 - kMaxOrder + i;
      xs[i] = (g >= 0 && g < B) ? xr[g] : 0;
    }
    __syncthreads();
    for (int step = 0; step < kChunk; step += kThreads) {
      const int li = step + threadIdx.x;
      const int i = c0 + li;
      const bool in = i < B;
      const int p = in ? i / psize : parts;   // non-decreasing over lanes
      const int* win = xs + kMaxOrder + li;   // win[-1 - j] = x[i-1-j]
      const int xi = win[0];
      const int pprev = __shfl_up_sync(0xffffffffu, p, 1);
      const bool head = in && (lane == 0 || pprev != p);
      for (int o = 1; o <= max_order; ++o) {
        const int* co = c + (o - 1) * max_order;
        long long a = 0;
        for (int j = 0; j < o; ++j)
          a += static_cast<long long>(co[j]) * win[-1 - j];
        const long long pred = a >> sh[o - 1];
        const int r = static_cast<int>(static_cast<unsigned>(
            static_cast<unsigned long long>(xi - pred)));
        const unsigned z = (static_cast<unsigned>(r) << 1)
                           ^ static_cast<unsigned>(r >> 31);
        unsigned long long v = (in && i >= o) ? z : 0ull;
        // segmented suffix sum: after the loop a run's first lane holds
        // the total of its run (p is non-decreasing over lanes)
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned long long vo = __shfl_down_sync(0xffffffffu, v, off);
          const int po = __shfl_down_sync(0xffffffffu, p, off);
          if (lane + off < 32 && po == p) v += vo;
        }
        if (head && v) atomicAdd(&acc[(o - 1) * parts + p], v);
      }
    }
  }
  __syncthreads();
  unsigned long long* dst = out + n * max_order * parts;
  for (int i = threadIdx.x; i < max_order * parts; i += kThreads)
    dst[i] = acc[i];
}

}  // namespace

// x int32 [N, B], coefs int32 [N, max_order, max_order] (row o-1 holds
// order o's taps), shifts int32 [N, max_order] -> out int64
// [N, max_order, 2^pmax_static], psize = B >> pmax_static.
extern "C" int flake_sweep_sums(const int* x, const int* coefs,
                                const int* shifts, long long* out, int N,
                                int B, int max_order, int pmax_static,
                                cudaStream_t stream) {
  const int parts = 1 << pmax_static;
  const int psize = B >> pmax_static;
  const size_t smem = sizeof(unsigned long long) * max_order * parts;
  cudaFuncSetAttribute(sweep_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  if (N > 0 && B > 0)
    sweep_kernel<<<N, kThreads, smem, stream>>>(
        x, coefs, shifts, reinterpret_cast<unsigned long long*>(out), B,
        max_order, parts, psize);
  return static_cast<int>(cudaGetLastError());
}
