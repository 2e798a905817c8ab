// K4: for every candidate LPC order, the zigzag residual's granule sums.
//
// Replaces the TPU kernel flake_tpu/ops/pallas_sweep.py:
// sweep_partition_limbs (_sweep_kernel). For each stream, each order o in
// 1..max_order and each sample i >= o:
//   pred = (sum_j c[o][j] * x[i-1-j]) >> shift[o]   (int64, arithmetic)
//   r    = wrap32(x[i] - pred)
//   z    = (2r) ^ (r >> 31) as uint32
// and z is added to granule i / gs of order o, gs = min(psize, 128). The
// TPU kernel split samples and coefficients into 16-bit and 8-bit limbs,
// kept per-stream scalars in SMEM, built lag views from lane and sublane
// rolls and summed granules with an f32 one-hot matmul, all because the
// TPU has no int64 and a 128-lane layout. Here every product is one
// 32x32 -> 64-bit multiply-add and the sums are exact int64.
//
// What bounds it on the card: at order 32 every sample costs 528 64-bit
// multiply-adds against 4 bytes read, so it is bound by the integer pipes.
// The shapes that reach it (levels 11-12: B = 4096 or 8192, order 32,
// 256 partitions) come a few dozen streams per launch, which one block
// per stream (K2) spreads over too few of the 132 SMs, and K2's shared
// accumulators grow to 64 KiB there. Design: the grid tiles (stream,
// 1024-sample tile); each block stages its tile with a 32-sample halo
// from the previous tile (zero at the stream start) and the stream's
// coefficients in shared memory. A thread takes 4 consecutive samples and
// holds their 36-sample window in registers, so each coefficient read
// from shared memory feeds 4 multiply-adds; the order and tap loops are
// unrolled at compile time up to 32 and skip the orders beyond
// max_order. A granule is gs / 4 neighbouring lanes of one warp (gs a
// power of two from 4 to 128), summed with xor shuffles; its first lane
// stores the sum. A tile holds whole granules, so every output has one
// writer: plain stores, no atomics, and sums that do not depend on
// scheduling.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                     // consecutive samples a thread
constexpr int kTile = kThreads * kPer;      // samples per block
constexpr int kMaxOrder = 32;
constexpr int kWin = kMaxOrder + kPer;      // a thread's register window

// acc + (int64)a * b in one instruction
__device__ __forceinline__ long long mad_wide(int a, int b, long long acc) {
  long long d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(acc));
  return d;
}

__global__ void __launch_bounds__(kThreads)
granule_kernel(const int* __restrict__ x, const int* __restrict__ coefs,
               const int* __restrict__ shifts,
               unsigned long long* __restrict__ out, int B, int max_order,
               int gs_log2) {
  __shared__ int xs[kMaxOrder + kTile];             // halo, then the tile
  __shared__ __align__(16) int c[kMaxOrder * kMaxOrder];  // [order-1][tap]
  __shared__ int sh[kMaxOrder];

  const size_t n = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int* xr = x + n * B;
  for (int i = threadIdx.x; i < kMaxOrder * kMaxOrder; i += kThreads) {
    const int o = i / kMaxOrder, j = i % kMaxOrder;
    c[i] = (o < max_order && j <= o)
               ? coefs[(n * max_order + o) * max_order + j] : 0;
  }
  for (int i = threadIdx.x; i < kMaxOrder; i += kThreads)
    sh[i] = i < max_order ? shifts[n * max_order + i] : 0;
  for (int i = threadIdx.x; i < kMaxOrder + kTile; i += kThreads) {
    const int g = t0 - kMaxOrder + i;
    xs[i] = (g >= 0 && g < B) ? xr[g] : 0;
  }
  __syncthreads();

  // w[k] = x[i0 - kMaxOrder + k]: the 32 samples before i0, then i0..i0+3
  const int li = threadIdx.x * kPer;
  const int i0 = t0 + li;
  int w[kWin];
#pragma unroll
  for (int k = 0; k < kWin; ++k) w[k] = xs[li + k];

  const int lanes = (1 << gs_log2) / kPer;    // lanes per granule, 1..32
  const int lane = threadIdx.x & 31;
  const bool head = i0 < B && (lane & (lanes - 1)) == 0;
  const int G = B >> gs_log2;
  unsigned long long* dst = out + n * max_order * G + (i0 >> gs_log2);

#pragma unroll
  for (int o = 1; o <= kMaxOrder; ++o) {
    if (o <= max_order) {                     // uniform over the block
      const int* co = c + (o - 1) * kMaxOrder;
      long long a[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) a[k] = 0;
#pragma unroll
      for (int j = 0; j < o; ++j) {
        const int cj = co[j];
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          a[k] = mad_wide(cj, w[kMaxOrder + k - 1 - j], a[k]);
      }
      const int s = sh[o - 1];
      unsigned long long v = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const long long pred = a[k] >> s;
        const int r = static_cast<int>(static_cast<unsigned>(
            static_cast<unsigned long long>(w[kMaxOrder + k] - pred)));
        const unsigned z = (static_cast<unsigned>(r) << 1)
                           ^ static_cast<unsigned>(r >> 31);
        if (i0 + k >= o) v += z;              // warm-up samples excluded
      }
      // granule sum over its aligned group of lanes (a power of two)
      for (int off = 1; off < lanes; off <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (head) dst[static_cast<size_t>(o - 1) * G] = v;
    }
  }
}

}  // namespace

// x int32 [N, B], coefs int32 [N, max_order, max_order] (row o-1 holds
// order o's taps), shifts int32 [N, max_order] -> out int64
// [N, max_order, B >> gs_log2]; 2 <= gs_log2 <= 7 and B % (1 << gs_log2)
// == 0, checked by the caller.
extern "C" int flake_sweep_granules(const int* x, const int* coefs,
                                    const int* shifts, long long* out, int N,
                                    int B, int max_order, int gs_log2,
                                    cudaStream_t stream) {
  if (N > 0 && B > 0) {
    const dim3 grid((B + kTile - 1) / kTile, N);
    granule_kernel<<<grid, kThreads, 0, stream>>>(
        x, coefs, shifts, reinterpret_cast<unsigned long long*>(out), B,
        max_order, gs_log2);
  }
  return static_cast<int>(cudaGetLastError());
}
