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
// itself off for bps > 16; here every product is one 32x32 -> 64-bit
// multiply-add and the sums are exact int64 for every bit depth and order
// up to 32.
//
// What bounds it on the card: integer multiply-adds, B * o * (o + 1) / 2
// wide products per stream (78 a sample at order 12, 528 at order 32)
// against 4 bytes read a sample, so the integer pipes, not memory; the
// residual's shift, zigzag and 64-bit sum cost about as many integer
// instructions again as the products at order 12. The first design lost
// most of its time around the products: a segmented warp sum and a shared
// atomic per sample and order, two shared loads per product, and one block
// per stream, which left most of the 132 SMs idle on the level-12 buckets
// of 6-190 streams. This design:
// - The split plan (ops/sweep.py: sweep_plan) cuts every partition into
//   segments of at most `seg` samples; thread t of a block takes segment
//   t % spp of partition p0 + t / spp, and a block takes ppb whole
//   partitions, so a stream spreads over several blocks and the blocks
//   need no sum across them. The plan shortens segments until the launch
//   has enough threads to fill the card.
// - A thread walks its segment serially, four samples at a time, with the
//   MO samples before them in registers (a window that slides by four);
//   the window comes in as 16-byte loads of the segment and its halo,
//   the next four samples' load issued before this four's products, not
//   as a shared load per tap.
// - MO, the order bucket (12 or 32), is a template argument, so the
//   triangle of taps unrolls and the window and sums stay in registers;
//   orders above max_order are skipped by a branch that is uniform over
//   the launch.
// - Coefficients sit in shared memory, a row per order, read four taps at
//   a time as broadcasts: one 16-byte load feeds 16 multiply-adds.
// - Each order's zigzag sum stays in a register for the whole segment and
//   leaves the thread once: a plain store where the thread owns the whole
//   partition (spp = 1), else into shared memory, where after one barrier
//   a partition's spp sums are added in segment order and stored. No
//   atomics (the card's 64-bit shared atomic add is a compare-and-swap
//   loop, which contending threads serialise).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 4;       // samples a thread takes at once
constexpr int kMaxBucket = 32;

// acc + (int64)a * b in one instruction
__device__ __forceinline__ long long mad_wide(int a, int b, long long acc) {
  long long d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(acc));
  return d;
}

// w[k] = x[i + k] for k < n, zero outside [0, B); 16-byte loads when the
// caller knows them aligned and inside the stream
template <int n>
__device__ __forceinline__ void load_run(const int* __restrict__ xr, int i,
                                         int B, bool vec, int* w) {
  if (vec && i >= 0 && i + n <= B) {
#pragma unroll
    for (int k = 0; k < n; k += 4) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(xr + i + k));
      w[k] = v.x; w[k + 1] = v.y; w[k + 2] = v.z; w[k + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < n; ++k)
      w[k] = (i + k >= 0 && i + k < B) ? __ldg(xr + i + k) : 0;
  }
}

// Every order's zigzag residual at samples i..i+3 (w[MO + k] = x[i + k],
// the MO samples before them in w[0..MO)), added to sum[order - 1] where
// sample k counts: at[k] is its index, or -1 past the segment, and a
// sample counts for the orders up to its index (the warm-up excluded).
// Orders past max_order are skipped by a branch uniform over the launch.
template <int MO>
__device__ __forceinline__ void group(const int* c, const int* sh,
                                      const int* w, unsigned long long* sum,
                                      const int* at, int max_order) {
#pragma unroll
  for (int o = 1; o <= MO; ++o) {
    if (o <= max_order) {
      const int4* row = reinterpret_cast<const int4*>(c + (o - 1) * MO);
      long long a[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) a[k] = 0;
#pragma unroll
      for (int j4 = 0; j4 < (o + 3) / 4; ++j4) {
        const int4 q = row[j4];
        const int cq[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = 4 * j4 + u;
          if (j < o) {
#pragma unroll
            for (int k = 0; k < kGroup; ++k)
              a[k] = mad_wide(cq[u], w[MO + k - 1 - j], a[k]);
          }
        }
      }
      const int sft = sh[o - 1];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const unsigned r = static_cast<unsigned>(w[MO + k])
                           - static_cast<unsigned>(a[k] >> sft);
        const unsigned z = (r << 1)
                           ^ static_cast<unsigned>(static_cast<int>(r) >> 31);
        if (at[k] >= o) sum[o - 1] += z;
      }
    }
  }
}

template <int MO>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const int* __restrict__ x, const int* __restrict__ coefs,
             const int* __restrict__ shifts,
             unsigned long long* __restrict__ out, int B, int max_order,
             int pmax, int seg, int spp, int ppb, int blocks,
             bool aligned) {
  __shared__ __align__(16) int c[MO * MO];   // [order-1][tap], 0 past it
  __shared__ int sh[MO];
  // each thread's sums, [order][thread], for the combine (spp > 1)
  __shared__ unsigned long long part[MO][kThreads];

  const int n = blockIdx.x / blocks;
  const int parts = 1 << pmax;
  const int psize = B >> pmax;
  const int p0 = (blockIdx.x - n * blocks) * ppb;
  const int np = min(ppb, parts - p0);
  const int* xr = x + static_cast<size_t>(n) * B;
  for (int i = threadIdx.x; i < MO * MO; i += kThreads) {
    const int o = i / MO, j = i - o * MO;
    c[i] = (o < max_order && j <= o)
               ? coefs[(static_cast<size_t>(n) * max_order + o) * max_order
                       + j] : 0;
  }
  for (int i = threadIdx.x; i < MO; i += kThreads)
    sh[i] = i < max_order ? shifts[static_cast<size_t>(n) * max_order + i]
                          : 0;
  __syncthreads();

  const int pl = threadIdx.x / spp;          // partition within the block
  const int s = threadIdx.x - pl * spp;      // segment within the partition
  const int p = p0 + pl;
  unsigned long long sum[MO];
#pragma unroll
  for (int o = 0; o < MO; ++o) sum[o] = 0ull;

  if (pl < np) {
    const int s0 = p * psize + s * seg;
    const int len = min(seg, psize - s * seg);
    // every load 16-byte aligned: the rows, the segment, the group
    const bool vec = aligned && (B & 3) == 0 && (s0 & 3) == 0
                     && (len & 3) == 0;
    int w[MO + kGroup];                      // w[k] = x[i - MO + k]
    int ahead[kGroup];                       // the next group's samples
    load_run<MO>(xr, s0 - MO, B, vec, w);
    load_run<kGroup>(xr, s0, B, vec, ahead);
    for (int g = 0; g < len; g += kGroup) {
      const int i = s0 + g;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) w[MO + k] = ahead[k];
      // the next group's load goes out before this group's products
      load_run<kGroup>(xr, i + kGroup, B, vec && g + 2 * kGroup <= len,
                       ahead);
      int at[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) at[k] = g + k < len ? i + k : -1;
      group<MO>(c, sh, w, sum, at, max_order);
#pragma unroll
      for (int k = 0; k < MO; ++k) w[k] = w[k + kGroup];
    }
    if (spp == 1) {                          // the thread owns partition p
      unsigned long long* dst = out
          + static_cast<size_t>(n) * max_order * parts + p;
#pragma unroll
      for (int o = 0; o < MO; ++o)
        if (o < max_order) dst[static_cast<size_t>(o) * parts] = sum[o];
    } else {
#pragma unroll
      for (int o = 0; o < MO; ++o) part[o][threadIdx.x] = sum[o];
    }
  }
  if (spp > 1) {                             // uniform over the launch
    // a partition's spp segments, added in segment order
    __syncthreads();
    unsigned long long* dst = out
        + static_cast<size_t>(n) * max_order * parts + p0;
    for (int t = threadIdx.x; t < max_order * np; t += kThreads) {
      const int o = t / np, q = t - o * np;
      unsigned long long total = 0ull;
      for (int k = 0; k < spp; ++k) total += part[o][q * spp + k];
      dst[static_cast<size_t>(o) * parts + q] = total;
    }
  }
}

}  // namespace

// x int32 [N, B], coefs int32 [N, max_order, max_order] (row o-1 holds
// order o's taps), shifts int32 [N, max_order] -> out int64
// [N, max_order, 2^pmax_static], psize = B >> pmax_static. seg, spp,
// ppb, blocks and bucket are the split plan of ops/sweep.py: sweep_plan
// (segment length, segments a partition, partitions a block, blocks a
// stream, the order bucket: 12 or 32).
extern "C" int flake_sweep_sums(const int* x, const int* coefs,
                                const int* shifts, long long* out, int N,
                                int B, int max_order, int pmax_static,
                                int seg, int spp, int ppb, int blocks,
                                int bucket, cudaStream_t stream) {
  if (N > 0 && B > 0) {
    auto* o = reinterpret_cast<unsigned long long*>(out);
    const unsigned grid = static_cast<unsigned>(N) * blocks;
    const bool aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    if (bucket == 12)
      sweep_kernel<12><<<grid, kThreads, 0, stream>>>(
          x, coefs, shifts, o, B, max_order, pmax_static, seg, spp, ppb,
          blocks, aligned);
    else if (bucket == kMaxBucket)
      sweep_kernel<kMaxBucket><<<grid, kThreads, 0, stream>>>(
          x, coefs, shifts, o, B, max_order, pmax_static, seg, spp, ppb,
          blocks, aligned);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
