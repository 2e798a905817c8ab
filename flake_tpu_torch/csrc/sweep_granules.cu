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
// TPU has no int64 and a 128-lane layout.
//
// What bounds it on the card: at order 32 every sample costs 528
// products against 4 bytes read, so the multiply pipes, not memory. A
// 32x32 -> 64-bit integer multiply-add (mad.wide) runs on this card at
// about 0.4 of the int32 multiply-add rate (csrc/yardsticks/rates.cu),
// but every product and partial sum here is an integer below 2^51 in
// magnitude (coefficients below 2^14, samples below 2^31, at most 32
// taps), so a float64 FMA computes it exactly, at the full FP64 rate. The
// kernel runs its products on the FP64 pipe; the same design on the
// integer pipes (csrc/yardsticks/sweep_granules_int.cu) is timed beside it
// by chip_smoke.py.
//
// Design: the grid tiles (stream, 1024-sample tile); each block stages
// its tile with a 32-sample halo from the previous tile (zero at the
// stream start) and the stream's coefficients in shared memory. A thread
// takes 8 consecutive samples and holds their 40-sample window in
// registers; each coefficient is a shared broadcast that feeds 8
// products. The order loop steps four orders at a time, whose residues
// 1-4 are compile-time: an order's first taps, as many as its residue,
// then whole chunks of four that a uniform branch skips past the order,
// so no product is padded (chunks from tap 0 padded to fours cost 9% more
// products). Above order 12 the loop is not unrolled further, which
// keeps the body in the instruction cache; up to order 12 it is. The
// epilogue is 32-bit: only the low 32 bits of pred count after the wrap,
// and for 0 <= shift <= 15 they are one funnel shift of the sum's two
// halves; the sums start at 1.5 * 2^52, so their halves are the bits of
// the sum plus 2^51 in the mantissa, an offset that the shift moves past
// bit 31. The zigzag runs in 32 bits, and only the sums widen to 64. A
// thread sums its samples 0-3 and 4-7 apart, which are granules of their
// own when gs is 4; larger granules are gs / 8 neighbouring lanes of one
// warp, summed with xor shuffles, whose first lane stores the sum. A tile
// holds whole granules, so every output has one writer: plain stores, no
// atomics, and sums that do not depend on scheduling.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 8;                     // consecutive samples a thread
constexpr int kTile = kThreads * kPer;      // samples per block
constexpr int kMaxOrder = 32;
constexpr int kWin = kMaxOrder + kPer;      // a thread's register window
// up to this order the unrolled order loop is the faster (chip_smoke.py
// times both): its few iterations stay in the instruction cache and know
// their chunk counts at compile time
constexpr int kUnrollUpTo = 12;

// the low 32 bits of (sum of c[o-1][j] * x[i-1-j]) >> s for this thread's
// 8 samples, order o = 4m + R: taps 0..R-1 first, then m chunks of four,
// so every tap the order has is computed and no other; wd is the window
// in float64
template <int R>
__device__ __forceinline__ void predictions(
    int m, const double (&wd)[kWin], const double* __restrict__ c, int s,
    unsigned (&pred)[kPer]) {
  const int o = 4 * m + R;
  const double* co = c + (o - 1) * kMaxOrder;
  // each sum starts at 1.5 * 2^52: every partial sum S is an integer
  // with |S| < 2^51, so 1.5 * 2^52 + S lies where doubles are the
  // integers, each fma is exact, and the sum's bits are S + 2^51 in the
  // mantissa
  double a[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) a[k] = 6755399441055744.0;
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const double cv = co[t];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      a[k] = fma(cv, wd[kMaxOrder + k - 1 - t], a[k]);
  }
#pragma unroll
  for (int q = 0; q < (kMaxOrder - R) / 4; ++q) {
    if (q < m) {                              // uniform over the block
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = R + 4 * q + t;
        const double cv = co[j];
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          a[k] = fma(cv, wd[kMaxOrder + k - 1 - j], a[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    pred[k] = __funnelshift_r(static_cast<unsigned>(__double2loint(a[k])),
                              static_cast<unsigned>(__double2hiint(a[k])),
                              s);
}

template <bool kUnrollOrders>
__global__ void __launch_bounds__(kThreads)
granule_kernel(const int* __restrict__ x, const int* __restrict__ coefs,
               const int* __restrict__ shifts,
               unsigned long long* __restrict__ out, int B, int max_order,
               int gs_log2) {
  __shared__ __align__(16) int xs[kMaxOrder + kTile];    // halo, then tile
  __shared__ __align__(16) double c[kMaxOrder * kMaxOrder];  // [order-1][tap]
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

  // w[k] = x[i0 - kMaxOrder + k]: the 32 samples before i0, then i0..i0+7
  const int li = threadIdx.x * kPer;
  const int i0 = t0 + li;
  int w[kWin];
  double wd[kWin];
#pragma unroll
  for (int k = 0; k < kWin; k += 4) {
    const int4 q = *reinterpret_cast<const int4*>(xs + li + k);
    w[k] = q.x;
    w[k + 1] = q.y;
    w[k + 2] = q.z;
    w[k + 3] = q.w;
  }
#pragma unroll
  for (int k = 0; k < kWin; ++k) wd[k] = w[k];

  const bool warm = i0 < kMaxOrder;
  const int lane = threadIdx.x & 31;
  const int G = B >> gs_log2;
  unsigned long long* dst = out + n * max_order * G + (i0 >> gs_log2);
  // gs 4: two granules a thread; else gs / 8 lanes a granule, 1..16
  const int lanes = gs_log2 == 2 ? 1 : 1 << (gs_log2 - 3);
  const bool head = i0 < B && (lane & (lanes - 1)) == 0;

  // order 4m + R, R a compile-time 1..4
  auto one_order = [&](auto residue, int m) {
    constexpr int R = decltype(residue)::value;
    const int o = 4 * m + R;
    unsigned pred[kPer];
    predictions<R>(m, wd, c, sh[o - 1], pred);
    unsigned z[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int r = static_cast<int>(static_cast<unsigned>(w[kMaxOrder + k])
                                     - pred[k]);
      z[k] = (static_cast<unsigned>(r) << 1) ^ static_cast<unsigned>(r >> 31);
    }
    if (warm) {                               // the stream's first samples
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        if (i0 + k < o) z[k] = 0;
    }
    unsigned long long* d = dst + static_cast<size_t>(o - 1) * G;
    if (gs_log2 == 2) {                       // uniform over the launch
      unsigned long long v0 = 0, v1 = 0;
#pragma unroll
      for (int k = 0; k < kPer / 2; ++k) {
        v0 += z[k];
        v1 += z[k + kPer / 2];
      }
      if (i0 < B) d[0] = v0;
      if (i0 + kPer / 2 < B) d[1] = v1;
    } else {
      unsigned long long v = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) v += z[k];
      for (int off = 1; off < lanes; off <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (head) d[0] = v;
    }
  };
  auto four_orders = [&](int m) {             // orders 4m + 1 .. 4m + 4
    one_order(std::integral_constant<int, 1>{}, m);
    if (4 * m + 2 <= max_order) one_order(std::integral_constant<int, 2>{}, m);
    if (4 * m + 3 <= max_order) one_order(std::integral_constant<int, 3>{}, m);
    if (4 * m + 4 <= max_order) one_order(std::integral_constant<int, 4>{}, m);
  };
  if constexpr (kUnrollOrders) {
#pragma unroll
    for (int m = 0; m < kMaxOrder / 4; ++m)
      if (4 * m < max_order) four_orders(m);
  } else {
#pragma unroll 1
    for (int m = 0; 4 * m < max_order; ++m) four_orders(m);
  }
}

template <bool kUnrollOrders>
int launch(const int* x, const int* coefs, const int* shifts, long long* out,
           int N, int B, int max_order, int gs_log2, cudaStream_t stream) {
  if (N > 0 && B > 0) {
    const dim3 grid((B + kTile - 1) / kTile, N);
    granule_kernel<kUnrollOrders><<<grid, kThreads, 0, stream>>>(
        x, coefs, shifts, reinterpret_cast<unsigned long long*>(out), B,
        max_order, gs_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x int32 [N, B], coefs int32 [N, max_order, max_order] (row o-1 holds
// order o's taps), shifts int32 [N, max_order] -> out int64
// [N, max_order, B >> gs_log2]; 2 <= gs_log2 <= 7 and B % (1 << gs_log2)
// == 0, checked by the caller.
// Precondition, not checked here: |coef| < 2^14 and 0 <= shift <= 15.
// Outside it the float64 sums are no longer exact and the result is wrong
// without an error. ops/lpc.py: quantize_lpc_coefs gives exactly this
// range at the encoder's precision, params.LPC_PRECISION = 15
// (|coef| <= 2^14 - 1, the shift clamped to 0..15), and
// tests/test_torch_sweep_granules.py holds that, so a change of precision
// fails a test.
extern "C" int flake_sweep_granules(const int* x, const int* coefs,
                                    const int* shifts, long long* out, int N,
                                    int B, int max_order, int gs_log2,
                                    cudaStream_t stream) {
  return max_order <= kUnrollUpTo
             ? launch<true>(x, coefs, shifts, out, N, B, max_order, gs_log2,
                            stream)
             : launch<false>(x, coefs, shifts, out, N, B, max_order, gs_log2,
                             stream);
}
