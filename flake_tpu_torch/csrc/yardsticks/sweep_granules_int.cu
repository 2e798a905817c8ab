// K4 on the integer pipes: the design of ../sweep_granules.cu with each
// product one 32x32 -> 64-bit multiply-add (mad.wide) in place of a
// float64 FMA. Kept only as a yardstick: chip_smoke.py builds it beside
// the kernel and times both on the same inputs in one run. No path of the
// package calls it; it is not part of the package's kernel library
// (flake_tpu_torch/_cuda.py builds csrc/*.cu only).
//
// The design, as the kernel's: 8 consecutive samples a thread in a
// register window, each shared coefficient broadcast feeding 8 products,
// orders four at a time with compile-time residues, the order loop
// unrolled up to order 12 and rolled above, a 32-bit epilogue (the low
// 32 bits of the sum >> shift by one funnel shift) and granule sums by
// xor shuffles. On this card ptxas makes each mad.wide an IMAD.WIDE
// product and an IADD3 (PERF.md section 6), which is why the kernel runs
// its products on the FP64 pipe instead.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 8;                     // consecutive samples a thread
constexpr int kTile = kThreads * kPer;      // samples per block
constexpr int kMaxOrder = 32;
constexpr int kWin = kMaxOrder + kPer;      // a thread's register window
// up to this order the order loop is unrolled, as in the kernel
constexpr int kUnrollUpTo = 12;

// acc + (int64)a * b in one instruction
__device__ __forceinline__ long long mad_wide(int a, int b, long long acc) {
  long long d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(acc));
  return d;
}

// the low 32 bits of (sum of c[o-1][j] * x[i-1-j]) >> s for this thread's
// 8 samples, order o = 4m + R: taps 0..R-1 first, then m chunks of four,
// so every tap the order has is computed and no other
template <int R>
__device__ __forceinline__ void predictions(int m, const int (&w)[kWin],
                                            const int* __restrict__ c, int s,
                                            unsigned (&pred)[kPer]) {
  const int o = 4 * m + R;
  const int* co = c + (o - 1) * kMaxOrder;
  long long a[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) a[k] = 0;
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int cv = co[t];
#pragma unroll
    for (int k = 0; k < kPer; ++k)
      a[k] = mad_wide(cv, w[kMaxOrder + k - 1 - t], a[k]);
  }
#pragma unroll
  for (int q = 0; q < (kMaxOrder - R) / 4; ++q) {
    if (q < m) {                              // uniform over the block
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = R + 4 * q + t;
        const int cv = co[j];
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          a[k] = mad_wide(cv, w[kMaxOrder + k - 1 - j], a[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    pred[k] = __funnelshift_r(
        static_cast<unsigned>(a[k]),
        static_cast<unsigned>(static_cast<unsigned long long>(a[k]) >> 32),
        s);
}

template <bool kUnrollOrders>
__global__ void __launch_bounds__(kThreads)
granule_kernel(const int* __restrict__ x, const int* __restrict__ coefs,
               const int* __restrict__ shifts,
               unsigned long long* __restrict__ out, int B, int max_order,
               int gs_log2) {
  __shared__ __align__(16) int xs[kMaxOrder + kTile];    // halo, then tile
  __shared__ __align__(16) int c[kMaxOrder * kMaxOrder];   // [order-1][tap]
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
#pragma unroll
  for (int k = 0; k < kWin; k += 4) {
    const int4 q = *reinterpret_cast<const int4*>(xs + li + k);
    w[k] = q.x;
    w[k + 1] = q.y;
    w[k + 2] = q.z;
    w[k + 3] = q.w;
  }

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
    predictions<R>(m, w, c, sh[o - 1], pred);
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

// the contract of flake_sweep_granules (../sweep_granules.cu), with no
// limit on the coefficients' range: the products are exact int64
extern "C" int flake_sweep_granules_int(const int* x, const int* coefs,
                                        const int* shifts, long long* out,
                                        int N, int B, int max_order,
                                        int gs_log2, cudaStream_t stream) {
  return max_order <= kUnrollUpTo
             ? launch<true>(x, coefs, shifts, out, N, B, max_order, gs_log2,
                            stream)
             : launch<false>(x, coefs, shifts, out, N, B, max_order, gs_log2,
                             stream);
}
