// L: the LPC coefficient stage, every candidate order's quantized
// coefficients from one stream's autocorrelation, in one launch.
//
// No Pallas kernel stands behind it. The JAX package writes the stage as
// two jax.lax.scans inside its one jitted analysis program: Levinson-Durbin
// for every order (flake_tpu/ops/lpc.py:174, levinson_all_orders) or, under
// the EST order method, the Schur recursion and the Levinson update seeded
// with its reflection coefficients (:242 schur_refs, :271
// levinson_from_refs), then the quantizer (:307 quantize_lpc_coefs). The
// port's plain versions (ops/lpc.py) unroll each scan into Python, some
// 400-2,600 small launches a batch; this kernel replaces them all.
//
// Arithmetic, bit for bit the plain version on the card: every operation
// is written with its rounding intrinsic (__dadd_rn, __dmul_rn, __ddiv_rn,
// __fma_rn and their float forms), which nvcc never contracts, so the
// default -fmad=true changes nothing here. The plain version fuses exactly
// 1 - r*r, the symmetric update (torch.addcmul) and Schur's multiply-adds,
// and those are __fma_rn here; the reflection numerator is a left fold from
// tap 0 (acc = 0, then acc + prod[j]), as the plain loop adds; the products
// before it, the division, err * (1 - r*r) and the quantizer's error + c *
// 2^sh are rounded one by one. The plain version's incrementally kept
// reversed vector rev[j] is, bit for bit, tmp[i-1-j] (each of its elements
// is the same fused multiply-add of the same two operands as the tap it
// mirrors), so the update reads tap i-1-t in its place. The quantizer's
// shift comes from the float32 image of the row's largest magnitude and
// four exact power-of-two comparisons, as the plain version finds it; NaN
// rows (a silent stream's Schur divides by an error of 0) give the same
// shift 0, and their NaN taps the int32 0, as XLA converts a NaN and the
// plain version maps one (the card's float64 cvt.rzi would give INT32_MIN,
// its float32 one 0).
//
// What bounds it on the card: neither bytes (the level-12 batch reads 0.27
// MB and writes 4.6 MB, 0.0014 ms at 3.35 TB/s) nor throughput (about
// 30 k floating operations a stream) but the dependent chain of one
// stream: at order 32, 528 dependent adds of the reflection numerators, 32
// divisions, the updates between them, then the last row's 32 taps of
// error feedback. The first design (csrc/yardsticks/lpc_v1.cu) put a
// stream on a warp, a tap a lane, and paid a shuffle on that chain for
// every four products it folded (its SASS issues four SHFL pairs, then
// four dependent DADDs) and for every update's mirrored tap, and it
// quantized only after the whole recursion.
//
// Design: 32 streams a block, warp-specialised. Warp 0 runs the recursion, one
// stream a lane, with the stream's coefficient vector in registers (the steps
// unrolled to a bound of 8, 16 or 32 orders, so every tap has its register; a
// step's lags are loaded together at its start): each lane forms its own
// products and folds them, and the update reads the mirrored tap from its own
// registers, so no shuffle and no memory access lies on the chain. After order
// i it writes row i (its vector, the coefficients of order i + 1 negated) to
// shared memory and arrives on row i's mbarrier. Twelve warps quantize, a
// stream a lane: those off warp 0's sub-partition (warps 4, 8 and 12 idle:
// they would issue there and take the FP64 pipe the recursion waits on). They
// take the rows in order from a shared counter, each waiting on its row's
// mbarrier and quantizing it as soon as it is published, while the recursion
// runs on, so only the last row's quantizer follows the recursion. A row's
// four taps at a time are scaled first, off the error feedback's chain. Each
// row's int32 taps go to device memory as 16-byte stores where the order
// allows. Degenerate streams' quotients (below) keep every lane on the
// division's fast path. Float coefficient rows never reach device memory.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxOrder = 32;                    // params.MAX_LPC_ORDER
constexpr int kStreams = 32;                     // streams a block
constexpr int kThreads = 512;                    // warps 4, 8, 12 idle
constexpr unsigned kFull = 0xffffffffu;

// A zero over any number but a NaN, and any quotient of a NaN: the
// quotients a degenerate stream (a silent one's error is 0) asks for
// at every order. __ddiv_rn and __fdiv_rn leave their fast path for them,
// and a warp whose lanes hold 32 streams would pay that path at every
// order for one silent stream, so they are answered here, with the values
// the division gives them: a zero whose sign is the operands' signs'
// exclusive or (0 / 0 a NaN), and a NaN (NaNs compare equal, payloads
// aside).
template <typename T>
__device__ __forceinline__ bool quiet_quotient(T a, T b) {
  return (a == T(0) && b == b) || a != a || b != b;
}

__device__ __forceinline__ double quotient_of_zero_or_nan(double a,
                                                          double b) {
  if (a != a || b != b || b == 0.0)
    return __longlong_as_double(0x7fffffffffffffffLL);
  return __longlong_as_double(
      (__double_as_longlong(a) ^ __double_as_longlong(b)) &
      static_cast<long long>(0x8000000000000000ULL));
}

__device__ __forceinline__ float quotient_of_zero_or_nan(float a, float b) {
  if (a != a || b != b || b == 0.0f) return __int_as_float(0x7fffffff);
  return __int_as_float((__float_as_int(a) ^ __float_as_int(b)) &
                        static_cast<int>(0x80000000u));
}

template <typename T>
struct Fp;

template <>
struct Fp<double> {
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double div(double a, double b) {
    if (quiet_quotient(a, b)) return quotient_of_zero_or_nan(a, b);
    return __ddiv_rn(a, b);
  }
  __device__ static double fma(double a, double b, double c) {
    return __fma_rn(a, b, c);
  }
  __device__ static double tiny() { return 2.2250738585072014e-308; }
  // 2^s from its bits; s stays in [-130, 142] here
  __device__ static double exp2i(int s) {
    return __longlong_as_double(static_cast<long long>(s + 1023) << 52);
  }
  __device__ static int f32_bits(double c) {
    return __float_as_int(__double2float_rn(c));
  }
  __device__ static double trunc(double x) { return ::trunc(x); }
  __device__ static int to_int(double q) { return __double2int_rz(q); }
};

template <>
struct Fp<float> {
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float sub(float a, float b) { return __fsub_rn(a, b); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float div(float a, float b) {
    if (quiet_quotient(a, b)) return quotient_of_zero_or_nan(a, b);
    return __fdiv_rn(a, b);
  }
  __device__ static float fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
  __device__ static float tiny() { return 1.17549435e-38f; }
  // inf above 127 and 2^-126 below -126, as ops/lpc._exp2i builds them
  __device__ static float exp2i(int s) {
    s = min(max(s, -126), 128);
    return __int_as_float((s + 127) << 23);
  }
  __device__ static int f32_bits(float c) { return __float_as_int(c); }
  __device__ static float trunc(float x) { return truncf(x); }
  __device__ static int to_int(float q) { return __float2int_rz(q); }
};

// the shared-memory layout for max order m: a row of m + 1 lags and a
// triangle of m rows (row o's o + 1 taps from o (o + 1) / 2) a stream, each
// of an odd number of elements, so that lanes on streams hit distinct banks
__host__ __device__ inline int ac_stride(int m) { return (m + 1) | 1; }
__host__ __device__ inline int tri_stride(int m) {
  return (m * (m + 1) / 2) | 1;
}

template <typename T>
size_t shared_bytes(int m) {
  return kMaxOrder * sizeof(uint64_t) +
         static_cast<size_t>(kStreams) * (ac_stride(m) + tri_stride(m)) *
             sizeof(T);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];"
               : "=l"(state)
               : "r"(smem_addr(bar))
               : "memory");
  (void)state;
}

__device__ __forceinline__ void bar_wait(uint64_t* bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0, 10000000;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
}

// fn(std::integral_constant<int, i>) for i = 0 .. min(m, kBound) - 1, each
// step compiled on its own, so that every tap index is a constant and the
// coefficient vector stays in registers
template <int kBound, int I = 0, typename Fn>
__device__ __forceinline__ void unrolled(Fn& fn, int m) {
  if constexpr (I < kBound) {
    if (I >= m) return;
    fn(std::integral_constant<int, I>{});
    unrolled<kBound, I + 1>(fn, m);
  }
}

// Row i <- taps 0..i of tmp (the coefficients of order i + 1, negated:
// the quantizer negates them as it reads them, a sign on an operand); then
// row i's mbarrier.
template <typename T, int i>
__device__ __forceinline__ void publish(T* tri, uint64_t* bar, const T* tmp) {
  T* row = tri + i * (i + 1) / 2;
#pragma unroll
  for (int t = 0; t <= i; ++t) row[t] = tmp[t];
  bar_arrive(bar + i);
}

// The symmetric update of step i with reflection coefficient r: tap t < i
// takes tmp[t] + r * tmp[i-1-t] (one FMA), tap i takes r; taps t and
// i-1-t are updated as a pair, each from the other's old value.
template <typename T, int i>
__device__ __forceinline__ void update(T* tmp, T r) {
#pragma unroll
  for (int t = 0; 2 * t < i; ++t) {
    const T x = tmp[t], y = tmp[i - 1 - t];
    tmp[t] = Fp<T>::fma(r, y, x);
    if (i - 1 - t != t) tmp[i - 1 - t] = Fp<T>::fma(r, x, y);
  }
  tmp[i] = r;
}

// Levinson-Durbin for every order (lpc.c:77-117), one stream a lane.
template <typename T, int kBound>
__device__ void levinson(const T* ac, T* tri, uint64_t* bar, int m) {
  typedef Fp<T> F;
  T tmp[kBound];
#pragma unroll
  for (int t = 0; t < kBound; ++t) tmp[t] = T(0);
  T err = ac[0];
  auto order = [&](auto step) {
    constexpr int i = decltype(step)::value;
    // the step's lags, loaded together before its chain
    T a[i + 2];
#pragma unroll
    for (int k = 0; k <= i + 1; ++k) a[k] = ac[k];
    T acc = T(0);
#pragma unroll
    for (int j = 0; j < i; ++j) acc = F::add(acc, F::mul(tmp[j], a[i - j]));
    T r = F::sub(-a[i + 1], acc);
    r = F::div(r, err == T(0) ? F::tiny() : err);    // NaN guard only
    err = F::mul(err, F::fma(-r, r, T(1)));
    update<T, i>(tmp, r);
    publish<T, i>(tri, bar, tmp);
  };
  unrolled<kBound>(order, m);
}

// Schur (lpc.c:136-147), then the Levinson update seeded with each
// reflection coefficient as it comes, one stream a lane. Step k's
// generators matter only at j < m - k, so step k updates j < kBound - k.
template <typename T, int kBound>
__device__ void schur(const T* ac, T* tri, uint64_t* bar, int m) {
  typedef Fp<T> F;
  T gen0[kBound], gen1[kBound], tmp[kBound];
#pragma unroll
  for (int j = 0; j < kBound; ++j) {
    gen0[j] = j < m ? ac[j + 1] : T(0);
    gen1[j] = gen0[j];
    tmp[j] = T(0);
  }
  T error = ac[0], r = T(0);
  auto order = [&](auto step) {
    constexpr int k = decltype(step)::value;
    if constexpr (k > 0) {
#pragma unroll
      for (int j = 0; j < kBound - k; ++j) {
        const T g1s = gen1[j + 1];
        gen1[j] = F::fma(r, gen0[j], g1s);
        gen0[j] = F::fma(g1s, r, gen0[j]);
      }
    }
    const T g = gen1[0];
    r = F::div(-g, error);
    error = F::fma(g, r, error);
    update<T, k>(tmp, r);
    publish<T, k>(tri, bar, tmp);
  };
  unrolled<kBound>(order, m);
}

// The quantizer (lpc.c:167-219) on row o (order o + 1) of one stream, whose
// coefficients are -row[t]: its m int32 taps to `out` (16-byte stores when
// `vec`), its shift, and the reflection coefficient of order o + 1, which
// is row[o] (the recursion sets tap o to it). The scaled taps c 2^sh
// are formed first, off the error feedback's chain, and the clamps are
// read from e2 + 0.5 beside its truncation: trunc(y) <= -qmax exactly when
// y <= -qmax, and trunc(y) > qmax exactly when y >= qmax + 1, NaN neither.
template <typename T>
__device__ void quantize_row(const T* row, int o, int m, int precision,
                            int* out, int* shift, T* ref, bool valid,
                            bool vec) {
  typedef Fp<T> F;
  const int qmax = (1 << (precision - 1)) - 1;
  const T tq = T(qmax);
  // the largest magnitude, as four running maxima; amax keeps a NaN
  T part[4] = {T(0), T(0), T(0), T(0)};
  for (int t0 = 0; t0 <= o; t0 += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (t0 + u <= o) {
        const T v = fabs(row[t0 + u]);             // |-c| = |c|
        if (v > part[u] || v != v) part[u] = v;
      }
    }
  }
  T cmax = part[0];
#pragma unroll
  for (int u = 1; u < 4; ++u)
    if (part[u] > cmax || part[u] != part[u]) cmax = part[u];
  const bool zero_out = F::mul(cmax, T(32768)) < T(1);
  const int s0 = (precision - 1) - (((F::f32_bits(cmax) >> 23) & 0xFF)
                                    - 126);
  int sh = -(1 << 20);
  for (int d = -2; d <= 1; ++d)
    if (F::mul(cmax, F::exp2i(s0 + d)) <= tq) sh = max(sh, s0 + d);
  sh = min(max(sh, 0), 15);
  const bool scale_down = sh == 0 && cmax > tq;
  // qmax / cmax as torch computes a number over a tensor: the reciprocal,
  // then the product (read only where scale_down)
  const T scale = scale_down ? F::mul(F::div(T(1), cmax), tq) : T(1);
  const T mult = F::exp2i(sh);
  T error = T(0);
  for (int t0 = 0; t0 < m; t0 += 4) {
    if (t0 > o) {                                // past the row: zeros
      if (valid && vec) {
        *reinterpret_cast<int4*>(out + t0) = make_int4(0, 0, 0, 0);
      } else if (valid) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (t0 + u < m) out[t0 + u] = 0;
      }
      continue;
    }
    // four taps' c 2^sh first, off the chain, then their error feedback,
    // kept where the tap is the row's
    T cm[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const T c = t0 + u <= o ? -row[t0 + u] : T(0);
      cm[u] = F::mul(scale_down ? F::mul(c, scale) : c, mult);
    }
    int qv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool on = t0 + u <= o;
      const T e2 = F::add(error, cm[u]);
      const T y = F::add(e2, T(0.5));
      const bool low = y <= T(-qmax), high = y >= T(qmax + 1);
      T q = F::trunc(y);
      q = low ? T(-qmax + 1) : high ? tq : q;
      const T next = F::sub(e2, q);
      error = on ? next : error;
      qv[u] = on && !zero_out && q == q ? F::to_int(q) : 0;
    }
    if (!valid) continue;
    if (vec) {
      *reinterpret_cast<int4*>(out + t0) =
          make_int4(qv[0], qv[1], qv[2], qv[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (t0 + u < m) out[t0 + u] = qv[u];
    }
  }
  if (!valid) return;
  *shift = zero_out ? 0 : sh;
  *ref = row[o];
}

template <typename T, bool kEst, int kBound>
__global__ void __launch_bounds__(kThreads)
candidates_kernel(const T* __restrict__ autoc, int* __restrict__ qcoefs,
                  int* __restrict__ shifts, T* __restrict__ refs, int N,
                  int m, int precision) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int acs = ac_stride(m), ts = tri_stride(m), width = m + 1;
  T* ac_all = reinterpret_cast<T*>(smem + kMaxOrder * sizeof(uint64_t));
  T* tri_all = ac_all + kStreams * acs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kStreams;
  __shared__ int next_row;                       // the quantizers' queue
  if (threadIdx.x < m) bar_init(bar + threadIdx.x, 32);
  if (threadIdx.x == 0) next_row = 0;
  // the block's lags, coalesced; a lane past the last stream repeats the
  // block's first, so that it takes the same path (it writes nothing)
  for (int idx = threadIdx.x; idx < kStreams * width; idx += kThreads) {
    const int s = idx / width, k = idx - s * width;
    ac_all[s * acs + k] = autoc[(size_t)n0 * width +
                                (n0 + s < N ? idx : k)];
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();

  const size_t n = static_cast<size_t>(n0) + lane;
  const bool valid = n < static_cast<size_t>(N);
  T* tri = tri_all + lane * ts;
  if (warp == 0) {
    if (kEst)
      schur<T, kBound>(ac_all + lane * acs, tri, bar, m);
    else
      levinson<T, kBound>(ac_all + lane * acs, tri, bar, m);
  } else if (warp % 4 != 0) {
    // the quantizers keep off warp 0's sub-partition (warp w issues on
    // sub-partition w % 4), whose FP64 pipe the recursion needs; each
    // takes the next row not yet taken, so the last row goes to the first
    // warp free
    for (;;) {
      int o = 0;
      if (lane == 0) o = atomicAdd(&next_row, 1);
      o = __shfl_sync(kFull, o, 0);
      if (o >= m) break;
      bar_wait(bar + o);
      quantize_row<T>(tri + o * (o + 1) / 2, o, m, precision,
                              qcoefs + (n * m + o) * m, shifts + n * m + o,
                              refs + n * m + o, valid, (m & 3) == 0);
    }
  }
}

template <typename T, bool kEst, int kBound>
int launch_bound(const T* a, int* q, int* sh, T* r, int N, int m,
                 int precision, cudaStream_t stream) {
  auto kern = candidates_kernel<T, kEst, kBound>;
  const size_t bytes = shared_bytes<T>(m);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<(N + kStreams - 1) / kStreams, kThreads, bytes, stream>>>(
      a, q, sh, r, N, m, precision);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kEst>
int launch(const void* autoc, int* qcoefs, int* shifts, void* refs, int N,
           int m, int precision, cudaStream_t stream) {
  const T* a = static_cast<const T*>(autoc);
  T* r = static_cast<T*>(refs);
  if (m <= 8)
    return launch_bound<T, kEst, 8>(a, qcoefs, shifts, r, N, m, precision,
                                    stream);
  if (m <= 16)
    return launch_bound<T, kEst, 16>(a, qcoefs, shifts, r, N, m, precision,
                                     stream);
  return launch_bound<T, kEst, 32>(a, qcoefs, shifts, r, N, m, precision,
                                   stream);
}

}  // namespace

// L. autoc [N, m + 1] float64 (f64 = 1) or float32 -> qcoefs int32 [N, m,
// m] (on a 16-byte boundary), shifts int32 [N, m], refs [N, m] in autoc's
// dtype; 1 <= m <= 32, precision 2..16; est = 1: Schur then the seeded
// Levinson, else Levinson.
extern "C" int flake_lpc_candidates(const void* autoc, int* qcoefs,
                                    int* shifts, void* refs, int N, int m,
                                    int precision, int est, int f64,
                                    cudaStream_t stream) {
  if (m < 1 || m > kMaxOrder || precision < 2 || precision > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(qcoefs) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  if (f64)
    return est ? launch<double, true>(autoc, qcoefs, shifts, refs, N, m,
                                      precision, stream)
               : launch<double, false>(autoc, qcoefs, shifts, refs, N, m,
                                       precision, stream);
  return est ? launch<float, true>(autoc, qcoefs, shifts, refs, N, m,
                                   precision, stream)
             : launch<float, false>(autoc, qcoefs, shifts, refs, N, m,
                                    precision, stream);
}
