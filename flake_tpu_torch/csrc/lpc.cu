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
// mirrors), so lane t reads it from lane i-1-t by shuffle. The quantizer's
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
// divisions, then 32 taps of error feedback. Design: one warp a stream
// (max order <= 32 = the warp width), four streams a block. Lane t holds
// tap t of the coefficient vector; r is computed by every lane (each adds
// the products broadcast by shuffle in the fold's order), the update is one
// FMA a lane, and each order's row goes to shared memory. Then lane o
// quantizes row o, serially over its taps with its own error feedback, so
// all rows run at once; the rows are packed as a triangle (row o's o + 1
// taps from o (o + 1) / 2), the int32 taps go to a second table, and the
// warp writes those out coalesced. Float coefficient rows never reach
// device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOrder = 32;                    // params.MAX_LPC_ORDER
constexpr int kWarps = 4;                        // streams a block
constexpr int kStride = kMaxOrder + 1;           // an int32 row, no conflicts
constexpr int kTriangle = kMaxOrder * (kMaxOrder + 1) / 2;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Fp;

template <>
struct Fp<double> {
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
  __device__ static double sub(double a, double b) { return __dsub_rn(a, b); }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double div(double a, double b) { return __ddiv_rn(a, b); }
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
  __device__ static float div(float a, float b) { return __fdiv_rn(a, b); }
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

// Row i of the triangle <- the negated coefficients of order i + 1 (taps
// 0..i); `tmp` is lane t's tap after step i.
template <typename T>
__device__ T* row_at(T* tri, int i) { return tri + i * (i + 1) / 2; }

template <typename T>
__device__ void put_row(T* tri, int i, int lane, T tmp) {
  if (lane <= i) row_at(tri, i)[lane] = -tmp;
}

// The symmetric update of step i with reflection coefficient r: tap t < i
// takes tmp[t] + r * tmp[i-1-t] (one FMA), tap i takes r.
template <typename T>
__device__ T update(T tmp, T r, int i, int lane) {
  const T mirror = __shfl_sync(kFull, tmp, (i - 1 - lane) & 31);
  if (lane < i) return Fp<T>::fma(r, mirror, tmp);
  return lane == i ? r : tmp;
}

template <typename T, bool kEst>
__global__ void __launch_bounds__(kWarps * 32)
candidates_kernel(const T* __restrict__ autoc, int* __restrict__ qcoefs,
                  int* __restrict__ shifts, T* __restrict__ refs, int N,
                  int m, int precision) {
  typedef Fp<T> F;
  __shared__ T tri_s[kWarps][kTriangle];
  __shared__ int q_s[kWarps][kMaxOrder][kStride];
  __shared__ T ac_all[kWarps][kMaxOrder + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  if (n >= N) return;                      // the whole warp: no block sync
  T* tri = tri_s[warp];
  int (*qrow)[kStride] = q_s[warp];
  T* ac = ac_all[warp];
  for (int k = lane; k <= m; k += 32) ac[k] = autoc[(size_t)n * (m + 1) + k];
  __syncwarp();

  T tmp = T(0), my_ref = T(0);
  if (!kEst) {
    // Levinson-Durbin for every order (lpc.c:77-117)
    T err = ac[0];
    for (int i = 0; i < m; ++i) {
      const T prod = lane < i ? F::mul(tmp, ac[i - lane]) : T(0);
      T acc = T(0);
#pragma unroll 4
      for (int j = 0; j < i; ++j) acc = F::add(acc, __shfl_sync(kFull, prod, j));
      T r = F::sub(-ac[i + 1], acc);
      r = F::div(r, err == T(0) ? F::tiny() : err);     // NaN guard only
      err = F::mul(err, F::fma(-r, r, T(1)));
      tmp = update(tmp, r, i, lane);
      if (lane == i) my_ref = r;
      put_row(tri, i, lane, tmp);
    }
  } else {
    // Schur (lpc.c:136-147): lane j holds gen0[j] and gen1[j]
    T gen0 = lane < m ? ac[lane + 1] : T(0);
    T gen1 = gen0;
    T error = ac[0];
    T g = __shfl_sync(kFull, gen1, 0);
    T r = F::div(-g, error);
    error = F::fma(g, r, error);
    if (lane == 0) my_ref = r;
    for (int k = 1; k < m; ++k) {
      T g1s = __shfl_down_sync(kFull, gen1, 1);
      if (lane >= m - 1) g1s = T(0);
      gen1 = F::fma(r, gen0, g1s);
      gen0 = F::fma(g1s, r, gen0);
      g = __shfl_sync(kFull, gen1, 0);
      r = F::div(-g, error);
      error = F::fma(g, r, error);
      if (lane == k) my_ref = r;
    }
    // the Levinson update seeded with those coefficients
    for (int i = 0; i < m; ++i) {
      tmp = update(tmp, __shfl_sync(kFull, my_ref, i), i, lane);
      put_row(tri, i, lane, tmp);
    }
  }
  __syncwarp();

  // the quantizer (lpc.c:167-219): lane o takes row o, order o + 1
  const int qmax = (1 << (precision - 1)) - 1;
  const T tq = T(qmax);
  int sh_out = 0;
  if (lane < m) {
    const int o = lane;
    const T* row = row_at(tri, o);
    T cmax = T(0);
    for (int t = 0; t <= o; ++t) {                // amax keeps a NaN
      const T v = fabs(row[t]);
      if (v > cmax || v != v) cmax = v;
    }
    const bool zero_out = F::mul(cmax, T(32768)) < T(1);
    const int s0 = (precision - 1) - (((F::f32_bits(cmax) >> 23) & 0xFF)
                                      - 126);
    int sh = -(1 << 20);
    for (int d = -2; d <= 1; ++d)
      if (F::mul(cmax, F::exp2i(s0 + d)) <= tq) sh = max(sh, s0 + d);
    sh = min(max(sh, 0), 15);
    const bool scale_down = sh == 0 && cmax > tq;
    // qmax / cmax as torch computes a number over a tensor: the
    // reciprocal, then the product
    const T scale = F::mul(F::div(T(1), cmax == T(0) ? T(1) : cmax), tq);
    const T mult = F::exp2i(sh);
    T error = T(0);
    for (int t = 0; t < m; ++t) {
      int qi = 0;
      if (t <= o) {
        const T c = scale_down ? F::mul(row[t], scale) : row[t];
        const T e2 = F::add(error, F::mul(c, mult));
        T q = F::trunc(F::add(e2, T(0.5)));
        if (q <= T(-qmax)) q = T(-qmax + 1);
        if (q > tq) q = tq;
        error = F::sub(e2, q);
        qi = zero_out || q != q ? 0 : F::to_int(q);
      }
      qrow[o][t] = qi;
    }
    sh_out = zero_out ? 0 : sh;
  }
  __syncwarp();
  if (lane < m) {
    const size_t base = (size_t)n * m;
    shifts[base + lane] = sh_out;
    refs[base + lane] = my_ref;
    for (int o = 0; o < m; ++o)
      qcoefs[(base + o) * m + lane] = qrow[o][lane];
  }
}

template <typename T>
int launch(const void* autoc, int* qcoefs, int* shifts, void* refs, int N,
           int m, int precision, int est, cudaStream_t stream) {
  const int blocks = (N + kWarps - 1) / kWarps;
  const T* a = static_cast<const T*>(autoc);
  T* r = static_cast<T*>(refs);
  if (est)
    candidates_kernel<T, true><<<blocks, kWarps * 32, 0, stream>>>(
        a, qcoefs, shifts, r, N, m, precision);
  else
    candidates_kernel<T, false><<<blocks, kWarps * 32, 0, stream>>>(
        a, qcoefs, shifts, r, N, m, precision);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L. autoc [N, m + 1] float64 (f64 = 1) or float32 -> qcoefs int32 [N, m,
// m], shifts int32 [N, m], refs [N, m] in autoc's dtype; 1 <= m <= 32,
// precision 2..16; est = 1: Schur then the seeded Levinson, else Levinson.
extern "C" int flake_lpc_candidates(const void* autoc, int* qcoefs,
                                    int* shifts, void* refs, int N, int m,
                                    int precision, int est, int f64,
                                    cudaStream_t stream) {
  if (m < 1 || m > kMaxOrder || precision < 2 || precision > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  return f64 ? launch<double>(autoc, qcoefs, shifts, refs, N, m, precision,
                              est, stream)
             : launch<float>(autoc, qcoefs, shifts, refs, N, m, precision,
                             est, stream);
}
