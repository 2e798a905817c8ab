// S: order selection and the chosen candidate's gather, in one launch, under
// every order method.
//
// No Pallas kernel stands behind it. The JAX package writes the selection
// as tensor code inside its one jitted analysis program
// (flake_tpu/ops/frame.py:102-183): MAX's constant order, EST's rule on the
// reflection coefficients (lpc.estimate_order, lpc.c:149-156), the LOG
// step-halving search (_select_order_log, optimize.c:239-261), the
// 2/4/8-LEVEL candidate scan (_select_order_level, optimize.c:202-223) and
// SEARCH's argmin; then the analysis gathers the chosen order's quantized
// coefficient row and shift. The port's plain versions (ops/frame.py) run
// them eagerly: the gather, its index arithmetic and the pad to 32 taps are
// seven launches, EST's rule six more, LOG's fifteen steps some 360. This
// kernel does all of it for every method, and with the gather switched off
// it is the order-only selection (frame.select_order_bits).
//
// Arithmetic, the plain version's: bits are int64, compared as int64 with
// strict <. SEARCH keeps the first (lowest) order among equal minima, as
// jnp.argmin and torch.argmin do: the warp takes the least high word, then
// the least low word among the lanes that tie on it, then the lowest such
// lane. LEVEL scans its
// candidates highest first, so a tie keeps the earlier, higher one. LOG
// keeps the visited set as a 32-bit mask (max order <= 32); an order not
// yet visited compares as 0xFFFFFFFF, as the plain version's opt_bits does,
// and every index is clamped to [0, max_order) before it is read, as the
// plain version's gathers clamp. EST: the highest order whose |ref| > 0.10
// in the refs' own dtype (float64, or float32 with the constant rounded to
// float32, as torch compares a float32 tensor with a Python float), at
// least 1; a NaN is not above.
//
// What bounds it on the card: the launch. It reads a row of at most 32
// int64 (or refs), one quantized row of at most 32 int32 and a shift, and
// writes 32 int32 and two int32 a stream. Design: one warp a stream, four
// streams a block, so that the level-8 batch's 1,024 streams spread over
// every SM. Lane j loads column j (one coalesced load, no division) and,
// under the gather, shift j with it. The methods run on shuffles and
// ballots with every lane holding the same state (LOG's three visits a step
// in closed form from three shuffles issued at once); then lane j copies
// tap j of the chosen row. Loading the whole candidate table before the
// choice, into registers or shared memory, so that no load waits on it, was
// slower on an H100 (order 12 and 32), and comparing as uint32 where a row
// fits, with half the shuffles, no faster.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxOrder = 32;                    // params.MAX_LPC_ORDER
constexpr int kWarps = 4;                        // streams a block
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kU32 = 0xFFFFFFFFll;

// params.OrderMethod
constexpr int kMax = 0;
constexpr int kEst = 1;
constexpr int kLevel2 = 2;
constexpr int kLevel8 = 4;
constexpr int kSearch = 5;
constexpr int kLog = 6;

__device__ __forceinline__ long long lane_of(long long v, int lane) {
  return __shfl_sync(kFull, v, lane);
}

// the 0-based order `method` picks from the warp's row, lane j holding
// column j (LLONG_MAX past the last column)
__device__ __forceinline__ int pick(long long v, int lane, int method,
                                    int min_o, int max_o) {
  if (method == kSearch) {
    // the first (lowest) order among equal minima: the least high word,
    // then the least low word of the lanes that tie on it
    const long long w = lane < max_o ? v : LLONG_MAX;
    const int hi = static_cast<int>(w >> 32);
    const unsigned lo = static_cast<unsigned>(w);
    const int least_hi = __reduce_min_sync(kFull, hi);
    const unsigned least_lo =
        __reduce_min_sync(kFull, hi == least_hi ? lo : 0xFFFFFFFFu);
    return __ffs(__ballot_sync(kFull, hi == least_hi && lo == least_lo)) - 1;
  }
  if (method == kLog) {
    auto clamp = [&](int i) { return min(max(i, 0), max_o - 1); };
    int opt = min_o - 1 + (max_o - min_o) / 3;
    unsigned visited = 0;
    for (int step = 16; step; step >>= 1) {
      // the step's three visits (last - step, last, last + step) in closed
      // form, from three reads issued at once. last is always in range, so
      // a visit in range never meets another's index; after the second
      // visit opt is visited, so the third compares with its bits
      const int last = opt, im = last - step, ip = last + step;
      const int cm = clamp(im), cp = clamp(ip);
      const long long vm = lane_of(v, cm), v0 = lane_of(v, last),
                      vp = lane_of(v, cp);
      const bool seen = visited >> last & 1u;
      const bool fresh_m = im >= min_o - 1 && !(visited >> cm & 1u);
      const bool take_m = fresh_m && vm < (seen ? v0 : kU32);
      // a last not yet visited takes opt back where strictly smaller
      const bool at_m = take_m && !(!seen && v0 < vm);
      const bool fresh_p = ip < max_o && !(visited >> cp & 1u);
      const bool take_p = fresh_p && vp < (at_m ? vm : v0);
      opt = take_p ? ip : at_m ? im : last;
      visited |= (fresh_m ? 1u << cm : 0u) | 1u << last |
                 (fresh_p ? 1u << cp : 0u);
    }
    return opt;
  }
  // LEVEL2/4/8: candidate i of `levels`, highest first
  const int levels = 1 << (method - 1);
  auto cand = [&](int i) {
    return max(min_o + ((max_o - min_o + 1) * (i + 1)) / levels - 2, 0);
  };
  int best = cand(levels - 1);
  long long bb = lane_of(v, best);
  for (int i = levels - 2; i >= 0; --i) {
    const int o = cand(i);
    const long long bo = lane_of(v, o);
    if (bo < bb) {
      bb = bo;
      best = o;
    }
  }
  return best;
}

template <typename R>
__global__ void __launch_bounds__(kWarps * 32)
    select_kernel(const long long* __restrict__ bits,
                  const R* __restrict__ refs, const int* __restrict__ qcoefs,
                  const int* __restrict__ shifts, int* __restrict__ order,
                  int* __restrict__ coefs, int* __restrict__ shift, int N,
                  int m, int method, int min_o, int max_o, int gather) {
  const int lane = threadIdx.x & 31;
  const long long s =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (s >= N) return;                            // the whole warp

  // the column the method reads and, under the gather, the shifts, in one
  // go; the chosen row is read once the choice is made
  long long v = LLONG_MAX;
  R ref = 0;
  if (method == kEst)
    ref = lane < max_o ? refs[s * max_o + lane] : static_cast<R>(0);
  else if (method != kMax && lane < m)
    v = bits[s * m + lane];
  int sh = 0;
  if (gather && lane < max_o) sh = shifts[s * max_o + lane];

  int best;                                      // 0-based order
  if (method == kMax) {
    best = max_o - 1;
  } else if (method == kEst) {
    const unsigned set =
        __ballot_sync(kFull, fabs(ref) > static_cast<R>(0.10));
    best = set ? 31 - __clz(set) : 0;
  } else {
    best = pick(v, lane, method, min_o, max_o);
  }
  if (lane == 0) order[s] = best + 1;
  if (!gather) return;
  coefs[s * kMaxOrder + lane] =
      lane < max_o ? qcoefs[(s * max_o + best) * max_o + lane] : 0;
  sh = __shfl_sync(kFull, sh, best);
  if (lane == 0) shift[s] = sh;
}

bool bad_method(int method, int m, int min_o, int max_o) {
  if (min_o < 1 || min_o > max_o || max_o > kMaxOrder) return true;
  if (method == kMax || method == kEst) return false;
  return m < max_o || m > kMaxOrder ||
         (method != kSearch && method != kLog &&
          (method < kLevel2 || method > kLevel8));
}

template <typename R>
int launch(const long long* bits, const R* refs, const int* qcoefs,
           const int* shifts, int* order, int* coefs, int* shift, int N,
           int m, int method, int min_o, int max_o, int gather,
           cudaStream_t stream) {
  if (N > 0)
    select_kernel<R><<<(N + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
        bits, refs, qcoefs, shifts, order, coefs, shift, N, m, method, min_o,
        max_o, gather);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S with the gather. bits int64 [N, m] (order j + 1 in column j; read under
// LEVEL2/4/8, SEARCH and LOG, m <= 32), refs [N, max_o] float64 (f64 = 1)
// or float32 (read under EST), qcoefs int32 [N, max_o, max_o] and shifts
// int32 [N, max_o] (L's candidates) -> order int32 [N] (1-based), coefs
// int32 [N, 32] (the chosen row, zero-padded) and shift int32 [N], under
// order method `method` (params.OrderMethod) over orders min_o..max_o,
// 1 <= min_o <= max_o <= 32; the caller checks the shapes.
extern "C" int flake_select_candidate(const long long* bits, const void* refs,
                                      const int* qcoefs, const int* shifts,
                                      int* order, int* coefs, int* shift,
                                      int N, int m, int method, int min_o,
                                      int max_o, int f64,
                                      cudaStream_t stream) {
  if (bad_method(method, m, min_o, max_o))
    return static_cast<int>(cudaErrorInvalidValue);
  if (f64)
    return launch(bits, static_cast<const double*>(refs), qcoefs, shifts,
                  order, coefs, shift, N, m, method, min_o, max_o, 1, stream);
  return launch(bits, static_cast<const float*>(refs), qcoefs, shifts, order,
                coefs, shift, N, m, method, min_o, max_o, 1, stream);
}

// S without the gather: bits int64 [N, m] -> order int32 [N], under
// LEVEL2/4/8, SEARCH or LOG, 1 <= min_o <= max_o <= m <= 32.
extern "C" int flake_select_order(const long long* bits, int* order, int N,
                                  int m, int method, int min_o, int max_o,
                                  cudaStream_t stream) {
  if (method == kMax || method == kEst || max_o > m ||
      bad_method(method, m, min_o, max_o))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<double>(bits, nullptr, nullptr, nullptr, order, nullptr,
                        nullptr, N, m, method, min_o, max_o, 0, stream);
}
