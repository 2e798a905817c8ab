// The first design of X, kept unchanged apart from the entry point's name,
// only as a yardstick: chip_smoke.py builds it beside the current design
// (../rice.cu) and times both on the same inputs in one run. No path of
// the package calls it; it is not part of the package's kernel library
// (flake_tpu_torch/_cuda.py builds csrc/*.cu only). The helpers below are
// the copies of ../rice.cu's that it used (R1's k search and level scan,
// R2's partition shares).
//
// X, flake_fixed_search, replaces the FIXED order loop of analyze_frames
// (flake_tpu/ops/frame.py:323-336: predict.residual_fixed, then
// rice.subframe_bits, whose calc_rice_params is the static search of
// rice.py:158): for each fixed order o of min_o..max_o (<= 4), the wrapped
// residual, its zigzag partition sums with the warm-up zeroed, the level
// scan over limit_max_partition_order(pmin or pmax, n, o) with (n >> p) - o
// counted in a level's first partition, then the estimate of rice.c:157-171
// without LPC fields, u32(bits + o * obits + 2 + method + 4); the order of
// the least estimate, ascending with strict <, and its predictor's
// coefficients.
// X reads a stream's samples once from device memory (the lags of the
// five predictors come from the cache) and writes an order and four
// coefficients: 4 bytes a sample, 4.7 MB on the level-2 batch of 1,024
// streams of 1,152 samples. Its operations, at most fifteen multiply-adds,
// five zigzags and five adds a sample for the five orders and R1's scan
// five times, are of the same size at the int32 rate. Design: one block of
// 256 a stream, R2's partition shares, pyramid and scan once an order;
// thread 0 compares the orders' estimates.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kMaxPorder = 8;                    // params.MAX_PARTITION_ORDER
constexpr int kMaxK = 30;                        // params.MAX_RICE_PARAM
constexpr int kMaxK4bit = 14;                    // params.MAX_RICE_PARAM_4BIT
constexpr int kFixedThreads = 256;               // X: threads a block
constexpr int kMaxFixed = 4;                     // X: the highest order
// predict.FIXED_COEFS, orders 0-4: coef[j] applies to smp[i - 1 - j]
__constant__ int kFixedCoefs[kMaxFixed + 1][kMaxFixed] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {2, -1, 0, 0}, {3, -3, 1, 0}, {4, -6, 4, -1}};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// (2r) ^ (r >> 31) in uint32 (rice.h), wrapping for |r| >= 2^30
__device__ __forceinline__ unsigned zigzag(int r) {
  return (static_cast<unsigned>(r) << 1) ^ static_cast<unsigned>(r >> 31);
}

// the first design's 31-step scan of the count over k (t's halves lo, hi)
__device__ __forceinline__ int scan_k(unsigned lo, unsigned hi,
                                      unsigned cnt32, unsigned& kb) {
  unsigned best = cnt32 + lo, c = cnt32;
  int k_best = 0;
#pragma unroll
  for (int k = 1; k <= kMaxK; ++k) {
    c += cnt32;
    const unsigned nb = c + __funnelshift_r(lo, hi, k);
    if (nb < best) {
      best = nb;
      k_best = k;
    }
  }
  kb = best;
  return k_best;
}

// the k search of one partition of sum s and count cnt (cnt is negative
// where the warm-up exceeds the partition; its low 32 bits and those of
// cnt >> 1 are the JAX package's uint64 ones): returns the first k of the
// least count, and that count in kb
__device__ __forceinline__ int rice_k(u64 s, int cnt, unsigned& kb) {
  const unsigned cnt32 = static_cast<unsigned>(cnt);
  const u64 t = s - static_cast<u64>(static_cast<unsigned>(cnt >> 1));
  const unsigned lo = static_cast<unsigned>(t);
  const unsigned hi = static_cast<unsigned>(t >> 32);
  const bool negative = static_cast<long long>(t) < 0;
  if (cnt < 1 || (!negative && t + 31ull * cnt32 >= (1ull << 32)))
    return scan_k(lo, hi, cnt32, kb);
  int k = 0;
  if (!negative) {
    const unsigned m = 2u * cnt32 + 1u;
    const int k0 = max(0, __clz(m) - __clz(lo));  // bit lengths: t's - m's
    k = min(k0 + ((lo >> k0) >= m ? 1 : 0), kMaxK);
  }
  kb = cnt32 * (k + 1) + __funnelshift_r(lo, hi, k);
  return k;
}

struct Choice {
  unsigned bits;
  int porder;
  int method;
  int taken;  // a level was in range (always, unless pmin > pmax)
};

// Each level's uint32 sum of its partitions' counts and whether any of its
// k is above 14, gathered in shared memory (zeroed first).
struct Levels {
  unsigned bits[kMaxPorder + 1];
  unsigned wide[kMaxPorder + 1];
};

// The pyramid is in heap order: level p's partition j at slot (1 << p) + j,
// so slot i holds the sum of slots 2i and 2i + 1; slot 0 is unused.
__host__ __device__ __forceinline__ int heap_size(int ps) { return 2 << ps; }

// the levels the scan may take, rice.c:148-155's clamps: log2(n ^ (n - 1))
// (ub, from the caller) and, where the order is positive, log2(n / order)
__device__ __forceinline__ void level_range(int n, int order, int pmin,
                                            int pmax, int ub, int ps,
                                            int& lo, int& hi) {
  lo = min(pmin, ub);
  hi = min(min(pmax, ub), ps);
  if (order > 0) {
    const int q = n / order;
    const int log2_no = q > 0 ? 31 - __clz(q) : 0;
    lo = min(lo, log2_no);
    hi = min(hi, log2_no);
  }
}

// By `threads` threads from `tid` (whole warps): the k of every partition of
// levels lo..hi (to ks, at its slot; partition 0 of each level holds the
// warm-up) and each level's count sum and method into lv. A warp takes 32
// slots at a time: from slot 32 up they lie in one level, and the warp sums
// its run of them in a level by shuffles once, with one shared atomic;
// slots 1..31 (levels 0-4) add one by one. A sum mod 2^32 does not depend
// on the order of its terms.
__device__ void scan_slots(const u64* pyr, unsigned char* ks, Levels* lv,
                           int ps, int n, int order, int lo, int hi, int tid,
                           int threads) {
  const int lane = tid & 31;
  unsigned acc = 0;
  bool wide = false;
  for (int base = tid - lane; base < heap_size(ps); base += threads) {
    const int i = base + lane;
    const int p = 31 - __clz(i);            // -1 for slot 0
    const bool on = i < heap_size(ps) && p >= lo && p <= hi;
    unsigned kb = 0;
    int k = 0;
    if (on) {
      const int j = i - (1 << p);
      k = rice_k(pyr[i], (n >> p) - (j == 0 ? order : 0), kb);
      ks[i] = static_cast<unsigned char>(k);
    }
    if (base < 32) {
      if (on) {
        atomicAdd(&lv->bits[p], kb);
        if (k > kMaxK4bit) atomicOr(&lv->wide[p], 1u);
      }
      continue;
    }
    // from slot 32 up: sum the warp's run of slots in one level, then
    // reduce it once
    acc += kb;
    wide |= k > kMaxK4bit;
    const int next = base + threads;
    if (next < heap_size(ps) && 31 - __clz(next) == p) continue;
    const unsigned sum = warp_sum(acc);
    const bool any = __any_sync(0xffffffffu, wide);
    if (lane == 0 && p >= lo && p <= hi) {
      atomicAdd(&lv->bits[p], sum);
      if (any) atomicOr(&lv->wide[p], 1u);
    }
    acc = 0;
    wide = false;
  }
}

// the pick, ascending from a best of 0xFFFFFFFF, taking a level whose bits
// (its count sum + 4 a partition) are <= the best
__device__ __forceinline__ Choice pick_level(const Levels* lv, int lo,
                                             int hi) {
  Choice best = {0xFFFFFFFFu, 0, 0, 0};
  for (int p = lo; p <= hi; ++p) {
    const unsigned bits = lv->bits[p] + (4u << p);
    if (bits <= best.bits) best = {bits, p, lv->wide[p] ? 1 : 0, 1};
  }
  return best;
}

// A block's partition sums at ps (R2, X). Each thread takes a contiguous
// share of one partition (tpp threads a partition, or a partition at a time
// when there are more partitions than threads), read from lane % its length
// on so that the lanes of a warp fall on different banks; a group's shares
// sum by shuffles, or through quot_s where a partition spans warps.
struct Shares {
  int part, groups, from, len, tpp;
};

template <int kThreads>
__device__ __forceinline__ Shares shares_of(int n, int ps, int tid) {
  const int parts = 1 << ps, psize = n >> ps;
  const int tpp = max(1, kThreads / parts);
  const int share = (psize + tpp - 1) / tpp;
  const int from = min((tid % tpp) * share, psize);
  return {tid / tpp, kThreads / tpp, from, min(from + share, psize) - from,
          tpp};
}

// the sums of zig(i) over each partition at ps into the pyramid's finest
// level, then the pyramid folded (barriers included)
template <int kThreads, typename Zig>
__device__ void partition_sums(u64* pyr, u64* quot_s, const Shares& shares,
                               Zig zig, int n, int ps, int tid) {
  const int parts = 1 << ps, psize = n >> ps;
  const int warp = tid >> 5, lane = tid & 31;
  for (int j = shares.part; j < parts; j += shares.groups) {
    u64 acc = 0;
    const int a = j * psize + shares.from;
    for (int q = 0, r = shares.len ? lane % shares.len : 0; q < shares.len;
         ++q) {
      acc += zig(a + r);
      r = r + 1 == shares.len ? 0 : r + 1;
    }
    if (shares.tpp > 1) {
      for (int off = min(shares.tpp, 32) >> 1; off; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (shares.tpp <= 32) {
      if (tid % shares.tpp == 0) pyr[parts + j] = acc;
    } else if (lane == 0) {
      quot_s[warp] = acc;
    }
  }
  if (shares.tpp > 32) {
    __syncthreads();
    if (tid < parts) {
      u64 acc = 0;
      for (int w = 0; w < shares.tpp / 32; ++w)
        acc += quot_s[tid * (shares.tpp / 32) + w];
      pyr[parts + tid] = acc;
    }
  }
  __syncthreads();
  for (int p = ps - 1; p >= 0; --p) {
    for (int i = (1 << p) + tid; i < (2 << p); i += kThreads)
      pyr[i] = pyr[2 * i] + pyr[2 * i + 1];
    __syncthreads();
  }
}

// X: one block of kThreads a stream; dynamic shared memory: the pyramid
// (heap_size(ps) uint64) and the k bytes. For each order o of min_o..max_o:
// the order-o residual's zigzag values (warm-up zeroed) summed by partition
// (partition_sums), R1's scan of the levels limit_max_partition_order(pmin
// or pmax, n, o) allows, the pick, and the estimate of _overhead_bits
// (precision 0, not LPC); thread 0 keeps the first order of the least
// estimate (strict <, ascending) and writes it with its coefficients.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    fixed_search_kernel(const int* __restrict__ smp,
                        const int* __restrict__ obits,
                        int* __restrict__ order_out,
                        int* __restrict__ coefs_out, int n, int min_o,
                        int max_o, int taps, int pmin, int pmax, int ps,
                        int ub) {
  extern __shared__ u64 fixed_smem[];
  __shared__ u64 quot_s[kThreads / 32];
  __shared__ Levels lv;
  u64* pyr = fixed_smem;
  unsigned char* ks = reinterpret_cast<unsigned char*>(pyr + heap_size(ps));
  const int tid = threadIdx.x;
  const long long s = blockIdx.x;
  const int* x = smp + s * n;
  const Shares shares = shares_of<kThreads>(n, ps, tid);
  long long best_bits = 0;
  int best_o = min_o;
  for (int o = min_o; o <= max_o; ++o) {
    if (tid <= kMaxPorder) lv.bits[tid] = lv.wide[tid] = 0;
    // predict.residual_fixed: the prediction in int64, the residual
    // wrapped to int32
    auto zig = [&](int i) -> unsigned {
      if (i < o) return 0u;
      long long r = x[i];
      switch (o) {
        case 1: r -= x[i - 1]; break;
        case 2: r -= 2ll * x[i - 1] - x[i - 2]; break;
        case 3: r -= 3ll * x[i - 1] - 3ll * x[i - 2] + x[i - 3]; break;
        case 4:
          r -= 4ll * x[i - 1] - 6ll * x[i - 2] + 4ll * x[i - 3] - x[i - 4];
          break;
        default: break;
      }
      return zigzag(static_cast<int>(static_cast<unsigned>(r)));
    };
    partition_sums<kThreads>(pyr, quot_s, shares, zig, n, ps, tid);
    int lo, hi;
    level_range(n, o, pmin, pmax, ub, ps, lo, hi);
    scan_slots(pyr, ks, &lv, ps, n, o, lo, hi, tid, kThreads);
    __syncthreads();
    if (tid == 0) {
      const Choice c = pick_level(&lv, lo, hi);
      const long long est = (static_cast<long long>(c.bits) +
                             static_cast<long long>(o) * obits[s] + 2 +
                             c.method + 4) & 0xFFFFFFFFll;
      if (o == min_o || est < best_bits) {
        best_bits = est;
        best_o = o;
      }
    }
    __syncthreads();                // lv and the pyramid are rewritten
  }
  __shared__ int chosen;
  if (tid == 0) {
    chosen = best_o;
    order_out[s] = best_o;
  }
  __syncthreads();
  if (tid < taps) coefs_out[s * taps + tid] = kFixedCoefs[chosen][tid];
}

}  // namespace

// X. smp int32 [N, n], obits int32 [N] -> order int32 [N] (the FIXED
// order of the least estimated bits, min_o..max_o, 0 <= min_o <= max_o <=
// 4) and coefs int32 [N, taps] (its predictor's coefficients, zero-padded;
// max_o <= taps <= 4); n a multiple of 2^ps, ps and ub as for R1.
extern "C" int flake_fixed_search_v1(const int* smp, const int* obits,
                                     int* order, int* coefs, int N, int n,
                                     int min_o, int max_o, int taps,
                                     int pmin, int pmax, int ps, int ub,
                                     cudaStream_t stream) {
  if (min_o < 0 || min_o > max_o || max_o > kMaxFixed || taps < max_o ||
      taps > kMaxFixed || n <= max_o)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N > 0)
    fixed_search_kernel<kFixedThreads>
        <<<N, kFixedThreads, heap_size(ps) * (sizeof(u64) + 1), stream>>>(
            smp, obits, order, coefs, n, min_o, max_o, taps, pmin, pmax, ps,
            ub);
  return static_cast<int>(cudaGetLastError());
}
