// R1, R2 and X: the Rice partition-order and parameter search, the final
// pass from the samples, and the FIXED order search.
//
// No Pallas kernel stands behind these three. The JAX package writes the
// search as tensor expressions inside one jitted program, where XLA fuses
// the 31-wide k grid into its argmin and min, and the final residual as a
// loop over taps in the same program.
//
// R1, flake_rice_scan, replaces flake_tpu/ops/rice.py: _fold_pyramid,
// _dynamic_porder_scan and find_optimal_k_u32 (rice.py:213-277, :109),
// which the JAX package reaches through subframe_bits_from_limbs: from one
// row's partition sums (K2's or K4's, folded to 2^ps partitions here), the
// sums of every partition order 0..ps, the k search of every partition
// (rice.c:30-45, rice.h:48) and the partition-order scan with per-row
// clamps (rice.c:105-139, 148-155, 163-164).
// R2, flake_final_pass, replaces predict.residual_lpc_dynamic followed by
// calc_rice_params_dynamic (flake_tpu/ops/predict.py:84, rice.py:314-376):
// the residual of one stream's samples under its selected coefficients,
// order and shift (taps j >= order add nothing, positions i < order keep
// the sample; the prediction summed in int64 and arithmetic-shifted, the
// residual wrapped to int32), whether every exact residual fits int32, the
// zigzag residual (rice.h wraps it at |r| >= 2^30) with its warm-up zeroed,
// its partition sums, R1's search, then the exact Rice bits of the winning
// parameters: the sum over samples past the warm-up of (z >> k) + 1 + k,
// plus (4 + method) bits a partition. The FIXED predictors are the same
// pass with their binomial coefficients and shift 0.
// X, flake_fixed_search, replaces the FIXED order loop of analyze_frames
// (flake_tpu/ops/frame.py:323-336: predict.residual_fixed, then
// rice.subframe_bits, whose calc_rice_params is the static search of
// rice.py:158): for each fixed order o of min_o..max_o (<= 4), the wrapped
// residual, its zigzag partition sums with the warm-up zeroed, the level
// scan over limit_max_partition_order(pmin or pmax, n, o) with (n >> p) - o
// counted in a level's first partition (R1's scan: the same clamps, counts,
// wraps and tie rules), then the estimate of rice.c:157-171 without LPC
// fields, u32(bits + o * obits + 2 + method + 4); the order of the least
// estimate, ascending with strict <, and its predictor's coefficients, which
// R2 then takes for the final pass.
//
// Arithmetic, bit for bit the JAX package's: its limb form of the count,
// cnt32 * (k + 1) + low32((s - (cnt >> 1)) >> k) in uint32, is the
// cheap form here too: the 64-bit difference splits into two 32-bit
// halves, and one funnel shift gives bits k..k+31. The k search keeps the
// first minimum (strict <, jnp.argmin); a level's bits are the uint32 sum
// of its partitions' counts plus 4 a partition (a sum mod 2^32 is the low
// 32 bits of the 64-bit sum); the level scan starts at 0xFFFFFFFF and
// takes a level whose bits are <= the best so far, so a tie goes to the
// higher order (rice.c:131).
//
// The k search in closed form. With t = s - floor(cnt / 2), cnt >= 1, and
// either t < 0 or t + 31 cnt < 2^32, no count wraps and the count is
// f(k) = cnt (k + 1) + floor(t / 2^k), whose differences f(k+1) - f(k) =
// cnt - ceil(floor(t / 2^k) / 2) do not decrease: the scan's first
// minimum is k = 0 where t < 0, else the least k with t < (2 cnt + 1) 2^k
// (from the bit lengths of t and 2 cnt + 1, and one compare), capped at
// 30. The one count at that k is the scan's count. Partitions outside that
// domain (sums from 2^32 up, counts of zero or below past the warm-up) run
// the 31-step scan unchanged.
//
// What bounds them on the card. R1 reads 8 bytes a finest partition and,
// in closed form, does about twenty int32 operations for each partition of
// each level (the first design's 31-step scan did about 190), so on a
// level-8 batch its bytes and its operations are of one size. Design: one
// warp a row, four rows a block, shared memory sized by ps (a level-8 row
// holds 128 slots, not the 512 of ps = 8). The warp folds the row into a
// pyramid of 64-bit sums in heap order (level p's partition j at slot
// (1 << p) + j), then takes the slots of levels pmin_eff..pmax_eff 32 at a
// time: from slot 32 up a warp's slots lie in one level and their counts
// sum by shuffles, slots 1..31 (levels 0-4, one pass instead of five) add
// into the level table one by one; k goes to shared memory for the chosen
// level's parameters and the pick reads the table.
// R2 reads the samples once and writes the residual once (4 + 4 bytes a
// sample) and does one 32x32->64-bit multiply-add a tap, at most 32 a
// sample: bytes at order 12, about even at order 32. One block of 256
// threads a stream: the samples pass through shared memory in tiles of
// 1,024 with a 32-sample halo, each thread computes residuals from the
// tile with the coefficients in registers, writes them out, and keeps
// their zigzag values in shared memory (rows up to 8,192 samples, 32 KiB;
// longer rows, up to 65,535, read their residual back from device memory,
// where this block wrote it). Then each thread sums a contiguous share of
// one partition (shares of a partition combine by shuffles, so a row of 256
// partitions of 4 samples needs no reduction at all), the block folds the
// pyramid, all its warps scan the slots as R1's warp does, one thread picks
// the level, and the exact pass runs over the same shares.
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
constexpr int kScanWarps = 4;                    // R1: rows a block
constexpr int kTaps = 32;                        // params.MAX_LPC_ORDER
constexpr int kZigCap = 8192;                    // R2: samples kept in shared
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

// params: the chosen level's k for its partitions, zero beyond
__device__ __forceinline__ void write_params(int* row_params,
                                            const unsigned char* ks,
                                            int parts, const Choice& c,
                                            int tid, int threads) {
  const int used = c.taken ? 1 << c.porder : 0;
  for (int j = tid; j < parts; j += threads)
    row_params[j] = j < used ? ks[(1 << c.porder) + j] : 0;
}

// R1: one warp a row; dynamic shared memory: kScanWarps pyramids of
// heap_size(ps) uint64 sums, as many level tables, then as many k bytes
__global__ void __launch_bounds__(kScanWarps * 32)
    rice_scan_kernel(const long long* __restrict__ sums,
                     const int* __restrict__ order,
                     long long* __restrict__ bits_out,
                     int* __restrict__ porder_out,
                     int* __restrict__ method_out,
                     int* __restrict__ params, int R, int G, int n, int pmin,
                     int pmax, int ps, int ub) {
  extern __shared__ u64 scan_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kScanWarps + warp;
  if (r >= R) return;                       // a whole warp
  const int size = heap_size(ps);
  u64* pyr = scan_smem + warp * size;
  Levels* tables = reinterpret_cast<Levels*>(scan_smem + kScanWarps * size);
  Levels* lv = tables + warp;
  unsigned char* ks =
      reinterpret_cast<unsigned char*>(tables + kScanWarps) + warp * size;
  const int parts = 1 << ps, sub = G >> ps;
  const u64* row = reinterpret_cast<const u64*>(sums) +
                   static_cast<long long>(r) * G;
  if (sub == 1) {
#pragma unroll 8
    for (int j = lane; j < parts; j += 32) pyr[parts + j] = row[j];
  } else {
    for (int j = lane; j < parts; j += 32) {
      u64 acc = 0;
      for (int q = 0; q < sub; ++q) acc += row[j * sub + q];
      pyr[parts + j] = acc;
    }
  }
  if (lane <= kMaxPorder) lv->bits[lane] = lv->wide[lane] = 0;
  __syncwarp();
  for (int p = ps - 1; p >= 0; --p) {
    for (int i = (1 << p) + lane; i < (2 << p); i += 32)
      pyr[i] = pyr[2 * i] + pyr[2 * i + 1];
    __syncwarp();
  }
  const int o = order[r];
  int lo, hi;
  level_range(n, o, pmin, pmax, ub, ps, lo, hi);
  scan_slots(pyr, ks, lv, ps, n, o, lo, hi, lane, 32);
  __syncwarp();
  const Choice c = pick_level(lv, lo, hi);
  if (lane == 0) {
    bits_out[r] = c.bits;
    porder_out[r] = c.porder;
    method_out[r] = c.method;
  }
  write_params(params + static_cast<long long>(r) * parts, ks, parts, c,
               lane, 32);
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

// R2: one block of kThreads a stream. Dynamic shared memory: the pyramid
// (heap_size(ps) uint64), the sample tile with its halo (kTaps + 4 kThreads
// int32), the zigzag row (n uint32, when n <= kZigCap) and the k bytes.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    final_pass_kernel(const int* __restrict__ smp,
                      const int* __restrict__ coefs,
                      const int* __restrict__ shift,
                      const int* __restrict__ order, int* res,
                      unsigned char* __restrict__ fits,
                      long long* __restrict__ bits_out,
                      int* __restrict__ porder_out,
                      int* __restrict__ method_out, int* __restrict__ params,
                      long long* __restrict__ exact_out, int n, int taps,
                      int pmin, int pmax, int ps, int ub) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kTile = 4 * kThreads;
  extern __shared__ u64 final_smem[];
  __shared__ u64 quot_s[kWarps];
  __shared__ unsigned ovh_s[kWarps];
  __shared__ Levels lv;
  __shared__ Choice choice;
  const int size = heap_size(ps);
  const bool zig_shared = n <= kZigCap;
  u64* pyr = final_smem;
  int* xs = reinterpret_cast<int*>(pyr + size);
  unsigned* zs = reinterpret_cast<unsigned*>(xs + kTaps + kTile);
  unsigned char* ks =
      reinterpret_cast<unsigned char*>(zs + (zig_shared ? n : 0));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long s = blockIdx.x;
  const int* x = smp + s * n;
  int* row = res + s * n;
  const int o = order[s], sh = shift[s];
  const int nt = min(o, taps);              // taps that add
  int c[kTaps];
#pragma unroll
  for (int j = 0; j < kTaps; ++j) c[j] = j < nt ? coefs[s * taps + j] : 0;
  if (tid <= kMaxPorder) lv.bits[tid] = lv.wide[tid] = 0;

  // the residual, a tile at a time; xs[kTaps + q] is sample t0 + q
  bool fit = true;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int len = min(kTile, n - t0);
    for (int q = tid; q < kTaps + len; q += kThreads) {
      const int i = t0 - kTaps + q;
      xs[q] = i >= 0 ? x[i] : 0;
    }
    __syncthreads();
    // a thread's four outputs of the tile, q = tid + m kThreads, in four
    // independent chains (outputs past the tile's end are dropped)
    long long acc[4] = {0, 0, 0, 0};
    const int* lag = xs + kTaps + tid - 1;
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      if (j == nt) break;
#pragma unroll
      for (int m = 0; m < 4; ++m)
        acc[m] += static_cast<long long>(c[j]) * lag[m * kThreads - j];
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int q = tid + m * kThreads, i = t0 + q;
      if (q >= len) break;
      const int xi = xs[kTaps + q];
      int r = xi;
      if (i >= o) {
        const long long r64 = xi - (acc[m] >> sh);
        r = static_cast<int>(static_cast<unsigned>(r64));
        fit &= r64 == r;
      }
      row[i] = r;
      if (zig_shared) zs[i] = i >= o ? zigzag(r) : 0u;
    }
    __syncthreads();
  }
  fit = __syncthreads_and(fit);

  // the zigzag value of sample i, warm-up zeroed: from shared memory, or
  // from the residual this block wrote (visible after the barrier above)
  auto zig_at = [&](int i) -> unsigned {
    if (zig_shared) return zs[i];
    return i >= o ? zigzag(row[i]) : 0u;
  };

  const Shares shares = shares_of<kThreads>(n, ps, tid);
  partition_sums<kThreads>(pyr, quot_s, shares, zig_at, n, ps, tid);
  int lo, hi;
  level_range(n, o, pmin, pmax, ub, ps, lo, hi);
  scan_slots(pyr, ks, &lv, ps, n, o, lo, hi, tid, kThreads);
  __syncthreads();
  if (tid == 0) choice = pick_level(&lv, lo, hi);
  __syncthreads();
  const Choice ch = choice;

  // the exact pass over the same shares: (z >> k) + 1 + k for each sample
  // past the warm-up, k the chosen level's parameter of the sample's
  // partition (0 where no level was in range)
  u64 quot = 0;
  unsigned ovh = 0;
  const int parts = 1 << ps, psize = n >> ps;
  for (int j = shares.part; j < parts; j += shares.groups) {
    const int k = ch.taken ? ks[(1 << ch.porder) + (j >> (ps - ch.porder))]
                           : 0;
    const int a = j * psize + shares.from;
    for (int q = 0, r = shares.len ? lane % shares.len : 0; q < shares.len;
         ++q) {
      quot += zig_at(a + r) >> k;
      r = r + 1 == shares.len ? 0 : r + 1;
    }
    ovh += max(0, a + shares.len - max(a, o)) * (1 + k);
  }
  quot = warp_sum(quot);
  ovh = warp_sum(ovh);
  if (lane == 0) {
    quot_s[warp] = quot;
    ovh_s[warp] = ovh;
  }
  __syncthreads();
  if (tid == 0) {
    u64 total_bits = static_cast<u64>(4 + ch.method) << ch.porder;
    for (int w = 0; w < kWarps; ++w) total_bits += quot_s[w] + ovh_s[w];
    bits_out[s] = ch.bits;
    porder_out[s] = ch.porder;
    method_out[s] = ch.method;
    exact_out[s] = static_cast<long long>(total_bits);
    fits[s] = fit ? 1 : 0;
  }
  write_params(params + s * parts, ks, parts, ch, tid, kThreads);
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

template <int kThreads>
int launch_final(const int* smp, const int* coefs, const int* shift,
                 const int* order, int* res, unsigned char* fits,
                 long long* bits, int* porder, int* method, int* params,
                 long long* exact, int N, int n, int taps, int pmin, int pmax,
                 int ps, int ub, cudaStream_t stream) {
  const size_t smem = heap_size(ps) * (sizeof(u64) + 1) +
                      (kTaps + 4 * kThreads) * sizeof(int) +
                      (n <= kZigCap ? n * sizeof(unsigned) : 0);
  final_pass_kernel<kThreads><<<N, kThreads, smem, stream>>>(
      smp, coefs, shift, order, res, fits, bits, porder, method, params,
      exact, n, taps, pmin, pmax, ps, ub);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// R1. sums int64 [R, G] (G = 2^ps x sub: finer sums are folded here),
// order int32 [R] -> bits int64 [R] (the uint32 value), porder, method
// int32 [R], params int32 [R, 2^ps]. ps = limit_max_partition_order(pmax,
// n, 1) <= 8 and ub = log2i(n ^ (n - 1)), from the caller, who checks the
// shapes.
extern "C" int flake_rice_scan(const long long* sums, const int* order,
                               long long* bits, int* porder, int* method,
                               int* params, int R, int G, int n, int pmin,
                               int pmax, int ps, int ub,
                               cudaStream_t stream) {
  if (R > 0)
    rice_scan_kernel<<<(R + kScanWarps - 1) / kScanWarps, kScanWarps * 32,
                       kScanWarps * (heap_size(ps) * (sizeof(u64) + 1) +
                                     sizeof(Levels)),
                       stream>>>(sums, order, bits, porder, method, params, R,
                                 G, n, pmin, pmax, ps, ub);
  return static_cast<int>(cudaGetLastError());
}

// R2. smp int32 [N, n], coefs int32 [N, taps] (taps <= 32), shift and
// order int32 [N] -> res int32 [N, n], fits uint8 [N] (0 or 1), bits int64,
// porder, method int32 [N], params int32 [N, 2^ps], exact int64 [N]; n a
// multiple of 2^ps (limit_max_partition_order guarantees it), ps and ub as
// for R1; threads 128, 256 or 512 a block (the package takes 256).
extern "C" int flake_final_pass(const int* smp, const int* coefs,
                                const int* shift, const int* order, int* res,
                                unsigned char* fits, long long* bits,
                                int* porder, int* method, int* params,
                                long long* exact, int N, int taps, int n,
                                int pmin, int pmax, int ps, int ub,
                                int threads, cudaStream_t stream) {
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  switch (threads) {
    case 128:
      return launch_final<128>(smp, coefs, shift, order, res, fits, bits,
                               porder, method, params, exact, N, n, taps,
                               pmin, pmax, ps, ub, stream);
    case 256:
      return launch_final<256>(smp, coefs, shift, order, res, fits, bits,
                               porder, method, params, exact, N, n, taps,
                               pmin, pmax, ps, ub, stream);
    case 512:
      return launch_final<512>(smp, coefs, shift, order, res, fits, bits,
                               porder, method, params, exact, N, n, taps,
                               pmin, pmax, ps, ub, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// X. smp int32 [N, n], obits int32 [N] -> order int32 [N] (the FIXED
// order of the least estimated bits, min_o..max_o, 0 <= min_o <= max_o <=
// 4) and coefs int32 [N, taps] (its predictor's coefficients, zero-padded;
// max_o <= taps <= 4); n a multiple of 2^ps, ps and ub as for R1.
extern "C" int flake_fixed_search(const int* smp, const int* obits,
                                  int* order, int* coefs, int N, int n,
                                  int min_o, int max_o, int taps, int pmin,
                                  int pmax, int ps, int ub,
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
