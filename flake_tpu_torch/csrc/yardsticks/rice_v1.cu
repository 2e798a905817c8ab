// The first designs of R1 and R2, kept unchanged apart from the entry
// points' names, only as yardsticks: chip_smoke.py builds them beside the
// current designs (../rice.cu) and times both on the same inputs in one
// run, R2's first design after the torch lag loop that gave it its
// residual (ops/predict.residual_lpc_dynamic64). No path of the package
// calls them; they are not part of the package's kernel library
// (flake_tpu_torch/_cuda.py builds csrc/*.cu only).
//
// R1 and R2: the Rice partition-order and parameter search.
//
// No Pallas kernel stands behind these two. The JAX package writes the
// search as tensor expressions inside one jitted program, where XLA fuses
// the 31-wide k grid into its argmin and min; the eager port built every
// step of that grid as a full int64 tensor, and at a level-12 batch
// (32,768 rows of 256 partitions) three such 2 GiB temporaries were alive
// at once. These kernels hold nothing in device memory but their outputs.
//
// R1, flake_rice_scan, replaces flake_tpu/ops/rice.py: _fold_pyramid,
// _dynamic_porder_scan and find_optimal_k_u32 (rice.py:213-277, :109),
// which the JAX package reaches through subframe_bits_from_limbs: from one
// row's partition sums (K2's or K4's, folded to 2^ps partitions here), the
// sums of every partition order 0..ps, the k = 0..30 scan of every
// partition (rice.c:30-45, rice.h:48) and the partition-order scan with
// per-row clamps (rice.c:105-139, 148-155, 163-164).
// R2, flake_rice_final, replaces calc_rice_params_dynamic (rice.py:314-376):
// the zigzag residual of one stream (rice.h wraps it at |r| >= 2^30) with
// its warm-up samples zeroed, its partition sums, R1's scan, then the exact
// Rice bits of the winning parameters: the sum over samples past the
// warm-up of (z >> k) + 1 + k, plus (4 + method) bits a partition.
//
// Arithmetic, bit for bit the JAX package's: its limb form of the count,
// cnt32 * (k + 1) + low32((s - (cnt >> 1)) >> k) in uint32, is the
// cheap form here too: the 64-bit difference splits into two 32-bit
// halves, and one funnel shift gives bits k..k+31. The k scan keeps the
// first minimum (strict <, jnp.argmin); a level's bits are the uint32 sum
// of its partitions' counts plus 4 a partition (a sum mod 2^32 is the low
// 32 bits of the 64-bit sum); the level scan starts at 0xFFFFFFFF and
// takes a level whose bits are <= the best so far, so a tie goes to the
// higher order (rice.c:131).
//
// What bounds them on the card: R1 does 31 count evaluations of about six
// int32 operations for each partition of each level (511 a row at ps = 8)
// against 8 bytes read a finest partition, so operations. Design: one warp
// a row. The warp folds the row into a pyramid of 64-bit sums in shared
// memory (level p's partition j at (1 << p) - 1 + j), then every lane
// scans 1/32 of the pyramid's partitions, all levels flat, so no lane
// idles at the small levels; k and the count go to shared memory, and
// the warp reduces each level with shuffles and picks the order. R2 reads
// its stream twice (the sums, then the exact pass), a few KiB to 256 KiB a
// row (blocks up to 65,535 samples do not fit shared memory), the second
// time from L2; it is bound by its bytes. One block of 256 threads a
// stream: the partition sums a warp a partition (or several warps a
// partition when there are fewer partitions than warps), the same
// pyramid, the k scan spread over the block, the level pick by warp 0
// (the device function R1's warp runs), and the exact pass over the same
// mapping.

#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr int kMaxPorder = 8;                    // params.MAX_PARTITION_ORDER
constexpr int kPyramid = (2 << kMaxPorder) - 1;  // partitions of levels 0..8
constexpr int kMaxK = 30;                        // params.MAX_RICE_PARAM
constexpr int kMaxK4bit = 14;                    // params.MAX_RICE_PARAM_4BIT
constexpr int kScanWarps = 4;                    // R1: rows a block
constexpr int kFinalThreads = 256;               // R2: one block a stream
constexpr int kFinalWarps = kFinalThreads / 32;

// level p's partitions start at (1 << p) - 1 in a pyramid
__device__ __forceinline__ int level_at(int p) { return (1 << p) - 1; }

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

// the k scan of one partition of sum s and count cnt (cnt is negative
// where the warm-up exceeds the partition; its low 32 bits and those of
// cnt >> 1 are the JAX package's uint64 ones): returns the first k of the
// least count, and that count in kb
__device__ __forceinline__ int best_k(u64 s, int cnt, unsigned& kb) {
  const unsigned cnt32 = static_cast<unsigned>(cnt);
  const u64 t = s - static_cast<u64>(static_cast<unsigned>(cnt >> 1));
  const unsigned lo = static_cast<unsigned>(t);
  const unsigned hi = static_cast<unsigned>(t >> 32);
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

// the k scan of every partition of levels 0..ps of the pyramid, by
// `threads` threads from `tid`: k to ks, its count to kb, at the
// partition's place; partition 0 of each level holds the warm-up
__device__ __forceinline__ void scan_pyramid(const u64* pyr,
                                             unsigned char* ks, unsigned* kb,
                                             int ps, int n, int order,
                                             int tid, int threads) {
  const int total = (2 << ps) - 1;
  for (int i = tid; i < total; i += threads) {
    const int p = 31 - __clz(i + 1);
    const int cnt = (n >> p) - (i == level_at(p) ? order : 0);
    ks[i] = static_cast<unsigned char>(best_k(pyr[i], cnt, kb[i]));
  }
}

struct Choice {
  unsigned bits;
  int porder;
  int method;
};

// The per-level scan, by one warp, all lanes alike: each level's bits
// (uint32 sum of its counts + 4 a partition) and method (a k above 14),
// then the pick among levels pmin_eff..pmax_eff, ascending from a best of
// 0xFFFFFFFF, taking a level whose bits are <= the best. The clamps are
// rice.c:148-155's: log2(n ^ (n - 1)) (ub, from the caller) and, where the
// order is positive, log2(n / order).
__device__ Choice pick_level(const unsigned char* ks, const unsigned* kb,
                             int ps, int n, int order, int pmin, int pmax,
                             int ub, int lane) {
  int lo = min(pmin, ub), hi = min(pmax, ub);
  if (order > 0) {
    const int q = n / order;
    const int log2_no = q > 0 ? 31 - __clz(q) : 0;
    lo = min(lo, log2_no);
    hi = min(hi, log2_no);
  }
  Choice best = {0xFFFFFFFFu, 0, 0};
  for (int p = 0; p <= ps; ++p) {
    const int at = level_at(p);
    unsigned acc = 0;
    int method = 0;
    for (int j = lane; j < (1 << p); j += 32) {
      acc += kb[at + j];
      method |= ks[at + j] > kMaxK4bit;
    }
    acc = warp_sum(acc);
    method = __any_sync(0xffffffffu, method) ? 1 : 0;
    const unsigned bits = acc + (4u << p);
    if (p >= lo && p <= hi && bits <= best.bits) best = {bits, p, method};
  }
  return best;
}

// params: the chosen level's k for its partitions, zero beyond
__device__ __forceinline__ void write_params(int* row_params,
                                            const unsigned char* ks,
                                            int parts, int porder, int tid,
                                            int threads) {
  const int at = level_at(porder), used = 1 << porder;
  for (int j = tid; j < parts; j += threads)
    row_params[j] = j < used ? ks[at + j] : 0;
}

__global__ void __launch_bounds__(kScanWarps * 32)
    rice_scan_kernel(const long long* __restrict__ sums,
                     const int* __restrict__ order,
                     long long* __restrict__ bits_out,
                     int* __restrict__ porder_out,
                     int* __restrict__ method_out,
                     int* __restrict__ params, int R, int G, int n, int pmin,
                     int pmax, int ps, int ub) {
  __shared__ u64 pyr_s[kScanWarps][kPyramid];
  __shared__ unsigned kb_s[kScanWarps][kPyramid];
  __shared__ unsigned char ks_s[kScanWarps][kPyramid + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kScanWarps + warp;
  if (r >= R) return;                       // a whole warp
  u64* pyr = pyr_s[warp];
  unsigned* kb = kb_s[warp];
  unsigned char* ks = ks_s[warp];
  const int parts = 1 << ps, sub = G >> ps;
  const u64* row = reinterpret_cast<const u64*>(sums) +
                   static_cast<long long>(r) * G;
  const int top = level_at(ps);
  for (int j = lane; j < parts; j += 32) {
    u64 acc = 0;
    for (int q = 0; q < sub; ++q) acc += row[j * sub + q];
    pyr[top + j] = acc;
  }
  __syncwarp();
  for (int p = ps - 1; p >= 0; --p) {
    const int at = level_at(p), up = level_at(p + 1);
    for (int j = lane; j < (1 << p); j += 32)
      pyr[at + j] = pyr[up + 2 * j] + pyr[up + 2 * j + 1];
    __syncwarp();
  }
  const int o = order[r];
  scan_pyramid(pyr, ks, kb, ps, n, o, lane, 32);
  __syncwarp();
  const Choice c = pick_level(ks, kb, ps, n, o, pmin, pmax, ub, lane);
  if (lane == 0) {
    bits_out[r] = c.bits;
    porder_out[r] = c.porder;
    method_out[r] = c.method;
  }
  write_params(params + static_cast<long long>(r) * parts, ks, parts,
               c.porder, lane, 32);
}

__global__ void __launch_bounds__(kFinalThreads)
    rice_final_kernel(const int* __restrict__ res,
                      const int* __restrict__ order,
                      long long* __restrict__ bits_out,
                      int* __restrict__ porder_out,
                      int* __restrict__ method_out, int* __restrict__ params,
                      long long* __restrict__ exact_out, int n, int pmin,
                      int pmax, int ps, int ub) {
  __shared__ u64 pyr[kPyramid];
  __shared__ unsigned kb[kPyramid];
  __shared__ unsigned char ks[kPyramid + 1];
  __shared__ u64 quot_s[kFinalWarps];
  __shared__ unsigned ovh_s[kFinalWarps];
  __shared__ Choice choice;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long s = blockIdx.x;
  const int* row = res + s * n;
  const int o = order[s];
  const int parts = 1 << ps, psize = n >> ps, top = level_at(ps);
  // warps a partition: 1 from 8 partitions up, else 8 / parts (a power of
  // two); a group's lanes stride over its partition's samples
  const int wpp = parts < kFinalWarps ? kFinalWarps / parts : 1;
  const int group = warp / wpp, groups = kFinalWarps / wpp;
  const int lane_in = (warp % wpp) * 32 + lane, stride = wpp * 32;

  // partition sums of the zigzag residual at ps, warm-up samples zeroed;
  // with several warps a partition each warp's share goes to quot_s first
  for (int j = group; j < parts; j += groups) {
    u64 acc = 0;
    const int end = (j + 1) * psize;
    for (int i = j * psize + lane_in; i < end; i += stride)
      if (i >= o) acc += zigzag(row[i]);
    acc = warp_sum(acc);
    if (lane == 0) {
      if (wpp == 1)
        pyr[top + j] = acc;
      else
        quot_s[warp] = acc;
    }
  }
  __syncthreads();
  if (wpp > 1 && tid < parts) {
    u64 acc = 0;
    for (int w = 0; w < wpp; ++w) acc += quot_s[tid * wpp + w];
    pyr[top + tid] = acc;
  }
  __syncthreads();
  for (int p = ps - 1; p >= 0; --p) {
    const int at = level_at(p), up = level_at(p + 1);
    for (int j = tid; j < (1 << p); j += kFinalThreads)
      pyr[at + j] = pyr[up + 2 * j] + pyr[up + 2 * j + 1];
    __syncthreads();
  }
  scan_pyramid(pyr, ks, kb, ps, n, o, tid, kFinalThreads);
  __syncthreads();
  if (warp == 0) {
    const Choice c = pick_level(ks, kb, ps, n, o, pmin, pmax, ub, lane);
    if (lane == 0) choice = c;
  }
  __syncthreads();
  const Choice c = choice;

  // the exact pass: (z >> k) + 1 + k for each sample past the warm-up, k
  // the chosen level's parameter of the sample's partition
  const int at = level_at(c.porder), up_shift = ps - c.porder;
  u64 quot = 0;
  unsigned ovh = 0;
  for (int j = group; j < parts; j += groups) {
    const int k = ks[at + (j >> up_shift)];
    const int end = (j + 1) * psize;
    for (int i = j * psize + lane_in; i < end; i += stride)
      if (i >= o) {
        quot += zigzag(row[i]) >> k;
        ovh += 1 + k;
      }
  }
  quot = warp_sum(quot);
  ovh = warp_sum(ovh);
  if (lane == 0) {
    quot_s[warp] = quot;
    ovh_s[warp] = ovh;
  }
  __syncthreads();
  if (tid == 0) {
    u64 total = static_cast<u64>(4 + c.method) << c.porder;
    for (int w = 0; w < kFinalWarps; ++w) total += quot_s[w] + ovh_s[w];
    bits_out[s] = c.bits;
    porder_out[s] = c.porder;
    method_out[s] = c.method;
    exact_out[s] = static_cast<long long>(total);
  }
  write_params(params + s * parts, ks, parts, c.porder, tid, kFinalThreads);
}

}  // namespace

// R1. sums int64 [R, G] (G = 2^ps x sub: finer sums are folded here),
// order int32 [R] -> bits int64 [R] (the uint32 value), porder, method
// int32 [R], params int32 [R, 2^ps]. ps = limit_max_partition_order(pmax,
// n, 1) <= 8 and ub = log2i(n ^ (n - 1)), from the caller, who checks the
// shapes.
extern "C" int flake_rice_scan_v1(const long long* sums, const int* order,
                                  long long* bits, int* porder, int* method,
                                  int* params, int R, int G, int n, int pmin,
                                  int pmax, int ps, int ub,
                                  cudaStream_t stream) {
  if (R > 0)
    rice_scan_kernel<<<(R + kScanWarps - 1) / kScanWarps, kScanWarps * 32, 0,
                       stream>>>(sums, order, bits, porder, method, params, R,
                                 G, n, pmin, pmax, ps, ub);
  return static_cast<int>(cudaGetLastError());
}

// R2. res int32 [N, n], order int32 [N] -> bits int64, porder, method
// int32 [N], params int32 [N, 2^ps], exact int64 [N]; n a multiple of 2^ps
// (limit_max_partition_order guarantees it), ps and ub as for R1.
extern "C" int flake_rice_final_v1(const int* res, const int* order,
                                   long long* bits, int* porder, int* method,
                                   int* params, long long* exact, int N, int n,
                                   int pmin, int pmax, int ps, int ub,
                                   cudaStream_t stream) {
  if (N > 0)
    rice_final_kernel<<<N, kFinalThreads, 0, stream>>>(
        res, order, bits, porder, method, params, exact, n, pmin, pmax, ps,
        ub);
  return static_cast<int>(cudaGetLastError());
}
