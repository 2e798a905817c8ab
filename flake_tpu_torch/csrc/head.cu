// H: the frame head, everything the analysis does to a frame before its
// prediction, in one launch: the stereo mode and decorrelation, the wasted
// bits and the constant flags.
//
// No Pallas kernel stands behind it. The JAX package writes these stages as
// tensor code inside its one jitted analysis program
// (flake_tpu/ops/frame.py:279-305: stereo.decorr_mode, stereo.apply_decorr,
// wasted.remove_wasted_bits and the constant test), where XLA fuses them.
// The port's plain version (ops/frame.frame_head_plain) runs them eagerly,
// about 130 small launches a batch.
//
// Arithmetic, the plain version's. The mode estimate (encode.c:598-643):
// the four int64 abs-sums of the second differences from sample 2 on (left,
// right, (l + r) >> 1 of the differences, l - r), doubled; per sum the first
// k of the least int64 count u32(n (k + 1) + ((s - (n >> 1)) >> k)) over k =
// 0..30 (stereo.mode_from_sums with find_optimal_k, not the u32 form); the
// first minimum of L+R, L+S, R+S, M+S. At 32 bits a side mode is vetoed
// where max |l - r| >= 2^31. Mid is (l + r) >> 1 in int64, the side l - r
// wrapped to int32, a side channel one more output bit. Wasted bits
// (encode.c:558-593): the trailing zeros of the OR of a channel's samples,
// 32 where all are 0, capped at bps - 1, and a count of exactly bps - 1 is
// 0; the samples shift right by it. A channel is constant where every sample
// equals its first (where the OR and the AND of its samples both equal
// it): before the shift, which drops only zero bits, the same test. At 16
// bits and under, mid, the differences and each thread's sums run in 32
// bits, exact for samples within bps bits; the pass also ORs every
// sample's offset from -2^(bps-1), and a frame with a sample outside bps
// bits takes the statistics again in int64, so that every int32 input
// gives the plain version's outputs.
//
// What bounds it on the card: bytes, the samples read once and the channels
// written once (4 + 4 bytes a sample; 33.6 MB on the level-8 batch of 512
// frames of 4,096 stereo samples), the work a few integer operations a
// sample. Design: one block of 256 a frame, which reads its frame once: the
// bulk copy engine stages it in shared memory (cp.async.bulk in chunks of
// kChunk bytes, each completing on its own mbarrier, so that the statistics
// start on the first chunk while the rest arrive) where it starts on a
// 16-byte boundary, int4 loads where it does not. One pass over shared
// memory gathers every statistic at once: under the stereo estimate the
// four abs-sums, the 32-bit veto's max |l - r| and, for each of the four
// channels a mode can give (L, R, M, S), the OR and the AND of its
// samples, two samples an int4 read; otherwise the OR and the AND of each
// channel. Warp 0 folds the warps' partials and picks the mode, the shifts
// and the constant flags, and one store pass writes [C, n] from shared
// memory, four samples a thread with aligned int4 stores where n is a
// multiple of 4. A frame larger than kStageCap (65,535 stereo samples, 8
// channels of 8,192) takes the same statistics straight from device memory
// and reads it again for the store.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 30;                        // params.MAX_RICE_PARAM
constexpr int kMaxC = 8;                         // FLAC's channels
constexpr unsigned kFull = 0xffffffffu;
// a frame of at most this many bytes is staged in shared memory
constexpr int kStageCap = 200 * 1024;
// bytes a bulk copy, each completing on its own mbarrier, so that the
// statistics start on the first while the rest arrive
constexpr int kChunk = 8 * 1024;
constexpr int kMaxChunks = kStageCap / kChunk + 1;

// stereo modes (ops/stereo.py)
constexpr int kNotStereo = 0;
constexpr int kLeftRight = 1;
constexpr int kLeftSide = 8;
constexpr int kRightSide = 9;
constexpr int kMidSide = 10;

// the statistics' channels under the stereo estimate
constexpr int kL = 0, kR = 1, kM = 2, kS = 3;

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ long long warp_max(long long v) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    v = max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// _rice_count (rice.h:48) in int64, truncated to uint32
__device__ __forceinline__ long long rice_count(long long s, long long cnt,
                                                int k) {
  return (cnt * (k + 1) + ((s - (cnt >> 1)) >> k)) & 0xFFFFFFFFll;
}

// stereo.mode_from_sums on the four sums of one frame, by a whole warp:
// lane k counts parameter k, and the least count (a uint32) is one
// reduction
__device__ int mode_from_sums(const long long* sums, int n, int lane) {
  long long est[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    est[c] = __reduce_min_sync(
        kFull, lane <= kMaxK
                   ? static_cast<unsigned>(rice_count(2 * sums[c], n, lane))
                   : 0xFFFFFFFFu);
  // the first least of L+R, L+S, R+S, M+S (no array indexed at run time,
  // which would sit in local memory)
  long long best = est[0] + est[1];
  int mode = kLeftRight;
  if (est[0] + est[3] < best) {
    best = est[0] + est[3];
    mode = kLeftSide;
  }
  if (est[1] + est[3] < best) {
    best = est[1] + est[3];
    mode = kRightSide;
  }
  if (est[2] + est[3] < best) mode = kMidSide;
  return mode;
}

__device__ __forceinline__ int mid_of(int l, int r) {
  return static_cast<int>((static_cast<long long>(l) + r) >> 1);
}

__device__ __forceinline__ int side_of(int l, int r) {
  return static_cast<int>(static_cast<unsigned>(l) -
                          static_cast<unsigned>(r));
}

// statistics channel `src` (kL, kR, kM or kS) of the stereo sample (l, r)
__device__ __forceinline__ int stereo_value(int src, int l, int r) {
  return src == kL ? l : src == kR ? r : src == kM ? mid_of(l, r)
                                                   : side_of(l, r);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread's statistics of its samples: per channel the OR and the AND of
// its samples (a channel is constant where both equal its first sample,
// and its wasted bits are the trailing zeros of the OR), the four abs-sums,
// the veto's max |l - r| and, on a narrow pass, the OR of every sample's
// offset from -2^(bps-1) (a sample outside bps bits sets a bit at bps or
// above)
template <int kC, bool kEst, bool kWide>
struct Stats {
  static constexpr int kN = kC == 2 && kEst ? 4 : kC;
  using Sum = typename std::conditional<kWide, long long, unsigned>::type;
  unsigned orv[kN], andv[kN];
  Sum sum[4];
  long long over;
  unsigned range, half;

  __device__ explicit Stats(int bps)
      : over(0), range(0), half(1u << (bps - 1)) {
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      orv[c] = 0;
      andv[c] = ~0u;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) sum[c] = 0;
  }

  __device__ __forceinline__ void take(int c, int a, int b) {
    orv[c] |= static_cast<unsigned>(a | b);
    andv[c] &= static_cast<unsigned>(a & b);
  }

  // a sample of every channel, x[c] its channel c
  __device__ __forceinline__ void sample(const int* x) {
#pragma unroll
    for (int c = 0; c < kC; ++c) take(c, x[c], x[c]);
  }

  // l + r fits int32 for samples within 16 bits (a narrow pass that sees
  // one outside them is taken again wide)
  __device__ __forceinline__ int mid(int l, int r) {
    return kWide ? mid_of(l, r) : (l + r) >> 1;
  }

  // two stereo samples (a single one twice)
  __device__ __forceinline__ void stereo(int la, int ra, int lb, int rb) {
    take(kL, la, lb);
    take(kR, ra, rb);
    if constexpr (kEst) {
      take(kM, mid(la, ra), mid(lb, rb));
      take(kS, side_of(la, ra), side_of(lb, rb));
      if (kWide)
        over = max(over, max(llabs(static_cast<long long>(la) - ra),
                             llabs(static_cast<long long>(lb) - rb)));
      else
        range |= (static_cast<unsigned>(la) + half) |
                 (static_cast<unsigned>(ra) + half) |
                 (static_cast<unsigned>(lb) + half) |
                 (static_cast<unsigned>(rb) + half);
    }
  }

  // the four abs-sum terms of a stereo sample from sample 2 on, (l1, r1)
  // the sample before it and (l2, r2) the one before that
  __device__ __forceinline__ void terms(int l, int r, int l1, int r1, int l2,
                                        int r2, Sum* t) {
    if (kWide) {
      const long long lt = static_cast<long long>(l) - 2ll * l1 + l2;
      const long long rt = static_cast<long long>(r) - 2ll * r1 + r2;
      t[0] = llabs(lt);
      t[1] = llabs(rt);
      t[2] = llabs((lt + rt) >> 1);
      t[3] = llabs(lt - rt);
    } else {
      const int lt = l - 2 * l1 + l2, rt = r - 2 * r1 + r2;
      t[0] = abs(lt);
      t[1] = abs(rt);
      t[2] = abs((lt + rt) >> 1);
      t[3] = abs(lt - rt);
    }
  }

  __device__ __forceinline__ void second(int l, int r, int l1, int r1, int l2,
                                         int r2) {
    Sum t[4];
    terms(l, r, l1, r1, l2, r2, t);
#pragma unroll
    for (int c = 0; c < 4; ++c) sum[c] += t[c];
  }

  // two consecutive samples a, b, (l1, r1) and (l2, r2) the two before a
  __device__ __forceinline__ void second2(int la, int ra, int lb, int rb,
                                          int l1, int r1, int l2, int r2) {
    Sum ta[4], tb[4];
    terms(la, ra, l1, r1, l2, r2, ta);
    terms(lb, rb, la, ra, l1, r1, tb);
#pragma unroll
    for (int c = 0; c < 4; ++c) sum[c] += ta[c] + tb[c];
  }
};

// the warps' partials, and the block's totals
struct Partials {
  unsigned orv[kWarps][kMaxC], andv[kWarps][kMaxC], range[kWarps];
  long long sum[kWarps][4], over[kWarps];
};

struct Totals {
  unsigned orv[kMaxC], andv[kMaxC];
  long long sum[4], over;
  int bad;
};

__device__ __forceinline__ void wait_chunk(uint64_t* bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
}

// every statistic of the frame x ([n, kC]: in shared memory, bulk chunk k
// complete once bars[k] is, for k < chunks; or in device memory), folded
// over the block into tot by warp 0. tot.bad: a narrow pass saw a sample
// outside bps bits.
template <int kC, bool kEst, bool kWide, bool kPairs>
__device__ void gather(const int* x, int n, int bps, uint64_t* bars,
                       int chunks, Partials& part, Totals& tot) {
  using S = Stats<kC, kEst, kWide>;
  constexpr int kN = S::kN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  S st(bps);
  if constexpr (kC == 2 && kPairs) {
    // two samples an int4 (x is 16-byte aligned), a bulk chunk at a time
    // as each arrives; the pair before gives the second differences, from
    // sample 2 on
    const int4* x4 = reinterpret_cast<const int4*>(x);
    constexpr int kPer = kChunk / 16;            // pairs a chunk
    for (int k = 0; k * kPer < n / 2; ++k) {
      if (k < chunks) wait_chunk(bars + k);
      const int end = min(n / 2, (k + 1) * kPer);
      for (int p = k * kPer + tid; p < end; p += kThreads) {
        const int4 q = x4[p];
        st.stereo(q.x, q.y, q.z, q.w);
        if (kEst && p > 0) {
          const int4 o = x4[p - 1];
          st.second2(q.x, q.y, q.z, q.w, o.z, o.w, o.x, o.y);
        }
      }
    }
    if ((n & 1) && tid == kThreads - 1) {
      const int i = n - 1;
      st.stereo(x[2 * i], x[2 * i + 1], x[2 * i], x[2 * i + 1]);
      if (kEst && i >= 2)
        st.second(x[2 * i], x[2 * i + 1], x[2 * i - 2], x[2 * i - 1],
                  x[2 * i - 4], x[2 * i - 3]);
    }
  } else {
    for (int k = 0; k < chunks; ++k) wait_chunk(bars + k);
    for (int i = tid; i < n; i += kThreads) {
      const int* s = x + static_cast<long long>(i) * kC;
      if constexpr (kC == 2) {
        st.stereo(s[0], s[1], s[0], s[1]);
        if (kEst && i >= 2) st.second(s[0], s[1], s[-2], s[-1], s[-4], s[-3]);
      } else {
        st.sample(s);
      }
    }
  }

  // the warps' partials
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    st.orv[c] = __reduce_or_sync(kFull, st.orv[c]);
    st.andv[c] = __reduce_and_sync(kFull, st.andv[c]);
  }
  long long sums[4] = {0, 0, 0, 0};
  long long over = 0;
  unsigned range = 0;
  if (kEst) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      sums[c] = kWide ? warp_sum(static_cast<long long>(st.sum[c]))
                      : static_cast<long long>(__reduce_add_sync(
                            kFull, static_cast<unsigned>(st.sum[c])));
    if (kWide)
      over = warp_max(st.over);
    else
      range = __reduce_or_sync(kFull, st.range);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      part.orv[warp][c] = st.orv[c];
      part.andv[warp][c] = st.andv[c];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) part.sum[warp][c] = sums[c];
    part.over[warp] = over;
    part.range[warp] = range;
  }
  __syncthreads();
  if (warp != 0) return;

  // warp 0: lane w folds in warp w's partials
  const bool has = lane < kWarps;
#pragma unroll
  for (int c = 0; c < kN; ++c) {
    const unsigned o = __reduce_or_sync(kFull, has ? part.orv[lane][c] : 0u);
    const unsigned a =
        __reduce_and_sync(kFull, has ? part.andv[lane][c] : ~0u);
    if (lane == 0) {
      tot.orv[c] = o;
      tot.andv[c] = a;
    }
  }
  if (lane == 0) tot.bad = 0;
  if (kEst) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const long long v = warp_sum(has ? part.sum[lane][c] : 0);
      if (lane == 0) tot.sum[c] = v;
    }
    over = warp_max(has ? part.over[lane] : 0);
    range = __reduce_or_sync(kFull, has ? part.range[lane] : 0u);
    if (lane == 0) {
      tot.over = over;
      tot.bad = !kWide && (range >> bps);
    }
  }
}

// start staging `count` ints at src into dst (16-byte aligned shared
// memory). From a 16-byte boundary: bulk copies of kChunk bytes, chunk k
// complete once bars[k] completes, the ragged end by the threads; returns
// the chunks. Otherwise int4 loads, all in place on return (0 chunks).
__device__ int stage(int* dst, const int* src, int count, uint64_t* bars) {
  const int tid = threadIdx.x;
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if ((a & 15) == 0) {
    const int bytes = (count & ~3) * 4;          // whole 16-byte units
    const int chunks = (bytes + kChunk - 1) / kChunk;
    // one thread makes the barriers and issues every copy at once, with no
    // block barrier before the first (the one below makes the barriers
    // visible before any other thread waits on them)
    if (tid == 0) {
      for (int k = 0; k < chunks; ++k)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                         smem_addr(bars + k))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int k = 0; k < chunks; ++k) {
        const int off = k * kChunk, len = min(kChunk, bytes - off);
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                smem_addr(bars + k)),
            "r"(len)
            : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst + off / 4)),
            "l"(src + off / 4), "r"(len), "r"(smem_addr(bars + k))
            : "memory");
      }
    }
    for (int e = bytes / 4 + tid; e < count; e += kThreads) dst[e] = src[e];
    __syncthreads();
    return chunks;
  }
  // aligned int4 loads from the first 16-byte boundary on
  const int head = min(count, static_cast<int>((16 - (a & 15)) & 15) >> 2);
  const int vec = (count - head) >> 2;
  for (int e = tid; e < head; e += kThreads) dst[e] = src[e];
  const int4* s4 = reinterpret_cast<const int4*>(src + head);
  for (int q = tid; q < vec; q += kThreads) {
    const int4 v = s4[q];
    int* d = dst + head + 4 * q;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  for (int e = head + 4 * vec + tid; e < count; e += kThreads)
    dst[e] = src[e];
  __syncthreads();
  return 0;
}

template <int kC, bool kEst, bool kNarrow, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    frame_head_kernel(const int* __restrict__ smp, int* __restrict__ chans,
                      int* __restrict__ obits, int* __restrict__ wasted,
                      int* __restrict__ mode_out,
                      unsigned char* __restrict__ constant, int n, int bps) {
  extern __shared__ int4 staged[];
  __shared__ Partials part;
  __shared__ Totals tot;
  __shared__ int src_s[kMaxC], w_s[kMaxC];
  __shared__ uint64_t bars[kMaxChunks];
  const int tid = threadIdx.x, lane = tid & 31;
  const long long f = blockIdx.x;
  const int* x = smp + f * n * kC;
  int chunks = 0;
  if (kStaged) {
    chunks = stage(reinterpret_cast<int*>(staged), x, n * kC, bars);
    x = reinterpret_cast<const int*>(staged);
  }

  gather<kC, kEst, !kNarrow, kStaged>(x, n, bps, bars, chunks, part, tot);
  __syncthreads();
  if (kNarrow && tot.bad) {
    // a sample outside bps bits: the statistics again in int64
    gather<kC, kEst, true, kStaged>(x, n, bps, bars, 0, part, tot);
    __syncthreads();
  }

  // warp 0 picks the mode (a lane a Rice parameter), lane 0 the shifts and
  // the flags
  if (tid < 32) {
    int mode = kC == 2 ? kLeftRight : kNotStereo;
    if (kEst) {
      mode = mode_from_sums(tot.sum, n, lane);
      if (bps >= 32 && tot.over >= (1ll << 31)) mode = kLeftRight;
    }
    if (lane == 0) {
      mode_out[f] = mode;
      for (int c = 0; c < kC; ++c) {
        int src = c;
        if (kC == 2 && kEst)
          src = c == 0
                    ? (mode == kMidSide ? kM : mode == kRightSide ? kS : kL)
                    : (mode == kMidSide || mode == kLeftSide ? kS : kR);
        const unsigned o = tot.orv[src], a = tot.andv[src];
        const int tz = o ? __ffs(o) - 1 : 32;
        int w = tz == 32 ? bps - 1 : min(tz, bps - 1);
        if (w == bps - 1) w = 0;
        const int side = (c == 0 && mode == kRightSide) ||
                         (c == 1 && (mode == kMidSide || mode == kLeftSide));
        unsigned v0;
        if constexpr (kC == 2)
          v0 = static_cast<unsigned>(stereo_value(src, x[0], x[1]));
        else
          v0 = static_cast<unsigned>(x[c]);
        obits[f * kC + c] = bps + side - w;
        wasted[f * kC + c] = w;
        constant[f * kC + c] = o == v0 && a == v0;
        src_s[c] = src;
        w_s[c] = w;
      }
    }
  }
  __syncthreads();

  int src[kC], w[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    src[c] = src_s[c];
    w[c] = w_s[c];
  }
  int* out = chans + f * kC * n;
  if (kStaged && (n & 3) == 0 &&
      (reinterpret_cast<uintptr_t>(chans) & 15) == 0) {
    // four samples a thread: kC int4 loads, one int4 store a channel
    const int4* x4 = reinterpret_cast<const int4*>(x);
    for (int q = tid; q < n / 4; q += kThreads) {
      int v[4 * kC];
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const int4 t = x4[q * kC + k];
        v[4 * k] = t.x;
        v[4 * k + 1] = t.y;
        v[4 * k + 2] = t.z;
        v[4 * k + 3] = t.w;
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        int o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (kC == 2)
            o[j] = stereo_value(src[c], v[2 * j], v[2 * j + 1]) >> w[c];
          else
            o[j] = v[j * kC + c] >> w[c];
        }
        *reinterpret_cast<int4*>(out + static_cast<long long>(c) * n +
                                 4 * q) = make_int4(o[0], o[1], o[2], o[3]);
      }
    }
  } else {
    for (int i = tid; i < n; i += kThreads) {
      const int* s = x + static_cast<long long>(i) * kC;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        int v;
        if constexpr (kC == 2)
          v = stereo_value(src[c], s[0], s[1]);
        else
          v = s[c];
        out[static_cast<long long>(c) * n + i] = v >> w[c];
      }
    }
  }
}

template <int kC, bool kEst, bool kNarrow>
int launch(const int* smp, int* chans, int* obits, int* wasted, int* mode,
           unsigned char* constant, int F, int n, int bps,
           cudaStream_t stream) {
  const long long bytes = static_cast<long long>(n) * kC * 4;
  if (bytes > kStageCap) {
    frame_head_kernel<kC, kEst, false, false><<<F, kThreads, 0, stream>>>(
        smp, chans, obits, wasted, mode, constant, n, bps);
    return static_cast<int>(cudaGetLastError());
  }
  // the static shared memory counts toward the 48 KB a block may take
  // without opting in, so each staged kernel opts in, to the largest frame
  // (the same value from every caller, whatever runs at once), once a
  // device: a bit a device that has opted in
  static std::atomic<unsigned long long> opted{0};
  auto kern = frame_head_kernel<kC, kEst, kNarrow, true>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (!(opted.load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kStageCap);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted.fetch_or(bit, std::memory_order_release);
  }
  kern<<<F, kThreads, static_cast<int>((bytes + 15) & ~15ll), stream>>>(
      smp, chans, obits, wasted, mode, constant, n, bps);
  return static_cast<int>(cudaGetLastError());
}

template <int kC>
int launch_c(const int* smp, int* chans, int* obits, int* wasted, int* mode,
             unsigned char* constant, int F, int n, int bps, int est,
             cudaStream_t stream) {
  if constexpr (kC == 2) {
    if (est)
      return bps <= 16
                 ? launch<2, true, true>(smp, chans, obits, wasted, mode,
                                         constant, F, n, bps, stream)
                 : launch<2, true, false>(smp, chans, obits, wasted, mode,
                                          constant, F, n, bps, stream);
  }
  return launch<kC, false, false>(smp, chans, obits, wasted, mode, constant,
                                  F, n, bps, stream);
}

}  // namespace

// H. smp int32 [F, n, C] -> chans int32 [F, C, n] (decorrelated, wasted
// bits shifted out), obits and wasted int32 [F, C], mode int32 [F], constant
// uint8 [F, C] (0 or 1); est (the stereo estimate) only with C == 2; C 1-8;
// the caller checks the shapes.
extern "C" int flake_frame_head(const int* smp, int* chans, int* obits,
                                int* wasted, int* mode,
                                unsigned char* constant, int F, int n, int C,
                                int bps, int est, cudaStream_t stream) {
  if (n < 1 || C < 1 || C > kMaxC || (est && C != 2) || bps < 1 || bps > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (F <= 0) return static_cast<int>(cudaGetLastError());
  switch (C) {
#define FLAKE_HEAD_C(c)                                                      \
  case c:                                                                    \
    return launch_c<c>(smp, chans, obits, wasted, mode, constant, F, n, bps, \
                       est, stream);
    FLAKE_HEAD_C(1)
    FLAKE_HEAD_C(2)
    FLAKE_HEAD_C(3)
    FLAKE_HEAD_C(4)
    FLAKE_HEAD_C(5)
    FLAKE_HEAD_C(6)
    FLAKE_HEAD_C(7)
    FLAKE_HEAD_C(8)
#undef FLAKE_HEAD_C
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
