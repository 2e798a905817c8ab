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
// equals its first: before the shift, which drops only zero bits, the same
// test.
//
// What bounds it on the card: bytes, the samples read once and the channels
// written once (4 + 4 bytes a sample; 33.6 MB on the level-8 batch of 512
// frames of 4,096 stereo samples), the work a few integer operations a
// sample. Design: one block of 256 a frame. Under the stereo estimate the
// block sums the differences (two lags of the cache) and one thread picks
// the mode; then, a channel at a time, the block ORs and compares the
// channel's decorrelated samples, reduces them by warp votes and shared
// atomics, and writes the shifted channel [C, B] from the frame's [B, C].

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 30;                        // params.MAX_RICE_PARAM
constexpr unsigned kFull = 0xffffffffu;

// stereo modes (ops/stereo.py)
constexpr int kNotStereo = 0;
constexpr int kLeftRight = 1;
constexpr int kLeftSide = 8;
constexpr int kRightSide = 9;
constexpr int kMidSide = 10;

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

// stereo.mode_from_sums on the four sums of one frame
__device__ int mode_from_sums(const long long* sums, int n) {
  long long est[4];
  for (int c = 0; c < 4; ++c) {
    const long long s = 2 * sums[c];
    long long best = rice_count(s, n, 0);
    for (int k = 1; k <= kMaxK; ++k) best = min(best, rice_count(s, n, k));
    est[c] = best;
  }
  const long long score[4] = {est[0] + est[1], est[0] + est[3],
                              est[1] + est[3], est[2] + est[3]};
  int b = 0;
  for (int i = 1; i < 4; ++i)
    if (score[i] < score[b]) b = i;
  const int modes[4] = {kLeftRight, kLeftSide, kRightSide, kMidSide};
  return modes[b];
}

// channel c of sample i after the decorrelation of `mode`
__device__ __forceinline__ int channel_at(const int* x, int i, int c, int C,
                                          int mode) {
  if (mode < kLeftSide) return x[i * C + c];
  const int l = x[2 * i], r = x[2 * i + 1];
  const int side = static_cast<int>(
      static_cast<unsigned>(static_cast<long long>(l) - r));
  if (mode == kMidSide)
    return c == 0 ? static_cast<int>((static_cast<long long>(l) + r) >> 1)
                  : side;
  if (mode == kLeftSide) return c == 0 ? l : side;
  return c == 0 ? side : r;                      // kRightSide
}

__global__ void __launch_bounds__(kThreads)
    frame_head_kernel(const int* __restrict__ smp, int* __restrict__ chans,
                      int* __restrict__ obits, int* __restrict__ wasted,
                      int* __restrict__ mode_out,
                      unsigned char* __restrict__ constant, int n, int C,
                      int bps, int est) {
  __shared__ long long red[kWarps][5];
  __shared__ int mode_s;
  __shared__ unsigned or_s;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long f = blockIdx.x;
  const int* x = smp + f * n * C;

  if (est) {
    // the second differences' abs-sums and, at 32 bits, max |l - r|
    long long s[4] = {0, 0, 0, 0}, over = 0;
    for (int i = tid; i < n; i += kThreads) {
      const long long l = x[2 * i], r = x[2 * i + 1];
      if (i >= 2) {
        const long long lt = l - 2ll * x[2 * i - 2] + x[2 * i - 4];
        const long long rt = r - 2ll * x[2 * i - 1] + x[2 * i - 3];
        s[0] += llabs(lt);
        s[1] += llabs(rt);
        s[2] += llabs((lt + rt) >> 1);
        s[3] += llabs(lt - rt);
      }
      over = max(over, llabs(l - r));
    }
    for (int c = 0; c < 4; ++c) s[c] = warp_sum(s[c]);
    over = warp_max(over);
    if (lane == 0) {
      for (int c = 0; c < 4; ++c) red[warp][c] = s[c];
      red[warp][4] = over;
    }
    __syncthreads();
    if (tid == 0) {
      long long sums[4] = {0, 0, 0, 0}, top = 0;
      for (int w = 0; w < kWarps; ++w) {
        for (int c = 0; c < 4; ++c) sums[c] += red[w][c];
        top = max(top, red[w][4]);
      }
      int mode = mode_from_sums(sums, n);
      if (bps >= 32 && top >= (1ll << 31)) mode = kLeftRight;
      mode_s = mode;
    }
    __syncthreads();
  }
  const int mode = est ? mode_s : (C == 2 ? kLeftRight : kNotStereo);
  if (tid == 0) mode_out[f] = mode;

  for (int c = 0; c < C; ++c) {
    if (tid == 0) or_s = 0;
    __syncthreads();
    const int first = channel_at(x, 0, c, C, mode);
    unsigned bits = 0;
    bool differs = false;
    for (int i = tid; i < n; i += kThreads) {
      const int v = channel_at(x, i, c, C, mode);
      bits |= static_cast<unsigned>(v);
      differs |= v != first;
    }
    bits = __reduce_or_sync(kFull, bits);
    if (lane == 0 && bits) atomicOr(&or_s, bits);
    differs = __syncthreads_or(differs);         // also orders or_s
    const int tz = or_s ? __ffs(or_s) - 1 : 32;
    int w = tz == 32 ? bps - 1 : min(tz, bps - 1);
    if (w == bps - 1) w = 0;
    int* out = chans + (f * C + c) * n;
    for (int i = tid; i < n; i += kThreads)
      out[i] = channel_at(x, i, c, C, mode) >> w;
    if (tid == 0) {
      const int side = (c == 0 && mode == kRightSide) ||
                       (c == 1 && (mode == kMidSide || mode == kLeftSide));
      obits[f * C + c] = bps + side - w;
      wasted[f * C + c] = w;
      constant[f * C + c] = differs ? 0 : 1;
    }
    __syncthreads();                             // or_s is reset
  }
}

}  // namespace

// H. smp int32 [F, n, C] -> chans int32 [F, C, n] (decorrelated, wasted
// bits shifted out), obits and wasted int32 [F, C], mode int32 [F], constant
// uint8 [F, C] (0 or 1); est (the stereo estimate) only with C == 2; the
// caller checks the shapes.
extern "C" int flake_frame_head(const int* smp, int* chans, int* obits,
                                int* wasted, int* mode,
                                unsigned char* constant, int F, int n, int C,
                                int bps, int est, cudaStream_t stream) {
  if (n < 1 || C < 1 || (est && C != 2) || bps < 1 || bps > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (F > 0)
    frame_head_kernel<<<F, kThreads, 0, stream>>>(smp, chans, obits, wasted,
                                                  mode, constant, n, C, bps,
                                                  est);
  return static_cast<int>(cudaGetLastError());
}
