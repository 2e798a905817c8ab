// K1: Welch-windowed autocorrelation, lags 0..max_order, float64.
//
// Replaces the TPU kernel flake_tpu/ops/pallas_autocorr.py:
// autocorr_dd_pallas (_autocorr_kernel). The TPU has no native float64,
// so that kernel carried double-float f32 pairs with TwoProd/TwoSum.
// Hopper has native FP64 (34 TFLOP/s outside the tensor cores on an
// H100 SXM at 700 W, NVIDIA's data sheet), so d = x*w is formed in
// float64 and every lag is a plain FMA accumulation.
//
// What bounds it on the card: memory at 13 lags, the FP64 pipes at 33.
// Per stream of B samples it must read 4*B bytes of samples (the 8*B
// bytes of window are the same for every stream and come from L2) and it
// does B*(max_order+1) FMAs: at 13 lags about 3 FMAs a byte, under the
// card's 5 FP64 FMAs a byte of HBM, so the FMAs have to hide under the
// loads. The first design ran one block per stream through a shared chunk
// with a block barrier between its load and its use, read every lag's
// operand from shared memory, kept 33 accumulators whatever the order,
// and reduced every lag over the whole block. This design:
// - A block takes one stream with W <= 4 warps; a warp takes chunks of
//   512 samples and each lane a contiguous run of 16 of them. The warp
//   reads its chunk and the halo after it with coalesced 16-byte loads of
//   x and w (a lane's own run read straight from memory would touch a
//   cache line a lane), all of them issued before any is used, and stages
//   d = x*w in its own part of shared memory; only __syncwarp stands
//   between the staging and its use. The warp's next chunk is loaded into
//   registers while this one is summed. Rows padded to 18 doubles make the
//   lanes' 16-byte reads of their runs conflict-free.
// - A lane walks its run G samples at a time (8, or 4 at 33 lags) with
//   the next H >= max_order values of d in registers (a window that
//   slides by G), so every lag is an FMA between registers. LB, the lag
//   bucket (13 or 33), is a template argument: only LB accumulators are
//   live, and the loops unroll.
// - The reduction runs once a lane, in a fixed order: a butterfly that
//   halves the values a lane holds at every step (16 doubles exchanged a
//   lane at 13 lags instead of 65 for a full butterfly of each lag), then
//   the W warp totals added in warp order. No float atomics: the result
//   does not depend on scheduling, and two calls give the same bits. The
//   +2.0 bias per lag (lpc.c:57-67) is added last, matching
//   flake_tpu_torch.ops.lpc.autocorr.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;       // at most, a block (one stream)
constexpr int kRun = 16;        // samples a lane
constexpr int kChunk = 32 * kRun;   // samples a warp stages at once
constexpr int kRow = kRun + 2;  // doubles a staged row, padded
constexpr int kHaloMax = 32;
constexpr int kRows = 32 + kHaloMax / kRun;  // a row a lane, then the halo

// Sum v over the 32 lanes of a warp, V values (a power of two) a lane:
// each step sends half of what a lane holds to its partner and keeps the
// other half, with the partner's copy added; once a lane holds one value
// the remaining steps add it whole. Returns the index of the first value
// the lane holds; it holds max(V / 32, 1) of them, in v[0..], and lanes
// that hold copies of one value agree bit for bit.
template <int V>
__device__ __forceinline__ int warp_reduce_scatter(double* v, int lane) {
  int base = 0;
  int held = V;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (held > 1) {
      const int h = held / 2;
      const bool upper = lane & off;
#pragma unroll
      for (int i = 0; i < V / 2; ++i) {
        if (i < h) {
          const double send = upper ? v[i] : v[i + h];
          const double keep = upper ? v[i + h] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
        }
      }
      if (upper) base += h;
      held = h;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
    }
  }
  return base;
}

// A warp's chunk [base, base + kChunk + H) of x and w in registers, four
// samples a lane a step, neighbouring lanes on neighbouring 16 bytes;
// zero past the stream. Every load is issued before any is used.
template <int H>
struct Chunk {
  static constexpr int kSteps = (kChunk + H + 127) / 128;
  int x[4 * kSteps];
  double w[4 * kSteps];

  __device__ __forceinline__ void load(const int* __restrict__ xr,
                                       const double* __restrict__ wr,
                                       int base, int B, bool vec,
                                       int lane) {
    if (vec) {     // 16-byte loads: a group of four is all in or all out
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int v = j * 128 + 4 * lane;
        const int i = base + v;
        const bool in = i < B && v < kChunk + H;
        const int at = in ? i : 0;
        const int4 a = __ldg(reinterpret_cast<const int4*>(xr + at));
        const double2 b = __ldg(reinterpret_cast<const double2*>(wr + at));
        const double2 c = __ldg(reinterpret_cast<const double2*>(wr + at
                                                                  + 2));
        x[4 * j] = in ? a.x : 0;      w[4 * j] = in ? b.x : 0.0;
        x[4 * j + 1] = in ? a.y : 0;  w[4 * j + 1] = in ? b.y : 0.0;
        x[4 * j + 2] = in ? a.z : 0;  w[4 * j + 2] = in ? c.x : 0.0;
        x[4 * j + 3] = in ? a.w : 0;  w[4 * j + 3] = in ? c.y : 0.0;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int v = j * 128 + 4 * lane + k;
          const int i = base + v;
          const bool in = i < B && v < kChunk + H;
          x[4 * j + k] = in ? __ldg(xr + (in ? i : 0)) : 0;
          w[4 * j + k] = in ? __ldg(wr + (in ? i : 0)) : 0.0;
        }
      }
    }
  }

  // d = x*w into the warp's rows: sample v of the chunk at row v / kRun,
  // column v % kRun
  __device__ __forceinline__ void stage(double* st, int lane) const {
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int v = j * 128 + 4 * lane;
      if (v < kChunk + H) {
        double2* dst = reinterpret_cast<double2*>(
            st + (v / kRun) * kRow + v % kRun);
        dst[0] = make_double2(static_cast<double>(x[4 * j]) * w[4 * j],
                              static_cast<double>(x[4 * j + 1])
                                  * w[4 * j + 1]);
        dst[1] = make_double2(static_cast<double>(x[4 * j + 2])
                                  * w[4 * j + 2],
                              static_cast<double>(x[4 * j + 3])
                                  * w[4 * j + 3]);
      }
    }
  }
};

// d at sample k of the lane's run (k past the run reaches into the next
// lanes' rows, the halo), two at a time; k is even and known at compile
// time
__device__ __forceinline__ double2 staged2(const double* st, int lane,
                                           int k) {
  return *reinterpret_cast<const double2*>(
      st + (lane + k / kRun) * kRow + k % kRun);
}

template <int LB>
__global__ void __launch_bounds__(32 * kWarps)
autocorr_kernel(const int* __restrict__ x, const double* __restrict__ w,
                double* __restrict__ out, int B, int lags, bool vec) {
  constexpr int H = (LB - 1 + 3) / 4 * 4;    // window past a group
  constexpr int G = LB <= 16 ? 8 : 4;        // samples a lane takes at once
  constexpr int V = LB <= 16 ? 16 : 64;      // accumulators, a power of 2
  constexpr int kCopies = V < 32 ? 32 / V : 1;  // lanes holding one value
  static_assert(H <= kHaloMax, "halo rows");
  __shared__ __align__(16) double stage[kWarps][kRows * kRow];
  __shared__ double warp_sum[kWarps][LB];

  const int W = blockDim.x / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* xr = x + static_cast<size_t>(blockIdx.x) * B;
  double* st = stage[warp];

  double acc[V];
#pragma unroll
  for (int l = 0; l < V; ++l) acc[l] = 0.0;

  Chunk<H> next;
  next.load(xr, w, warp * kChunk, B, vec, lane);
  for (int base = warp * kChunk; base < B; base += W * kChunk) {
    next.stage(st, lane);
    __syncwarp();
    // the warp's next chunk is in flight while this one is summed
    if (base + W * kChunk < B)
      next.load(xr, w, base + W * kChunk, B, vec, lane);

    double d[H + G];
#pragma unroll
    for (int k = 0; k < H; k += 2) {
      const double2 p = staged2(st, lane, k);
      d[k] = p.x; d[k + 1] = p.y;
    }
#pragma unroll
    for (int g = 0; g < kRun; g += G) {
#pragma unroll
      for (int k = 0; k < G; k += 2) {
        const double2 p = staged2(st, lane, g + H + k);
        d[H + k] = p.x; d[H + k + 1] = p.y;
      }
      // all LB lags, so the block has no branch and LB independent sums;
      // the lags past max_order are not stored
#pragma unroll
      for (int k = 0; k < G; ++k) {
#pragma unroll
        for (int l = 0; l < LB; ++l) acc[l] = fma(d[k], d[k + l], acc[l]);
      }
#pragma unroll
      for (int k = 0; k < H; ++k) d[k] = d[k + G];
    }
    __syncwarp();                            // before the next chunk
  }

  const int first = warp_reduce_scatter<V>(acc, lane);
  if (lane % kCopies == 0) {
#pragma unroll
    for (int i = 0; i < (V >= 32 ? V / 32 : 1); ++i)
      if (first + i < LB) warp_sum[warp][first + i] = acc[i];
  }
  __syncthreads();
  for (int l = threadIdx.x; l < lags; l += blockDim.x) {
    double s = warp_sum[0][l];               // the W warps, in warp order
    for (int k = 1; k < W; ++k) s += warp_sum[k][l];
    out[static_cast<size_t>(blockIdx.x) * lags + l] = s + 2.0;
  }
}

}  // namespace

// x int32 [N, B], window float64 [B] -> out float64 [N, max_order + 1]
extern "C" int flake_autocorr(const int* x, const double* window,
                              double* out, int N, int B, int max_order,
                              cudaStream_t stream) {
  if (N > 0 && B > 0) {
    // warps a stream: one a chunk, at most kWarps (then they loop)
    const int W = (B + kChunk - 1) / kChunk < kWarps
                      ? (B + kChunk - 1) / kChunk : kWarps;
    const bool vec = (B & 3) == 0
                     && (reinterpret_cast<uintptr_t>(x) & 15) == 0
                     && (reinterpret_cast<uintptr_t>(window) & 15) == 0;
    const int lags = max_order + 1;
    if (lags <= 13)
      autocorr_kernel<13><<<N, 32 * W, 0, stream>>>(x, window, out, B, lags,
                                                     vec);
    else
      autocorr_kernel<33><<<N, 32 * W, 0, stream>>>(x, window, out, B, lags,
                                                     vec);
  }
  return static_cast<int>(cudaGetLastError());
}
