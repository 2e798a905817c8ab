// The first design of this kernel, kept unchanged apart from the entry
// point's name, only as a yardstick: chip_smoke.py builds it beside the
// current design (../bitmerge.cu) and times both on the same inputs in one
// run. No path of the package calls it; it is not part of the package's
// kernel library (flake_tpu_torch/_cuda.py builds csrc/*.cu only).
//
// K3: place every slot payload of a frame into its big-endian 32-bit words.
//
// Replaces the TPU kernel flake_tpu/ops/pallas_bitmerge.py:
// merge_combined (_merge_combined_kernel, _mxu_chunk, _vals12). A frame
// is a fixed table of M slots; slot s has a bit length len[s], of which
// the first lead[s] bits are zeros (a Rice quotient) and the rest carry
// the <= 32-bit payload. Slot bit offsets are the exclusive prefix sum
// of the lengths, and payload extents are disjoint, so the OR of the
// payloads at their offsets is the frame. Stream bit 0 is bit 31 of
// word 0, as in the JAX package. The TPU kernel first combined slots
// into <= 64-bit nodes and placed them with one-hot matmuls on the
// matrix unit, with a static row span per chunk and an overflow
// re-pack; none of that is needed here.
//
// What bounds it on the card: per frame it reads 12 bytes per slot and
// writes the frame's words, with one or two 32-bit atomicOr per nonzero
// payload into device memory (L2). Design: one block per frame walks
// the slot table in chunks of 1024, one slot per thread; a hand-written
// block scan (warp shuffles, then a scan of the 32 warp totals) gives
// each slot its offset, with the running total carried across chunks;
// each payload (spanning at most two words) is ORed into the zeroed
// output. OR is order-free, so the words do not depend on scheduling.
// The frame's total bit count is the scan's final carry. Staging the
// frame in shared memory is left for a later speed change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(const int* __restrict__ lengths, const int* __restrict__ leading,
             const int* __restrict__ payload, unsigned* __restrict__ words,
             int* __restrict__ total_bits, int M, int W) {
  __shared__ int warp_excl[kThreads / 32];
  __shared__ int chunk_total;
  const size_t f = blockIdx.x;
  const int* len = lengths + f * M;
  const int* lead = leading + f * M;
  const int* pay = payload + f * M;
  unsigned* out = words + f * W;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int carry = 0;
  for (int base = 0; base < M; base += kThreads) {
    const int s = base + threadIdx.x;
    const int ln = s < M ? len[s] : 0;
    int inc = ln;  // inclusive scan within the warp
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += t;
    }
    if (lane == 31) warp_excl[warp] = inc;
    __syncthreads();
    if (warp == 0) {  // scan of the 32 warp totals
      const int tot = warp_excl[lane];
      int winc = tot;
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, winc, off);
        if (lane >= off) winc += t;
      }
      warp_excl[lane] = winc - tot;
      if (lane == 31) chunk_total = winc;
    }
    __syncthreads();

    if (s < M) {
      const int plen = ln - lead[s];
      if (plen > 0) {
        const unsigned p = static_cast<unsigned>(pay[s]);
        const int start = carry + warp_excl[warp] + (inc - ln) + lead[s];
        const int w0 = start >> 5;
        const int t = (start & 31) + plen;
        // the same shift clamps as the plain version (bitpack.py:677-684)
        const unsigned hi = t <= 32 ? p << clampi(32 - t, 0, 31)
                                    : p >> clampi(t - 32, 0, 31);
        const unsigned lo = t <= 32 ? 0u : p << clampi(64 - t, 1, 31);
        if (hi && w0 < W) atomicOr(out + w0, hi);
        if (lo && w0 + 1 < W) atomicOr(out + w0 + 1, lo);
      }
    }
    carry += chunk_total;
    __syncthreads();  // warp_excl and chunk_total are rewritten next
  }
  if (threadIdx.x == 0) total_bits[f] = carry;
}

}  // namespace

// lengths, leading, payload int32 [F, M] -> words int32 [F, W] (zeroed by
// the caller), total_bits int32 [F]
extern "C" int flake_merge_words_v1(const int* lengths, const int* leading,
                                 const int* payload, int* words,
                                 int* total_bits, int F, int M, int W,
                                 cudaStream_t stream) {
  if (F > 0)
    merge_kernel<<<F, kThreads, 0, stream>>>(
        lengths, leading, payload, reinterpret_cast<unsigned*>(words),
        total_bits, M, W);
  return static_cast<int>(cudaGetLastError());
}
