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
// writes the frame's W words once, so it is bound by bytes. Design: one
// block of 256 threads per frame (128 and 512 were no faster on the
// card, PERF.md section 6). A thread takes 4
// consecutive slots with one 16-byte load from each of the three arrays
// (a row that starts off a 16-byte boundary, or a row's last slots, take
// scalar loads for the quad that straddles), scans its 4 lengths itself,
// then the warp scans with shuffles; each warp's total goes to shared
// memory, and after the chunk's one barrier every thread adds up the
// totals of the warps before its own. The next chunk's loads are sent
// before the current chunk's scan. The frame's words live in dynamic
// shared memory: zeroed by the block, the payloads ORed in with
// shared-memory atomics (OR is order-free, so the words do not depend on
// scheduling), then written out 16 bytes a thread, zeros past the
// frame's end included, so the output needs no memset. A frame whose
// words do not fit the shared-memory cap the caller picks takes the
// second instantiation of the same body: it zeroes its frame's words in
// device memory itself and ORs into them there. The frame's total bit
// count is the scan's final carry.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;             // a block, one frame
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                   // consecutive slots a thread

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// slots 4 * g - pre .. + 3 of a row, 0 outside [0, M); one 16-byte load
// when the four lie inside the row and ``vec`` says the row's quads are
// aligned
__device__ __forceinline__ int4 load_quad(const int* __restrict__ row,
                                          int g, int pre, int M, bool vec) {
  const int s0 = kPer * g - pre;
  if (vec && s0 >= 0 && s0 + kPer <= M)
    return __ldg(reinterpret_cast<const int4*>(row + s0));
  int v[kPer];
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int s = s0 + t;
    v[t] = s >= 0 && s < M ? __ldg(row + s) : 0;
  }
  return make_int4(v[0], v[1], v[2], v[3]);
}

// OR one slot's payload, starting at bit ``off`` of the frame, into its
// one or two words (the same shift clamps as the plain version,
// bitpack.py:677-684)
__device__ __forceinline__ void place(unsigned* words, int off, int ln,
                                      int lead, int pay, int W) {
  const int plen = ln - lead;
  if (plen <= 0) return;
  const unsigned p = static_cast<unsigned>(pay);
  const int start = off + lead;
  const int w0 = start >> 5;
  const int t = (start & 31) + plen;
  const unsigned hi = t <= 32 ? p << clampi(32 - t, 0, 31)
                              : p >> clampi(t - 32, 0, 31);
  const unsigned lo = t <= 32 ? 0u : p << clampi(64 - t, 1, 31);
  if (hi && w0 < W) atomicOr(words + w0, hi);
  if (lo && w0 + 1 < W) atomicOr(words + w0 + 1, lo);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const int* __restrict__ lengths, const int* __restrict__ leading,
             const int* __restrict__ payload, unsigned* __restrict__ words,
             int* __restrict__ total_bits, int M, int W) {
  extern __shared__ uint4 staged[];             // the frame's W words
  __shared__ int warp_tot[2][kWarps];           // by chunk parity
  const size_t f = blockIdx.x;
  const int* len = lengths + f * M;
  const int* lead = leading + f * M;
  const int* pay = payload + f * M;
  unsigned* out = words + f * W;
  unsigned* dst = kShared ? reinterpret_cast<unsigned*>(staged) : out;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  uint4* dst4 = reinterpret_cast<uint4*>(dst);  // W is a multiple of 128
  for (int i = threadIdx.x; i < W / 4; i += kThreads)
    dst4[i] = make_uint4(0u, 0u, 0u, 0u);

  // the row's quads start ``pre`` slots before it, at a 16-byte boundary;
  // rows of arrays that are not aligned alike take scalar loads
  const int pre = static_cast<int>(
      (reinterpret_cast<uintptr_t>(len) >> 2) & 3);
  const bool vec =
      pre == static_cast<int>((reinterpret_cast<uintptr_t>(lead) >> 2) & 3)
      && pre == static_cast<int>((reinterpret_cast<uintptr_t>(pay) >> 2) & 3);
  const int skew = vec ? pre : 0;
  const int quads = (skew + M + kPer - 1) / kPer;

  int g = threadIdx.x;
  int4 l = load_quad(len, g, skew, M, vec);
  int4 d = load_quad(lead, g, skew, M, vec);
  int4 p = load_quad(pay, g, skew, M, vec);
  int carry = 0;
  for (int base = 0, it = 0; base < quads;
       base += kThreads, ++it, g += kThreads) {
    const int gn = g + kThreads;                // the next chunk, in flight
    const int4 ln = load_quad(len, gn, skew, M, vec);
    const int4 dn = load_quad(lead, gn, skew, M, vec);
    const int4 pn = load_quad(pay, gn, skew, M, vec);

    const int e1 = l.x, e2 = e1 + l.y, e3 = e2 + l.z, tot = e3 + l.w;
    int inc = tot;                              // inclusive, within the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += t;
    }
    if (lane == 31) warp_tot[it & 1][warp] = inc;
    __syncthreads();  // also orders the zeroing before the first OR
    int before = 0, chunk = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int t = warp_tot[it & 1][w];
      chunk += t;
      before += w < warp ? t : 0;
    }
    const int off = carry + before + inc - tot;
    place(dst, off, l.x, d.x, p.x, W);
    place(dst, off + e1, l.y, d.y, p.y, W);
    place(dst, off + e2, l.z, d.z, p.z, W);
    place(dst, off + e3, l.w, d.w, p.w, W);
    carry += chunk;
    l = ln;
    d = dn;
    p = pn;
  }
  __syncthreads();
  if (kShared) {
    uint4* out4 = reinterpret_cast<uint4*>(out);
    for (int i = threadIdx.x; i < W / 4; i += kThreads) out4[i] = dst4[i];
  }
  if (threadIdx.x == 0) total_bits[f] = carry;
}

template <bool kShared>
cudaError_t launch(const int* lengths, const int* leading, const int* payload,
                   int* words, int* total_bits, int F, int M, int W,
                   cudaStream_t stream) {
  const size_t smem = kShared ? static_cast<size_t>(W) * 4 : 0;
  if (smem > 48 * 1024) {  // above the default for dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        merge_kernel<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  merge_kernel<kShared><<<F, kThreads, smem, stream>>>(
      lengths, leading, payload, reinterpret_cast<unsigned*>(words),
      total_bits, M, W);
  return cudaGetLastError();
}

}  // namespace

// lengths, leading, payload int32 [F, M] -> words int32 [F, W] (written
// whole, W a multiple of 128), total_bits int32 [F]; ``shared`` picks the
// instantiation that stages the frame's words in shared memory (W * 4
// bytes of it) over the one that ORs into device memory
extern "C" int flake_merge_words(const int* lengths, const int* leading,
                                 const int* payload, int* words,
                                 int* total_bits, int F, int M, int W,
                                 int shared, cudaStream_t stream) {
  if (F <= 0) return static_cast<int>(cudaGetLastError());
  if (W % 128) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      shared ? launch<true>(lengths, leading, payload, words, total_bits, F,
                            M, W, stream)
             : launch<false>(lengths, leading, payload, words, total_bits, F,
                             M, W, stream));
}
