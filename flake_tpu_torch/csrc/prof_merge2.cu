// U2: two prototypes of the pre-aligned word merge K5 (bitmerge_aligned.cu)
// for flake_tpu_torch/util/prof_merge2.py.
//
// Replaces the TPU kernels util/prof_merge2.py: merge_v2 (body k_v2,
// _frame_body) and merge_v3 (body k_v3, _frame_body_s2w). On the TPU, v2
// compares a chunk of 128 slots against windows of 64 words from the
// chunk's first word and carries the first window in two row registers
// that follow the bit cursor; v3 compares against the chunk's first four
// word rows and skips the rows it does not reach. The compares, lane rolls
// and register carry exist because the TPU cannot scatter; what they
// compute is K5's sum out[w0] += hi, out[w0 + 1] += lo, in int32 with
// wraparound, restricted and displaced as follows, and that is ported:
//
//   v2  cw = cb[c] >> 5 is chunk c's first word, rel = w0 - cw, p = rel >> 6.
//       A slot with rel < 0 or p >= 4 adds nothing. One with p in 1..3 adds
//       only where ((cb[c + 1] - 1) >> 5) - cw >= 64 p. One with p == 0 adds
//       at w0 - 128 (r - ra) and the word after it, where r = cw >> 7 and ra
//       is the carry's row: ra = max(ra', min(r, ra' + 2)) from the chunk
//       before, 0 before the first. ra == r unless a chunk starts three or
//       more rows past the carry.
//   v3  row0 = cb[c] >> 12, last_row = (((cb[c + 1] - 1) >> 5) + 1) >> 7. A
//       word adds where its row is row0, or in row0 + 1 .. row0 + 3 and at
//       most last_row.
//
// A word at or past W is never written. Shifts are signed and the int32
// arithmetic wraps, as on the TPU.
//
// What bounds them on the card: bytes, as K5 (12 bytes per slot read, the
// word block written once: 61.7 MB, 0.0184 ms, on the tools' music batch).
//
// Design for the card, one body for both rules (walk_kernel<kV3, kVec>):
// one block of 256 threads per frame, whatever the TPU tool's fb (frames per
// program) is, so that no frame waits behind another and four blocks an SM
// hold the tools' 512 frames in one wave. The frame's word block lies in
// shared memory; slots add with shared-memory atomicAdd on int (int32
// addition in any order) and the block is stored with 16-byte writes. The
// three inputs are read as 16-byte quads of four slots; a thread loads its
// next quad as soon as it has added the one before, its first before the
// block's barrier, and the SM's other warps cover the loads' latency (two or
// four quads a thread in flight, or 128 or 512 threads a block, read slower
// on an H100 for v2). A frame's [128, nc] arrays start 512 nc bytes apart,
// so the quads are aligned wherever the arrays are (else the same walk
// loads one slot at a time). The chunk of element j is j % nc: each thread
// computes it once and carries it forward by its fixed stride modulo nc.
// While the other warps zero the word block, warp 0 builds a table of every
// chunk in shared memory, so that a slot needs one 16-byte shared load:
//
//   v2  (cw, lim, early): a slot adds where 0 <= w0 - cw < lim (lim = 64
//       windows kept, 64 to 256), at w0 - early in the first window and at
//       w0 in the others. The carry rows come from a warp prefix minimum:
//       where r_c does not decrease, ra_c = max(ra_{c-1}, min(r_c,
//       ra_{c-1} + 2)) with ra_{-1} = 0 equals min(2 (c + 1), min_{j <= c}
//       (r_j + 2 (c - j))), that is 2 c + min(2, min_{j <= c} (r_j - 2 j))
//       (flake_tpu_torch/util/prof_merge2.py: v2_carry_rows_prefix_min
//       states the same on the host).
//   v3  (row0, span) with span = max(0, min(last_row, row0 + 3) - row0): a
//       word of row r adds where 0 <= r - row0 <= span (v3_chunk_rows
//       states the same on the host). Each chunk's entry is its own; v3
//       needs no order of the chunk bounds.
//
// The first designs (a block per fb frames) are yardsticks/prof_merge2_v1.cu.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kLane = 128;

__device__ __forceinline__ void add_at(int* smem, int w, int value, int W) {
  if (value != 0 && w >= 0 && w < W) atomicAdd(smem + w, value);
}

// Warp 0 fills table[c] = (cw, lim, early, 0) for every chunk of a frame
// whose chunk bounds are cb[0, nc].
__device__ __forceinline__ void v2_chunk_table(int4* table, const int* cb,
                                               int nc) {
  const int lane = threadIdx.x;
  int carry = INT_MAX;   // min of r_j - 2 j over the chunks of earlier passes
  for (int base = 0; base < nc; base += 32) {
    const int c = base + lane;
    const bool in = c < nc;
    const int b0 = in ? cb[c] : 0;
    const int b1 = in ? cb[c + 1] : 0;
    const int r = b0 >> 12;
    int m = in ? r - 2 * c : INT_MAX;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, m, d);
      if (lane >= d) m = min(m, o);
    }
    m = min(m, carry);
    carry = __shfl_sync(0xffffffffu, m, 31);
    if (in) {
      const int ra = 2 * c + min(2, m);
      const int cw = b0 >> 5;
      const int ext = ((b1 - 1) >> 5) - cw;
      const int windows = 1 + min(3, max(0, ext >> 6));
      table[c] = make_int4(cw, 64 * windows, kLane * (r - ra), 0);
    }
  }
}

// Warp 0 fills table[c] = (row0, span, 0, 0) for every chunk.
__device__ __forceinline__ void v3_chunk_table(int4* table, const int* cb,
                                               int nc) {
  for (int c = threadIdx.x; c < nc; c += 32) {
    const int row0 = cb[c] >> 12;
    // cb[c + 1] - 1 wraps at INT_MIN, as the TPU's int32 does
    const int last = static_cast<int>(static_cast<unsigned>(cb[c + 1]) - 1u);
    const int last_row = ((last >> 5) + 1) >> 7;
    table[c] = make_int4(row0, max(0, min(last_row, row0 + 3) - row0), 0, 0);
  }
}

__device__ __forceinline__ bool v3_keeps(int4 t, int w) {
  return static_cast<unsigned>((w >> 7) - t.x) <= static_cast<unsigned>(t.y);
}

// Adds the four slots of one quad, elements of chunks c, c + 1, ... mod nc.
template <bool kV3>
__device__ __forceinline__ void add_quad(int* block_words, const int4* table,
                                         int4 w, int4 h, int4 l, int c, int nc,
                                         int W) {
  const int ws[4] = {w.x, w.y, w.z, w.w};
  const int hs[4] = {h.x, h.y, h.z, h.w};
  const int ls[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 t = table[c];
    if (kV3) {
      if (v3_keeps(t, ws[k])) add_at(block_words, ws[k], hs[k], W);
      if (v3_keeps(t, ws[k] + 1)) add_at(block_words, ws[k] + 1, ls[k], W);
    } else {
      const int rel = ws[k] - t.x;
      if (static_cast<unsigned>(rel) < static_cast<unsigned>(t.y)) {
        const int at = rel < 64 ? ws[k] - t.z : ws[k];
        add_at(block_words, at, hs[k], W);
        add_at(block_words, at + 1, ls[k], W);
      }
    }
    if (++c == nc) c = 0;
  }
}

template <bool kVec>
__device__ __forceinline__ int4 load_quad(const int* p, int q) {
  if (kVec) return reinterpret_cast<const int4*>(p)[q];
  return make_int4(p[4 * q], p[4 * q + 1], p[4 * q + 2], p[4 * q + 3]);
}

// shared memory: word block [W], chunk table [nc] of int4. kV3: v3's rule,
// else v2's. kVec: the inputs and the output are 16-byte aligned.
template <bool kV3, bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
walk_kernel(const int* __restrict__ chunk_bits, const int* __restrict__ w0t,
            const int* __restrict__ hit, const int* __restrict__ lot,
            int* __restrict__ words, int nc, int W) {
  extern __shared__ int4 shared4[];
  int* block_words = reinterpret_cast<int*>(shared4);
  int4* table = shared4 + W / 4;
  const size_t f = blockIdx.x;
  const int Q = 32 * nc;   // quads of a frame's [128, nc] array
  const int* w0 = w0t + f * kLane * nc;
  const int* hi = hit + f * kLane * nc;
  const int* lo = lot + f * kLane * nc;
  int q = threadIdx.x;
  int4 wq, hq, lq;
  if (q < Q) {
    wq = load_quad<kVec>(w0, q);
    hq = load_quad<kVec>(hi, q);
    lq = load_quad<kVec>(lo, q);
  }
  if (threadIdx.x < 32) {
    const int* cb = chunk_bits + f * (nc + 1);
    if (kV3) v3_chunk_table(table, cb, nc);
    else v2_chunk_table(table, cb, nc);
  } else {
    for (int i = threadIdx.x - 32; i < W / 4; i += kThreads - 32)
      shared4[i] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  if (Q > 0) {
    int c = 4 * static_cast<int>(threadIdx.x) % nc;
    const int step = 4 * kThreads % nc;
    for (; q < Q; q += kThreads) {
      add_quad<kV3>(block_words, table, wq, hq, lq, c, nc, W);
      c += step;
      if (c >= nc) c -= nc;
      const int next = q + kThreads;
      if (next < Q) {
        wq = load_quad<kVec>(w0, next);
        hq = load_quad<kVec>(hi, next);
        lq = load_quad<kVec>(lo, next);
      }
    }
  }
  __syncthreads();
  if (kVec) {
    int4* out = reinterpret_cast<int4*>(words + f * W);
    for (int i = threadIdx.x; i < W / 4; i += kThreads) out[i] = shared4[i];
  } else {
    for (int w = threadIdx.x; w < W; w += kThreads)
      words[f * W + w] = block_words[w];
  }
}

template <bool kV3, bool kVec>
int launch_walk(const int* chunk_bits, const int* w0t, const int* hit,
                const int* lot, int* words, int F, int nc, int W,
                cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(W) * sizeof(int)
      + static_cast<size_t>(nc) * sizeof(int4);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        walk_kernel<kV3, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  walk_kernel<kV3, kVec><<<F, kThreads, bytes, stream>>>(chunk_bits, w0t, hit,
                                                         lot, words, nc, W);
  return static_cast<int>(cudaGetLastError());
}

// Checks the shapes, then takes the 16-byte instantiation where the four
// arrays are aligned and the slot-by-slot one otherwise.
template <bool kV3>
int launch(const int* chunk_bits, const int* w0t, const int* hit,
           const int* lot, int* words, int F, int nc, int W,
           cudaStream_t stream) {
  if (F <= 0) return 0;
  if (W <= 0 || W % kLane != 0 || nc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = ((reinterpret_cast<uintptr_t>(w0t)
                         | reinterpret_cast<uintptr_t>(hit)
                         | reinterpret_cast<uintptr_t>(lot)
                         | reinterpret_cast<uintptr_t>(words)) & 15) == 0;
  return aligned
      ? launch_walk<kV3, true>(chunk_bits, w0t, hit, lot, words, F, nc, W,
                               stream)
      : launch_walk<kV3, false>(chunk_bits, w0t, hit, lot, words, F, nc, W,
                                stream);
}

}  // namespace

// chunk_bits int32 [F, nc + 1]; w0t, hit, lot int32 [F, 128, nc]
// -> words int32 [F, W], W a multiple of 128. One block a frame.
// Precondition: each frame's chunk_bits do not decrease and start at or
// above 0 (aligned_parts makes them a running sum of bit lengths); the carry
// rows' prefix-minimum form equals the TPU's recurrence only there.
extern "C" int flake_prof_merge_v2(
    const int* chunk_bits, const int* w0t, const int* hit, const int* lot,
    int* words, int F, int nc, int W, cudaStream_t stream) {
  return launch<false>(chunk_bits, w0t, hit, lot, words, F, nc, W, stream);
}

// as v2, the v3 rule; any chunk_bits
extern "C" int flake_prof_merge_v3(
    const int* chunk_bits, const int* w0t, const int* hit, const int* lot,
    int* words, int F, int nc, int W, cudaStream_t stream) {
  return launch<true>(chunk_bits, w0t, hit, lot, words, F, nc, W, stream);
}
