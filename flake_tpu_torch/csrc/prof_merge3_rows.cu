// U3c-U3d: the row-layout combined-node merges of
// flake_tpu_torch/util/prof_merge3.py (their zero floors, U3e and U3f, are
// the tools' one zero floor in zero_floor.cu).
//
// Replaces the TPU kernels util/prof_merge3.py: merge_v5d (body k_v5d,
// _mxu_chunk_d) and merge_v5c (body k_v5c, _mxu_chunk). The inputs are the
// three node sets that v5d_parts / v5c_parts make of a frame's slots: main
// and sp2, each w0 and (A, B, C), and sp1, w0 and (A, B), with cb2
// [F, nc2 + 1] and cb1 [F, nc1 + 1], whose low 31 bits are the bit offset of
// a chunk's first node and whose bit 31 says that the chunk of sp2 or sp1
// holds a spill at all.
// The words A, B, C lie in rows, int32 [F, nc, 128]: a chunk is 512
// contiguous bytes. w0 lies in rows too for v5d and in chunks, int32
// [F, 128, nc], for v5c.
//
// On the TPU a chunk's nodes are placed by one one-hot matrix product per
// word row (the words split into 8-bit quarters so that the sums stay exact),
// over a static number of rows from the chunk's first, with B and C rolled
// one and two lanes and carried into the next row. The products, the rolls
// and the row gate of v5d are how; what both bodies compute is ported:
//
//   row0 = (cb[c] & 0x7fffffff) >> 12 is chunk c's first word row. A node of
//   chunk c with w0 >= 128 row0 adds A at w0, B at w0 + 1 and C at w0 + 2, in
//   int32 with wraparound, each only where its word lies before
//   128 (row0 + K): K = kmax for main and sp2 (both by cb2's row0; sp2 only
//   where cb2[c] < 0), K = kmax1 for sp1 (cb1's row0, only where cb1[c] < 0,
//   A and B only).
//
// A word at or past W is never written (the TPU bodies index row0 + dr
// without a bound).
//
// What bounds the merges on the card: bytes (16 bytes per main node, the
// flagged spill chunks, the word block written once). Design as v5a
// (prof_merge3.cu) and merge_v3 (prof_merge2.cu): a block takes fb
// consecutive frames, one after the other through one word block in shared
// memory (fb word blocks would not fit an SM at fb = 16), shared-memory
// atomicAdd on int, one coalesced store a frame. In rows the chunk of
// element j is j / 128, the same for a whole warp, so a warp skips an
// unflagged spill chunk without a load, and every load is coalesced. v5c
// reads w0 of element j = 128 c + s at s * nc + c: neighbouring threads
// lie nc ints apart, and a frame's w0 array (128 nc ints) is read through
// L1 line by line, each line by several warps.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLane = 128;
constexpr int kMask31 = 0x7fffffff;

// Adds one set's nodes of frame f. `cb` holds the set's chunk entries in
// shared memory; with `spill`, only chunks whose entry is negative count. c
// is null for sp1. kDual: w0 in [128, nc], else in [nc, 128].
template <bool kDual>
__device__ __forceinline__ void add_set(int* smem, const int* cb, bool spill,
                                        const int* w0, const int* a,
                                        const int* b, const int* c, size_t f,
                                        int nc, int rows, int W) {
  const int S = kLane * nc;
  for (int j = threadIdx.x; j < S; j += kThreads) {
    const int chunk = j / kLane;
    const int entry = cb[chunk];
    if (spill && entry >= 0) continue;
    const int first = ((entry & kMask31) >> 12) * kLane;
    const int end = min(first + rows * kLane, W);
    const size_t at = f * S + j;
    const int w = kDual ? w0[f * S + (j % kLane) * nc + chunk] : w0[at];
    if (w < first) continue;
    int value = a[at];
    if (value != 0 && w < end) atomicAdd(smem + w, value);
    value = b[at];
    if (value != 0 && w + 1 < end) atomicAdd(smem + w + 1, value);
    if (c != nullptr) {
      value = c[at];
      if (value != 0 && w + 2 < end) atomicAdd(smem + w + 2, value);
    }
  }
}

// shared memory: word block [W], cb2 [nc2], cb1 [nc1] (the chunks' entries;
// the total bits after them are not needed)
template <bool kDual>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const int* __restrict__ cb2, const int* __restrict__ cb1,
            const int* __restrict__ mw, const int* __restrict__ ma,
            const int* __restrict__ mb, const int* __restrict__ mc,
            const int* __restrict__ s2w, const int* __restrict__ s2a,
            const int* __restrict__ s2b, const int* __restrict__ s2c,
            const int* __restrict__ s1w, const int* __restrict__ s1a,
            const int* __restrict__ s1b, int* __restrict__ words, int nc2,
            int nc1, int W, int fb, int kmax, int kmax1) {
  extern __shared__ int smem[];
  int* e2 = smem + W;
  int* e1 = e2 + nc2;
  for (int i = 0; i < fb; ++i) {
    const size_t f = static_cast<size_t>(blockIdx.x) * fb + i;
    for (int w = threadIdx.x; w < W; w += kThreads) smem[w] = 0;
    for (int c = threadIdx.x; c < nc2; c += kThreads)
      e2[c] = cb2[f * (nc2 + 1) + c];
    for (int c = threadIdx.x; c < nc1; c += kThreads)
      e1[c] = cb1[f * (nc1 + 1) + c];
    __syncthreads();
    add_set<kDual>(smem, e2, false, mw, ma, mb, mc, f, nc2, kmax, W);
    add_set<kDual>(smem, e2, true, s2w, s2a, s2b, s2c, f, nc2, kmax, W);
    add_set<kDual>(smem, e1, true, s1w, s1a, s1b, nullptr, f, nc1, kmax1, W);
    __syncthreads();
    for (int w = threadIdx.x; w < W; w += kThreads)
      words[f * W + w] = smem[w];
    __syncthreads();   // frees the word block and the entries for the next
  }
}

template <bool kDual>
int launch(const int* cb2, const int* cb1, const int* mw, const int* ma,
           const int* mb, const int* mc, const int* s2w, const int* s2a,
           const int* s2b, const int* s2c, const int* s1w, const int* s1a,
           const int* s1b, int* words, int F, int nc2, int nc1, int W, int fb,
           int kmax, int kmax1, cudaStream_t stream) {
  if (F <= 0) return 0;
  if (fb <= 0 || F % fb != 0 || kmax < 1 || kmax1 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = (static_cast<size_t>(W) + nc2 + nc1) * sizeof(int);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        rows_kernel<kDual>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  rows_kernel<kDual><<<F / fb, kThreads, bytes, stream>>>(
      cb2, cb1, mw, ma, mb, mc, s2w, s2a, s2b, s2c, s1w, s1a, s1b, words, nc2,
      nc1, W, fb, kmax, kmax1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cb2 int32 [F, nc2 + 1], cb1 int32 [F, nc1 + 1]; main (mw, ma, mb, mc) and
// sp2 (s2w, s2a, s2b, s2c) int32 [F, nc2, 128]; sp1 (s1w, s1a, s1b) int32
// [F, nc1, 128] -> words int32 [F, W], W a multiple of 128; fb divides F
extern "C" int flake_prof_merge_v5d(
    const int* cb2, const int* cb1, const int* mw, const int* ma,
    const int* mb, const int* mc, const int* s2w, const int* s2a,
    const int* s2b, const int* s2c, const int* s1w, const int* s1a,
    const int* s1b, int* words, int F, int nc2, int nc1, int W, int fb,
    int kmax, int kmax1, cudaStream_t stream) {
  return launch<false>(cb2, cb1, mw, ma, mb, mc, s2w, s2a, s2b, s2c, s1w, s1a,
                       s1b, words, F, nc2, nc1, W, fb, kmax, kmax1, stream);
}

// as v5d, but mw, s2w int32 [F, 128, nc2] and s1w int32 [F, 128, nc1]
extern "C" int flake_prof_merge_v5c(
    const int* cb2, const int* cb1, const int* mw, const int* ma,
    const int* mb, const int* mc, const int* s2w, const int* s2a,
    const int* s2b, const int* s2c, const int* s1w, const int* s1a,
    const int* s1b, int* words, int F, int nc2, int nc1, int W, int fb,
    int kmax, int kmax1, cudaStream_t stream) {
  return launch<true>(cb2, cb1, mw, ma, mb, mc, s2w, s2a, s2b, s2c, s1w, s1a,
                      s1b, words, F, nc2, nc1, W, fb, kmax, kmax1, stream);
}
