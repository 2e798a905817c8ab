// U3a, U3b: the combined-node word merges of
// flake_tpu_torch/util/prof_merge3.py.
//
// Replaces the TPU kernels util/prof_merge3.py: merge_v5a (body k_v5a,
// _win3) and merge_v5b (body k_v5b, _chunk_v5b). Their inputs are three
// sets of nodes that v5_parts makes of a frame's slots: main and sp2, each
// (w0, A, B, C) int32 [F, 128, nc2], and sp1 (w0, A, B) int32 [F, 128, nc1],
// with cb2 [F, nc2 + 1] and cb1 [F, nc1 + 1], whose bit 31 says that a
// chunk of sp2 or sp1 holds a spill at all. Both TPU kernels compute
//
//   out[w0] += A, out[w0 + 1] += B, out[w0 + 2] += C
//
// in int32 with wraparound over every main node, every sp2 node of a
// flagged chunk and every sp1 node (A, B only) of a flagged chunk; on the
// TPU they walk the word rows a chunk can touch and differ only in how
// that loop is unrolled (v5a a loop, v5b two static rows, two gated rows
// and a loop), which a scatter does not have. A word at or past W is never
// written.
//
// What bounds them on the card: bytes (16 bytes per main node, the flagged
// spill chunks, the word block written once). Design as K5: one block per
// frame, the word block and both cb tables in shared memory, every set read
// in memory order (the chunk of element j of a [128, nc] array is j % nc),
// shared-memory atomicAdd on int, one coalesced store. The two entry
// points share one body and differ in how they use the flags: v5a tests
// each spill node's chunk flag before it loads the node; v5b first reduces
// the frame's flags of a set and, where none is set, skips the set as a
// whole, so that on content without spills it runs no loop over them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLane = 128;

__device__ __forceinline__ void add_at(int* smem, int w, int value, int W) {
  if (value != 0 && w >= 0 && w < W) atomicAdd(smem + w, value);
}

// Adds one set's nodes of frame f; with `flags`, only those whose chunk's
// entry is negative. c is null for sp1.
__device__ __forceinline__ void add_set(int* smem, const int* flags,
                                        const int* w0, const int* a,
                                        const int* b, const int* c, size_t f,
                                        int nc, int W) {
  const int S = kLane * nc;
  for (int j = threadIdx.x; j < S; j += kThreads) {
    if (flags != nullptr && flags[j % nc] >= 0) continue;
    const size_t at = f * S + j;
    const int w = w0[at];
    add_at(smem, w, a[at], W);
    add_at(smem, w + 1, b[at], W);
    if (c != nullptr) add_at(smem, w + 2, c[at], W);
  }
}

// shared memory: word block [W], cb2 [nc2], cb1 [nc1] (the chunks' entries;
// the total bits after them are not needed)
template <bool kSkipSets>
__global__ void __launch_bounds__(kThreads)
v5_kernel(const int* __restrict__ cb2, const int* __restrict__ cb1,
          const int* __restrict__ mw, const int* __restrict__ ma,
          const int* __restrict__ mb, const int* __restrict__ mc,
          const int* __restrict__ s2w, const int* __restrict__ s2a,
          const int* __restrict__ s2b, const int* __restrict__ s2c,
          const int* __restrict__ s1w, const int* __restrict__ s1a,
          const int* __restrict__ s1b, int* __restrict__ words, int nc2,
          int nc1, int W) {
  extern __shared__ int smem[];
  int* f2 = smem + W;
  int* f1 = f2 + nc2;
  const size_t f = blockIdx.x;
  int any2 = 0, any1 = 0;
  for (int w = threadIdx.x; w < W; w += kThreads) smem[w] = 0;
  for (int c = threadIdx.x; c < nc2; c += kThreads) {
    f2[c] = cb2[f * (nc2 + 1) + c];
    any2 |= f2[c] < 0;
  }
  for (int c = threadIdx.x; c < nc1; c += kThreads) {
    f1[c] = cb1[f * (nc1 + 1) + c];
    any1 |= f1[c] < 0;
  }
  if (kSkipSets) {
    any2 = __syncthreads_or(any2);
    any1 = __syncthreads_or(any1);
  } else {
    any2 = any1 = 1;
    __syncthreads();
  }
  add_set(smem, nullptr, mw, ma, mb, mc, f, nc2, W);
  if (any2) add_set(smem, f2, s2w, s2a, s2b, s2c, f, nc2, W);
  if (any1) add_set(smem, f1, s1w, s1a, s1b, nullptr, f, nc1, W);
  __syncthreads();
  for (int w = threadIdx.x; w < W; w += kThreads) words[f * W + w] = smem[w];
}

template <bool kSkipSets>
int launch(const int* cb2, const int* cb1, const int* mw, const int* ma,
           const int* mb, const int* mc, const int* s2w, const int* s2a,
           const int* s2b, const int* s2c, const int* s1w, const int* s1a,
           const int* s1b, int* words, int F, int nc2, int nc1, int W,
           cudaStream_t stream) {
  if (F <= 0) return 0;
  const size_t bytes = (static_cast<size_t>(W) + nc2 + nc1) * sizeof(int);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        v5_kernel<kSkipSets>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  v5_kernel<kSkipSets><<<F, kThreads, bytes, stream>>>(
      cb2, cb1, mw, ma, mb, mc, s2w, s2a, s2b, s2c, s1w, s1a, s1b, words, nc2,
      nc1, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cb2 int32 [F, nc2 + 1], cb1 int32 [F, nc1 + 1]; main (mw, ma, mb, mc) and
// sp2 (s2w, s2a, s2b, s2c) int32 [F, 128, nc2]; sp1 (s1w, s1a, s1b) int32
// [F, 128, nc1] -> words int32 [F, W], W a multiple of 128
extern "C" int flake_prof_merge_v5a(
    const int* cb2, const int* cb1, const int* mw, const int* ma,
    const int* mb, const int* mc, const int* s2w, const int* s2a,
    const int* s2b, const int* s2c, const int* s1w, const int* s1a,
    const int* s1b, int* words, int F, int nc2, int nc1, int W,
    cudaStream_t stream) {
  return launch<false>(cb2, cb1, mw, ma, mb, mc, s2w, s2a, s2b, s2c, s1w, s1a,
                       s1b, words, F, nc2, nc1, W, stream);
}

extern "C" int flake_prof_merge_v5b(
    const int* cb2, const int* cb1, const int* mw, const int* ma,
    const int* mb, const int* mc, const int* s2w, const int* s2a,
    const int* s2b, const int* s2c, const int* s1w, const int* s1a,
    const int* s1b, int* words, int F, int nc2, int nc1, int W,
    cudaStream_t stream) {
  return launch<true>(cb2, cb1, mw, ma, mb, mc, s2w, s2a, s2b, s2c, s1w, s1a,
                      s1b, words, F, nc2, nc1, W, stream);
}
