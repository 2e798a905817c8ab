// K5: add every slot's pre-aligned (w0, hi, lo) payload into its frame's
// big-endian 32-bit words.
//
// Replaces the TPU kernel flake_tpu/ops/pallas_bitmerge.py: merge_words
// (_merge_kernel). The inputs are what ops/bitpack.py: aligned_parts
// makes of a frame's slots: w0 is the word a slot's payload starts in, hi
// the part of the payload in that word and lo the part in the next one
// (uint32 patterns carried as int32, 0 where there is none). The contract
// is out[f, w0] += hi and out[f, w0 + 1] += lo for every slot; payload bit
// extents are disjoint, so the sum is their OR. The TPU has no scatter:
// its kernel compares 128 slots against 128 word lanes, reduces over
// sublanes, and walks the word rows a chunk can touch in a loop, which is
// why the inputs come as [F, 128, nc] with the chunk's bit bounds beside
// them. None of that is needed here; the layout stays because it is the
// function's contract. A word index outside [0, W) adds nothing.
//
// What bounds it on the card: bytes. Per frame it reads 12 bytes per slot
// and writes the frame's words once. Design: one block per frame zeroes
// the frame's word block in shared memory (W * 4 bytes: 17 KiB for
// 4096-sample 16-bit stereo frames, 34 KiB for 8192), walks the three
// input arrays in memory order (a slot's place in the order does not
// matter to a sum, so the reads are coalesced whatever the [128, nc]
// layout means), adds each nonzero part with a shared-memory atomicAdd,
// and stores the block with coalesced writes. Integer adds commute, so
// the words do not depend on scheduling. Blocks above 48 KiB opt in to
// more dynamic shared memory, up to the card's 227 KiB.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
merge_aligned_kernel(const int* __restrict__ w0t, const int* __restrict__ hit,
                     const int* __restrict__ lot, int* __restrict__ words,
                     int S, int W) {
  extern __shared__ int block_words[];
  const size_t f = blockIdx.x;
  const int* w0 = w0t + f * S;
  const int* hi = hit + f * S;
  const int* lo = lot + f * S;
  for (int w = threadIdx.x; w < W; w += kThreads) block_words[w] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < S; j += kThreads) {
    const int w = w0[j];
    const int h = hi[j];
    const int l = lo[j];
    if (h != 0 && w >= 0 && w < W) atomicAdd(block_words + w, h);
    if (l != 0 && w + 1 >= 0 && w + 1 < W) atomicAdd(block_words + w + 1, l);
  }
  __syncthreads();
  int* out = words + f * W;
  for (int w = threadIdx.x; w < W; w += kThreads) out[w] = block_words[w];
}

}  // namespace

// w0t, hit, lot int32 [F, S] (S = 128 * nc, any slot order within a frame)
// -> words int32 [F, W]
extern "C" int flake_merge_aligned(const int* w0t, const int* hit,
                                   const int* lot, int* words, int F, int S,
                                   int W, cudaStream_t stream) {
  if (F <= 0) return 0;
  const size_t bytes = static_cast<size_t>(W) * sizeof(int);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        merge_aligned_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  merge_aligned_kernel<<<F, kThreads, bytes, stream>>>(w0t, hit, lot, words,
                                                      S, W);
  return static_cast<int>(cudaGetLastError());
}
