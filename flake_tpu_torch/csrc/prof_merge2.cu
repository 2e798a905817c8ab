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
// A word at or past W is never written. Shifts are signed, as on the TPU.
//
// What bounds them on the card: bytes, as K5 (12 bytes per slot read, the
// word block written once). Design as K5: the word block of one frame in
// shared memory, inputs read in memory order (the chunk of element j of a
// frame's [128, nc] array is j % nc), shared-memory atomicAdd on int, one
// coalesced store. `fb` is the TPU tool's frames per program: a block
// takes fb consecutive frames, one after the other through the same word
// block (fb word blocks would not fit an SM at fb = 16), so the grid has
// F / fb blocks and the words do not depend on fb.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLane = 128;

// Zeroes the word block smem[0, W) and loads frame f's chunk bounds into
// cb[0, nc].
__device__ __forceinline__ void stage(int* smem, int* cb,
                                      const int* chunk_bits, size_t f, int nc,
                                      int W) {
  for (int w = threadIdx.x; w < W; w += kThreads) smem[w] = 0;
  for (int c = threadIdx.x; c <= nc; c += kThreads)
    cb[c] = chunk_bits[f * (nc + 1) + c];
  __syncthreads();
}

// Stores the word block; the barrier after it frees smem for the next frame.
__device__ __forceinline__ void store(const int* smem, int* words, size_t f,
                                      int W) {
  __syncthreads();
  for (int w = threadIdx.x; w < W; w += kThreads) words[f * W + w] = smem[w];
  __syncthreads();
}

__device__ __forceinline__ void add_at(int* smem, int w, int value, int W) {
  if (value != 0 && w >= 0 && w < W) atomicAdd(smem + w, value);
}

// shared memory: word block [W], chunk bounds [nc + 1], early words [nc]
__global__ void __launch_bounds__(kThreads)
v2_kernel(const int* __restrict__ chunk_bits, const int* __restrict__ w0t,
          const int* __restrict__ hit, const int* __restrict__ lot,
          int* __restrict__ words, int nc, int W, int fb) {
  extern __shared__ int smem[];
  int* cb = smem + W;
  int* early = cb + nc + 1;   // 128 (r - ra) of each chunk
  const int S = kLane * nc;
  for (int i = 0; i < fb; ++i) {
    const size_t f = static_cast<size_t>(blockIdx.x) * fb + i;
    stage(smem, cb, chunk_bits, f, nc, W);
    if (threadIdx.x == 0) {
      int ra = 0;
      for (int c = 0; c < nc; ++c) {
        const int r = cb[c] >> 12;
        const int up = r < ra + 2 ? r : ra + 2;
        if (up > ra) ra = up;
        early[c] = (r - ra) * kLane;
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < S; j += kThreads) {
      const int w = w0t[f * S + j];
      const int h = hit[f * S + j];
      const int l = lot[f * S + j];
      const int c = j % nc;
      const int cw = cb[c] >> 5;
      const int rel = w - cw;
      const int p = rel >> 6;
      if (rel < 0 || p >= 4) continue;
      if (p > 0 && ((cb[c + 1] - 1) >> 5) - cw < 64 * p) continue;
      const int at = p == 0 ? w - early[c] : w;
      add_at(smem, at, h, W);
      add_at(smem, at + 1, l, W);
    }
    store(smem, words, f, W);
  }
}

// shared memory: word block [W], chunk bounds [nc + 1]
__global__ void __launch_bounds__(kThreads)
v3_kernel(const int* __restrict__ chunk_bits, const int* __restrict__ w0t,
          const int* __restrict__ hit, const int* __restrict__ lot,
          int* __restrict__ words, int nc, int W, int fb) {
  extern __shared__ int smem[];
  int* cb = smem + W;
  const int S = kLane * nc;
  for (int i = 0; i < fb; ++i) {
    const size_t f = static_cast<size_t>(blockIdx.x) * fb + i;
    stage(smem, cb, chunk_bits, f, nc, W);
    for (int j = threadIdx.x; j < S; j += kThreads) {
      const int w = w0t[f * S + j];
      const int h = hit[f * S + j];
      const int l = lot[f * S + j];
      const int c = j % nc;
      const int row0 = cb[c] >> 12;
      const int last_row = (((cb[c + 1] - 1) >> 5) + 1) >> 7;
      const int reach = last_row < row0 + 3 ? last_row : row0 + 3;
      const int rh = w >> 7;
      const int rl = (w + 1) >> 7;
      if (rh == row0 || (rh > row0 && rh <= reach)) add_at(smem, w, h, W);
      if (rl == row0 || (rl > row0 && rl <= reach)) add_at(smem, w + 1, l, W);
    }
    store(smem, words, f, W);
  }
}

typedef void (*Prototype)(const int*, const int*, const int*, const int*,
                          int*, int, int, int);

int launch(Prototype kernel, size_t shared_ints, const int* chunk_bits,
           const int* w0t, const int* hit, const int* lot, int* words, int F,
           int nc, int W, int fb, cudaStream_t stream) {
  if (F <= 0) return 0;
  if (fb <= 0 || F % fb != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = shared_ints * sizeof(int);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<F / fb, kThreads, bytes, stream>>>(chunk_bits, w0t, hit, lot,
                                              words, nc, W, fb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// chunk_bits int32 [F, nc + 1]; w0t, hit, lot int32 [F, 128, nc]
// -> words int32 [F, W], W a multiple of 128; fb divides F
extern "C" int flake_prof_merge_v2(
    const int* chunk_bits, const int* w0t, const int* hit, const int* lot,
    int* words, int F, int nc, int W, int fb, cudaStream_t stream) {
  return launch(v2_kernel, static_cast<size_t>(W) + 2 * nc + 1, chunk_bits,
                w0t, hit, lot, words, F, nc, W, fb, stream);
}

extern "C" int flake_prof_merge_v3(
    const int* chunk_bits, const int* w0t, const int* hit, const int* lot,
    int* words, int F, int nc, int W, int fb, cudaStream_t stream) {
  return launch(v3_kernel, static_cast<size_t>(W) + nc + 1, chunk_bits, w0t,
                hit, lot, words, F, nc, W, fb, stream);
}
