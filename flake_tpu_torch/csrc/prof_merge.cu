// U1: three of the four variants of K5 (bitmerge_aligned.cu) for the
// emission profiling tool, flake_tpu_torch/util/prof_merge.py; the fourth,
// zero, is the tools' one zero floor in zero_floor.cu.
//
// Replaces the TPU kernels built by util/prof_merge.py: _mk (bodies
// k_static2, k_fixedrow, k_nowin). On the TPU each variant drops
// one part of the merge kernel to show what that part costs: the loop
// over the word rows a chunk can touch, the row-dependent store, the
// 128 x 128 compares. Two of them (fixedrow, nowin) compute wrong words
// on purpose, but each is a fixed function of its inputs, in int32 with
// wraparound, and the port computes the same functions:
//
//   static2   the K5 sum, restricted per chunk to the word rows row0 and
//             row0 + 1 (equal to K5 where no chunk touches three rows);
//   fixedrow  for every row from row0 to last_row of a chunk, the parts
//             that fall into that row are added into row 0 at their lane;
//   nowin     every row from row0 to last_row of a chunk gets the sum of
//             the chunk's hi words on all 128 lanes.
//
// row0 = chunk_bits[c] >> 12 and last_row = max((((chunk_bits[c + 1] - 1)
// >> 5) + 1) >> 7, row0), with signed shifts and the subtraction wrapping
// in int32 (an end of INT32_MIN gives the largest row, 524,288), as the TPU
// kernels compute them. A row at or past the block's word rows is never
// written.
//
// What bounds them on the card: bytes (12 bytes per slot read, the word
// block written once), as K5. Design as K5: one block per frame, the
// chunk bounds and the word block in shared memory, inputs read in memory
// order (the chunk of element j of a frame's [128, nc] array is j % nc),
// shared-memory atomicAdd on int, whose wraparound is int32 addition in
// any order, one coalesced store.
//
// The file also holds flake_spin_us, a timing aid and no part of U1: one
// thread that keeps the stream busy for a given time, behind which the
// tool enqueues short kernels so that they run back to back.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kLane = 128;

// the first and last word row chunk c can touch
__device__ __forceinline__ void chunk_rows(const int* cb, int c, int* row0,
                                           int* last_row) {
  *row0 = cb[c] >> 12;
  // unsigned, so that an end of INT32_MIN wraps instead of overflowing
  const int end = static_cast<int>(static_cast<unsigned>(cb[c + 1]) - 1u);
  const int last = ((end >> 5) + 1) >> 7;
  *last_row = last > *row0 ? last : *row0;
}

// shared memory: word block [W] then the frame's chunk bounds [nc + 1]
__device__ __forceinline__ int* stage(int* smem, const int* chunk_bits,
                                      size_t f, int nc, int W) {
  int* cb = smem + W;
  for (int w = threadIdx.x; w < W; w += kThreads) smem[w] = 0;
  for (int c = threadIdx.x; c <= nc; c += kThreads)
    cb[c] = chunk_bits[f * (nc + 1) + c];
  __syncthreads();
  return cb;
}

__device__ __forceinline__ void store(const int* smem, int* words, size_t f,
                                      int W) {
  __syncthreads();
  for (int w = threadIdx.x; w < W; w += kThreads) words[f * W + w] = smem[w];
}

__global__ void __launch_bounds__(kThreads)
static2_kernel(const int* __restrict__ chunk_bits,
               const int* __restrict__ w0t, const int* __restrict__ hit,
               const int* __restrict__ lot, int* __restrict__ words, int nc,
               int W) {
  extern __shared__ int smem[];
  const size_t f = blockIdx.x;
  const int* cb = stage(smem, chunk_bits, f, nc, W);
  const int S = kLane * nc;
  for (int j = threadIdx.x; j < S; j += kThreads) {
    const int w = w0t[f * S + j];
    const int h = hit[f * S + j];
    const int l = lot[f * S + j];
    const int row0 = cb[j % nc] >> 12;
    const int rh = w >> 7;
    const int rl = (w + 1) >> 7;
    if (h != 0 && w >= 0 && w < W && (rh == row0 || rh == row0 + 1))
      atomicAdd(smem + w, h);
    if (l != 0 && w + 1 >= 0 && w + 1 < W && (rl == row0 || rl == row0 + 1))
      atomicAdd(smem + w + 1, l);
  }
  store(smem, words, f, W);
}

__global__ void __launch_bounds__(kThreads)
fixedrow_kernel(const int* __restrict__ chunk_bits,
                const int* __restrict__ w0t, const int* __restrict__ hit,
                const int* __restrict__ lot, int* __restrict__ words, int nc,
                int W) {
  extern __shared__ int smem[];
  const size_t f = blockIdx.x;
  const int* cb = stage(smem, chunk_bits, f, nc, W);
  const int S = kLane * nc;
  for (int j = threadIdx.x; j < S; j += kThreads) {
    const int w = w0t[f * S + j];
    const int h = hit[f * S + j];
    const int l = lot[f * S + j];
    int row0, last_row;
    chunk_rows(cb, j % nc, &row0, &last_row);
    const int rh = w >> 7;
    const int rl = (w + 1) >> 7;
    if (h != 0 && rh >= row0 && rh <= last_row)
      atomicAdd(smem + (w & (kLane - 1)), h);
    if (l != 0 && rl >= row0 && rl <= last_row)
      atomicAdd(smem + ((w + 1) & (kLane - 1)), l);
  }
  store(smem, words, f, W);
}

__global__ void __launch_bounds__(kThreads)
nowin_kernel(const int* __restrict__ chunk_bits, const int* __restrict__ w0t,
             const int* __restrict__ hit, const int* __restrict__ lot,
             int* __restrict__ words, int nc, int W) {
  // shared memory: row sums [W / 128], chunk bounds [nc + 1], chunk hi
  // sums [nc]; every lane of a row holds the row's sum
  extern __shared__ int smem[];
  const size_t f = blockIdx.x;
  const int rows = W / kLane;
  const int* cb = stage(smem, chunk_bits, f, nc, rows);
  int* chunk_hi = smem + rows + nc + 1;
  for (int c = threadIdx.x; c < nc; c += kThreads) chunk_hi[c] = 0;
  __syncthreads();
  const int S = kLane * nc;
  for (int j = threadIdx.x; j < S; j += kThreads) {
    const int h = hit[f * S + j];
    if (h != 0) atomicAdd(chunk_hi + j % nc, h);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < nc; c += kThreads) {
    int row0, last_row;
    chunk_rows(cb, c, &row0, &last_row);
    if (row0 < 0) row0 = 0;
    for (int row = row0; row <= last_row && row < rows; ++row)
      atomicAdd(smem + row, chunk_hi[c]);
  }
  __syncthreads();
  for (int w = threadIdx.x; w < W; w += kThreads)
    words[f * W + w] = smem[w / kLane];
}

// Busy-wait on the nanosecond timer; the cycle counter ends the wait too
// (the SM clock stays under 4 GHz), should the timer stand still.
__global__ void spin_kernel(unsigned long long ns) {
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  const long long c0 = clock64();
  do {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  } while (t - t0 < ns &&
           static_cast<unsigned long long>(clock64() - c0) < 4 * ns);
}

typedef void (*Variant)(const int*, const int*, const int*, const int*, int*,
                        int, int);

int launch(Variant kernel, size_t shared_ints, const int* chunk_bits,
           const int* w0t, const int* hit, const int* lot, int* words, int F,
           int nc, int W, cudaStream_t stream) {
  if (F <= 0) return 0;
  const size_t bytes = shared_ints * sizeof(int);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<F, kThreads, bytes, stream>>>(chunk_bits, w0t, hit, lot, words,
                                         nc, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// chunk_bits int32 [F, nc + 1]; w0t, hit, lot int32 [F, 128, nc]
// -> words int32 [F, W], W a multiple of 128
extern "C" int flake_prof_merge_static2(
    const int* chunk_bits, const int* w0t, const int* hit, const int* lot,
    int* words, int F, int nc, int W, cudaStream_t stream) {
  return launch(static2_kernel, static_cast<size_t>(W) + nc + 1, chunk_bits,
                w0t, hit, lot, words, F, nc, W, stream);
}

extern "C" int flake_prof_merge_fixedrow(
    const int* chunk_bits, const int* w0t, const int* hit, const int* lot,
    int* words, int F, int nc, int W, cudaStream_t stream) {
  return launch(fixedrow_kernel, static_cast<size_t>(W) + nc + 1, chunk_bits,
                w0t, hit, lot, words, F, nc, W, stream);
}

extern "C" int flake_prof_merge_nowin(
    const int* chunk_bits, const int* w0t, const int* hit, const int* lot,
    int* words, int F, int nc, int W, cudaStream_t stream) {
  return launch(nowin_kernel, static_cast<size_t>(W / kLane) + 2 * nc + 1,
                chunk_bits, w0t, hit, lot, words, F, nc, W, stream);
}

// keeps the stream busy for `us` microseconds
extern "C" int flake_spin_us(int us, cudaStream_t stream) {
  if (us <= 0) return 0;
  spin_kernel<<<1, 1, 0, stream>>>(1000ull * static_cast<unsigned>(us));
  return static_cast<int>(cudaGetLastError());
}
