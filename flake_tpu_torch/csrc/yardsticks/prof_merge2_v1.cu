// The first designs of these kernels, kept unchanged apart from the entry
// points' names, only as yardsticks: chip_smoke.py builds them beside the
// current design (../prof_merge2.cu) and times both on the same inputs in one
// run. No path of the package calls them; they are not part of the package's
// kernel library (flake_tpu_torch/_cuda.py builds csrc/*.cu only).
//
// U2a merge_v2 (util/prof_merge2.py:224, body k_v2 :193, _frame_body :111)
// and U2b merge_v3 (:353, body k_v3 :328, _frame_body_s2w :295): K5's sum
// out[w0] += hi, out[w0 + 1] += lo, in int32 with wraparound, restricted and
// displaced as ../prof_merge2.cu states. The first designs kept the TPU's
// geometry: a block of 512 threads takes fb consecutive frames, one after
// the other through one word block in shared memory, so the grid has F / fb
// blocks; every slot pays a j % nc and three 4-byte loads, and for v2 thread
// 0 alone walks the chunks for the carry rows while the others wait.

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

}  // namespace

// chunk_bits int32 [F, nc + 1]; w0t, hit, lot int32 [F, 128, nc]
// -> words int32 [F, W], W a multiple of 128; fb divides F
extern "C" int flake_prof_merge_v2_v1(
    const int* chunk_bits, const int* w0t, const int* hit, const int* lot,
    int* words, int F, int nc, int W, int fb, cudaStream_t stream) {
  if (F <= 0) return 0;
  if (fb <= 0 || F % fb != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = (static_cast<size_t>(W) + 2 * nc + 1) * sizeof(int);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  v2_kernel<<<F / fb, kThreads, bytes, stream>>>(chunk_bits, w0t, hit, lot,
                                                 words, nc, W, fb);
  return static_cast<int>(cudaGetLastError());
}

// as v2, the v3 rule
extern "C" int flake_prof_merge_v3_v1(
    const int* chunk_bits, const int* w0t, const int* hit, const int* lot,
    int* words, int F, int nc, int W, int fb, cudaStream_t stream) {
  if (F <= 0) return 0;
  if (fb <= 0 || F % fb != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = (static_cast<size_t>(W) + nc + 1) * sizeof(int);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        v3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  v3_kernel<<<F / fb, kThreads, bytes, stream>>>(chunk_bits, w0t, hit, lot,
                                                 words, nc, W, fb);
  return static_cast<int>(cudaGetLastError());
}
