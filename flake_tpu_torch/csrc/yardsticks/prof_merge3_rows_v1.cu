// The first design of these kernels, kept unchanged apart from the entry
// points' names, only as a yardstick: chip_smoke.py builds it beside the
// current design (../prof_merge3_rows.cu) and times both on the same inputs
// in one run. No path of the package calls it; it is not part of the
// package's kernel library (flake_tpu_torch/_cuda.py builds csrc/*.cu only).
//
// U3c merge_v5d (util/prof_merge3.py:653, body k_v5d :612) and U3d merge_v5c
// (:714, body k_v5c :677): the row-layout combined-node merges, whose
// function ../prof_merge3_rows.cu states. The first design kept the TPU's
// geometry: a block of 512 threads takes fb consecutive frames, one after
// the other through one word block in shared memory, so the grid has F / fb
// blocks; every node pays a 4-byte load of each array, and v5c reads w0 of
// element j = 128 c + s at s * nc + c, neighbouring threads nc ints apart.

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
extern "C" int flake_prof_merge_v5d_v1(
    const int* cb2, const int* cb1, const int* mw, const int* ma,
    const int* mb, const int* mc, const int* s2w, const int* s2a,
    const int* s2b, const int* s2c, const int* s1w, const int* s1a,
    const int* s1b, int* words, int F, int nc2, int nc1, int W, int fb,
    int kmax, int kmax1, cudaStream_t stream) {
  return launch<false>(cb2, cb1, mw, ma, mb, mc, s2w, s2a, s2b, s2c, s1w, s1a,
                       s1b, words, F, nc2, nc1, W, fb, kmax, kmax1, stream);
}

// as v5d, but mw, s2w int32 [F, 128, nc2] and s1w int32 [F, 128, nc1]
extern "C" int flake_prof_merge_v5c_v1(
    const int* cb2, const int* cb1, const int* mw, const int* ma,
    const int* mb, const int* mc, const int* s2w, const int* s2a,
    const int* s2b, const int* s2c, const int* s1w, const int* s1a,
    const int* s1b, int* words, int F, int nc2, int nc1, int W, int fb,
    int kmax, int kmax1, cudaStream_t stream) {
  return launch<true>(cb2, cb1, mw, ma, mb, mc, s2w, s2a, s2b, s2c, s1w, s1a,
                      s1b, words, F, nc2, nc1, W, fb, kmax, kmax1, stream);
}
