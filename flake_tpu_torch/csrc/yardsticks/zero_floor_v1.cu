// The first design of this kernel, kept unchanged apart from the entry
// point, only as a yardstick: chip_smoke.py builds it beside the current
// design (../zero_floor.cu) and times both on the same output in one run.
// No path of the package calls it; it is not part of the package's kernel
// library (flake_tpu_torch/_cuda.py builds csrc/*.cu only).
//
// The tools' zero floor (U1's k_zero, U3e merge_zero_fb, U3f
// merge_zero_rows of util/prof_merge.py and util/prof_merge3.py): int32
// zeros of shape [F, W], nothing read. The first design kept the TPU's
// geometry: a block of 512 threads writes the fb word blocks of one TPU
// program, one 4-byte store at a time, so the grid has F / fb blocks (64 at
// fb = 8 on the tools' 512 frames, for 132 SMs). U1's copy launched F
// blocks: the same kernel at fb = 1.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

// Writes the fb word blocks of a program; reads nothing.
__global__ void __launch_bounds__(kThreads)
zero_kernel(int* __restrict__ words, int W, int fb) {
  const size_t n = static_cast<size_t>(fb) * W;
  int* out = words + static_cast<size_t>(blockIdx.x) * n;
  for (size_t w = threadIdx.x; w < n; w += kThreads) out[w] = 0;
}

}  // namespace

// -> words int32 [F, W] of zeros; fb divides F
extern "C" int flake_zero_floor_v1(int* words, int F, int W, int fb,
                                   cudaStream_t stream) {
  if (F <= 0) return 0;
  if (fb <= 0 || F % fb != 0) return static_cast<int>(cudaErrorInvalidValue);
  zero_kernel<<<F / fb, kThreads, 0, stream>>>(words, W, fb);
  return static_cast<int>(cudaGetLastError());
}
