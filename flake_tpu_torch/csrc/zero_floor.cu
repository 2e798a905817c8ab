// The tools' zero floor: one kernel behind U1's zero variant and U3e / U3f.
//
// Replaces the TPU kernels util/prof_merge.py: k_zero (:228, built by _mk
// :141), util/prof_merge3.py: merge_zero_fb (k_zero_fb :841, :847) and
// merge_zero_rows (k_zero_rows :1013, :1019). Each writes int32 zeros of
// shape [F, word_rows, 128] and reads nothing: the launch-and-store floor of
// the merge it stands beside. On the TPU a program writes fb frames' word
// blocks; fb is that tiling and not part of what is computed, so here it
// only has to divide F, as the TPU grid needs.
//
// What bounds it on the card: the bytes it writes, 4 F W (8.9 MB on the
// tools' music batch: 0.0027 ms at 3.35 TB/s), and beside them the fixed
// cost of a launch, which chip_smoke.py reads from an empty kernel of the
// same grid (launch_floor_ms). Design: the grid is sized to the card, not
// to F / fb: one block of 256 threads an SM (fewer where F * W is small)
// walks the flat F * W ints with a grid stride, each thread issuing
// kInFlight 16-byte stores at a time. The ints before the output's first
// 16-byte boundary and after its last are written one at a time, so any
// int-aligned output and any F * W are taken. Two, four and eight blocks an
// SM, 512- and 1,024-thread blocks, two or eight stores in flight and
// streaming stores each read slower on an H100.
//
// The first design (a block per fb frames, one 4-byte store at a time) is
// kept in yardsticks/zero_floor_v1.cu, and the same floor by Hopper's bulk
// asynchronous store from a zeroed shared tile in yardsticks/
// zero_floor_bulk.cu; chip_smoke.py times both beside this one.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 1;
constexpr int kInFlight = 4;      // 16-byte stores a thread issues together

// words[0, head) and words[head + 4 n4, n) one int at a time (at most three
// each), words[head, head + 4 n4) by 16-byte stores.
__global__ void __launch_bounds__(kThreads)
zero_kernel(int* __restrict__ words, int head, size_t n4, size_t n) {
  const size_t tid = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  int4* body = reinterpret_cast<int4*>(words + head);
  const int4 zero = make_int4(0, 0, 0, 0);
  for (size_t i = tid; i < n4; i += kInFlight * stride) {
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      const size_t at = i + k * stride;
      if (at < n4) body[at] = zero;
    }
  }
  const size_t tail = head + 4 * n4;
  if (tid < static_cast<size_t>(head)) words[tid] = 0;
  if (tid < n - tail) words[tail + tid] = 0;
}

int launch_zero(int* words, int F, int W, cudaStream_t stream) {
  if (F <= 0 || W <= 0) return 0;
  const size_t n = static_cast<size_t>(F) * W;
  size_t head = (16 - reinterpret_cast<uintptr_t>(words) % 16) % 16 / 4;
  if (head > n) head = n;
  const size_t n4 = (n - head) / 4;
  int device = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const size_t per_block = static_cast<size_t>(kThreads) * kInFlight;
  size_t blocks = (n4 + per_block - 1) / per_block;
  if (blocks > static_cast<size_t>(sms) * kBlocksPerSm)
    blocks = static_cast<size_t>(sms) * kBlocksPerSm;
  if (blocks < 1) blocks = 1;
  zero_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      words, static_cast<int>(head), n4, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// U1's zero variant, with K5's operands (none of them read) -> words int32
// [F, W] of zeros
extern "C" int flake_prof_merge_zero(const int*, const int*, const int*,
                                     const int*, int* words, int F, int,
                                     int W, cudaStream_t stream) {
  return launch_zero(words, F, W, stream);
}

// U3e and U3f: v5c's operands (zero_fb) and v5d's (zero_rows), none of them
// read -> words int32 [F, W] of zeros; fb must divide F and does not shape
// the launch
extern "C" int flake_prof_merge_zero_fb(
    const int*, const int*, const int*, const int*, const int*, const int*,
    const int*, const int*, const int*, const int*, const int*, const int*,
    const int*, int* words, int F, int, int, int W, int fb,
    cudaStream_t stream) {
  if (F > 0 && (fb <= 0 || F % fb != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_zero(words, F, W, stream);
}

extern "C" int flake_prof_merge_zero_rows(
    const int*, const int*, const int*, const int*, const int*, const int*,
    const int*, const int*, const int*, const int*, const int*, const int*,
    const int*, int* words, int F, int, int, int W, int fb,
    cudaStream_t stream) {
  if (F > 0 && (fb <= 0 || F % fb != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_zero(words, F, W, stream);
}
