// A second form of the tools' zero floor (../zero_floor.cu), kept only as a
// yardstick: chip_smoke.py builds it beside the kernel and times both on the
// same output in one run. No path of the package calls it.
//
// The same function, int32 zeros of shape [F, W] and nothing read, by
// Hopper's bulk asynchronous store: each block zeroes a 16 KiB tile of
// shared memory once, and one of its threads hands whole tiles to the copy
// engine (cp.async.bulk.global.shared::cta, one bulk group), which writes
// them to consecutive 16 KiB pieces of the output with no further
// instruction from the threads; the block waits for the group to have read
// the tile before it exits. The pieces are spread over the blocks with a
// grid stride; the ints before the first 16-byte boundary and after the last
// are written one at a time.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 16384;
constexpr int kBlocksPerSm = 4;

__global__ void __launch_bounds__(kThreads)
bulk_zero_kernel(int* __restrict__ words, int head, size_t n4, size_t n) {
  __shared__ __align__(128) int4 tile[kTileBytes / 16];
  for (int i = threadIdx.x; i < kTileBytes / 16; i += kThreads)
    tile[i] = make_int4(0, 0, 0, 0);
  // the zeros written by the threads become visible to the copy engine
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    char* body = reinterpret_cast<char*>(words + head);
    const size_t bytes = 16 * n4;
    const unsigned src =
        static_cast<unsigned>(__cvta_generic_to_shared(tile));
    for (size_t off = static_cast<size_t>(blockIdx.x) * kTileBytes;
         off < bytes; off += static_cast<size_t>(gridDim.x) * kTileBytes) {
      const unsigned size = static_cast<unsigned>(
          bytes - off < kTileBytes ? bytes - off : kTileBytes);
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
          :: "l"(body + off), "r"(src), "r"(size) : "memory");
    }
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
  if (blockIdx.x == 0) {
    const size_t tail = head + 4 * n4;
    if (static_cast<int>(threadIdx.x) < head) words[threadIdx.x] = 0;
    if (threadIdx.x < n - tail) words[tail + threadIdx.x] = 0;
  }
}

}  // namespace

// -> words int32 [F, W] of zeros
extern "C" int flake_zero_floor_bulk(int* words, int F, int W,
                                     cudaStream_t stream) {
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
  size_t blocks = (16 * n4 + kTileBytes - 1) / kTileBytes;
  if (blocks > static_cast<size_t>(sms) * kBlocksPerSm)
    blocks = static_cast<size_t>(sms) * kBlocksPerSm;
  if (blocks < 1) blocks = 1;
  bulk_zero_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      words, static_cast<int>(head), n4, n);
  return static_cast<int>(cudaGetLastError());
}
