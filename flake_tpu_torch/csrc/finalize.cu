// Z: the analysis' finalize in one launch. The CONSTANT override
// (optimize.c:143-151), the exact frame sizes, the 32-bit unfit override,
// the verbatim fallback of frames over the uncompressed bound
// (encode.c:949-964) and the header type codes, from the [F, C] tables;
// and the samples copied into the residual where a subframe ends up
// stored raw.
//
// No Pallas kernel stands behind it. The JAX package writes this step as
// tensor code inside its one jitted analysis program
// (flake_tpu/ops/frame.py:188-261, finalize_analysis), where XLA fuses
// it. The port's plain version (ops/frame.finalize_analysis_plain) runs it
// eagerly: about 70 small-table launches and three torch.where's over the
// whole [F, C, B] residual, each reading the samples and the residual and
// writing a new tensor.
//
// Arithmetic, the plain version's, in int64 where it is. A channel is
// CONSTANT where its constant flag is set (order 0). Its body bits are obits
// (CONSTANT), n * obits (VERBATIM), order * obits + 6 + the exact Rice bits
// (FIXED) or order * obits + 9 + order * precision + 6 + the exact Rice
// bits (LPC); with 8 + wasted header bits each, summed over the channels
// with the frame header's bits, a frame is ((bits + 7) >> 3) + 2 bytes.
// Where the caller passes the unfit flags (LPC subframes whose exact
// residual leaves int32 under a shifted prediction), an unfit subframe that
// is not CONSTANT, in a frame within the bound, becomes VERBATIM and the
// frame is sized again. A frame over the bound (P.max_frame_size) becomes
// VERBATIM whole and takes the verbatim size. The type code is 8 + order
// (FIXED), 32 + order - 1 (LPC), else the type.
//
// What bounds it on the card: bytes, the [F, C] tables read and written
// once (about 2 MB on a 12,288-frame stereo batch) plus the rows it
// copies, each read from the samples and written into the residual once.
// Design: skip the rows that are already right. R2 (or on the VERBATIM path
// the samples themselves) has already written every row that keeps its
// prediction, so only the rows stored raw (CONSTANT, unfit, or in an
// over-size frame) are copied: on most frames none, and a frame with none
// reads its scalars and writes no residual byte. A warp a frame, eight
// frames a block: lane c takes channel c's scalars, the frame's sums are
// shuffle sums, and a ballot of the raw rows hands the warp each row to
// copy, int4 loads and stores where source and destination share their
// offset from a 16-byte boundary, ints at the edges (and for the samples
// of a strided view). The residual is updated in place: it is the
// analysis' own tensor, R2's fresh output or the sp path's rank-0 slice,
// which that path overrides the same way afterwards. Where the residual is
// the samples' own tensor (the VERBATIM path), the copy is switched off.
// The row length is the residual's, which on the sp path is a rank's slice
// of the block, while the sizes take the block size n.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = kThreads / 32;           // a warp a frame
constexpr int kMaxC = 8;                         // FLAC's channels
constexpr unsigned kFull = 0xffffffffu;

// subframe types (ops/frame.py)
constexpr int kConstant = 0;
constexpr int kVerbatim = 1;
constexpr int kFixed = 8;
constexpr int kLpc = 32;

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// a frame's bytes from its bits: byte-aligned, then the CRC-16
__device__ __forceinline__ long long frame_bytes_of(long long bits) {
  return ((bits + 7) >> 3) + 2;
}

// one row of L samples (src at a stride of sB ints) into dst, by the warp
__device__ __forceinline__ void copy_row(const int* __restrict__ src,
                                         long long sB, int* __restrict__ dst,
                                         int L, int lane) {
  const auto s = reinterpret_cast<uintptr_t>(src);
  const auto d = reinterpret_cast<uintptr_t>(dst);
  if (sB != 1) {
    for (int i = lane; i < L; i += 32) dst[i] = src[i * sB];
    return;
  }
  if ((s ^ d) & 15) {
    for (int i = lane; i < L; i += 32) dst[i] = src[i];
    return;
  }
  int head = static_cast<int>(((16 - (d & 15)) & 15) >> 2);
  if (head > L) head = L;
  if (lane < head) dst[lane] = src[lane];
  const int quads = (L - head) >> 2;
  const auto* s4 = reinterpret_cast<const int4*>(src + head);
  auto* d4 = reinterpret_cast<int4*>(dst + head);
#pragma unroll 4
  for (int i = lane; i < quads; i += 32) d4[i] = s4[i];
  for (int i = head + 4 * quads + lane; i < L; i += 32) dst[i] = src[i];
}

__global__ void __launch_bounds__(kThreads) finalize_kernel(
    const int* __restrict__ chans, int* __restrict__ res,
    const int* __restrict__ obits, const int* __restrict__ wasted,
    const unsigned char* __restrict__ constant,
    const int* __restrict__ sf_in, const int* __restrict__ order_in,
    const long long* __restrict__ exact,
    const unsigned char* __restrict__ unfit, const int* __restrict__ hdr,
    int* __restrict__ sf_out, int* __restrict__ order_out,
    int* __restrict__ type_code, long long* __restrict__ frame_bytes, int F,
    int C, int L, int n, int vsize, int precision, long long sF,
    long long sC, long long sB, int copy) {
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kFrames + (threadIdx.x >> 5);
  if (f >= F) return;                            // the whole warp
  const bool mine = lane < C;
  const long long at = static_cast<long long>(f) * C + lane;

  bool ct = false, u = false;
  int st = kConstant, ord = 0;
  long long ob = 0, sub_hdr = 0, body = 0;
  if (mine) {
    ct = constant[at] != 0;
    st = ct ? kConstant : sf_in[at];
    ord = ct ? 0 : order_in[at];
    ob = obits[at];
    sub_hdr = 8 + static_cast<long long>(wasted[at]);
    const long long ex = exact ? exact[at] : 0;
    const long long o = ord;
    body = st == kConstant   ? ob
           : st == kVerbatim ? n * ob
           : st == kFixed    ? o * ob + 6 + ex
                             : o * ob + 9 + o * precision + 6 + ex;
    u = unfit && unfit[at];
  }
  const long long h = hdr[f];
  long long bytes = frame_bytes_of(h + warp_sum(sub_hdr + body));
  if (unfit) {
    u = u && st != kConstant && bytes <= vsize;
    if (u) st = kVerbatim, ord = 0;
    bytes = frame_bytes_of(h + warp_sum(sub_hdr + (u ? n * ob : body)));
  }
  const bool fb = bytes > vsize;                 // the same on every lane
  if (fb) {
    st = kVerbatim;
    ord = 0;
    bytes = frame_bytes_of(h + warp_sum(sub_hdr + n * ob));
  }
  if (mine) {
    sf_out[at] = st;
    order_out[at] = ord;
    type_code[at] = st == kFixed ? kFixed + ord
                    : st == kLpc ? kLpc + ord - 1
                                 : st;
  }
  if (lane == 0) frame_bytes[f] = bytes;
  if (!copy) return;
  // the rows stored raw, whose residual must hold the samples
  for (unsigned raw = __ballot_sync(kFull, ct || u || (mine && fb)); raw;
       raw &= raw - 1) {
    const int c = __ffs(raw) - 1;
    copy_row(chans + f * sF + c * sC, sB,
             res + (static_cast<long long>(f) * C + c) * L, L, lane);
  }
}

}  // namespace

extern "C" int flake_finalize(
    const int* chans, int* res, const int* obits, const int* wasted,
    const unsigned char* constant, const int* sf_type, const int* order,
    const long long* exact, const unsigned char* unfit, const int* hdr,
    int* sf_out, int* order_out, int* type_code, long long* frame_bytes,
    int F, int C, int L, int n, int vsize, int precision, int sF, int sC,
    int sB, int copy, cudaStream_t stream) {
  if (C < 1 || C > kMaxC || L < 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (F <= 0) return static_cast<int>(cudaGetLastError());
  finalize_kernel<<<(F + kFrames - 1) / kFrames, kThreads, 0, stream>>>(
      chans, res, obits, wasted, constant, sf_type, order, exact, unfit, hdr,
      sf_out, order_out, type_code, frame_bytes, F, C, L, n, vsize, precision,
      sF, sC, sB, copy);
  return static_cast<int>(cudaGetLastError());
}
