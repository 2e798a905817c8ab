// U3c-U3d: the row-layout combined-node merges of
// flake_tpu_torch/util/prof_merge3.py (their zero floors, U3e and U3f, are
// the tools' one zero floor in zero_floor.cu).
//
// Replaces the TPU kernels util/prof_merge3.py: merge_v5d (body k_v5d,
// _mxu_chunk_d) and merge_v5c (body k_v5c, _mxu_chunk). The inputs are the
// three node sets that v5d_parts / v5c_parts make of a frame's slots: main
// and sp2, each w0 and (A, B, C), and sp1, w0 and (A, B), with cb2
// [F, nc2 + 1] and cb1 [F, nc1 + 1], whose low 31 bits are the bit offset of
// a chunk's first node and whose bit 31 says that the chunk of sp2 or sp1
// holds a spill at all.
// The words A, B, C lie in rows, int32 [F, nc, 128]: a chunk is 512
// contiguous bytes. w0 lies in rows too for v5d and in chunks, int32
// [F, 128, nc], for v5c.
//
// On the TPU a chunk's nodes are placed by one one-hot matrix product per
// word row (the words split into 8-bit quarters so that the sums stay exact),
// over a static number of rows from the chunk's first, with B and C rolled
// one and two lanes and carried into the next row. The products, the rolls
// and the row gate of v5d are how; what both bodies compute is ported:
//
//   row0 = (cb[c] & 0x7fffffff) >> 12 is chunk c's first word row. A node of
//   chunk c with w0 >= 128 row0 adds A at w0, B at w0 + 1 and C at w0 + 2, in
//   int32 with wraparound, each only where its word lies before
//   128 (row0 + K): K = kmax for main and sp2 (both by cb2's row0; sp2 only
//   where cb2[c] < 0), K = kmax1 for sp1 (cb1's row0, only where cb1[c] < 0,
//   A and B only).
//
// A word at or past W is never written (the TPU bodies index row0 + dr
// without a bound), and w0 + 1, w0 + 2 are compared without overflow.
//
// What bounds the merges on the card: bytes (16 bytes per main node, the
// flagged spill chunks, the word block written once: 27.8 MB, 0.0083 ms, on
// the tools' music batch).
//
// Design for the card (rows_kernel): one block per frame, whatever the TPU
// tool's fb (frames per program) is, so that no frame waits behind another
// and the tools' 512 frames run in one wave. The frame's word block lies in
// shared memory; nodes add with shared-memory atomicAdd on int (int32
// addition in any order) and the block is stored with 16-byte writes. A
// warp takes one chunk at a time: in rows a chunk's 128 nodes are 512
// contiguous bytes of each array, so each lane loads four nodes of w0, A, B
// and C with one 16-byte load each. A frame's chunks of all three sets are
// one list of tasks (main, then sp2, then sp1); warp w takes tasks w, w +
// warps, ... Each lane reads the chunk entry of one of its warp's tasks,
// and one ballot tells the warp which of them hold nodes to add: a main
// chunk always, a spill chunk only where its entry is negative, so an
// unflagged spill chunk costs no load. A warp loads its next chunk as soon
// as it has added the one before, its first before the block's barrier
// (while the block zeroes its word block). A frame's arrays start 512 nc
// bytes apart, so the loads are aligned wherever the arrays and the output
// are (else the same walk loads one node at a time).
//
// v5c (kDual) reads each w0 from the chunk layout [128, nc], where a
// chunk's column is 128 ints nc apart: a lane reads its four nodes one at a
// time. The warps take neighbouring chunks at once, whose columns share
// sectors, so most of these reads hit L1.
//
// Staging the main set's w0 (or sp2's too) transposed in shared memory,
// blocks of 128 or 512 threads (at 64 registers an SM holds two of 512,
// so 512 frames take two waves) and a grid of one or two blocks an SM that
// walks the frames each read slower on an H100
// (yardsticks/prof_merge3_rows_alt.cu, a copy of this body with those forms
// open, times them for chip_smoke.py). The first design (a block per fb
// frames, one node a thread) is yardsticks/prof_merge3_rows_v1.cu.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLane = 128;
constexpr int kMask31 = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The operands of one launch: the chunk entries cb2 [F, nc2 + 1] and cb1
// [F, nc1 + 1], and of each set (main, sp2, sp1) w0 and A, B, C (sp1: no C).
struct Nodes {
  const int* cb2;
  const int* cb1;
  const int* w0[3];
  const int* val[3][3];
  int nc2, nc1, W, kmax, kmax1;
};

struct Quads {
  int4 w, a, b, c;
};

template <bool kVec>
__device__ __forceinline__ int4 load4(const int* p) {
  if (kVec) return *reinterpret_cast<const int4*>(p);
  return make_int4(p[0], p[1], p[2], p[3]);
}

// Task t of a frame: set 0 (main), 1 (sp2) or 2 (sp1) and its chunk.
__device__ __forceinline__ int split_task(int t, int nc2, int* chunk) {
  const int set = (t >= nc2) + (t >= 2 * nc2);
  *chunk = t - set * nc2;
  return set;
}

// The lane's task base + kWarps * lane: its chunk entry, and whether it
// holds nodes to add. Returns the warp's ballot of the latter.
__device__ __forceinline__ unsigned task_mask(const Nodes& n, size_t f,
                                              int base, int T, int* entry) {
  const int t = base + kWarps * static_cast<int>(threadIdx.x & 31);
  bool work = false;
  *entry = 0;
  if (t < T) {
    int c;
    const int set = split_task(t, n.nc2, &c);
    *entry = set == 2 ? n.cb1[f * (n.nc1 + 1) + c]
                      : n.cb2[f * (n.nc2 + 1) + c];
    work = set == 0 || *entry < 0;
  }
  return __ballot_sync(0xffffffffu, work);
}

__device__ __forceinline__ int pop(unsigned* todo) {
  const int i = __ffs(*todo) - 1;
  *todo &= *todo - 1;
  return i;
}

// The lane's four nodes of task t.
template <bool kDual, bool kVec>
__device__ __forceinline__ Quads load_task(const Nodes& n, size_t f, int t) {
  int c;
  const int set = split_task(t, n.nc2, &c);
  const int nc = set == 2 ? n.nc1 : n.nc2;
  const int s = 4 * static_cast<int>(threadIdx.x & 31);
  const size_t at = (f * nc + c) * kLane + s;
  // selects, not a dynamic index into the parameters (which would copy them
  // to local memory)
  const int* a = set == 0 ? n.val[0][0] : set == 1 ? n.val[1][0] : n.val[2][0];
  const int* b = set == 0 ? n.val[0][1] : set == 1 ? n.val[1][1] : n.val[2][1];
  const int* w0 = set == 0 ? n.w0[0] : set == 1 ? n.w0[1] : n.w0[2];
  Quads q;
  q.a = load4<kVec>(a + at);
  q.b = load4<kVec>(b + at);
  q.c = set == 2 ? make_int4(0, 0, 0, 0)
                 : load4<kVec>((set == 0 ? n.val[0][2] : n.val[1][2]) + at);
  if (!kDual) {
    q.w = load4<kVec>(w0 + at);
  } else {
    const int* col = w0 + f * kLane * nc + c;
    q.w = make_int4(col[s * nc], col[(s + 1) * nc], col[(s + 2) * nc],
                    col[(s + 3) * nc]);
  }
  return q;
}

// Adds the lane's four nodes of task t, whose chunk entry is `entry`.
__device__ __forceinline__ void add_task(int* block_words, const Nodes& n,
                                         int t, int entry, const Quads& q) {
  int c;
  const int set = split_task(t, n.nc2, &c);
  const int first = ((entry & kMask31) >> 12) * kLane;
  // w >= first >= 0, so w + k < end is w < end - k, which cannot overflow
  const int end = min(first + (set == 2 ? n.kmax1 : n.kmax) * kLane, n.W);
  const int ws[4] = {q.w.x, q.w.y, q.w.z, q.w.w};
  const int as[4] = {q.a.x, q.a.y, q.a.z, q.a.w};
  const int bs[4] = {q.b.x, q.b.y, q.b.z, q.b.w};
  const int cs[4] = {q.c.x, q.c.y, q.c.z, q.c.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int w = ws[k];
    if (w < first) continue;
    if (as[k] != 0 && w < end) atomicAdd(block_words + w, as[k]);
    if (bs[k] != 0 && w < end - 1) atomicAdd(block_words + w + 1, bs[k]);
    if (cs[k] != 0 && w < end - 2) atomicAdd(block_words + w + 2, cs[k]);
  }
}

// shared memory: the frame's word block [W]. One block a frame.
template <bool kDual, bool kVec>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
rows_kernel(const Nodes n, int* __restrict__ words) {
  extern __shared__ int4 shared4[];
  int* block_words = reinterpret_cast<int*>(shared4);
  const size_t f = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int T = 2 * n.nc2 + n.nc1;
  // the warp's tasks base + kWarps i, 32 at a time; its first, a main chunk
  // where there is one, is loaded before its entry is known
  int base = warp;
  int i = -1;
  Quads cur;
  if (base < n.nc2) {
    i = 0;
    cur = load_task<kDual, kVec>(n, f, base);
  }
  int entry;
  unsigned todo = task_mask(n, f, base, T, &entry);
  if (i == 0) {
    todo &= ~1u;
  } else if (todo) {
    i = pop(&todo);
    cur = load_task<kDual, kVec>(n, f, base + kWarps * i);
  }
  for (int w = threadIdx.x; w < n.W / 4; w += kThreads)
    shared4[w] = make_int4(0, 0, 0, 0);
  __syncthreads();
  while (true) {
    while (i >= 0) {
      int next = -1;
      Quads ahead;
      if (todo) {
        next = pop(&todo);
        ahead = load_task<kDual, kVec>(n, f, base + kWarps * next);
      }
      add_task(block_words, n, base + kWarps * i,
               __shfl_sync(0xffffffffu, entry, i), cur);
      i = next;
      cur = ahead;
    }
    base += 32 * kWarps;
    if (base >= T) break;
    todo = task_mask(n, f, base, T, &entry);
    if (todo) {
      i = pop(&todo);
      cur = load_task<kDual, kVec>(n, f, base + kWarps * i);
    }
  }
  __syncthreads();
  if (kVec) {
    int4* out = reinterpret_cast<int4*>(words + f * n.W);
    for (int w = threadIdx.x; w < n.W / 4; w += kThreads) out[w] = shared4[w];
  } else {
    for (int w = threadIdx.x; w < n.W; w += kThreads)
      words[f * n.W + w] = block_words[w];
  }
}

template <bool kDual, bool kVec>
int launch_rows(const Nodes& n, int* words, int F, cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(n.W) * sizeof(int);
  auto kernel = rows_kernel<kDual, kVec>;
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<F, kThreads, bytes, stream>>>(n, words);
  return static_cast<int>(cudaGetLastError());
}

Nodes make_nodes(const int* cb2, const int* cb1, const int* mw,
                 const int* ma, const int* mb, const int* mc, const int* s2w,
                 const int* s2a, const int* s2b, const int* s2c,
                 const int* s1w, const int* s1a, const int* s1b, int nc2,
                 int nc1, int W, int kmax, int kmax1) {
  // rows past the block change nothing, and a smaller count keeps
  // first + rows * 128 inside int
  const int rows = W / kLane;
  return Nodes{cb2, cb1, {mw, s2w, s1w}, {{ma, mb, mc}, {s2a, s2b, s2c},
               {s1a, s1b, nullptr}}, nc2, nc1, W, min(kmax, rows),
               min(kmax1, rows)};
}

// Checks the operands, then takes the 16-byte instantiation where every
// node array and the output are aligned and the node-by-node one otherwise.
template <bool kDual>
int launch(const Nodes& n, int* words, int F, cudaStream_t stream) {
  if (F <= 0) return 0;
  if (n.W <= 0 || n.W % kLane != 0 || n.nc2 < 0 || n.nc1 < 0 || n.kmax < 1
      || n.kmax1 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  uintptr_t bits = reinterpret_cast<uintptr_t>(words);
  for (int s = 0; s < 3; ++s) {
    bits |= reinterpret_cast<uintptr_t>(n.w0[s]);
    for (int k = 0; k < 3; ++k) bits |= reinterpret_cast<uintptr_t>(n.val[s][k]);
  }
  return (bits & 15) == 0 ? launch_rows<kDual, true>(n, words, F, stream)
                          : launch_rows<kDual, false>(n, words, F, stream);
}

}  // namespace

// cb2 int32 [F, nc2 + 1], cb1 int32 [F, nc1 + 1]; main (mw, ma, mb, mc) and
// sp2 (s2w, s2a, s2b, s2c) int32 [F, nc2, 128]; sp1 (s1w, s1a, s1b) int32
// [F, nc1, 128] -> words int32 [F, W], W a multiple of 128. One block a
// frame.
extern "C" int flake_prof_merge_v5d(
    const int* cb2, const int* cb1, const int* mw, const int* ma,
    const int* mb, const int* mc, const int* s2w, const int* s2a,
    const int* s2b, const int* s2c, const int* s1w, const int* s1a,
    const int* s1b, int* words, int F, int nc2, int nc1, int W, int kmax,
    int kmax1, cudaStream_t stream) {
  return launch<false>(
      make_nodes(cb2, cb1, mw, ma, mb, mc, s2w, s2a, s2b, s2c, s1w, s1a, s1b,
                 nc2, nc1, W, kmax, kmax1),
      words, F, stream);
}

// as v5d, but mw, s2w int32 [F, 128, nc2] and s1w int32 [F, 128, nc1]
extern "C" int flake_prof_merge_v5c(
    const int* cb2, const int* cb1, const int* mw, const int* ma,
    const int* mb, const int* mc, const int* s2w, const int* s2a,
    const int* s2b, const int* s2c, const int* s1w, const int* s1a,
    const int* s1b, int* words, int F, int nc2, int nc1, int W, int kmax,
    int kmax1, cudaStream_t stream) {
  return launch<true>(
      make_nodes(cb2, cb1, mw, ma, mb, mc, s2w, s2a, s2b, s2c, s1w, s1a, s1b,
                 nc2, nc1, W, kmax, kmax1),
      words, F, stream);
}
