// U3a, U3b: the combined-node word merges of
// flake_tpu_torch/util/prof_merge3.py.
//
// Replaces the TPU kernels util/prof_merge3.py: merge_v5a (body k_v5a,
// _win3) and merge_v5b (body k_v5b, _chunk_v5b). Their inputs are three
// sets of nodes that v5_parts makes of a frame's slots: main and sp2, each
// (w0, A, B, C) int32 [F, 128, nc2], and sp1 (w0, A, B) int32 [F, 128, nc1],
// with cb2 [F, nc2 + 1] and cb1 [F, nc1 + 1], whose bit 31 says that a
// chunk of sp2 or sp1 holds a spill at all. Element c * 128 + s of a set
// (node s of chunk c) lies at [f, s, c]. Both TPU kernels compute
//
//   out[w0] += A, out[w0 + 1] += B, out[w0 + 2] += C
//
// in int32 with wraparound over every main node, every sp2 node of a
// flagged chunk and every sp1 node (A, B only) of a flagged chunk; on the
// TPU they walk the word rows a chunk can touch and differ only in how
// that loop is unrolled (v5a a loop, v5b two static rows, two gated rows
// and a loop), which a scatter does not have. So merge_v5a and merge_v5b
// launch the same kernel; each keeps its own entry point and launch count.
// A word outside [0, W) is never written; w0 + 1 and w0 + 2 are compared
// without overflow.
//
// What bounds them on the card: bytes (16 bytes per main node, the flagged
// spill chunks, the word block written once: 27.8 MB, 0.0083 ms, on the
// tools' music batch). In chunk layout the 128 nodes of one chunk lie nc
// ints apart, so a reader of a flagged chunk among unflagged ones touches a
// 32-byte sector per node and array (35.1 MB on music); on an H100 one
// flagged sp2 chunk of 17 reads as slowly as all of them.
//
// Design for the card (v5_kernel): one block of 256 threads a frame, so
// that the tools' 512 frames run in one wave. The function has no window,
// so no node needs its chunk's row: every set is read in memory order, four
// nodes of each array with one 16-byte load, and a set is a run of quads.
// The frame's quads of main, then of sp2, then of sp1, are one list; thread
// t takes quads t, t + 256, ... of it, and loads the next before it adds
// the one before, its first (a main quad) before the block's barrier, while
// warps 0 and 1 read the chunk entries of sp2 and sp1 and all threads zero
// the word block. A spill set whose frame flags no chunk is left out of the
// list. A spill quad's four elements are chunks c..c + 3 mod nc, c carried
// from quad to quad by the fixed stride 1024 mod nc (no division per
// element); a table in shared memory holds, for each c, the 4-bit mask of
// those chunks' flags, and a quad whose mask is 0 is not loaded. On music
// (one sp2 chunk of 17 flagged) one sp2 quad in 4.25 is loaded, the same
// sectors as reading the flagged column in place; on noise (all flagged)
// sp2 is read as main is. Nodes add with shared-memory atomicAdd on int
// (int32 addition in any order); the word block is zeroed and stored with
// 16-byte accesses. A frame's arrays start 512 nc bytes apart, so the quads
// are aligned wherever the arrays and the output are (else the same walk
// loads one int at a time).
//
// Reading the flagged columns in place instead (yardsticks/
// prof_merge3_columns.cu, neighbouring threads on neighbouring flagged
// chunks) reads within a few per cent of this on music and slower on
// noise; the first design (512 threads, one node a thread, j % nc for each
// spill node) is yardsticks/prof_merge3_v1.cu.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLane = 128;
constexpr int kThreads = 256;
constexpr int kSets = 3;

// The operands of one launch: the chunk entries of sp2 and sp1, of each set
// (main, sp2, sp1) w0 and A, B, C (sp1: no C), the chunk counts of main and
// sp2 (nc2) and of sp1 (nc1).
struct Sets {
  const int* cb[2];
  const int* w0[kSets];
  const int* val[kSets][3];
  int nc2, nc1, W;
};

// selects, not a dynamic index into the parameters (which would copy them
// to local memory)
__device__ __forceinline__ int chunks(const Sets& n, int set) {
  return set == 2 ? n.nc1 : n.nc2;
}

struct Quads {
  int4 w, a, b, c;
};

// A thread's place in the frame's list of quads: the set, the quad in it,
// and, in a spill set, the chunk of the quad's first element, 4 q mod nc,
// and what it grows by from one of the thread's quads to the next.
struct Walk {
  int set;
  int q;
  int chunk;
  int step;
};

template <bool kVec>
__device__ __forceinline__ int4 load4(const int* p) {
  if (kVec) return *reinterpret_cast<const int4*>(p);
  return make_int4(p[0], p[1], p[2], p[3]);
}

// Quad q of set `set` of frame f.
template <bool kVec>
__device__ __forceinline__ Quads load_quad(const Sets& n, size_t f, int set,
                                           int q) {
  const size_t at = f * kLane * chunks(n, set) + 4 * q;
  Quads r;
  r.w = load4<kVec>((set == 0 ? n.w0[0] : set == 1 ? n.w0[1] : n.w0[2]) + at);
  r.a = load4<kVec>(
      (set == 0 ? n.val[0][0] : set == 1 ? n.val[1][0] : n.val[2][0]) + at);
  r.b = load4<kVec>(
      (set == 0 ? n.val[0][1] : set == 1 ? n.val[1][1] : n.val[2][1]) + at);
  r.c = set == 2 ? make_int4(0, 0, 0, 0)
                 : load4<kVec>((set == 0 ? n.val[0][2] : n.val[1][2]) + at);
  return r;
}

// Moves the walk by `by` quads of the list of the sets in `active`; a set
// entered anew gets its chunk by one division, the same set by the stride.
__device__ __forceinline__ void advance(Walk& k, const Sets& n,
                                        unsigned active, int by) {
  k.q += by;
  int set = k.set;
  while (set < kSets && k.q >= 32 * chunks(n, set)) {
    k.q -= 32 * chunks(n, set);
    do {
      ++set;
    } while (set < kSets && !(active >> set & 1));
  }
  if (set == kSets || set == 0) {
    k.set = set;
    return;
  }
  const int nc = chunks(n, set);
  if (set != k.set) {
    k.set = set;
    k.chunk = 4 * k.q % nc;
    k.step = 4 * kThreads % nc;
  } else {
    k.chunk += k.step;
    if (k.chunk >= nc) k.chunk -= nc;
  }
}

// Moves the walk to the thread's next quad that holds a node to add and
// returns which of its four do (0 past the end).
__device__ __forceinline__ unsigned next_quad(Walk& k, const Sets& n,
                                              unsigned active,
                                              const unsigned char* masks) {
  while (true) {
    advance(k, n, active, kThreads);
    if (k.set == kSets) return 0;
    if (k.set == 0) return 0xf;
    const unsigned m = masks[(k.set == 2 ? n.nc2 : 0) + k.chunk];
    if (m) return m;
  }
}

// value at w + k, for k = 0..2, where 0 <= w + k < W (compared without
// forming w + k, which can overflow)
__device__ __forceinline__ void add_at(int* block_words, int w, int k,
                                       int value, int W) {
  if (value != 0 && w >= -k && w < W - k) atomicAdd(block_words + w + k, value);
}

__device__ __forceinline__ void add_quad(int* block_words, const Quads& q,
                                         unsigned mask, int W) {
  const int ws[4] = {q.w.x, q.w.y, q.w.z, q.w.w};
  const int as[4] = {q.a.x, q.a.y, q.a.z, q.a.w};
  const int bs[4] = {q.b.x, q.b.y, q.b.z, q.b.w};
  const int cs[4] = {q.c.x, q.c.y, q.c.z, q.c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!(mask >> i & 1)) continue;
    add_at(block_words, ws[i], 0, as[i], W);
    add_at(block_words, ws[i], 1, bs[i], W);
    add_at(block_words, ws[i], 2, cs[i], W);
  }
}

// One warp's part of the prologue, for a spill set's frame entries `cb`:
// masks[c] = the flags of chunks c..c + 3 mod nc as bits 0..3, and
// *active = whether the frame flags any chunk of the set.
__device__ __forceinline__ void flag_masks(unsigned char* masks, int* active,
                                           const int* cb, int nc) {
  const int lane = threadIdx.x & 31;
  bool any = false;
  for (int c = lane; c < nc; c += 32) {
    unsigned m = 0;
    int chunk = c;
    for (int i = 0; i < 4; ++i) {
      m |= (cb[chunk] < 0 ? 1u : 0u) << i;
      if (++chunk == nc) chunk = 0;
    }
    masks[c] = static_cast<unsigned char>(m);
    any |= m & 1;
  }
  any = __any_sync(0xffffffffu, any);
  if (lane == 0) *active = any;
}

// shared memory: the frame's word block [W], whether sp2 and sp1 are active
// [2], then the spill sets' masks [nc2 + nc1] bytes. One block a frame.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
v5_kernel(const Sets n, int* __restrict__ words) {
  extern __shared__ int4 shared4[];
  int* block_words = reinterpret_cast<int*>(shared4);
  int* active_sets = block_words + n.W;
  unsigned char* masks = reinterpret_cast<unsigned char*>(active_sets + 2);
  const size_t f = blockIdx.x;
  // the thread's first quad, a main one where there is one, is loaded
  // before the spill sets' flags are known; warps 0 and 1 read the flags of
  // sp2 and sp1 while all zero the word block
  const int tid = threadIdx.x;
  Walk k{0, tid - kThreads, 0, 0};
  unsigned mask = 0;
  Quads cur;
  if (tid < 32 * n.nc2) {
    k.q = tid;
    mask = 0xf;
    cur = load_quad<kVec>(n, f, 0, tid);
  }
  if (tid < 32) {
    flag_masks(masks, active_sets, n.cb[0] + f * (n.nc2 + 1), n.nc2);
  } else if (tid < 64) {
    flag_masks(masks + n.nc2, active_sets + 1, n.cb[1] + f * (n.nc1 + 1),
               n.nc1);
  }
  for (int w = tid; w < n.W / 4; w += kThreads)
    shared4[w] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const unsigned active =
      1u | (active_sets[0] ? 2u : 0u) | (active_sets[1] ? 4u : 0u);
  if (!mask) {
    mask = next_quad(k, n, active, masks);
    if (mask) cur = load_quad<kVec>(n, f, k.set, k.q);
  }
  while (mask) {
    Walk ahead_at = k;
    const unsigned ahead_mask = next_quad(ahead_at, n, active, masks);
    Quads ahead;
    if (ahead_mask) ahead = load_quad<kVec>(n, f, ahead_at.set, ahead_at.q);
    add_quad(block_words, cur, mask, n.W);
    k = ahead_at;
    mask = ahead_mask;
    cur = ahead;
  }
  __syncthreads();
  if (kVec) {
    int4* out = reinterpret_cast<int4*>(words + f * n.W);
    for (int w = tid; w < n.W / 4; w += kThreads) out[w] = shared4[w];
  } else {
    for (int w = tid; w < n.W; w += kThreads)
      words[f * n.W + w] = block_words[w];
  }
}

template <bool kVec>
int launch_sets(const Sets& n, int* words, int F, cudaStream_t stream) {
  const size_t bytes =
      (static_cast<size_t>(n.W) + 2) * sizeof(int) + n.nc2 + n.nc1;
  auto kernel = v5_kernel<kVec>;
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<F, kThreads, bytes, stream>>>(n, words);
  return static_cast<int>(cudaGetLastError());
}

// Checks the operands, then takes the 16-byte instantiation where every
// node array and the output are aligned and the int-by-int one otherwise.
int launch(const int* cb2, const int* cb1, const int* mw, const int* ma,
           const int* mb, const int* mc, const int* s2w, const int* s2a,
           const int* s2b, const int* s2c, const int* s1w, const int* s1a,
           const int* s1b, int* words, int F, int nc2, int nc1, int W,
           cudaStream_t stream) {
  if (F <= 0) return 0;
  if (W <= 0 || W % kLane != 0 || nc2 < 0 || nc1 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Sets n{{cb2, cb1},
               {mw, s2w, s1w},
               {{ma, mb, mc}, {s2a, s2b, s2c}, {s1a, s1b, nullptr}},
               nc2,
               nc1,
               W};
  uintptr_t bits = reinterpret_cast<uintptr_t>(words);
  for (int s = 0; s < kSets; ++s) {
    bits |= reinterpret_cast<uintptr_t>(n.w0[s]);
    for (int v = 0; v < 3; ++v)
      bits |= reinterpret_cast<uintptr_t>(n.val[s][v]);
  }
  return (bits & 15) == 0 ? launch_sets<true>(n, words, F, stream)
                          : launch_sets<false>(n, words, F, stream);
}

}  // namespace

// cb2 int32 [F, nc2 + 1], cb1 int32 [F, nc1 + 1]; main (mw, ma, mb, mc) and
// sp2 (s2w, s2a, s2b, s2c) int32 [F, 128, nc2]; sp1 (s1w, s1a, s1b) int32
// [F, 128, nc1] -> words int32 [F, W], W a multiple of 128. One block a
// frame; v5a and v5b launch the same kernel (see above).
extern "C" int flake_prof_merge_v5a(
    const int* cb2, const int* cb1, const int* mw, const int* ma,
    const int* mb, const int* mc, const int* s2w, const int* s2a,
    const int* s2b, const int* s2c, const int* s1w, const int* s1a,
    const int* s1b, int* words, int F, int nc2, int nc1, int W,
    cudaStream_t stream) {
  return launch(cb2, cb1, mw, ma, mb, mc, s2w, s2a, s2b, s2c, s1w, s1a, s1b,
                words, F, nc2, nc1, W, stream);
}

extern "C" int flake_prof_merge_v5b(
    const int* cb2, const int* cb1, const int* mw, const int* ma,
    const int* mb, const int* mc, const int* s2w, const int* s2a,
    const int* s2b, const int* s2c, const int* s1w, const int* s1a,
    const int* s1b, int* words, int F, int nc2, int nc1, int W,
    cudaStream_t stream) {
  return launch(cb2, cb1, mw, ma, mb, mc, s2w, s2a, s2b, s2c, s1w, s1a, s1b,
                words, F, nc2, nc1, W, stream);
}
