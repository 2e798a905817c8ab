// The other way to read the spill sets of U3a merge_v5a and U3b merge_v5b,
// kept only as a yardstick: chip_smoke.py builds it beside the kernel
// (../prof_merge3.cu) and times both on the same inputs in one run. No path
// of the package calls it; it is not part of the package's kernel library
// (flake_tpu_torch/_cuda.py builds csrc/*.cu only).
//
// The function is the one ../prof_merge3.cu states, and so is the design
// of the main set (a block of 256 threads a frame, main read in memory
// order by 16-byte quads, the next quad loaded before the last one is
// added). The spill sets differ: there every thread reads its part of
// each set in memory order and skips a quad whose four chunks are not
// flagged; here each set's flagged chunks are listed (one ballot a warp
// over 32 chunk entries) and only their columns are read, in place, four
// nodes of one chunk an item, one int a load. Neighbouring threads take
// neighbouring flagged chunks at the same nodes, so where the flagged
// chunks lie side by side (all of them, on the noise batch) their loads
// fall into the same sectors. Takes 16-byte aligned arrays only.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLane = 128;
constexpr int kThreads = 256;
constexpr int kSets = 3;

struct Sets {
  const int* cb[2];
  const int* w0[kSets];
  const int* val[kSets][3];
  int nc2, nc1, W;
};

__device__ __forceinline__ int chunks(const Sets& n, int set) {
  return set == 2 ? n.nc1 : n.nc2;
}

struct Quads {
  int4 w, a, b, c;
};

// A thread's place in the frame's list of items: main quads, then the
// flagged columns of sp2 and of sp1 in items of four nodes. In a spill set
// item i is nodes 4 g..4 g + 3 of the set's flagged chunk `pos` (i = g cnt +
// pos); g and pos are carried by the thread's fixed stride.
struct Walk {
  int set;
  int i;
  int g, pos;
  int dg, dpos;
};

// The walk's item of frame f; `lists` holds each spill set's flagged
// chunks.
__device__ __forceinline__ Quads load_item(const Sets& n, size_t f,
                                           const Walk& k, const int* lists) {
  const int set = k.set;
  const int nc = chunks(n, set);
  const int* w0 = set == 0 ? n.w0[0] : set == 1 ? n.w0[1] : n.w0[2];
  const int* a = set == 0 ? n.val[0][0] : set == 1 ? n.val[1][0] : n.val[2][0];
  const int* b = set == 0 ? n.val[0][1] : set == 1 ? n.val[1][1] : n.val[2][1];
  const int* c = set == 0 ? n.val[0][2] : n.val[1][2];
  Quads r;
  if (set == 0) {
    const size_t at = f * kLane * nc + 4 * k.i;
    r.w = *reinterpret_cast<const int4*>(w0 + at);
    r.a = *reinterpret_cast<const int4*>(a + at);
    r.b = *reinterpret_cast<const int4*>(b + at);
    r.c = *reinterpret_cast<const int4*>(c + at);
    return r;
  }
  const int chunk = lists[(set == 2 ? n.nc2 : 0) + k.pos];
  const size_t at = f * kLane * nc + static_cast<size_t>(4 * k.g) * nc + chunk;
  int ws[4], as[4], bs[4], cs[4] = {0, 0, 0, 0};
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    ws[m] = w0[at + m * nc];
    as[m] = a[at + m * nc];
    bs[m] = b[at + m * nc];
    if (set == 1) cs[m] = c[at + m * nc];
  }
  r.w = make_int4(ws[0], ws[1], ws[2], ws[3]);
  r.a = make_int4(as[0], as[1], as[2], as[3]);
  r.b = make_int4(bs[0], bs[1], bs[2], bs[3]);
  r.c = make_int4(cs[0], cs[1], cs[2], cs[3]);
  return r;
}

// Moves the walk by kThreads items; false past the end. cnt2, cnt1: the
// flagged chunks of sp2 and sp1.
__device__ __forceinline__ bool advance(Walk& k, const Sets& n, int cnt2,
                                        int cnt1) {
  k.i += kThreads;
  int set = k.set;
  while (set < kSets &&
         k.i >= 32 * (set == 0 ? n.nc2 : set == 1 ? cnt2 : cnt1)) {
    k.i -= 32 * (set == 0 ? n.nc2 : set == 1 ? cnt2 : cnt1);
    ++set;
  }
  if (set == kSets) return false;
  if (set != 0) {
    const int cnt = set == 1 ? cnt2 : cnt1;
    if (set != k.set) {
      k.g = k.i / cnt;
      k.pos = k.i % cnt;
      k.dg = kThreads / cnt;
      k.dpos = kThreads % cnt;
    } else {
      k.g += k.dg;
      k.pos += k.dpos;
      if (k.pos >= cnt) {
        k.pos -= cnt;
        ++k.g;
      }
    }
  }
  k.set = set;
  return true;
}

__device__ __forceinline__ void add_at(int* block_words, int w, int k,
                                       int value, int W) {
  if (value != 0 && w >= -k && w < W - k) atomicAdd(block_words + w + k, value);
}

__device__ __forceinline__ void add_quad(int* block_words, const Quads& q,
                                         int W) {
  const int ws[4] = {q.w.x, q.w.y, q.w.z, q.w.w};
  const int as[4] = {q.a.x, q.a.y, q.a.z, q.a.w};
  const int bs[4] = {q.b.x, q.b.y, q.b.z, q.b.w};
  const int cs[4] = {q.c.x, q.c.y, q.c.z, q.c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    add_at(block_words, ws[i], 0, as[i], W);
    add_at(block_words, ws[i], 1, bs[i], W);
    add_at(block_words, ws[i], 2, cs[i], W);
  }
}

// One warp lists a spill set's flagged chunks in order; returns their count
// on every lane.
__device__ __forceinline__ int list_flagged(int* list, const int* cb,
                                            int nc) {
  const int lane = threadIdx.x & 31;
  int cnt = 0;
  for (int base = 0; base < nc; base += 32) {
    const int c = base + lane;
    const unsigned flagged =
        __ballot_sync(0xffffffffu, c < nc && cb[min(c, nc - 1)] < 0);
    if (flagged >> lane & 1)
      list[cnt + __popc(flagged & ((1u << lane) - 1))] = c;
    cnt += __popc(flagged);
  }
  return cnt;
}

// shared memory: the word block [W], the flagged chunks of sp2 [nc2] and of
// sp1 [nc1], their two counts
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
columns_kernel(const Sets n, int* __restrict__ words) {
  extern __shared__ int4 shared4[];
  int* block_words = reinterpret_cast<int*>(shared4);
  int* lists = block_words + n.W;
  int* counts = lists + n.nc2 + n.nc1;
  const size_t f = blockIdx.x;
  const int tid = threadIdx.x;
  Walk k{0, tid - kThreads, 0, 0, 0, 0};
  bool more = false;
  Quads cur;
  if (tid < 32 * n.nc2) {
    k.i = tid;
    more = true;
    cur = load_item(n, f, k, lists);
  }
  const int warp = tid >> 5;
  if (warp < 2) {
    const int cnt = warp == 0
        ? list_flagged(lists, n.cb[0] + f * (n.nc2 + 1), n.nc2)
        : list_flagged(lists + n.nc2, n.cb[1] + f * (n.nc1 + 1), n.nc1);
    if ((tid & 31) == 0) counts[warp] = cnt;
  }
  for (int w = tid; w < n.W / 4; w += kThreads)
    shared4[w] = make_int4(0, 0, 0, 0);
  __syncthreads();
  const int cnt2 = counts[0], cnt1 = counts[1];
  if (!more) {
    more = advance(k, n, cnt2, cnt1);
    if (more) cur = load_item(n, f, k, lists);
  }
  while (more) {
    Walk ahead_at = k;
    const bool ahead_more = advance(ahead_at, n, cnt2, cnt1);
    Quads ahead;
    if (ahead_more) ahead = load_item(n, f, ahead_at, lists);
    add_quad(block_words, cur, n.W);
    k = ahead_at;
    more = ahead_more;
    cur = ahead;
  }
  __syncthreads();
  int4* out = reinterpret_cast<int4*>(words + f * n.W);
  for (int w = tid; w < n.W / 4; w += kThreads) out[w] = shared4[w];
}

}  // namespace

// The operands of flake_prof_merge_v5a (../prof_merge3.cu), all 16-byte
// aligned.
extern "C" int flake_prof_merge_v5_columns(
    const int* cb2, const int* cb1, const int* mw, const int* ma,
    const int* mb, const int* mc, const int* s2w, const int* s2a,
    const int* s2b, const int* s2c, const int* s1w, const int* s1a,
    const int* s1b, int* words, int F, int nc2, int nc1, int W,
    cudaStream_t stream) {
  if (F <= 0) return 0;
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
  if (W <= 0 || W % kLane != 0 || nc2 < 0 || nc1 < 0 || (bits & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = (static_cast<size_t>(W) + nc2 + nc1 + 2) * sizeof(int);
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        columns_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  columns_kernel<<<F, kThreads, bytes, stream>>>(n, words);
  return static_cast<int>(cudaGetLastError());
}
