// The row-layout merges of ../prof_merge3_rows.cu (U3c merge_v5d, U3d
// merge_v5c) at other launch geometries, only as yardsticks: chip_smoke.py
// builds this file beside the package's kernels and times each form on the
// same inputs as the entry points, to show what chose their geometry. No
// path of the package calls it; it is not part of the package's kernel
// library (flake_tpu_torch/_cuda.py builds csrc/*.cu only).
//
// A copy of the package's body as it was before it was cut to one form,
// with its geometry left open: the block size (128, 256 or 512 threads, for
// v5d) and the grid (one block a frame, or fewer blocks that walk the
// frames with a grid stride). v5c here stages the main set's w0 transposed
// in shared memory and, with kStageSpill, sp2's too. The package's form is
// 256 threads, one block a frame, and every w0 column of v5c read in place.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLane = 128;
constexpr int kMask31 = 0x7fffffff;
constexpr int kStage = kLane + 4;   // ints of a staged w0 row, padded
constexpr int kRowsThreads = 256;   // the block the package launches

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

// The lane's task base + warps * lane: its chunk entry, and whether it
// holds nodes to add. Returns the warp's ballot of the latter.
__device__ __forceinline__ unsigned task_mask(const Nodes& n, size_t f,
                                              int base, int warps, int T,
                                              int* entry) {
  const int t = base + warps * static_cast<int>(threadIdx.x & 31);
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

// True where this instantiation reads the set's w0 from the stage.
template <bool kDual, bool kStageSpill>
__device__ __forceinline__ bool staged(int set) {
  return kDual && (set == 0 || (kStageSpill && set == 1));
}

// The lane's four nodes of task t; a staged w0 is read when the task is
// added.
template <bool kDual, bool kVec, bool kStageSpill>
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
  } else if (!staged<kDual, kStageSpill>(set)) {
    const int* col = w0 + f * kLane * nc + c;
    q.w = make_int4(col[s * nc], col[(s + 1) * nc], col[(s + 2) * nc],
                    col[(s + 3) * nc]);
  }
  return q;
}

// Adds the lane's four nodes of task t, whose chunk entry is `entry`.
template <bool kDual, bool kStageSpill>
__device__ __forceinline__ void add_task(int* block_words, const int* stage,
                                         const Nodes& n, int t, int entry,
                                         Quads q) {
  int c;
  const int set = split_task(t, n.nc2, &c);
  if (staged<kDual, kStageSpill>(set))
    q.w = *reinterpret_cast<const int4*>(
        stage + (set * n.nc2 + c) * kStage + 4 * (threadIdx.x & 31));
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

// stage[c * kStage + s] = src[s * nc + c] for a frame's [128, nc] w0 array
template <bool kVec, int kThreads>
__device__ __forceinline__ void stage_w0(int* stage, const int* src, int nc) {
  for (int q = threadIdx.x; q < 32 * nc; q += kThreads) {
    const int4 v = load4<kVec>(src + 4 * q);
    const int vs[4] = {v.x, v.y, v.z, v.w};
    int s = 4 * q / nc;
    int c = 4 * q - s * nc;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      stage[c * kStage + s] = vs[k];
      if (++c == nc) {
        c = 0;
        ++s;
      }
    }
  }
}

// shared memory: word block [W], then for kDual the staged w0 of main (and
// with kStageSpill of sp2), [nc2, kStage] each. Blocks walk the frames with
// a grid stride (one frame each where the grid is F).
template <bool kDual, bool kVec, bool kStageSpill, int kThreads>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
rows_kernel(const Nodes n, int* __restrict__ words, int F) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ int4 shared4[];
  int* block_words = reinterpret_cast<int*>(shared4);
  int* stage = block_words + n.W;
  const int warp = threadIdx.x >> 5;
  const int T = 2 * n.nc2 + n.nc1;
  for (size_t f = blockIdx.x; f < static_cast<size_t>(F); f += gridDim.x) {
    // the warp's tasks base + kWarps i, 32 at a time; its first, a main
    // chunk where there is one, is loaded before its entry is known
    int base = warp;
    int i = -1;
    Quads cur;
    if (base < n.nc2) {
      i = 0;
      cur = load_task<kDual, kVec, kStageSpill>(n, f, base);
    }
    int entry;
    unsigned todo = task_mask(n, f, base, kWarps, T, &entry);
    if (i == 0) {
      todo &= ~1u;
    } else if (todo) {
      i = pop(&todo);
      cur = load_task<kDual, kVec, kStageSpill>(n, f, base + kWarps * i);
    }
    for (int w = threadIdx.x; w < n.W / 4; w += kThreads)
      shared4[w] = make_int4(0, 0, 0, 0);
    if (kDual) {
      stage_w0<kVec, kThreads>(stage, n.w0[0] + f * kLane * n.nc2, n.nc2);
      if (kStageSpill)
        stage_w0<kVec, kThreads>(stage + n.nc2 * kStage,
                                 n.w0[1] + f * kLane * n.nc2, n.nc2);
    }
    __syncthreads();
    while (true) {
      while (i >= 0) {
        int next = -1;
        Quads ahead;
        if (todo) {
          next = pop(&todo);
          ahead = load_task<kDual, kVec, kStageSpill>(n, f,
                                                      base + kWarps * next);
        }
        add_task<kDual, kStageSpill>(block_words, stage, n, base + kWarps * i,
                                     __shfl_sync(0xffffffffu, entry, i), cur);
        i = next;
        cur = ahead;
      }
      base += 32 * kWarps;
      if (base >= T) break;
      todo = task_mask(n, f, base, kWarps, T, &entry);
      if (todo) {
        i = pop(&todo);
        cur = load_task<kDual, kVec, kStageSpill>(n, f, base + kWarps * i);
      }
    }
    __syncthreads();
    if (kVec) {
      int4* out = reinterpret_cast<int4*>(words + f * n.W);
      for (int w = threadIdx.x; w < n.W / 4; w += kThreads)
        out[w] = shared4[w];
    } else {
      for (int w = threadIdx.x; w < n.W; w += kThreads)
        words[f * n.W + w] = block_words[w];
    }
    __syncthreads();   // frees the word block for the grid's next frame
  }
}

template <bool kDual, bool kVec, bool kStageSpill, int kThreads>
int launch_rows(const Nodes& n, int* words, int F, int blocks,
                cudaStream_t stream) {
  const int staged_sets = kDual ? 1 + kStageSpill : 0;
  const size_t bytes = (static_cast<size_t>(n.W)
                        + static_cast<size_t>(staged_sets) * n.nc2 * kStage)
      * sizeof(int);
  auto kernel = rows_kernel<kDual, kVec, kStageSpill, kThreads>;
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<blocks, kThreads, bytes, stream>>>(n, words, F);
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
// blocks <= 0: one a frame.
template <bool kDual, bool kStageSpill, int kThreads>
int launch(const Nodes& n, int* words, int F, int blocks,
           cudaStream_t stream) {
  if (F <= 0) return 0;
  if (n.W <= 0 || n.W % kLane != 0 || n.nc2 < 0 || n.nc1 < 0 || n.kmax < 1
      || n.kmax1 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  uintptr_t bits = reinterpret_cast<uintptr_t>(words);
  for (int s = 0; s < 3; ++s) {
    bits |= reinterpret_cast<uintptr_t>(n.w0[s]);
    for (int k = 0; k < 3; ++k) bits |= reinterpret_cast<uintptr_t>(n.val[s][k]);
  }
  blocks = blocks > 0 && blocks < F ? blocks : F;
  return (bits & 15) == 0
      ? launch_rows<kDual, true, kStageSpill, kThreads>(n, words, F, blocks,
                                                        stream)
      : launch_rows<kDual, false, kStageSpill, kThreads>(n, words, F, blocks,
                                                         stream);
}

}  // namespace

// The operands of flake_prof_merge_v5d (dual = 0) or flake_prof_merge_v5c
// (dual = 1), then the form: threads 128, 256 or 512 (v5d; v5c takes the
// entry point's), stage_spill 0 or 1 (v5c) and blocks (<= 0: one a frame).
extern "C" int flake_prof_merge_rows_alt(
    int dual, int threads, int stage_spill, int blocks, const int* cb2,
    const int* cb1, const int* mw, const int* ma, const int* mb,
    const int* mc, const int* s2w, const int* s2a, const int* s2b,
    const int* s2c, const int* s1w, const int* s1a, const int* s1b,
    int* words, int F, int nc2, int nc1, int W, int kmax, int kmax1,
    cudaStream_t stream) {
  const Nodes n = make_nodes(cb2, cb1, mw, ma, mb, mc, s2w, s2a, s2b, s2c,
                             s1w, s1a, s1b, nc2, nc1, W, kmax, kmax1);
  if (dual) {
    return stage_spill
        ? launch<true, true, kRowsThreads>(n, words, F, blocks, stream)
        : launch<true, false, kRowsThreads>(n, words, F, blocks, stream);
  }
  switch (threads) {
    case 128:
      return launch<false, false, 128>(n, words, F, blocks, stream);
    case 256:
      return launch<false, false, 256>(n, words, F, blocks, stream);
    case 512:
      return launch<false, false, 512>(n, words, F, blocks, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
