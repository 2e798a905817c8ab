// S: order selection from every candidate order's estimated bits, in one
// launch.
//
// No Pallas kernel stands behind it. The JAX package writes the selection
// as tensor code inside its one jitted analysis program
// (flake_tpu/ops/frame.py:102-183): the LOG step-halving search
// (_select_order_log, optimize.c:239-261), the 2/4/8-LEVEL candidate scan
// (_select_order_level, optimize.c:202-223) and SEARCH's argmin. The
// port's plain versions (ops/frame.py) run them eagerly: LOG's fifteen
// steps of gathers, compares and a scatter make some 360 small launches a
// batch. This kernel replaces all three; MAX and EST read no bits and stay
// tensor code.
//
// Arithmetic, the plain version's: bits are int64 (uint32 values), the
// compares strict <. SEARCH keeps the first (lowest) order among equal
// minima, as jnp.argmin and torch.argmin do. LEVEL scans its candidates
// highest first, so a tie keeps the earlier, higher one. LOG keeps the
// visited set as a 32-bit mask (max order <= 32); an order not yet visited
// compares as 0xFFFFFFFF in int64, as the plain version's opt_bits does, and
// every index is clamped to [0, max_order) before it is read, as the plain
// version's gathers clamp.
//
// What bounds it on the card: bytes. A row of at most 32 int64 is read once
// (256 bytes) and one int32 written; LOG reads 15 of them, the others at
// most 32, with a compare each. Design: one thread a stream, 128 streams a
// block; the block stages its rows in shared memory with coalesced loads
// (rows padded to an odd count of int64, so that the threads' row reads do
// not all fall on one bank), then each thread walks its own row.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxOrder = 32;                    // params.MAX_LPC_ORDER
constexpr int kThreads = 128;                    // streams a block
constexpr long long kU32 = 0xFFFFFFFFll;

// params.OrderMethod
constexpr int kLevel2 = 2;
constexpr int kLevel8 = 4;
constexpr int kSearch = 5;
constexpr int kLog = 6;

__global__ void __launch_bounds__(kThreads)
    select_order_kernel(const long long* __restrict__ bits,
                        int* __restrict__ out, int N, int m, int method,
                        int min_o, int max_o) {
  __shared__ long long rows[kThreads * (kMaxOrder + 1)];
  const int stride = m | 1;                      // m, or m + 1: odd
  const long long first = static_cast<long long>(blockIdx.x) * kThreads;
  const long long left = N - first;
  const int count = left < kThreads ? static_cast<int>(left) : kThreads;
  const long long* src = bits + first * m;
  for (int e = threadIdx.x; e < count * m; e += kThreads)
    rows[(e / m) * stride + e % m] = src[e];
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= count) return;
  const long long* b = rows + threadIdx.x * stride;

  int best = 0;                                  // 0-based order
  if (method == kSearch) {
    long long bb = b[0];
    for (int j = 1; j < max_o; ++j)
      if (b[j] < bb) {
        bb = b[j];
        best = j;
      }
  } else if (method == kLog) {
    auto clamp = [&](int i) { return min(max(i, 0), max_o - 1); };
    int opt = min_o - 1 + (max_o - min_o) / 3;
    unsigned visited = 0;
    for (int step = 16; step; step >>= 1) {
      const int last = opt;
      for (int t = -1; t <= 1; ++t) {
        const int i = last + t * step;
        const int ci = clamp(i), co = clamp(opt);
        const bool fresh =
            i >= min_o - 1 && i < max_o && !(visited >> ci & 1u);
        const long long opt_bits = (visited >> co & 1u) ? b[co] : kU32;
        if (fresh) {
          visited |= 1u << ci;
          if (b[ci] < opt_bits) opt = i;
        }
      }
    }
    best = opt;
  } else {
    // LEVEL2/4/8: candidate i of `levels`, highest first
    const int levels = 1 << (method - 1);
    auto cand = [&](int i) {
      return max(min_o + ((max_o - min_o + 1) * (i + 1)) / levels - 2, 0);
    };
    best = cand(levels - 1);
    long long bb = b[best];
    for (int i = levels - 2; i >= 0; --i) {
      const int o = cand(i);
      if (b[o] < bb) {
        bb = b[o];
        best = o;
      }
    }
  }
  out[first + threadIdx.x] = best + 1;
}

}  // namespace

// S. bits int64 [N, m] (m <= 32 columns, order j + 1 in column j) ->
// order int32 [N] (1-based), under order method `method` (LEVEL2/4/8,
// SEARCH or LOG) over orders min_o..max_o, 1 <= min_o <= max_o <= m; the
// caller checks the shapes.
extern "C" int flake_select_order(const long long* bits, int* order, int N,
                                  int m, int method, int min_o, int max_o,
                                  cudaStream_t stream) {
  if (m < 1 || m > kMaxOrder || min_o < 1 || min_o > max_o || max_o > m ||
      (method != kSearch && method != kLog &&
       (method < kLevel2 || method > kLevel8)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N > 0)
    select_order_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(bits, order, N, m, method, min_o, max_o);
  return static_cast<int>(cudaGetLastError());
}
