// E: the slot layout, a batch's analysis as the three int32 slot tables K3
// merges (each slot's bit length, its leading zero bits and its payload),
// in one launch.
//
// No Pallas kernel stands behind it. The JAX package writes the layout as
// tensor code inside its jitted emission (flake_tpu/ops/bitpack.py:421-625,
// pack_frames_device before the merge), where XLA fuses it. The port's
// plain version (ops/bitpack.slot_layout_plain) runs it eagerly, about 110
// launches a batch, with four sample-sized int32 temporaries.
//
// The tables, bit for bit the plain version's. A frame's M slots: the
// header (16 slots of its bytes, 8 bits each while a byte is there; byte 3
// the channel assignment and bps code), then each channel's region of L
// slots, then the alignment pad and the CRC-16 placeholder. A channel's
// region opens with 68 fixed slots (100 when a sample field may pass 32
// bits and splits into a (hi, lo) pair): the subframe header byte, the
// wasted-bits unary code, 32 warm-up samples (slot 0 the CONSTANT value),
// the LPC precision and shift, 32 coefficients and the Rice method and
// partition order; then G = 2^ps groups of gs = n >> ps samples, each a
// parameter slot (where a partition of the chosen order starts) and a slot
// (or pair) a sample. A predicted sample past the warm-up is a Rice code of
// parameter k: q = z >> k leading zeros, clamped at 2^24, then a 1 and k
// bits of z; q comes from h = z >> 1 = r ^ (r >> 31), as h >> (k - 1) for k
// >= 1 and 2 min(h, 2^23) + (z & 1) for k = 0, and the payload (1 << k) |
// (z & (2^k - 1)) from the int32 image (r << 1) ^ (r >> 31) of z. A
// verbatim sample is its obits low bits, in the wide form its top obits -
// 16 bits (arithmetic shift) and then its low 16. The pad is (-sum) & 7 of
// the frame's other lengths.
//
// What bounds it on the card: bytes. It reads the residual once (4 bytes a
// sample) and writes 12 bytes a slot, about one slot a sample (two in the
// wide form): 69 MB on the level-8 batch of 512 stereo frames of 4,096. Its
// operations, some twenty int32 ones a slot, come to less.
//
// Design: one thread-block cluster a frame, of up to 8 blocks (the portable
// size; fewer on short frames, so that a block has about kSpan slots). The
// blocks split the frame's slots before the pad into spans that start on
// 16-byte boundaries of the tables. A block stages what its span reads: the
// channels' scalars, every group's Rice parameter, the header, and the
// residual samples its span covers, which it reads as aligned 16-byte
// vectors. Each thread then lays out four consecutive slots that share one
// 16-byte word of each table and writes them with one aligned int4 store a
// table; it finds where its first slot lies once (a multiply-high in place
// of a division) and steps to the next three, so a sample costs no division
// and no dependent load; four samples of one group, the common quad, take
// a path of their own. The span's first and last few slots, where a
// table's row does not start or end on a 16-byte boundary, are written one
// by one. Every slot is written exactly once, so nothing is zeroed first.
// A block stages all it reads in one round trip and syncs once. Each block
// sums the lengths it wrote and stores the sum into block 0's shared
// memory (distributed shared memory, after a cluster barrier phase that
// every block's start completed); block 0 waits on the barrier's next
// phase for them and writes the pad and the CRC placeholder: no global
// scratch, no ticket and no second launch, and no block but block 0 waits
// at the end.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;                   // the portable cluster size
constexpr int kSpan = 4096;                      // slots a block aims at
constexpr int kTile = 4096;                      // slots staged a pass
constexpr int kMaxChannels = 8;                  // FLAC's limit
constexpr int kMaxGroups = 256;                  // 2^8 partitions
constexpr int kHdrSlots = 16;                    // bitpack.HDR_SLOTS
constexpr int kWarm = 32;                        // warm-up slots
constexpr int kCoefs = 32;                       // params.MAX_LPC_ORDER

// subframe types (ops/frame.py)
constexpr int kConstant = 0;
constexpr int kVerbatim = 1;
constexpr int kFixed = 8;
constexpr int kLpc = 32;

// u / d for u < 2^31 from m = floor(2^32 / d) + 1: the high product is
// u / d or one more
struct Divisor {
  unsigned d, m;
};

__device__ __forceinline__ int div_by(unsigned u, Divisor v) {
  if (v.d == 1) return static_cast<int>(u);
  unsigned q = __umulhi(u, v.m);
  if (q * v.d > u) --q;
  return static_cast<int>(q);
}

struct SlotArgs {
  // analysis, int32: [F, C] each
  const int *sf_type, *order, *obits, *wasted, *method, *porder, *type_code,
      *shift;
  const int* coefs;          // [F, C, 32]
  const int* rice_params;    // [F, C, rp], rp >= G
  const int* residual;       // [F, C, n]
  const int* ch_mode;        // [F]
  const unsigned char* hdr_bytes;  // [F, 16]
  const int* hdr_nbytes;     // [F]
  int *lengths, *leading, *payload;  // [F, M], 16-byte aligned
  int n, C, ps, rp, wide, precision, bps_code, n_fixed, L, M;
  int G, gs, spg;            // groups, samples a group, sample slots a group
  int cluster, chunk;        // blocks a frame, slots a block before aligning
  Divisor by_L, by_group;    // L and 1 + spg
};

// one channel's scalars
struct Chan {
  int sf, order, ob, wb, method, porder, type_code, shift;
  int pred, lpc, verb, cons, po_shift;
  int k_shift;               // group g reads parameter g >> k_shift
  int ob_lo, ob_hi, ob_mask, lo_mask, hi_mask;
};

// the int32 image of 2^bits - 1, bits in [0, 32]
__device__ __forceinline__ int low_mask(int bits) {
  return bits >= 32 ? -1 : static_cast<int>((1u << bits) - 1u);
}

// where a slot lies: c < 0 the header (r its index), else channel c's r-th
// slot, and past the fixed slots group g's t-th (t = 0 its parameter)
struct Cursor {
  int c, r, g, t;
};

__device__ __forceinline__ Cursor locate(const SlotArgs& a, int s) {
  Cursor k = {-1, s, 0, 0};
  if (s < kHdrSlots) return k;
  const int u = s - kHdrSlots;
  k.c = div_by(static_cast<unsigned>(u), a.by_L);
  k.r = u - k.c * a.L;
  if (k.r >= a.n_fixed) {
    const int v = k.r - a.n_fixed;
    k.g = div_by(static_cast<unsigned>(v), a.by_group);
    k.t = v - k.g * (1 + a.spg);
  }
  return k;
}

__device__ __forceinline__ void step(const SlotArgs& a, Cursor& k) {
  if (k.c < 0) {
    if (++k.r == kHdrSlots) k = {0, 0, 0, 0};
    return;
  }
  if (++k.r == a.L) {
    k = {k.c + 1, 0, 0, 0};
    return;
  }
  if (k.r > a.n_fixed && ++k.t == 1 + a.spg) {
    k.t = 0;
    ++k.g;
  }
}

// The linear sample index (c n + i) of the first sample slot at or after
// frame slot s; C n past the last.
__device__ int first_sample(const SlotArgs& a, int s) {
  if (s < kHdrSlots) return 0;
  const Cursor k = locate(a, s);
  if (k.c >= a.C) return a.C * a.n;
  if (k.r < a.n_fixed) return k.c * a.n;
  const int j = k.t == 0 ? 0 : (a.wide ? (k.t - 1) >> 1 : k.t - 1);
  return k.c * a.n + k.g * a.gs + j;
}

struct Staged {
  Chan ch[kMaxChannels];
  int k[kMaxChannels * kMaxGroups];   // the first G Rice parameters
  int warm[kMaxChannels * kWarm];     // each channel's first 32 samples
  int coefs[kMaxChannels * kCoefs];
  int hdr_len[kHdrSlots], hdr_pay[kHdrSlots];
  __align__(16) int res[kTile + 8];   // the span's residual samples
};

// Sample i of a channel, value r, as its (first) slot: a Rice code of
// parameter kk past a predicted channel's warm-up, else the verbatim value
// (in the wide form its top obits - 16 bits), else nothing.
__device__ __forceinline__ void sample_slot(const Chan& h, bool wide, int kk,
                                            int i, int r, int& len,
                                            int& lead, int& pay) {
  const int e = kk == 0 ? 1 : 0;
  const int sign = r >> 31;
  int q = (r ^ sign) >> max(kk - 1, 0);
  q = min(q, (1 << 24) >> e) << e;
  q = min(q | (sign & e), 1 << 24);
  const bool active = h.pred && i >= h.order;
  if (active) {
    len = q + kk + 1;
    lead = q;
    pay = ((static_cast<int>(static_cast<unsigned>(r) << 1) ^ sign) &
           low_mask(kk)) | (1 << kk);
  } else if (!wide) {
    len = h.verb ? h.ob : 0;
    lead = 0;
    pay = r & (h.verb ? h.ob_mask : 0);
  } else {
    len = h.verb ? h.ob_hi : 0;
    lead = 0;
    pay = (r >> h.ob_lo) & (h.verb ? h.hi_mask : 0);
  }
}

// One slot's (length, leading zeros, payload). `res` holds the samples
// from linear index `res0` on.
__device__ __forceinline__ void slot_value(const SlotArgs& a,
                                           const Staged& st, long long f,
                                           const Cursor& k, int res0,
                                           int& len, int& lead, int& pay) {
  lead = 0;
  if (k.c < 0) {
    len = st.hdr_len[k.r];
    pay = st.hdr_pay[k.r];
    return;
  }
  const Chan& h = st.ch[k.c];
  if (k.r < a.n_fixed) {
    const int s = k.r, n_warm = a.wide ? 2 * kWarm : kWarm;
    const int has_wasted = h.wb > 0 ? 1 : 0;
    len = 0;
    pay = 0;
    if (s == 0) {
      len = 8;
      pay = (h.type_code << 1) | has_wasted;
    } else if (s == 1) {
      len = h.wb;
      pay = has_wasted;
    } else if (s < 2 + n_warm) {
      const int j = a.wide ? (s - 2) >> 1 : s - 2;
      const bool on = (h.pred && j < h.order) || (h.cons && j == 0);
      const int w = st.warm[k.c * kWarm + j];
      if (on) {
        if (!a.wide) {
          len = h.ob;
          pay = w & h.ob_mask;
        } else if (((s - 2) & 1) == 0) {
          len = h.ob_hi;
          pay = (w >> h.ob_lo) & h.hi_mask;
        } else {
          len = h.ob_lo;
          pay = w & h.lo_mask;
        }
      }
    } else if (s == 2 + n_warm) {
      if (h.lpc) {
        len = 9;
        pay = ((a.precision - 1) << 5) | (h.shift & 31);
      }
    } else if (s < 3 + n_warm + kCoefs) {
      const int j = s - 3 - n_warm;
      if (h.lpc && j < h.order) {
        len = a.precision;
        pay = st.coefs[k.c * kCoefs + j] & ((1 << a.precision) - 1);
      }
    } else if (h.pred) {                          // s == n_fixed - 1
      len = 6;
      pay = (h.method << 4) | h.porder;
    }
    return;
  }
  const int kk = st.k[k.c * a.G + (k.g >> h.k_shift)];
  if (k.t == 0) {
    // group g starts a partition of the chosen order where it is a
    // multiple of 2^(ps - porder)
    const bool on = h.pred && (k.g & ((1 << h.po_shift) - 1)) == 0;
    len = on ? 4 + h.method : 0;
    pay = on ? kk : 0;
    return;
  }
  const int i = k.g * a.gs + (a.wide ? (k.t - 1) >> 1 : k.t - 1);
  const int r = st.res[k.c * a.n + i - res0];
  if (a.wide && ((k.t - 1) & 1)) {               // the lo half
    len = h.verb ? h.ob_lo : 0;
    pay = r & (h.verb ? h.lo_mask : 0);
    return;
  }
  sample_slot(h, a.wide, kk, i, r, len, lead, pay);
}

__global__ void __launch_bounds__(kThreads) slot_layout_kernel(SlotArgs a) {
  __shared__ Staged st;
  __shared__ unsigned red[kWarps];
  __shared__ unsigned span_sums[kMaxCluster];    // block 0's: every span's
  cg::cluster_group cluster = cg::this_cluster();
  // the cluster barrier's first phase: every block has started (waited on
  // before block 0's shared memory is written)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const long long f = blockIdx.x / a.cluster;
  const long long row = f * a.M;
  const int body = a.M - 2;                      // slots before the pad

  // the frame's scalars
  if (tid < a.C) {
    const long long fc = f * a.C + tid;
    Chan h;
    h.sf = a.sf_type[fc];
    h.order = a.order[fc];
    h.ob = a.obits[fc];
    h.wb = a.wasted[fc];
    h.method = a.method[fc];
    h.porder = a.porder[fc];
    h.type_code = a.type_code[fc];
    h.shift = a.shift[fc];
    h.pred = h.sf == kFixed || h.sf == kLpc;
    h.lpc = h.sf == kLpc;
    h.verb = h.sf == kVerbatim;
    h.cons = h.sf == kConstant;
    h.po_shift = a.ps - h.porder;
    h.k_shift = h.pred ? h.po_shift : 31;      // 0 where nothing reads it
    h.ob_lo = min(h.ob, 16);
    h.ob_hi = h.ob - h.ob_lo;
    h.ob_mask = low_mask(h.ob);
    h.lo_mask = low_mask(h.ob_lo);
    h.hi_mask = low_mask(h.ob_hi);
    st.ch[tid] = h;
  } else if (tid >= 32 && tid < 32 + kHdrSlots) {
    const int j = tid - 32;
    st.hdr_len[j] = j < a.hdr_nbytes[f] ? 8 : 0;
    int pay = a.hdr_bytes[f * kHdrSlots + j];
    if (j == 3) {
      const int m = a.ch_mode[f];
      pay = ((m > 0 ? m : a.C - 1) << 4) | (a.bps_code << 1);
    }
    st.hdr_pay[j] = pay;
  }
  // every channel's first G Rice parameters (group g reads parameter
  // g >> (ps - porder)), first 32 samples and coefficients, loaded beside
  // the scalars: one round trip
  for (int idx = tid; idx < a.C * a.G; idx += kThreads) {
    const int c = idx >> a.ps, g = idx & (a.G - 1);
    st.k[idx] = a.rice_params[(f * a.C + c) * a.rp + g];
  }
  for (int idx = tid; idx < a.C * kWarm; idx += kThreads) {
    const int c = idx / kWarm, j = idx % kWarm;
    st.warm[idx] = j < a.n ? a.residual[(f * a.C + c) * a.n + j] : 0;
    st.coefs[idx] = a.coefs[(f * a.C + c) * kCoefs + j];
  }

  // this block's span [lo, hi) of the frame's slots; the ends between
  // blocks lie on 16-byte boundaries of the tables
  auto edge = [&](int r) -> int {
    if (r <= 0) return 0;
    if (r >= a.cluster) return body;
    const long long at =
        (row + static_cast<long long>(r) * a.chunk + 3) & ~3LL;
    return static_cast<int>(min(at - row, static_cast<long long>(body)));
  };
  const int lo = edge(rank), hi = edge(rank + 1);
  const int* res_f = a.residual + f * a.C * a.n;

  // stage the samples the slots [t0, min(t0 + kTile, hi)) read, as aligned
  // int4 loads; returns where st.res starts (a linear sample index)
  auto stage = [&](int t0, bool first) -> int {
    const int t1 = min(t0 + kTile, hi);
    const int s0 = first_sample(a, t0);
    const int s1 = min(first_sample(a, t1) + 1, a.C * a.n);
    const uintptr_t p0 = reinterpret_cast<uintptr_t>(res_f + s0);
    const uintptr_t v0 = p0 & ~uintptr_t(15);
    const int head = static_cast<int>((p0 - v0) >> 2);
    const int nvec = (head + (s1 - s0) + 3) >> 2;
    if (!first) __syncthreads();                 // the last pass's reads
    const int4* src = reinterpret_cast<const int4*>(v0);
    for (int j = tid; j < nvec; j += kThreads)
      reinterpret_cast<int4*>(st.res)[j] = __ldg(src + j);
    __syncthreads();
    return s0 - head;
  };

  // slots [t0, t1) of a staged tile: aligned quads of four, the ragged
  // ends one by one; each slot's values go to put(at, len, lead, pay)
  // (one slot) or put4 (an aligned quad), and the lengths are summed
  auto tile = [&](int t0, int res0, auto put, auto put4) -> unsigned {
    const int t1 = min(t0 + kTile, hi);
    unsigned sum = 0;
    const long long g0 = row + t0, g1 = row + t1;
    long long q0 = (g0 + 3) & ~3LL, q1 = g1 & ~3LL;
    if (q0 > q1) q0 = q1 = g1;
    const int n_head = static_cast<int>(q0 - g0);
    const int n_tail = static_cast<int>(g1 - q1);
    int one = -1;
    if (tid < n_head)
      one = t0 + tid;
    else if (tid >= 32 && tid < 32 + n_tail)
      one = static_cast<int>(q1 - row) + tid - 32;
    if (one >= 0) {
      int len, lead, pay;
      slot_value(a, st, f, locate(a, one), res0, len, lead, pay);
      put(row + one, len, lead, pay);
      sum += static_cast<unsigned>(len);
    }
    const int nq = static_cast<int>((q1 - q0) >> 2);
    for (int q = tid; q < nq; q += kThreads) {
      const int s = static_cast<int>(q0 - row) + 4 * q;
      Cursor k = locate(a, s);
      int4 len, lead, pay;
      if (!a.wide && k.c >= 0 && k.r > a.n_fixed && k.t >= 1 &&
          k.t + 3 <= a.spg) {
        // the common quad: four samples of one group
        const Chan& h = st.ch[k.c];
        const int kk = st.k[k.c * a.G + (k.g >> h.k_shift)];
        const int i = k.g * a.gs + k.t - 1;
        const int* r = st.res + (k.c * a.n + i - res0);
        sample_slot(h, false, kk, i, r[0], len.x, lead.x, pay.x);
        sample_slot(h, false, kk, i + 1, r[1], len.y, lead.y, pay.y);
        sample_slot(h, false, kk, i + 2, r[2], len.z, lead.z, pay.z);
        sample_slot(h, false, kk, i + 3, r[3], len.w, lead.w, pay.w);
      } else {
        slot_value(a, st, f, k, res0, len.x, lead.x, pay.x);
        step(a, k);
        slot_value(a, st, f, k, res0, len.y, lead.y, pay.y);
        step(a, k);
        slot_value(a, st, f, k, res0, len.z, lead.z, pay.z);
        step(a, k);
        slot_value(a, st, f, k, res0, len.w, lead.w, pay.w);
      }
      put4(q0 + 4LL * q, len, lead, pay);
      sum += static_cast<unsigned>(len.x) + static_cast<unsigned>(len.y) +
             static_cast<unsigned>(len.z) + static_cast<unsigned>(len.w);
    }
    return sum;
  };

  // every slot into the three tables, the lengths summed mod 2^32
  auto store = [&](long long at, int len, int lead, int pay) {
    a.lengths[at] = len;
    a.leading[at] = lead;
    a.payload[at] = pay;
  };
  auto store4 = [&](long long at, int4 len, int4 lead, int4 pay) {
    *reinterpret_cast<int4*>(a.lengths + at) = len;
    *reinterpret_cast<int4*>(a.leading + at) = lead;
    *reinterpret_cast<int4*>(a.payload + at) = pay;
  };
  unsigned acc = 0;
  for (int t0 = lo; t0 < hi; t0 += kTile)
    acc += tile(t0, stage(t0, t0 == lo), store, store4);

  // the span's sum, then block 0 gathers every block's and writes the pad
  // and the CRC-16 placeholder
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if ((tid & 31) == 0) red[tid >> 5] = acc;
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (tid == 0) {
    unsigned total = 0;
    for (int w = 0; w < kWarps; ++w) total += red[w];
    *cluster.map_shared_rank(&span_sums[rank], 0) = total;
  }
  // the second phase: every span's sum is in block 0, which alone waits
  // for it (a block that has exited counts as arrived)
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  if (rank != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (tid == 0) {
    unsigned total = 0;
    for (int r = 0; r < a.cluster; ++r) total += span_sums[r];
    const long long at = row + a.M - 2;
    a.lengths[at] = static_cast<int>(-total & 7u);
    a.leading[at] = 0;
    a.payload[at] = 0;
    a.lengths[at + 1] = 16;
    a.leading[at + 1] = 0;
    a.payload[at + 1] = 0;
  }
}

Divisor divisor(unsigned d) {
  return {d, d > 1 ? static_cast<unsigned>((1ull << 32) / d + 1) : 0u};
}

}  // namespace

// E. The analysis tables (int32, contiguous): sf_type, order, obits, wasted,
// method, porder, type_code, shift [F, C], coefs [F, C, 32], rice_params [F,
// C, rp] (rp >= 2^ps), residual [F, C, n], ch_mode [F]; hdr_bytes uint8 [F,
// 16], hdr_nbytes int32 [F] -> lengths, leading, payload int32 [F, M], each
// on a 16-byte boundary, M = 16 + C L + 2, L = n_fixed + 2^ps (1 + (wide ?
// 2 : 1) (n >> ps)), n_fixed 68 or, wide, 100; n a multiple of 2^ps, C <=
// 8. The caller checks the shapes.
extern "C" int flake_slot_layout(
    const int* sf_type, const int* order, const int* obits, const int* wasted,
    const int* method, const int* porder, const int* type_code,
    const int* shift, const int* coefs, const int* rice_params,
    const int* residual, const int* ch_mode, const unsigned char* hdr_bytes,
    const int* hdr_nbytes, int* lengths, int* leading, int* payload, int F,
    int n, int C, int ps, int rp, int wide, int precision, int bps_code,
    cudaStream_t stream) {
  if (n < 1 || C < 1 || C > kMaxChannels || ps < 0 || ps > 8 ||
      rp < (1 << ps) || n % (1 << ps) || precision < 1 || precision > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(lengths) |
       reinterpret_cast<uintptr_t>(leading) |
       reinterpret_cast<uintptr_t>(payload)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  SlotArgs a = {sf_type, order, obits, wasted, method, porder, type_code,
                shift, coefs, rice_params, residual, ch_mode, hdr_bytes,
                hdr_nbytes, lengths, leading, payload};
  a.n = n;
  a.C = C;
  a.ps = ps;
  a.rp = rp;
  a.wide = wide;
  a.precision = precision;
  a.bps_code = bps_code;
  a.n_fixed = wide ? 100 : 68;
  a.G = 1 << ps;
  a.gs = n >> ps;
  a.spg = wide ? 2 * a.gs : a.gs;
  a.L = a.n_fixed + a.G * (1 + a.spg);
  a.M = kHdrSlots + C * a.L + 2;
  const int body = a.M - 2;
  a.cluster = min(kMaxCluster, max(1, (body + kSpan - 1) / kSpan));
  a.chunk = (body + a.cluster - 1) / a.cluster;
  a.by_L = divisor(static_cast<unsigned>(a.L));
  a.by_group = divisor(static_cast<unsigned>(1 + a.spg));
  if (F <= 0) return static_cast<int>(cudaGetLastError());

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(F) * a.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, slot_layout_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
