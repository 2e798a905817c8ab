// The first design of E, kept unchanged apart from the entry point's name,
// only as a yardstick: chip_smoke.py builds it beside the current design
// (../slots.cu) and times both on the same inputs in one run. No path of
// the package calls it; it is not part of the package's kernel library
// (flake_tpu_torch/_cuda.py builds csrc/*.cu only).
//
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
// operations, some twenty int32 ones a slot, come to less. Design: one block
// of 256 a frame; its threads take the header, then each channel's fixed
// slots, parameter slots and samples in turn, each slot written once to all
// three tables (so no table is zeroed first), each thread keeping the sum of
// the lengths it wrote; a block reduction gives the pad.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHdrSlots = 16;                    // bitpack.HDR_SLOTS
constexpr int kWarm = 32;                        // warm-up slots
constexpr int kCoefs = 32;                       // params.MAX_LPC_ORDER

// subframe types (ops/frame.py)
constexpr int kConstant = 0;
constexpr int kVerbatim = 1;
constexpr int kFixed = 8;
constexpr int kLpc = 32;

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
  int *lengths, *leading, *payload;  // [F, M]
  int n, C, ps, rp, wide, precision, bps_code, n_fixed, L, M;
};

__device__ __forceinline__ void put(const SlotArgs& a, long long at, int len,
                                    int lead, int pay) {
  a.lengths[at] = len;
  a.leading[at] = lead;
  a.payload[at] = pay;
}

// the int32 image of 2^bits - 1, bits in [0, 32]
__device__ __forceinline__ int low_mask(int bits) {
  return bits >= 32 ? -1 : static_cast<int>((1u << bits) - 1u);
}

__global__ void __launch_bounds__(kThreads) slot_layout_kernel(SlotArgs a) {
  __shared__ long long red[kWarps];
  const int tid = threadIdx.x;
  const long long f = blockIdx.x;
  const long long row = f * a.M;
  const int G = 1 << a.ps, gs = a.n >> a.ps;
  const int spg = a.wide ? 2 * gs : gs;          // sample slots a group
  long long acc = 0;                             // lengths this thread wrote

  if (tid < kHdrSlots) {
    const int len = tid < a.hdr_nbytes[f] ? 8 : 0;
    int pay = a.hdr_bytes[f * kHdrSlots + tid];
    if (tid == 3) {
      const int m = a.ch_mode[f];
      pay = ((m > 0 ? m : a.C - 1) << 4) | (a.bps_code << 1);
    }
    put(a, row + tid, len, 0, pay);
    acc += len;
  }

  for (int c = 0; c < a.C; ++c) {
    const long long fc = f * a.C + c;
    const int sf = a.sf_type[fc], order = a.order[fc], ob = a.obits[fc];
    const int wb = a.wasted[fc], method = a.method[fc];
    const int porder = a.porder[fc];
    const bool pred = sf == kFixed || sf == kLpc, lpc = sf == kLpc;
    const bool verb = sf == kVerbatim, cons = sf == kConstant;
    const int ob_lo = min(ob, 16), ob_hi = ob - ob_lo;
    const int ob_mask = low_mask(ob);
    const int lo_mask = low_mask(ob_lo), hi_mask = low_mask(ob_hi);
    const int* res = a.residual + fc * a.n;
    const int* rp = a.rice_params + fc * a.rp;
    const long long base = row + kHdrSlots + static_cast<long long>(c) * a.L;
    const int n_warm = a.wide ? 2 * kWarm : kWarm;

    // the fixed slots
    for (int s = tid; s < a.n_fixed; s += kThreads) {
      int len = 0, pay = 0;
      const int has_wasted = wb > 0 ? 1 : 0;
      if (s == 0) {
        len = 8;
        pay = (a.type_code[fc] << 1) | has_wasted;
      } else if (s == 1) {
        len = wb;
        pay = has_wasted;
      } else if (s < 2 + n_warm) {
        const int j = a.wide ? (s - 2) >> 1 : s - 2;
        const bool on = (pred && j < order) || (cons && j == 0);
        const int w = j < a.n ? res[j] : 0;
        if (on) {
          if (!a.wide) {
            len = ob;
            pay = w & ob_mask;
          } else if (((s - 2) & 1) == 0) {
            len = ob_hi;
            pay = (w >> ob_lo) & hi_mask;
          } else {
            len = ob_lo;
            pay = w & lo_mask;
          }
        }
      } else if (s == 2 + n_warm) {
        if (lpc) {
          len = 9;
          pay = ((a.precision - 1) << 5) | (a.shift[fc] & 31);
        }
      } else if (s < 3 + n_warm + kCoefs) {
        const int j = s - 3 - n_warm;
        if (lpc && j < order) {
          len = a.precision;
          pay = a.coefs[fc * kCoefs + j] & ((1 << a.precision) - 1);
        }
      } else if (pred) {                         // s == n_fixed - 1
        len = 6;
        pay = (method << 4) | porder;
      }
      put(a, base + s, len, 0, pay);
      acc += len;
    }

    // the parameter slots: group g starts a partition of the chosen order
    // where it is a multiple of 2^(ps - porder)
    const int po_shift = a.ps - porder;
    const long long body = base + a.n_fixed;
    for (int g = tid; g < G; g += kThreads) {
      const bool on = pred && (g & ((1 << po_shift) - 1)) == 0;
      const int len = on ? 4 + method : 0;
      put(a, body + static_cast<long long>(g) * (1 + spg), len, 0,
          on ? rp[g >> po_shift] : 0);
      acc += len;
    }

    // the samples
    for (int i = tid; i < a.n; i += kThreads) {
      const int g = i / gs, t = i - g * gs;
      const int k = rp[g >> po_shift];
      const int r = res[i];
      const int e = k == 0 ? 1 : 0;
      const int sign = r >> 31;
      int q = (r ^ sign) >> max(k - 1, 0);
      q = min(q, (1 << 24) >> e) << e;
      q = min(q | (sign & e), 1 << 24);
      const int pay =
          ((static_cast<int>(static_cast<unsigned>(r) << 1) ^ sign) &
           low_mask(k)) | (1 << k);
      const bool active = pred && i >= order;
      const long long at = body + static_cast<long long>(g) * (1 + spg) + 1 +
                           (a.wide ? 2 * t : t);
      if (!a.wide) {
        const int len = active ? q + k + 1 : (verb ? ob : 0);
        put(a, at, len, active ? q : 0,
            active ? pay : (r & (verb ? ob_mask : 0)));
        acc += len;
      } else {
        const int len = active ? q + k + 1 : (verb ? ob_hi : 0);
        put(a, at, len, active ? q : 0,
            active ? pay : ((r >> ob_lo) & (verb ? hi_mask : 0)));
        const int len_lo = verb ? ob_lo : 0;
        put(a, at + 1, len_lo, 0, r & (verb ? lo_mask : 0));
        acc += len + len_lo;
      }
    }
  }

  // the alignment pad and the CRC-16 placeholder
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if ((tid & 31) == 0) red[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += red[w];
    put(a, row + a.M - 2, static_cast<int>(-total & 7), 0, 0);
    put(a, row + a.M - 1, 16, 0, 0);
  }
}

}  // namespace

// E. The analysis tables (int32, contiguous): sf_type, order, obits, wasted,
// method, porder, type_code, shift [F, C], coefs [F, C, 32], rice_params [F,
// C, rp] (rp >= 2^ps), residual [F, C, n], ch_mode [F]; hdr_bytes uint8 [F,
// 16], hdr_nbytes int32 [F] -> lengths, leading, payload int32 [F, M], M =
// 16 + C L + 2, L = n_fixed + 2^ps (1 + (wide ? 2 : 1) (n >> ps)), n_fixed
// 68 or, wide, 100; n a multiple of 2^ps. The caller checks the shapes.
extern "C" int flake_slot_layout_v1(
    const int* sf_type, const int* order, const int* obits, const int* wasted,
    const int* method, const int* porder, const int* type_code,
    const int* shift, const int* coefs, const int* rice_params,
    const int* residual, const int* ch_mode, const unsigned char* hdr_bytes,
    const int* hdr_nbytes, int* lengths, int* leading, int* payload, int F,
    int n, int C, int ps, int rp, int wide, int precision, int bps_code,
    cudaStream_t stream) {
  if (n < 1 || C < 1 || ps < 0 || ps > 8 || rp < (1 << ps) ||
      n % (1 << ps) || precision < 1 || precision > 16)
    return static_cast<int>(cudaErrorInvalidValue);
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
  a.L = a.n_fixed + (1 << ps) * (1 + (wide ? 2 : 1) * (n >> ps));
  a.M = kHdrSlots + C * a.L + 2;
  if (F > 0) slot_layout_kernel<<<F, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
