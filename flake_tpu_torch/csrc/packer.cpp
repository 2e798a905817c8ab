// The port's host library: FLAC bitstream packer, CRC patch, stream
// stitcher, MD5 block compress (a copy of flake_tpu/native/packer.cpp,
// which the port cannot build from: it keeps its own sources).
//
// Two emissions share it. The device emission (K3) writes each frame's
// bytes with zero CRC placeholders, and flake_crc_patch fills them. The
// host emission (pack_backend="host") receives the per-frame selection
// tensors and residuals computed on the GPU and emits whole FLAC frames
// (header + subframes + Rice codes + CRC-8/16) with flake_pack_frames,
// parallel over frames with OpenMP: frames are packed independently into
// strided slots and stitched once their lengths are known.
//
// Reference semantics mirrored here:
//   frame header layout + CRC-8  (reference encode.c:718-764)
//   UTF-8 frame numbers          (encode.c:700-716)
//   subframe headers/wasted bits (encode.c:871-905)
//   Rice partitions              (encode.c:766-798)
//   footer CRC-16                (encode.c:907-917)

#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// ---------------------------------------------------------------- CRC --

struct CrcTables {
    uint8_t crc8[256];
    uint16_t crc16[256];
    // slice-by-8: slice16[j][b] = CRC-16 of byte b followed by j zero
    // bytes (zero seed), so 8 input bytes cost 8 independent lookups
    uint16_t slice16[8][256];
    CrcTables() {
        for (int i = 0; i < 256; i++) {
            unsigned c8 = i;
            for (int j = 0; j < 8; j++)
                c8 = (c8 & 0x80) ? (c8 << 1) ^ 0x107 : (c8 << 1);
            crc8[i] = static_cast<uint8_t>(c8 & 0xFF);
            unsigned c16 = i;
            for (int j = 0; j < 16; j++)
                c16 = (c16 & 0x8000) ? (c16 << 1) ^ 0x18005 : (c16 << 1);
            crc16[i] = static_cast<uint16_t>(c16 & 0xFFFF);
        }
        for (int b = 0; b < 256; b++) {
            uint16_t c = crc16[b];
            slice16[0][b] = c;
            for (int j = 1; j < 8; j++) {
                c = static_cast<uint16_t>(crc16[c >> 8] ^ (c << 8));
                slice16[j][b] = c;
            }
        }
    }
};
const CrcTables kCrc;

inline uint8_t calc_crc8(const uint8_t* data, int64_t len) {
    uint8_t crc = 0;
    for (int64_t i = 0; i < len; i++) crc = kCrc.crc8[crc ^ data[i]];
    return crc;
}

inline uint16_t calc_crc16(const uint8_t* data, int64_t len) {
    uint16_t crc = 0;
    int64_t i = 0;
    for (; i + 8 <= len; i += 8) {
        const uint8_t* d = data + i;
        crc = static_cast<uint16_t>(
            kCrc.slice16[7][d[0] ^ (crc >> 8)]
            ^ kCrc.slice16[6][d[1] ^ (crc & 0xFF)]
            ^ kCrc.slice16[5][d[2]] ^ kCrc.slice16[4][d[3]]
            ^ kCrc.slice16[3][d[4]] ^ kCrc.slice16[2][d[5]]
            ^ kCrc.slice16[1][d[6]] ^ kCrc.slice16[0][d[7]]);
    }
    for (; i < len; i++)
        crc = static_cast<uint16_t>(kCrc.crc16[(crc >> 8) ^ data[i]]
                                    ^ (crc << 8));
    return crc;
}

// ---------------------------------------------------------- BitWriter --

// 64-bit accumulator MSB-first writer with a hard buffer bound and a
// sticky eof flag (the reference's bitwriter carries the same guard,
// bitio.h:89-93): once the slot is full no byte is ever stored, pos
// keeps counting, and the caller reports the frame as failed instead
// of corrupting the heap.
struct BitWriter {
    uint8_t* buf;
    int64_t pos;        // bytes flushed (keeps counting past end)
    int64_t end;        // slot capacity in bytes
    uint64_t acc;
    int nacc;
    bool eof;           // sticky: a write did not fit

    BitWriter(uint8_t* b, int64_t size)
        : buf(b), pos(0), end(size), acc(0), nacc(0), eof(false) {}

    inline void emit(uint8_t byte) {
        if (pos < end) buf[pos] = byte;
        else eof = true;
        pos++;
    }

    inline void put(int bits, uint64_t val) {
        acc = (acc << bits) | (val & ((bits == 64)
                                      ? ~0ULL : ((1ULL << bits) - 1)));
        nacc += bits;
        while (nacc >= 8) {
            nacc -= 8;
            emit(static_cast<uint8_t>((acc >> nacc) & 0xFF));
        }
    }

    inline void put_signed(int bits, int64_t val) {
        put(bits, static_cast<uint64_t>(val) & ((1ULL << bits) - 1));
    }

    inline void rice(int k, int32_t val) {
        // zigzag (bitio.h:127-129); shift in uint32 — left-shifting a
        // negative int32 is UB pre-C++20, same bits mod 2^32 either way
        uint32_t v = (static_cast<uint32_t>(val) << 1)
                     ^ static_cast<uint32_t>(val >> 31);
        uint32_t q = v >> k;
        while (q >= 48) {           // long unary runs in byte chunks
            put(48, 0);
            q -= 48;
            if (eof) return;        // bound hostile unary runs
        }
        put(static_cast<int>(q) + 1, 1);
        put(k, v & ((1U << k) - 1));
    }

    inline void flush() {          // zero-pad to byte boundary
        if (nacc > 0) {
            emit(static_cast<uint8_t>((acc << (8 - nacc)) & 0xFF));
            nacc = 0;
        }
        acc = 0;
    }

    inline int64_t count() const { return pos + ((nacc + 7) >> 3); }
};

// FLAC UTF-8 coded numbers carry up to 36 bits (frame number, or the
// first sample number in VBS streams past 2^32 samples) — 64-bit in.
inline void write_utf8(BitWriter& bw, uint64_t val) {
    if (val < 0x80) { bw.put(8, static_cast<uint32_t>(val)); return; }
    int lg = 63 - __builtin_clzll(val);
    int bytes = (lg + 4) / 5;
    int shift = (bytes - 1) * 6;
    bw.put(8, static_cast<uint32_t>((256 - (256 >> bytes)) | (val >> shift)));
    while (shift >= 6) {
        shift -= 6;
        bw.put(8, static_cast<uint32_t>(0x80 | ((val >> shift) & 0x3F)));
    }
}

constexpr int SF_CONSTANT = 0;
constexpr int SF_VERBATIM = 1;
constexpr int SF_FIXED = 8;
constexpr int SF_LPC = 32;

// Reject analysis tensors that would drive the writer into undefined
// shifts or out-of-range indexing (adversarial/buggy device output).
// Mirrors the *constraints* the format imposes (doc/flac_constraints),
// not any reference code path — the reference trusts its own encoder.
inline bool valid_subframe(int typ, int ord, int ob, int w, int po,
                           int B, int parts_stride, const int32_t* ks) {
    if (ob < 1 || ob > 33 || w < 0 || w > 32) return false;
    switch (typ) {
        case SF_CONSTANT:
        case SF_VERBATIM:
            return true;
        case SF_FIXED:
            if (ord < 0 || ord > 4) return false;
            break;
        case SF_LPC:
            if (ord < 1 || ord > 32) return false;
            break;
        default:
            return false;
    }
    if (ord > B) return false;
    if (po < 0 || po > 14 || (1 << po) > parts_stride) return false;
    if ((B >> po) << po != B) return false;
    for (int p = 0; p < (1 << po); p++)
        if (ks[p] < 0 || ks[p] > 30) return false;
    return true;
}

}  // namespace

extern "C" {

// Pack F frames into strided slots out[f * out_stride ...].
// Per-frame data is indexed [f * C + c] (and * B or * 32 or
// * parts_stride for the wide arrays). Returns per-frame byte lengths.
void flake_pack_frames(
    const int32_t* residual,    // [F, C, B]
    const int32_t* coefs,       // [F, C, 32]
    const int32_t* shift,       // [F, C]
    const int32_t* obits,       // [F, C]
    const int32_t* wasted,      // [F, C]
    const int32_t* sf_type,     // [F, C]
    const int32_t* order,       // [F, C]
    const int32_t* porder,      // [F, C]
    const int32_t* method,      // [F, C]
    const int32_t* rice_k,      // [F, C, parts_stride]
    int parts_stride,
    const uint64_t* frame_num,  // [F]
    const int32_t* ch_mode,     // [F] (0 = not stereo)
    int F, int C, int B,
    int bps_code, int sr_code0, int sr_code1,
    int bs_code0, int bs_code1,
    int allow_vbs, int precision, int ch_code,
    uint8_t* out, int64_t out_stride,
    int64_t* lengths) {
#pragma omp parallel for schedule(dynamic, 8)
    for (int f = 0; f < F; f++) {
        uint8_t* slot = out + static_cast<int64_t>(f) * out_stride;
        BitWriter bw(slot, out_stride);

        // validate per-channel selection data up front: a frame with
        // out-of-range values is reported as length -1, never packed
        bool ok = true;
        for (int c = 0; c < C; c++) {
            const int64_t fc = static_cast<int64_t>(f) * C + c;
            ok = ok && valid_subframe(
                sf_type[fc], order[fc], obits[fc], wasted[fc],
                porder[fc], B, parts_stride, rice_k + fc * parts_stride);
        }
        if (!ok) { lengths[f] = -1; continue; }

        // ---- frame header (encode.c:718-764) ----
        bw.put(15, 0x7FFC);
        bw.put(1, allow_vbs);
        bw.put(4, bs_code0);
        bw.put(4, sr_code0);
        bw.put(4, ch_mode[f] ? ch_mode[f] : ch_code);
        bw.put(3, bps_code);
        bw.put(1, 0);
        write_utf8(bw, frame_num[f]);
        if (bs_code1 >= 0) bw.put(bs_code1 < 256 ? 8 : 16, bs_code1);
        if (sr_code1 > 0) bw.put(sr_code1 < 256 ? 8 : 16, sr_code1);
        bw.flush();
        if (bw.eof) { lengths[f] = -1; continue; }
        bw.put(8, calc_crc8(slot, bw.pos));

        // ---- subframes (encode.c:871-905) ----
        for (int c = 0; c < C && !bw.eof; c++) {
            const int64_t fc = static_cast<int64_t>(f) * C + c;
            const int32_t* res = residual + fc * B;
            const int ob = obits[fc];
            const int w = wasted[fc];
            const int typ = sf_type[fc];
            const int ord = order[fc];

            bw.put(1, 0);
            int type_code = typ;
            if (typ == SF_FIXED) type_code = SF_FIXED | ord;
            else if (typ == SF_LPC) type_code = SF_LPC | (ord - 1);
            bw.put(6, type_code);
            if (w) {
                bw.put(1, 1);
                for (int z = 0; z < w - 1; z += 32)
                    bw.put(w - 1 - z < 32 ? w - 1 - z : 32, 0);
                bw.put(1, 1);
            } else {
                bw.put(1, 0);
            }

            if (typ == SF_CONSTANT) {
                bw.put_signed(ob, res[0]);
                continue;
            }
            if (typ == SF_VERBATIM) {
                for (int i = 0; i < B; i++) bw.put_signed(ob, res[i]);
                continue;
            }
            // warm-up samples
            for (int i = 0; i < ord; i++) bw.put_signed(ob, res[i]);
            if (typ == SF_LPC) {
                bw.put(4, precision - 1);
                bw.put_signed(5, shift[fc]);
                const int32_t* cf = coefs + fc * 32;
                for (int i = 0; i < ord; i++)
                    bw.put_signed(precision, cf[i]);
            }
            // ---- Rice partitions (encode.c:766-798) ----
            const int po = porder[fc];
            const int param_bits = 4 + method[fc];
            const int psize = B >> po;
            const int32_t* ks = rice_k + fc * parts_stride;
            bw.put(2, method[fc]);
            bw.put(4, po);
            int j = ord;
            int cnt = psize - ord;
            for (int p = 0; p < (1 << po); p++) {
                const int k = ks[p];
                bw.put(param_bits, k);
                for (int i = 0; i < cnt && j < B; i++, j++)
                    bw.rice(k, res[j]);
                cnt = psize;
            }
        }

        // ---- footer (encode.c:907-917) ----
        bw.flush();
        if (bw.eof || bw.pos + 2 > out_stride) { lengths[f] = -1; continue; }
        const uint16_t crc = calc_crc16(slot, bw.pos);
        bw.put(16, crc);
        bw.flush();
        lengths[f] = bw.eof ? -1 : bw.pos;
    }
}

// ---------------------------------------------------------------- MD5 --
//
// Block-level MD5 compress with caller-owned state, so the digest chain
// can be exported and resumed (functionality the reference gets from its
// in-process md5.c, which must be state-portable here). Implemented from
// RFC 1321: the sine-derived constant table is generated at load time
// and the four round functions are expressed directly.

namespace {

struct Md5Tables {
    uint32_t K[64];
    Md5Tables() {
        for (int i = 0; i < 64; i++) {
            double s = std::sin(static_cast<double>(i + 1));
            K[i] = static_cast<uint32_t>(std::floor(std::fabs(s)
                                                    * 4294967296.0));
        }
    }
};
const Md5Tables kMd5;

constexpr int kShift[64] = {
    7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
    5, 9, 14, 20, 5, 9, 14, 20, 5, 9, 14, 20, 5, 9, 14, 20,
    4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
    6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21};

inline uint32_t rotl32(uint32_t x, int c) {
    return (x << c) | (x >> (32 - c));
}

}  // namespace

// Compress ``nblocks`` 64-byte blocks into state[4] (little-endian
// message words, RFC 1321 section 3.4).
void flake_md5_blocks(uint32_t* state, const uint8_t* data,
                      int64_t nblocks) {
    uint32_t a0 = state[0], b0 = state[1], c0 = state[2], d0 = state[3];
    for (int64_t blk = 0; blk < nblocks; blk++) {
        uint32_t m[16];
        std::memcpy(m, data + blk * 64, 64);  // LE hosts: direct words
        uint32_t a = a0, b = b0, c = c0, d = d0;
        for (int i = 0; i < 64; i++) {
            uint32_t f;
            int g;
            if (i < 16) { f = (b & c) | (~b & d); g = i; }
            else if (i < 32) { f = (d & b) | (~d & c); g = (5 * i + 1) & 15; }
            else if (i < 48) { f = b ^ c ^ d; g = (3 * i + 5) & 15; }
            else { f = c ^ (b | ~d); g = (7 * i) & 15; }
            uint32_t tmp = d;
            d = c;
            c = b;
            b = b + rotl32(a + f + kMd5.K[i] + m[g], kShift[i]);
            a = tmp;
        }
        a0 += a; b0 += b; c0 += c; d0 += d;
    }
    state[0] = a0; state[1] = b0; state[2] = c0; state[3] = d0;
}

// Patch the CRC-8 (last header byte) and CRC-16 (last two frame bytes)
// into a device-emitted stream: the device emission (ops/bitpack.py, K3)
// writes zero placeholders because CRCs are serial byte reductions, the
// one stage cheaper on the host. Parallel over frames; each frame's
// bytes live at offsets[f] .. +lengths[f].
// Returns 0, or 1 + the index of the first malformed frame descriptor.
int64_t flake_crc_patch(uint8_t* buf, int64_t buf_len, int F,
                        const int64_t* offsets, const int64_t* lengths,
                        const int32_t* hdr_nbytes) {
    for (int f = 0; f < F; f++) {
        if (offsets[f] < 0 || lengths[f] < hdr_nbytes[f] + 2
            || hdr_nbytes[f] < 5
            || offsets[f] + lengths[f] > buf_len)
            return 1 + f;
    }
#pragma omp parallel for schedule(dynamic, 8)
    for (int f = 0; f < F; f++) {
        uint8_t* fr = buf + offsets[f];
        const int hb = hdr_nbytes[f];
        fr[hb - 1] = calc_crc8(fr, hb - 1);
        const uint16_t crc = calc_crc16(fr, lengths[f] - 2);
        fr[lengths[f] - 2] = static_cast<uint8_t>(crc >> 8);
        fr[lengths[f] - 1] = static_cast<uint8_t>(crc & 0xFF);
    }
    return 0;
}

// Concatenate strided frame slots into a contiguous stream.
void flake_stitch(const uint8_t* bufs, int F, int64_t stride,
                  const int64_t* lengths, const int64_t* offsets,
                  uint8_t* dest) {
#pragma omp parallel for schedule(static)
    for (int f = 0; f < F; f++) {
        std::memcpy(dest + offsets[f],
                    bufs + static_cast<int64_t>(f) * stride, lengths[f]);
    }
}

uint8_t flake_crc8(const uint8_t* data, int64_t len) {
    return calc_crc8(data, len);
}

uint16_t flake_crc16(const uint8_t* data, int64_t len) {
    return calc_crc16(data, len);
}

}  // extern "C"
