// Native helpers of the port's verification decoder.
//
// The Python decoder (flake_tpu_torch/decoder.py) is the independent
// oracle that stands in for `flac -t`; its per-sample Rice reads and the
// O(n*order) predictor recurrence are Python-loop bound. These helpers
// run exactly those two inner loops, the residual read and the integer
// recurrence, while frame parsing, CRC checking and MD5 stay in Python.
// Implemented from the FLAC format specification; deliberately shares
// nothing with the encoder's emission path (a shared bug could
// self-verify): this is a reader, written independently.

#include <cstdint>

namespace {

struct BitReader {
    const uint8_t* d;
    int64_t nbits;
    int64_t pos;
    bool err;

    inline uint32_t read(int bits) {           // 0 <= bits <= 32
        if (pos + bits > nbits) {
            err = true;
            return 0;
        }
        uint32_t v = 0;
        int64_t p = pos;
        pos += bits;
        while (bits > 0) {
            const int64_t byte = p >> 3;
            const int off = static_cast<int>(p & 7);
            int take = 8 - off;
            if (take > bits) take = bits;
            const uint32_t chunk =
                (d[byte] >> (8 - off - take)) & ((1u << take) - 1u);
            v = (v << take) | chunk;
            p += take;
            bits -= take;
        }
        return v;
    }

    inline int64_t read_signed(int bits) {
        if (bits == 0) return 0;
        const uint32_t v = read(bits);
        if (v & (1u << (bits - 1)))
            return static_cast<int64_t>(v) - (1ll << bits);
        return static_cast<int64_t>(v);
    }

    inline int64_t read_unary() {
        int64_t q = 0;
        while (true) {
            if (pos >= nbits) {
                err = true;
                return 0;
            }
            const int64_t byte = pos >> 3;
            const int off = static_cast<int>(pos & 7);
            const uint32_t cur = d[byte] & (0xFFu >> off);
            if (cur == 0) {
                q += 8 - off;
                pos += 8 - off;
                continue;
            }
            const int lead = __builtin_clz(cur) - 24;  // zeros from bit 0
            q += lead - off;
            pos += lead - off + 1;
            return q;
        }
    }

    inline int64_t read_rice(int k) {
        const int64_t q = read_unary();
        const uint32_t r = k ? read(k) : 0;
        const uint64_t u = (static_cast<uint64_t>(q) << k) | r;
        return static_cast<int64_t>(u >> 1) ^
               -static_cast<int64_t>(u & 1);
    }
};

}  // namespace

extern "C" {

// Read one subframe's Rice-coded residual section (method, porder,
// per-partition parameters, codes — FLAC spec RESIDUAL) and run the
// integer predictor recurrence in place. ``out`` [n] arrives with the
// first ``order`` entries holding the warm-up samples; on return it
// holds the decoded samples. Returns the new bit position, or a
// negative error code.
int64_t flake_verify_subframe(const uint8_t* data, int64_t nbits,
                              int64_t bitpos, int32_t n, int32_t order,
                              const int32_t* coefs, int32_t shift,
                              int64_t* out) {
    BitReader br{data, nbits, bitpos, false};
    const uint32_t method = br.read(2);
    if (method > 1) return -1;
    const int pb = 4 + static_cast<int>(method);
    const uint32_t escape = (1u << pb) - 1u;
    const uint32_t porder = br.read(4);
    const int64_t psize = static_cast<int64_t>(n) >> porder;
    if ((psize << porder) != n) return -2;
    if (psize - order < 0) return -2;
    int64_t idx = order;
    int64_t cnt = psize - order;
    for (int64_t p = 0; p < (1ll << porder); p++) {
        if (p == 1) cnt = psize;
        const uint32_t k = br.read(pb);
        if (k == escape) {
            const uint32_t raw = br.read(5);
            for (int64_t i = 0; i < cnt; i++)
                out[idx++] = raw ? br.read_signed(raw) : 0;
        } else {
            for (int64_t i = 0; i < cnt; i++)
                out[idx++] = br.read_rice(static_cast<int>(k));
        }
        if (br.err) return -3;
    }
    if (idx != n) return -4;
    for (int64_t i = order; i < n; i++) {
        __int128 pred = 0;
        for (int j = 0; j < order; j++)
            pred += static_cast<__int128>(coefs[j]) * out[i - 1 - j];
        out[i] += static_cast<int64_t>(pred >> shift);
    }
    return br.pos;
}

// Read ``n`` raw ``bits``-wide signed values (VERBATIM subframes /
// warm-up runs). Returns the new bit position or a negative error.
int64_t flake_verify_raw(const uint8_t* data, int64_t nbits,
                         int64_t bitpos, int64_t n, int32_t bits,
                         int64_t* out) {
    BitReader br{data, nbits, bitpos, false};
    for (int64_t i = 0; i < n; i++) out[i] = br.read_signed(bits);
    return br.err ? -3 : br.pos;
}

}  // extern "C"
