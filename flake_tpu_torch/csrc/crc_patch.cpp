// Host CRC patch of the port: the device emits each frame's bytes with
// zero placeholders for the CRC-8 (last header byte) and the CRC-16 (last
// two frame bytes), because a CRC is a serial byte reduction and is the
// one stage cheaper on the host. This file fills the placeholders,
// parallel over frames with OpenMP. The polynomials are the FLAC
// format's: CRC-8 0x07 over the frame header, CRC-16 0x8005 over the
// whole frame, both with a zero seed (reference encode.c:718-764,
// 907-917).

#include <cstdint>

namespace {

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

}  // namespace

// Frame f's bytes live at buf + offsets[f] .. + lengths[f]; hdr_nbytes[f]
// counts its header bytes, the CRC-8 byte included. Returns 0, or 1 + the
// index of the first malformed frame descriptor (nothing is written then).
extern "C" int64_t flake_crc_patch(uint8_t* buf, int64_t buf_len, int F,
                                   const int64_t* offsets,
                                   const int64_t* lengths,
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
