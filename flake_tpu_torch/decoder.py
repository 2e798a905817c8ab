"""Independent FLAC decoder used for verification (stand-in for ``flac -t``).

Implements enough of the FLAC format to fully decode what the encoder can
produce — all subframe types, Rice/Rice2 partitions, all stereo modes,
wasted bits, standard and custom block-size/sample-rate codes — and
verifies frame CRC-8/CRC-16 and the STREAMINFO MD5, which is exactly the
check ``flac -t`` performs.

Written against the FLAC format specification; deliberately shares no code
with the encoder paths so it can serve as an independent oracle.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from flake_tpu_torch.crc import crc8, crc16
from flake_tpu_torch.native import get_verifier


class FlacDecodeError(Exception):
    pass


# Native inner-loop helpers (Rice residual read + predictor
# recurrence): a separate shared object written from the format spec,
# independent of the encoder runtime. Set False to force the
# pure-Python loops (cross-checked in tests).
USE_NATIVE = True


def _get_native():
    return get_verifier() if USE_NATIVE else None


class BitReader:
    """MSB-first bit reader over a bytes object."""

    def __init__(self, data: bytes, pos_bits: int = 0):
        self.data = data
        self.pos = pos_bits  # absolute bit position

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        end = self.pos + nbits
        if end > len(self.data) * 8:
            raise FlacDecodeError("bitstream truncated")
        first_byte = self.pos >> 3
        last_byte = (end + 7) >> 3
        chunk = int.from_bytes(self.data[first_byte:last_byte], "big")
        total_bits = (last_byte - first_byte) * 8
        val = (chunk >> (total_bits - (end - first_byte * 8))) \
            & ((1 << nbits) - 1)
        self.pos = end
        return val

    def read_signed(self, nbits: int) -> int:
        v = self.read(nbits)
        if v >= (1 << (nbits - 1)):
            v -= 1 << nbits
        return v

    def read_unary(self) -> int:
        """Count zero bits until a one bit (inclusive of neither)."""
        n = 0
        byte_pos = self.pos >> 3
        bit_in_byte = self.pos & 7
        data = self.data
        while True:
            if byte_pos >= len(data):
                raise FlacDecodeError("bitstream truncated in unary")
            b = data[byte_pos] & (0xFF >> bit_in_byte)
            if b:
                msb = 7 - b.bit_length() + 1  # index of highest set bit
                n += msb - bit_in_byte
                self.pos = byte_pos * 8 + msb + 1
                return n
            n += 8 - bit_in_byte
            byte_pos += 1
            bit_in_byte = 0

    def read_rice_signed(self, k: int) -> int:
        q = self.read_unary()
        v = (q << k) | self.read(k)
        # zigzag decode
        return (v >> 1) ^ -(v & 1)

    def align(self):
        self.pos = (self.pos + 7) & ~7


@dataclasses.dataclass
class StreamInfo:
    min_block_size: int
    max_block_size: int
    min_frame_size: int
    max_frame_size: int
    sample_rate: int
    channels: int
    bits_per_sample: int
    samples: int
    md5sum: bytes


@dataclasses.dataclass
class DecodedStream:
    streaminfo: StreamInfo
    samples: np.ndarray            # int32 [nsamples, channels]
    frames: int
    md5_ok: bool
    vorbis_vendor: str | None = None
    vorbis_entries: list[str] = dataclasses.field(default_factory=list)


BLOCKSIZE_TABLE = (0, 192, 576, 1152, 2304, 4608, -1, -2,
                   256, 512, 1024, 2048, 4096, 8192, 16384)
SAMPLERATE_TABLE = (0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
                    32000, 44100, 48000, 96000, -1, -2, -3, 0)
BPS_TABLE = (0, 8, 12, 0, 16, 20, 24, 0)

FIXED_COEFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def _read_utf8_number(br: BitReader) -> int:
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    nbytes = 0
    mask = 0x80
    while b0 & mask:
        nbytes += 1
        mask >>= 1
    if nbytes < 2 or nbytes > 7:
        raise FlacDecodeError(f"bad UTF-8 lead byte {b0:#x}")
    val = b0 & (0x7F >> nbytes)
    for _ in range(nbytes - 1):
        b = br.read(8)
        if (b & 0xC0) != 0x80:
            raise FlacDecodeError("bad UTF-8 continuation byte")
        val = (val << 6) | (b & 0x3F)
    return val


def _decode_subframe(br: BitReader, n: int, obits: int) -> np.ndarray:
    pad = br.read(1)
    if pad != 0:
        raise FlacDecodeError("subframe padding bit set")
    type_code = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
    obits -= wasted

    if type_code == 0:  # CONSTANT
        v = br.read_signed(obits)
        out = np.full(n, v, dtype=np.int64)
    elif type_code == 1:  # VERBATIM
        lib = _get_native()
        if lib is not None:
            out = np.empty(n, dtype=np.int64)
            data = np.frombuffer(br.data, dtype=np.uint8)
            rc = lib.flake_verify_raw(data, len(br.data) * 8, br.pos,
                                      n, obits, out)
            if rc < 0:
                raise FlacDecodeError("bitstream truncated")
            br.pos = int(rc)
        else:
            out = np.array([br.read_signed(obits) for _ in range(n)],
                           dtype=np.int64)
    elif 8 <= type_code <= 12:  # FIXED, order 0-4
        order = type_code - 8
        out = _decode_predicted(br, n, obits, order, FIXED_COEFS[order],
                                0)
    elif type_code >= 32:  # LPC
        order = (type_code & 0x1F) + 1
        warmup = [br.read_signed(obits) for _ in range(order)]
        precision = br.read(4) + 1
        if precision == 16:
            raise FlacDecodeError("invalid LPC precision escape")
        shift = br.read_signed(5)
        if shift < 0:
            raise FlacDecodeError("negative LPC shift")
        coefs = [br.read_signed(precision) for _ in range(order)]
        out = _decode_predicted(br, n, obits, order, coefs, shift,
                                warmup=warmup)
    else:
        raise FlacDecodeError(f"reserved subframe type {type_code}")

    return out << wasted


def _read_residual(br: BitReader, n: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise FlacDecodeError("reserved residual coding method")
    param_bits = 4 + method
    escape = (1 << param_bits) - 1
    porder = br.read(4)
    psize = n >> porder
    if psize << porder != n:
        raise FlacDecodeError("partition order does not divide block size")
    res = np.empty(n - order, dtype=np.int64)
    idx = 0
    cnt = psize - order
    for p in range(1 << porder):
        if p == 1:
            cnt = psize
        k = br.read(param_bits)
        if k == escape:
            raw_bits = br.read(5)
            for _ in range(cnt):
                res[idx] = br.read_signed(raw_bits) if raw_bits else 0
                idx += 1
        else:
            for _ in range(cnt):
                res[idx] = br.read_rice_signed(k)
                idx += 1
    if idx != n - order:
        raise FlacDecodeError("residual count mismatch")
    return res


def _decode_predicted(br: BitReader, n, obits, order, coefs, shift,
                      warmup=None) -> np.ndarray:
    if warmup is None:
        warmup = [br.read_signed(obits) for _ in range(order)]
    lib = _get_native()
    if lib is not None:
        out = np.empty(n, dtype=np.int64)
        out[:order] = warmup
        carr = np.ascontiguousarray(coefs, dtype=np.int32)
        if carr.size < max(order, 1):
            carr = np.pad(carr, (0, max(order, 1) - carr.size))
        data = np.frombuffer(br.data, dtype=np.uint8)
        rc = lib.flake_verify_subframe(data, len(br.data) * 8, br.pos,
                                       n, order, carr, shift, out)
        if rc == -1:
            raise FlacDecodeError("reserved residual coding method")
        if rc == -2:
            raise FlacDecodeError(
                "partition order does not divide block size")
        if rc < 0:
            raise FlacDecodeError("bitstream truncated")
        br.pos = int(rc)
        return out
    res = _read_residual(br, n, order)
    out = np.empty(n, dtype=np.int64)
    out[:order] = warmup
    c = coefs  # c[0] applies to the previous sample
    for i in range(order, n):
        pred = 0
        for j in range(order):
            pred += c[j] * int(out[i - 1 - j])
        out[i] = int(res[i - order]) + (pred >> shift)
    return out


def _parse_metadata(data: bytes):
    if data[:4] != b"fLaC":
        raise FlacDecodeError("missing fLaC stream marker")
    pos = 4
    streaminfo = None
    vendor = None
    entries: list[str] = []
    while True:
        header = int.from_bytes(data[pos:pos + 4], "big")
        last = header >> 31
        btype = (header >> 24) & 0x7F
        size = header & 0xFFFFFF
        body = data[pos + 4:pos + 4 + size]
        pos += 4 + size
        if btype == 0:
            br = BitReader(body)
            streaminfo = StreamInfo(
                min_block_size=br.read(16),
                max_block_size=br.read(16),
                min_frame_size=br.read(24),
                max_frame_size=br.read(24),
                sample_rate=br.read(20),
                channels=br.read(3) + 1,
                bits_per_sample=br.read(5) + 1,
                samples=(br.read(4) << 32) | br.read(32),
                md5sum=body[18:34],
            )
        elif btype == 4:
            vlen = int.from_bytes(body[0:4], "little")
            vendor = body[4:4 + vlen].decode("utf-8", "replace")
            off = 4 + vlen
            n_entries = int.from_bytes(body[off:off + 4], "little")
            off += 4
            for _ in range(n_entries):
                elen = int.from_bytes(body[off:off + 4], "little")
                off += 4
                entries.append(body[off:off + elen]
                               .decode("utf-8", "replace"))
                off += elen
        if last:
            break
    if streaminfo is None:
        raise FlacDecodeError("no STREAMINFO block")
    return streaminfo, vendor, entries, pos


def decode_frame(data: bytes, byte_pos: int, si: StreamInfo):
    """Decode one frame starting at ``byte_pos``.

    Returns (samples int32 [n, channels], new_byte_pos, frame_or_sample_no).
    Raises FlacDecodeError on any CRC/syntax violation.
    """
    br = BitReader(data, byte_pos * 8)
    sync = br.read(15)
    if sync != 0x7FFC:
        raise FlacDecodeError(f"bad sync code {sync:#x} at byte {byte_pos}")
    _blocking_strategy = br.read(1)
    bs_code = br.read(4)
    sr_code = br.read(4)
    ch_code = br.read(4)
    bps_code = br.read(3)
    if br.read(1):
        raise FlacDecodeError("reserved frame-header bit set")
    number = _read_utf8_number(br)

    if bs_code == 0:
        raise FlacDecodeError("reserved block size code 0")
    n = BLOCKSIZE_TABLE[bs_code]
    if n == -1:
        n = br.read(8) + 1
    elif n == -2:
        n = br.read(16) + 1

    sr = SAMPLERATE_TABLE[sr_code]
    if sr == -1:
        sr = br.read(8) * 1000
    elif sr == -2:
        sr = br.read(16)
    elif sr == -3:
        sr = br.read(16) * 10
    elif sr == 0:
        sr = si.sample_rate

    bps = BPS_TABLE[bps_code]
    if bps == 0:
        bps = si.bits_per_sample

    hdr_crc = br.read(8)
    hdr_len = (br.pos >> 3) - byte_pos - 1
    expect = crc8(data[byte_pos:byte_pos + hdr_len])
    if hdr_crc != expect:
        raise FlacDecodeError(
            f"frame header CRC-8 mismatch ({hdr_crc:#x} != {expect:#x})")

    if ch_code < 8:
        channels = ch_code + 1
        chans = [_decode_subframe(br, n, bps) for _ in range(channels)]
        out = np.stack(chans, axis=1)
    elif ch_code in (8, 9, 10):
        ob0 = bps + (1 if ch_code == 9 else 0)
        ob1 = bps + (1 if ch_code in (8, 10) else 0)
        c0 = _decode_subframe(br, n, ob0)
        c1 = _decode_subframe(br, n, ob1)
        if ch_code == 8:      # left/side
            left, right = c0, c0 - c1
        elif ch_code == 9:    # right/side
            left, right = c0 + c1, c1
        else:                 # mid/side
            side = c1
            mid = (c0 << 1) | (side & 1)
            left = (mid + side) >> 1
            right = (mid - side) >> 1
        out = np.stack([left, right], axis=1)
    else:
        raise FlacDecodeError(f"reserved channel assignment {ch_code}")

    br.align()
    frame_crc = br.read(16)
    end = br.pos >> 3
    expect = crc16(data[byte_pos:end - 2])
    if frame_crc != expect:
        raise FlacDecodeError(
            f"frame CRC-16 mismatch ({frame_crc:#x} != {expect:#x})")

    return out.astype(np.int64), end, number


def decode_stream(data: bytes, verify_md5: bool = True) -> DecodedStream:
    """Decode a whole FLAC stream, verifying CRCs and (optionally) MD5."""
    si, vendor, entries, pos = _parse_metadata(data)
    chunks = []
    nframes = 0
    while pos < len(data):
        samples, pos, _num = decode_frame(data, pos, si)
        chunks.append(samples)
        nframes += 1
    if chunks:
        pcm = np.concatenate(chunks, axis=0)
    else:
        pcm = np.zeros((0, si.channels), dtype=np.int64)

    md5_ok = True
    if verify_md5 and si.md5sum != b"\x00" * 16:
        bytes_per_sample = (si.bits_per_sample + 7) >> 3
        flat = np.ascontiguousarray(pcm.reshape(-1).astype("<i4"))
        raw = flat.view(np.uint8).reshape(-1, 4)[:, :bytes_per_sample]
        digest = hashlib.md5(np.ascontiguousarray(raw).tobytes()).digest()
        md5_ok = digest == si.md5sum
        if not md5_ok:
            raise FlacDecodeError("stream MD5 mismatch")

    return DecodedStream(streaminfo=si,
                         samples=pcm.astype(np.int32),
                         frames=nframes, md5_ok=md5_ok,
                         vorbis_vendor=vendor, vorbis_entries=entries)
