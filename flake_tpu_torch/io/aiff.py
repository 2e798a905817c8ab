"""AIFF/AIFF-C container parser, big-endian (port of
``flake_tpu/io/aiff.py``).

Reference analogue: libpcm_io/aiff.c — 80-bit extended-float sample rate
(aiff.c:40-61), COMM/SSND chunk parsing (aiff.c:128-238).
"""

from __future__ import annotations

import struct
from typing import BinaryIO

from flake_tpu_torch.io.pcm import (DEFAULT_CHANNEL_MASKS, PcmInfo,
                                    register_format)


def ext_to_double(b: bytes) -> float:
    """Decode an 80-bit IEEE 754 extended float (aiff.c:40-61)."""
    sign_exp = struct.unpack(">H", b[0:2])[0]
    mantissa = struct.unpack(">Q", b[2:10])[0]
    sign = -1.0 if sign_exp & 0x8000 else 1.0
    exp = sign_exp & 0x7FFF
    if exp == 0 and mantissa == 0:
        return 0.0
    if exp == 0x7FFF:
        return float("inf") * sign
    return sign * mantissa * 2.0 ** (exp - 16383 - 63)


def probe_aiff(magic: bytes) -> int:
    if len(magic) >= 12 and magic[0:4] == b"FORM" and \
            magic[8:12] in (b"AIFF", b"AIFC"):
        return 100
    return 0


def parse_aiff(fp: BinaryIO, magic: bytes) -> PcmInfo:
    """Parse COMM/SSND chunks; leaves ``fp`` at the first data byte
    (aiff.c:128-238). Raises ``ValueError`` for any other magic."""
    if not probe_aiff(magic):
        raise ValueError("not an AIFF/AIFF-C file")
    aifc = magic[8:12] == b"AIFC"
    info = PcmInfo(format_name="aiff", big_endian=True)
    pos = 12
    have_comm = False
    while True:
        hdr = fp.read(8)
        if len(hdr) < 8:
            raise ValueError("AIFF: no SSND chunk found")
        cid, csize = struct.unpack(">4sI", hdr)
        pos += 8
        if cid == b"COMM":
            body = fp.read(csize + (csize & 1))
            pos += len(body)
            channels, nframes, bits = struct.unpack_from(">hIh", body, 0)
            rate = ext_to_double(body[8:18])
            compression = body[18:22] if aifc and csize >= 22 else b"NONE"
            if compression in (b"NONE", b"sowt", b"twos"):
                info.big_endian = compression != b"sowt"
            elif compression == b"fl32":
                info.float_fmt = True
            else:
                raise ValueError(
                    f"AIFF: unsupported compression {compression!r}")
            if channels < 1 or channels > 8:
                raise ValueError(f"AIFF: bad channel count {channels}")
            info.channels = channels
            info.sample_rate = int(rate)
            info.bits_per_sample = bits
            info.container_bytes = (bits + 7) // 8
            info.signed = True
            info.channel_mask = DEFAULT_CHANNEL_MASKS.get(channels, 0)
            info._nframes = nframes  # type: ignore[attr-defined]
            have_comm = True
        elif cid == b"SSND":
            if not have_comm:
                raise ValueError("AIFF: SSND before COMM")
            offset, _blocksize = struct.unpack(">II", fp.read(8))
            pos += 8
            if offset:
                fp.read(offset)
                pos += offset
            info.data_offset = pos
            data_bytes = csize - 8 - offset
            frames = getattr(info, "_nframes", 0)
            if frames:
                data_bytes = min(data_bytes, frames * info.block_align)
            info.data_size = data_bytes if data_bytes > 0 else None
            return info
        else:
            skip = csize + (csize & 1)
            data = fp.read(skip)
            if len(data) < skip:
                raise ValueError("AIFF: truncated chunk")
            pos += skip


register_format("aiff", probe_aiff, parse_aiff)
