"""RIFF/WAVE container parser (port of ``flake_tpu/io/wav.py``).

Reference analogue: libpcm_io/wav.c — fmt chunk parsing including
WAVE_FORMAT_EXTENSIBLE channel masks (wav.c:120-127), data-chunk bounds
(wav.c:163-178), and bit depths 8/16/20/24/32 (wav.c:190-202).
"""

from __future__ import annotations

import struct
from typing import BinaryIO

from flake_tpu_torch.io.pcm import (DEFAULT_CHANNEL_MASKS, PcmInfo,
                                    register_format)

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def probe_wave(magic: bytes) -> int:
    """Magic-byte probe (wav.c:61-77)."""
    if len(magic) >= 12 and magic[0:4] == b"RIFF" and magic[8:12] == b"WAVE":
        return 100
    return 0


def parse_wave(fp: BinaryIO, magic: bytes) -> PcmInfo:
    """Parse fmt/data chunks; leaves ``fp`` at the first data byte
    (wav.c:79-207). Raises ``ValueError`` for any other magic (the JAX
    package asserts, which ``wavinfo`` does not catch)."""
    if not probe_wave(magic):
        raise ValueError("not a RIFF/WAVE file")
    info = PcmInfo(format_name="wave")
    pos = 12  # past RIFF size + WAVE
    have_fmt = False
    while True:
        hdr = fp.read(8)
        if len(hdr) < 8:
            raise ValueError("WAVE: no data chunk found")
        cid, csize = struct.unpack("<4sI", hdr)
        pos += 8
        if cid == b"fmt ":
            body = fp.read(csize + (csize & 1))
            pos += len(body)
            (tag, channels, sample_rate, _byte_rate, block_align,
             bits) = struct.unpack_from("<HHIIHH", body, 0)
            if tag == WAVE_FORMAT_EXTENSIBLE and csize >= 40:
                cb_size, valid_bits, ch_mask = struct.unpack_from(
                    "<HHI", body, 16)
                sub_format = struct.unpack_from("<H", body, 24)[0]
                info.channel_mask = ch_mask
                tag = sub_format
                if valid_bits:
                    bits = valid_bits
            if tag == WAVE_FORMAT_IEEE_FLOAT:
                info.float_fmt = True
            elif tag != WAVE_FORMAT_PCM:
                raise ValueError(f"WAVE: unsupported format tag {tag:#x}")
            if channels < 1 or channels > 8:
                raise ValueError(f"WAVE: bad channel count {channels}")
            if bits not in (8, 16, 20, 24, 32) and not info.float_fmt:
                raise ValueError(f"WAVE: unsupported bit depth {bits}")
            info.channels = channels
            info.sample_rate = sample_rate
            info.bits_per_sample = bits
            info.container_bytes = block_align // channels
            info.signed = bits > 8
            info.big_endian = False
            if not info.channel_mask:
                info.channel_mask = DEFAULT_CHANNEL_MASKS.get(channels, 0)
            have_fmt = True
        elif cid == b"data":
            if not have_fmt:
                raise ValueError("WAVE: data chunk before fmt chunk")
            info.data_offset = pos
            info.data_size = csize if csize > 0 else None
            return info
        else:
            skip = csize + (csize & 1)
            data = fp.read(skip)
            if len(data) < skip:
                raise ValueError("WAVE: truncated chunk")
            pos += skip


register_format("wave", probe_wave, parse_wave)


def write_wave(path, pcm, sample_rate: int, bits_per_sample: int = 16):
    """Write int32 [n, channels] native-range samples as a canonical PCM
    WAV file (testing/benchmark helper; the reference ships none)."""
    import numpy as np

    n, channels = pcm.shape
    cb = (bits_per_sample + 7) // 8
    block_align = cb * channels
    data_size = n * block_align

    flat = np.ascontiguousarray(pcm.reshape(-1).astype("<i4"))
    if bits_per_sample == 8:
        raw = (flat + 128).astype(np.uint8).tobytes()
    else:
        raw = np.ascontiguousarray(
            flat.view(np.uint8).reshape(-1, 4)[:, :cb]).tobytes()

    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + data_size))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, WAVE_FORMAT_PCM, channels,
                            sample_rate, sample_rate * block_align,
                            block_align, bits_per_sample))
        f.write(b"data")
        f.write(struct.pack("<I", data_size))
        f.write(raw)
