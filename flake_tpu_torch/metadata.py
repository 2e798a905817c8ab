"""FLAC metadata blocks: STREAMINFO, VORBIS_COMMENT, PADDING, stream header.

The port's copy of :mod:`flake_tpu.metadata` (reference: libflake/metadata.c
and the header-assembly helpers encode.c:52-156); the tests hold the two
equal. Runs once per stream, so it is plain Python.
"""

from __future__ import annotations

import dataclasses
import struct

from flake_tpu_torch.version import __version__


@dataclasses.dataclass
class StreamInfo:
    """Mirror of FlakeStreaminfo (flake.h:239-249)."""

    min_block_size: int = 0
    max_block_size: int = 0
    min_frame_size: int = 0
    max_frame_size: int = 0
    sample_rate: int = 0
    channels: int = 0
    bits_per_sample: int = 0
    samples: int = 0
    md5sum: bytes = b"\x00" * 16


def write_streaminfo(si: StreamInfo) -> bytes:
    """Serialize the 34-byte STREAMINFO body (metadata.c:67-84)."""
    bits = 0
    val = 0

    def put(n, v):
        nonlocal bits, val
        val = (val << n) | (v & ((1 << n) - 1))
        bits += n

    put(16, si.min_block_size)
    put(16, si.max_block_size)
    put(24, si.min_frame_size)
    put(24, si.max_frame_size)
    put(20, si.sample_rate)
    put(3, si.channels - 1)
    put(5, si.bits_per_sample - 1)
    put(4, 0)
    put(32, si.samples)
    # 36 bits of total-samples in full FLAC; reference uses 4+32 split above
    data = val.to_bytes(bits // 8, "big")
    assert len(data) == 18
    return data + si.md5sum


def metadata_block_header(last: int, btype: int, size: int) -> bytes:
    """4-byte metadata block header (encode.c:52-61)."""
    word = (last << 31) | (btype << 24) | (size & 0xFFFFFF)
    return struct.pack(">I", word)


DEFAULT_VENDOR = f"flake-tpu {__version__}"


@dataclasses.dataclass
class VorbisComment:
    """Mirror of FlakeVorbisComment (flake.h:264-268)."""

    vendor_string: str = DEFAULT_VENDOR
    entries: list[str] = dataclasses.field(default_factory=list)


def validate_vorbiscomment_entry(entry: str) -> bool:
    """True if the entry is a valid ``NAME=value`` pair
    (metadata.c:102-126)."""
    if "=" not in entry:
        return False
    name = entry.split("=", 1)[0]
    for c in name:
        if c < " " or c > "}" or c == "=":
            return False
    return True


def add_vorbiscomment_entry(vc: VorbisComment, entry: str) -> bool:
    """Append a validated entry; returns False if invalid
    (metadata.c:154-162)."""
    if not validate_vorbiscomment_entry(entry):
        return False
    if len(vc.entries) >= 1024:
        return False
    vc.entries.append(entry)
    return True


def vorbiscomment_size(vc: VorbisComment) -> int:
    """Byte size of the serialized comment body (metadata.c:164-185)."""
    size = 4 + len(vc.vendor_string.encode("utf-8"))
    size += 4
    for e in vc.entries:
        size += 4 + len(e.encode("utf-8"))
    return size


def write_vorbiscomment(vc: VorbisComment) -> bytes:
    """Serialize the comment body: little-endian lengths per the Vorbis
    spec (metadata.c:196-229)."""
    out = bytearray()
    vendor = vc.vendor_string.encode("utf-8")
    out += struct.pack("<I", len(vendor)) + vendor
    out += struct.pack("<I", len(vc.entries))
    for e in vc.entries:
        eb = e.encode("utf-8")
        out += struct.pack("<I", len(eb)) + eb
    return bytes(out)


def write_headers(si: StreamInfo, padding_size: int,
                  vc: VorbisComment | None = None) -> bytes:
    """'fLaC' marker + STREAMINFO + VORBIS_COMMENT + optional PADDING
    (encode.c:125-156). STREAMINFO starts at byte offset 4; callers patch
    bytes [8:42) after encoding to finalize MD5/max_frame_size
    (flake.c:669-678)."""
    out = bytearray(b"fLaC")
    out += metadata_block_header(0, 0, 34)
    out += write_streaminfo(si)
    if vc is None:
        vc = VorbisComment()
    vc_size = vorbiscomment_size(vc)
    last_vc = 1 if padding_size == 0 else 0
    out += metadata_block_header(last_vc, 4, vc_size)
    out += write_vorbiscomment(vc)
    if padding_size > 0:
        out += metadata_block_header(1, 1, padding_size)
        out += b"\x00" * padding_size
    return bytes(out)
