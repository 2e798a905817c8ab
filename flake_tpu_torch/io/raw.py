"""Raw PCM fallback: headerless s16le 44.1 kHz stereo, read to EOF (port
of ``flake_tpu/io/raw.py``).

Reference analogue: libpcm_io/raw.c:38-41 (default parameters) — used
when no container magic matches.
"""

from __future__ import annotations

from typing import BinaryIO

from flake_tpu_torch.io.pcm import PcmInfo, register_format


class _Prefixed:
    """File wrapper replaying the already-consumed magic bytes."""

    def __init__(self, fp: BinaryIO, prefix: bytes):
        self.fp = fp
        self.prefix = prefix

    def read(self, n: int = -1) -> bytes:
        if self.prefix:
            if n < 0:
                out = self.prefix + self.fp.read()
                self.prefix = b""
                return out
            out = self.prefix[:n]
            self.prefix = self.prefix[n:]
            if len(out) < n:
                out += self.fp.read(n - len(out))
            return out
        return self.fp.read(n)


def probe_raw(magic: bytes) -> int:
    return 1  # last-resort fallback (formats.c raw probe scores lowest)


def parse_raw(fp: BinaryIO, magic: bytes) -> PcmInfo:
    info = PcmInfo(format_name="raw", channels=2, sample_rate=44100,
                   bits_per_sample=16, container_bytes=2, signed=True,
                   big_endian=False, data_offset=0, data_size=None)
    info._replay = magic  # type: ignore[attr-defined]
    return info


register_format("raw", probe_raw, parse_raw)
