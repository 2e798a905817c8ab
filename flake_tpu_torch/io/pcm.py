"""PCM input core: probe registry, chunked reads, int32 conversion
(port of ``flake_tpu/io/pcm.py``).

Reference analogue: libpcm_io/pcm_io.c (reader core, 24-bit unpacking,
endian handling), formats.c (score-based probe registry), convert.c
(sample-format conversion — native range, sign-extension only).
"""

from __future__ import annotations

import dataclasses
from typing import BinaryIO, Callable

import numpy as np

# default channel masks by channel count (pcm_io.c:383-399)
DEFAULT_CHANNEL_MASKS = {
    1: 0x04, 2: 0x03, 3: 0x07, 4: 0x107, 5: 0x37, 6: 0x3F,
}


@dataclasses.dataclass
class PcmInfo:
    """Stream description produced by a format parser
    (pcm_io.h struct PcmFile, condensed)."""

    format_name: str = "raw"
    channels: int = 2
    sample_rate: int = 44100
    bits_per_sample: int = 16      # valid bits (e.g. 20-in-24 containers)
    container_bytes: int = 2       # bytes per stored sample
    signed: bool = True
    big_endian: bool = False
    float_fmt: bool = False
    data_offset: int = 0           # byte offset of sample data
    data_size: int | None = None   # bytes of sample data (None = to EOF)
    channel_mask: int = 0

    @property
    def block_align(self) -> int:
        return self.container_bytes * self.channels

    @property
    def samples(self) -> int:
        """Total per-channel sample count (0 if unknown)."""
        if self.data_size is None or self.block_align == 0:
            return 0
        return self.data_size // self.block_align

    @property
    def duration(self) -> float:
        if self.sample_rate == 0:
            return 0.0
        return self.samples / self.sample_rate


# -- probe registry (formats.c:50-89) ---------------------------------------

_FORMATS: list[tuple[str, Callable[[bytes], int],
                     Callable[[BinaryIO, bytes], PcmInfo]]] = []


def register_format(name: str, probe: Callable[[bytes], int],
                    parse: Callable[[BinaryIO, bytes], PcmInfo]) -> None:
    """Register a container format: ``probe(magic12) -> score`` and
    ``parse(fileobj, magic12) -> PcmInfo``."""
    _FORMATS.append((name, probe, parse))


def probe_format(magic: bytes) -> str | None:
    """Pick the highest-scoring registered format for the 12 magic bytes
    (formats.c:71-89)."""
    best, best_score = None, 0
    for name, probe, _ in _FORMATS:
        score = probe(magic)
        if score > best_score:
            best, best_score = name, score
    return best


class PcmReader:
    """Chunked reader producing interleaved int32 blocks
    (pcm_io.c:155-277)."""

    def __init__(self, fp: BinaryIO, info: PcmInfo):
        self.fp = fp
        self.info = info
        self._remaining = info.data_size
        self._consumed = 0  # sample frames delivered so far

    def read_samples(self, n: int) -> np.ndarray:
        """Read up to ``n`` interleaved sample frames; returns int32
        [frames, channels] (short or empty at EOF)."""
        info = self.info
        want = n * info.block_align
        if self._remaining is not None:
            want = min(want, self._remaining)
        raw = self.fp.read(want)
        if self._remaining is not None:
            self._remaining -= len(raw)
        usable = len(raw) - (len(raw) % info.block_align)
        if usable == 0:
            return np.zeros((0, info.channels), dtype=np.int32)
        out = decode_pcm_block(raw[:usable], info)
        self._consumed += out.shape[0]
        return out

    def read_all(self) -> np.ndarray:
        chunks = []
        while True:
            blk = self.read_samples(1 << 18)
            if blk.shape[0] == 0:
                break
            chunks.append(blk)
        if not chunks:
            return np.zeros((0, self.info.channels), dtype=np.int32)
        return np.concatenate(chunks, axis=0)

    def position(self) -> int:
        """Current position in sample frames (pcm_io.c position API)."""
        return self._consumed

    def seek_samples(self, offset: int, whence: int = 0) -> int:
        """Seek by sample frames (pcm_io.c:279-324). whence: 0=set,
        1=cur, 2=end. Falls back to a slow forward read for pipes.
        Returns the new position."""
        info = self.info
        if whence == 1:
            target = self._consumed + offset
        elif whence == 2:
            if info.samples == 0:
                raise ValueError("cannot seek from end: unknown length")
            target = info.samples + offset
        else:
            target = offset
        target = max(target, 0)
        if info.samples:
            target = min(target, info.samples)

        byte_pos = info.data_offset + target * info.block_align
        try:
            self.fp.seek(byte_pos)
            if self._remaining is not None:
                self._remaining = (info.data_size
                                   - target * info.block_align)
            self._consumed = target
            return target
        except (OSError, AttributeError):
            pass
        # non-seekable stream: slow forward-only seek (pcm_io.c:41-85)
        if target < self._consumed:
            raise ValueError("cannot seek backwards in a pipe")
        while self._consumed < target:
            n = min(target - self._consumed, 1 << 16)
            if self.read_samples(n).shape[0] == 0:
                break
        return self._consumed


def decode_pcm_block(raw: bytes, info: PcmInfo) -> np.ndarray:
    """Convert packed sample bytes to native-range int32 [frames, ch]
    (pcm_io.c:208-270 for unpacking, convert.c for range semantics)."""
    bo = ">" if info.big_endian else "<"
    cb = info.container_bytes
    if info.float_fmt:
        if cb == 4:
            f = np.frombuffer(raw, dtype=f"{bo}f4").astype(np.float64)
        elif cb == 8:
            f = np.frombuffer(raw, dtype=f"{bo}f8").astype(np.float64)
        else:
            raise ValueError(f"unsupported float width {cb}")
        scale = float(1 << (info.bits_per_sample - 1))
        lim = scale - 1
        x = np.clip(np.rint(f * scale), -scale, lim).astype(np.int32)
    elif cb == 1:
        x = np.frombuffer(raw, dtype=np.uint8).astype(np.int32)
        if not info.signed:
            x -= 128  # u8 -> native signed range (convert.c:131-139)
    elif cb == 2:
        x = np.frombuffer(raw, dtype=f"{bo}i2").astype(np.int32)
    elif cb == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        if info.big_endian:
            b = b[:, ::-1]
        x = (b[:, 0].astype(np.uint32)
             | (b[:, 1].astype(np.uint32) << 8)
             | (b[:, 2].astype(np.uint32) << 16)).astype(np.int32)
        # valid bits are right-justified in the container; sign-extend at
        # bits_per_sample (pcm_io.c:226-240: shift by 32 - bit_width)
        ub = 32 - info.bits_per_sample
        x = (x << ub) >> ub
    elif cb == 4:
        x = np.frombuffer(raw, dtype=f"{bo}i4").astype(np.int32)
        if info.bits_per_sample < 32:
            ub = 32 - info.bits_per_sample
            x = (x << ub) >> ub
    else:
        raise ValueError(f"unsupported container width {cb}")

    return x.reshape(-1, info.channels)


def open_pcm(fp: BinaryIO, forced_format: str | None = None) -> PcmReader:
    """Probe + parse a PCM container (pcm_io.c:87-147); the formats are
    registered when the package is imported."""
    magic = fp.read(12)
    fmt = forced_format or probe_format(magic) or "raw"
    for name, _, parse in _FORMATS:
        if name == fmt:
            info = parse(fp, magic)
            replay = getattr(info, "_replay", b"")
            if replay:
                from flake_tpu_torch.io.raw import _Prefixed
                fp = _Prefixed(fp, replay)  # type: ignore[assignment]
            return PcmReader(fp, info)
    raise ValueError(f"unknown format {fmt!r}")
