"""MD5 whose state can leave the process (port of ``flake_tpu/md5.py``).

The FLAC stream MD5 (reference md5.c:281-320) is one sequential chain over
the raw little-endian sample bytes. When ranks encode spans of a stream,
the chain has to pass from rank to rank in order, and ``hashlib`` cannot
export its state. :class:`Md5Chain` keeps MD5's (state, count, pending
tail) in numpy and Python, compresses whole blocks with the port's native
``flake_md5_blocks`` (``csrc/packer.cpp``), and exports its state as 88
bytes: the JAX package's blob, byte for byte, so a chain may pass between
the two packages.
"""

from __future__ import annotations

import numpy as np

from flake_tpu_torch.native import md5_blocks

_INIT = np.array([0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476],
                 dtype=np.uint32)
STATE_BYTES = 88


class Md5Chain:
    """Incremental MD5 whose state can be exported and imported."""

    def __init__(self):
        self._state = _INIT.copy()
        self._count = 0          # message bytes so far
        self._pending = b""      # < 64 bytes awaiting a full block

    def update(self, data: bytes | np.ndarray) -> None:
        if isinstance(data, np.ndarray):
            data = np.ascontiguousarray(data)
        # whole blocks are compressed where they lie (a rank's span is a
        # gigabyte); only the pending tail is copied
        view = memoryview(data).cast("B")
        if not len(view):
            return
        self._count += len(view)
        if self._pending:
            take = min(64 - len(self._pending), len(view))
            self._pending += bytes(view[:take])
            view = view[take:]
            if len(self._pending) < 64:
                return
            md5_blocks(self._state, self._pending)
            self._pending = b""
        whole = len(view) // 64 * 64
        if whole:
            md5_blocks(self._state, view[:whole])
        self._pending = bytes(view[whole:])

    def digest(self) -> bytes:
        """The digest of what was hashed so far; the chain goes on."""
        state = self._state.copy()
        # RFC 1321 padding: 0x80, zeros, the 64-bit little-endian bit length
        bitlen = (self._count * 8) & 0xFFFFFFFFFFFFFFFF
        tail = (self._pending + b"\x80" + b"\x00" * ((55 - self._count) % 64)
                + bitlen.to_bytes(8, "little"))
        md5_blocks(state, tail)
        return state.tobytes()

    def hexdigest(self) -> str:
        return self.digest().hex()

    def export_state(self) -> bytes:
        """88 bytes: 16 B state, 8 B count (little-endian), 1 B tail
        length, 63 B tail (zero-padded)."""
        tail = self._pending
        return (self._state.tobytes() + self._count.to_bytes(8, "little")
                + bytes([len(tail)]) + tail.ljust(63, b"\x00"))

    @classmethod
    def import_state(cls, blob: bytes) -> "Md5Chain":
        if len(blob) != STATE_BYTES or blob[24] > 63:
            raise ValueError("bad md5 state blob")
        h = cls.__new__(cls)
        h._state = np.frombuffer(blob[:16], dtype=np.uint32).copy()
        h._count = int.from_bytes(blob[16:24], "little")
        h._pending = bytes(blob[25:25 + blob[24]])
        return h

    def copy(self) -> "Md5Chain":
        return Md5Chain.import_state(self.export_state())


def pcm_md5_bytes(pcm: np.ndarray, bps: int) -> bytes:
    """The sample bytes the FLAC MD5 takes: interleaved, little-endian,
    (bps + 7) / 8 bytes a sample (reference encode.c, md5.c)."""
    width = (bps + 7) >> 3
    flat = pcm.reshape(-1)
    if width != 3:
        # the low bytes of each sample: a narrowing cast keeps them
        return flat.astype(f"<i{width}").tobytes()
    raw = np.ascontiguousarray(flat.astype("<i4")).view(np.uint8)
    return np.ascontiguousarray(raw.reshape(-1, 4)[:, :3]).tobytes()
