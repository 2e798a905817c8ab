"""CRC-8 / CRC-16 for FLAC frame headers and footers.

Same polynomials as the FLAC spec (reference: libflake/crc.c:43-47 —
CRC-8 poly 0x07 for the frame header, CRC-16 poly 0x8005 for the frame
footer). Table-driven; the verification decoder uses these, the encoder's
hot path the C++ implementation behind :mod:`flake_tpu_torch.native`.
"""

from __future__ import annotations

import numpy as np

CRC8_POLY = 0x07
CRC16_POLY = 0x8005


def _make_table(bits: int, poly: int) -> np.ndarray:
    full = poly | (1 << bits)
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        crc = i
        for _ in range(bits):
            if crc & (1 << (bits - 1)):
                crc = (crc << 1) ^ full
            else:
                crc <<= 1
        table[i] = crc & ((1 << bits) - 1)
    return table


CRC8_TABLE = _make_table(8, CRC8_POLY)
CRC16_TABLE = _make_table(16, CRC16_POLY)


def crc8(data: bytes | np.ndarray) -> int:
    """CRC-8 over ``data`` with init 0 (crc.c:74-83)."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    crc = 0
    for b in buf:
        crc = CRC8_TABLE[crc ^ b]
    return int(crc)


def crc16(data: bytes | np.ndarray) -> int:
    """CRC-16 over ``data`` with init 0 (crc.c:85-94)."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    crc = 0
    for b in buf:
        crc = CRC16_TABLE[(crc >> 8) ^ b] ^ ((crc << 8) & 0xFFFF)
    return int(crc)
