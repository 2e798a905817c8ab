"""Host CRC patch: the repository's C++ packer, bound with ctypes.

Builds ``flake_tpu/native/packer.cpp`` (read by path, not copied) with the
same g++ flags as ``flake_tpu/native/__init__.py:31-34`` into the port's
build directory, and binds only ``flake_crc_patch``: the port emits frame
bytes on the device and the host fills the CRC-8/CRC-16 placeholders.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from flake_tpu_torch import _build

SRC = _build.ROOT / "flake_tpu" / "native" / "packer.cpp"
LIB = _build.BUILD_DIR / "libflake_packer.so"
GXX = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp",
       "-march=native"]

_lock = threading.Lock()
_lib = None


def build() -> str:
    """Build the packer library if it is missing or stale."""
    return _build.build(GXX, [SRC], LIB)


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB))
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.flake_crc_patch.argtypes = [u8p, ctypes.c_int64,
                                            ctypes.c_int, i64p, i64p, i32p]
            lib.flake_crc_patch.restype = ctypes.c_int64
            _lib = lib
        return _lib


def crc_patch(buf: np.ndarray, lengths: np.ndarray,
              hdr_nbytes: np.ndarray) -> None:
    """Fill the CRC-8/CRC-16 placeholders of a device-emitted stream in
    place. ``buf`` uint8 [total]; ``lengths`` int64 [F] per-frame byte
    counts (frames contiguous in order); ``hdr_nbytes`` int32 [F] header
    byte counts incl. the CRC-8 byte."""
    lib = get_lib()
    F = lengths.shape[0]
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    offsets = np.zeros(F, dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    rc = lib.flake_crc_patch(
        buf, buf.shape[0], F, offsets, lengths,
        np.ascontiguousarray(hdr_nbytes, dtype=np.int32))
    if rc:
        raise ValueError(
            f"crc_patch: malformed frame descriptor at index {rc - 1}")
