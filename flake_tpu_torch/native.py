"""The port's host-side native code, built with g++ and bound with ctypes.

Two small libraries, each from one source of ``flake_tpu_torch/csrc/`` and
built at first use into the port's build directory:

- ``crc_patch.cpp``: ``flake_crc_patch``. The port emits frame bytes on
  the device and the host fills the CRC-8/CRC-16 placeholders.
- ``verifier.cpp``: the inner loops of the verification decoder
  (:mod:`flake_tpu_torch.decoder`), kept apart from the encoder's
  library so the decoder stays an independent check.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from flake_tpu_torch import _build

CSRC = _build.ROOT / "flake_tpu_torch" / "csrc"
SRC = CSRC / "crc_patch.cpp"
LIB = _build.BUILD_DIR / "libflake_crc_patch.so"
VERIFIER_SRC = CSRC / "verifier.cpp"
VERIFIER_LIB = _build.BUILD_DIR / "libflake_verifier.so"
GXX = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp",
       "-march=native"]

_lock = threading.Lock()
_lib = None
_verifier = None

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def build() -> str:
    """Build the CRC patch library if it is missing or stale."""
    return _build.build(GXX, [SRC], LIB)


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB))
            lib.flake_crc_patch.argtypes = [_u8p, ctypes.c_int64,
                                            ctypes.c_int, _i64p, _i64p,
                                            _i32p]
            lib.flake_crc_patch.restype = ctypes.c_int64
            _lib = lib
        return _lib


def get_verifier() -> ctypes.CDLL:
    """The verification decoder's helper library (built if missing or
    stale)."""
    global _verifier
    with _lock:
        if _verifier is None:
            _build.build(GXX, [VERIFIER_SRC], VERIFIER_LIB)
            lib = ctypes.CDLL(str(VERIFIER_LIB))
            lib.flake_verify_subframe.argtypes = [
                _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32, _i32p, ctypes.c_int32, _i64p]
            lib.flake_verify_subframe.restype = ctypes.c_int64
            lib.flake_verify_raw.argtypes = [
                _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32, _i64p]
            lib.flake_verify_raw.restype = ctypes.c_int64
            _verifier = lib
        return _verifier


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
