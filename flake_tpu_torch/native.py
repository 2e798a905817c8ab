"""The port's host-side native code, built with g++ and bound with ctypes.

Two small libraries, each from one source of ``flake_tpu_torch/csrc/`` and
built at first use into the port's build directory; a failed build raises:

- ``packer.cpp``: the encoder's host library. ``flake_crc_patch`` fills
  the CRC placeholders of the device emission (K3); ``flake_pack_frames``
  and ``flake_stitch`` are the host emission (``pack_backend="host"``),
  which packs whole frames from the analysis tensors; ``flake_crc8``,
  ``flake_crc16`` and ``flake_md5_blocks`` come with it.
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
SRC = CSRC / "packer.cpp"
LIB = _build.BUILD_DIR / "libflake_packer.so"
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
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")


def build() -> str:
    """Build the packer library if it is missing or stale."""
    return _build.build(GXX, [SRC], LIB)


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB))
            lib.flake_pack_frames.argtypes = [
                _i32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p,
                _i32p, _i32p, ctypes.c_int, _u64p, _i32p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _u8p, ctypes.c_int64, _i64p]
            lib.flake_pack_frames.restype = None
            lib.flake_stitch.argtypes = [_u8p, ctypes.c_int, ctypes.c_int64,
                                         _i64p, _i64p, _u8p]
            lib.flake_stitch.restype = None
            lib.flake_crc8.argtypes = [_u8p, ctypes.c_int64]
            lib.flake_crc8.restype = ctypes.c_uint8
            lib.flake_crc16.argtypes = [_u8p, ctypes.c_int64]
            lib.flake_crc16.restype = ctypes.c_uint16
            lib.flake_crc_patch.argtypes = [_u8p, ctypes.c_int64,
                                            ctypes.c_int, _i64p, _i64p,
                                            _i32p]
            lib.flake_crc_patch.restype = ctypes.c_int64
            lib.flake_md5_blocks.argtypes = [_u32p, _u8p, ctypes.c_int64]
            lib.flake_md5_blocks.restype = None
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


def pack_frames(analysis: dict, frame_nums: np.ndarray, *,
                block_size: int, channels: int, bps_code: int,
                sr_code: tuple[int, int], bs_code: tuple[int, int],
                allow_vbs: int, precision: int, ch_code: int,
                max_frame_size: int) -> tuple[bytes, np.ndarray]:
    """Pack a batch of analysed frames into one contiguous byte stream
    (the host emission; ``flake_tpu/native/__init__.py:122-170``).

    ``analysis`` holds host numpy arrays of the analysis dict's keys;
    ``frame_nums`` each frame's header number (frame index, or first
    sample number in VBS streams). Returns (bytes, int64 [F] frame
    lengths). A frame whose tensors are out of range, or that does not
    fit ``max_frame_size + 64`` bytes, raises ``ValueError``."""
    lib = get_lib()
    F = frame_nums.shape[0]

    def a32(name):
        return np.ascontiguousarray(analysis[name], dtype=np.int32)

    residual = a32("residual")
    coefs = a32("coefs")
    rice_k = a32("rice_params")
    parts_stride = rice_k.shape[-1]
    out_stride = max_frame_size + 64
    out = np.empty((F, out_stride), dtype=np.uint8)
    lengths = np.empty(F, dtype=np.int64)

    lib.flake_pack_frames(
        residual, coefs, a32("shift"), a32("obits"), a32("wasted"),
        a32("sf_type"), a32("order"), a32("porder"), a32("method"),
        rice_k, parts_stride,
        np.ascontiguousarray(frame_nums, dtype=np.uint64),
        a32("ch_mode"),
        F, channels, block_size,
        bps_code, sr_code[0], sr_code[1], bs_code[0], bs_code[1],
        allow_vbs, precision, ch_code,
        out.reshape(-1), out_stride, lengths)

    if F and lengths.min() < 0:
        bad = np.flatnonzero(lengths < 0)
        raise ValueError(
            f"native packer rejected {bad.size} frame(s) "
            f"(first at batch index {int(bad[0])}): analysis tensors "
            "out of range or frame exceeded its slot")

    offsets = np.zeros(F, dtype=np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    total = int(offsets[-1] + lengths[-1]) if F else 0
    dest = np.empty(total, dtype=np.uint8)
    lib.flake_stitch(out.reshape(-1), F, out_stride, lengths, offsets,
                     dest)
    return dest.tobytes(), lengths


def crc8(data: bytes) -> int:
    """CRC-8 (poly 0x07, zero seed) of ``data``."""
    buf = np.frombuffer(data, dtype=np.uint8)
    return int(get_lib().flake_crc8(np.ascontiguousarray(buf), buf.size))


def crc16(data: bytes) -> int:
    """CRC-16 (poly 0x8005, zero seed) of ``data``."""
    buf = np.frombuffer(data, dtype=np.uint8)
    return int(get_lib().flake_crc16(np.ascontiguousarray(buf), buf.size))


def md5_blocks(state: np.ndarray, data: bytes) -> None:
    """Compress whole 64-byte blocks of ``data`` into the MD5 state
    ``state`` (uint32 [4], updated in place; RFC 1321 section 3.4)."""
    if state.dtype != np.uint32 or state.shape != (4,) \
            or not state.flags.c_contiguous:
        raise ValueError("md5_blocks: state must be C-contiguous uint32 [4]")
    if len(data) % 64:
        raise ValueError("md5_blocks: data must be whole 64-byte blocks")
    buf = np.frombuffer(data, dtype=np.uint8)
    get_lib().flake_md5_blocks(state, np.ascontiguousarray(buf),
                               buf.size // 64)


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
