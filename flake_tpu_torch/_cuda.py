"""The port's CUDA kernels: nvcc build at first use, bound with ctypes.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` (Hopper), each by
its own nvcc process and all at once, and linked into one shared library
with a plain C interface in the port's build directory. Each entry point
takes its pointers and the CUDA stream as ``ctypes.c_void_p``, launches
on that stream, and returns ``cudaGetLastError()``; :func:`launch`
raises when it is not 0. Nothing is built or loaded at import, so the
CPU tests import every module.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import pathlib
import shutil
import threading

import torch

from flake_tpu_torch import _build

SOURCES = sorted((pathlib.Path(__file__).resolve().parent / "csrc")
                 .glob("*.cu"))
LIB = _build.BUILD_DIR / "libflake_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argument types after the pointers and ints, in order;
# every entry ends with the stream
SIGNATURES = {
    # x, window, out, N, B, max_order
    "flake_autocorr": [_P, _P, _P, _I, _I, _I],
    # x, coefs, shifts, out, N, B, max_order, pmax_static, then the split
    # plan: seg, spp, ppb, blocks, bucket (ops/sweep.py: sweep_plan)
    "flake_sweep_sums": [_P, _P, _P, _P] + [_I] * 9,
    # x, coefs, shifts, out, N, B, max_order, gs_log2
    "flake_sweep_granules": [_P, _P, _P, _P, _I, _I, _I, _I],
    # R1: sums, order, bits, porder, method, params, R, G, n, pmin, pmax,
    # pmax_static, log2(n ^ (n - 1))
    "flake_rice_scan": [_P] * 6 + [_I] * 7,
    # R2: smp, coefs, shift, order, res, fits, bits, porder, method, params,
    # exact, N, taps, coefs' row stride, n, pmin, pmax, pmax_static,
    # log2(n ^ (n - 1)), threads
    "flake_final_pass": [_P] * 11 + [_I] * 9,
    # L: autoc, qcoefs, shifts, refs, N, max_order, precision, est, float64
    "flake_lpc_candidates": [_P] * 4 + [_I] * 5,
    # S: bits, refs, qcoefs, shifts, order, coefs, shift, N, m, method,
    # min_o, max_o, float64 refs
    "flake_select_candidate": [_P] * 7 + [_I] * 6,
    # S without the gather: bits, order, N, m, method, min_o, max_o
    "flake_select_order": [_P, _P] + [_I] * 5,
    # X: smp, obits, order, coefs, N, n, min_o, max_o, taps, pmin, pmax,
    # pmax_static, log2(n ^ (n - 1))
    "flake_fixed_search": [_P] * 4 + [_I] * 9,
    # H: smp, chans, obits, wasted, mode, constant, F, n, C, bps, est
    "flake_frame_head": [_P] * 6 + [_I] * 5,
    # E: sf_type, order, obits, wasted, method, porder, type_code, shift,
    # coefs, rice_params, residual, ch_mode, hdr_bytes, hdr_nbytes, lengths,
    # leading, payload, F, n, C, pmax_static, rp, wide, precision, bps_code
    "flake_slot_layout": [_P] * 17 + [_I] * 8,
    # lengths, leading, payload, words, total_bits, F, M, W, shared
    "flake_merge_words": [_P, _P, _P, _P, _P, _I, _I, _I, _I],
    # w0t, hit, lot, words, F, S, W
    "flake_merge_aligned": [_P, _P, _P, _P, _I, _I, _I],
    # chunk_bits, w0t, hit, lot, words, F, nc, W (zero: csrc/zero_floor.cu;
    # v2 and v3 launch one block a frame)
    **{f"flake_prof_merge_{variant}": [_P, _P, _P, _P, _P, _I, _I, _I]
       for variant in ("static2", "fixedrow", "nowin", "zero", "v2", "v3")},
    # cb2, cb1, main x4, sp2 x4, sp1 x3, words, F, nc2, nc1, W (one kernel,
    # one block a frame)
    **{f"flake_prof_merge_{proto}": [_P] * 14 + [_I] * 4
       for proto in ("v5a", "v5b")},
    # the same with w0 in rows (v5d) or chunks (v5c), then kmax, kmax1 (one
    # block a frame)
    **{f"flake_prof_merge_{proto}": [_P] * 14 + [_I] * 6
       for proto in ("v5d", "v5c")},
    # their zero floors (csrc/zero_floor.cu): the same operands, F, nc2, nc1,
    # W, fb
    **{f"flake_prof_merge_{floor}": [_P] * 14 + [_I] * 5
       for floor in ("zero_fb", "zero_rows")},
    # microseconds (a timing aid, see csrc/prof_merge.cu)
    "flake_spin_us": [_I],
}

_lock = threading.Lock()
_lib = None


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> str:
    """Compile the kernels if the library is missing or stale: one nvcc
    per stale source, all started together, then one link. Returns the
    compilers' report (registers, shared memory, spills per kernel),
    empty when the library was up to date."""
    compile_cmd = [nvcc(), *ARCH, "-std=c++17", "-O3", "-Xcompiler",
                   "-fPIC", "-Xptxas", "-v", "-c"]
    objs = [_build.BUILD_DIR / f"{src.stem}.o" for src in SOURCES]
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        reports = list(pool.map(
            lambda src, obj: _build.build(compile_cmd, [src], obj),
            SOURCES, objs))
    reports.append(_build.build([nvcc(), *ARCH, "-shared"], objs, LIB))
    return "".join(reports)


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIB))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [*args, _P]
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``name`` on ``device``'s current stream. Tensors
    pass as their data pointers, ints as ints. Raises on a refused
    launch."""
    fn = getattr(get_lib(), name)
    c_args = [_P(a.data_ptr()) if isinstance(a, torch.Tensor) else int(a)
              for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*c_args, _P(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def check(t: torch.Tensor, name: str, dtype: torch.dtype,
          shape: tuple, device: torch.device, rows: bool = False) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (what the kernels take). With ``rows``, a 2-D ``t``'s rows
    may lie apart, as in a column slice of a wider table: each row
    contiguous, at a stride of at least its length."""
    dense = t.is_contiguous() or (
        rows and t.dim() == 2 and t.stride(1) == 1
        and t.stride(0) >= t.shape[1])
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != device or not dense:
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if dense else ' (non-contiguous)'}")
