#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Builds the port's CUDA kernels (K1 autocorrelation, K2 and K4 order
sweeps, K3 word merge, K5 pre-aligned word merge, U1, the four merge
variants of the emission-profiling tool, U2, the merge prototypes
``merge_v2`` and ``merge_v3``, U3a/U3b, the combined-node merges
``merge_v5a`` and ``merge_v5b``, and U3c-U3f, their row-layout forms
``merge_v5d`` and ``merge_v5c`` with the zero floors ``merge_zero_rows`` and
``merge_zero_fb``, one kernel with U1's zero variant) and its host
libraries (CRC patcher, decoder helpers) from this checkout, and holds
each kernel
against its plain PyTorch version: K1-K3 on the inputs the first level-8
batch gives them (its sweep's, which the route gives K4, for K2), K4 (and
K1 at 33 lags, K3 on 8192-sample frames) on the
inputs of a level-12 batch of 8192-sample sub-blocks, with K2 timed on
K4's inputs beside it; K5 and U1 on the aligned parts of the profiling
tool's own level-8 batch, K5 also on the first level-5 batch and the
level-12 8192 bucket, where its words must equal K3's. K2 is held against
its plain version on every shape the sweeping levels give the sweeps
(order 8 at level 7, 12 at levels 8 and 10, 32 at level 12; every
sub-block size and the tails). Every kernel's time stands beside its
plain version's, its bound (bytes over the memory rate or operations
over the peak rate of their type outside the tensor cores, whichever is
larger; the sweeps' also at the float64 tensor cores' rate) and, where
one PyTorch call computes the same function, that call's time (for K1 a
grouped float64 ``conv1d``, held against K1's plain version first).
K1-K4, ``merge_v2``, ``merge_v3``, ``merge_v5a``, ``merge_v5b``,
``merge_v5d``, ``merge_v5c`` and the zero floor are also timed beside their
first designs
(``flake_tpu_torch/csrc/yardsticks``, built into a library of their own and
held against the plain versions too): K1-K3 on the level-8 batch, K1 and
K4 on the level-12 8192 bucket, ``merge_v2`` at 1, 4, 8 and 16 frames a
TPU program, ``merge_v3`` at 1, 8 and 16, ``merge_v5a`` and ``merge_v5b``
on ``music`` and ``noise``, ``merge_v5d`` at 1, 8, 16 and 32,
``merge_v5c`` at 1, 4, 8 and 16 and the zero floors at 1, 8, 16 and 32 on
the tools' ``music`` batch (the row-layout merges on ``noise`` too, the
floor also beside its form by bulk asynchronous stores), and K2 on every
order-32 shape of the
level-12 stream, where K4 is timed beside them wherever it can sum the
shape (the table of the K2/K4 route). K3 is timed in both its
instantiations (a frame's words staged in shared memory, or ORed into
device memory, which frames above its shared-memory cap take), K4 beside
the same design on the integer pipes (``csrc/yardsticks/
sweep_granules_int.cu``, held against the plain version too). Rate probes
from the same folder measure the card's 32x32->64-bit and 32-bit integer
multiply-add and float64 FMA rates. ``merge_v3`` is timed beside
``merge_v2`` and K5, ``merge_v5c`` beside ``merge_v5d`` on the same nodes,
``merge_v5a``, ``merge_v5d`` and ``merge_v3`` with a cold L2 (a 64 MiB
buffer written, or read, between calls), ``merge_v5a`` beside the same
merge with its spill sets read by flagged columns (``csrc/yardsticks/
prof_merge3_columns.cu``) and on ``music`` with no, its own and every sp2
chunk flagged, its bounds also at 32-byte sectors, and the row-layout
merges at other block sizes and grids
(``csrc/yardsticks/prof_merge3_rows_alt.cu``). Every kernel's
registers, spills and static shared bytes are printed from ``ptxas -v``
as one JSON line. U2 and
U3 are held against their plain versions bit for bit
on the ``music`` and ``noise`` batches of their tools (512 frames of 4096;
the noise frames are verbatim, in chunks of 68 words, past the first
window of ``merge_v2``) and on a made-up slot table with unary runs of
thousands of bits, where ``merge_v2`` drops and misplaces parts,
``merge_v3`` drops rows and both spill sets of the combined nodes are
flagged; ``merge_v5a``, ``merge_v5b`` (and their first designs and the
flagged-column form), K5 and K3 must give the same words on all three, and K5 is held against its plain version and K3 on the noise
batch too; ``merge_v2`` and ``merge_v3`` are held at every fb they are
timed at.
``merge_v5d`` and ``merge_v5c`` (at every fb they are timed at) must
equal their plain version on all three, K5's and K3's words on the two
batches, where no frame may overflow the static rows, and K5's words on the
frames of the made-up table that do not overflow them (some must); the zero
floors must give ``torch.zeros``. The Schur and Levinson recursions of the EST order method
must give the same float64 bits on the card and on the host.

Three-second windows must give the same bytes through
``Encoder(device="cpu")`` (the plain versions) and
``Encoder(device="cuda")``: 4-7 s of the level-12 stream (steady audio
and noise bursts, reaching both K2 and K4) and 99-102 s of the fixed-block
stream (tones around the full-scale noise second) at levels 5, 7, 3, 2, 1
and 0, and 2 s of each stream at another width (``WIDE_STREAMS``: 24-bit
/ 96 kHz stereo at level 8, 6-channel / 48 kHz 16-bit at level 5, and
8-channel / 96 kHz 24-bit at level 5, whose frames' words exceed K3's
shared-memory cap). Each fixed-block stream (levels 8, 5, 7, 3, 2, 1, 0),
each of those and the level-12 and level-11 streams is encoded once with
K1-K4 recorded, and every call they got, each batch and the partial last
block, is held against the plain version again (K1 at 13, 9, 7 and 33
lags, K2 at orders 12, 8 and 32, K3 on 1152- to 8192-sample frames and in
both instantiations, K4 on every bucket it sums). Then the main paths run, each with the launch counts set to 0 just before it
and read just after: the profiling tool
(``flake_tpu_torch.util.prof_merge.main``; K1, K3, K4, K5 and U1 must
launch),
the merge-prototype tools (``prof_merge2.main`` and ``main_v3``: K5 and
``merge_v2``, ``merge_v3``; ``prof_merge3.main``: K5, ``merge_v5a``,
``merge_v5b``; ``prof_merge3.main_v5d``: K5, ``merge_v5d``,
``merge_zero_rows``; ``prof_merge3.main_v5c``: K5, ``merge_v5c``,
``merge_zero_fb``) and, through ``Encoder.encode_stream``, cold and warm,
180 s of deterministic 16-bit / 44.1 kHz stereo at level 8 (K1-K4 must
launch: K2 for the partial last block) and at level 5 (EST: K1 and K3
must launch, K2 and K4 must not), 60 s of it at level 7 (K1-K4), 30 s at
levels 3 (K1, K3) and 2, 1, 0 (block 1152, K3 only),
a second deterministic stream with level jumps, bursts and silences
at levels 12 and 11, whose variable block sizes must split into at least
four sub-block sizes, 4096 and 8192 among them (K1-K4 must launch), and
the three streams at other widths (30 s, 30 s and 4 s; K1 and K3, and K4
at level 8; the 8-channel stream must launch K3's device-memory
instantiation, the others its shared one). Every stream is decoded with
the port's independent decoder (``flake_tpu_torch.decoder``), MD5
included, and its STREAMINFO must give its channels, bits and rate.

    python3 chip_smoke.py

Needs one CUDA device of compute capability 9.0; fails without one. Any
failed phase exits non-zero before the final line, which is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 20260116
SAMPLE_RATE = 44100
SECONDS = 180
BLOCK = 4096
BATCH = 512
VBS_SECONDS = 60        # the level-12 and level-11 stream
PARITY_WINDOW = (4, 7)  # seconds of it through the CPU and the CUDA encoder
FIXED_PARITY_WINDOW = (99, 102)  # of the fixed-block stream, levels 5 and 7
# seconds of the fixed-block stream per level below 8 (level 8 takes it all)
LEVEL_SECONDS = {5: 180, 7: 60, 3: 30, 2: 30, 1: 30, 0: 30}
SCENE = 10              # seconds per scene of that stream
# streams at other widths: label -> (channels, bits per sample, sample
# rate, level, seconds). The 6-channel frames take 49,664 bytes of words,
# above the 48 KiB that needs K3's shared-memory opt-in; the 8-channel
# 24-bit frames take 98,816, above K3's shared-memory cap, so they take
# its other instantiation
WIDE_STREAMS = {"24-bit/96 kHz stereo": (2, 24, 96000, 8, 30),
                "6-channel/48 kHz 16-bit": (6, 16, 48000, 5, 30),
                "8-channel/96 kHz 24-bit": (8, 24, 96000, 5, 4)}
WIDE_PARITY_SECONDS = 2  # of each, through the CPU and the CUDA encoder
K1_REL_TOL = 5e-11      # tests/test_pallas_autocorr.py:55
# the frames a TPU program takes at which the merge prototypes are held and
# timed: those their tools time, and 1 and 8 (merge_v5d) and 1 (merge_v5c)
# besides
U2_FBS = {"v2": (1, 4, 8, 16), "v3": (1, 8, 16)}
U3_FBS = {"merge_v5d": (1, 8, 16, 32), "merge_v5c": (1, 4, 8, 16)}
# Published peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM3;
# 67 TFLOP/s float32 outside the tensor cores, float64 at half of it. An SM
# has half as many int32 lanes as float32 lanes, so int32 operations peak
# at half the float32 rate too. The rate probes (csrc/yardsticks/rates.cu,
# printed by every run) measure both that the sweeps and K1 are made of.
# The float64 tensor cores (DMMA) peak at 67 TFLOP/s: the sweeps' bounds
# are also given at that rate (``bound_ms_fp64_tensor``), which no kernel
# of the port uses yet.
HBM_BYTES_PER_MS = 3.35e9
FP64_OPS_PER_MS = 33.5e9
FP64_TENSOR_OPS_PER_MS = 67e9
INT32_OPS_PER_MS = 33.5e9


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def make_stream(seed: int) -> "np.ndarray":
    """180 s of int32 [n, 2] 16-bit stereo: two different low tone pairs
    (every lag up to 12 stays well correlated), light noise, a silent
    second at 60 s (CONSTANT subframes) and a second of full-scale binary
    noise at 100 s (verbatim frames). The first batch (47.5 s) is
    tonal."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = SECONDS * SAMPLE_RATE
    t = np.arange(n) / SAMPLE_RATE
    env = 0.6 + 0.4 * np.sin(2 * np.pi * t / 23.0)
    left = env * (9000 * np.sin(2 * np.pi * 220 * t)
                  + 4000 * np.sin(2 * np.pi * 331 * t))
    right = env * (8000 * np.sin(2 * np.pi * 277 * t + 0.3)
                   + 3000 * np.sin(2 * np.pi * 440 * t))
    pcm = np.stack([left, right], axis=1) + rng.normal(0, 150, (n, 2))
    pcm[60 * SAMPLE_RATE:61 * SAMPLE_RATE] = 0
    burst = slice(100 * SAMPLE_RATE, 101 * SAMPLE_RATE)
    pcm[burst] = rng.choice([-32768, 32767], (SAMPLE_RATE, 2))
    return np.clip(np.rint(pcm), -32768, 32767).astype(np.int32)


def make_vbs_stream(seed: int, seconds: int) -> "np.ndarray":
    """int32 [n, 2] 16-bit stereo in 10 s scenes for the variable block
    sizes: two tone pairs under a slow envelope and light noise, whose
    level jumps between 1 and 0.3 every 4096 samples for the first 2 s of
    a scene (4096-sample sub-blocks), six noise bursts of 300-3000
    samples at 5-7 s (short sub-blocks) and silence at 9-10 s (CONSTANT
    subframes); the rest is steady (8192-sample blocks, unsplit)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = seconds * SAMPLE_RATE
    scene = SCENE * SAMPLE_RATE
    t = np.arange(n) / SAMPLE_RATE
    env = 0.6 + 0.4 * np.sin(2 * np.pi * t / 17.0)
    left = env * (7000 * np.sin(2 * np.pi * 196 * t)
                  + 3000 * np.sin(2 * np.pi * 392.5 * t))
    right = env * (6000 * np.sin(2 * np.pi * 247 * t + 0.5)
                   + 2500 * np.sin(2 * np.pi * 523 * t))
    pcm = np.stack([left, right], axis=1) + rng.normal(0, 120, (n, 2))
    idx = np.arange(n)
    pcm[(idx % scene < 2 * SAMPLE_RATE) & ((idx // 4096) % 2 == 1)] *= 0.3
    for s0 in range(0, n, scene):
        lo = s0 + 5 * SAMPLE_RATE
        for b in rng.integers(lo, min(lo + 2 * SAMPLE_RATE, n), 6):
            burst = pcm[b:b + int(rng.integers(300, 3000))]
            burst += rng.normal(0, 6000, burst.shape)
        pcm[s0 + 9 * SAMPLE_RATE:s0 + scene] = 0
    return np.clip(np.rint(pcm), -32768, 32767).astype(np.int32)


def make_wide_stream(seed: int, channels: int, bps: int, rate: int,
                     seconds: int) -> "np.ndarray":
    """int32 [n, channels] at ``bps`` bits: a tone pair a channel under a
    slow envelope with light noise, a silent half second at a quarter of
    the stream (CONSTANT subframes) and a half second of full-scale binary
    noise at half of it (verbatim frames)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = seconds * rate
    t = np.arange(n) / rate
    top = (1 << (bps - 1)) - 1
    env = 0.6 + 0.4 * np.sin(2 * np.pi * t / 13.0)
    pcm = np.empty((n, channels))
    for ch in range(channels):
        f0 = 110.0 * (1 + 0.37 * ch)
        pcm[:, ch] = env * top * (0.4 * np.sin(2 * np.pi * f0 * t + ch)
                                  + 0.15 * np.sin(2 * np.pi * 2.5 * f0 * t))
    pcm += rng.normal(0, top / 200, pcm.shape)
    half = rate // 2
    pcm[n // 4:n // 4 + half] = 0
    pcm[n // 2:n // 2 + half] = rng.choice([-top - 1, top],
                                           (min(half, n - n // 2), channels))
    return np.clip(np.rint(pcm), -top - 1, top).astype(np.int32)


def make_slot_table(seed: int, frames: int, slots: int):
    """A made-up slot table, int32 numpy [frames, slots] x 3 (lengths,
    leading zero bits, payload) and the word rows that hold its longest
    frame: fields of 0-32 payload bits, one in a hundred behind a unary run
    of up to 9,000 zero bits. Chunks of 128 slots then pass 256 words and
    four word rows, and neighbours do not fit a 64-bit node."""
    import numpy as np

    rng = np.random.default_rng(seed)
    paylen = rng.integers(0, 33, (frames, slots))
    leading = np.where(rng.random((frames, slots)) < 0.01,
                       rng.integers(1, 9000, (frames, slots)), 0)
    leading[paylen == 0] = 0
    payload = rng.integers(0, 1 << 32, (frames, slots)) & ((1 << paylen) - 1)
    lengths = paylen + leading
    word_rows = int(-(-lengths.sum(-1).max() // 4096)) + 1
    return (lengths.astype(np.int32), leading.astype(np.int32),
            payload.astype(np.uint32).view(np.int32)), word_rows


def bound(bytes_moved: float, ops: float, ops_per_ms: float):
    """The least ms the card could take for this much work, and which of
    bytes or operations sets it."""
    by_bytes = bytes_moved / HBM_BYTES_PER_MS
    by_ops = ops / ops_per_ms
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def build_yardsticks():
    """Build ``flake_tpu_torch/csrc/yardsticks`` (the first designs of K1-K4,
    of ``merge_v2``, ``merge_v3``, ``merge_v5a``, ``merge_v5b``,
    ``merge_v5d``, ``merge_v5c`` and of the zero floor, the combined-node
    merge with its spill sets read by flagged columns, the row-layout merges
    at other geometries, K4's design on the integer pipes, the zero floor by
    bulk asynchronous stores and the card's rate probes) into a library of
    their own. Returns (the compiler's report, a dict of functions):
    ``k1_before`` to ``k4_before``, ``v2_before``, ``v3_before``,
    ``v5a_before``, ``v5b_before``, ``v5d_before`` and ``v5c_before`` take
    the wrappers' arguments and launch the first designs (K3's zeroes its
    words first, as its wrapper did), ``v5_columns`` takes ``merge_v5a``'s
    and reads the spill sets by columns, ``rows_form(dual, threads, stage_spill,
    blocks, operands, word_rows)`` launches ``merge_v5d`` (``dual`` 0) or
    ``merge_v5c`` (1) in another form, ``zero_before(F, word_rows, fb)`` and
    ``zero_bulk(F, word_rows)`` write the zero floor, ``k4_int`` is K4's
    design on the integer pipes, ``launch_floor(blocks, threads)``
    launches an empty kernel; ``mad_wide``, ``imad`` and ``dfma`` measure
    the card's rate of each operation, in operations a ms."""
    import ctypes

    import torch
    from flake_tpu_torch import _build, _cuda

    srcs = sorted((ROOT / "flake_tpu_torch" / "csrc" / "yardsticks")
                  .glob("*.cu"))
    lib_path = _build.BUILD_DIR / "libflake_yardsticks.so"
    report = _build.build([_cuda.nvcc(), *_cuda.ARCH, "-std=c++17", "-O3",
                           "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                           "-shared"], srcs, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.flake_autocorr_v1.argtypes = [P, P, P, I, I, I, P]
    lib.flake_sweep_sums_v1.argtypes = [P, P, P, P, I, I, I, I, P]
    lib.flake_merge_words_v1.argtypes = [P, P, P, P, P, I, I, I, P]
    lib.flake_sweep_granules_v1.argtypes = [P, P, P, P, I, I, I, I, P]
    lib.flake_sweep_granules_int.argtypes = [P, P, P, P, I, I, I, I, P]
    lib.flake_rate_mad_wide.argtypes = [P, I, I, I, P]
    lib.flake_rate_imad.argtypes = [P, I, I, I, P]
    lib.flake_rate_dfma.argtypes = [P, I, I, I, P]
    lib.flake_prof_merge_v2_v1.argtypes = [P] * 5 + [I] * 4 + [P]
    lib.flake_prof_merge_v3_v1.argtypes = [P] * 5 + [I] * 4 + [P]
    for v5 in ("v5a_v1", "v5b_v1", "v5_columns"):
        getattr(lib, f"flake_prof_merge_{v5}").argtypes = [P] * 14 + [I] * 4 \
            + [P]
    lib.flake_prof_merge_v5d_v1.argtypes = [P] * 14 + [I] * 7 + [P]
    lib.flake_prof_merge_v5c_v1.argtypes = [P] * 14 + [I] * 7 + [P]
    lib.flake_prof_merge_rows_alt.argtypes = [I] * 4 + [P] * 14 + [I] * 6 \
        + [P]
    lib.flake_zero_floor_v1.argtypes = [P, I, I, I, P]
    lib.flake_zero_floor_bulk.argtypes = [P, I, I, P]
    lib.flake_launch_floor.argtypes = [I, I, P]

    def call(fn, *args):
        rc = fn(*[P(a.data_ptr()) if isinstance(a, torch.Tensor) else a
                  for a in args],
                P(torch.cuda.current_stream().cuda_stream))
        if rc:
            raise RuntimeError(f"{fn.__name__}: CUDA error {rc}")

    def k1_before(x, window, max_order):
        out = torch.empty((x.shape[0], max_order + 1), dtype=torch.float64,
                          device=x.device)
        call(lib.flake_autocorr_v1, x, window, out, *x.shape, max_order)
        return out

    def k2_before(x, coefs, shifts, max_order, pmax_static):
        out = torch.empty((x.shape[0], max_order, 1 << pmax_static),
                          dtype=torch.int64, device=x.device)
        call(lib.flake_sweep_sums_v1, x, coefs, shifts, out, *x.shape,
             max_order, pmax_static)
        return out

    def k3_before(lengths, leading, payload, word_rows):
        F, M = lengths.shape
        words = torch.zeros((F, word_rows, 128), dtype=torch.int32,
                            device=lengths.device)
        total_bits = torch.empty((F,), dtype=torch.int32,
                                 device=lengths.device)
        call(lib.flake_merge_words_v1, lengths, leading, payload, words,
             total_bits, F, M, word_rows * 128)
        return words, total_bits

    def k4_on(fn, x, coefs, shifts, max_order, pmax_static):
        from flake_tpu_torch.ops.sweep import granule_size

        gs = granule_size(x.shape[1], pmax_static)
        out = torch.empty((x.shape[0], max_order, x.shape[1] // gs),
                          dtype=torch.int64, device=x.device)
        call(fn, x, coefs, shifts, out, *x.shape, max_order,
             gs.bit_length() - 1)
        return out

    def u2_before(fn, w0t, hit, lot, chunk_bits, word_rows, fb):
        F, _, nc = w0t.shape
        words = torch.empty((F, word_rows, 128), dtype=torch.int32,
                            device=w0t.device)
        call(fn, chunk_bits, w0t, hit, lot, words, F, nc, word_rows * 128,
             fb)
        return words

    def v5_on(fn, v5, word_rows):
        main, sp2, sp1, cb2, cb1 = v5
        words = torch.empty((main[0].shape[0], word_rows, 128),
                            dtype=torch.int32, device=main[0].device)
        call(fn, cb2, cb1, *main, *sp2, *sp1, words, main[0].shape[0],
             main[0].shape[-1], sp1[0].shape[-1], word_rows * 128)
        return words

    def rows_operands(kin):
        """The pointers of a row-layout merge, in the entry points' order."""
        mainw, mainr, sp2w, sp2r, sp1w, sp1r, cb2, cb1 = kin
        return (cb2, cb1, mainw, *mainr, sp2w, *sp2r, sp1w, *sp1r)

    def rows_shape(kin, word_rows):
        F, nc2, _ = kin[1][0].shape
        return (torch.empty((F, word_rows, 128), dtype=torch.int32,
                            device=kin[0].device),
                F, nc2, kin[5][0].shape[1], word_rows * 128)

    def rows_before(fn, kin, word_rows, fb, kmax=4, kmax1=3):
        words, *dims = rows_shape(kin, word_rows)
        call(fn, *rows_operands(kin), words, *dims, fb, kmax, kmax1)
        return words

    def rows_form(dual, threads, stage_spill, blocks, kin, word_rows):
        words, *dims = rows_shape(kin, word_rows)
        call(lib.flake_prof_merge_rows_alt, dual, threads, stage_spill,
             blocks, *rows_operands(kin), words, *dims, 4, 3)
        return words

    def zero_floor(fn, F, word_rows, *fb):
        words = torch.empty((F, word_rows, 128), dtype=torch.int32,
                            device="cuda")
        call(fn, words, F, word_rows * 128, *fb)
        return words

    def rate(fn, dtype):
        """Operations a ms of ``fn`` on 8 blocks of 256 threads an SM."""
        blocks, threads, iters = 8 * 132, 256, 256
        out = torch.empty(blocks * threads, dtype=dtype, device="cuda")
        ms, = time_turns(lambda: call(fn, out, blocks, threads, iters))
        return blocks * threads * iters * 8 * 16 / ms

    return report, {
        "k1_before": k1_before, "k2_before": k2_before,
        "k3_before": k3_before,
        "k4_before": lambda *a: k4_on(lib.flake_sweep_granules_v1, *a),
        "k4_int": lambda *a: k4_on(lib.flake_sweep_granules_int, *a),
        "v2_before": lambda *a: u2_before(lib.flake_prof_merge_v2_v1, *a),
        "v3_before": lambda *a: u2_before(lib.flake_prof_merge_v3_v1, *a),
        "v5a_before": lambda *a: v5_on(lib.flake_prof_merge_v5a_v1, *a),
        "v5b_before": lambda *a: v5_on(lib.flake_prof_merge_v5b_v1, *a),
        "v5_columns": lambda *a: v5_on(lib.flake_prof_merge_v5_columns, *a),
        "v5d_before": lambda *a: rows_before(lib.flake_prof_merge_v5d_v1, *a),
        "v5c_before": lambda *a: rows_before(lib.flake_prof_merge_v5c_v1, *a),
        "rows_form": rows_form,
        "zero_before": lambda F, wr, fb: zero_floor(lib.flake_zero_floor_v1,
                                                    F, wr, fb),
        "zero_bulk": lambda F, wr: zero_floor(lib.flake_zero_floor_bulk, F,
                                              wr),
        "launch_floor": lambda blocks, threads: call(lib.flake_launch_floor,
                                                     blocks, threads),
        "mad_wide": lambda: rate(lib.flake_rate_mad_wide, torch.int64),
        "imad": lambda: rate(lib.flake_rate_imad, torch.int32),
        "dfma": lambda: rate(lib.flake_rate_dfma, torch.float64)}


def ptxas_table(report: str) -> dict:
    """Each kernel's registers, spill bytes and static shared bytes from
    ``ptxas -v``'s report, by demangled name (template arguments kept,
    parameters dropped)."""
    import re

    table, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            table[name] = {"registers": None, "spill_stores": 0,
                           "spill_loads": 0, "smem": 0}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            table[name]["spill_stores"], table[name]["spill_loads"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            table[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            table[name]["smem"] = int(m.group(1)) if m else 0
    names = list(table)
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        plain = names
    if len(plain) != len(names):
        plain = names
    out = {}
    for n, p in zip(names, plain):
        # a kernel in an anonymous namespace carries its file's name
        m = re.search(r"GLOBAL__N__\w+?_\d+_(\w+?)_cu_", n)
        p = p.replace("(anonymous namespace)::", "").split("(")[0]
        out[f"{m.group(1) + '.cu: ' if m else ''}"
            f"{p.removeprefix('void ')}"] = table[n]
    return out


def time_turns(*fns, loop=(), reps: int = 20):
    """Mean ms per call of each function between two CUDA events, in turns
    (first to last, then last to first) after one warm-up call each. A
    function in ``loop`` (a plain version, a program of many launches) is
    timed in a plain loop, as its caller sees it; every other is one
    short kernel and is timed back to back, enqueued behind a spinning
    kernel, so that the card's time is read and not the host's launch
    rate (``flake_tpu_torch.util.prof_merge.device_ms``)."""
    import torch
    from flake_tpu_torch.util.prof_merge import device_ms

    dev = torch.device("cuda", 0)
    for fn in fns:
        fn()
    forth = [device_ms(fn, dev, reps, fn not in loop) for fn in fns]
    back = [device_ms(fn, dev, reps, fn not in loop)
            for fn in reversed(fns)][::-1]
    return [(f + b) / 2 for f, b in zip(forth, back)]


def main() -> None:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"missing dependency: {e}")
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not (ROOT / "flake_tpu_torch").is_dir():
        fail(f"no flake_tpu_torch package beside {__file__}")
    sys.path.insert(0, str(ROOT))

    # -- 1. the card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    print(card, flush=True)
    cap = torch.cuda.get_device_capability(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"capability {cap}", flush=True)
    if cap != (9, 0):
        fail(f"need compute capability (9, 0), got {cap}")
    dev = torch.device("cuda", 0)

    from flake_tpu_torch import _cuda, decoder, native
    from flake_tpu_torch import params as P
    from flake_tpu_torch.encoder import Encoder, vbs_layout, vbs_section_sums
    from flake_tpu_torch.ops import autocorr as k1_mod
    from flake_tpu_torch.ops import bitmerge as k3_mod
    from flake_tpu_torch.ops import bitpack, frame, lpc
    from flake_tpu_torch.ops import sweep as sweep_mod
    from flake_tpu_torch.util import prof_merge as tool
    from flake_tpu_torch.util import prof_merge2 as tool2
    from flake_tpu_torch.util import prof_merge3 as tool3

    if "jax" in sys.modules:
        fail("importing flake_tpu_torch imported jax")

    # -- 2. builds ----------------------------------------------------------
    t0 = time.perf_counter()
    report = _cuda.build()
    print(f"build kernels {[str(s.relative_to(ROOT)) for s in _cuda.SOURCES]}"
          f": {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = {"package": ptxas_table(report)}
    t0 = time.perf_counter()
    report, yard = build_yardsticks()
    ptxas["yardsticks"] = ptxas_table(report)
    print("build the yardsticks: K1's to K4's, merge_v2's, merge_v3's, "
          "merge_v5a's, merge_v5b's, merge_v5d's, merge_v5c's and the zero "
          "floor's first designs, the combined-node merge by flagged columns, "
          "the row-layout merges at other geometries, K4 on the integer pipes, "
          "the zero floor by bulk asynchronous stores, the rate probes and "
          "an empty kernel (flake_tpu_torch/csrc/yardsticks): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # registers, spill bytes and static shared bytes of every kernel
    print(json.dumps({"ptxas": ptxas}), flush=True)
    rates = {"mad_wide_per_ms": yard["mad_wide"](),
             "imad_per_ms": yard["imad"](),
             "dfma_per_ms": yard["dfma"]()}
    print(f"rates on {card}: {rates['mad_wide_per_ms']:.4g} 32x32->64-bit "
          f"integer multiply-adds a ms, {rates['imad_per_ms']:.4g} 32-bit "
          f"ones (the int32 bound assumes {INT32_OPS_PER_MS / 2:.4g}), "
          f"{rates['dfma_per_ms']:.4g} float64 FMAs a ms (the sweeps' bound "
          f"assumes {FP64_OPS_PER_MS / 2:.4g})", flush=True)
    t0 = time.perf_counter()
    native.build()
    native.get_verifier()
    print(f"build crc_patch.cpp and verifier.cpp: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def stream_config(level):
        return P.StreamConfig(channels=2, sample_rate=SAMPLE_RATE,
                              bits_per_sample=16,
                              params=P.set_defaults(level))

    def header_bytes(nums, block_size, allow_vbs):
        return bitpack.frame_header_bytes(
            nums, bs_code=P.blocksize_code(block_size),
            sr_code=P.samplerate_code(SAMPLE_RATE), allow_vbs=allow_vbs)

    def capture(hooks, run):
        """Run ``run()`` with each (module, name) of ``hooks`` wrapped to
        record the arguments of its calls: name -> list, in call order."""
        got = {}
        originals = [(mod, name, getattr(mod, name)) for mod, name in hooks]

        def wrap(name, orig):
            def rec(*args):
                got.setdefault(name, []).append(args)
                return orig(*args)
            return rec

        for mod, name, orig in originals:
            setattr(mod, name, wrap(name, orig))
        try:
            run()
            torch.cuda.synchronize()
        finally:
            for mod, name, orig in originals:
                setattr(mod, name, orig)
        return got

    def analyze_and_pack(frames, fcfg, nums, allow_vbs):
        hb, hnb = header_bytes(nums, fcfg.block_size, allow_vbs)
        analysis = frame.analyze_frames(frames, fcfg,
                                        torch.from_numpy(hnb * 8).to(dev))
        bitpack.pack_frames_device(analysis, torch.from_numpy(hb).to(dev),
                                   torch.from_numpy(hnb).to(dev), fcfg)
        return analysis

    # -- 3. kernel phases on the first level-8 batch's inputs ---------------
    pcm = make_stream(SEED)
    n_full = pcm.shape[0] // BLOCK
    print(f"level-8 stream: {pcm.shape[0]} samples x 2 ch = {n_full} full "
          f"frames + {pcm.shape[0] - n_full * BLOCK}-sample tail", flush=True)
    cfg8 = stream_config(8)
    fcfg8 = frame.FrameConfig.from_params(cfg8.params, 2, 16)
    cap8 = capture(
        [(frame, "autocorr"), (frame, "sweep_granules"),
         (bitpack, "merge_words")],
        lambda: analyze_and_pack(
            torch.from_numpy(pcm[:BATCH * BLOCK].reshape(BATCH, BLOCK, 2))
            .to(dev), fcfg8, np.arange(BATCH, dtype=np.int64), 0))
    x, window, max_o = cap8["autocorr"][0]
    # the batch's sweep goes to K4; K2 takes the same arguments and is held
    # and timed on them, as on the shapes it keeps
    sx, scoefs, sshifts, s_mo, s_pmax = cap8["sweep_granules"][0]
    ml, mlead, mpay, mwr = cap8["merge_words"][0]
    print(f"K1 inputs x {tuple(x.shape)}, max_order {max_o}; K2 inputs "
          f"coefs {tuple(scoefs.shape)}, pmax_static {s_pmax}; K3 inputs "
          f"slots {tuple(ml.shape)}, word_rows {mwr}", flush=True)

    kernels = []
    rel_err = {}

    def check(name, kern, plain, compare):
        out_k = kern()
        out_p = plain()
        torch.cuda.synchronize()
        err, ok, detail = compare(name, out_k, out_p)
        if not ok:
            fail(f"{name} disagrees with its plain version ({detail})")
        return err, detail

    def phase(name, route_src, replaces, kern, plain, compare, reads, ops,
              ops_per_ms, library=None, plain_is_one_kernel=False,
              read_bytes=None, before=None):
        """Hold one kernel against its plain version, time both (and the
        library call, where there is one, and the kernel's first design,
        ``before``, held against the plain version too) in turns, and
        work out its bound: ``reads`` are the tensors the function must
        read, each once, its outputs are written once, ``ops`` the
        operations it does on these inputs at ``ops_per_ms`` peak;
        ``read_bytes`` stands in for the size of ``reads`` where the data
        decides how much of them is needed. The kernel, the first design
        and the library call are timed back to back, the plain version in
        a plain loop unless it is one kernel too."""
        if before is not None:
            check(name, before, plain, compare)
        err, detail = check(name, kern, plain, compare)
        out = kern()
        moved = (nbytes(*reads) if read_bytes is None else read_bytes) \
            + nbytes(*(out if isinstance(out, tuple) else (out,)))
        bound_ms, bound_by = bound(moved, ops, ops_per_ms)
        fns = (plain, kern, *(f for f in (library, before) if f))
        plain_ms, ms, *rest = time_turns(
            *fns, loop=() if plain_is_one_kernel else (plain,))
        library_ms = rest.pop(0) if library else None
        ms_before = rest.pop(0) if before else None
        timed = {"ms": "back_to_back", "plain_ms": "back_to_back"
                 if plain_is_one_kernel else "loop"}
        print(f"{name}: kernel {ms:.4f} ms"
              f"{'' if before is None else f' (first design {ms_before:.4f} ms)'}"
              f", plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} ({moved / 1e6:.1f} MB, "
              f"{ops / 1e9:.3f} G operations), library call "
              f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, "
              f"timed {timed}, {detail} -> ok", flush=True)
        kernels.append({"name": name, "route": "cuda", "source": route_src,
                        "replaces": replaces, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms,
                        "timed": timed})
        if before is not None:
            kernels[-1]["ms_before"] = ms_before

    def at_every_fb(name, fbs, kern_at, before_at, plain, prefix=""):
        """Hold a kernel and its first design against the plain version's
        ``plain`` words at every ``fb`` of ``fbs``, and time both in turns
        at each: ``ms_by_fb`` and ``ms_before_by_fb`` of the kernel's last
        entry, after ``prefix`` (for another batch than the phase's)."""
        entry = kernels[-1]
        by_fb, before_by_fb = f"{prefix}ms_by_fb", f"{prefix}ms_before_by_fb"
        entry[by_fb], entry[before_by_fb] = {}, {}
        for fb in fbs:
            for label, fn in (("the kernel", kern_at),
                              ("the first design", before_at)):
                got = fn(fb)
                torch.cuda.synchronize()
                if not torch.equal(got, plain):
                    fail(f"{name}: {label} at fb {fb} disagrees with the "
                         "plain version")
            entry[by_fb][fb], entry[before_by_fb][fb] = time_turns(
                lambda: kern_at(fb), lambda: before_at(fb))
        print(f"{name} at fb {list(fbs)}, each bit-exact against the plain "
              f"version: kernel "
              f"{[round(v, 5) for v in entry[by_fb].values()]} ms, "
              f"first design "
              f"{[round(v, 5) for v in entry[before_by_fb].values()]} "
              "ms", flush=True)

    # a 64 MiB buffer, above the card's 50 MB L2: written (or read) between
    # two calls, it leaves none of their operands in the cache
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def cold_ms(fn):
        """``fn``'s ms with a cold L2: the flush and ``fn`` back to back,
        less the flush alone, in turns; by a flush that writes the buffer
        and by one that reads it (which leaves no dirty line to write
        back)."""
        def write():
            flush_buf.fill_(1)

        def read():
            flush_buf.sum()

        w, wk, r, rk = time_turns(write, lambda: (write(), fn()), read,
                                  lambda: (read(), fn()))
        return wk - w, rk - r

    def k1_library_on(x, window, max_order):
        """K1's library yardstick: one grouped float64 ``conv1d`` gives
        every lag of every stream. The window multiply and the padding are
        made here, outside the timed call; the caller adds the +2.0 bias
        outside it too."""
        d = x.to(torch.float64) * window
        padded = torch.nn.functional.pad(d, (0, max_order))[None]
        taps = d[:, None]

        def run():
            return torch.nn.functional.conv1d(padded, taps,
                                              groups=d.shape[0])[0]
        return run

    def check_k1_library(label, run, want):
        _, ok, detail = cmp_rel(f"autocorr library {label}", run() + 2.0,
                                want)
        print(f"K1's library call (grouped float64 conv1d) on {label}: "
              f"{detail}", flush=True)
        if not ok:
            fail(f"the grouped conv1d does not give K1's lags on {label}")

    def sweep_ops(sx, order):
        """Operations of an order sweep: one multiply-add per sample,
        candidate order and tap, counted as one float64 FMA (two float64
        operations): every product and partial sum of the sweep is an
        integer below 2^51 in magnitude, so an FMA on the FP64 pipe does
        the work exactly (K4 runs so; a 32x32->64-bit integer multiply-add
        runs at less than half the FMA rate, as the rate probes show). The
        bound counts them at the FP64 rate outside the tensor cores. It is
        not the least time the card could take: the float64 tensor cores
        run twice that rate and would compute the same integer products
        exactly (``bound_ms_fp64_tensor``)."""
        return 2 * sx.numel() * order * (order + 1) // 2

    def tensor_bound(moved, ops):
        """A sweep's bound at the float64 tensor cores' rate: ``moved``
        bytes, ``ops`` operations."""
        return bound(moved, ops, FP64_TENSOR_OPS_PER_MS)[0]

    def cmp_rel(name, a, b):
        abs_err = (a - b).abs()
        rel = (abs_err / b.abs().clamp_min(1e-300)).max().item()
        rel_err[name] = rel
        return abs_err.max().item(), rel < K1_REL_TOL, \
            f"max rel err {rel:.3e} (tolerance {K1_REL_TOL:g})"

    def cmp_exact(name, a, b):
        if isinstance(a, tuple):
            same = all(torch.equal(u, v) for u, v in zip(a, b))
            err = max((u.to(torch.int64) - v.to(torch.int64)).abs().max()
                      .item() for u, v in zip(a, b))
        else:
            same = torch.equal(a, b)
            err = (a - b).abs().max().item()
        return float(err), same, f"bit-exact {same}"

    k1_library = k1_library_on(x, window, max_o)
    check_k1_library("the level-8 batch", k1_library,
                     lpc.autocorr(x, max_o, window))
    phase("autocorr", "flake_tpu_torch/csrc/autocorr.cu",
          "flake_tpu/ops/pallas_autocorr.py:158",
          lambda: k1_mod.autocorr(x, window, max_o),
          lambda: lpc.autocorr(x, max_o, window), cmp_rel,
          # a window multiply per sample, a float64 multiply-add per sample
          # and lag
          (x, window), x.numel() * (1 + 2 * (max_o + 1)), FP64_OPS_PER_MS,
          library=k1_library,
          before=lambda: yard["k1_before"](x, window, max_o))
    kernels[-1]["max_rel_err"] = rel_err["autocorr"]
    kernels[-1]["tolerance"] = f"{K1_REL_TOL:g} relative per element"
    phase("sweep_sums", "flake_tpu_torch/csrc/sweep.cu",
          "flake_tpu/ops/pallas_sweep3.py:124",
          lambda: sweep_mod.sweep_sums(sx, scoefs, sshifts, s_mo, s_pmax),
          lambda: sweep_mod.sweep_sums_plain(sx, scoefs, sshifts, s_mo,
                                          s_pmax), cmp_exact,
          (sx, scoefs, sshifts), sweep_ops(sx, s_mo), FP64_OPS_PER_MS,
          before=lambda: yard["k2_before"](sx, scoefs, sshifts, s_mo, s_pmax))
    kernels[-1]["bound_ms_fp64_tensor"] = tensor_bound(
        nbytes(sx, scoefs, sshifts) + sx.shape[0] * s_mo * (1 << s_pmax) * 8,
        sweep_ops(sx, s_mo))
    # K4 on the same order-12 inputs, for the K2/K4 route
    folded = sweep_mod.sweep_granules(sx, scoefs, sshifts, s_mo, s_pmax) \
        .reshape(sx.shape[0], s_mo, 1 << s_pmax, -1).sum(-1)
    if not torch.equal(folded, sweep_mod.sweep_sums(sx, scoefs, sshifts,
                                                    s_mo, s_pmax)):
        fail("K4's granules, folded, differ from K2's sums at level 8")
    k2_ms, k4_ms = time_turns(
        lambda: sweep_mod.sweep_sums(sx, scoefs, sshifts, s_mo, s_pmax),
        lambda: sweep_mod.sweep_granules(sx, scoefs, sshifts, s_mo, s_pmax))
    kernels[-1]["k4_ms_same_inputs"] = k4_ms
    print(f"info: on K2's level-8 inputs K2 {k2_ms:.4f} ms, K4 {k4_ms:.4f} ms"
          " (same sums folded)", flush=True)
    phase("merge_words", "flake_tpu_torch/csrc/bitmerge.cu",
          "flake_tpu/ops/pallas_bitmerge.py:173",
          lambda: k3_mod.merge_words(ml, mlead, mpay, mwr),
          lambda: k3_mod.merge_words_plain(ml, mlead, mpay, mwr), cmp_exact,
          # about 16 int32 operations per slot: the scan, the shifts and
          # masks of its two word parts, two atomics
          (ml, mlead, mpay), 16 * ml.numel(), INT32_OPS_PER_MS,
          before=lambda: yard["k3_before"](ml, mlead, mpay, mwr))

    def k3_at(shared):
        """K3 on the level-8 batch in the given instantiation, whichever
        the wrapper would pick: launched here only to be timed, not
        counted."""
        F, M = ml.shape
        words = torch.empty((F, mwr, 128), dtype=torch.int32, device=dev)
        total = torch.empty((F,), dtype=torch.int32, device=dev)
        _cuda.launch("flake_merge_words", dev, ml, mlead, mpay, words, total,
                     F, M, mwr * 128, int(shared))
        return words, total

    k3_plain = k3_mod.merge_words_plain(ml, mlead, mpay, mwr)
    for sh in (True, False):
        if not all(torch.equal(a, b) for a, b in zip(k3_at(sh), k3_plain)):
            fail(f"K3's {'shared' if sh else 'device'}-memory instantiation "
                 "disagrees with its plain version")
    k3_forms_ms = dict(zip(("shared memory", "device memory"), time_turns(
        lambda: k3_at(True), lambda: k3_at(False))))
    kernels[-1].update(shared_cap_bytes=k3_mod.MERGE_SHARED_CAP,
                       forms_ms=k3_forms_ms)
    print(f"K3's instantiations on the level-8 batch (the wrapper stages a "
          f"frame's words in shared memory up to {k3_mod.MERGE_SHARED_CAP} "
          f"bytes, {mwr * 512} here), each bit-exact: "
          f"{ {k: round(v, 4) for k, v in k3_forms_ms.items()} } ms",
          flush=True)

    # -- 4. K4 on a level-12 batch of 8192-sample sub-blocks ----------------
    vpcm = make_vbs_stream(SEED + 12, VBS_SECONDS)
    cfg12 = stream_config(12)
    vbs = cfg12.params.block_size
    n_super = vpcm.shape[0] // vbs
    supers = vpcm[:n_super * vbs].reshape(n_super, vbs, 2)
    sec = vbs // P.VBS_MAX_FRAMES
    res = vbs_section_sums(torch.from_numpy(supers).to(dev), sec)
    f_idx, starts, sizes = vbs_layout(res.cpu().numpy(), sec)
    hist = {int(k): int(v) for k, v in zip(*np.unique(sizes,
                                                      return_counts=True))}
    print(f"level-12/11 stream: {vpcm.shape[0]} samples x 2 ch = {n_super} "
          f"superblocks of {vbs} + {vpcm.shape[0] - n_super * vbs}-sample "
          f"tail; sub-block sizes {hist}", flush=True)
    if len(hist) < 4 or 4096 not in hist or vbs not in hist:
        fail("the split decision gave fewer than four sub-block sizes or "
             "missed 4096 or 8192")
    whole = np.flatnonzero(sizes == vbs)[:BATCH]
    fcfg12 = frame.FrameConfig.from_params(cfg12.params, 2, 16,
                                           block_size=vbs)
    cap12 = capture(
        [(frame, "autocorr"), (frame, "sweep_granules"),
         (bitpack, "merge_words")],
        lambda: analyze_and_pack(
            torch.from_numpy(supers[f_idx[whole]]).to(dev), fcfg12,
            f_idx[whole] * vbs, 1))
    gx, gcoefs, gshifts, g_mo, g_pmax = cap12["sweep_granules"][0]
    print(f"K4 inputs x {tuple(gx.shape)} ({whole.size} sub-blocks of "
          f"{vbs}), coefs {tuple(gcoefs.shape)}, pmax_static {g_pmax}, "
          f"granule {sweep_mod.granule_size(gx.shape[1], g_pmax)}", flush=True)

    def k4_run():
        return sweep_mod.sweep_granules(gx, gcoefs, gshifts, g_mo, g_pmax)

    def k2_run():
        return sweep_mod.sweep_sums(gx, gcoefs, gshifts, g_mo, g_pmax)

    phase("sweep_granules", "flake_tpu_torch/csrc/sweep_granules.cu",
          "flake_tpu/ops/pallas_sweep.py:147", k4_run,
          lambda: sweep_mod.sweep_granules_plain(gx, gcoefs, gshifts, g_mo,
                                              g_pmax), cmp_exact,
          (gx, gcoefs, gshifts), sweep_ops(gx, g_mo), FP64_OPS_PER_MS,
          before=lambda: yard["k4_before"](gx, gcoefs, gshifts, g_mo, g_pmax))
    k4_out = k4_run()
    kernels[-1]["bound_ms_fp64_tensor"] = tensor_bound(
        nbytes(gx, gcoefs, gshifts, k4_out), sweep_ops(gx, g_mo))

    def k4_int():
        return yard["k4_int"](gx, gcoefs, gshifts, g_mo, g_pmax)

    check("sweep_granules", k4_int,
          lambda: sweep_mod.sweep_granules_plain(gx, gcoefs, gshifts, g_mo,
                                                 g_pmax), cmp_exact)
    k4_ms, k4_int_ms = time_turns(k4_run, k4_int)
    kernels[-1].update(ms_beside_int=k4_ms, int_pipes_ms=k4_int_ms)
    print(f"info: K4 {k4_ms:.4f} ms (FP64 pipe); the same design on the "
          f"integer pipes (csrc/yardsticks/sweep_granules_int.cu, the same "
          f"sums) {k4_int_ms:.4f} ms; bound at the float64 tensor cores' "
          f"rate {kernels[-1]['bound_ms_fp64_tensor']:.4f} ms", flush=True)
    folded = k4_run().reshape(gx.shape[0], g_mo, 1 << g_pmax, -1).sum(-1)
    if not torch.equal(folded, k2_run()):
        fail("K4's granules, folded to partitions, differ from K2's sums")
    k2_ms, k4_ms = time_turns(k2_run, k4_run)
    kernels[-1]["k2_ms_same_inputs"] = k2_ms
    kernels[-1]["ms_beside_k2"] = k4_ms
    print(f"info: on K4's inputs K4 {k4_ms:.4f} ms, K2 {k2_ms:.4f} ms "
          f"(same sums folded)", flush=True)

    ax, awin, a_mo = cap12["autocorr"][0]
    _, detail = check("autocorr", lambda: k1_mod.autocorr(ax, awin, a_mo),
                      lambda: lpc.autocorr(ax, a_mo, awin), cmp_rel)
    k1_library12 = k1_library_on(ax, awin, a_mo)
    check_k1_library(f"the level-12 {vbs} bucket", k1_library12,
                     lpc.autocorr(ax, a_mo, awin))
    k1_12 = dict(zip(("ms", "ms_before", "library_ms"), time_turns(
        lambda: k1_mod.autocorr(ax, awin, a_mo),
        lambda: yard["k1_before"](ax, awin, a_mo), k1_library12)))
    k1_12["bound_ms"], k1_12["bound_by"] = bound(
        nbytes(ax, awin) + ax.shape[0] * (a_mo + 1) * 8, ax.numel()
        * (1 + 2 * (a_mo + 1)), FP64_OPS_PER_MS)
    k1_12["shape"] = [*ax.shape, a_mo + 1]
    next(k for k in kernels if k["name"] == "autocorr")[
        "level12_8192"] = k1_12
    print(f"K1 at {a_mo + 1} lags on x {tuple(ax.shape)}: {detail}; kernel "
          f"{k1_12['ms']:.4f} ms, first design {k1_12['ms_before']:.4f} ms, "
          f"grouped conv1d {k1_12['library_ms']:.4f} ms, bound {k1_12['bound_ms']:.4f} ms by {k1_12['bound_by']}",
          flush=True)
    vl, vlead, vpay, vwr = cap12["merge_words"][0]
    _, detail = check("merge_words",
                      lambda: k3_mod.merge_words(vl, vlead, vpay, vwr),
                      lambda: k3_mod.merge_words_plain(vl, vlead, vpay, vwr),
                      cmp_exact)
    print(f"K3 on {vbs}-sample frames, slots {tuple(vl.shape)}, word_rows "
          f"{vwr}: {detail}", flush=True)

    # -- 4b. K5 and U1 on the profiling tool's batch ---------------------------
    tF = tool.FRAMES
    tslots, tcfg = tool.batch_slots("music", tF, dev)
    parts = bitpack.aligned_parts(*tslots)
    twr = bitpack.word_rows(tcfg)
    w0t, hit, lot, cbits = parts
    nc = w0t.shape[-1]
    print(f"K5 and U1 inputs: aligned parts {tuple(w0t.shape)} of slots "
          f"{tuple(tslots[0].shape)}, chunk_bits {tuple(cbits.shape)}, "
          f"word_rows {twr}", flush=True)
    # the library yardstick: one scatter_add_ of every hi and lo word at its
    # word index (prepared outside the timed call) computes K5's words
    sc_idx = torch.cat([w0t, w0t + 1], dim=1).reshape(tF, -1).to(torch.int64)
    sc_val = torch.cat([hit, lot], dim=1).reshape(tF, -1)
    if int(sc_idx.min()) < 0 or int(sc_idx.max()) >= twr * 128:
        fail("the tool's batch has a word index outside its block")

    def k5_library():
        return torch.zeros((tF, twr * 128), dtype=torch.int32, device=dev) \
            .scatter_add_(1, sc_idx, sc_val).reshape(tF, twr, 128)

    def k5_run():
        return k3_mod.merge_aligned(*parts, twr)

    if not torch.equal(k5_library(), k5_run()):
        fail("scatter_add_ does not give K5's words")
    # about 6 int32 operations per slot: bounds checks and two atomics
    phase("merge_aligned", "flake_tpu_torch/csrc/bitmerge_aligned.cu",
          "flake_tpu/ops/pallas_bitmerge.py:271", k5_run,
          lambda: k3_mod.merge_aligned_plain(*parts, twr), cmp_exact,
          (w0t, hit, lot), 6 * w0t.numel(), INT32_OPS_PER_MS,
          library=k5_library)
    if not torch.equal(k5_run(), k3_mod.merge_words(*tslots, twr)[0]):
        fail("K5's words differ from K3's on the tool's slots")
    def prep_run():
        return bitpack.aligned_parts(*tslots)

    k5_ms, prep_ms, k3_ms = time_turns(
        k5_run, prep_run, lambda: k3_mod.merge_words(*tslots, twr),
        loop=(prep_run,))
    print(f"info: on the tool's slots K5 {k5_ms:.4f} ms after aligned_parts "
          f"{prep_ms:.4f} ms (in a plain loop), K3 {k3_ms:.4f} ms from the "
          "slots directly; the words are equal", flush=True)

    # what each variant must read: static2 and fixedrow everything, nowin
    # the hi words and the chunk bounds, zero nothing
    u1 = {"static2": (154, (cbits, w0t, hit, lot), 8 * w0t.numel()),
          "fixedrow": (178, (cbits, w0t, hit, lot), 10 * w0t.numel()),
          "nowin": (208, (cbits, hit), hit.numel()),
          "zero": (228, (), 0)}
    for name, (line, reads, ops) in u1.items():
        kern, plain = tool.VARIANTS[name]
        phase(f"prof_merge_{name}", "flake_tpu_torch/csrc/zero_floor.cu"
              if name == "zero" else "flake_tpu_torch/csrc/prof_merge.cu",
              f"util/prof_merge.py:141 (k_{name} :{line})",
              lambda kern=kern: kern(*parts, twr),
              lambda plain=plain: plain(*parts, twr), cmp_exact, reads, ops,
              INT32_OPS_PER_MS,
              library=(lambda: torch.zeros((tF, twr, 128), dtype=torch.int32,
                                           device=dev))
              if name == "zero" else None,
              plain_is_one_kernel=name == "zero",
              before=(lambda: yard["zero_before"](tF, twr, 1))
              if name == "zero" else None)
    print(f"static2_matches: "
          f"{torch.equal(tool.merge_static2(*parts, twr), k5_run())}",
          flush=True)

    def k5_on(label, slots, wr):
        """K5 against its plain version and against K3 on ``slots``."""
        p5 = bitpack.aligned_parts(*slots)
        got = k3_mod.merge_aligned(*p5, wr)
        torch.cuda.synchronize()
        if not torch.equal(got, k3_mod.merge_aligned_plain(*p5, wr)):
            fail(f"K5 disagrees with its plain version on {label}")
        if not torch.equal(got, k3_mod.merge_words(*slots, wr)[0]):
            fail(f"K5's words differ from K3's on {label}")
        print(f"K5 on {label}: aligned parts {tuple(p5[0].shape)}, word_rows "
              f"{wr}: bit-exact against its plain version and K3", flush=True)

    k5_on(f"the level-12 bucket of {vbs}-sample frames", (vl, vlead, vpay),
          vwr)
    cfg5 = stream_config(5)
    fcfg5 = frame.FrameConfig.from_params(cfg5.params, 2, 16)
    cap5 = capture(
        [(frame, "autocorr"), (bitpack, "merge_words")],
        lambda: analyze_and_pack(
            torch.from_numpy(pcm[:BATCH * BLOCK].reshape(BATCH, BLOCK, 2))
            .to(dev), fcfg5, np.arange(BATCH, dtype=np.int64), 0))
    k5_on("the first level-5 batch", cap5["merge_words"][0][:3],
          cap5["merge_words"][0][3])

    # -- 4b2. U2 and U3 on the music and noise batches and a made-up table -----
    nslots, _ = tool.batch_slots("noise", tF, dev)
    k5_on("the tools' noise batch", nslots, twr)
    made_up, mwr2 = make_slot_table(SEED + 4, 64, tslots[0].shape[1])
    content = {"music": (tslots, twr), "noise": (nslots, twr),
               "made-up table": (tuple(torch.from_numpy(a).to(dev)
                                       for a in made_up), mwr2)}
    aligned = {k: bitpack.aligned_parts(*sl) for k, (sl, _) in content.items()}
    combined = {k: tool3.v5_parts(*sl) for k, (sl, _) in content.items()}
    in_rows = {k: tool3.v5d_parts(*sl) for k, (sl, _) in content.items()}
    in_dual = {k: tool3.v5c_parts(*sl) for k, (sl, _) in content.items()}
    for label, (slots_c, wr_c) in content.items():
        al, v5 = aligned[label], combined[label]
        k5_words = k3_mod.merge_aligned(*al, wr_c)
        if label == "made-up table":
            k5_on(f"the made-up table ({wr_c} word rows, "
                  f"{wr_c * 512 / 1024:.0f} KiB of shared words)", slots_c,
                  wr_c)
        same = {}
        for name, kern, plain in (("v2", tool2.merge_v2,
                                   tool2.merge_v2_plain),
                                  ("v3", tool2.merge_v3,
                                   tool2.merge_v3_plain)):
            want = plain(*al, wr_c)
            for fb in U2_FBS[name]:
                got = kern(*al, wr_c, fb)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"merge_{name} at fb {fb} disagrees with its plain "
                         f"version on {label}")
            same[name] = torch.equal(want, k5_words)
        want = tool3.merge_v5_plain(*v5, wr_c)
        for name, run in (
                ("merge_v5a", lambda: tool3.merge_v5a(*v5, wr_c)),
                ("merge_v5b", lambda: tool3.merge_v5b(*v5, wr_c)),
                ("merge_v5a's first design",
                 lambda: yard["v5a_before"](v5, wr_c)),
                ("merge_v5b's first design",
                 lambda: yard["v5b_before"](v5, wr_c)),
                ("the combined-node merge by flagged columns",
                 lambda: yard["v5_columns"](v5, wr_c))):
            got = run()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"{name} disagrees with its plain version on {label}")
        if not torch.equal(want, k5_words) or not torch.equal(
                want, k3_mod.merge_words(*slots_c, wr_c)[0]):
            fail(f"the combined nodes' words differ from K5's or K3's on "
                 f"{label}")
        ext = int(tool2.chunk_ext_words(al[3]).max())
        flagged = [float((cb[:, :-1] < 0).double().mean()) for cb in v5[3:]]
        print(f"U2, U3 on {label}: merge_v2 (fb {U2_FBS['v2']}), merge_v3 "
              f"(fb {U2_FBS['v3']}), merge_v5a, "
              f"merge_v5b (and their first designs, and the spill sets by "
              f"flagged columns) bit-exact against their plain versions; v5a = v5b "
              f"= K5 = K3 words; widest chunk {ext} words; v2 gives K5's "
              f"words {same['v2']}, v3 {same['v3']}; flagged chunks sp2 "
              f"{flagged[0]:.4f}, sp1 {flagged[1]:.4f}", flush=True)
        in_domain = label != "made-up table"
        if same["v2"] != in_domain or same["v3"] != in_domain:
            fail(f"merge_v2 / merge_v3 against K5 on {label}: expected "
                 f"{in_domain}")
        if (flagged[0] > 0, flagged[1] > 0) != (True, not in_domain):
            fail(f"unexpected spill flags on {label}: {flagged}")
        # U3c-U3f: the same nodes in rows, placed over static rows
        *rows, overflow = in_rows[label]
        *dual, _ = in_dual[label]
        want = tool3.merge_v5_rows_plain(*rows, wr_c)
        zeros = torch.zeros_like(want)
        for kern, floor, kin in (
                (tool3.merge_v5d, tool3.merge_zero_rows, rows),
                (tool3.merge_v5c, tool3.merge_zero_fb, dual)):
            for fb in U3_FBS[kern.__name__]:
                got, nothing = kern(*kin, wr_c, fb), floor(*kin, wr_c, fb)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"{kern.__name__} at fb {fb} disagrees with its "
                         f"plain version on {label}")
                if not torch.equal(nothing, zeros):
                    fail(f"{floor.__name__} at fb {fb} does not give zeros "
                         f"on {label}")
        n_over = int(overflow.sum())
        if bool(n_over) == in_domain:
            fail(f"{n_over} frames overflow the static rows on {label}")
        if not torch.equal(want[~overflow], k5_words[~overflow]) or (
                in_domain and not torch.equal(
                    want, k3_mod.merge_words(*slots_c, wr_c)[0])):
            fail(f"the row-layout merges' words differ from K5's or K3's on "
                 f"{label}")
        changed = int((want != k5_words).flatten(1).any(-1).sum())
        print(f"U3c-U3f on {label}: merge_v5d (fb {U3_FBS['merge_v5d']}), "
              f"merge_v5c (fb {U3_FBS['merge_v5c']}) bit-exact "
              f"against their plain version, merge_zero_rows, merge_zero_fb "
              f"against torch.zeros; {n_over} of {want.shape[0]} frames "
              f"overflow {tool3.KMAX} / {tool3.KMAX1} static rows, {changed} "
              f"differ from K5's words, the others equal them", flush=True)

    # times and bounds on the music batch, the shapes the tools time; v2 and
    # v3 at fb = 8, the JAX tool's default, and beside their first designs at
    # every fb their tool times. One scatter_add_ gives their words too,
    # since they equal K5's there.
    for name, line, body, ops in (("v2", 224, "k_v2 :193", 12),
                                  ("v3", 353, "k_v3 :328", 10)):
        kern = getattr(tool2, f"merge_{name}")
        plain = getattr(tool2, f"merge_{name}_plain")
        before = yard[f"{name}_before"]
        phase(f"prof_merge_{name}", "flake_tpu_torch/csrc/prof_merge2.cu",
              f"util/prof_merge2.py:{line} ({body})",
              lambda kern=kern: kern(*parts, twr, 8),
              lambda plain=plain: plain(*parts, twr), cmp_exact,
              (cbits, w0t, hit, lot), ops * w0t.numel(), INT32_OPS_PER_MS,
              library=k5_library,
              before=lambda before=before: before(*parts, twr, 8))
        kernels[-1].update(fb=8)
        at_every_fb(f"merge_{name}", U2_FBS[name],
                    lambda fb, kern=kern: kern(*parts, twr, fb),
                    lambda fb, before=before: before(*parts, twr, fb),
                    plain(*parts, twr))
    v2_ms, v3_ms, k5_same_ms = time_turns(
        lambda: tool2.merge_v2(*parts, twr, 8),
        lambda: tool2.merge_v3(*parts, twr, 8), k5_run)
    kernels[-2].update(k5_ms_same_inputs=k5_same_ms)
    kernels[-1].update(k5_ms_same_inputs=k5_same_ms,
                       v2_ms_same_inputs=v2_ms)
    v3_cold = cold_ms(lambda: tool2.merge_v3(*parts, twr, 8))
    kernels[-1].update(cold_write_ms=v3_cold[0], cold_read_ms=v3_cold[1])
    print(f"info: on the same parts merge_v3 {v3_ms:.5f} ms, merge_v2 "
          f"{v2_ms:.5f} ms, K5 {k5_same_ms:.5f} ms; merge_v3 with a cold L2 "
          f"{v3_cold[0]:.5f} ms (64 MiB written between calls), "
          f"{v3_cold[1]:.5f} ms (read)", flush=True)

    def v5_read_bytes(v5):
        """What the v5 kernels must read of ``v5``: both cb tables, the
        main set, and the nodes of the flagged spill chunks."""
        main_p, _, _, cb2, cb1 = v5
        flagged2 = int((cb2[:, :-1] < 0).sum())
        flagged1 = int((cb1[:, :-1] < 0).sum())
        return nbytes(cb2, cb1, *main_p) + 128 * 4 * (4 * flagged2
                                                      + 3 * flagged1)

    def v5_sector_bytes(v5):
        """What a reader of ``v5`` in chunk layout moves at the 32-byte
        sectors the card reads: both cb tables, the main set, and each
        sector of a spill set that holds a node of a flagged chunk (a
        frame's arrays start on a sector: 512 nc bytes apart)."""
        main_p, sp2, sp1, cb2, cb1 = v5
        moved = nbytes(cb2, cb1, *main_p)
        for nodes, cb in ((sp2, cb2), (sp1, cb1)):
            F, _, nc = nodes[0].shape
            flagged = (cb[:, None, :-1] < 0).expand(F, 128, nc)
            moved += 32 * len(nodes) * int(
                flagged.reshape(F, -1, 8).any(-1).sum())
        return moved

    out_bytes = tF * twr * 512
    for name, line, body in (("v5a", 344, "k_v5a :307"),
                             ("v5b", 440, "k_v5b :403")):
        kern = getattr(tool3, f"merge_{name}")
        before = yard[f"{name}_before"]
        v5, v5n = combined["music"], combined["noise"]
        # about 8 int32 operations per node: bounds checks and three atomics
        phase(f"prof_merge_{name}", "flake_tpu_torch/csrc/prof_merge3.cu",
              f"util/prof_merge3.py:{line} ({body})",
              lambda kern=kern, v5=v5: kern(*v5, twr),
              lambda v5=v5: tool3.merge_v5_plain(*v5, twr), cmp_exact, (),
              8 * v5[0][0].numel(), INT32_OPS_PER_MS,
              read_bytes=v5_read_bytes(v5),
              before=lambda before=before, v5=v5: before(v5, twr))
        # the noise batch, every sp2 chunk flagged, beside it; the bounds
        # also at sector level
        noise_ms, noise_before = time_turns(
            lambda kern=kern: kern(*v5n, twr),
            lambda before=before: before(v5n, twr))
        noise_bound, _ = bound(v5_read_bytes(v5n) + out_bytes, 0,
                               INT32_OPS_PER_MS)
        sector_mb = {k: (v5_sector_bytes(combined[k]) + out_bytes) / 1e6
                     for k in ("music", "noise")}
        kernels[-1].update(
            noise_ms=noise_ms, noise_ms_before=noise_before,
            noise_bound_ms=noise_bound, sector_mb=sector_mb,
            sector_bound_ms={k: bound(mb * 1e6, 0, INT32_OPS_PER_MS)[0]
                             for k, mb in sector_mb.items()})
        print(f"info: prof_merge_{name} on the noise batch {noise_ms:.5f} ms "
              f"(first design {noise_before:.5f} ms), bound "
              f"{noise_bound:.5f} ms by bytes; at 32-byte sectors "
              f"{ {k: round(v, 2) for k, v in sector_mb.items()} } MB, "
              f"{ {k: round(v, 5) for k, v in kernels[-1]['sector_bound_ms'].items()} } "
              "ms (music, noise)", flush=True)
    v5a_entry = kernels[-2]
    # the spill sets read by flagged columns beside the kernel's masked
    # quads on both batches, and merge_v5a with a cold L2
    v5a_entry["forms_ms"] = {}
    for kind in ("music", "noise"):
        v5k = combined[kind]
        v5a_entry["forms_ms"][kind] = dict(zip(
            ("quads", "columns"),
            time_turns(lambda: tool3.merge_v5a(*v5k, twr),
                       lambda: yard["v5_columns"](v5k, twr))))
    v5a_cold = cold_ms(lambda: tool3.merge_v5a(*combined["music"], twr))
    v5a_entry.update(cold_write_ms=v5a_cold[0], cold_read_ms=v5a_cold[1])
    # what the chunk layout costs: the music nodes with no spill chunk
    # flagged (main alone), as they are (sp2's chunk 0 of 17), and with
    # every sp2 chunk flagged, held against the plain version each
    main_p, sp2_p, sp1_p, cb2_m, cb1_m = combined["music"]
    patterns = {"none": (cb2_m & tool3.MASK31, cb1_m & tool3.MASK31),
                "as is": (cb2_m, cb1_m),
                "every sp2": (cb2_m | tool3.FLAG, cb1_m)}
    for label, cbs in patterns.items():
        got = tool3.merge_v5a(main_p, sp2_p, sp1_p, *cbs, twr)
        torch.cuda.synchronize()
        if not torch.equal(got, tool3.merge_v5_plain(main_p, sp2_p, sp1_p,
                                                     *cbs, twr)):
            fail(f"merge_v5a disagrees with its plain version on music with "
                 f"{label} flagged")
    v5a_entry["music_flagged_ms"] = dict(zip(patterns, time_turns(
        *(lambda cbs=cbs: tool3.merge_v5a(main_p, sp2_p, sp1_p, *cbs, twr)
          for cbs in patterns.values()))))
    print(f"info: merge_v5a's spill sets by masked quads / by flagged "
          f"columns (csrc/yardsticks/prof_merge3_columns.cu) "
          f"{ {k: {f: round(t, 5) for f, t in v.items()} for k, v in v5a_entry['forms_ms'].items()} } "
          f"ms; merge_v5a with a cold L2 {v5a_cold[0]:.5f} ms (64 MiB "
          f"written between calls), {v5a_cold[1]:.5f} ms (read); on music "
          f"with no, its own and every sp2 chunk flagged "
          f"{ {k: round(t, 5) for k, t in v5a_entry['music_flagged_ms'].items()} } "
          "ms", flush=True)

    def v5a_run():
        return tool3.merge_v5a(*combined["music"], twr)

    def rows_of(parts_of, kind):
        *kin, _ = parts_of[kind]
        return kin

    # U3c, U3d: at fb = 8, the JAX tool's default, beside their first
    # designs at every fb on both batches; v5a's nodes, bytes and operations
    for name, line, body, parts_of in (("v5d", 653, "k_v5d :612", in_rows),
                                      ("v5c", 714, "k_v5c :677", in_dual)):
        kern = getattr(tool3, f"merge_{name}")
        before = yard[f"{name}_before"]
        fbs = U3_FBS[f"merge_{name}"]
        kin = rows_of(parts_of, "music")
        phase(f"prof_merge_{name}", "flake_tpu_torch/csrc/prof_merge3_rows.cu",
              f"util/prof_merge3.py:{line} ({body})",
              lambda kern=kern, kin=kin: kern(*kin, twr, 8),
              lambda: tool3.merge_v5_rows_plain(*rows_of(in_rows, "music"),
                                                twr),
              cmp_exact, (), 8 * kin[0].numel(), INT32_OPS_PER_MS,
              read_bytes=v5_read_bytes(combined["music"]),
              before=lambda before=before, kin=kin: before(kin, twr, 8))
        noise_bound, _ = bound(v5_read_bytes(combined["noise"])
                               + tF * twr * 512, 0, INT32_OPS_PER_MS)
        kernels[-1].update(fb=8, noise_bound_ms=noise_bound)
        for kind, prefix in (("music", ""), ("noise", "noise_")):
            kin = rows_of(parts_of, kind)
            at_every_fb(f"merge_{name} on {kind}", fbs,
                        lambda fb, kern=kern, kin=kin: kern(*kin, twr, fb),
                        lambda fb, before=before, kin=kin: before(kin, twr,
                                                                  fb),
                        tool3.merge_v5_rows_plain(*rows_of(in_rows, kind),
                                                  twr), prefix)
        kernels[-1]["noise_ms"] = kernels[-1]["noise_ms_by_fb"][8]
        kin = rows_of(parts_of, "music")
        _, v5a_ms = time_turns(lambda kern=kern, kin=kin: kern(*kin, twr, 8),
                               v5a_run)
        kernels[-1].update(v5a_ms_same_batch=v5a_ms)
        print(f"info: prof_merge_{name}: bound {noise_bound:.4f} ms by bytes "
              f"on the noise batch; merge_v5a {v5a_ms:.5f} ms on the same "
              "music nodes in chunk layout", flush=True)
    v5d_entry, v5c_entry = kernels[-2], kernels[-1]
    # v5c beside v5d on the same nodes, v5d with a cold L2, and the smoke's
    # v5c at fb 8 as the tool times it (the least of three means)
    same = {}
    for kind in ("music", "noise"):
        rows_k, dual_k = rows_of(in_rows, kind), rows_of(in_dual, kind)
        same[kind] = time_turns(lambda: tool3.merge_v5d(*rows_k, twr, 8),
                                lambda: tool3.merge_v5c(*dual_k, twr, 8))
    v5c_entry["v5d_ms_same_nodes"] = {k: v[0] for k, v in same.items()}
    v5c_entry["ms_same_nodes"] = {k: v[1] for k, v in same.items()}
    v5d_cold = cold_ms(lambda: tool3.merge_v5d(*rows_of(in_rows, "music"),
                                               twr, 8))
    v5d_entry.update(cold_write_ms=v5d_cold[0], cold_read_ms=v5d_cold[1])
    v5c_entry["tool_method_ms_fb8"] = tool.time_ms(
        lambda: tool3.merge_v5c(*rows_of(in_dual, "music"), twr, 8), dev, 20,
        back_to_back=True)
    print(f"info: on the same nodes merge_v5c / merge_v5d "
          f"{ {k: [round(x, 5) for x in v] for k, v in same.items()} } ms "
          "(music, noise; fb 8); merge_v5d with a cold L2 "
          f"{v5d_cold[0]:.5f} ms (64 MiB written between calls), "
          f"{v5d_cold[1]:.5f} ms (read); merge_v5c at fb 8 timed as the tool "
          f"times it {v5c_entry['tool_method_ms_fb8']:.5f} ms", flush=True)
    # the body as it was before it was cut to the one form it launches, at
    # other geometries (csrc/yardsticks/prof_merge3_rows_alt.cu): what chose
    # 256 threads, one block a frame and v5c's w0 read in place
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    forms = {"v5d 128 threads": (0, 128, 0, 0),
             "v5d 256 threads": (0, 256, 0, 0),
             "v5d 512 threads": (0, 512, 0, 0),
             f"v5d {sms} blocks": (0, 256, 0, sms),
             f"v5d {2 * sms} blocks": (0, 256, 0, 2 * sms),
             "v5c main w0 staged": (1, 256, 0, 0),
             "v5c main and sp2 w0 staged": (1, 256, 1, 0)}
    v5d_entry["forms_ms"] = {}
    for kind in ("music", "noise"):
        want = tool3.merge_v5_rows_plain(*rows_of(in_rows, kind), twr)
        runs = []
        for form in forms.values():
            kin = rows_of(in_dual if form[0] else in_rows, kind)
            got = yard["rows_form"](*form, kin, twr)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"the row-layout form {form} disagrees with the plain "
                     f"version on {kind}")
            runs.append(lambda form=form, kin=kin: yard["rows_form"](
                *form, kin, twr))
        v5d_entry["forms_ms"][kind] = dict(zip(forms, time_turns(*runs)))
    print(f"info: the row-layout merges' forms, each bit-exact: "
          f"{ {k: {f: round(t, 5) for f, t in v.items()} for k, v in v5d_entry['forms_ms'].items()} } "
          "ms", flush=True)

    def zeros_run():
        return torch.zeros((tF, twr, 128), dtype=torch.int32, device=dev)

    for name, line, parts_of in (("zero_fb", 847, in_dual),
                                 ("zero_rows", 1019, in_rows)):
        floor = getattr(tool3, f"merge_{name}")
        *kin, _ = parts_of["music"]
        phase(f"prof_merge_{name}", "flake_tpu_torch/csrc/zero_floor.cu",
              f"util/prof_merge3.py:{line} (k_{name})",
              lambda floor=floor, kin=kin: floor(*kin, twr, 8), zeros_run,
              cmp_exact, (), 0, INT32_OPS_PER_MS, library=zeros_run,
              plain_is_one_kernel=True,
              before=lambda: yard["zero_before"](tF, twr, 8))
        kernels[-1]["fb"] = 8
        at_every_fb(f"merge_{name}", (1, 8, 16, 32),
                    lambda fb, floor=floor, kin=kin: floor(*kin, twr, fb),
                    lambda fb: yard["zero_before"](tF, twr, fb), zeros_run())
    # the zero floor's other form, by bulk asynchronous stores
    bulk = yard["zero_bulk"](tF, twr)
    torch.cuda.synchronize()
    if not torch.equal(bulk, zeros_run()):
        fail("the zero floor by bulk asynchronous stores does not give zeros")
    # and the fixed cost of a launch: an empty kernel of one warp and one
    # of the zero floor's grid (a block of 256 threads an SM)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    zero_ms, bulk_ms, zeros_ms, empty_ms, empty_grid_ms = time_turns(
        lambda: tool3.merge_zero_rows(*in_rows["music"][:-1], twr, 8),
        lambda: yard["zero_bulk"](tF, twr), zeros_run,
        lambda: yard["launch_floor"](1, 32),
        lambda: yard["launch_floor"](sms, 256))
    kernels[-1].update(bulk_form_ms=bulk_ms, launch_floor_ms={
        "1x32": empty_ms, f"{sms}x256": empty_grid_ms})
    print(f"info: the zero floor {zero_ms:.4f} ms, by bulk asynchronous "
          f"stores (csrc/yardsticks/zero_floor_bulk.cu) {bulk_ms:.4f} ms, "
          f"torch.zeros {zeros_ms:.4f} ms; an empty kernel of 1 x 32 "
          f"threads {empty_ms:.4f} ms, of {sms} x 256 {empty_grid_ms:.4f} "
          "ms", flush=True)

    def v5_prep_run():
        return tool3.v5_parts(*tslots)

    def v5d_prep_run():
        return tool3.v5d_parts(*tslots)

    def v5c_prep_run():
        return tool3.v5c_parts(*tslots)

    preps = (v5_prep_run, v5d_prep_run, v5c_prep_run, prep_run)
    v5_prep, v5d_prep, v5c_prep, al_prep = time_turns(*preps, loop=preps)
    print(f"info: on the tool's slots v5_parts {v5_prep:.4f} ms, v5d_parts "
          f"{v5d_prep:.4f} ms, v5c_parts {v5c_prep:.4f} ms beside "
          f"aligned_parts {al_prep:.4f} ms (all in a plain loop)",
          flush=True)

    # -- 4c. the EST recursions on the card and on the host --------------------
    # XLA:CPU fuses every multiply-add of Schur and Levinson, and the port
    # writes them as torch.addcmul; the card must round them the same way
    gen = torch.Generator().manual_seed(SEED)
    fa, fb, fc = (torch.randn(1 << 20, dtype=torch.float64, generator=gen)
                  for _ in range(3))
    on_card = torch.addcmul(fa.to(dev), fb.to(dev), fc.to(dev)).cpu()
    print(f"addcmul on 2^20 float64 triples: {int((on_card != torch.addcmul(fa, fb, fc)).sum())} "
          f"differ between card and host; {int((on_card != fa + fb * fc).sum())} "
          "differ from the unfused a + b*c", flush=True)
    ax5, awin5, a_mo5 = cap5["autocorr"][0]
    ac5 = k1_mod.autocorr(ax5, awin5, a_mo5)
    refs5 = lpc.schur_refs(ac5)
    for label, on_dev, on_host in (
            ("schur_refs", refs5, lpc.schur_refs(ac5.cpu())),
            ("levinson_from_refs", lpc.levinson_from_refs(refs5),
             lpc.levinson_from_refs(refs5.cpu())),
            ("levinson_all_orders", lpc.levinson_all_orders(ac5)[0],
             lpc.levinson_all_orders(ac5.cpu())[0])):
        on_dev = on_dev.cpu()
        differ = int(((on_dev != on_host)
                      & ~(on_dev.isnan() & on_host.isnan())).sum())
        print(f"{label} on {tuple(ac5.shape)} autocorrelations: {differ} of "
              f"{on_host.numel()} float64 values differ between card and "
              "host", flush=True)
        if differ:
            fail(f"{label} rounds differently on the card and on the host")
    est = lpc.estimate_order(refs5, a_mo5)
    print(f"EST orders of the first level-5 batch: "
          f"{ {int(k): int(v) for k, v in zip(*torch.unique(est, return_counts=True))} }",
          flush=True)

    # -- 5. the sweeps on every shape the level-12 path gives them ----------
    # every shape the sweeping levels give them: order 8 at level 7 and
    # order 12 at level 8 (their first 60 s), order 12 at every sub-block
    # size of level 10 and order 32 at every one of level 12, tails
    # included. K2 is held against its plain version on each, and timed
    # beside its first design and, where K4 can sum the shape, beside K4
    # (whose granules, folded, must give K2's sums): the table the K2/K4
    # route (ops/sweep.uses_granule_kernel) was drawn from, measured again
    route_calls = {}
    for level, stream in ((7, pcm[:60 * SAMPLE_RATE]),
                          (8, pcm[:60 * SAMPLE_RATE]), (10, vpcm),
                          (12, vpcm)):
        got = capture([(frame, "sweep_sums"), (frame, "sweep_granules")],
                      lambda: Encoder(stream_config(level), device="cuda")
                      .encode_stream(stream))
        for args in got.get("sweep_sums", []) + got.get("sweep_granules",
                                                         []):
            route_calls.setdefault((level, tuple(args[0].shape[::-1]),
                                    args[3], args[4]), args)
    table = []
    for (level, *_), (cx, cc, cs, c_mo, c_pmax) in sorted(
            route_calls.items(), key=lambda item: item[0]):
        N, B = cx.shape

        def k2c(cx=cx, cc=cc, cs=cs, c_mo=c_mo, c_pmax=c_pmax):
            return sweep_mod.sweep_sums(cx, cc, cs, c_mo, c_pmax)

        def k2b(cx=cx, cc=cc, cs=cs, c_mo=c_mo, c_pmax=c_pmax):
            return yard["k2_before"](cx, cc, cs, c_mo, c_pmax)

        _, detail = check(
            "sweep_sums", k2c,
            lambda: sweep_mod.sweep_sums_plain(cx, cc, cs, c_mo, c_pmax),
            cmp_exact)
        fns = [k2c, k2b]
        if sweep_mod.granule_fits(B, c_pmax):
            def k4c(cx=cx, cc=cc, cs=cs, c_mo=c_mo, c_pmax=c_pmax):
                return sweep_mod.sweep_granules(cx, cc, cs, c_mo, c_pmax)

            folded = k4c().reshape(N, c_mo, 1 << c_pmax, -1).sum(-1)
            if not torch.equal(folded, k2c()):
                fail(f"K4 folded differs from K2 on x {tuple(cx.shape)}")
            fns.append(k4c)
        k2_ms, k2_before_ms, *k4 = time_turns(*fns)
        to_k4 = sweep_mod.uses_granule_kernel(B, c_pmax)
        row = {"level": level, "shape": [N, B], "order": c_mo,
               "pmax_static": c_pmax,
               "k2_ms": k2_ms, "k2_ms_before": k2_before_ms,
               "k4_ms": k4[0] if k4 else None,
               "bound_ms": bound(nbytes(cx, cc, cs) + N * c_mo
                                 * (1 << c_pmax) * 8, sweep_ops(cx, c_mo),
                                 FP64_OPS_PER_MS)[0],
               "bound_ms_fp64_tensor": tensor_bound(
                   nbytes(cx, cc, cs) + N * c_mo * (1 << c_pmax) * 8,
                   sweep_ops(cx, c_mo)),
               "routed_to": "K4" if to_k4 else "K2"}
        table.append(row)
        faster = "K4" if k4 and k4[0] < k2_ms else "K2"
        print(f"level {level}, x {tuple(cx.shape)}, order {c_mo}, pmax_static "
              f"{c_pmax}: K2 {detail}, K2 {k2_ms:.4f} ms (first design "
              f"{k2_before_ms:.4f} ms), K4 "
              f"{f'{k4[0]:.4f} ms (granule {sweep_mod.granule_size(B, c_pmax)})' if k4 else 'cannot sum it'}"
              f", bound {row['bound_ms']:.4f} ms; routed to {row['routed_to']}"
              f", faster in this run: {faster}", flush=True)
    if not any(r["order"] == 32 and r["pmax_static"] == 8
               and r["routed_to"] == "K2" for r in table):
        fail("the level-12 path gave K2 no shape at order 32, pmax 8")
    next(k for k in kernels if k["name"] == "sweep_sums")[
        "level12_shapes"] = table

    # -- 6. a level-12 segment through the CPU and the CUDA encoder ---------
    seg = vpcm[PARITY_WINDOW[0] * SAMPLE_RATE:PARITY_WINDOW[1] * SAMPLE_RATE]
    before = {fn: fn.launches for fn in (sweep_mod.sweep_sums,
                                         sweep_mod.sweep_granules)}
    t0 = time.perf_counter()
    on_card = Encoder(cfg12, device="cuda").encode_stream(seg)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    if any(fn.launches == n for fn, n in before.items()):
        fail("the level-12 parity segment did not reach both K2 and K4")
    t0 = time.perf_counter()
    on_host = Encoder(cfg12, device="cpu").encode_stream(seg)
    t_host = time.perf_counter() - t0
    print(f"parity: {PARITY_WINDOW[0]}-{PARITY_WINDOW[1]} s of level 12, "
          f"CUDA {t_card:.2f} s, CPU {t_host:.2f} s, {len(on_card)} bytes, "
          f"equal {on_card == on_host}", flush=True)
    if on_card != on_host:
        fail("the CPU and CUDA encoders disagree on the level-12 segment")
    fseg = pcm[FIXED_PARITY_WINDOW[0] * SAMPLE_RATE:
               FIXED_PARITY_WINDOW[1] * SAMPLE_RATE]
    for level in LEVEL_SECONDS:
        on_card = Encoder(stream_config(level),
                          device="cuda").encode_stream(fseg)
        on_host = Encoder(stream_config(level),
                          device="cpu").encode_stream(fseg)
        print(f"parity: {FIXED_PARITY_WINDOW[0]}-{FIXED_PARITY_WINDOW[1]} s "
              f"of the fixed-block stream at level {level}, {len(on_card)} "
              f"bytes, equal {on_card == on_host}", flush=True)
        if on_card != on_host:
            fail(f"the CPU and CUDA encoders disagree at level {level}")

    def wide_config(label):
        channels, bps, rate, level, _ = WIDE_STREAMS[label]
        return P.StreamConfig(channels=channels, sample_rate=rate,
                              bits_per_sample=bps,
                              params=P.set_defaults(level))

    wide = {label: make_wide_stream(SEED + 24 + i, channels, bps, rate, secs)
            for i, (label, (channels, bps, rate, _, secs))
            in enumerate(WIDE_STREAMS.items())}
    for label, stream in wide.items():
        cfg = wide_config(label)
        mid, half = stream.shape[0] // 2, cfg.sample_rate \
            * WIDE_PARITY_SECONDS // 2
        wseg = stream[mid - half:mid + half]    # tones, then the noise
        on_card = Encoder(cfg, device="cuda").encode_stream(wseg)
        on_host = Encoder(cfg, device="cpu").encode_stream(wseg)
        print(f"parity: {WIDE_PARITY_SECONDS} s of the {label} stream at "
              f"level {WIDE_STREAMS[label][3]}, {len(on_card)} bytes, equal "
              f"{on_card == on_host}", flush=True)
        if on_card != on_host:
            fail(f"the CPU and CUDA encoders disagree on the {label} stream")

    # -- 6b. K1-K3 on every call of the fixed-block levels' main paths -------
    # levels 0-7: EST needs no sweep, the FIXED levels no autocorrelation
    # either; every stream here ends in a partial block
    k123 = ("autocorr", "sweep_sums", "merge_words")
    k1234 = k123 + ("sweep_granules",)   # K2 for the partial last block
    sweeps = ("sweep_sums", "sweep_granules")
    low_levels = ((5, ("autocorr", "merge_words"), sweeps),
                  (7, k1234, ()),
                  (3, ("autocorr", "merge_words"), sweeps),
                  (2, ("merge_words",), ("autocorr",) + sweeps),
                  (1, ("merge_words",), ("autocorr",) + sweeps),
                  (0, ("merge_words",), ("autocorr",) + sweeps))

    def level_stream(level):
        return pcm[:LEVEL_SECONDS.get(level, SECONDS) * SAMPLE_RATE]

    # each stream is encoded once with the three wrappers recorded, and every
    # call they got (each batch and the partial last block) goes through the
    # kernel and its plain version again: the whole width and every shape of
    # the main path, which the 3 s parity windows above do not reach
    held = {"autocorr": (k1_mod.autocorr,
                         lambda cx, cw, mo: lpc.autocorr(cx, mo, cw), cmp_rel),
            "sweep_sums": (sweep_mod.sweep_sums, sweep_mod.sweep_sums_plain,
                           cmp_exact),
            "merge_words": (k3_mod.merge_words, k3_mod.merge_words_plain,
                            cmp_exact),
            "sweep_granules": (sweep_mod.sweep_granules,
                               sweep_mod.sweep_granules_plain, cmp_exact)}
    needs_of_level = {8: ("autocorr", "sweep_granules", "merge_words"),
                      5: ("autocorr", "merge_words")}
    held_paths = [(f"level {level}", stream_config(level),
                   level_stream(level), needs)
                  for level, needs, _ in ((8, k1234, ()),) + low_levels] \
        + [(label, wide_config(label), stream,
            needs_of_level[WIDE_STREAMS[label][3]])
           for label, stream in wide.items()] \
        + [(f"level {level}", stream_config(level), vpcm, k1234)
           for level in (12, 11)]
    k3_forms_held = set()
    for label, cfg, stream, needs in held_paths:
        calls = capture(
            [(frame, "autocorr"), (frame, "sweep_sums"),
             (frame, "sweep_granules"), (bitpack, "merge_words")],
            lambda: Encoder(cfg, device="cuda").encode_stream(stream))
        if set(calls) != set(needs):
            fail(f"{label} called {sorted(calls)}, expected "
                 f"{sorted(needs)}")
        for name, args_of_calls in calls.items():
            kern, plain, compare = held[name]
            worst = 0.0
            for args in args_of_calls:
                err, _ = check(f"{name} on {label}",
                               lambda: kern(*args), lambda: plain(*args),
                               compare)
                worst = max(worst, rel_err.pop(f"{name} on {label}", err))
            shapes = sorted({tuple(args[0].shape) for args in args_of_calls})
            what = (f", {args_of_calls[0][2] + 1} lags" if name == "autocorr"
                    else f", order {args_of_calls[0][3]}"
                    if name in sweeps else "")
            if name == "merge_words":
                forms = {"shared" if k3_mod.merge_in_shared(args[3])
                         else "global" for args in args_of_calls}
                k3_forms_held |= forms
                what = (f", word rows {sorted({a[3] for a in args_of_calls})}"
                        f", K3 instantiations {sorted(forms)}")
            how = (f"max rel err {worst:.3e} (tolerance {K1_REL_TOL:g})"
                   if compare is cmp_rel else "bit-exact")
            print(f"{label}: {name} on {len(args_of_calls)} calls, "
                  f"first-argument shapes {shapes}{what}: {how} against the "
                  "plain version", flush=True)
        del calls
    if k3_forms_held != {"shared", "global"}:
        fail(f"K3 was held on the streams in {sorted(k3_forms_held)} only")

    # -- 7. the main paths through Encoder.encode_stream ---------------------
    counted = {"autocorr": k1_mod.autocorr, "sweep_sums": sweep_mod.sweep_sums,
               "merge_words": k3_mod.merge_words,
               "sweep_granules": sweep_mod.sweep_granules,
               "merge_aligned": k3_mod.merge_aligned,
               **{f"prof_merge_{name}": kern
                  for name, (kern, _) in tool.VARIANTS.items()},
               "prof_merge_v2": tool2.merge_v2, "prof_merge_v3": tool2.merge_v3,
               "prof_merge_v5a": tool3.merge_v5a,
               "prof_merge_v5b": tool3.merge_v5b,
               "prof_merge_v5d": tool3.merge_v5d,
               "prof_merge_v5c": tool3.merge_v5c,
               "prof_merge_zero_fb": tool3.merge_zero_fb,
               "prof_merge_zero_rows": tool3.merge_zero_rows}
    launched = {name: {} for name in counted}   # name -> {path: count}
    k3_launched_by = {}     # path -> K3's launches by instantiation

    def count_launches(label, run, needs, never=()):
        """Run one main path with every count set to 0 just before it and
        read just after; ``needs`` must have launched, ``never`` not."""
        for fn in counted.values():
            fn.launches = 0
        k3_mod.merge_words.launches_by = {"shared": 0, "global": 0}
        result = run()
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in counted.items()}
        if counts["merge_words"]:
            k3_launched_by[label] = dict(k3_mod.merge_words.launches_by)
        print(f"{label}: launches { {k: v for k, v in counts.items() if v} }",
              flush=True)
        missing = [name for name in needs if counts[name] < 1]
        if missing:
            fail(f"{label}: {missing} never launched on the main path")
        unwanted = [name for name in never if counts[name]]
        if unwanted:
            fail(f"{label}: {unwanted} launched, and this path has no use "
                 "for them")
        for name, n in counts.items():
            if n:
                launched[name][label] = n
        return result

    # the emission-profiling tool: K5 and U1's main path; its counts are
    # those of its fixed timing passes (two warm-up calls and three times
    # one or two passes of 20, by how the stage is timed)
    res = count_launches(
        "profiling tool", lambda: tool.main(device="cuda"),
        ("autocorr", "sweep_granules", "merge_words", "merge_aligned")
        + tuple(f"prof_merge_{name}" for name in tool.VARIANTS))
    if not res["static2_matches"] or (res["F"], res["nc"], res["wr"]) \
            != (tF, nc, twr):
        fail(f"the profiling tool's result is off: {res}")
    # the merge-prototype tools: U2's and U3's main paths. Their match keys
    # must hold on both batches: the widest noise chunk stays inside
    # merge_v2's 256 words and merge_v3's four rows
    analysis_k5 = ("autocorr", "sweep_granules", "merge_aligned")
    for label, run, needs in (
            ("prototype tool v2", tool2.main, ("prof_merge_v2",)),
            ("prototype tool v3", tool2.main_v3, ("prof_merge_v3",)),
            ("combined-node tool", tool3.main,
             ("prof_merge_v5a", "prof_merge_v5b")),
            ("row-layout tool v5d", tool3.main_v5d,
             ("prof_merge_v5d", "prof_merge_zero_rows")),
            ("dual-layout tool v5c", tool3.main_v5c,
             ("prof_merge_v5c", "prof_merge_zero_fb"))):
        res = count_launches(label, lambda: run(device="cuda"),
                             analysis_k5 + needs)
        wrong = [k for k, v in res.items() if "match" in k and v is not True]
        if wrong or any(k.endswith("first_bad") for k in res):
            fail(f"{label}: {wrong} not true in {res}")
        if any(v for k, v in res.items() if k.endswith("overflow_frames")):
            fail(f"{label}: frames of the tool's batches overflow the static "
                 f"rows: {res}")
        if run is tool3.main_v5c:
            v5c_entry["tool_ms_fb8"] = res["music_v5c_fb8_ms"]
            print(f"info: merge_v5c at fb 8 on music: the tool "
                  f"{res['music_v5c_fb8_ms']} ms, the smoke "
                  f"{v5c_entry['ms_by_fb'][8]:.5f} ms in turns and "
                  f"{v5c_entry['tool_method_ms_fb8']:.5f} ms as the tool "
                  "times it", flush=True)

    def drive(label, cfg, stream, needs, never=()):
        """One main path through the encoder, cold then warm; the counts
        are those of the cold run."""
        torch.cuda.reset_peak_memory_stats(dev)
        rate, pcm_bytes = cfg.sample_rate, stream.size * cfg.bits_per_sample / 8
        enc = Encoder(cfg, device="cuda")
        t0 = time.perf_counter()
        blob = count_launches(label, lambda: enc.encode_stream(stream),
                              needs, never)
        cold = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"{label}: batches {enc.stats['batches']}, frames "
              f"{enc.stats['frames']}: total_bits == 8*frame_bytes held for "
              "every batch", flush=True)
        enc2 = Encoder(cfg, device="cuda")
        t0 = time.perf_counter()
        blob2 = enc2.encode_stream(stream)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        if blob2 != blob:
            fail(f"{label}: the warm run's bytes differ from the cold run's")
        secs = stream.shape[0] / rate
        print(f"encode {secs:g} s {label} on {card}: cold {cold:.3f} s "
              f"({secs / cold:.1f}x realtime), warm {warm:.3f} s "
              f"({secs / warm:.1f}x realtime); {len(blob)} bytes "
              f"({len(blob) / pcm_bytes:.4f} of the PCM bytes); "
              f"peak device memory {peak / 2**20:.0f} MiB; warm stats "
              f"{ {k: round(v, 4) for k, v in enc2.stats.items()} }",
              flush=True)
        t0 = time.perf_counter()
        dec = decoder.decode_stream(blob)
        if not dec.md5_ok:
            fail(f"{label}: decoded MD5 does not match STREAMINFO")
        if not np.array_equal(dec.samples, stream):
            fail(f"{label}: decoded samples differ from the input")
        print(f"{label} decode: lossless, MD5 ok, {dec.frames} frames, "
              f"STREAMINFO block sizes {dec.streaminfo.min_block_size}-"
              f"{dec.streaminfo.max_block_size} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        return dec

    dec8 = drive("level 8", cfg8, pcm, k1234)
    if dec8.streaminfo.min_block_size != BLOCK:
        fail("level 8: STREAMINFO min block is not the block size")
    # the silent and noise seconds take the CONSTANT and VERBATIM branches
    for label, first, want in (("silent second", 640, frame.SF_CONSTANT),
                               ("noise second", 1070, frame.SF_VERBATIM)):
        _, hnb = header_bytes(np.arange(first, first + 32, dtype=np.int64),
                              BLOCK, 0)
        got = frame.analyze_frames(
            torch.from_numpy(pcm[first * BLOCK:(first + 32) * BLOCK]
                             .reshape(32, BLOCK, 2)).to(dev), fcfg8,
            torch.from_numpy(hnb * 8).to(dev))["sf_type"]
        kinds = {int(k): int(v) for k, v in
                 zip(*torch.unique(got, return_counts=True))}
        print(f"{label}: subframe types {kinds}", flush=True)
        if want not in kinds:
            fail(f"the {label} did not reach subframe type {want}")

    for level, needs, never in low_levels:
        cfg = stream_config(level)
        stream = level_stream(level)
        if stream.shape[0] % cfg.params.block_size == 0:
            fail(f"level {level}: the stream has no partial last block")
        dec = drive(f"level {level}", cfg, stream, needs, never)
        if dec.streaminfo.min_block_size != cfg.params.block_size:
            fail(f"level {level}: STREAMINFO min block is not the block size")

    for level in (12, 11):
        dec = drive(f"level {level}", stream_config(level), vpcm, k1234)
        if dec.streaminfo.min_block_size != 16:
            fail(f"level {level}: STREAMINFO min block is not 16")

    for label, stream in wide.items():
        cfg = wide_config(label)
        dec = drive(label, cfg, stream, needs_of_level[WIDE_STREAMS[label][3]])
        info = dec.streaminfo
        if (info.channels, info.bits_per_sample, info.sample_rate) != (
                cfg.channels, cfg.bits_per_sample, cfg.sample_rate):
            fail(f"{label}: STREAMINFO says {info}")
        form = "shared" if k3_mod.merge_in_shared(bitpack.word_rows(
            frame.FrameConfig.from_params(cfg.params, cfg.channels,
                                          cfg.bits_per_sample))) else "global"
        if not k3_launched_by[label][form]:
            fail(f"{label}: K3's {form} instantiation never launched")
    if not all(sum(by[form] for by in k3_launched_by.values())
               for form in ("shared", "global")):
        fail(f"the main paths did not launch both K3 instantiations: "
             f"{k3_launched_by}")

    # -- 8. results -----------------------------------------------------------
    for k in kernels:
        k["launches"] = sum(launched[k["name"]].values())
        k["launches_by_path"] = launched[k["name"]]
    next(k for k in kernels if k["name"] == "merge_words")[
        "launches_by_instantiation"] = {
            form: {path: by[form] for path, by in k3_launched_by.items()
                   if by[form]} for form in ("shared", "global")}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
