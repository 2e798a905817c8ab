#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Builds the port's CUDA kernels (K1 autocorrelation, K2 and K4 order
sweeps, K3 word merge, K5 pre-aligned word merge, U1, the four merge
variants of the emission-profiling tool, U2, the merge prototypes
``merge_v2`` and ``merge_v3``, U3a/U3b, the combined-node merges
``merge_v5a`` and ``merge_v5b``, and U3c-U3f, their row-layout forms
``merge_v5d`` and ``merge_v5c`` with the zero floors ``merge_zero_rows`` and
``merge_zero_fb``, one kernel with U1's zero variant, and R1 and R2, the
Rice search from partition sums and the final pass from the samples (the
residual, its int32 fit flag and the Rice search with the exact bits),
L, the LPC coefficient stage (Levinson for every order, or Schur and
the seeded Levinson, then the quantizer, in one launch), and the four
kernels of the last launch chains: S, the order selection under every
order method and its candidate's coefficients and shift, X, the FIXED
order search, H, the frame head (stereo mode and decorrelation, wasted
bits, constant flags) and E, the slot layout; no
Pallas kernel stands behind R1, R2, L, S, X, H or E) and its host
libraries (CRC
patcher, decoder helpers) from this checkout, and holds each kernel
against its plain PyTorch version: R1 and R2 on the inputs the first
level-8 batch and the level-12 8192 bucket give them (timed there beside
their plain versions, their bounds and their first designs, R2's after
the torch lag loop it replaced, and R2 at 128, 256 and 512 threads a
block) and on made-up tables (rows whose k and partition-order scans
tie, sums from 2^32 up; for R2, 32-bit samples at the int32 limits under
order-32 coefficients near +-2^14 and shift 15, where the fit flag must
take both values, orders 0-32 on rows of 777, 16,384, 20 and 3 samples,
samples of -2..2 and the fixed predictors); K1-K3 on the inputs the first level-8
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
K1-K4, R1, R2, ``merge_v2``, ``merge_v3``, ``merge_v5a``, ``merge_v5b``,
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
floors must give ``torch.zeros``. L (32 streams a block, the recursion
one stream a lane in registers, the quantizer on other warps as rows are
published) and its first design (``csrc/yardsticks/lpc_v1.cu``, a warp a
stream) must give their plain version's bits (NaNs equal) on the inputs
of the first level-8 batch, the level-12 8192 bucket, the first level-5
batch (EST) and the level-8 batch in float32, each timed beside the other
(``ms_before``), its plain version and the launch floor of its grid, with
its bounds by bytes, by operations and by its dependent chain, each
operation at its own probed latency (adds, correctly rounded divisions,
truncations; a shuffle's latency is printed and not counted), and L on
made-up tables (the shift search's edges at precisions 5-15, degenerate
autocorrelations) in both dtypes and both modes. The Schur and Levinson
recursions of the EST order method must give the same float64 bits on
the card and on the host, and torch.addcmul in both dtypes is read
against the host's. S, H and E must give their plain versions' bits on
the inputs of the first level-8 batch and of the level-12 8192 bucket, X
on those of the first level-2 batch (512 frames of 1,152), the first
level-1 and level-0 batches (orders 2-4, and order 2 alone) and the
10-sample tail at level 8, each timed beside its plain version with its
bound by bytes and int32 operations and its share of it; E (a
thread-block cluster a frame), H (a block a frame, staged by bulk
copies), S and X (a warp a stream) beside their first designs
(``csrc/yardsticks/slots_v1.cu``, ``head_v1.cu``, ``select_v1.cu`` and
``fixed_v1.cu``), which must give the same bits, H, S and X beside an
empty kernel on their grids, S also without its gather (the order alone,
as its first design computes it) and on the 8192 bucket (SEARCH) beside
``torch.argmin``, the one PyTorch call of SEARCH's selection (no PyTorch
call computes X, H, E, or S under LOG: library none).

Three-second windows must give the same bytes through
``Encoder(device="cpu")`` (the plain versions) and
``Encoder(device="cuda")``: 4-7 s of the level-12 stream (steady audio
and noise bursts, reaching both K2 and K4) and 99-102 s of the fixed-block
stream (tones around the full-scale noise second) at levels 5, 7, 3, 2, 1
and 0, and 2 s of each stream at another width (``WIDE_STREAMS``: 24-bit
/ 96 kHz stereo at level 8, 6-channel / 48 kHz 16-bit at level 5,
8-channel / 96 kHz 24-bit at level 5, whose frames' words exceed K3's
shared-memory cap, 32-bit / 44.1 kHz stereo at level 8, and 24-bit / 96
kHz stereo at level 12, whose side channels give K4 25-bit samples).
Each fixed-block stream (levels 8, 5, 7, 3, 2, 1, 0),
each of those and the level-12 and level-11 streams is encoded once with
K1-K4, R1, R2 and L recorded, and every call they got, each batch and the
partial last block, is held against the plain version again (K1 at 13, 9, 7 and 33
lags, K2 at orders 12, 8 and 32, K3 on 1152- to 8192-sample frames and in
both instantiations, K4 on every bucket it sums; S, X, H and E too).
Then the main paths run, each with the launch counts set to 0 just before it
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
levels 3 (K1, K3) and 2, 1, 0 (block 1152, K3 only), 32 blocks and a
10-sample tail at level 8 (the tail takes X at an LPC level; the CPU
encoder must give its bytes),
a second deterministic stream with level jumps, bursts and silences
at levels 12 and 11, whose variable block sizes must split into at least
four sub-block sizes, 4096 and 8192 among them (K1-K4 must launch), and
the five streams at other widths (30 s, 30 s, 4 s, 10 s and 10 s; K1 and
K3, and K4 at levels 8 and 12, K2 for the 32-bit tail and the level-12
stream's odd sub-block sizes; the 8-channel stream must launch K3's
device-memory instantiation, the others its shared one). Every stream is
decoded with
the port's independent decoder (``flake_tpu_torch.decoder``), MD5
included, and its STREAMINFO must give its channels, bits and rate. Each
stream is encoded once more, untimed, with the host emission
(``pack_backend="host"``, the native packer), whose bytes must equal K3's
and which must launch no K3. Each stream prints its peak device memory
above what the smoke holds at the reset, which at levels 11 and 12 must
stay under ``PEAK_LIMIT_MIB``; levels 8 and 12 also print it by stage
(``analyze_frames``, R1, R2, the emission and, inside it, the slot layout
and K3 apart), with the slot layout's own tensors alive at its peak
(:func:`live_tensors`). 600 s of the variable-block stream at level 12
is encoded the same way, decoded with its MD5, and 3 s of it must give
the same bytes through the CPU and the CUDA encoder. 600 s of the
fixed-block stream at levels 2 and 7 is encoded once counted and once by
stage, decoded with its MD5, and its peak device memory may lie no more
than ``LONG_PEAK_SLACK_MIB`` above its level's short stream's (printed by
stage beside it). On every path R2 must launch wherever a stream is
predicted, R1 wherever a sweep runs (R1 also on the sp path, in its final
search), L and S wherever LPC runs (the sp path too), X on every FIXED
level, H on every
dense analysis and E on every device emission (each sp rank's too), and
no plain version of the seven, nor the plain final pass's lag loop, nor a
plain recursion or quantizer, nor the plain pieces of the order
selection, the FIXED search and the frame head, may see a card tensor.

Then the file path, as a user runs it (``flake_tpu_torch.cli.main``, the
launch counts set to 0 around each run), on WAV files written by the
port's ``write_wave``: BASELINE config 1 at full width (``-5 -b 4608`` on
600 s of 16-bit / 44.1 kHz stereo with a partial last block; ``wavinfo``
printed; K1 and K3 must launch, the sweeps not), cold and warm under each
emission, whose files must be equal and decode to the samples the port's
reader reads, with STREAMINFO blocks of 4608; the 24-bit / 96 kHz stream
at ``-8``, whose file must equal ``encode_stream``'s (the command line
reads in chunks); the recorded plucks of ``tests/data`` (AIFF and WAV,
16- and 24-bit, 11,025 Hz) at ``-5``, each file equal to
``encode_stream``'s on the samples it decodes to; and ``-8 --lpc-dtype
float32`` on 30 s (lossless; K1 must not launch, K4 and K3 must) beside
float64.

Then the sharded path (``flake_tpu_torch.parallel``): 30 s of the
fixed-block stream at level 8 through ``Encoder(mesh=make_mesh(devices=
[cuda:0, cuda:0]))`` under both emissions (and over distinct cards where
there are two), whose bytes must equal one device's; BASELINE config 5 at
full width (6 channels, 48 kHz, 16-bit, 3,600 s, level 8, made on the card
by ``make_wide_stream``'s signal model) in one process, through the
launcher (``python -m flake_tpu_torch.parallel.launch --spawn 2 --backend
gloo --device cuda:0``) and through ``encode_stream_to_file_distributed``
on two ranks, every rank reading the whole WAV: every rank's stream and
both files must have the one process's sha256, STREAMINFO the PCM's MD5
and 172,800,000 samples, and every rank must sit on the card and launch
K1, K4 and K3; 60 s of the same signal through the two ranks, decoded in
full with its MD5; and one NCCL rank (two on distinct cards where there
are two) on the 60 s WAV, whose file must equal the gloo ranks'. The
ranks' launches, summed, are their paths' (``dp mesh``, ``2 ranks gloo``,
``1 rank nccl`` and the rest in ``launches_by_path``).

Then the sp path (section 7d, ``flake_tpu_torch.parallel.mesh``'s sp
analysis: each frame's samples over two ranks): 30 s of the fixed-block
stream at levels 8 and 5, 30 s of BASELINE config 3's 24-bit / 96 kHz
stereo at level 8, and 10 s of the variable-block stream at level 12,
each through ``Encoder(mesh=make_mesh(devices=..., sp=2))`` on sp 2 (the
card twice), dp 2 x sp 2 (the card four times), and the distinct cards
where there are two or four: every stream must decode with its MD5 and
hold its sample count, give the same bytes twice, on distinct cards as on
the card repeated, and under the host emission (no K3) as under the device
one (K3); where every block size took the sp analysis, K1, K2 and K4 must
not launch, and no plain version of a kernel may run on a CUDA tensor. The
frames whose bytes differ from one device's are counted and printed, not
gated; each such frame's sp autocorrelation must lie within K1_REL_TOL of
the dense one. Each run prints its wall against one device's, each
device's peak memory and its launches (``sp ...`` in
``launches_by_path``). A level-8 sp batch runs under
``profiling.trace``, whose top ten device ops and sp stages are printed;
then ``graft_entry.dryrun_multichip(4)`` and ``graft_entry.entry()``'s
function (K1, K4 and K3 must launch).

Then the measurement path (section 8, :func:`measurement_paths`), each
tool at full size through its entry point, with the launch counts set to
0 around it and its JSON lines printed: the bench
(``flake_tpu_torch.bench``: 512 frames of 4096 at level 8, 30 s end to
end; ``e2e_verified`` true and a host-packer rate, K1-K4 must launch),
``util.bench_matrix`` over its six configs with the host/device parity
encodes (every row's ``device_pack_parity`` true, K1-K4), ``util.
level_matrix``'s full cells over the 10 s corpus (every cell decoded with
its MD5, K1-K4) and
``util.prof_an5`` at levels 5 (K1 only), 8 and 12 (K1 and K4, on K4's
route).

    python3 chip_smoke.py

Needs one CUDA device of compute capability 9.0; fails without one. Any
failed phase exits non-zero before the final line, which is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 20260116
SAMPLE_RATE = 44100
SECONDS = 180
BLOCK = 4096
BATCH = 512
VBS_SECONDS = 60        # the level-12 and level-11 stream
LONG_SECONDS = 600      # the long streams (levels 12, 2 and 7)
PARITY_WINDOW = (4, 7)  # seconds of it through the CPU and the CUDA encoder
FIXED_PARITY_WINDOW = (99, 102)  # of the fixed-block stream, levels 5 and 7
# seconds of the fixed-block stream per level below 8 (level 8 takes it all)
LEVEL_SECONDS = {5: 180, 7: 60, 3: 30, 2: 30, 1: 30, 0: 30}
SCENE = 10              # seconds per scene of that stream
# BASELINE.json config 1 (the default flake CLI run: level 5, fixed
# 4608-sample blocks) through the command line on a WAV file of this
# length; 600 s end in an 864-sample partial block
CONFIG1_SECONDS = 600
CONFIG1_BLOCK = 4608
FLOAT32_SECONDS = 30    # of the fixed-block stream at --lpc-dtype float32
# the sharded path: 30 s of the fixed-block stream at level 8 through a dp
# mesh of the card twice; BASELINE.json config 5 ("multichannel (6ch) +
# hour-long streams frame-sharded over N>=2 hosts") at full width, two
# ranks sharing the card; a 60 s stream of the same generator decoded in
# full (the hour's decode would take about 11 minutes)
DP_SECONDS = 30
CONFIG5 = {"channels": 6, "bps": 16, "rate": 48000, "seconds": 3600,
           "level": 8}
CONFIG5_DECODE_SECONDS = 60
RANK_DEVICE = "cuda:0"  # the card the ranks share
# the sp path: each frame's samples over two ranks. Streams: label ->
# (level, seconds, source); "config 3" is BASELINE.json config 3's
# 24-bit/96 kHz stereo, made by WIDE_STREAMS' model. A level-8 batch of
# SP_TRACE_FRAMES frames runs under the profiler
SP_STREAMS = {"level 8": (8, DP_SECONDS, "fixed"),
              "level 5": (5, DP_SECONDS, "fixed"),
              "config 3, 24-bit/96 kHz stereo": (8, DP_SECONDS, "wide"),
              "level 12": (12, 10, "vbs")}
SP_TRACE_FRAMES = 256
RANK_TIMEOUT = 600      # seconds a job of ranks may take
# streams at other widths: label -> (channels, bits per sample, sample
# rate, level, seconds). The 6-channel frames take 49,664 bytes of words,
# above the 48 KiB that needs K3's shared-memory opt-in; the 8-channel
# 24-bit frames take 98,816, above K3's shared-memory cap, so they take
# its other instantiation
WIDE_STREAMS = {"24-bit/96 kHz stereo": (2, 24, 96000, 8, 30),
                "6-channel/48 kHz 16-bit": (6, 16, 48000, 5, 30),
                "8-channel/96 kHz 24-bit": (8, 24, 96000, 5, 4),
                "32-bit/44.1 kHz stereo": (2, 32, 44100, 8, 10),
                "24-bit/96 kHz stereo, level 12": (2, 24, 96000, 12, 10)}
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
FP32_OPS_PER_MS = 67e9
FP64_OPS_PER_MS = 33.5e9
FP64_TENSOR_OPS_PER_MS = 67e9
INT32_OPS_PER_MS = 33.5e9
# the encoder's peak device memory above the smoke's at levels 11 and 12:
# 6,559 MiB while the Rice scans held their k grids, level 8's 732 MiB since
PEAK_LIMIT_MIB = 2048
# how far a 600 s stream's peak device memory may lie above the same
# level's short stream's (allocator rounding; nothing should grow)
LONG_PEAK_SLACK_MIB = 4
LONG_LEVELS = (2, 7)    # 600 s at these levels beside their short streams


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def make_stream(seed: int, seconds: int = SECONDS) -> "np.ndarray":
    """``seconds`` (180 unless asked) of int32 [n, 2] 16-bit stereo: two
    different low tone pairs (every lag up to 12 stays well correlated),
    light noise, a silent second at 60 s (CONSTANT subframes) and a second
    of full-scale binary noise at 100 s (verbatim frames). The first batch
    (47.5 s) is tonal."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = seconds * SAMPLE_RATE
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


def make_wide_stream_on(device, seed: int, channels: int, bps: int, rate: int,
                        seconds: int) -> "np.ndarray":
    """:func:`make_wide_stream`'s signal, made on ``device`` in float64 from
    torch's generator (numpy takes about 100 s for an hour of 6 channels):
    a tone pair a channel under a slow envelope with light noise, a silent
    half second at a quarter of the stream and a half second of full-scale
    binary noise at half of it. Returns int32 [n, channels] on the host."""
    import math

    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    n = seconds * rate
    t = torch.arange(n, dtype=torch.float64, device=device) / rate
    top = (1 << (bps - 1)) - 1
    env = 0.6 + 0.4 * torch.sin(2 * math.pi * t / 13.0)
    pcm = torch.randn((n, channels), generator=g, dtype=torch.float64,
                      device=device).mul_(top / 200)
    for ch in range(channels):
        f0 = 110.0 * (1 + 0.37 * ch)
        pcm[:, ch] += env * top * (0.4 * torch.sin(2 * math.pi * f0 * t + ch)
                                   + 0.15 * torch.sin(2 * math.pi * 2.5 * f0
                                                      * t))
    del t, env
    half = rate // 2
    pcm[n // 4:n // 4 + half] = 0
    m = min(half, n - n // 2)
    pcm[n // 2:n // 2 + m] = torch.where(
        torch.rand((m, channels), generator=g, device=device) < 0.5,
        -top - 1.0, float(top))
    out = pcm.round_().clamp_(-top - 1, top).to(torch.int32).cpu().numpy()
    del pcm
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


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


# one rank of encode_stream_to_file_distributed: argv rank, ranks, port,
# WAV, output, level, device; prints one JSON line of its counters
TO_FILE_RANK = """
import json, resource, sys, time
import torch
from flake_tpu_torch import params as P
from flake_tpu_torch.io import open_pcm
from flake_tpu_torch.ops import autocorr, bitmerge, bitpack, frame, lpc
from flake_tpu_torch.ops import rice, sweep
from flake_tpu_torch.parallel import distributed as D
rank, nproc, port, wav, out, level, device = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5],
    int(sys.argv[6]), sys.argv[7])
D.initialize(f"127.0.0.1:{port}", nproc, rank, "gloo")
with open(wav, "rb") as fp:
    reader = open_pcm(fp)
    pcm, info = reader.read_all(), reader.info
cfg = P.StreamConfig(channels=info.channels, sample_rate=info.sample_rate,
                     bits_per_sample=info.bits_per_sample,
                     samples=pcm.shape[0], params=P.set_defaults(level))
kernels = {"autocorr": autocorr.autocorr, "sweep_sums": sweep.sweep_sums,
           "sweep_granules": sweep.sweep_granules,
           "merge_words": bitmerge.merge_words, "rice_scan": rice.rice_scan,
           "final_pass": rice.final_pass, "candidates": lpc.candidates,
           "select_candidate": frame.select_candidate,
           "fixed_search": rice.fixed_search, "frame_head": frame.frame_head,
           "slot_layout": bitpack.slot_layout}
for fn in kernels.values():
    fn.launches = 0
t0 = time.perf_counter()
size = D.encode_stream_to_file_distributed(pcm, cfg, out, device=device)
torch.cuda.synchronize(device)
encode_s = time.perf_counter() - t0
D.dist.destroy_process_group()
assert "jax" not in sys.modules
print(json.dumps({"rank": rank, "device": device, "bytes": size,
                  "encode_s": encode_s,
                  "peak_host_mib": resource.getrusage(
                      resource.RUSAGE_SELF).ru_maxrss / 1024,
                  "peak_device_mib": torch.cuda.max_memory_allocated(device)
                  / 2**20,
                  "launches": {k: fn.launches for k, fn in kernels.items()}}),
      flush=True)
"""


def streaminfo_of(blob: bytes) -> dict:
    """STREAMINFO's sample count and MD5, read from its fixed layout (the
    first metadata block's 34 bytes after "fLaC" and the block header)."""
    body = blob[8:42]
    return {"samples": int.from_bytes(body[10:18], "big") & ((1 << 36) - 1),
            "md5": body[18:34]}


def run_ranks(label, cmds, launched, needs):
    """Run one job of ranks (a command a rank, or one launcher command that
    spawns them), each printing a JSON line of its counters; every rank
    must sit on the card and launch each kernel of ``needs``. The ranks'
    launches, summed, are the path's. Returns (wall seconds, the ranks'
    lines in rank order)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              text=True) for cmd in cmds]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    if any(proc.returncode for proc in procs):
        fail(f"{label}: exit codes {[proc.returncode for proc in procs]}")
    ranks = sorted((json.loads(line) for out in outs
                    for line in out.splitlines() if line.startswith("{")),
                   key=lambda r: r["rank"])
    if [r["rank"] for r in ranks] != list(range(len(ranks))) or not ranks:
        fail(f"{label}: the ranks' counters are missing: {outs}")
    for r in ranks:
        if not r["device"].startswith("cuda"):
            fail(f"{label}: rank {r['rank']} ran on {r['device']}")
        missing = [k for k in needs if r["launches"][k] < 1]
        if missing:
            fail(f"{label}: rank {r['rank']} never launched {missing}")
    counts = {k: sum(r["launches"][k] for r in ranks)
              for k in ranks[0]["launches"]}
    print(f"{label}: launches {counts}, by rank "
          f"{[{k: v for k, v in r['launches'].items() if v} for r in ranks]}",
          flush=True)
    for name, n in counts.items():
        if n:
            launched[name][label] = n
    return wall, ranks


def launcher(wav, out, ranks: int, backend: str, device: str, level: int):
    """The launcher's command line for ``ranks`` local ranks."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return [sys.executable, "-m", "flake_tpu_torch.parallel.launch",
            "--spawn", str(ranks), "--backend", backend, "--device", device,
            "--coordinator", f"127.0.0.1:{port}", "--level", str(level),
            "--stats", str(wav), "-o", str(out)]


def sharded_paths(card, pcm, count_launches, launched) -> None:
    """Section 7c: the dp mesh in one process, then BASELINE config 5
    through two ranks (the launcher, the to-file path) against one
    process, a 60 s stream of its generator decoded, and NCCL."""
    import hashlib
    import socket

    import numpy as np
    import torch

    from flake_tpu_torch import decoder
    from flake_tpu_torch import params as P
    from flake_tpu_torch.encoder import Encoder
    from flake_tpu_torch.io.wav import write_wave
    from flake_tpu_torch.md5 import Md5Chain, pcm_md5_bytes
    from flake_tpu_torch.parallel.mesh import make_mesh
    from flake_tpu_torch.parallel.runner import shard_ranges

    k1234 = ("autocorr", "sweep_sums", "merge_words", "sweep_granules",
             "rice_scan", "final_pass", "candidates", "select_candidate",
             "frame_head", "slot_layout")
    # config 5's tails (2,048 and 512 samples) take K4, so K2 need not run
    on_card = ("autocorr", "sweep_granules", "merge_words", "rice_scan",
               "final_pass", "candidates", "select_candidate", "frame_head",
               "slot_layout")
    cfg8 = P.StreamConfig(channels=2, sample_rate=SAMPLE_RATE,
                          bits_per_sample=16, params=P.set_defaults(8))

    # a. frames over a dp mesh of the card twice (and of distinct cards)
    seg = pcm[:DP_SECONDS * SAMPLE_RATE]
    t0 = time.perf_counter()
    want = Encoder(cfg8, device=RANK_DEVICE).encode_stream(seg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"one device: {DP_SECONDS} s at level 8 in {wall:.3f} s "
          f"({DP_SECONDS / wall:.1f}x realtime)", flush=True)
    meshes = {"dp mesh": [RANK_DEVICE, RANK_DEVICE]}
    if torch.cuda.device_count() >= 2:
        meshes[f"dp mesh, {torch.cuda.device_count()} cards"] = [
            f"cuda:{i}" for i in range(torch.cuda.device_count())]
    for label, devices in meshes.items():
        mesh = make_mesh(devices=devices)
        for backend in ("device", "host"):
            path = label if backend == "device" else f"{label}, host emission"
            t0 = time.perf_counter()
            got = count_launches(
                path, lambda: Encoder(cfg8, mesh=mesh, pack_backend=backend)
                .encode_stream(seg),
                k1234 if backend == "device"
                else tuple(k for k in k1234
                           if k not in ("merge_words", "slot_layout")),
                () if backend == "device" else ("merge_words",
                                                "slot_layout"))
            wall = time.perf_counter() - t0
            if got != want:
                fail(f"{path}: the bytes differ from one device's")
            print(f"{path} ({mesh}): {DP_SECONDS} s at level 8 in "
                  f"{wall:.3f} s ({DP_SECONDS / wall:.1f}x realtime); the "
                  f"bytes equal one device's {len(want)}", flush=True)

    # b. BASELINE config 5 at full width
    c5 = CONFIG5
    cfg5 = P.StreamConfig(channels=c5["channels"], sample_rate=c5["rate"],
                          bits_per_sample=c5["bps"],
                          params=P.set_defaults(c5["level"]))
    t0 = time.perf_counter()
    stream = make_wide_stream_on(RANK_DEVICE, SEED + 50, c5["channels"],
                                 c5["bps"], c5["rate"], c5["seconds"])
    n = stream.shape[0]
    secs = n / c5["rate"]
    pcm_md5 = hashlib.md5(stream.astype("<i2").tobytes()).digest()
    print(f"config 5 input: {n} samples x {c5['channels']} channels "
          f"({secs:g} s at {c5['rate']} Hz, {c5['bps']}-bit), made on the "
          f"card and hashed in {time.perf_counter() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        wav = tmp / "config5.wav"
        t0 = time.perf_counter()
        write_wave(wav, stream, c5["rate"], c5["bps"])
        print(f"config 5 WAV: {wav.stat().st_size} bytes, written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        torch.cuda.reset_peak_memory_stats(0)
        held = torch.cuda.memory_allocated(0)
        enc = Encoder(cfg5, device=RANK_DEVICE)
        t0 = time.perf_counter()
        one = count_launches("config 5, one process",
                             lambda: enc.encode_stream(stream), on_card)
        walls = {"one process": time.perf_counter() - t0}
        peak = (torch.cuda.max_memory_allocated(0) - held) / 2**20
        si = streaminfo_of(one)
        digest = hashlib.sha256(one).hexdigest()
        print(f"config 5, one process: {len(one)} bytes, sha256 {digest}; "
              f"peak device memory {peak:.0f} MiB above the {held / 2**20:.0f}"
              f" MiB held; stats "
              f"{ {k: round(v, 4) for k, v in enc.stats.items()} }",
              flush=True)
        if si["samples"] != n or n != c5["seconds"] * c5["rate"]:
            fail(f"config 5: STREAMINFO holds {si['samples']} samples, "
                 f"not {c5['seconds'] * c5['rate']}")
        if si["md5"] != pcm_md5:
            fail("config 5: STREAMINFO's MD5 is not the PCM bytes' MD5")
        # the MD5 ring's step on one rank: the chain over its span's sample
        # bytes, which the ranks take in turn
        lo, hi = shard_ranges(n, cfg5.params.block_size, 2)[0]
        t0 = time.perf_counter()
        chain = Md5Chain()
        chain.update(pcm_md5_bytes(stream[lo:hi], c5["bps"]))
        print(f"config 5: one rank's step of the MD5 ring (rank 0's "
              f"{hi - lo} samples) {time.perf_counter() - t0:.3f} s on the "
              "host", flush=True)
        del stream

        out = tmp / "config5_launcher.flac"
        walls["2 ranks gloo"], ranks = run_ranks(
            "2 ranks gloo",
            [launcher(wav, out, 2, "gloo", RANK_DEVICE, c5["level"])],
            launched, on_card)
        if {r["sha256"] for r in ranks} != {digest} \
                or hashlib.sha256(out.read_bytes()).hexdigest() != digest:
            fail("config 5: the ranks' streams or the launcher's file differ "
                 "from one process's")
        out.unlink()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        out = tmp / "config5_to_file.flac"
        walls["2 ranks to file"], file_ranks = run_ranks(
            "2 ranks gloo, to file",
            [[sys.executable, "-c", TO_FILE_RANK, str(r), "2", str(port),
              str(wav), str(out), str(c5["level"]), RANK_DEVICE]
             for r in range(2)], launched, on_card)
        if hashlib.sha256(out.read_bytes()).hexdigest() != digest:
            fail("config 5: the to-file path's file differs from one "
                 "process's stream")
        out.unlink()
        for label, wall in walls.items():
            print(f"config 5 (6 ch, 48 kHz, 16-bit, {secs:g} s, level 8), "
                  f"{label} on {card}: {wall:.3f} s ({secs / wall:.1f}x "
                  "realtime); sha256 equal to one process's", flush=True)
        for label, rows in (("launcher", ranks), ("to file", file_ranks)):
            print(f"config 5 ranks ({label}): " + "; ".join(
                f"rank {r['rank']} on {r['device']}: encode "
                f"{r['encode_s']:.3f} s"
                + (f", read {r['read_s']:.3f} s" if "read_s" in r else "")
                + f", peak host {r['peak_host_mib']:.0f} MiB, peak device "
                f"{r['peak_device_mib']:.0f} MiB" for r in rows), flush=True)
        wav.unlink()

        # c. 60 s of the same generator through the same two ranks, decoded
        short = make_wide_stream_on(RANK_DEVICE, SEED + 51, c5["channels"],
                                    c5["bps"], c5["rate"],
                                    CONFIG5_DECODE_SECONDS)
        wav = tmp / "config5_60s.wav"
        write_wave(wav, short, c5["rate"], c5["bps"])
        out = tmp / "config5_60s.flac"
        wall, _ = run_ranks(
            f"2 ranks gloo, {CONFIG5_DECODE_SECONDS} s",
            [launcher(wav, out, 2, "gloo", RANK_DEVICE, c5["level"])],
            launched, on_card)
        blob = out.read_bytes()
        t0 = time.perf_counter()
        dec = decoder.decode_stream(blob)
        if not dec.md5_ok or not np.array_equal(dec.samples, short):
            fail(f"config 5, {CONFIG5_DECODE_SECONDS} s: the two ranks' "
                 "stream does not decode to its samples with its MD5")
        print(f"config 5, {CONFIG5_DECODE_SECONDS} s over 2 ranks: "
              f"{wall:.3f} s; decode: "
              f"lossless, MD5 ok, {dec.frames} frames "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

        # d. NCCL: one rank on the card (and a rank a card where there are
        # two or more)
        jobs = {"1 rank nccl": (1, RANK_DEVICE)}
        if torch.cuda.device_count() >= 2:
            jobs["2 ranks nccl"] = (2, "cuda")
        for label, (nranks, device) in jobs.items():
            out2 = tmp / f"{label.replace(' ', '_')}.flac"
            wall, _ = run_ranks(
                label, [launcher(wav, out2, nranks, "nccl", device,
                                 c5["level"])],
                launched, on_card)
            if out2.read_bytes() != blob:
                fail(f"{label}: the file differs from the gloo ranks'")
            print(f"{label}, {CONFIG5_DECODE_SECONDS} s: {wall:.3f} s; the "
                  "file equals the gloo ranks'", flush=True)


def frame_spans(blob: bytes) -> list:
    """(first byte, end byte, samples) of each frame of a FLAC stream,
    found by decoding it frame by frame."""
    from flake_tpu_torch import decoder

    si, _, _, pos = decoder._parse_metadata(blob)
    spans = []
    while pos < len(blob):
        samples, end, _ = decoder.decode_frame(blob, pos, si)
        spans.append((pos, end, samples.shape[0]))
        pos = end
    return spans


def device_ms(event) -> float:
    """An averaged profiler event's own device time in ms."""
    return event.self_device_time_total / 1000


def sp_paths(card, streams, count_launches, launched) -> None:
    """Section 7d: each frame's samples over two ranks. ``streams``: label
    -> (StreamConfig, int32 samples). For each stream one device's bytes
    and wall first, then on each mesh (sp 2 on the card twice, dp 2 x sp 2
    on it four times, and the distinct cards where there are two or four)
    the device emission cold and again, and the host emission: lossless
    with the MD5, the same bytes twice and under both emissions, K3 under
    the device emission and not under the host one, no K1, K2 or K4 where
    every block size took the sp analysis, and no plain version of K1-K4
    on a CUDA tensor. The frames whose bytes differ from one device's are
    counted, not gated; each must have its autocorrelation within
    K1_REL_TOL of the dense one. Then a level-8 sp batch under
    ``profiling.trace``, ``graft_entry.dryrun_multichip(4)`` and one run of
    ``graft_entry.entry()``'s function."""
    import numpy as np
    import torch

    from flake_tpu_torch import decoder, graft_entry, profiling
    from flake_tpu_torch import params as P
    from flake_tpu_torch.encoder import Encoder
    from flake_tpu_torch.ops import autocorr as k1_mod
    from flake_tpu_torch.ops import bitmerge, bitpack, frame, lpc, rice
    from flake_tpu_torch.ops import stereo, sweep
    from flake_tpu_torch.parallel import mesh as mesh_mod

    dense_kernels = ("autocorr", "sweep_sums", "sweep_granules")
    cards = torch.cuda.device_count()
    meshes = {"sp 2": [RANK_DEVICE] * 2, "dp 2 x sp 2": [RANK_DEVICE] * 4}
    same_shape = {}      # a mesh of distinct cards -> the card's of its shape
    for n, like in ((2, "sp 2"), (4, "dp 2 x sp 2")):
        if cards >= n:
            meshes[f"{like}, {n} cards"] = [f"cuda:{i}" for i in range(n)]
            same_shape[f"{like}, {n} cards"] = like

    def cpu_only(name, plain):
        def run(x, *args):
            # the slot layout's plain version takes the analysis dict; S's
            # takes no bits under MAX and EST
            t = next(a for a in (x["sf_type"] if isinstance(x, dict) else x,
                                 *args) if isinstance(a, torch.Tensor))
            if t.device.type != "cpu":
                fail(f"the sp path ran {name}, a plain version of a kernel, "
                     f"on {t.device}")
            return plain(x, *args)
        return run

    plains = [(lpc, "autocorr"), (sweep, "sweep_sums_plain"),
              (sweep, "sweep_granules_plain"), (bitmerge, "merge_words_plain"),
              (rice, "rice_scan_plain"), (rice, "rice_final_plain"),
              (rice, "final_pass_plain"), (lpc, "candidates_plain"),
              (frame, "select_order_bits_plain"),
              (frame, "select_candidate_plain"), (lpc, "estimate_order"),
              (bitpack, "slot_layout_plain")]
    originals = [(mod, name, getattr(mod, name)) for mod, name in plains]
    for mod, name, orig in originals:
        setattr(mod, name, cpu_only(name, orig))

    def autocorr_gap(cfg, pcm, start, n) -> float:
        """The largest relative difference between the sp and the dense
        autocorrelation of the frame of ``n`` samples at ``start``, on the
        channels the analysis gives it (stereo mode and wasted bits from
        the dense analysis, which the sp one equals exactly)."""
        dev = torch.device(RANK_DEVICE)
        fcfg = frame.FrameConfig.from_params(cfg.params, cfg.channels,
                                             cfg.bits_per_sample,
                                             block_size=n)
        x = torch.from_numpy(pcm[start:start + n][None]).to(dev)
        a = frame.analyze_frames(x, fcfg, torch.full((1,), 48, device=dev))
        chans = x.permute(0, 2, 1)
        if cfg.channels == 2:
            ch0, ch1, _ = stereo.apply_decorr(chans[:, 0], chans[:, 1],
                                              a["ch_mode"])
            chans = torch.stack([ch0, ch1], dim=1)
        xn = (chans >> a["wasted"][..., None]).reshape(cfg.channels, n) \
            .contiguous()
        mo = fcfg.max_prediction_order
        dense = k1_mod.autocorr(xn, lpc.welch_window_on(n, dev), mo)
        spv = mesh_mod.autocorr_sp(list(xn.chunk(2, dim=-1)), mo)
        return float(((spv - dense).abs() / dense.abs().clamp_min(1)).max())

    try:
        for label, (cfg, pcm) in streams.items():
            secs = pcm.shape[0] / cfg.sample_rate
            walls = []
            for _ in range(2):           # the second run is the warm one
                torch.cuda.reset_peak_memory_stats(RANK_DEVICE)
                t0 = time.perf_counter()
                one = Encoder(cfg, device=RANK_DEVICE).encode_stream(pcm)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            print(f"sp, {label}: one device {secs:g} s in {walls[1]:.3f} s "
                  f"warm ({secs / walls[1]:.1f}x realtime), {len(one)} bytes,"
                  " peak device memory "
                  f"{torch.cuda.max_memory_allocated(RANK_DEVICE) / 2**20:.1f}"
                  " MiB", flush=True)
            blobs, checked = {}, set()
            for mlabel, devices in meshes.items():
                mesh = mesh_mod.make_mesh(devices=devices, sp=2)
                path = f"sp {label}, {mlabel}"
                used = sorted({torch.device(d).index for d in devices})
                for i in used:
                    torch.cuda.reset_peak_memory_stats(i)
                enc = Encoder(cfg, mesh=mesh)
                t0 = time.perf_counter()
                # R1: the order loop's scan and the final search; L: the
                # coefficient stage and S, the selection and its gather,
                # once a group; E before K3
                blob = count_launches(path, lambda: enc.encode_stream(pcm),
                                      ("merge_words", "slot_layout",
                                       "rice_scan", "candidates",
                                       "select_candidate"))
                cold = time.perf_counter() - t0
                peaks = {m["device"]: m["peak_bytes_in_use"] / 2**20
                         for m in profiling.device_memory_stats()
                         if torch.device(m["device"]).index in used}
                sizes = sorted(c.block_size for c in enc._sharded_packers)
                folded = [c.block_size for c in enc._sharded_packers
                          if not mesh_mod.sp_supported(c, 2)]
                if len(folded) == len(sizes):
                    fail(f"{path}: no block size took the sp analysis")
                ran = {k: launched[k].get(path, 0) for k in dense_kernels}
                if not folded and any(ran.values()):
                    fail(f"{path}: every block size took the sp analysis, "
                         f"yet the dense kernels launched: {ran}")
                t0 = time.perf_counter()
                again = Encoder(cfg, mesh=mesh).encode_stream(pcm)
                torch.cuda.synchronize()
                warm = time.perf_counter() - t0
                if again != blob:
                    fail(f"{path}: two encodes on one mesh differ")
                host = count_launches(
                    f"{path}, host emission",
                    lambda: Encoder(cfg, mesh=mesh, pack_backend="host")
                    .encode_stream(pcm),
                    ("rice_scan", "candidates", "select_candidate"),
                    ("merge_words", "slot_layout"))
                if host != blob:
                    fail(f"{path}: the host emission's bytes differ from "
                         "K3's")
                if mlabel in same_shape and blob != blobs[same_shape[mlabel]]:
                    fail(f"{path}: the bytes differ from the card's "
                         f"{same_shape[mlabel]}")
                blobs[mlabel] = blob
                if blob not in checked:
                    t0 = time.perf_counter()
                    dec = decoder.decode_stream(blob)
                    if not dec.md5_ok or not np.array_equal(dec.samples, pcm):
                        fail(f"{path}: the stream does not decode to its "
                             "samples with its MD5")
                    if streaminfo_of(blob)["samples"] != pcm.shape[0]:
                        fail(f"{path}: STREAMINFO holds "
                             f"{streaminfo_of(blob)['samples']} samples")
                    checked.add(blob)
                    print(f"{path}: lossless, MD5 ok, {dec.frames} frames, "
                          f"STREAMINFO {pcm.shape[0]} samples "
                          f"({time.perf_counter() - t0:.1f} s)", flush=True)
                differ, gaps = 0, []
                if blob != one:
                    sa, sb = frame_spans(blob), frame_spans(one)
                    if [n for _, _, n in sa] != [n for _, _, n in sb]:
                        fail(f"{path}: the frames' sizes differ from one "
                             "device's")
                    start = 0
                    for i, ((a0, a1, n), (b0, b1, _)) in enumerate(zip(sa,
                                                                       sb)):
                        if blob[a0:a1] != one[b0:b1]:
                            differ += 1
                            gap = autocorr_gap(cfg, pcm, start, n)
                            gaps.append((i, n, gap))
                            if gap >= K1_REL_TOL:
                                fail(f"{path}: frame {i} differs from one "
                                     "device's, and its sp autocorrelation "
                                     f"is {gap:.3e} from the dense one")
                        start += n
                print(f"{path} ({mesh}) on {card}: {secs:g} s, block sizes "
                      f"{sizes} (folded into dp: {folded}); cold "
                      f"{cold:.3f} s, warm {warm:.3f} s ({secs / warm:.1f}x "
                      f"realtime; one device {secs / walls[1]:.1f}x); "
                      f"{len(blob)} bytes; frames differing from one "
                      f"device's: {differ} (frame, samples, largest relative "
                      f"autocorrelation difference: {gaps}); peak device "
                      f"memory MiB {peaks}; stats "
                      f"{ {k: round(v, 4) for k, v in enc.stats.items()} }",
                      flush=True)

        # one level-8 batch over sp 2 under the profiler
        cfg, pcm = streams["level 8"]
        fcfg = frame.FrameConfig.from_params(cfg.params, 2, 16)
        run, _, _ = mesh_mod.make_sharded_packer(
            fcfg, mesh_mod.make_mesh(devices=meshes["sp 2"], sp=2))
        F = SP_TRACE_FRAMES
        batch = pcm[:F * BLOCK].reshape(F, BLOCK, 2).astype(np.int16)
        hb, hn = bitpack.frame_header_bytes(
            np.arange(F, dtype=np.int64), bs_code=P.blocksize_code(BLOCK),
            sr_code=P.samplerate_code(SAMPLE_RATE), allow_vbs=0)
        run(batch, hn * 8, hb, hn)
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            with profiling.trace(tmp) as prof:
                run(batch, hn * 8, hb, hn)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            files = [(f.name, f.stat().st_size)
                     for f in pathlib.Path(tmp).iterdir()]
        # the device's own events (kernels, copies) are the ops; each sp
        # stage's range appears twice, on the host (its time, and the
        # device time of the kernels launched inside it) and on the device
        # timeline (the range's span there, idle gaps included)
        events = prof.key_averages()
        on_device = torch.autograd.DeviceType.CUDA
        ops = [e for e in events
               if e.device_type == on_device and not e.key.startswith("sp ")]
        if not ops:
            fail("the sp trace holds no op on the device")
        busy = sum(device_ms(e) for e in ops)
        top = sorted(ops, key=device_ms, reverse=True)[:10]
        print(f"sp trace, a level-8 batch of {F} frames over sp 2 on {card}: "
              f"{wall:.3f} s under the profiler, {len(ops)} kinds of device "
              f"op, {busy:.3f} ms of device time, trace {files}; top ten: "
              + "; ".join(f"{e.key[:80]} {device_ms(e):.3f} ms x{e.count}"
                          for e in top), flush=True)
        stages = {}
        for e in events:
            if e.key.startswith("sp "):
                host, inside, span = stages.get(e.key, (0.0, 0.0, 0.0))
                if e.device_type == on_device:
                    span = device_ms(e)
                else:
                    host = e.cpu_time_total / 1000
                    inside = e.device_time_total / 1000
                stages[e.key] = (host, inside, span)
        if not stages:
            fail("the sp trace holds none of the sp stages' ranges")
        print("sp stages in the trace (host ms; device ms of the kernels "
              "inside; the range's span on the device, ms): " + "; ".join(
                  f"{k} {h:.3f}; {i:.3f}; {sp:.3f}"
                  for k, (h, i, sp) in sorted(stages.items())), flush=True)
    finally:
        for mod, name, orig in originals:
            setattr(mod, name, orig)

    # the entry points
    count_launches("dryrun_multichip(4)",
                   lambda: graft_entry.dryrun_multichip(4),
                   ("merge_words", "slot_layout"))
    fn, args = graft_entry.entry()
    out = count_launches("graft entry", lambda: fn(*args),
                         ("autocorr", "sweep_granules", "merge_words",
                          "rice_scan", "final_pass", "candidates",
                          "select_candidate", "frame_head", "slot_layout"))
    if not torch.equal(out["total_bits"].to(torch.int64),
                       8 * out["frame_bytes"]):
        fail("graft entry: total_bits is not 8 x frame_bytes")
    print(f"graft entry: {tuple(out['words'].shape)} words, "
          f"{int(out['frame_bytes'].sum())} bytes of {args[0].shape[0]} "
          "frames", flush=True)


def measurement_paths(card, count_launches) -> None:
    """Section 8, the measurement path, each tool through its entry point
    at full size with the launch counts set to 0 around it: the bench
    (``flake_tpu_torch.bench``: K1, K4, K3, and K2 for its 30 s stream's
    4,088-sample tail), ``bench_matrix`` over its six configs with the
    host/device parity encodes (K1, K4, K3, and K2 for the parity streams'
    tails), ``level_matrix``'s full cells over the 10 s corpus (K1-K4) and
    ``prof_an5``
    at levels 5 (K1 only), 8 and 12 (K1 and K4). Each tool prints its JSON
    lines; a parity miss, a failed decode or a missing launch fails."""
    from flake_tpu_torch import bench
    from flake_tpu_torch.util import bench_matrix, level_matrix, prof_an5

    k1234 = ("autocorr", "sweep_granules", "merge_words", "sweep_sums")
    rice12 = ("rice_scan", "final_pass", "candidates")
    # S wherever LPC runs, H on every dense analysis, E on every device
    # emission; X at the level matrix's FIXED levels
    she = ("select_candidate", "frame_head", "slot_layout")
    t0 = time.perf_counter()
    res = count_launches("bench", lambda: bench.run(device="cuda"),
                         k1234 + rice12 + she)
    if res["e2e_verified"] is not True or res["host_pack_gbps"] is None:
        fail(f"bench: {res}")
    print(f"bench on {card}: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    rows = count_launches("bench matrix",
                          lambda: bench_matrix.run(device="cuda"),
                          k1234 + rice12 + she)
    if [r["config"] for r in rows] != [c[0] for c in bench_matrix.CONFIGS] \
            or any(r["device_pack_parity"] is not True for r in rows):
        fail(f"bench matrix: {rows}")
    print(f"bench matrix on {card}: {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    cells, seconds = count_launches(
        "level matrix",
        lambda: level_matrix.run(device="cuda"),
        k1234 + rice12 + she + ("fixed_search",))
    print(f"level matrix on {card}: {len(cells)} cells of {seconds:g} s, "
          f"each decoded with its MD5, in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for level in (5, 8, 12):
        needs = ("autocorr", "final_pass", "candidates", "select_candidate",
                 "frame_head") \
            if level == 5 else ("autocorr", "sweep_granules") + rice12 \
            + ("select_candidate", "frame_head")
        res = count_launches(
            f"prof_an5 level {level}",
            lambda: prof_an5.run(level, device="cuda"), needs,
            tuple(k for k in k1234 + rice12 if k not in needs))
        if res["sweep_route"] != (None if level == 5 else "K4"):
            fail(f"prof_an5 level {level}: {res}")


def bound(bytes_moved: float, ops: float, ops_per_ms: float):
    """The least ms the card could take for this much work, and which of
    bytes or operations sets it."""
    by_bytes = bytes_moved / HBM_BYTES_PER_MS
    by_ops = ops / ops_per_ms
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def live_tensors(run, top: int = 8):
    """Run ``run()`` with every tensor its operations make recorded (a
    ``TorchDispatchMode``): returns (its result, the most bytes of those
    tensors alive at once, the ``top`` largest of them alive at that
    moment as (operation, shape, dtype, MiB), and the number of
    operations), those under 1% of that peak left out. Bytes are storage
    bytes, so a view or an in-place result counts once; the allocator's
    rounding is not in them."""
    import weakref

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Live(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.live = {}      # storage address -> (refs, op, shape, ...)
            self.peak, self.at_peak, self.ops = 0, [], 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.ops += 1
            given = {t.untyped_storage().data_ptr()
                     for t in tree_leaves((args, kwargs))
                     if isinstance(t, torch.Tensor)}
            for t in tree_leaves(out):
                if not isinstance(t, torch.Tensor):
                    continue
                key = t.untyped_storage().data_ptr()
                if key in given:
                    continue        # a view of an input, or in place
                entry = self.live.get(key)
                if entry and any(r() is not None for r in entry[0]):
                    entry[0].append(weakref.ref(t))
                    continue
                self.live[key] = ([weakref.ref(t)], str(func.__name__),
                                  tuple(t.shape), str(t.dtype),
                                  t.untyped_storage().nbytes())
            self.live = {k: e for k, e in self.live.items()
                         if any(r() is not None for r in e[0])}
            alive = list(self.live.values())
            now = sum(e[4] for e in alive)
            if now > self.peak:
                self.peak = now
                self.at_peak = sorted(
                    ((e[1], e[2], e[3], round(e[4] / 2**20, 1))
                     for e in alive if e[4] * 100 >= now),
                    key=lambda e: -e[3])[:top]
            return out

    mode = Live()
    with mode:
        result = run()
    return result, mode.peak, mode.at_peak, mode.ops


def build_yardsticks():
    """Build ``flake_tpu_torch/csrc/yardsticks`` (the first designs of K1-K4,
    of ``merge_v2``, ``merge_v3``, ``merge_v5a``, ``merge_v5b``,
    ``merge_v5d``, ``merge_v5c`` and of the zero floor, the combined-node
    merge with its spill sets read by flagged columns, the row-layout merges
    at other geometries, K4's design on the integer pipes, the zero floor by
    bulk asynchronous stores, the first designs of L, E, S, H and X and the
    card's rate and latency probes) into a library of their own, one nvcc a
    source, all started together. Returns (the compiler's report, a dict of functions):
    ``k1_before`` to ``k4_before``, ``v2_before``, ``v3_before``,
    ``v5a_before``, ``v5b_before``, ``v5d_before`` and ``v5c_before`` take
    the wrappers' arguments and launch the first designs (K3's zeroes its
    words first, as its wrapper did), ``v5_columns`` takes ``merge_v5a``'s
    and reads the spill sets by columns, ``rows_form(dual, threads, stage_spill,
    blocks, operands, word_rows)`` launches ``merge_v5d`` (``dual`` 0) or
    ``merge_v5c`` (1) in another form, ``zero_before(F, word_rows, fb)`` and
    ``zero_bulk(F, word_rows)`` write the zero floor, ``k4_int`` is K4's
    design on the integer pipes, ``launch_floor(blocks, threads)``
    launches an empty kernel, ``r1_before`` takes ``rice_scan``'s arguments
    and ``r2_before`` a residual with ``rice_final_plain``'s (R1's and
    R2's first designs); ``l_before`` takes ``lpc.candidates``' arguments
    and ``e_before`` ``bitpack.slot_layout``'s (L's and E's first
    designs), ``s_before`` ``frame.select_order_bits``', ``h_before``
    ``frame.frame_head``'s and ``x_before`` ``rice.fixed_search``'s (S's,
    H's and X's); ``mad_wide``, ``imad`` and ``dfma`` measure the card's rate
    of each operation, in operations a ms, and the latency probes the ms
    of one dependent operation: ``dadd_latency`` and ``fadd_latency`` a
    float64 and a float32 add, ``ddiv_latency`` and ``fdiv_latency`` a
    correctly rounded division, ``dtrunc_latency`` and ``ftrunc_latency``
    a truncation and the add after it, ``shfl_latency`` a float64
    shuffle."""
    import concurrent.futures
    import ctypes

    import torch
    from flake_tpu_torch import _build, _cuda

    srcs = sorted((ROOT / "flake_tpu_torch" / "csrc" / "yardsticks")
                  .glob("*.cu"))
    lib_path = _build.BUILD_DIR / "libflake_yardsticks.so"
    # one nvcc a source, all started together, then one link
    objs = [_build.BUILD_DIR / f"yardstick_{src.stem}.o" for src in srcs]
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        reports = list(pool.map(
            lambda src, obj: _build.build(
                [_cuda.nvcc(), *_cuda.ARCH, "-std=c++17", "-O3", "-Xcompiler",
                 "-fPIC", "-Xptxas", "-v", "-c"], [src], obj), srcs, objs))
    report = "".join(reports) + _build.build(
        [_cuda.nvcc(), *_cuda.ARCH, "-shared"], objs, lib_path)
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
    for probe in ("dadd", "fadd", "ddiv", "fdiv", "dtrunc", "ftrunc",
                  "shfl"):
        getattr(lib, f"flake_latency_{probe}").argtypes = [P, I, P]
    lib.flake_slot_layout_v1.argtypes = [P] * 17 + [I] * 8 + [P]
    lib.flake_lpc_candidates_v1.argtypes = [P] * 4 + [I] * 5 + [P]
    lib.flake_rice_scan_v1.argtypes = [P] * 6 + [I] * 7 + [P]
    lib.flake_rice_final_v1.argtypes = [P] * 7 + [I] * 6 + [P]
    lib.flake_select_order_v1.argtypes = [P, P] + [I] * 5 + [P]
    lib.flake_frame_head_v1.argtypes = [P] * 6 + [I] * 5 + [P]
    lib.flake_fixed_search_v1.argtypes = [P] * 4 + [I] * 9 + [P]

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

    def search_args(n, pmin, pmax):
        from flake_tpu_torch.ops import rice

        ps = rice.limit_max_partition_order(pmax, n, 1)
        return ps, (n, pmin, pmax, ps, rice.log2i(n ^ (n - 1)))

    def r1_before(sums, order, n, pmin, pmax):
        batch, G = sums.shape[:-1], sums.shape[-1]
        R = batch.numel()
        ps, ints = search_args(n, pmin, pmax)
        out = [torch.empty(R, dtype=torch.int64, device=sums.device)] + [
            torch.empty(R, dtype=torch.int32, device=sums.device)
            for _ in range(2)] + [torch.empty(
                (R, 1 << ps), dtype=torch.int32, device=sums.device)]
        call(lib.flake_rice_scan_v1, sums.contiguous(),
             order.expand(batch).contiguous(), *out, R, G, *ints)
        return tuple(t.reshape(batch + t.shape[1:]) for t in out)

    def r2_before(res, order, n, pmin, pmax):
        batch = res.shape[:-1]
        N = batch.numel()
        ps, ints = search_args(n, pmin, pmax)
        out = {"bits": torch.empty(N, dtype=torch.int64, device=res.device),
               "porder": torch.empty(N, dtype=torch.int32, device=res.device),
               "method": torch.empty(N, dtype=torch.int32, device=res.device),
               "params": torch.empty((N, 1 << ps), dtype=torch.int32,
                                     device=res.device),
               "exact_rice_bits": torch.empty(N, dtype=torch.int64,
                                              device=res.device)}
        call(lib.flake_rice_final_v1, res.contiguous(), order.contiguous(),
             *out.values(), N, *ints)
        return {k: v.reshape(batch + v.shape[1:]) for k, v in out.items()}

    def l_before(autoc, est, precision):
        from flake_tpu_torch.ops import lpc

        ins, outs, ints, batch = lpc.candidates_operands(autoc, est,
                                                         precision)
        call(lib.flake_lpc_candidates_v1, *ins, *outs, *ints)
        m = ints[1]
        return (outs[0].reshape(batch + (m, m)),
                outs[1].reshape(batch + (m,)), outs[2].reshape(batch + (m,)))

    def e_before(analysis, hdr_bytes, hdr_nbytes, cfg):
        from flake_tpu_torch.ops import bitpack

        ins, outs, ints = bitpack.slot_operands(analysis, hdr_bytes,
                                                hdr_nbytes, cfg)
        call(lib.flake_slot_layout_v1, *ins, *outs, *ints)
        return outs

    def s_before(bits, method, min_o, max_o):
        N, m = bits.shape
        order = torch.empty(N, dtype=torch.int32, device=bits.device)
        call(lib.flake_select_order_v1, bits, order, N, m, int(method), min_o,
             max_o)
        return order

    def h_before(samples, cfg):
        from flake_tpu_torch.ops import frame

        F, n, C = samples.shape
        outs = (torch.empty((F, C, n), dtype=torch.int32, device="cuda"),
                *(torch.empty((F, C), dtype=torch.int32, device="cuda")
                  for _ in range(2)),
                torch.empty(F, dtype=torch.int32, device="cuda"),
                torch.empty((F, C), dtype=torch.bool, device="cuda"))
        call(lib.flake_frame_head_v1, samples, *outs, F, n, C, cfg.bps,
             int(frame._stereo_estimate(cfg)))
        return outs

    def x_before(chans, obits, min_o, max_o, pmin, pmax):
        from flake_tpu_torch.ops import rice

        batch, n = chans.shape[:-1], chans.shape[-1]
        N = batch.numel()
        order = torch.empty(N, dtype=torch.int32, device=chans.device)
        coefs = torch.empty((N, max_o), dtype=torch.int32, device=chans.device)
        call(lib.flake_fixed_search_v1, chans.contiguous(),
             obits.contiguous(), order, coefs, N, n, min_o, max_o, max_o,
             *rice._search_args(n, pmin, pmax)[1:])
        return order.reshape(batch), coefs.reshape(batch + (max_o,))

    def rate(fn, dtype):
        """Operations a ms of ``fn`` on 8 blocks of 256 threads an SM."""
        blocks, threads, iters = 8 * 132, 256, 256
        out = torch.empty(blocks * threads, dtype=dtype, device="cuda")
        ms, = time_turns(lambda: call(fn, out, blocks, threads, iters))
        return blocks * threads * iters * 8 * 16 / ms

    def latency(fn, dtype):
        """ms of one add of ``fn``'s dependent chain (one warp)."""
        iters = 1 << 14
        out = torch.empty(32, dtype=dtype, device="cuda")
        ms, = time_turns(lambda: call(fn, out, iters), reps=5)
        return ms / (iters * 16)

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
        "r1_before": r1_before, "r2_before": r2_before,
        "mad_wide": lambda: rate(lib.flake_rate_mad_wide, torch.int64),
        "imad": lambda: rate(lib.flake_rate_imad, torch.int32),
        "dfma": lambda: rate(lib.flake_rate_dfma, torch.float64),
        "l_before": l_before, "e_before": e_before, "s_before": s_before,
        "h_before": h_before, "x_before": x_before,
        **{f"{probe}_latency": (
            lambda probe=probe: latency(
                getattr(lib, f"flake_latency_{probe}"),
                torch.float32 if probe[0] == "f" else torch.float64))
           for probe in ("dadd", "fadd", "ddiv", "fdiv", "dtrunc", "ftrunc",
                         "shfl")}}


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
    import hashlib

    t_smoke = time.perf_counter()
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

    from flake_tpu_torch import _cuda, cli, decoder, native, wavinfo
    from flake_tpu_torch import params as P
    from flake_tpu_torch.io import open_pcm
    from flake_tpu_torch.io.wav import write_wave
    from flake_tpu_torch.encoder import Encoder, vbs_layout, vbs_section_sums
    from flake_tpu_torch.ops import autocorr as k1_mod
    from flake_tpu_torch.ops import bitmerge as k3_mod
    from flake_tpu_torch.ops import bitpack, frame, lpc, predict, rice
    from flake_tpu_torch.ops import stereo, wasted
    from flake_tpu_torch.ops import sweep as sweep_mod
    from flake_tpu_torch.ops.common import wrap_int32
    from flake_tpu_torch.parallel import mesh as mesh_mod
    from flake_tpu_torch.util import prof_merge as tool
    from flake_tpu_torch.util import prof_merge2 as tool2
    from flake_tpu_torch.util import prof_merge3 as tool3

    if "jax" in sys.modules:
        fail("importing flake_tpu_torch (its io, wavinfo and cli "
             "included) imported jax")

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
    for probe in ("dadd", "fadd", "ddiv", "fdiv", "dtrunc", "ftrunc",
                  "shfl"):
        rates[f"{probe}_latency_ms"] = yard[f"{probe}_latency"]()
    # the truncation probes time a truncation and the add after it
    rates["dtrunc_latency_ms"] -= rates["dadd_latency_ms"]
    rates["ftrunc_latency_ms"] -= rates["fadd_latency_ms"]
    print(f"latency on {card}, ns a dependent operation: "
          f"float64 add {rates['dadd_latency_ms'] * 1e6:.3f}, float32 add "
          f"{rates['fadd_latency_ms'] * 1e6:.3f}, float64 division "
          f"{rates['ddiv_latency_ms'] * 1e6:.3f}, float32 division "
          f"{rates['fdiv_latency_ms'] * 1e6:.3f}, float64 truncation "
          f"{rates['dtrunc_latency_ms'] * 1e6:.3f}, float32 truncation "
          f"{rates['ftrunc_latency_ms'] * 1e6:.3f}, float64 shuffle "
          f"{rates['shfl_latency_ms'] * 1e6:.3f}", flush=True)
    t0 = time.perf_counter()
    native.build()
    native.get_verifier()
    print(f"build packer.cpp and verifier.cpp: "
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
        record the arguments of its calls: name -> list, in call order. A
        wrapper carries its function's attributes: a kernel wrapper counts
        its launches on the name it looks itself up by."""
        got = {}
        originals = [(mod, name, getattr(mod, name)) for mod, name in hooks]

        def wrap(name, orig):
            @functools.wraps(orig)
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
         (bitpack, "merge_words"), (rice, "rice_scan"),
         (frame, "final_pass"), (lpc, "candidates"),
         (frame, "select_candidate"), (frame, "frame_head"),
         (bitpack, "slot_layout")],
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

    def cmp_bits(name, a, b):
        """Every output of a tuple equal in dtype, shape and bits, two
        NaNs counting as equal (a silent stream's Schur gives NaNs)."""
        same = True
        for u, v in zip(a, b):
            if u.dtype != v.dtype or u.shape != v.shape:
                same = False
            elif u.is_floating_point():
                nan = u.isnan() & v.isnan()
                bits = torch.int64 if u.dtype == torch.float64 \
                    else torch.int32
                same &= torch.equal(torch.where(nan, 0, u.view(bits)),
                                    torch.where(nan, 0, v.view(bits)))
            else:
                same &= torch.equal(u, v)
        return 0.0, bool(same), f"bit-exact {bool(same)} (NaNs equal)"

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
         (bitpack, "merge_words"), (rice, "rice_scan"),
         (frame, "final_pass"), (lpc, "candidates"),
         (frame, "select_candidate"), (frame, "frame_head"),
         (bitpack, "slot_layout")],
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

    # -- 4a. R1 and R2 on the level-8 batch, the level-12 bucket, tables -----
    def r1_ops(sums, order, n, pmax):
        """R1's int32 operations on these sums (the work depends on the
        data): each partition of every level 0..pmax_static of each row
        costs about 20 in closed form (the subtraction, two bit lengths,
        a shift, a compare, the count and the level's sum) and 31 counts
        of six (an add for the count, a funnel shift, an add, a compare,
        two selects) where the closed form does not apply. Returns those
        operations, the first design's (31 x 6 for every partition) and
        the share of the partitions in closed form."""
        ps = rice.limit_max_partition_order(pmax, n, 1)
        rows = sums.reshape(-1, 1 << ps, sums.shape[-1] >> ps).sum(-1)
        order = order.expand(sums.shape[:-1]).reshape(-1, 1).to(torch.int64)
        scan = 0
        for p in range(ps, -1, -1):
            cnt = torch.full_like(rows, n >> p)
            cnt[:, 0] -= order[:, 0]
            t = rows - (cnt >> 1)
            applies = (cnt >= 1) & ((t < 0) | (t + 31 * cnt < 1 << 32))
            scan += int((~applies).sum())
            rows = rows[:, 0::2] + rows[:, 1::2] if p else rows
        parts = order.shape[0] * ((2 << ps) - 1)
        return ((parts - scan) * 20 + scan * 31 * 6, parts * 31 * 6,
                1 - scan / parts)

    def r2_ops(smp, coefs, order, n, pmax):
        """R2's int32 operations: each tap of a sample past the warm-up
        one 32x32->64-bit multiply-add, counted as two, about eight a
        sample more (the shift, the wrap, the zigzag, the partition sum,
        the exact pass's shift and adds) and R1's closed-form search of
        each stream's pyramid."""
        o = order.reshape(-1).to(torch.int64)
        taps = torch.clamp(o, max=coefs.shape[-1])
        ps = rice.limit_max_partition_order(pmax, n, 1)
        rows = o.numel()
        return int((2 * taps * torch.clamp(n - o, min=0)).sum()) \
            + 8 * rows * n + rows * ((2 << ps) - 1) * 20

    def lag_loop(smp, coefs, shift, order):
        """The torch lag loop that fed R2's first design: the exact
        residual, its wrap and its fit check."""
        res64 = predict.residual_lpc_dynamic64(smp, coefs, shift, order,
                                               coefs.shape[-1])
        return wrap_int32(res64), predict.fits_int32(res64)

    def replaced_pass(smp, coefs, shift, order, n, pmin, pmax):
        """The final pass R2 replaced: the lag loop, then R2's first design
        (csrc/yardsticks/rice_v1.cu) on its residual; R2's outputs in R2's
        order."""
        res, fits = lag_loop(smp, coefs, shift, order)
        out = yard["r2_before"](res, order, n, pmin, pmax)
        return (*out.values(), res, fits)

    def as_tuple(fn):
        """R2's dict as a tuple, for cmp_exact."""
        return lambda *args: tuple(fn(*args).values())

    rice_held = {"rice_scan": (rice.rice_scan, rice.rice_scan_plain),
                 "final_pass": (as_tuple(rice.final_pass),
                                as_tuple(rice.final_pass_plain))}
    rice_replaces = {
        "rice_scan": "flake_tpu/ops/rice.py:222 (_dynamic_porder_scan with "
                     "_fold_pyramid :213 and find_optimal_k_u32 :109; no "
                     "pl.pallas_call)",
        "final_pass": "flake_tpu/ops/rice.py:314 (calc_rice_params_dynamic "
                      "after predict.residual_lpc_dynamic :84; no "
                      "pl.pallas_call)"}

    def r1_args(args):
        """The main path's arguments with the order laid out as the
        kernel reads it (R1's callers pass a broadcast view, which the
        wrapper would copy inside the timing)."""
        data, order, *rest = args
        return (data, order.expand(data.shape[:-1]).contiguous(), *rest)

    def r1_at(label, args, entry):
        """R1 and its first design held against the plain version on
        ``args`` and timed with it in turns; bounds by bytes and by the
        operations these sums need (``r1_ops``), and by the first design's
        scan operations, into ``entry``."""
        sums, order, n, _, pmax = args
        for fn in (rice.rice_scan, yard["r1_before"]):
            _, detail = check("rice_scan", lambda fn=fn: fn(*args),
                              lambda: rice.rice_scan_plain(*args), cmp_exact)

        def kern():
            return rice.rice_scan(*args)

        def before():
            return yard["r1_before"](*args)

        def plain():
            return rice.rice_scan_plain(*args)

        entry["plain_ms"], entry["ms"], entry["ms_before"] = time_turns(
            plain, kern, before, loop=(plain,))
        moved = nbytes(sums, order) + nbytes(*kern())
        ops, scan_ops, entry["closed_form_share"] = r1_ops(sums, order, n,
                                                           pmax)
        entry["bound_ms"], entry["bound_by"] = bound(moved, ops,
                                                     INT32_OPS_PER_MS)
        entry["bytes_bound_ms"] = moved / HBM_BYTES_PER_MS
        entry["scan_ops_bound_ms"] = scan_ops / INT32_OPS_PER_MS
        entry["shape"] = list(sums.shape)
        print(f"rice_scan on {label} {tuple(sums.shape)}: {detail}; kernel "
              f"{entry['ms']:.4f} ms (first design {entry['ms_before']:.4f} "
              f"ms), plain {entry['plain_ms']:.4f} ms; bounds: bytes "
              f"{entry['bytes_bound_ms']:.4f} ms ({moved / 1e6:.1f} MB), "
              f"this data's operations {ops / INT32_OPS_PER_MS:.4f} ms "
              f"({ops / 1e9:.3f} G), the first design's scan operations "
              f"{entry['scan_ops_bound_ms']:.4f} ms; closed form on "
              f"{entry['closed_form_share']:.4f} of the partitions",
              flush=True)

    def r2_at(label, args, entry):
        """R2 held against its plain version and against the lag loop with
        R2's first design on ``args``; R2 at 128, 256 and 512 threads a
        block, without its taps and with one partition, the first design
        alone on the lag loop's residual, the lag loop alone, the two
        together and the plain version timed in turns;
        the bound by bytes (samples in, residual and results out) and by
        ``r2_ops``, into ``entry``."""
        smp, coefs, shift, order, n, pmin, pmax = args
        kern = as_tuple(rice.final_pass)
        plain = as_tuple(rice.final_pass_plain)
        _, detail = check("final_pass", lambda: kern(*args),
                          lambda: plain(*args), cmp_exact)
        check("final_pass", lambda: replaced_pass(*args),
              lambda: plain(*args), cmp_exact)
        res, _ = lag_loop(smp, coefs, shift, order)

        def at_threads(threads):
            def run():
                rice.FINAL_THREADS = threads
                try:
                    return kern(*args)
                finally:
                    rice.FINAL_THREADS = chosen
            return run

        chosen = rice.FINAL_THREADS
        forms = {t: at_threads(t) for t in (128, 256, 512)}
        for t, fn in forms.items():
            check("final_pass", fn, lambda: plain(*args), cmp_exact)

        def run_plain():
            return plain(*args)

        def loop_only():
            return lag_loop(smp, coefs, shift, order)

        def before():
            return replaced_pass(*args)

        def before_kernel():
            return yard["r2_before"](res, order, n, pmin, pmax)

        # R2 without its taps, with one partition, and with neither: what
        # the residual's multiply-adds and the search at ps cost
        no_taps = coefs[..., :0].contiguous()
        phases = {"no taps": lambda: kern(smp, no_taps, shift, order, n,
                                          pmin, pmax),
                  "one partition": lambda: kern(smp, coefs, shift, order, n,
                                                0, 0),
                  "no taps, one partition": lambda: kern(
                      smp, no_taps, shift, order, n, 0, 0)}
        others = [t for t in forms if t != chosen]
        times = time_turns(run_plain, forms[chosen], before, before_kernel,
                           loop_only, *(forms[t] for t in others),
                           *phases.values(),
                           loop=(run_plain, before, loop_only))
        (entry["plain_ms"], entry["ms"], entry["ms_before"],
         entry["ms_before_kernel"], entry["lag_loop_ms"]) = times[:5]
        entry["forms_ms"] = {chosen: entry["ms"],
                             **dict(zip(others, times[5:7]))}
        entry["phases_ms"] = dict(zip(phases, times[7:]))
        moved = nbytes(smp, coefs, shift, order) + nbytes(*kern(*args))
        ops = r2_ops(smp, coefs, order, n, pmax)
        entry["bound_ms"], entry["bound_by"] = bound(moved, ops,
                                                     INT32_OPS_PER_MS)
        entry["shape"] = list(smp.shape)
        entry["max_order"] = coefs.shape[-1]
        print(f"final_pass on {label} {tuple(smp.shape)}, {coefs.shape[-1]} "
              f"taps: {detail}; kernel {entry['ms']:.4f} ms at {chosen} "
              f"threads, {entry['forms_ms']} by threads; the lag loop and "
              f"R2's first design {entry['ms_before']:.4f} ms (the lag loop "
              f"{entry['lag_loop_ms']:.4f}, the first design alone "
              f"{entry['ms_before_kernel']:.4f}); by phase "
              f"{ {k: round(v, 4) for k, v in entry['phases_ms'].items()} } "
              f"ms; plain {entry['plain_ms']:.4f} ms; bound "
              f"{entry['bound_ms']:.4f} ms "
              f"by {entry['bound_by']} ({moved / 1e6:.1f} MB, {ops / 1e9:.3f} "
              "G operations)", flush=True)

    for name, at in (("rice_scan", r1_at), ("final_pass", r2_at)):
        args = cap8[name][0]
        args = r1_args(args) if name == "rice_scan" else args
        entry = {"name": name, "route": "cuda",
                 "source": "flake_tpu_torch/csrc/rice.cu",
                 "replaces": rice_replaces[name], "library_ms": None,
                 "timed": {"ms": "back_to_back", "plain_ms": "loop"}}
        at("the level-8 batch", args, entry)
        entry["max_abs_err"] = 0.0
        at12 = {}
        args = cap12[name][0]
        at(f"the level-12 {vbs} bucket",
           r1_args(args) if name == "rice_scan" else args, at12)
        entry[f"level12_{vbs}"] = at12
        kernels.append(entry)

    # made-up tables: rows of 8 small partition sums (n 64, pmax 3), where
    # about 5% tie in the partition-order scan and most in some k scan; rows
    # at the level-12 shape of sums from 2^32 up (the limb form's high half,
    # counts that wrap uint32); for R2, 32-bit samples at the int32 limits
    # under order-32 coefficients near +-2^14 and shift 15 (exact residuals
    # past int32 on some rows: fits false), orders 0..32 on 777-, 16,384-
    # (past R2's shared-memory row), 20- and 3-sample rows, samples of -2..2
    # (ties), and the fixed predictors
    trng = np.random.default_rng(SEED + 15)
    small = trng.integers(0, 1 + (1 << trng.integers(0, 5, (20000, 1))) * 8,
                          (20000, 8))
    small[:, 4:] *= trng.integers(1, 6, (20000, 1))
    big = trng.integers(1 << 32, 8192 << 32, (4096, 256))
    for label, (data, order, n, pmin, pmax) in (
            ("ties, n 64", (small, trng.integers(0, 5, 20000), 64, 0, 3)),
            ("sums from 2^32, n 8192",
             (big, np.tile(np.arange(1, 33), 128), 8192, 0, 8))):
        args = (torch.from_numpy(data).to(dev),
                torch.from_numpy(order).to(dev, torch.int32), n, pmin, pmax)
        _, detail = check("rice_scan", lambda: rice.rice_scan(*args),
                          lambda: rice.rice_scan_plain(*args), cmp_exact)
        print(f"rice_scan on the made-up table ({label}, "
              f"{tuple(args[0].shape)}): {detail} against the plain version",
              flush=True)

    def pass_table(n, rows, orders, taps, limits, fixed):
        """R2's made-up rows: samples (at the int32 limits, or of -2..2),
        coefficients near +-2^14 with shift 15 (or the fixed predictors'
        with shift 0), each order of ``orders`` on ``rows`` rows."""
        order = np.repeat(np.asarray(orders, np.int32), rows)
        N = order.size
        if limits:
            smp = trng.choice(np.array([-2**31, -2**30 - 1, -2**30,
                                        2**30 - 1, 2**30, 2**31 - 1]), (N, n))
            smp[::2] = trng.integers(-2**31, 2**31, (len(smp[::2]), n))
        else:
            smp = trng.integers(-2, 3, (N, n))
        if fixed:
            coefs = predict.fixed_coefs(torch.from_numpy(order), taps)
            shift = np.zeros(N, np.int32)
        else:
            coefs = torch.from_numpy(trng.integers(
                2**14 - 64, 2**14, (N, taps)) * trng.choice([-1, 1],
                                                            (N, taps)))
            shift = np.full(N, 15, np.int32)
        return (torch.from_numpy(smp.astype(np.int32)).to(dev),
                coefs.to(dev, torch.int32), torch.from_numpy(shift).to(dev),
                torch.from_numpy(order).to(dev))

    for label, n, table, pmax in (
            ("32-bit at the int32 limits, order-32 coefficients, shift 15, "
             "n 4096", 4096, (16, range(33), 32, True, False), 6),
            ("orders 0-32, n 777", 777, (8, range(33), 32, True, False), 8),
            ("orders 0-32, n 16384, past R2's shared-memory row", 16384,
             (2, range(33), 32, True, False), 8),
            ("orders 0-20, n 20", 20, (16, range(21), 32, True, False), 8),
            ("orders 0-3, n 3", 3, (16, range(4), 4, True, False), 8),
            ("samples -2..2, n 64", 64, (512, range(5), 4, False, True), 3),
            ("fixed predictors at the int32 limits, n 1152", 1152,
             (64, range(5), 4, True, True), 8)):
        args = (*pass_table(n, *table), n, 0, pmax)
        got = rice.final_pass(*args)
        _, detail = check("final_pass", lambda: as_tuple(rice.final_pass)(
            *args), lambda: as_tuple(rice.final_pass_plain)(*args), cmp_exact)
        unfit = int((~got["fits"]).sum())
        print(f"final_pass on the made-up table ({label}, "
              f"{tuple(args[0].shape)}): {detail} against the plain version; "
              f"{unfit} rows whose exact residual leaves int32", flush=True)
        if n == 4096 and not 0 < unfit < args[0].shape[0]:
            fail(f"the made-up R2 table ({label}) did not reach both values "
                 f"of the fit flag: {unfit} rows unfit")

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
        [(frame, "autocorr"), (bitpack, "merge_words"), (lpc, "candidates")],
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

    # -- 4c. L, the coefficient stage --------------------------------------
    def chain_ops(m, est):
        """The operations on one stream's dependent path through L's
        necessary work, by kind, a lower bound on its time at each kind's
        probed latency (a multiply, an FMA, a subtraction, a compare or a
        conversion counts as an add; no shuffle counts, since moving a
        value between lanes is no part of the work). Levinson: order 0's
        subtraction and division; order i >= 1's update FMA, its first
        product, the fold of i adds (left to right, the plain version's
        rounding), the subtraction and the division; under EST a Schur step
        is one FMA (after the first) and the division. Then the last
        order's update, the last row's quantizer: its largest magnitude as
        a tree of ceil(log2 m) compares, the shift search (the float32
        image, a product and a compare), and a tap's error feedback (two
        adds, the truncation, the clamp's compare and the subtraction) on
        each of its m taps. The scale-down's division, which only rows
        whose largest tap passes qmax at shift 0 take, is not counted."""
        rec = m - 1 if est else 2 * (m - 1) + m * (m - 1) // 2 + m
        quant = 1 + (m - 1).bit_length() + 3 + 4 * m
        return {"add": rec + quant, "div": m, "trunc": m}

    def l_ops(N, m, est):
        """L's float operations on N streams: Levinson order i's i
        products, i adds and i update multiply-adds (two each) and about
        six more; under EST m Schur steps of two multiply-adds a lane and
        the seeded updates; the quantizer's six a valid tap."""
        rec = 4 * m * m if est else 2 * m * (m - 1) + 6 * m
        if est:
            rec += m * (m - 1)
        return N * (rec + 3 * m * (m + 1))

    def l_at(label, args, entry):
        """L and its first design held against the plain version on
        ``args`` (autoc, est, precision) and timed with it and the launch
        floor of its grid in turns; bounds by bytes, by operations and by
        the dependent chain at each operation's probed latency, into
        ``entry``."""
        autoc, est, precision = args
        for fn in (lpc.candidates, yard["l_before"]):
            _, detail = check("candidates", lambda fn=fn: fn(*args),
                              lambda: lpc.candidates_plain(*args), cmp_bits)
        N, m = autoc.shape[0], autoc.shape[-1] - 1
        grid = ((N + 31) // 32, 512)

        def kern():
            return lpc.candidates(*args)

        def before():
            return yard["l_before"](*args)

        def plain():
            return lpc.candidates_plain(*args)

        def floor():
            yard["launch_floor"](*grid)

        entry["plain_ms"], entry["ms"], entry["ms_before"], \
            entry["launch_floor_ms"] = time_turns(plain, kern, before, floor,
                                                  loop=(plain,))
        moved = nbytes(autoc) + nbytes(*kern())
        entry["bound_ms"], entry["bound_by"] = bound(
            moved, l_ops(N, m, est), FP64_OPS_PER_MS
            if autoc.dtype == torch.float64 else FP32_OPS_PER_MS)
        chain = chain_ops(m, est)
        prefix = "d" if autoc.dtype == torch.float64 else "f"
        entry["chain_ops"] = chain
        entry["chain_bound_ms"] = sum(
            count * rates[f"{prefix}{kind}_latency_ms"]
            for kind, count in chain.items())
        entry["shape"] = list(autoc.shape)
        entry["est"], entry["dtype"] = bool(est), str(autoc.dtype)
        print(f"candidates on {label} {tuple(autoc.shape)}, "
              f"{'EST' if est else 'Levinson'}, {autoc.dtype}: {detail}; "
              f"kernel {entry['ms']:.4f} ms (first design "
              f"{entry['ms_before']:.4f} ms), plain {entry['plain_ms']:.4f} "
              f"ms, the launch floor of its grid {grid} "
              f"{entry['launch_floor_ms']:.4f} ms; bounds: "
              f"{entry['bound_ms']:.5f} ms by {entry['bound_by']} "
              f"({moved / 1e6:.2f} MB, {l_ops(N, m, est) / 1e9:.4f} G "
              f"operations), the dependent chain {chain} = "
              f"{entry['chain_bound_ms']:.5f} ms at the probed latencies",
              flush=True)

    l_entry = {"name": "candidates", "route": "cuda",
               "source": "flake_tpu_torch/csrc/lpc.cu",
               "replaces": "flake_tpu/ops/lpc.py:174 (levinson_all_orders; "
                           "under EST schur_refs :242 and levinson_from_refs "
                           ":271; then quantize_lpc_coefs :307; no "
                           "pl.pallas_call)",
               "library_ms": None, "max_abs_err": 0.0,
               "timed": {"ms": "back_to_back", "plain_ms": "loop"}}
    l_at("the level-8 batch", cap8["candidates"][0], l_entry)
    x8, _, mo8 = cap8["autocorr"][0]
    ac32 = lpc.autocorr(x8, mo8, lpc.welch_window_on(x8.shape[1], dev,
                                                     torch.float32))
    for key, label, args in (
            (f"level12_{vbs}", f"the level-12 {vbs} bucket",
             cap12["candidates"][0]),
            ("level5_est", "the level-5 batch", cap5["candidates"][0]),
            ("level8_float32", "the level-8 batch in float32",
             (ac32, False, cap8["candidates"][0][2]))):
        l_entry[key] = {}
        l_at(label, args, l_entry[key])
    kernels.append(l_entry)

    # made-up tables: autocorrelations [1, c, 0, 0, 0], whose first row is
    # c, at the quantizer's edges for every precision 5-15 (0, subnormals,
    # powers of two, qmax * 2^-sh and its neighbours, above qmax), and
    # degenerate ones (zero, negative, inf and NaN lags), in both dtypes
    # and both modes
    edge_rows = []
    for precision in range(5, 16):
        qmax = (1 << (precision - 1)) - 1
        edges = [qmax * 2.0 ** -sh for sh in range(16)] \
            + [2.0 ** k for k in range(-20, 21)] \
            + [qmax + 0.5, qmax + 1.0, 2.0 * qmax, 1e6, 1e30, 1e300]
        c = [0.0, -0.0, 5e-324, 1e-310, 2.2250738585072014e-308]
        for e in edges:
            c += [np.nextafter(e, 0.0), e, np.nextafter(e, np.inf)]
        c = np.asarray(c)
        edge_rows.append((precision, np.concatenate([c, -c[c != 0]])))
    drng = np.random.default_rng(SEED + 17)
    degenerate = drng.normal(0, 1, (64, 33)) \
        * 10.0 ** drng.integers(-5, 6, (64, 1))
    degenerate[:, 0] = np.abs(degenerate[:, 0])
    degenerate[0], degenerate[1], degenerate[2, 0] = 0.0, 2.0, 0.0
    degenerate[3, 0], degenerate[4, 3], degenerate[5, 2] = -1.0, np.inf, \
        np.nan
    held_tables = 0
    for dtype in (torch.float64, torch.float32):
        for est in (False, True):
            for precision, c in edge_rows:
                table = np.zeros((c.size, 5))
                table[:, 0], table[:, 1] = 1.0, c
                args = (torch.from_numpy(table).to(dev, dtype), est,
                        precision)
                check("candidates", lambda: lpc.candidates(*args),
                      lambda: lpc.candidates_plain(*args), cmp_bits)
                held_tables += 1
            args = (torch.from_numpy(degenerate).to(dev, dtype), est, 15)
            check("candidates", lambda: lpc.candidates(*args),
                  lambda: lpc.candidates_plain(*args), cmp_bits)
            held_tables += 1
    print(f"candidates on {held_tables} made-up tables (the shift search's "
          "edges at precisions 5-15, degenerate autocorrelations; float64 "
          "and float32, Levinson and EST): bit-exact against the plain "
          "version", flush=True)

    # -- 4d. the EST recursions on the card and on the host --------------------
    # XLA:CPU fuses every multiply-add of Schur and Levinson, and the port
    # writes them as torch.addcmul; the card must round them the same way
    gen = torch.Generator().manual_seed(SEED)
    for dtype in (torch.float64, torch.float32):
        fa, fb, fc = (torch.randn(1 << 20, dtype=torch.float64,
                                  generator=gen).to(dtype) for _ in range(3))
        on_card = torch.addcmul(fa.to(dev), fb.to(dev), fc.to(dev)).cpu()
        print(f"addcmul on 2^20 {dtype} triples: "
              f"{int((on_card != torch.addcmul(fa, fb, fc)).sum())} differ "
              f"between card and host; {int((on_card != fa + fb * fc).sum())}"
              " differ from the unfused a + b*c", flush=True)
    nan = torch.tensor([float("nan")], dtype=torch.float64, device=dev)
    print(f"a NaN to int32 on the card: float64 {int(nan.to(torch.int32))}, "
          f"float32 {int(nan.float().to(torch.int32))} (ops/lpc maps a NaN "
          "tap to 0 before the cast, and so does L)", flush=True)
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

    # -- 4e. S, X, H and E: the analysis's and the emission's launch chains --
    def frame_kernel(name, source, replaces, kern, plain, shapes,
                     before=None, library=None, floor=None):
        """One of X, H and E held against its plain version bit for bit on
        each of ``shapes`` (key, label, args, reads, ops) and timed with it
        in turns (the kernel back to back, the plain version in a plain
        loop, as the analysis calls it); its bound from the bytes of
        ``reads`` (read once) and of its outputs (written once) and ``ops``
        int32 operations, and the kernel's share of it. ``before``, a first
        design taking the same arguments, is held and timed beside it
        (``ms_before``); ``library`` maps a key to (the call's name, a
        function of the shape's arguments), one PyTorch call of the same
        function, timed back to back beside it; ``floor``, a function of
        the arguments, launches an empty kernel on the kernel's grid
        (``launch_floor_ms``). The first shape is the entry's own, the
        others go under their keys."""
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "library_ms": None,
                 "max_abs_err": 0.0,
                 "timed": {"ms": "back_to_back", "plain_ms": "loop"}}
        for key, label, args, reads, ops in shapes:
            _, detail = check(name, lambda: kern(*args),
                              lambda: plain(*args), cmp_exact)
            fns = [lambda: plain(*args), lambda: kern(*args)]
            if before is not None:
                check(name, lambda: before(*args), lambda: plain(*args),
                      cmp_exact)
                fns.append(lambda: before(*args))
            if floor is not None:
                fns.append(lambda: floor(*args))
            lib_name, lib_fn = (library or {}).get(key, (None, None))
            if lib_fn is not None:
                fns.append(lambda: lib_fn(*args))
            times = time_turns(*fns, loop=(fns[0],))
            plain_ms, ms = times[:2]
            out = kern(*args)
            moved = nbytes(*reads) + nbytes(
                *(out if isinstance(out, tuple) else (out,)))
            bound_ms, bound_by = bound(moved, ops, INT32_OPS_PER_MS)
            row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "share_of_bound": bound_ms / ms,
                   "shape": label}
            if before is not None:
                row["ms_before"] = times[2]
            if floor is not None:
                row["launch_floor_ms"] = times[2 + (before is not None)]
            if lib_fn is not None:
                row["library_ms"], row["library"] = times[-1], lib_name
            print(f"{name} on {label}: {detail}; kernel {ms:.4f} ms"
                  + (f" (first design {row['ms_before']:.4f} ms)"
                     if before is not None else "")
                  + (f", an empty kernel on its grid "
                     f"{row['launch_floor_ms']:.4f} ms"
                     if floor is not None else "")
                  + f", plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms by "
                  f"{bound_by} ({moved / 1e6:.2f} MB, {ops / 1e9:.4f} G int32 "
                  f"operations; {100 * bound_ms / ms:.0f}% of it), on "
                  f"{card}, library call "
                  + (f"{lib_name} {row['library_ms']:.4f} ms"
                     if lib_fn is not None else "none"), flush=True)
            if key is None:
                entry.update(row)
            else:
                entry[key] = row
        kernels.append(entry)

    def s_ops(N, m, method):
        """S's int32 operations: LOG's 15 visits of about ten (a clamp, two
        mask tests, two reads, a compare) a stream; the others two a read
        column; the gather one a tap."""
        return N * ((150 if method == P.OrderMethod.LOG else 2 * m) + 32)

    def s_rows(args, entry, key, label, library):
        """S on one captured call: with its gather (``select_candidate``)
        and without (``select_order_bits``, the order alone), and its first
        design (the order alone), each held against its plain version bit
        for bit; all timed in turns beside an empty kernel on S's grid and,
        under SEARCH, ``torch.argmin`` (SEARCH's selection alone, one
        library call). Its bound: the bits once, the chosen rows and
        shifts once, the outputs once."""
        bits, refs, qc, sh, method, min_o, max_o = args
        N, m = bits.shape
        o_args = (bits, method, min_o, max_o)
        _, detail = check("select_candidate",
                          lambda: frame.select_candidate(*args),
                          lambda: frame.select_candidate_plain(*args),
                          cmp_exact)
        for fn in (frame.select_order_bits, yard["s_before"]):
            check("select_order_bits", lambda fn=fn: fn(*o_args),
                  lambda: frame.select_order_bits_plain(*o_args), cmp_exact)
        fns = [lambda: frame.select_candidate_plain(*args),
               lambda: frame.select_candidate(*args),
               lambda: frame.select_order_bits(*o_args),
               lambda: yard["s_before"](*o_args),
               lambda: yard["launch_floor"]((N + 3) // 4, 128)]
        if library:
            fns.append(lambda: torch.argmin(bits[..., :max_o], dim=-1))
        times = time_turns(*fns, loop=(fns[0],))
        out = frame.select_candidate(*args)
        moved = nbytes(bits, *out) + N * (max_o + 1) * 4
        bound_ms, bound_by = bound(moved, s_ops(N, m, method),
                                   INT32_OPS_PER_MS)
        order_bound_ms, _ = bound(nbytes(bits) + 4 * N, s_ops(N, m, method)
                                  - 32 * N, INT32_OPS_PER_MS)
        row = {"ms": times[1], "plain_ms": times[0], "bound_ms": bound_ms,
               "bound_by": bound_by, "share_of_bound": bound_ms / times[1],
               "ms_order_only": times[2], "order_only_bound_ms":
               order_bound_ms, "ms_before": times[3],
               "launch_floor_ms": times[4], "shape": label,
               "method": int(method)}
        if library:
            row["library_ms"], row["library"] = times[5], "torch.argmin"
        print(f"select_candidate on {label}: {detail}; kernel {times[1]:.4f} "
              f"ms with the gather, {times[2]:.4f} ms the order alone (first "
              f"design, the order alone, {times[3]:.4f} ms), an empty kernel "
              f"on its grid ({(N + 3) // 4} x 128) {times[4]:.4f} ms, plain "
              f"{times[0]:.4f} ms, bound {bound_ms:.5f} ms by {bound_by} "
              f"({moved / 1e6:.3f} MB), on {card}, library call "
              + (f"torch.argmin {times[5]:.4f} ms" if library else "none"),
              flush=True)
        if key is None:
            entry.update(row)
        else:
            entry[key] = row

    def h_shape(key, label, args):
        """H reads the samples once; about 16 operations a sample for the
        stereo sums and 8 a sample and channel for the OR, the compare, the
        decorrelation and the shift."""
        samples, cfg = args
        F, n, C = samples.shape
        return (key, label, args, (samples,), F * n * (16 + 8 * C))

    def e_shape(key, label, args):
        """E reads the analysis tables (the residual once) and the header;
        about twenty operations a slot written."""
        analysis, hb, hn, cfg = args
        F = analysis["sf_type"].shape[0]
        reads = [analysis[k] for k in (*bitpack._SLOT_TABLES, "coefs",
                                       "rice_params", "residual",
                                       "ch_mode")] + [hb, hn]
        M = bitpack.slot_layout_plain(analysis, hb, hn, cfg)[0].shape[1]
        return (key, label, args, reads, 20 * F * M)

    def x_capture(level):
        """X's arguments on the first batch of the level's stream."""
        cfg = stream_config(level)
        block = cfg.params.block_size
        fcfg = frame.FrameConfig.from_params(cfg.params, 2, 16)
        got = capture(
            [(frame, "fixed_search")],
            lambda: analyze_and_pack(
                torch.from_numpy(pcm[:BATCH * block].reshape(BATCH, block, 2))
                .to(dev), fcfg, np.arange(BATCH, dtype=np.int64), 0))
        return got["fixed_search"][0]

    def x_shape(key, label, args):
        """X reads the samples once (none where one order leaves nothing
        to search); about 8 operations a sample an order (the difference,
        the zigzag, the sum) and 20 for each order's every pyramid slot
        (the scan)."""
        chans, obits, min_o, max_o, pmin, pmax = args
        n = chans.shape[-1]
        orders = max_o - min_o + 1
        if orders == 1:
            return (key, f"{label} ({tuple(chans.shape)}, order {min_o} "
                    "alone)", args, (), 0)
        ps = rice.limit_max_partition_order(pmax, n, 1)
        return (key, f"{label} ({tuple(chans.shape)}, orders {min_o}-"
                f"{max_o})", args, (chans, obits),
                chans.numel() * 8 * orders
                + chans.numel() // n * orders * (2 << ps) * 20)

    def x_floor(chans, obits, min_o, max_o, pmin, pmax):
        """An empty kernel on X's grid (csrc/rice.cu, flake_fixed_search):
        four streams (warps) a block, or two where their five pyramids and
        level tables (360 bytes) pass 48 KB."""
        n = chans.shape[-1]
        N = chans.numel() // n
        part = 5 * (16 << rice.limit_max_partition_order(pmax, n, 1)) + 360
        warps = 4
        while warps > 1 and warps * part > 48 << 10:
            warps >>= 1
        yard["launch_floor"]((N + warps - 1) // warps, 32 * warps)

    # the 10-sample tail of a level-8 stream: X at an LPC level
    x_tail = capture(
        [(frame, "fixed_search")],
        lambda: Encoder(cfg8, device="cuda").encode_stream(
            pcm[:32 * BLOCK + 10]))["fixed_search"][0]
    s_entry = {"name": "select_candidate", "route": "cuda",
               "source": "flake_tpu_torch/csrc/select.cu",
               "replaces": "flake_tpu/ops/frame.py:102 (_select_order_log; "
               "LEVEL _select_order_level :142, SEARCH's argmin :181, MAX "
               "and EST :167-170, the row select :462-476; no "
               "pl.pallas_call)", "library_ms": None, "max_abs_err": 0.0,
               "timed": {"ms": "back_to_back", "plain_ms": "loop"}}
    s_rows(cap8["select_candidate"][0], s_entry, None,
           "the level-8 batch (LOG)", False)
    # SEARCH's selection is one argmin (the first order among equal
    # minima), then the 1-based int32 order
    s_rows(cap12["select_candidate"][0], s_entry, f"level12_{vbs}",
           f"the level-12 {vbs} bucket (SEARCH)", True)
    kernels.append(s_entry)
    frame_kernel(
        "fixed_search", "flake_tpu_torch/csrc/rice.cu",
        "flake_tpu/ops/frame.py:323 (the FIXED order loop: "
        "predict.residual_fixed and rice.subframe_bits, whose "
        "calc_rice_params is rice.py:158; no pl.pallas_call)",
        rice.fixed_search, rice.fixed_search_plain,
        [x_shape(None, "the level-2 batch", x_capture(2)),
         x_shape("level1", "the level-1 batch", x_capture(1)),
         x_shape("level0", "the level-0 batch", x_capture(0)),
         x_shape("tail10", "the 10-sample tail at level 8", x_tail)],
        before=yard["x_before"], floor=x_floor)
    frame_kernel(
        "frame_head", "flake_tpu_torch/csrc/head.cu",
        "flake_tpu/ops/frame.py:279 (analyze_frames before the prediction: "
        "stereo.decorr_mode, apply_decorr, wasted.remove_wasted_bits, the "
        "constant test; no pl.pallas_call)",
        frame.frame_head, frame.frame_head_plain,
        [h_shape(None, "the level-8 batch", cap8["frame_head"][0]),
         h_shape(f"level12_{vbs}", f"the level-12 {vbs} bucket",
                 cap12["frame_head"][0])], before=yard["h_before"],
        floor=lambda samples, cfg: yard["launch_floor"](samples.shape[0],
                                                         256))
    frame_kernel(
        "slot_layout", "flake_tpu_torch/csrc/slots.cu",
        "flake_tpu/ops/bitpack.py:402 (pack_frames_device's slot tables, "
        ":421-625; no pl.pallas_call)",
        bitpack.slot_layout, bitpack.slot_layout_plain,
        [e_shape(None, "the level-8 batch", cap8["slot_layout"][0]),
         e_shape(f"level12_{vbs}", f"the level-12 {vbs} bucket",
                 cap12["slot_layout"][0])], before=yard["e_before"])

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
                               sweep_mod.sweep_granules_plain, cmp_exact),
            "candidates": (lpc.candidates, lpc.candidates_plain, cmp_bits),
            "select_candidate": (frame.select_candidate,
                                 frame.select_candidate_plain, cmp_exact),
            "fixed_search": (rice.fixed_search, rice.fixed_search_plain,
                             cmp_exact),
            "frame_head": (frame.frame_head, frame.frame_head_plain,
                           cmp_exact),
            "slot_layout": (bitpack.slot_layout, bitpack.slot_layout_plain,
                            cmp_exact),
            **{name: (*fns, cmp_exact) for name, fns in rice_held.items()}}

    def with_rice(needs):
        """A path's kernels with R2, which runs wherever a stream is
        predicted (LPC or FIXED), H, on every dense analysis, R1, which
        runs wherever a sweep does (the order method reads bit counts), L
        and S wherever LPC runs (K1 or a sweep; the float32 path has no
        K1), X where it does not (the FIXED levels; at the LPC levels X
        takes only tails of at most the highest order's samples, and may
        run), and E wherever K3 does (every device emission)."""
        sweeps_run = set(needs) & {"sweep_sums", "sweep_granules"}
        lpc_runs = sweeps_run or "autocorr" in needs
        return tuple(needs) + ("final_pass", "frame_head") \
            + (("rice_scan",) if sweeps_run else ()) \
            + (("candidates", "select_candidate") if lpc_runs
               else ("fixed_search",)) \
            + (("slot_layout",) if "merge_words" in needs else ())

    # the kernels each wide stream's encode calls: K2 only where a block
    # size K4 cannot sum occurs (the 32-bit stream's 2,728-sample tail; the
    # 24-bit level-12 stream's sub-blocks of 3, 5 and 6 x 1,024 and its
    # 1,536-sample tail)
    k14 = ("autocorr", "sweep_granules", "merge_words")
    wide_needs = {"24-bit/96 kHz stereo": k14,
                  "6-channel/48 kHz 16-bit": ("autocorr", "merge_words"),
                  "8-channel/96 kHz 24-bit": ("autocorr", "merge_words"),
                  "32-bit/44.1 kHz stereo": k1234,
                  "24-bit/96 kHz stereo, level 12": k1234}
    held_paths = [(f"level {level}", stream_config(level),
                   level_stream(level), needs)
                  for level, needs, _ in ((8, k1234, ()),) + low_levels] \
        + [(label, wide_config(label), stream, wide_needs[label])
           for label, stream in wide.items()] \
        + [(f"level {level}", stream_config(level), vpcm, k1234)
           for level in (12, 11)]
    k3_forms_held = set()
    for label, cfg, stream, needs in held_paths:
        needs = with_rice(needs)
        calls = capture(
            [(frame, "autocorr"), (frame, "sweep_sums"),
             (frame, "sweep_granules"), (bitpack, "merge_words"),
             (rice, "rice_scan"), (frame, "final_pass"),
             (lpc, "candidates"), (frame, "select_candidate"),
             (frame, "fixed_search"), (frame, "frame_head"),
             (bitpack, "slot_layout")],
            lambda: Encoder(cfg, device="cuda").encode_stream(stream))
        tails = {"fixed_search"} if "candidates" in needs else set()
        if set(calls) - tails != set(needs):
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
            shapes = sorted({tuple(
                (args[0]["residual"] if name == "slot_layout" else args[2]
                 if name == "select_candidate" else args[0])
                .shape) for args in args_of_calls})
            what = (f", {args_of_calls[0][2] + 1} lags" if name == "autocorr"
                    else f", order {args_of_calls[0][3]}"
                    if name in sweeps else "")
            if name in rice_held:
                at = 2 if name == "rice_scan" else 4
                what = f", n {sorted({a[at] for a in args_of_calls})}"
            if name == "select_candidate":
                what = f", methods {sorted({a[4] for a in args_of_calls})}"
            if name == "candidates":
                what = (f", EST {sorted({a[1] for a in args_of_calls})}, "
                        f"{sorted({str(a[0].dtype) for a in args_of_calls})}")
            if name == "merge_words":
                forms = {"shared" if k3_mod.merge_in_shared(args[3])
                         else "global" for args in args_of_calls}
                k3_forms_held |= forms
                what = (f", word rows {sorted({a[3] for a in args_of_calls})}"
                        f", K3 instantiations {sorted(forms)}")
            how = (f"max rel err {worst:.3e} (tolerance {K1_REL_TOL:g})"
                   if compare is cmp_rel else "bit-exact" + (
                       " (NaNs equal)" if compare is cmp_bits else ""))
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
               "prof_merge_zero_rows": tool3.merge_zero_rows,
               "rice_scan": rice.rice_scan, "final_pass": rice.final_pass,
               "candidates": lpc.candidates,
               "select_candidate": frame.select_candidate,
               "fixed_search": rice.fixed_search,
               "frame_head": frame.frame_head,
               "slot_layout": bitpack.slot_layout}
    launched = {name: {} for name in counted}   # name -> {path: count}
    k3_launched_by = {}     # path -> K3's launches by instantiation

    def count_launches(label, run, needs, never=()):
        """Run one main path with every count set to 0 just before it and
        read just after; ``needs`` must have launched, ``never`` not."""
        for fn in counted.values():
            fn.launches = 0
        k3_mod.merge_words.launches_by = {"shared": 0, "global": 0}
        # no plain Rice search, no lag loop of the plain final pass, no
        # plain recursion or quantizer, and no plain order selection, FIXED
        # search, frame head or slot layout (nor the pieces of them) may run
        # on a card tensor on a main path
        plains = [(mod, name, getattr(mod, name))
                  for mod, name in ((rice, "rice_scan_plain"),
                                    (rice, "rice_final_plain"),
                                    (rice, "final_pass_plain"),
                                    (predict, "residual_lpc_dynamic64"),
                                    (lpc, "candidates_plain"),
                                    (lpc, "levinson_all_orders"),
                                    (lpc, "schur_refs"),
                                    (lpc, "levinson_from_refs"),
                                    (lpc, "quantize_lpc_coefs"),
                                    (frame, "select_order_bits_plain"),
                                    (frame, "_select_order_log"),
                                    (frame, "select_candidate_plain"),
                                    (lpc, "estimate_order"),
                                    (rice, "fixed_search_plain"),
                                    (rice, "calc_rice_params"),
                                    (frame, "frame_head_plain"),
                                    (stereo, "decorr_mode"),
                                    (wasted, "remove_wasted_bits"),
                                    (bitpack, "slot_layout_plain"))]
        on_card = set()

        def guard(name, plain):
            def run_plain(x, *args):
                # the slot layout's plain version takes the analysis dict;
                # S's takes no bits under MAX and EST
                t = next(a for a in (x["sf_type"] if isinstance(x, dict)
                                     else x, *args)
                         if isinstance(a, torch.Tensor))
                if t.device.type != "cpu":
                    on_card.add(name)
                return plain(x, *args)
            return run_plain

        for mod, name, plain in plains:
            setattr(mod, name, guard(name, plain))
        try:
            result = run()
            torch.cuda.synchronize()
        finally:
            for mod, name, plain in plains:
                setattr(mod, name, plain)
        if on_card:
            fail(f"{label}: {sorted(on_card)} ran on a card tensor")
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

    blobs = {}              # label -> the bytes of the stream's cold run

    def drive(label, cfg, stream, needs, never=()):
        """One main path through the encoder, cold then warm; the counts
        are those of the cold run. Then, untimed, the host emission must
        give the same bytes without K3. The encoder's peak device memory
        at levels 11 and 12 must stay under PEAK_LIMIT_MIB (R1 and R2 hold
        no k grid)."""
        needs = with_rice(needs)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        rate, pcm_bytes = cfg.sample_rate, stream.size * cfg.bits_per_sample / 8
        enc = Encoder(cfg, device="cuda")
        t0 = time.perf_counter()
        blob = count_launches(label, lambda: enc.encode_stream(stream),
                              needs, never)
        cold = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - held
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
              f"({len(blob) / pcm_bytes:.4f} of the PCM bytes, sha256 "
              f"{hashlib.sha256(blob).hexdigest()[:16]}); "
              f"peak device memory {peak / 2**20:.0f} MiB above the "
              f"{held / 2**20:.0f} MiB the smoke held at the reset; warm "
              f"stats { {k: round(v, 4) for k, v in enc2.stats.items()} }",
              flush=True)
        if label.startswith(("level 11", "level 12")) \
                and peak > PEAK_LIMIT_MIB << 20:
            fail(f"{label}: the encoder's peak device memory "
                 f"{peak / 2**20:.0f} MiB exceeds {PEAK_LIMIT_MIB} MiB")
        host_blob = count_launches(
            f"{label}, host emission",
            lambda: Encoder(cfg, device="cuda",
                            pack_backend="host").encode_stream(stream),
            tuple(n for n in needs if n not in ("merge_words",
                                                "slot_layout")),
            tuple(never) + ("merge_words", "slot_layout"))
        if host_blob != blob:
            fail(f"{label}: the host emission's bytes differ from K3's")
        print(f"{label}: the host emission (native packer) gives K3's "
              f"{len(blob)} bytes", flush=True)
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
        blobs[label] = blob
        return dec

    def stage_peaks(label, cfg, stream):
        """One more (untimed) encode with the peak device memory of each
        stage above the memory allocated when it begins: analyze_frames,
        the sweep's Rice scan (R1, ``rice_scan``), the final pass (R2,
        ``final_pass``), pack_frames_device and, inside it, the slot
        layout (``slot_layout``) and K3 (``merge_words``) apart, and L
        (``lpc_candidates``) inside the analysis. A stage
        that begins inside another hands its peak to the outer one, so each
        reading is that of the stage with everything it calls. The slot
        layout runs under :func:`live_tensors`: its largest call prints
        the tensors alive at its peak and its operation count. Returns
        (the bytes, the whole encode's peak bytes above the memory held at
        its start, each stage's peak bytes)."""
        # the encoder analyses each batch through the mesh module's groups
        hooks = [(mesh_mod, "analyze_frames"), (frame, "lpc_candidates"),
                 (rice, "rice_scan"), (frame, "final_pass"),
                 (bitpack, "pack_frames_device"), (bitpack, "slot_layout"),
                 (bitpack, "merge_words")]
        # [start, top] of the whole encode, then of each stage entered
        stack, peaks, layout = [], {}, {}

        def wrap(name, orig):
            @functools.wraps(orig)
            def run(*args, **kwargs):
                top = torch.cuda.max_memory_allocated(dev)
                for entry in stack:
                    entry[1] = max(entry[1], top)
                torch.cuda.reset_peak_memory_stats(dev)
                start = torch.cuda.memory_allocated(dev)
                stack.append([start, start])
                try:
                    if name != "slot_layout":
                        return orig(*args, **kwargs)
                    out, live, at_peak, ops = live_tensors(
                        lambda: orig(*args, **kwargs), top=24)
                    if live > layout.get("live_mib", 0) * 2**20:
                        layout.update(live_mib=round(live / 2**20, 1),
                                      operations=ops, at_peak=at_peak)
                    return out
                finally:
                    entry = stack.pop()
                    top = max(entry[1], torch.cuda.max_memory_allocated(dev))
                    for outer in stack:
                        outer[1] = max(outer[1], top)
                    if top - entry[0] > peaks.get(name, (0,))[0]:
                        shape = getattr(args[0], "shape", None)
                        peaks[name] = (top - entry[0],
                                       shape and tuple(shape))
            return run

        originals = [(mod, name, getattr(mod, name)) for mod, name in hooks]
        for mod, name, orig in originals:
            setattr(mod, name, wrap(name, orig))
        try:
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            stack.append([held, held])
            blob = Encoder(cfg, device="cuda").encode_stream(stream)
            torch.cuda.synchronize()
            whole = max(stack.pop()[1], torch.cuda.max_memory_allocated(dev))
        finally:
            for mod, name, orig in originals:
                setattr(mod, name, orig)
        print(f"{label}: peak device memory by stage, MiB above the stage's "
              "start (the first argument's shape at that peak): "
              f"{ {k: (round(v / 2**20, 1), sh) for k, (v, sh) in peaks.items()} }"
              f"; the whole encode {(whole - held) / 2**20:.1f} MiB above "
              f"the {held / 2**20:.0f} MiB held", flush=True)
        print(f"{label}: slot_layout's largest call: {layout['live_mib']} MiB "
              f"of its own tensors alive at once, {layout['operations']} "
              "operations; alive at that peak (operation, shape, dtype, "
              f"MiB): {layout['at_peak']}", flush=True)
        return blob, whole - held, {k: v for k, (v, _) in peaks.items()}

    dec8 = drive("level 8", cfg8, pcm, k1234)
    stage_peaks("level 8", cfg8, pcm)
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

    # a stream whose last block holds 10 samples, at most level 8's highest
    # order: that block takes the FIXED search (X) at an LPC level
    tail_pcm = pcm[:32 * BLOCK + 10]
    tail_label = "level 8, a 10-sample tail"
    drive(tail_label, cfg8, tail_pcm,
          ("autocorr", "sweep_granules", "merge_words", "fixed_search"))
    if Encoder(cfg8, device="cpu").encode_stream(tail_pcm) \
            != blobs[tail_label]:
        fail(f"{tail_label}: the CPU and CUDA encoders disagree")
    print(f"{tail_label}: the CPU encoder gives the same bytes", flush=True)

    for level in (12, 11):
        dec = drive(f"level {level}", stream_config(level), vpcm, k1234)
        if dec.streaminfo.min_block_size != 16:
            fail(f"level {level}: STREAMINFO min block is not 16")
    stage_peaks("level 12", stream_config(12), vpcm)

    # a long level-12 stream: every sub-block size's final pass over 600 s,
    # and a segment of it through the CPU and the CUDA encoder
    lpcm = make_vbs_stream(SEED + 16, LONG_SECONDS)
    long_label = f"level 12, {LONG_SECONDS} s"
    drive(long_label, stream_config(12), lpcm, k1234)
    mid = lpcm.shape[0] // 2
    lseg = lpcm[mid - SAMPLE_RATE * 3 // 2:mid + SAMPLE_RATE * 3 // 2]
    on_card = Encoder(stream_config(12), device="cuda").encode_stream(lseg)
    on_host = Encoder(stream_config(12), device="cpu").encode_stream(lseg)
    print(f"parity: 3 s in the middle of the {long_label} stream, "
          f"{len(on_card)} bytes, equal {on_card == on_host}", flush=True)
    if on_card != on_host:
        fail(f"the CPU and CUDA encoders disagree on the {long_label} stream")
    del lpcm

    # the FIXED levels' most frames a second (level 2, blocks of 1,152) and
    # level 7 over 600 s beside their short streams: decoded with the MD5,
    # and the encode's peak device memory may not grow with the length
    lpcm = make_stream(SEED, LONG_SECONDS)
    for level in LONG_LEVELS:
        cfg = stream_config(level)
        short = f"level {level}, {LEVEL_SECONDS[level]} s"
        _, short_peak, short_stages = stage_peaks(short, cfg,
                                                  level_stream(level))
        label = f"level {level}, {LONG_SECONDS} s"
        needs, never = next((n, nv) for lv, n, nv in low_levels
                            if lv == level)
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        blob = count_launches(
            label, lambda: Encoder(cfg, device="cuda").encode_stream(lpcm),
            with_rice(needs), never)
        wall = time.perf_counter() - t0
        print(f"encode {LONG_SECONDS} s level {level} on {card}: "
              f"{wall:.3f} s ({LONG_SECONDS / wall:.1f}x realtime); "
              f"{len(blob)} bytes, sha256 "
              f"{hashlib.sha256(blob).hexdigest()[:16]}; peak device memory "
              f"{(torch.cuda.max_memory_allocated(dev) - held) / 2**20:.0f} "
              "MiB above the held", flush=True)
        again, peak, stages = stage_peaks(label, cfg, lpcm)
        if again != blob:
            fail(f"{label}: two encodes differ")
        t0 = time.perf_counter()
        dec = decoder.decode_stream(blob)
        if not dec.md5_ok or not np.array_equal(dec.samples, lpcm):
            fail(f"{label}: the stream does not decode to its samples with "
                 "its MD5")
        grown = {k: round((v - short_stages.get(k, 0)) / 2**20, 1)
                 for k, v in stages.items()}
        print(f"{label}: lossless, MD5 ok, {dec.frames} frames "
              f"({time.perf_counter() - t0:.1f} s); peak device memory "
              f"{peak / 2**20:.1f} MiB above the held, the {short} stream's "
              f"{short_peak / 2**20:.1f}; each stage's peak above the short "
              f"stream's, MiB: {grown}", flush=True)
        if peak > short_peak + (LONG_PEAK_SLACK_MIB << 20):
            fail(f"{label}: the peak device memory grows with the stream: "
                 f"{peak / 2**20:.1f} MiB against {short_peak / 2**20:.1f} "
                 f"for {LEVEL_SECONDS[level]} s")
    del lpcm

    for label, stream in wide.items():
        cfg = wide_config(label)
        dec = drive(label, cfg, stream, wide_needs[label])
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

    # -- 7b. the file path: WAV files through the command line --------------
    def run_cli(label, argv, needs=None, never=()):
        """One command-line run as a user calls it, with the launch counts
        of this path (uncounted where ``needs`` is None: a warm run);
        returns its wall seconds."""
        t0 = time.perf_counter()
        if needs is None:
            rc = cli.main(list(map(str, argv)))
            torch.cuda.synchronize()
        else:
            rc = count_launches(label,
                                lambda: cli.main(list(map(str, argv))),
                                with_rice(needs), never)
        wall = time.perf_counter() - t0
        if rc != 0:
            fail(f"{label}: the command line exited {rc}")
        return wall

    def check_file(label, flac, wav, block=None):
        """The FLAC file decodes with its MD5 to the samples the port's
        reader reads from the WAV, and its STREAMINFO gives the WAV's
        rate, channels and bits (and ``block`` as both block sizes)."""
        with open(wav, "rb") as f:
            reader = open_pcm(f)
            info, want = reader.info, reader.read_all()
        t0 = time.perf_counter()
        dec = decoder.decode_stream(flac)
        si = dec.streaminfo
        if not dec.md5_ok or not np.array_equal(dec.samples, want):
            fail(f"{label}: the file does not decode to the input's samples "
                 "with its MD5")
        got = (si.sample_rate, si.channels, si.bits_per_sample)
        if got != (info.sample_rate, info.channels, info.bits_per_sample) \
                or (block and (si.min_block_size, si.max_block_size)
                    != (block, block)):
            fail(f"{label}: STREAMINFO says {si}")
        print(f"{label} decode: lossless, MD5 ok, {dec.frames} frames, "
              f"STREAMINFO {si.min_block_size}/{si.max_block_size} samples "
              f"a block, {si.sample_rate} Hz, {si.channels} ch, "
              f"{si.bits_per_sample} bit ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        return want

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        # BASELINE config 1 at full width: 600 s of 16-bit/44.1 kHz stereo
        wav = tmp / "config1.wav"
        write_wave(wav, make_stream(SEED, CONFIG1_SECONDS), SAMPLE_RATE, 16)
        print(f"config 1 input, wavinfo of {CONFIG1_SECONDS} s "
              f"({wav.stat().st_size} bytes):", flush=True)
        if wavinfo.main([str(wav)]) != 0:
            fail("wavinfo could not read the config-1 WAV")
        pcm_bytes = CONFIG1_SECONDS * SAMPLE_RATE * 4
        c1 = ["-q", "-5", "-b", CONFIG1_BLOCK]
        for backend, needs, never in (
                ("device", ("autocorr", "merge_words"), sweeps),
                ("host", ("autocorr",),
                 sweeps + ("merge_words", "slot_layout"))):
            out = tmp / f"config1_{backend}.flac"
            argv = c1 + ["--pack-backend", backend, wav, "-o", out]
            cold = run_cli(f"cli config 1 ({backend} emission)", argv,
                           needs, never)
            warm = run_cli(f"cli config 1 ({backend} emission), warm", argv)
            size = out.stat().st_size
            print(f"cli -5 -b {CONFIG1_BLOCK}, {CONFIG1_SECONDS} s WAV, "
                  f"{backend} emission, on {card}: cold {cold:.3f} s "
                  f"({CONFIG1_SECONDS / cold:.1f}x realtime), warm "
                  f"{warm:.3f} s ({CONFIG1_SECONDS / warm:.1f}x realtime); "
                  f"{size} bytes ({size / pcm_bytes:.4f} of the PCM bytes)",
                  flush=True)
        c1_blob = (tmp / "config1_device.flac").read_bytes()
        if (tmp / "config1_host.flac").read_bytes() != c1_blob:
            fail("cli config 1: the host emission's file differs from K3's")
        print("cli config 1: the host emission's file equals K3's", flush=True)
        check_file("cli config 1", c1_blob, wav, CONFIG1_BLOCK)

        # the command line reads in chunks of up to 1024 frames, which must
        # not change a byte: the 24-bit stream's file equals encode_stream's
        label = "24-bit/96 kHz stereo"
        channels, bps, rate, level, _ = WIDE_STREAMS[label]
        wav = tmp / "wide24.wav"
        write_wave(wav, wide[label], rate, bps)
        out = tmp / "wide24.flac"
        run_cli(f"cli -{level} on the {label} WAV",
                ["-q", f"-{level}", wav, "-o", out], wide_needs[label])
        if out.read_bytes() != blobs[label]:
            fail(f"cli on the {label} WAV: its file differs from "
                 "encode_stream's on the same samples")
        print(f"cli -{level} on the {label} WAV: the file equals "
              f"encode_stream's {len(blobs[label])} bytes", flush=True)

        # recorded input: 11,025 Hz guitar plucks (the custom-rate header
        # field) in every container the readers take
        for name in ("pluck-pcm16.aiff", "pluck-pcm16.wav",
                     "pluck-pcm24.wav"):
            src = ROOT / "tests" / "data" / name
            out = tmp / f"{name}.flac"
            run_cli(f"cli -5 on {name}", ["-q", "-5", src, "-o", out],
                    ("autocorr", "merge_words"), sweeps)
            blob = out.read_bytes()
            samples = check_file(f"cli -5 on {name}", blob, src)
            with open(src, "rb") as f:
                info = open_pcm(f).info
            want = Encoder(P.StreamConfig(
                channels=info.channels, sample_rate=info.sample_rate,
                bits_per_sample=info.bits_per_sample,
                params=P.set_defaults(5)), device="cuda").encode_stream(
                    samples)
            if blob != want:
                fail(f"cli -5 on {name}: the file differs from "
                     "encode_stream's on its samples")
            print(f"cli -5 on {name}: {samples.shape[0]} samples at "
                  f"{info.sample_rate} Hz, {info.bits_per_sample} bit; the "
                  f"file equals encode_stream's {len(want)} bytes", flush=True)

        # --lpc-dtype float32 at level 8: no K1, the sweep and K3 run
        wav = tmp / "float32.wav"
        seg = pcm[:FLOAT32_SECONDS * SAMPLE_RATE]
        write_wave(wav, seg, SAMPLE_RATE, 16)
        sizes = {}
        for dtype, needs, never in (
                ("float32", ("sweep_granules", "merge_words"), ("autocorr",)),
                ("float64", k1234, ())):
            out = tmp / f"{dtype}.flac"
            run_cli(f"cli -8 --lpc-dtype {dtype}",
                    ["-q", "-8", "--lpc-dtype", dtype, wav, "-o", out],
                    needs, never)
            sizes[dtype] = out.stat().st_size
            check_file(f"cli -8 --lpc-dtype {dtype}", out.read_bytes(), wav)
        print(f"cli -8 on {FLOAT32_SECONDS} s: float32 {sizes['float32']} "
              f"bytes, float64 {sizes['float64']} bytes "
              f"({sizes['float32'] / sizes['float64'] - 1:+.5%})", flush=True)

    # -- 7c. the sharded path -------------------------------------------------
    t0 = time.perf_counter()
    sharded_paths(card, pcm, count_launches, launched)
    print(f"the sharded path (section 7c): {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- 7d. the sp path: each frame's samples over two ranks ----------------
    t0 = time.perf_counter()
    sp_streams = {}
    for label, (level, secs, source) in SP_STREAMS.items():
        if source == "wide":
            cfg = wide_config("24-bit/96 kHz stereo")
            stream = wide["24-bit/96 kHz stereo"][:secs * cfg.sample_rate]
        else:
            cfg = stream_config(level)
            stream = (vpcm if source == "vbs" else pcm)[:secs * SAMPLE_RATE]
        sp_streams[label] = (cfg, stream)
    sp_paths(card, sp_streams, count_launches, launched)
    print(f"the sp path (section 7d): {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- 8. the measurement path: the bench, its matrices, the stage tool -----
    t0 = time.perf_counter()
    measurement_paths(card, count_launches)
    print(f"the measurement path (section 8): {time.perf_counter() - t0:.1f} "
          "s", flush=True)

    # -- 9. results -----------------------------------------------------------
    for k in kernels:
        k["launches"] = sum(launched[k["name"]].values())
        k["launches_by_path"] = launched[k["name"]]
    next(k for k in kernels if k["name"] == "merge_words")[
        "launches_by_instantiation"] = {
            form: {path: by[form] for path, by in k3_launched_by.items()
                   if by[form]} for form in ("shared", "global")}
    print(f"smoke wall {time.perf_counter() - t_smoke:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
