"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need an NVIDIA GPU and skip without one. They import no JAX,
so they run on a machine that has only PyTorch with CUDA:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` keeps ``tests/conftest.py``, which imports JAX, out.)
Shapes cover the level-8 main path, the level-11/12 sub-blocks of 4096
and 8192 samples at order 32 with 256 partitions, and the edges: odd
block sizes, a partition size of 253, K2 at order 32 with 256 partitions
(a stream split over several blocks), K4 with partitions larger than
its granule and with 300 streams, K4 on 1, 2 and 428 streams of 1024-8192
samples at orders 13-32 with granules of 4 to 128 and on 25-bit samples,
24-bit and 32-bit content, and blocks under 32; K3 in both its
instantiations (words below and above its shared-memory cap), on frames
of 3 and 20 samples, on slot counts that are no multiple of its tiles,
on rows that start off a 16-byte boundary and on 32-bit slot pairs; K2 on one stream, on the level-12 buckets and at the edges of
its order buckets, K1 at the edges of its lag buckets on blocks of 3 and
31 samples, and two K1 calls giving the same bits; the tie rules of the
Rice k scan and the stereo mode on equal counts; R1 (the Rice scan from
partition sums) at the level-8 and level-12 shapes, on finer sums, with
warm-ups past a partition, on a 777-sample tail and on rows whose k and
partition-order scans tie, and R2 (the final pass from the samples) at
the level-8 and level-12 shapes, n 4608, 1152, 777, 20, 3, 64, 16384
and 65535 (rows past R2's shared-memory row), on
samples of -2..2, 32-bit samples at the int32 limits under shifted
order-32 predictions (whose fit flag is false) and the fixed predictors,
each on every output bit for bit, and one R2 launch as the whole final
pass of an LPC and a FIXED batch; K5 and the four U1
variants on encoder slots, on random slot tables whose chunks span three
word rows, and on a word block above
48 KiB of shared memory; the merge prototypes ``merge_v2`` and ``merge_v3``
at fb = 1, 8 and 16 and the combined-node merges ``merge_v5a`` and
``merge_v5b`` on the tools' ``music`` and ``noise`` batches at full frame
width and on those random tables, where they leave K5's words or flag both
spill sets; the row-layout merges ``merge_v5d`` and ``merge_v5c`` on the
same four at fb = 1, 8, 16 and 32 and at four and two static rows (the
random tables and two rows overflow), with every spill chunk flagged and on
node arrays off a 16-byte boundary, and their zero floors; ``merge_v2``
(one block a frame) at fb = 1, 4, 8, 16 and 32 and on inputs off a 16-byte
boundary, ``merge_v3`` on inputs off it and on chunk bounds in no order,
negative ones among them; the one zero floor behind U1's zero variant and
U3e / U3f at fb = 1, 8, 16 and 32 and on a ragged 3 x 128 ints, and these,
``merge_v2``, ``merge_v3``, ``merge_v5d`` and ``merge_v5c`` writing into a
view of a sentinel-filled buffer, on and off a 16-byte boundary. L (the
LPC coefficient stage, ``csrc/lpc.cu``) in float64 and float32, under
Levinson and EST, against its plain version bit for bit (NaNs equal) on
windowed autocorrelations at orders 1-32 and precisions 5-15 for N from 1
to 13,696, on the quantizer's shift boundaries (cmax 0, subnormal, powers
of two, qmax * 2^-sh and its neighbours, above qmax) at precisions 5-15,
on degenerate autocorrelations (inf and NaN), on a non-contiguous batched
view, and on every call of the encoder at levels 5, 8 and 12. S, X, H and
E (the order selection, the FIXED order search, the frame head and the
slot layout) against their plain versions bit for bit: S under every
order method on tables with ties and U32_MASK at the level-8 and level-12
shapes and the edges, X at the level-2 batch, on 32-bit content and
alternating INT32_MIN / INT32_MAX, short tails, one order (0, 1, 2 and
4), 256 partitions at n 4,096 and 32,768, the first shape past each of its
routes (32 and 64 partitions, four and two streams a block, odd
partitions, a second batch of loads) and n up to 65,535, H at the level-8 batch, 32 bits (the side veto)
and 1, 6 and 8 channels, S with its gather under every order method at
orders 1-32 on 1, 5, 33 and 1,024 streams (NaN and zero reflection
coefficients under EST, float64 and float32) and H at 1-8 channels, 4-32
bits, n 1 to 65,535, on frames off a 16-byte boundary and on samples
outside their bits, E on the card's analyses at levels 2, 5, 8 and
12, 24 and 32 bits and tails of 20, 10 and 3 samples, and on made-up
analyses (every subframe type in a frame, 1 to 512 frames, the wide form,
8 channels, odd n, ps 0 to 8, 65,535 samples); an encode launches them
once a batch. Z (the analysis' finalize, ``csrc/finalize.cu``) against its
plain version on every output key on made-up tables that force CONSTANT
rows, unfit rows and over-size frames, alone and mixed, on the LPC, FIXED
and VERBATIM paths, at 1-8 channels and 16-32 bits, rows of 4,096, 4,608,
1,152, 777 and 333 samples and an sp rank's half block, 0 to 12,288
frames, samples in other layouts; ``analyze_frames`` launches it once a
call on every path, the Encoder once a batch, the pipeline entry once. L also at max orders 1, 2, 31 and 32 on 1, 5 and 1,024
streams with degenerate rows among them. The
command line (``flake_tpu_torch.cli``) on the card writes the file it
writes with ``--device cpu`` at ``-5 -b 4608`` (both emissions) and
``-8``.
"""

import functools

import numpy as np
import pytest
import torch

import flake_tpu_torch
from flake_tpu_torch import params as P
from flake_tpu_torch.ops import autocorr as k1
from flake_tpu_torch.ops import bitmerge as k3
from flake_tpu_torch.ops import bitpack, frame, lpc, rice
from flake_tpu_torch.ops import sweep as k2
from flake_tpu_torch.ops.sweep import sweep_granules as k4
from flake_tpu_torch.util import prof_merge, prof_merge2, prof_merge3

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tonal(N, B, bps, seed):
    """int32 [N, B] tonal streams with light noise; row 1 silent, row 2
    constant (the autocorrelation's +2.0 bias cases) where N has them."""
    rng = np.random.default_rng(seed)
    t = np.arange(B)
    amp = (1 << (bps - 2))
    x = amp * np.sin(2 * np.pi * rng.uniform(40, 700, (N, 1)) * t / 44100) \
        + rng.normal(0, amp / 100, (N, B))
    x[1:2] = 0
    x[2:3] = 1234
    return torch.from_numpy(x.astype(np.int32))


def _coefs(x, max_order):
    """Quantized LPC coefficients and shifts of every order."""
    B = x.shape[1]
    autoc = lpc.autocorr(x, max_order, lpc.welch_window_on(B, x.device))
    rows, _ = lpc.levinson_all_orders(autoc)
    return lpc.quantize_lpc_coefs(rows, 15)


@pytest.mark.parametrize("B,max_order", [(4096, 12), (777, 32),
                                         (65535, 8), (20, 12), (8192, 32)])
def test_autocorr_kernel(dev, B, max_order):
    x = _tonal(6, B, 16, seed=B).to(dev)
    w = lpc.welch_window_on(B, dev)
    before = k1.autocorr.launches
    got = k1.autocorr(x, w, max_order)
    want = lpc.autocorr(x, max_order, w)
    assert k1.autocorr.launches == before + 1
    rel = ((got - want).abs() / want.abs().clamp_min(1e-300)).max().item()
    assert rel < 5e-11


@pytest.mark.parametrize("B,max_order,pmax_static,bps", [
    (4096, 12, 6, 16), (777, 32, 0, 16), (4048, 12, 4, 16),
    (8192, 32, 8, 16), (4096, 32, 6, 24), (20, 12, 2, 16),
    (1024, 32, 8, 16), (3072, 32, 8, 16)])
def test_sweep_kernel(dev, B, max_order, pmax_static, bps):
    x = _tonal(9, B, bps, seed=B + bps)
    x[3] = torch.from_numpy(np.random.default_rng(3).integers(
        -(1 << (bps - 1)), 1 << (bps - 1), B).astype(np.int32))
    x = x.to(dev)
    qc, sh = _coefs(x, max_order)
    got = k2.sweep_sums(x, qc, sh, max_order, pmax_static)
    want = k2.sweep_sums_plain(x, qc, sh, max_order, pmax_static)
    assert torch.equal(got, want)


@pytest.mark.parametrize("N,B,max_order,pmax_static", [
    (1, 4096, 12, 6), (1, 3072, 32, 8), (32, 3072, 32, 8),
    (18, 5120, 32, 8), (12, 7168, 32, 8), (5, 1024, 1, 4),
    (5, 1024, 12, 4), (5, 1024, 13, 4), (5, 1024, 32, 4),
    (2, 8176, 32, 4)])
def test_sweep_kernel_geometry(dev, N, B, max_order, pmax_static):
    """K2 on one stream, on the level-12 buckets' 12-28-sample partitions
    (a stream split over several blocks, a partition over several
    threads), at both edges of each order bucket and on the tail."""
    x = _tonal(N, B, 16, seed=B + N + max_order)
    x[0] = torch.from_numpy(np.random.default_rng(N).integers(
        -32768, 32768, B).astype(np.int32))
    x = x.to(dev)
    qc, sh = _coefs(x, max_order)
    before = k2.sweep_sums.launches
    got = k2.sweep_sums(x, qc, sh, max_order, pmax_static)
    assert k2.sweep_sums.launches == before + 1
    want = k2.sweep_sums_plain(x, qc, sh, max_order, pmax_static)
    assert torch.equal(got, want)


@pytest.mark.parametrize("B", [3, 31, 4096])
@pytest.mark.parametrize("max_order", [12, 13, 32])
def test_autocorr_kernel_lag_buckets(dev, B, max_order):
    """K1 at both edges of its lag buckets, on blocks shorter than a lane's
    group and than the lags (lags past B sum nothing)."""
    x = _tonal(6, B, 16, seed=B + max_order).to(dev)
    w = lpc.welch_window_on(B, dev)
    got = k1.autocorr(x, w, max_order)
    want = lpc.autocorr(x, max_order, w)
    rel = ((got - want).abs() / want.abs().clamp_min(1e-300)).max().item()
    assert rel < 5e-11
    assert torch.equal(got[:, B:], torch.full_like(got[:, B:], 2.0))


@pytest.mark.parametrize("N,B,max_order", [(1024, 4096, 12),
                                           (428, 8192, 32), (3, 777, 8)])
def test_autocorr_kernel_same_bits_twice(dev, N, B, max_order):
    """Two calls on the same input give the same bits (no float atomics,
    a fixed reduction order)."""
    x = _tonal(N, B, 16, seed=N).to(dev)
    w = lpc.welch_window_on(B, dev)
    first = k1.autocorr(x, w, max_order)
    assert torch.equal(first, k1.autocorr(x, w, max_order))


@pytest.mark.parametrize("N", [2, 300])
@pytest.mark.parametrize("B,max_order,pmax_static", [
    (8192, 32, 8), (4096, 32, 8), (4096, 32, 4), (1024, 8, 6)])
def test_granule_kernel(dev, N, B, max_order, pmax_static):
    """K4 against its plain version; (4096, 32, 4) has 256-sample
    partitions summed as 128-sample granules."""
    x = _tonal(N, B, 16, seed=B + N)
    x[0] = torch.from_numpy(np.random.default_rng(N).integers(
        -32768, 32768, B).astype(np.int32))
    x = x.to(dev)
    qc, sh = _coefs(x, max_order)
    before = k4.launches
    got = k4(x, qc, sh, max_order, pmax_static)
    assert k4.launches == before + 1
    want = k2.sweep_granules_plain(x, qc, sh, max_order, pmax_static)
    assert got.shape == (N, max_order, B // min(B >> pmax_static, 128))
    assert torch.equal(got, want)
    # the same sums, folded to partitions, as K2 gives them
    parts = 1 << pmax_static
    assert torch.equal(got.reshape(N, max_order, parts, -1).sum(-1),
                       k2.sweep_sums(x, qc, sh, max_order, pmax_static))


@pytest.mark.parametrize("N", [1, 2, 428])
@pytest.mark.parametrize("B,max_order,pmax_static", [
    (1024, 32, 8), (2048, 13, 8), (4096, 20, 2), (8192, 32, 8),
    (8192, 17, 6), (1024, 24, 3)])
def test_granule_kernel_shapes(dev, N, B, max_order, pmax_static):
    """K4 on one to 428 streams, blocks of 1024-8192, orders 13-32 and
    granules of 4 (1024 at pmax 8) to 128 samples (4096 at pmax 2)."""
    x = _tonal(max(N, 3), B, 16, seed=B + N + max_order)[:N].to(dev)
    qc, sh = _coefs(x, max_order)
    got = k4(x, qc, sh, max_order, pmax_static)
    want = k2.sweep_granules_plain(x, qc, sh, max_order, pmax_static)
    assert got.shape == (N, max_order, B // min(B >> pmax_static, 128))
    assert torch.equal(got, want)


@pytest.mark.parametrize("pmax_static", [8, 2])
def test_granule_kernel_wide_samples(dev, pmax_static):
    """K4 on 25-bit samples (the side channel of 24-bit stereo at levels
    11-12), full-scale 25-bit noise and full-range int32 noise, where the
    FP64 sums come nearest 2^51; two calls give the same bits."""
    N, B = 6, 4096
    rng = np.random.default_rng(25)
    x = _tonal(N, B, 24, seed=25).to(torch.int64) * 2
    x[3] = torch.from_numpy(rng.integers(-(1 << 24), 1 << 24, B))
    x = x.clamp(-(1 << 24), (1 << 24) - 1)
    x[4] = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, B))
    x = x.to(torch.int32).to(dev)
    qc, sh = _coefs(x, 32)
    got = k4(x, qc, sh, 32, pmax_static)
    assert torch.equal(got, k2.sweep_granules_plain(x, qc, sh, 32,
                                                    pmax_static))
    assert torch.equal(k4(x, qc, sh, 32, pmax_static), got)


@pytest.mark.parametrize("B,F,bps", [(4096, 8, 16), (20, 2, 16),
                                     (256, 4, 32), (3, 1, 16), (20, 5, 24),
                                     (1024, 3, 32)])
def test_merge_kernel(dev, B, F, bps):
    rng = np.random.default_rng(B)
    lim = 1 << (bps - 1)
    frames = _tonal(2 * F, B, bps, seed=B).reshape(F, 2, B) \
        .permute(0, 2, 1).contiguous()
    frames[0] = torch.from_numpy(rng.choice([-lim, lim - 1], (B, 2))
                                 .astype(np.int32))
    cfg = frame.FrameConfig.from_params(P.set_defaults(8), 2, bps,
                                        block_size=B)
    nums = np.arange(F, dtype=np.int64) * 1000
    hdr_bytes, hdr_nb = bitpack.frame_header_bytes(
        nums, bs_code=P.blocksize_code(B),
        sr_code=P.samplerate_code(44100), allow_vbs=0)
    analysis = frame.analyze_frames(
        frames.to(dev), cfg, torch.from_numpy(hdr_nb * 8).to(dev))
    slots = bitpack.slot_layout(analysis, torch.from_numpy(hdr_bytes).to(dev),
                                torch.from_numpy(hdr_nb).to(dev), cfg)
    words, total_bits = k3.merge_words(*slots, bitpack.word_rows(cfg))
    words_p, total_p = k3.merge_words_plain(*slots, bitpack.word_rows(cfg))
    assert torch.equal(words, words_p)
    assert torch.equal(total_bits, total_p)
    assert torch.equal(total_bits.to(torch.int64),
                       analysis["frame_bytes"] * 8)


def test_merge_kernel_level12(dev):
    """K3 on a batch of 8192-sample level-12 frames (about 17k slots and
    65 word rows per frame)."""
    F, B = 6, 8192
    frames = _tonal(2 * F, B, 16, seed=12).reshape(F, 2, B) \
        .permute(0, 2, 1).contiguous()
    cfg = frame.FrameConfig.from_params(P.set_defaults(12), 2, 16,
                                        block_size=B)
    nums = np.arange(F, dtype=np.int64) * B
    hdr_bytes, hdr_nb = bitpack.frame_header_bytes(
        nums, bs_code=P.blocksize_code(B),
        sr_code=P.samplerate_code(44100), allow_vbs=1)
    analysis = frame.analyze_frames(
        frames.to(dev), cfg, torch.from_numpy(hdr_nb * 8).to(dev))
    slots = bitpack.slot_layout(analysis, torch.from_numpy(hdr_bytes).to(dev),
                                torch.from_numpy(hdr_nb).to(dev), cfg)
    assert slots[0].shape[1] > 16000 and bitpack.word_rows(cfg) >= 64
    words, total_bits = k3.merge_words(*slots, bitpack.word_rows(cfg))
    words_p, total_p = k3.merge_words_plain(*slots, bitpack.word_rows(cfg))
    assert torch.equal(words, words_p)
    assert torch.equal(total_bits, total_p)
    assert torch.equal(total_bits.to(torch.int64),
                       analysis["frame_bytes"] * 8)


def _random_slots(F, M, seed):
    """Random slot tables: short fields, a few Rice quotients of up to
    9,000 zero bits (a chunk then spans three word rows), empty slots."""
    rng = np.random.default_rng(seed)
    paylen = rng.integers(0, 33, (F, M))
    leading = np.where(rng.random((F, M)) < 0.01,
                       rng.integers(1, 9000, (F, M)), 0)
    leading[paylen == 0] = 0
    payload = rng.integers(0, 1 << 32, (F, M)) & ((1 << paylen) - 1)
    lengths = paylen + leading
    wr = int(-(-lengths.sum(-1).max() // 4096)) + 1
    return tuple(torch.from_numpy(a.astype(np.int64)).to(torch.int32)
                 for a in (lengths, leading,
                           payload.astype(np.uint32).view(np.int32))), wr


@pytest.mark.parametrize("F,M,rows", [(1, 7, 0), (5, 1025, 0),
                                      (3, 8473, 0), (2, 1000, 97),
                                      (4, 3001, 200), (1, 5, 193)])
def test_merge_kernel_instantiations(dev, F, M, rows):
    """K3 on random slot tables: M not a multiple of a thread's four slots
    or a block's chunk, F = 1, words below and above 48 KiB and above the
    shared-memory cap (193 and 200 rows), each launch counted under the
    instantiation the wrapper picked. The rows are a view one row into a
    larger table, so that they start off a 16-byte boundary when M % 4,
    and two calls give the same words."""
    slots, wr = _random_slots(F + 1, M, seed=F * M + rows)
    wr = max(wr, rows)
    slots = tuple(t.to(dev)[1:] for t in slots)
    form = "shared" if k3.merge_in_shared(wr) else "global"
    before = dict(k3.merge_words.launches_by)
    words, total_bits = k3.merge_words(*slots, wr)
    assert k3.merge_words.launches_by[form] == before[form] + 1
    words_p, total_p = k3.merge_words_plain(*slots, wr)
    assert torch.equal(words, words_p)
    assert torch.equal(total_bits, total_p)
    assert torch.equal(k3.merge_words(*slots, wr)[0], words)


def test_merge_kernel_mixed_alignment(dev):
    """Rows whose three arrays start at different 16-byte offsets take
    scalar loads throughout and give the same words."""
    (lengths, leading, payload), wr = _random_slots(4, 1001, seed=11)
    lengths, payload = (t.to(dev)[1:] for t in (lengths, payload))
    leading = leading.to(dev)[1:].clone()
    words, total_bits = k3.merge_words(lengths, leading, payload, wr)
    words_p, total_p = k3.merge_words_plain(lengths, leading, payload, wr)
    assert torch.equal(words, words_p)
    assert torch.equal(total_bits, total_p)


def _level8_slots(dev, F=8, B=4096):
    frames = _tonal(2 * F, B, 16, seed=5).reshape(F, 2, B) \
        .permute(0, 2, 1).contiguous()
    cfg = frame.FrameConfig.from_params(P.set_defaults(8), 2, 16,
                                        block_size=B)
    hdr_bytes, hdr_nb = bitpack.frame_header_bytes(
        np.arange(F, dtype=np.int64), bs_code=P.blocksize_code(B),
        sr_code=P.samplerate_code(44100), allow_vbs=0)
    analysis = frame.analyze_frames(
        frames.to(dev), cfg, torch.from_numpy(hdr_nb * 8).to(dev))
    return bitpack.slot_layout(
        analysis, torch.from_numpy(hdr_bytes).to(dev),
        torch.from_numpy(hdr_nb).to(dev), cfg), bitpack.word_rows(cfg)


@pytest.mark.parametrize("case", ["level8", "random", "random_120_rows"])
def test_aligned_merge_kernel(dev, case):
    """K5 against its plain version and against K3's words."""
    if case == "level8":
        slots, wr = _level8_slots(dev)
    else:
        slots, wr = _random_slots(5, 3000, seed=7)
        slots = tuple(t.to(dev) for t in slots)
        if case == "random_120_rows":      # 60 KiB of shared words
            wr = 120
    parts = bitpack.aligned_parts(*slots)
    before = k3.merge_aligned.launches
    got = k3.merge_aligned(*parts, wr)
    assert k3.merge_aligned.launches == before + 1
    assert torch.equal(got, k3.merge_aligned_plain(*parts, wr))
    assert torch.equal(got, k3.merge_words(*slots, wr)[0])


@pytest.mark.parametrize("case", ["level8", "random", "random_120_rows",
                                  "level8_int32_min_end"])
@pytest.mark.parametrize("variant", list(prof_merge.VARIANTS))
def test_prof_merge_kernels(dev, variant, case):
    """Each U1 kernel against its plain version; in the last case a chunk
    ends at INT32_MIN, where ``cb[c + 1] - 1`` wraps to the largest row."""
    if case.startswith("level8"):
        slots, wr = _level8_slots(dev)
    else:
        slots, wr = _random_slots(5, 3000, seed=9)
        slots = tuple(t.to(dev) for t in slots)
        if case == "random_120_rows":
            wr = 120
    parts = bitpack.aligned_parts(*slots)
    if case == "level8_int32_min_end":
        cb = parts[3].clone()
        cb[0, 3] = -1 << 31     # frame 0's chunks 2 and 3 hold parts
        parts = (*parts[:3], cb)
        assert int(prof_merge.chunk_rows(cb)[1][0, 2]) == 1 << 19
    kernel, plain = prof_merge.VARIANTS[variant]
    before = kernel.launches
    got = kernel(*parts, wr)
    assert kernel.launches == before + 1
    assert torch.equal(got, plain(*parts, wr))
    if variant == "static2":
        k5 = k3.merge_aligned(*parts, wr)
        assert torch.equal(got, k5) == (case == "level8")


def _prototype_slots(dev, case):
    """(slots, word rows) for the merge prototypes: 64 frames of a tool
    batch, or random slot tables (``random_120_rows``: 60 KiB of words)."""
    if case in prof_merge2.KINDS:
        slots, cfg = prof_merge.batch_slots(case, 64, dev)
        return slots, bitpack.word_rows(cfg)
    slots, wr = _random_slots(64, 3000, seed=13)
    return tuple(t.to(dev) for t in slots), \
        120 if case == "random_120_rows" else wr


PROTOTYPE_CASES = ["music", "noise", "random", "random_120_rows"]


@pytest.mark.parametrize("case", PROTOTYPE_CASES)
@pytest.mark.parametrize("proto", ["v2", "v3"])
def test_merge_prototype_kernels(dev, proto, case):
    """``merge_v2`` and ``merge_v3`` against their plain versions at every
    fb; K5's words on the tools' batches, not on the random tables."""
    slots, wr = _prototype_slots(dev, case)
    parts = bitpack.aligned_parts(*slots)
    kernel = getattr(prof_merge2, f"merge_{proto}")
    want = getattr(prof_merge2, f"merge_{proto}_plain")(*parts, wr)
    for fb in (1, 8, 16):
        before = kernel.launches
        got = kernel(*parts, wr, fb)
        assert kernel.launches == before + 1
        assert torch.equal(got, want), fb
    assert torch.equal(want, k3.merge_aligned(*parts, wr)) \
        == (case in prof_merge2.KINDS)
    with pytest.raises(ValueError, match="multiple"):
        kernel(*parts, wr, 5)


@pytest.mark.parametrize("case", PROTOTYPE_CASES)
def test_combined_merge_kernels(dev, case):
    """``merge_v5a`` and ``merge_v5b`` against their plain version, K5 and
    K3; the random tables flag both spill sets."""
    slots, wr = _prototype_slots(dev, case)
    parts = prof_merge3.v5_parts(*slots)
    want = prof_merge3.merge_v5_plain(*parts, wr)
    for kernel in (prof_merge3.merge_v5a, prof_merge3.merge_v5b):
        before = kernel.launches
        got = kernel(*parts, wr)
        assert kernel.launches == before + 1
        assert torch.equal(got, want)
    assert torch.equal(want, k3.merge_aligned(*bitpack.aligned_parts(*slots),
                                              wr))
    assert torch.equal(want, k3.merge_words(*slots, wr)[0])
    flagged = [bool((cb[:, :-1] < 0).any()) for cb in parts[3:]]
    assert flagged == [True, case.startswith("random")]
    # a spill node in an unflagged chunk must add nothing, in either kernel
    cb2, cb1 = (cb & prof_merge3.MASK31 for cb in parts[3:])
    want = prof_merge3.merge_v5_plain(*parts[:3], cb2, cb1, wr)
    for kernel in (prof_merge3.merge_v5a, prof_merge3.merge_v5b):
        assert torch.equal(kernel(*parts[:3], cb2, cb1, wr), want)


def _combined_both(parts, wr, want):
    """``merge_v5a`` and ``merge_v5b`` on ``parts`` each give ``want``, one
    launch counted a call."""
    for kernel in (prof_merge3.merge_v5a, prof_merge3.merge_v5b):
        before = kernel.launches
        got = kernel(*parts, wr)
        assert kernel.launches == before + 1
        assert torch.equal(got, want), kernel.__name__


@pytest.mark.parametrize("flags", ["every", "none", "last"])
@pytest.mark.parametrize("case", ["music", "random"])
def test_combined_merges_flag_patterns(dev, case, flags):
    """Frames that flag every chunk of sp2 and sp1, none, or only the last
    one of each: the kernels read the flagged chunks' nodes and skip the
    rest."""
    slots, wr = _prototype_slots(dev, case)
    main, sp2, sp1, cb2, cb1 = prof_merge3.v5_parts(*slots)
    cbs = []
    for cb in (cb2, cb1):
        cb = cb & prof_merge3.MASK31
        if flags == "every":
            cb[:, :-1] |= prof_merge3.FLAG
        elif flags == "last":
            cb[:, -2] |= prof_merge3.FLAG
        cbs.append(cb)
    want = prof_merge3.merge_v5_plain(main, sp2, sp1, *cbs, wr)
    _combined_both((main, sp2, sp1, *cbs), wr, want)
    if flags == "every":
        unflagged = prof_merge3.merge_v5_plain(
            main, sp2, sp1, *(cb & prof_merge3.MASK31 for cb in cbs), wr)
        assert not torch.equal(want, unflagged)


@pytest.mark.parametrize("case", ["noise", "random"])
def test_combined_merges_unaligned_inputs(dev, case):
    """Node arrays and an output off a 16-byte boundary take the kernels'
    int-by-int loads and give the same words."""
    slots, wr = _prototype_slots(dev, case)
    main, sp2, sp1, cb2, cb1 = prof_merge3.v5_parts(*slots)
    want = prof_merge3.merge_v5_plain(main, sp2, sp1, cb2, cb1, wr)
    shifted = [tuple(_shifted(t) for t in group) for group in (main, sp2, sp1)]
    _combined_both((*shifted, cb2, cb1), wr, want)


@pytest.mark.parametrize("F,nc2,nc1", [(5, 5, 3), (3, 1, 2), (4, 6, 0),
                                       (0, 5, 3)])
def test_combined_merges_random_nodes(dev, F, nc2, nc1):
    """Random nodes with ``nc2`` no multiple of 4 (and an empty sp1, and no
    frame at all): words at and around both ends of the block and at the
    int32 extremes, zeros among the values, about half the spill chunks
    flagged."""
    rng = np.random.default_rng(F * 100 + nc2 * 10 + nc1)
    wr = 3
    W = wr * 128

    def nodes(nc, k):
        w0 = rng.integers(-4, W + 4, (F, 128, nc))
        w0[..., ::7, :] = rng.choice([-(1 << 31), -2, -1, W - 2, W - 1,
                                      (1 << 31) - 3, (1 << 31) - 1],
                                     w0[..., ::7, :].shape)
        vals = [np.where(rng.random((F, 128, nc)) < 0.2, 0,
                         rng.integers(-(1 << 31), 1 << 31, (F, 128, nc)))
                for _ in range(k)]
        return tuple(torch.from_numpy(a.astype(np.int32)).to(dev)
                     for a in (w0, *vals))

    def table(nc):
        cb = rng.integers(0, 1 << 20, (F, nc + 1))
        cb[:, :-1] |= np.where(rng.random((F, nc)) < 0.5, 1 << 31, 0)
        return torch.from_numpy(cb.astype(np.uint32).view(np.int32)).to(dev)

    parts = (nodes(nc2, 3), nodes(nc2, 3), nodes(nc1, 2), table(nc2),
             table(nc1))
    if F:
        want = prof_merge3.merge_v5_plain(*parts, wr)
        assert bool(want.any())
    else:   # no frame: nothing is launched, and the plain version needs one
        want = torch.zeros((0, wr, 128), dtype=torch.int32, device=dev)
    _combined_both(parts, wr, want)


@pytest.mark.parametrize("kmax", [4, 2])
@pytest.mark.parametrize("case", PROTOTYPE_CASES)
def test_row_layout_merge_kernels(dev, case, kmax):
    """``merge_v5d`` and ``merge_v5c`` against their plain version at every
    fb; K5's words on the frames that do not overflow the static rows; the
    zero floors against ``torch.zeros``."""
    slots, wr = _prototype_slots(dev, case)
    *rows, overflow = prof_merge3.v5d_parts(*slots, kmax, kmax - 1)
    *dual, _ = prof_merge3.v5c_parts(*slots, kmax, kmax - 1)
    want = prof_merge3.merge_v5_rows_plain(*rows, wr, kmax, kmax - 1)
    zeros = torch.zeros_like(want)
    for kernel, floor, kin in (
            (prof_merge3.merge_v5d, prof_merge3.merge_zero_rows, rows),
            (prof_merge3.merge_v5c, prof_merge3.merge_zero_fb, dual)):
        for fb in (1, 8, 16, 32):
            before = kernel.launches, floor.launches
            got = kernel(*kin, wr, fb, kmax, kmax - 1)
            nothing = floor(*kin, wr, fb)
            assert (kernel.launches, floor.launches) \
                == (before[0] + 1, before[1] + 1)
            assert torch.equal(got, want), (kernel.__name__, fb)
            assert torch.equal(nothing, zeros), (floor.__name__, fb)
        with pytest.raises(ValueError, match="multiple"):
            kernel(*kin, wr, 5, kmax, kmax - 1)
        with pytest.raises(ValueError, match="w0"):
            kernel(*(dual if kin is rows else rows), wr, 8)
    k5 = k3.merge_aligned(*bitpack.aligned_parts(*slots), wr)
    assert torch.equal(want[~overflow], k5[~overflow])
    assert bool(overflow.any()) == (case.startswith("random") or kmax == 2)
    # a spill node in an unflagged chunk must add nothing
    cb2, cb1 = (cb & prof_merge3.MASK31 for cb in rows[6:])
    want = prof_merge3.merge_v5_rows_plain(*rows[:6], cb2, cb1, wr, kmax,
                                           kmax - 1)
    assert torch.equal(prof_merge3.merge_v5d(*rows[:6], cb2, cb1, wr, 8, kmax,
                                             kmax - 1), want)
    assert torch.equal(prof_merge3.merge_v5c(*dual[:6], cb2, cb1, wr, 8, kmax,
                                             kmax - 1), want)


@pytest.mark.parametrize("case", PROTOTYPE_CASES)
def test_row_layout_merges_every_chunk_flagged(dev, case):
    """With bit 31 set in every chunk entry of cb2 and cb1 the kernels read
    every spill chunk, and still give the plain version's words."""
    slots, wr = _prototype_slots(dev, case)
    *rows, _ = prof_merge3.v5d_parts(*slots)
    *dual, _ = prof_merge3.v5c_parts(*slots)
    cb2, cb1 = (cb | prof_merge3.FLAG for cb in rows[6:])
    assert bool((cb2[:, :-1] < 0).all()) and bool((cb1[:, :-1] < 0).all())
    want = prof_merge3.merge_v5_rows_plain(*rows[:6], cb2, cb1, wr)
    for kernel, kin in ((prof_merge3.merge_v5d, rows),
                        (prof_merge3.merge_v5c, dual)):
        assert torch.equal(kernel(*kin[:6], cb2, cb1, wr, 8), want), \
            kernel.__name__


def _shifted(t, by=1):
    """``t`` in a buffer ``by`` ints off a 16-byte boundary."""
    flat = torch.empty(t.numel() + by, dtype=t.dtype, device=t.device)
    flat[by:] = t.flatten()
    return flat[by:].view(t.shape)


@pytest.mark.parametrize("case", ["noise", "random"])
def test_row_layout_merges_unaligned_inputs(dev, case):
    """Node arrays that start off a 16-byte boundary take the kernels'
    node-by-node loads and give the same words."""
    slots, wr = _prototype_slots(dev, case)
    *rows, _ = prof_merge3.v5d_parts(*slots)
    *dual, _ = prof_merge3.v5c_parts(*slots)
    want = prof_merge3.merge_v5_rows_plain(*rows, wr)
    for kernel, kin in ((prof_merge3.merge_v5d, rows),
                        (prof_merge3.merge_v5c, dual)):
        w0s = [_shifted(kin[i]) for i in (0, 2, 4)]
        vals = [tuple(_shifted(t) for t in kin[i]) for i in (1, 3, 5)]
        got = kernel(w0s[0], vals[0], w0s[1], vals[1], w0s[2], vals[2],
                     *kin[6:], wr, 8)
        assert torch.equal(got, want), kernel.__name__


def test_merge_v3_kernel_unaligned_inputs(dev):
    """As ``merge_v2``'s: the slot-by-slot loads give the same words."""
    slots, wr = _prototype_slots(dev, "random")
    parts = bitpack.aligned_parts(*slots)
    got = prof_merge2.merge_v3(*(_shifted(t) for t in parts[:3]), parts[3],
                               wr, 8)
    assert torch.equal(got, prof_merge2.merge_v3_plain(*parts, wr))


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_v3_kernel_unordered_bounds(dev, seed):
    """``merge_v3`` needs no order of the chunk bounds: random bounds,
    decreasing and negative ones among them, a chunk that ends at
    INT32_MIN, and words around and outside the block give the plain
    version's words."""
    rng = np.random.default_rng(seed)
    F, nc, wr = 16, 40, 20
    W = wr * 128
    cb = rng.integers(-6 * 4096, (wr + 6) * 4096, (F, nc + 1))
    cb[0] = np.sort(cb[0])[::-1]
    cb[1, 5:7] = [2 * 4096 + 7, -1 << 31]
    w0t = rng.integers(-300, W + 300, (F, 128, nc))
    hit, lot = (rng.integers(-1 << 31, 1 << 31, (F, 128, nc))
                for _ in range(2))
    parts = [torch.from_numpy(a.astype(np.int32)).to(dev)
             for a in (w0t, hit, lot, cb)]
    got = prof_merge2.merge_v3(*parts, wr, 8)
    want = prof_merge2.merge_v3_plain(*parts, wr)
    assert torch.equal(got, want)
    assert bool(want.any())


@pytest.mark.parametrize("case", PROTOTYPE_CASES)
def test_merge_v2_kernel_every_fb(dev, case):
    """``merge_v2``, one block a frame, against its plain version at every
    fb the tools use and at 32, one launch counted a call; an fb that does
    not divide the frames is refused."""
    slots, wr = _prototype_slots(dev, case)
    parts = bitpack.aligned_parts(*slots)
    want = prof_merge2.merge_v2_plain(*parts, wr)
    for fb in (1, 4, 8, 16, 32):
        before = prof_merge2.merge_v2.launches
        got = prof_merge2.merge_v2(*parts, wr, fb)
        assert prof_merge2.merge_v2.launches == before + 1
        assert torch.equal(got, want), fb
    with pytest.raises(ValueError, match="multiple"):
        prof_merge2.merge_v2(*parts, wr, 5)


def test_merge_v2_kernel_unaligned_inputs(dev):
    """Input arrays that start off a 16-byte boundary take the kernel's
    slot-by-slot loads and give the same words."""
    slots, wr = _prototype_slots(dev, "random")
    parts = bitpack.aligned_parts(*slots)
    shifted = []
    for t in parts[:3]:
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        flat[1:] = t.flatten()
        shifted.append(flat[1:].view(t.shape))
    got = prof_merge2.merge_v2(*shifted, parts[3], wr, 8)
    assert torch.equal(got, prof_merge2.merge_v2_plain(*parts, wr))


def _floor_operands(dev, F):
    """K5's parts and v5d's and v5c's operands of F random frames: what
    the three zero floors take (and do not read); then v5a's."""
    slots, _ = _random_slots(F, 300, seed=F)
    slots = tuple(t.to(dev) for t in slots)
    *rows, _ = prof_merge3.v5d_parts(*slots)
    *dual, _ = prof_merge3.v5c_parts(*slots)
    return (bitpack.aligned_parts(*slots), rows, dual,
            prof_merge3.v5_parts(*slots))


@pytest.mark.parametrize("F,word_rows,fbs", [(64, 34, (1, 8, 16, 32)),
                                             (3, 1, (1, 3))])
def test_zero_floor_kernels(dev, F, word_rows, fbs):
    """The one zero floor behind U1's zero variant and U3e / U3f gives
    zeros at every fb, also where F * W is no multiple of a block's
    stores (F = 3, one word row), one launch counted a call; an fb that
    does not divide the frames is refused."""
    parts, rows, dual, _ = _floor_operands(dev, F)
    zeros = torch.zeros((F, word_rows, 128), dtype=torch.int32, device=dev)
    before = prof_merge.merge_zero.launches
    assert torch.equal(prof_merge.merge_zero(*parts, word_rows), zeros)
    assert prof_merge.merge_zero.launches == before + 1
    for floor, kin in ((prof_merge3.merge_zero_rows, rows),
                       (prof_merge3.merge_zero_fb, dual)):
        for fb in fbs:
            before = floor.launches
            assert torch.equal(floor(*kin, word_rows, fb), zeros), fb
            assert floor.launches == before + 1
        with pytest.raises(ValueError, match="multiple"):
            floor(*kin, word_rows, 2 if F == 3 else 5)


SENTINEL = 0x5A5A5A5A


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("F,word_rows", [(8, 34), (3, 1)])
def test_kernels_write_their_block_only(dev, F, word_rows, offset):
    """Each zero floor entry, ``merge_v2``, ``merge_v3``, ``merge_v5a``,
    ``merge_v5b``, ``merge_v5d`` and ``merge_v5c`` write into a view
    ``offset`` ints into a larger buffer prefilled with a sentinel: every
    word of the [F, W] block is written and nothing around it is touched,
    whether the view starts on a 16-byte boundary or not (the 16-byte and
    the one-at-a-time instantiations)."""
    from flake_tpu_torch import _cuda

    parts, rows, dual, combined = _floor_operands(dev, F)
    W = word_rows * 128
    nc = parts[0].shape[-1]
    launches = {
        "flake_prof_merge_zero": lambda out: (*parts[3:], *parts[:3], out, F,
                                              nc, W),
        "flake_prof_merge_zero_rows": lambda out: (
            rows[6], rows[7], rows[0], *rows[1], rows[2], *rows[3], rows[4],
            *rows[5], out, F, rows[1][0].shape[1], rows[5][0].shape[1], W,
            1),
        "flake_prof_merge_zero_fb": lambda out: (
            dual[6], dual[7], dual[0], *dual[1], dual[2], *dual[3], dual[4],
            *dual[5], out, F, dual[1][0].shape[1], dual[5][0].shape[1], W,
            F),
        "flake_prof_merge_v2": lambda out: (*parts[3:], *parts[:3], out, F,
                                            nc, W),
        "flake_prof_merge_v3": lambda out: (*parts[3:], *parts[:3], out, F,
                                            nc, W),
        **{f"flake_prof_merge_{name}": lambda out, kin=kin: (
            kin[6], kin[7], kin[0], *kin[1], kin[2], *kin[3], kin[4],
            *kin[5], out, F, kin[1][0].shape[1], kin[5][0].shape[1], W,
            prof_merge3.KMAX, prof_merge3.KMAX1)
           for name, kin in (("v5d", rows), ("v5c", dual))},
        **{f"flake_prof_merge_{name}": lambda out: (
            *combined[3:], *combined[0], *combined[1], *combined[2], out, F,
            combined[0][0].shape[-1], combined[2][0].shape[-1], W)
           for name in ("v5a", "v5b")}}
    wants = {name: torch.zeros(F * W, dtype=torch.int32, device=dev)
             for name in launches}
    wants["flake_prof_merge_v2"] = prof_merge2.merge_v2_plain(
        *parts, word_rows).flatten()
    wants["flake_prof_merge_v3"] = prof_merge2.merge_v3_plain(
        *parts, word_rows).flatten()
    wants["flake_prof_merge_v5d"] = wants["flake_prof_merge_v5c"] = \
        prof_merge3.merge_v5_rows_plain(*rows, word_rows).flatten()
    wants["flake_prof_merge_v5a"] = wants["flake_prof_merge_v5b"] = \
        prof_merge3.merge_v5_plain(*combined, word_rows).flatten()
    assert bool(wants["flake_prof_merge_v5d"].any())
    assert bool(wants["flake_prof_merge_v5a"].any())
    for name, args in launches.items():
        buf = torch.full((offset + F * W + 7,), SENTINEL, dtype=torch.int32,
                         device=dev)
        _cuda.launch(name, dev, *args(buf[offset:offset + F * W]))
        torch.cuda.synchronize()
        assert bool((buf[:offset] == SENTINEL).all()), name
        assert bool((buf[offset + F * W:] == SENTINEL).all()), name
        assert torch.equal(buf[offset:offset + F * W], wants[name]), name


def test_spin_and_device_ms(dev):
    """The tool's spinning kernel holds the stream for the time asked, and
    a single short kernel is timed back to back behind it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    prof_merge.spin(dev, 1.0)
    start.record()
    prof_merge.spin(dev, 5.0)
    end.record()
    end.synchronize()
    assert 5.0 <= start.elapsed_time(end) < 8.0
    slots, wr = _level8_slots(dev)
    parts = bitpack.aligned_parts(*slots)
    def run():
        return k3.merge_aligned(*parts, wr)

    ms = prof_merge.device_ms(run, dev, back_to_back=True)
    assert 0 < ms <= prof_merge.device_ms(run, dev) + 0.005


def test_est_recursions_on_the_card(dev):
    """Schur and the seeded Levinson round on the card as on the host
    (the silent row's NaNs count as equal)."""
    x = _tonal(64, 4096, 16, seed=3).to(dev)
    autoc = lpc.autocorr(x, 8, lpc.welch_window_on(4096, dev))
    refs = lpc.schur_refs(autoc)
    np.testing.assert_array_equal(refs.cpu().numpy(),
                                  lpc.schur_refs(autoc.cpu()).numpy())
    np.testing.assert_array_equal(
        lpc.levinson_from_refs(refs).cpu().numpy(),
        lpc.levinson_from_refs(refs.cpu()).numpy())
    assert torch.equal(lpc.estimate_order(refs, 8).cpu(),
                       lpc.estimate_order(refs.cpu(), 8))


@pytest.mark.parametrize("level", [5, 7, 3, 0])
def test_encoder_low_levels_cuda_matches_cpu(dev, level):
    """Levels below 8 at their own widths: CUDA bytes equal CPU bytes."""
    cfg = P.StreamConfig(params=P.set_defaults(level))
    n = 6 * cfg.params.block_size + 777
    t = np.arange(n)
    rng = np.random.default_rng(level)
    pcm = np.stack([9000 * np.sin(2 * np.pi * 220 * t / 44100),
                    7000 * np.sin(2 * np.pi * 330 * t / 44100)], 1) \
        + rng.normal(0, 200, (n, 2))
    pcm = np.clip(np.rint(pcm), -32768, 32767).astype(np.int32)
    got = flake_tpu_torch.Encoder(cfg, device=dev,
                                  batch_frames=4).encode_stream(pcm)
    want = flake_tpu_torch.Encoder(cfg, device="cpu",
                                   batch_frames=4).encode_stream(pcm)
    assert got == want


def test_search_ties_on_the_card(dev):
    """SEARCH on the card picks the order the CPU picks, ties included."""
    rng = np.random.default_rng(5)
    bits = torch.from_numpy(rng.integers(100, 103, (4096, 32)))
    bits[0] = 7
    bits[1, [4, 20, 31]] = 50
    cfg = frame.FrameConfig.from_params(P.set_defaults(12), 2, 16)
    got = frame.select_order(cfg, bits.to(dev), None, (4096,), dev)
    want = frame.select_order(cfg, bits, None, (4096,),
                              torch.device("cpu"))
    assert torch.equal(got.cpu(), want)
    assert want[0] == 1 and want[1] == 5


def test_ties_on_the_card(dev):
    """The Rice k scan and the stereo mode on the card pick the index the
    CPU picks on equal counts: the first minimum."""
    from flake_tpu_torch.ops import stereo

    rng = np.random.default_rng(6)
    nbits = torch.from_numpy(rng.integers(10, 13, (4096, 31)))
    nbits[0] = 7
    nbits[1, [3, 17]] = 2
    got = rice._first_min(nbits.to(dev))
    want = rice._first_min(nbits)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert want[0][0] == 0 and want[0][1] == 3
    sums = torch.arange(0, 3000, dtype=torch.int64)
    for cnt in (1, 16, 4096):
        assert torch.equal(rice.find_optimal_k(sums.to(dev), cnt)[0].cpu(),
                           rice.find_optimal_k(sums, cnt)[0])
        assert torch.equal(
            rice.find_optimal_k_u32(sums.to(dev), cnt)[0].cpu(),
            rice.find_optimal_k_u32(sums, cnt)[0])
    left = torch.from_numpy(rng.integers(-3000, 3000, (64, 256))
                            .astype(np.int32))
    right = torch.from_numpy(rng.integers(-3000, 3000, (64, 256))
                             .astype(np.int32))
    right[0] = left[0]
    left[1] = right[1] = 0
    mode = stereo.decorr_mode(left.to(dev), right.to(dev), 256)
    assert torch.equal(mode.cpu(), stereo.decorr_mode(left, right, 256))
    assert mode[0] == stereo.LEFT_SIDE and mode[1] == stereo.LEFT_RIGHT


def _rice_sums(rng, rows, n, pmax, sub=1):
    """Partition sums as the sweeps give them (per-row magnitudes 2^0 to
    2^20 a sample, some zero partitions) and, on an eighth of the rows,
    sums from 2^32 up (the limb form's high half, wrapping counts)."""
    from flake_tpu_torch.ops import rice

    ps = rice.limit_max_partition_order(pmax, n, 1)
    parts = (1 << ps) * sub
    mean = 2.0 ** rng.uniform(0, 20, (rows, 1))
    s = rng.gamma(4.0, mean / 4.0 * (n >> ps) / sub, (rows, parts)) \
        .astype(np.int64)
    s[rng.random((rows, parts)) < 0.05] = 0
    big = rng.random(rows) < 0.125
    s[big] = rng.integers(1 << 32, max(n, 2) << 32, (int(big.sum()), parts))
    return torch.from_numpy(s)


def _tie_sums(rng, rows):
    """Rows of 8 small partition sums (n 64, pmax 3): about 5% tie in the
    partition-order scan, most in some k scan."""
    s = rng.integers(0, 1 + (1 << rng.integers(0, 5, (rows, 1))) * 8,
                     (rows, 8))
    s[:, 4:] *= rng.integers(1, 6, (rows, 1))
    return torch.from_numpy(s)


@pytest.mark.parametrize("case,n,pmax,orders,streams,sub", [
    ("level 8", 4096, 6, 12, 1024, 1),
    ("level 12", 8192, 8, 32, 1024, 1),
    ("level 12, granules of 16", 8192, 8, 32, 64, 2),
    ("warm-up past a partition", 4096, 8, 32, 64, 1),
    ("tail 777", 777, 8, 32, 16, 1),
    ("ties", 64, 3, 5, 4000, 1)])
def test_rice_scan_kernel(dev, case, n, pmax, orders, streams, sub):
    """R1 against its plain version, bit for bit, on every output."""
    from flake_tpu_torch.ops import rice

    rng = np.random.default_rng(n + orders)
    sums = _tie_sums(rng, streams * orders) if case == "ties" \
        else _rice_sums(rng, streams * orders, n, pmax, sub)
    # a stream's rows at orders 1..orders (0..orders - 1 in the tie table)
    order = torch.arange(orders, dtype=torch.int32) + (case != "ties")
    sums = sums.reshape(streams, orders, -1)
    before = rice.rice_scan.launches
    got = rice.rice_scan(sums.to(dev), order.to(dev), n, 0, pmax)
    torch.cuda.synchronize()
    assert rice.rice_scan.launches == before + 1
    want = rice.rice_scan_plain(sums.to(dev), order.to(dev), n, 0, pmax)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), case


def _pass_rows(rng, N, n, max_order):
    """Samples, coefficients, shifts and orders of R2: tones with noise at
    16 bits under quantizer-sized coefficients and shifts; rows of -2..2
    (ties); 32-bit rows at the int32 limits under order-32 coefficients
    near +-2^14 and shift 15 (exact residuals past int32, fits false); and
    the fixed predictors (shift 0) on a quarter of the rows."""
    from flake_tpu_torch.ops import predict

    t = np.arange(n)
    smp = 12000 * np.sin(2 * np.pi * rng.uniform(50, 4000, (N, 1)) * t
                         / 44100) + rng.normal(0, 300, (N, n))
    smp[::4] = rng.integers(-2, 3, (len(smp[::4]), n))
    smp[1::8] = rng.choice([-2**31, -2**30 - 1, -2**30, 2**30 - 1, 2**30,
                            2**31 - 1], (len(smp[1::8]), n))
    smp = np.clip(np.rint(smp), -2**31, 2**31 - 1).astype(np.int32)
    order = rng.integers(0, max_order + 1, N).astype(np.int32)
    coefs = (rng.integers(-2**14, 2**14, (N, max_order))
             >> rng.integers(0, 8, (N, 1))).astype(np.int32)
    shift = rng.integers(0, 16, N).astype(np.int32)
    coefs[1::8], shift[1::8] = rng.integers(-2**14, 2**14,
                                            (len(coefs[1::8]), max_order)), 15
    fixed = np.arange(N) % 4 == 3
    fo = np.minimum(order[fixed], min(4, max_order))
    order[fixed] = fo
    coefs[fixed] = 0
    coefs[fixed, :min(4, max_order)] = predict.fixed_coefs(
        torch.from_numpy(fo), min(4, max_order)).numpy()
    shift[fixed] = 0
    return map(torch.from_numpy, (smp, coefs, shift, order))


@pytest.mark.parametrize("n,pmin,pmax,max_order,N", [
    (4096, 0, 6, 12, 1024), (8192, 0, 8, 32, 1024), (4608, 0, 8, 4, 64),
    (1152, 2, 8, 4, 64), (777, 0, 8, 32, 64), (20, 0, 8, 4, 64),
    (3, 0, 8, 2, 16), (64, 0, 3, 4, 2048), (16384, 0, 8, 32, 64),
    (65535, 0, 8, 12, 8)])
def test_rice_final_kernel(dev, n, pmin, pmax, max_order, N):
    """R2 (the final pass from the samples) against its plain version, bit
    for bit, on every output, with [F, C] leading dims as the FIXED path
    passes them; rows above 8,192 samples read their residual back from
    device memory."""
    from flake_tpu_torch.ops import rice

    rng = np.random.default_rng(n + N)
    smp, coefs, shift, order = (t.reshape((N // 2, 2) + t.shape[1:]).to(dev)
                                for t in _pass_rows(rng, N, n, max_order))
    before = rice.final_pass.launches
    got = rice.final_pass(smp, coefs, shift, order, n, pmin, pmax)
    torch.cuda.synchronize()
    assert rice.final_pass.launches == before + 1
    want = rice.final_pass_plain(smp, coefs, shift, order, n, pmin, pmax)
    assert set(got) == set(want)
    for key, w in want.items():
        assert got[key].dtype == w.dtype and torch.equal(got[key], w), key
    if max_order == 32 and n >= 777:
        assert not got["fits"].all()


@pytest.mark.parametrize("N", [1, 2, 512])
def test_final_pass_reads_a_column_slice(dev, N):
    """R2 on the first 12 columns of a 32-tap table (S's padded rows, the
    columns past 12 filled with other taps), in place and with [F, C]
    leading dims, equals its plain version on the contiguous rows."""
    from flake_tpu_torch.ops import rice

    rng = np.random.default_rng(N)
    smp, coefs, shift, order = (t.to(dev)
                                for t in _pass_rows(rng, N, 4096, 12))
    wide = torch.from_numpy(rng.integers(-2**14, 2**14, (N, 32)).astype(
        np.int32)).to(dev)
    wide[:, :12] = coefs
    want = rice.final_pass_plain(smp, coefs, shift, order, 4096, 0, 8)
    F = 1 if N == 1 else N // 2
    for view in (wide[:, :12], wide.reshape(F, -1, 32)[..., :12]):
        got = rice.final_pass(smp.reshape(view.shape[:-1] + (4096,)), view,
                              shift.reshape(view.shape[:-1]),
                              order.reshape(view.shape[:-1]), 4096, 0, 8)
        for key, w in want.items():
            g = got[key].reshape(w.shape)
            assert g.dtype == w.dtype and torch.equal(g, w), key


@pytest.mark.parametrize("level", [8, 2])
def test_final_pass_is_one_launch(dev, level, monkeypatch):
    """On the card, the LPC (level 8) and FIXED (level 2) final passes are
    R2 alone: one launch a batch, and no lag loop, wrap or fit check of
    the plain version runs."""
    from flake_tpu_torch.ops import predict, rice

    def refuse(name):
        def run(*args, **kwargs):
            raise AssertionError(f"{name} ran on the card")
        return run

    for mod, name in ((predict, "residual_lpc_dynamic64"),
                      (predict, "fits_int32"), (rice, "wrap_int32"),
                      (rice, "final_pass_plain"), (rice, "rice_final_plain")):
        monkeypatch.setattr(mod, name, refuse(name))
    B = P.set_defaults(level).block_size
    x = torch.stack([_tonal(4, B, 16, level)] * 2, -1).to(dev)
    cfg = frame.FrameConfig.from_params(P.set_defaults(level), 2, 16)
    before = rice.final_pass.launches
    frame.analyze_frames(x, cfg, torch.full((4,), 48, dtype=torch.int32,
                                            device=dev))
    torch.cuda.synchronize()
    assert rice.final_pass.launches == before + 1


def test_rice_kernels_refuse_other_types(dev):
    from flake_tpu_torch.ops import rice

    with pytest.raises(ValueError, match="sums"):
        rice.rice_scan(torch.zeros((4, 64), dtype=torch.int32, device=dev),
                       torch.ones(4, dtype=torch.int32, device=dev), 4096, 0,
                       6)
    smp = torch.zeros((4, 64), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="order"):
        rice.final_pass(smp, smp[:, :4], smp[:, 0],
                        torch.ones(4, dtype=torch.int64, device=dev), 64, 0,
                        3)
    with pytest.raises(ValueError, match="taps"):
        rice.final_pass(smp, smp[:, :33], smp[:, 0], smp[:, 0], 64, 0, 3)


def test_encoder_cuda_matches_cpu(dev):
    """The stream through the kernels equals the CPU path's bytes."""
    n = 40 * 1024 + 20
    t = np.arange(n)
    rng = np.random.default_rng(1)
    pcm = np.stack([9000 * np.sin(2 * np.pi * 220 * t / 44100),
                    7000 * np.sin(2 * np.pi * 330 * t / 44100)], 1) \
        + rng.normal(0, 200, (n, 2))
    pcm = np.clip(np.rint(pcm), -32768, 32767).astype(np.int32)
    pcm[5 * 1024:6 * 1024] = 0
    cfg = P.StreamConfig(params=P.set_defaults(8))
    cfg.params.block_size = 1024
    counters = (k1.autocorr, k2.sweep_sums, k3.merge_words)
    before = [c.launches for c in counters]
    got = flake_tpu_torch.Encoder(cfg, device=dev,
                                  batch_frames=16).encode_stream(pcm)
    assert all(c.launches > b for c, b in zip(counters, before))
    want = flake_tpu_torch.Encoder(cfg, device="cpu",
                                   batch_frames=16).encode_stream(pcm)
    assert got == want


def test_encoder_vbs_cuda_matches_cpu(dev):
    """Level 12 at full width (superblocks of 8192, order 32): the
    stream through the kernels, K4 included, equals the CPU path's
    bytes."""
    n = 4 * 8192 + 700
    t = np.arange(n)
    rng = np.random.default_rng(12)
    env = np.where((t // 4096) % 2, 1.0, 0.2)
    pcm = env[:, None] * np.stack([9000 * np.sin(2 * np.pi * 220 * t / 44100),
                                   7000 * np.sin(2 * np.pi * 330 * t / 44100)],
                                  1) + rng.normal(0, 100, (n, 2))
    pcm[3 * 8192:3 * 8192 + 6000] = 0
    pcm = np.clip(np.rint(pcm), -32768, 32767).astype(np.int32)
    cfg = P.StreamConfig(params=P.set_defaults(12))
    counters = (k1.autocorr, k2.sweep_sums, k3.merge_words, k4)
    before = [c.launches for c in counters]
    got = flake_tpu_torch.Encoder(cfg, device=dev,
                                  batch_frames=16).encode_stream(pcm)
    assert all(c.launches > b for c, b in zip(counters, before))
    want = flake_tpu_torch.Encoder(cfg, device="cpu",
                                   batch_frames=16).encode_stream(pcm)
    assert got == want


@pytest.mark.parametrize("args", [["-5", "-b", "4608"], ["-8"],
                                  ["-5", "-b", "4608", "--pack-backend",
                                   "host"]])
def test_cli_on_the_card_equals_the_cpu(dev, tmp_path, args):
    """The command line on the card writes the file it writes on the CPU
    (BASELINE config 1 at a short length, level 8, and the host
    emission), and decodes to the WAV's samples."""
    from flake_tpu_torch import cli, decoder
    from flake_tpu_torch.io.wav import write_wave

    n = 7 * 4608 + 999
    t = np.arange(n)
    rng = np.random.default_rng(4608)
    pcm = np.stack([9000 * np.sin(2 * np.pi * 220 * t / 44100),
                    7000 * np.sin(2 * np.pi * 331 * t / 44100)], 1) \
        + rng.normal(0, 150, (n, 2))
    pcm[2 * 4608:3 * 4608] = 0
    pcm = np.clip(np.rint(pcm), -32768, 32767).astype(np.int32)
    wav = tmp_path / "in.wav"
    write_wave(wav, pcm, 44100, 16)
    out = {}
    for device in ("cuda", "cpu"):
        out[device] = tmp_path / f"{device}.flac"
        assert cli.main(["-q", "--device", device, *args, str(wav), "-o",
                         str(out[device])]) == 0
    blob = out["cuda"].read_bytes()
    assert blob == out["cpu"].read_bytes()
    dec = decoder.decode_stream(blob)
    assert dec.md5_ok
    np.testing.assert_array_equal(dec.samples, pcm)


# -- L: the LPC coefficient stage -------------------------------------------

def _same_bits(got, want):
    """Equal dtype, shape and bits; two NaNs count as equal."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.is_floating_point:
        nan = got.isnan() & want.isnan()
        bits = {torch.float32: torch.int32,
                torch.float64: torch.int64}[got.dtype]
        got = torch.where(nan, 0, got.view(bits))
        want = torch.where(nan, 0, want.view(bits))
    bad = int((got != want).sum())
    assert bad == 0, f"{bad} of {got.numel()} differ"


def _candidates_on_card(autoc, est, precision):
    """L against its plain version on the same card tensor: every output
    bit for bit; one launch."""
    before = lpc.candidates.launches
    got = lpc.candidates(autoc, est, precision)
    torch.cuda.synchronize()
    assert lpc.candidates.launches == before + 1
    want = lpc.candidates_plain(autoc, est, precision)
    for g, w in zip(got, want):
        _same_bits(g, w)
    return got


def _stream_autoc(N, B, max_order, seed, dev):
    x = _tonal(N, B, 16, seed).to(dev)
    x[3::7] //= 1000                                  # quiet streams
    return k1.autocorr(x, lpc.welch_window_on(B, dev), max_order)


def _boundary_autoc(precision):
    """[1, c, 0, 0, 0] for c at the quantizer's edges: row 0 is c, the
    higher rows are far from positive definite."""
    qmax = (1 << (precision - 1)) - 1
    edges = [qmax * 2.0 ** -sh for sh in range(16)] \
        + [2.0 ** k for k in range(-20, 21)] \
        + [qmax + 0.5, qmax + 1.0, 2.0 * qmax, 1e6, 1e30, 1e300]
    c = [0.0, -0.0, 5e-324, 1e-310, 2.2250738585072014e-308]
    for e in edges:
        c += [np.nextafter(e, 0.0), e, np.nextafter(e, np.inf)]
    c = np.asarray(c)
    c = np.concatenate([c, -c[c != 0]])
    autoc = np.zeros((c.size, 5))
    autoc[:, 0], autoc[:, 1] = 1.0, c
    return torch.from_numpy(autoc)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("est", [False, True], ids=["levinson", "est"])
@pytest.mark.parametrize("max_order,precision,N", [
    (1, 15, 12), (12, 15, 1024), (12, 5, 77), (32, 15, 428), (32, 5, 3),
    (8, 15, 1), (32, 15, 13696), (7, 11, 5)])
def test_candidates_kernel_on_streams(dev, max_order, precision, N, est,
                                      dtype):
    """Windowed autocorrelations (silent, constant and quiet streams
    among them; the silent one's Schur gives NaNs) at the orders and
    precisions the levels use and the edges, N from 1 to 13,696 (the
    level-12 batch's bucket of 4096 at order 32)."""
    autoc = _stream_autoc(N, 1024 if N > 1024 else 4096, max_order,
                          max_order * N, dev).to(dtype)
    q, sh, _ = _candidates_on_card(autoc, est, precision)
    if N > 1:
        assert (q[0] != 0).any() and (sh[0] > 0).any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("est", [False, True], ids=["levinson", "est"])
@pytest.mark.parametrize("precision", range(5, 16))
def test_candidates_kernel_shift_boundaries(dev, precision, est, dtype):
    """cmax at 0, subnormals, powers of two, the qmax * 2^-sh boundaries
    and their neighbours, the zero-out edge and above qmax (scale-down),
    and the inf and NaN rows above them."""
    autoc = _boundary_autoc(precision).to(dev, dtype)
    q, sh, _ = _candidates_on_card(autoc, est, precision)
    assert (sh[:, 0] == 15).any() and (sh[:, 0] == 0).any()
    assert (q[:, 0, 0].abs() == (1 << (precision - 1)) - 1).any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("est", [False, True], ids=["levinson", "est"])
def test_candidates_kernel_degenerate(dev, est, dtype):
    """Zero, negative, huge, inf and NaN lags; a zero or negative lag 0."""
    rng = np.random.default_rng(17)
    autoc = rng.normal(0, 1, (40, 33)) * 10.0 ** rng.integers(-5, 6, (40, 1))
    autoc[:, 0] = np.abs(autoc[:, 0])
    autoc[0], autoc[1], autoc[2, 0], autoc[3, 0] = 0.0, 2.0, 0.0, -1.0
    autoc[4, 3], autoc[5, 2], autoc[7, 1:] = np.inf, np.nan, 0.0
    _, _, refs = _candidates_on_card(
        torch.from_numpy(autoc).to(dev, dtype), est, 15)
    assert refs.isnan().any() or refs.isinf().any()


def test_candidates_kernel_noncontiguous_and_batched(dev):
    """A strided [2, 6, 13] view (every other column of a wider tensor)
    gives the plain version's bits in the batch's shape."""
    wide = _stream_autoc(12, 4096, 25, 5, dev).reshape(2, 6, 26)
    autoc = wide[..., ::2]
    assert not autoc.is_contiguous()
    q, sh, refs = _candidates_on_card(autoc, False, 15)
    assert q.shape == (2, 6, 12, 12) and sh.shape == refs.shape == (2, 6, 12)


@pytest.mark.parametrize("level", [5, 8, 12])
def test_candidates_kernel_on_encoder_calls(dev, level, monkeypatch):
    """Every call the encoder makes at levels 5 (EST), 8 and 12 on 3 s of
    music-like signal is one launch of L and equals the plain version;
    no recursion of the plain version runs on the card."""
    calls = []
    kern = lpc.candidates

    @functools.wraps(kern)      # carries .launches, which L counts on
    def record(autoc, est, precision):
        calls.append((autoc.clone(), est, precision))
        return kern(autoc, est, precision)

    def refuse(name):
        def run(*args, **kwargs):
            raise AssertionError(f"{name} ran on the card")
        return run

    monkeypatch.setattr(lpc, "candidates", record)
    for name in ("levinson_all_orders", "schur_refs", "levinson_from_refs",
                 "quantize_lpc_coefs"):
        monkeypatch.setattr(lpc, name, refuse(name))
    n = 3 * 44100
    t = np.arange(n)
    rng = np.random.default_rng(level)
    pcm = np.stack([9000 * np.sin(2 * np.pi * 220 * t / 44100),
                    7000 * np.sin(2 * np.pi * 330 * t / 44100)], 1) \
        + rng.normal(0, 300, (n, 2))
    pcm[44100:50000] = 0
    pcm = np.clip(np.rint(pcm), -32768, 32767).astype(np.int32)
    cfg = P.StreamConfig(params=P.set_defaults(level))
    flake_tpu_torch.Encoder(cfg, device=dev).encode_stream(pcm)
    monkeypatch.undo()
    assert calls and all(est == (level == 5) for _, est, _ in calls)
    for autoc, est, precision in calls:
        _candidates_on_card(autoc, est, precision)


def test_candidates_kernel_refuses(dev):
    with pytest.raises(ValueError, match="max order"):
        lpc.candidates(torch.ones((4, 34), dtype=torch.float64, device=dev),
                       False, 15)
    with pytest.raises(ValueError, match="int32"):
        lpc.candidates(torch.ones((4, 13), dtype=torch.int32, device=dev),
                       False, 15)



def _mixed_autoc(N, m, seed, dev, dtype):
    """N windowed-stream autocorrelations at max order m with degenerate
    rows among them: silent (all zero, whose Schur gives NaNs), a NaN lag,
    an inf lag, a zero lag 0 under nonzero lags, a negative lag 0."""
    autoc = _stream_autoc(N, 1024 if N > 64 else 4096, m, seed, dev)
    bad = [np.zeros(m + 1), np.full(m + 1, np.nan), np.full(m + 1, np.inf),
           np.r_[0.0, np.ones(m)], np.r_[-1.0, np.full(m, 0.5)]]
    for row, values in zip(range(0, N, 3), bad):
        autoc[row] = torch.from_numpy(values)
    return autoc.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("est", [False, True], ids=["levinson", "est"])
@pytest.mark.parametrize("m", [1, 2, 31, 32])
@pytest.mark.parametrize("N", [1, 5, 1024])
def test_candidates_kernel_orders_and_counts(dev, N, m, est, dtype):
    """L on 1, 5 and 1,024 streams (one block short of full, several
    full) at max orders 1, 2, 31 and 32 (each unrolled bound's edge; 31 and
    1, 2 write their rows tap by tap, 32 in 16-byte stores), NaN and
    degenerate rows among them, in both dtypes and both modes."""
    autoc = _mixed_autoc(N, m, N * 64 + m, dev, dtype)
    q, sh, refs = _candidates_on_card(autoc, est, 15)
    assert q.shape == (N, m, m) and sh.shape == refs.shape == (N, m)

# -- S, X, H and E: the analysis's and the emission's launch chains ---------

def _order_bits(rng, N, m):
    """int64 per-order bits: a narrow range (ties everywhere), rows of
    U32_MASK, rows tied throughout, full-range uint32 rows."""
    bits = rng.integers(1000, 1004, (N, m)).astype(np.int64)
    bits[0] = 7
    bits[1] = 0xFFFFFFFF
    bits[2, ::2] = 0xFFFFFFFF
    bits[3:64] = rng.integers(0, 1 << 32, (61, m))
    bits[64:80, -1] = 0
    return torch.from_numpy(bits)


@pytest.mark.parametrize("method", [P.OrderMethod.LEVEL2, P.OrderMethod.LEVEL4,
                                    P.OrderMethod.LEVEL8,
                                    P.OrderMethod.SEARCH, P.OrderMethod.LOG])
@pytest.mark.parametrize("m,min_o,N", [(12, 1, 1024), (32, 1, 13696),
                                       (8, 1, 1), (32, 3, 300), (1, 1, 77),
                                       (12, 12, 129)])
def test_select_order_kernel(dev, method, m, min_o, N):
    """S against its plain version on tables with ties and U32_MASK, at
    the level-8 batch (1,024 streams of order 12) and the level-12 bucket
    (13,696 of 32) and the edges: one stream, one order, min = max."""
    bits = _order_bits(np.random.default_rng(m * 7 + N), max(N, 80), m)[:N]
    before = frame.select_order_bits.launches
    got = frame.select_order_bits(bits.to(dev), int(method), min_o, m)
    assert frame.select_order_bits.launches == before + 1
    want = frame.select_order_bits_plain(bits, int(method), min_o, m)
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


def _candidate_inputs(rng, N, m):
    """S's inputs with the gather: bit tables as above with values past
    2^32, reflection coefficients with NaN, zero and 0.10 rows, random
    quantized rows and shifts."""
    bits = _order_bits(rng, max(N, 80), m)[:N].clone()
    bits[N // 2:N // 2 + 2] += 1 << 32
    refs = torch.from_numpy(rng.normal(0, 0.15, (N, m)))
    refs[::7] = float("nan")
    refs[1::7] = 0.0
    refs[2::7] = 0.10
    refs[3::7, ::2] = float("nan")
    qcoefs = torch.from_numpy(rng.integers(-2**31, 2**31, (N, m, m),
                                           dtype=np.int64).astype(np.int32))
    shifts = torch.from_numpy(rng.integers(-16, 16, (N, m))
                              .astype(np.int32))
    return bits, refs, qcoefs, shifts


@pytest.mark.parametrize("m", [1, 2, 5, 8, 12, 17, 31, 32])
@pytest.mark.parametrize("N", [1, 5, 33, 1024])
def test_select_kernel_both_forms(dev, m, N):
    """S with the gather (``select_candidate``) under every order method,
    EST on float64 and float32 reflection coefficients, and without it
    (``select_order_bits``) under the methods that read bits, each one
    launch equal to its plain version bit for bit."""
    bits, refs, qcoefs, shifts = _candidate_inputs(
        np.random.default_rng(m * 1000 + N), N, m)
    for method in P.OrderMethod:
        reads = method > P.OrderMethod.EST
        for min_o in sorted({1, min(3, m), m}):
            for r in ((refs, refs.float()) if method == P.OrderMethod.EST
                      else (refs,)):
                before = frame.select_candidate.launches
                got = frame.select_candidate(
                    bits.to(dev) if reads else None, r.to(dev),
                    qcoefs.to(dev), shifts.to(dev), int(method), min_o, m)
                assert frame.select_candidate.launches == before + 1
                want = frame.select_candidate_plain(
                    bits if reads else None, r, qcoefs, shifts, int(method),
                    min_o, m)
                for g, w in zip(got, want):
                    assert g.dtype == torch.int32 and torch.equal(g.cpu(), w)
            if reads:
                got = frame.select_order_bits(bits.to(dev), int(method),
                                              min_o, m)
                want = frame.select_order_bits_plain(bits, int(method), min_o,
                                                     m)
                assert torch.equal(got.cpu(), want)


def _fixed_chans(rng, F, n, bps):
    """[F, 2, n] int32: tones with noise, full-scale noise (whose fixed
    predictions wrap int32 at 32 bits), a ramp, silence, a constant and,
    from 6 frames, alternating extremes (INT32_MIN and INT32_MAX at 32
    bits, which wrap every order)."""
    lim = 1 << (bps - 1)
    t = np.arange(n)
    x = (lim // 3) * np.sin(2 * np.pi * rng.uniform(40, 900, (F, 2, 1))
                            * t / 44100) + rng.normal(0, lim / 200,
                                                      (F, 2, n))
    x[1] = rng.integers(-lim, lim, (2, n))
    x[2] = (np.arange(n) * 7) % lim
    x[3] = 0
    x[4] = -5
    if F > 5:
        x[5] = np.where(np.arange(n) % 2, lim - 1, -lim)
    return torch.from_numpy(np.clip(np.rint(x), -lim, lim - 1)
                            .astype(np.int32))


@pytest.mark.parametrize("n,min_o,max_o,pmin,pmax,F,bps", [
    (1152, 0, 4, 0, 4, 512, 16), (1152, 0, 4, 0, 8, 64, 32),
    (4608, 1, 4, 0, 5, 16, 16), (20, 1, 4, 0, 8, 8, 16),
    (10, 0, 4, 0, 8, 8, 32), (5, 0, 4, 2, 3, 8, 16), (4096, 2, 2, 0, 6, 8, 24),
    (65535, 0, 4, 0, 8, 5, 16), (16, 1, 1, 0, 8, 8, 16),
    # the level-2 batch's partitions at other lengths; 256 partitions of
    # 16 and of 128
    (576, 0, 4, 0, 3, 16, 16), (192, 0, 4, 0, 3, 16, 16),
    (4096, 0, 4, 0, 8, 8, 16), (32768, 0, 4, 0, 8, 5, 16),
    # the kernel's routes: 32 partitions (the last of shares of one, and
    # level 5's one scan round) and 64 (the first of whole partitions a
    # lane, here of 3 samples, read one at a time); 128 (the last with four
    # streams a block; 256 above has two) and 256 of 28 samples; partitions
    # of odd length on rows off 16 bytes; 13 int4 a lane (a second batch of
    # loads)
    (4096, 0, 4, 0, 5, 8, 16), (192, 0, 4, 0, 6, 8, 16),
    (4096, 0, 4, 0, 6, 8, 32), (4096, 0, 4, 0, 7, 8, 16),
    (7168, 0, 4, 0, 8, 5, 16), (1154, 0, 4, 0, 3, 8, 16),
    (1664, 0, 4, 0, 5, 8, 16),
    # one order, no search
    (1152, 0, 0, 0, 3, 8, 16), (1152, 2, 2, 0, 3, 8, 16),
    (1152, 4, 4, 0, 3, 8, 32)])
def test_fixed_search_kernel(dev, n, min_o, max_o, pmin, pmax, F, bps):
    """X's orders and coefficient rows equal its plain version's, at the
    level-2 batch (512 stereo frames of 1,152) and the edges: 32-bit
    content and alternating extremes, short tails, one order, odd n, the
    longest block, 256 partitions, and the first shape past each of the
    kernel's routes."""
    chans = _fixed_chans(np.random.default_rng(n + bps), F, n, bps)
    obits = torch.full((F, 2), bps, dtype=torch.int32)
    obits[:, 1] += 1
    before = rice.fixed_search.launches
    order, coefs = rice.fixed_search(chans.to(dev), obits.to(dev), min_o,
                                     max_o, pmin, pmax)
    assert rice.fixed_search.launches == before + 1
    want_o, want_c = rice.fixed_search_plain(chans, obits, min_o, max_o,
                                             pmin, pmax)
    assert torch.equal(order.cpu(), want_o)
    assert torch.equal(coefs.cpu(), want_c)


def _head_frames(rng, F, n, C, bps):
    """[F, n, C] int32: music-like frames, all-zero, constant, 15 trailing
    zero bits, equal channels, mid/side, and at 32 bits full-scale
    opposites (the side veto)."""
    lim = 1 << (bps - 1)
    t = np.arange(n)[:, None]
    x = (lim // 3) * np.sin(2 * np.pi * rng.uniform(40, 900, (F, 1, C))
                            * t / 44100) + rng.normal(0, lim / 500, (F, n, C))
    x = np.clip(np.rint(x), -lim, lim - 1).astype(np.int64)
    x[1] = 0
    x[2] = 12
    x[3] = (x[3] >> 15) << 15
    x[4, :, -1] = x[4, :, 0]
    if C == 2:
        x[5, :, 1] = x[5, :, 0] // 2 + 7
        x[6, :, 0], x[6, :, 1] = lim - 1, -lim
        x[7, :, 1] = x[7, :, 0] - 1
    return torch.from_numpy(np.clip(x, -lim, lim - 1).astype(np.int32))


@pytest.mark.parametrize("C,bps,n,estimate,F", [
    (2, 16, 4096, True, 512), (2, 32, 4096, True, 16), (2, 24, 96, True, 16),
    (2, 16, 33, True, 16), (2, 16, 32, True, 16), (2, 16, 20, False, 16),
    (1, 24, 1000, True, 16), (6, 16, 4608, True, 16), (8, 24, 8192, True, 9),
    (2, 16, 65535, True, 9)])
def test_frame_head_kernel(dev, C, bps, n, estimate, F):
    """H's five outputs equal its plain version's: the level-8 batch (512
    stereo frames of 4,096) and the edges (32-bit and its side veto, n at
    the stereo estimate's 32-sample edge, 1, 6 and 8 channels, the longest
    block)."""
    x = _head_frames(np.random.default_rng(C * n + bps), F, n, C, bps)
    p = P.set_defaults(8)
    p.stereo_method = int(estimate)
    cfg = frame.FrameConfig.from_params(p, C, bps, block_size=n)
    before = frame.frame_head.launches
    got = frame.frame_head(x.to(dev), cfg)
    assert frame.frame_head.launches == before + 1
    want = frame.frame_head_plain(x, cfg)
    assert got[0].is_contiguous()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    if bps == 32 and estimate:
        assert want[3][6] == 1                  # LEFT_RIGHT: the veto


def _head_equal(dev, x, cfg):
    before = frame.frame_head.launches
    got = frame.frame_head(x.to(dev) if x.device.type == "cpu" else x, cfg)
    assert frame.frame_head.launches == before + 1
    want = frame.frame_head_plain(x.cpu(), cfg)
    assert got[0].is_contiguous()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    return want


def _head_cfg(C, bps, n, estimate):
    p = P.set_defaults(8)
    p.stereo_method = int(estimate)
    return frame.FrameConfig.from_params(p, C, bps, block_size=n)


@pytest.mark.parametrize("C,bps,n,estimate,F", [
    (2, 16, 6144, True, 8), (2, 16, 6080, True, 8), (2, 24, 6144, True, 8),
    (2, 16, 8192, True, 214), (2, 4, 1152, True, 16), (2, 8, 1152, True, 16),
    (2, 24, 4096, False, 16), (2, 24, 4608, True, 16),
    (2, 32, 4097, True, 8), (2, 16, 1, True, 8), (2, 16, 3, True, 8),
    (2, 16, 777, True, 16), (2, 16, 1152, False, 16), (1, 16, 1, False, 8),
    (1, 32, 65535, False, 8), (3, 16, 1000, False, 8),
    (4, 24, 1152, False, 8), (5, 8, 4095, False, 8), (6, 16, 8192, False, 8),
    (7, 16, 333, False, 8), (8, 32, 8192, False, 8), (8, 4, 4096, False, 8),
    (2, 32, 65535, True, 8), (2, 16, 65535, False, 8),
    (8, 16, 65535, False, 8)])
def test_frame_head_kernel_shapes(dev, C, bps, n, estimate, F):
    """H's five outputs equal its plain version's at 1-8 channels, 4 to 32
    bits, n from 1 to 65,535 (frames of 47.5 and 48 KB, whose shared
    memory with the kernel's own passes the 48 KB a block takes without
    opting in; frames above 200 KB, 65,535 stereo samples or 8 channels of
    8,192, take the path that reads the frame twice), the stereo estimate
    on and off; the frames
    include all-zero, constant and 15-wasted-bit ones, and at 32 bits full
    scale opposites (the side veto)."""
    x = _head_frames(np.random.default_rng(C * n + bps + F), F, n, C, bps)
    want = _head_equal(dev, x, _head_cfg(C, bps, n, estimate))
    if bps == 32 and estimate and C == 2 and n > 32:
        assert want[3][6] == 1                  # LEFT_RIGHT: the veto


def test_frame_head_kernel_unaligned_and_wide_samples(dev):
    """Frames off a 16-byte boundary (a view one int into its storage:
    int4 loads in place of the bulk copy; odd n puts every other frame
    off it), and 16-bit frames holding samples outside 16 bits, whose
    second differences the kernel sums again in int64."""
    rng = np.random.default_rng(5)
    for n, F in ((4096, 16), (1153, 16), (3, 8)):
        x = _head_frames(rng, F, n, 2, 16)
        buf = torch.empty(x.numel() + 1, dtype=torch.int32, device=dev)
        view = buf[1:].view(F, n, 2)
        view.copy_(x.to(dev))
        assert view.data_ptr() % 16 == 4
        _head_equal(dev, view, _head_cfg(2, 16, n, True))
    x = _head_frames(rng, 16, 4096, 2, 16)
    x[0] = torch.from_numpy(rng.integers(-2**31, 2**31, (4096, 2),
                                         dtype=np.int64).astype(np.int32))
    x[9, ::3, 0] = 2**31 - 1
    x[10, 7, 1] = 70000
    _head_equal(dev, x, _head_cfg(2, 16, 4096, True))


@pytest.mark.parametrize("level,C,bps,n,F", [
    (8, 2, 16, 4096, 512), (2, 2, 16, 1152, 64), (8, 2, 24, 4096, 16),
    (8, 2, 32, 4096, 16), (5, 6, 16, 4608, 8), (5, 8, 24, 2048, 8),
    (12, 2, 16, 8192, 8), (8, 2, 16, 20, 8), (8, 2, 16, 10, 8),
    (8, 2, 16, 3, 8), (5, 1, 32, 1000, 8)])
def test_slot_layout_kernel(dev, level, C, bps, n, F):
    """E's three tables equal its plain version's on the analysis of a
    batch on the card: the level-8 batch (512 frames of 4,096), FIXED at
    level 2, 24 bits, 32-bit stereo (the wide (hi, lo) form), 6 and 8
    channels, the level-12 8192 size, tails of 20, 10 and 3 samples
    (LPC, FIXED, VERBATIM), 32-bit mono."""
    rng = np.random.default_rng(level * n + C + bps)
    x = _head_frames(rng, F, n, C, bps)
    x[-1] = torch.from_numpy(rng.choice([-(1 << (bps - 1)),
                                         (1 << (bps - 1)) - 1], (n, C))
                             .astype(np.int32))
    cfg = frame.FrameConfig.from_params(P.set_defaults(level), C, bps,
                                        block_size=n)
    nums = np.arange(F, dtype=np.int64) * 977
    hb, hn = bitpack.frame_header_bytes(
        nums, bs_code=P.blocksize_code(n), sr_code=P.samplerate_code(44100),
        allow_vbs=0)
    analysis = frame.analyze_frames(x.to(dev), cfg,
                                    torch.from_numpy(hn * 8).to(dev))
    hb, hn = torch.from_numpy(hb).to(dev), torch.from_numpy(hn).to(dev)
    before = bitpack.slot_layout.launches
    got = bitpack.slot_layout(analysis, hb, hn, cfg)
    assert bitpack.slot_layout.launches == before + 1
    want = bitpack.slot_layout_plain(analysis, hb, hn, cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    words, total_bits = bitpack.pack_frames_device(analysis, hb, hn, cfg)
    assert torch.equal(total_bits.to(torch.int64),
                       analysis["frame_bytes"] * 8)


def _made_up_analysis(rng, F, C, n, bps, level, dev):
    """A made-up analysis E and its plain version take: every subframe
    type in every frame (CONSTANT, VERBATIM, FIXED, LPC in turn over the
    channels, from a random start), orders up to 4 (FIXED) and 32 (LPC),
    obits up to the field's width, wasted bits, both Rice methods,
    partition orders 0..ps, parameters 0..30, residuals from small to
    the full int32 range, random header bytes."""
    cfg = frame.FrameConfig.from_params(P.set_defaults(level), C, bps,
                                        block_size=n)
    ps = rice.limit_max_partition_order(cfg.max_partition_order, n, 1)
    kinds = np.array([frame.SF_CONSTANT, frame.SF_VERBATIM, frame.SF_FIXED,
                      frame.SF_LPC])
    sf = kinds[(np.arange(C)[None, :] + rng.integers(0, 4, (F, 1))) % 4]
    order = np.where(sf == frame.SF_FIXED, rng.integers(0, 5, (F, C)),
                     np.where(sf == frame.SF_LPC,
                              rng.integers(1, 33, (F, C)), 0))
    width = bps + (1 if C == 2 else 0)
    scale = 2.0 ** rng.integers(0, 32, (F, C, 1))
    residual = np.clip(np.rint(rng.normal(0, 1, (F, C, n)) * scale),
                       -2.0 ** 31, 2.0 ** 31 - 1)
    residual[0, 0, :5] = [-2 ** 31, 2 ** 31 - 1, -1, 0, 1][:n]
    table = {
        "sf_type": sf, "order": order,
        "obits": rng.integers(1, width + 1, (F, C)),
        "wasted": rng.integers(0, 4, (F, C)),
        "method": rng.integers(0, 2, (F, C)),
        "porder": rng.integers(0, ps + 1, (F, C)),
        "type_code": rng.integers(0, 64, (F, C)),
        "shift": rng.integers(0, 16, (F, C)),
        "coefs": rng.integers(-(1 << 14), 1 << 14, (F, C, P.MAX_LPC_ORDER)),
        "rice_params": rng.integers(0, 31, (F, C, (1 << ps) + 3)),
        "residual": residual, "ch_mode": rng.integers(0, 4, F)}
    analysis = {k: torch.from_numpy(np.asarray(v).astype(np.int32)).to(dev)
                for k, v in table.items()}
    hb = torch.from_numpy(rng.integers(0, 256, (F, bitpack.HDR_SLOTS))
                          .astype(np.uint8)).to(dev)
    hn = torch.from_numpy(rng.integers(6, 17, F).astype(np.int32)).to(dev)
    return analysis, hb, hn, cfg, ps


@pytest.mark.parametrize("F,C,n,bps,level,ps", [
    (1, 2, 4096, 16, 8, 6), (3, 2, 4096, 16, 8, 6), (214, 2, 8192, 16, 12, 8),
    (512, 2, 4096, 16, 8, 6), (5, 2, 4096, 32, 8, 6), (3, 8, 4096, 24, 8, 6),
    (4, 8, 2048, 32, 12, 8), (6, 2, 777, 16, 8, 0), (7, 2, 4095, 24, 12, 0),
    (2, 1, 3, 16, 8, 0), (9, 2, 20, 16, 8, 2), (3, 6, 1152, 16, 2, 3),
    (2, 2, 256, 16, 12, 8), (5, 2, 1024, 32, 12, 8), (1, 8, 65535, 24, 8, 0)])
def test_slot_layout_kernel_made_up(dev, F, C, n, bps, level, ps):
    """E's three tables equal its plain version's on made-up analyses: one
    frame, 3, 214 (the level-12 8192 bucket) and 512 (the level-8 batch);
    the wide (hi, lo) form of 32-bit stereo; 6 and 8 channels; odd n and
    VBS sub-block sizes (256 to 8192), ps 0 to 8 (n odd or a short tail
    takes 0); rows that start off a 16-byte boundary (M not a multiple of
    4); and
    65,535 samples of 8 channels, whose blocks lay out their spans in
    several passes."""
    rng = np.random.default_rng(F * n + C + bps)
    analysis, hb, hn, cfg, got_ps = _made_up_analysis(rng, F, C, n, bps,
                                                      level, dev)
    assert got_ps == ps
    before = bitpack.slot_layout.launches
    got = bitpack.slot_layout(analysis, hb, hn, cfg)
    torch.cuda.synchronize()
    assert bitpack.slot_layout.launches == before + 1
    want = bitpack.slot_layout_plain(analysis, hb, hn, cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("level", [8, 2, 12])
def test_encoder_launches_the_frame_kernels(dev, level):
    """An encode launches H and E once a batch, S with its gather (LPC
    levels; never the order-only form) or X (FIXED levels), and its bytes
    equal the CPU encoder's."""
    cfg = P.StreamConfig(channels=2, sample_rate=44100, bits_per_sample=16,
                         params=P.set_defaults(level))
    n = 2 * 44100 + 777
    t = np.arange(n)
    rng = np.random.default_rng(level)
    pcm = np.stack([9000 * np.sin(2 * np.pi * 220 * t / 44100),
                    7000 * np.sin(2 * np.pi * 330 * t / 44100)], 1) \
        + rng.normal(0, 200, (n, 2))
    pcm = np.clip(np.rint(pcm), -32768, 32767).astype(np.int32)
    kernels = (frame.select_candidate, rice.fixed_search, frame.frame_head,
               bitpack.slot_layout, frame.select_order_bits)
    before = [k.launches for k in kernels]
    got = flake_tpu_torch.Encoder(cfg, device=dev,
                                  batch_frames=8).encode_stream(pcm)
    torch.cuda.synchronize()
    ran = [k.launches - b for k, b in zip(kernels, before)]
    want = flake_tpu_torch.Encoder(cfg, device="cpu",
                                   batch_frames=8).encode_stream(pcm)
    assert got == want
    assert ran[2] >= 1 and ran[3] >= 1 and ran[4] == 0
    if level == 2:
        assert ran[1] >= 1 and ran[0] == 0
    else:
        assert ran[0] >= 1


def test_frame_kernels_refuse_other_types(dev):
    cfg = frame.FrameConfig.from_params(P.set_defaults(8), 2, 16,
                                        block_size=64)
    with pytest.raises(ValueError, match="int32"):
        frame.frame_head(torch.zeros((4, 64, 2), dtype=torch.int64,
                                     device=dev), cfg)
    with pytest.raises(ValueError, match="int64"):
        frame.select_order_bits(torch.zeros((4, 12), dtype=torch.int32,
                                            device=dev), 6, 1, 12)
    with pytest.raises(ValueError, match="orders"):
        frame.select_order_bits(torch.zeros((4, 40), dtype=torch.int64,
                                            device=dev), 6, 1, 40)
    with pytest.raises(ValueError, match="int32"):
        frame.select_candidate(
            None, None, torch.zeros((4, 12, 12), dtype=torch.int64,
                                    device=dev),
            torch.zeros((4, 12), dtype=torch.int32, device=dev), 0, 1, 12)
    with pytest.raises(ValueError, match="float32"):
        frame.select_candidate(
            None, torch.zeros((4, 12), dtype=torch.float16, device=dev),
            torch.zeros((4, 12, 12), dtype=torch.int32, device=dev),
            torch.zeros((4, 12), dtype=torch.int32, device=dev), 1, 1, 12)
    with pytest.raises(ValueError, match="orders"):
        rice.fixed_search(torch.zeros((4, 2, 64), dtype=torch.int32,
                                      device=dev),
                          torch.zeros((4, 2), dtype=torch.int32, device=dev),
                          0, 5, 0, 3)


# -- Z: the analysis' finalize -----------------------------------------------

_SF_OF = {"lpc": frame.SF_LPC, "fixed": frame.SF_FIXED,
          "verbatim": frame.SF_VERBATIM}


def _finalize_case(rng, path, overrides, C, bps, n, L, F):
    """Made-up inputs of ``finalize_analysis`` on the CPU: (cfg, args). The
    residual rows differ from the samples everywhere, so a row copied or
    missed shows. ``overrides`` names the ones forced: ``constant`` (about
    a fifth of the rows), ``unfit`` (about a fifth; LPC only),
    ``oversize`` (exact Rice bits that put about half the frames over the
    verbatim bound, the rest under it); under none, frames well
    within the bound. VERBATIM: ``res`` is ``chans`` and no exact bits."""
    level = {"lpc": 8, "fixed": 2, "verbatim": 8}[path]
    cfg = frame.FrameConfig.from_params(P.set_defaults(level), C, bps,
                                        block_size=n)
    lim = 1 << (bps - 1)
    i32 = torch.int32

    def ints(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64))

    chans = ints(-lim, lim, (F, C, L)).to(i32)
    obits = ints(max(bps - 3, 1), bps + (C == 2) + 1, (F, C)).to(i32)
    wasted = ints(0, 4, (F, C)).to(i32)
    constant = torch.from_numpy(rng.random((F, C)) < 0.2) \
        if "constant" in overrides else torch.zeros((F, C), dtype=torch.bool)
    sf_type = torch.full((F, C), _SF_OF[path], dtype=i32)
    order = (ints(1, 33, (F, C)) if path == "lpc" else ints(0, 5, (F, C))
             if path == "fixed" else torch.zeros((F, C), dtype=torch.int64)
             ).to(i32)
    # each frame's exact bits a share of the verbatim bound: over it or
    # under it where over-size frames are forced, a third of it otherwise
    vbits = 8 * P.max_frame_size(n, C, bps)
    share = torch.from_numpy(np.where(rng.random(F) < 0.5, 1.3, 0.7)
                             if "oversize" in overrides else np.full(F, 0.3))
    exact = (share[:, None] * vbits / C).to(torch.int64) \
        + ints(-40, 40, (F, C))
    rc = {"porder": ints(0, 7, (F, C)).to(i32),
          "method": ints(0, 2, (F, C)).to(i32),
          "params": ints(0, 31, (F, C, 64)).to(i32)}
    if path == "verbatim":
        res = chans
    else:
        res = chans ^ ints(1, 1 << 30, (F, C, L)).to(i32)
        rc["exact_rice_bits"] = exact.clamp_min(0)
    unfit = None
    if path == "lpc":
        unfit = torch.from_numpy(rng.random((F, C)) < 0.2) \
            if "unfit" in overrides else torch.zeros((F, C), dtype=torch.bool)
    mode = ints(0, 11, (F,)).to(i32)
    coefs = ints(-(1 << 14), 1 << 14, (F, C, P.MAX_LPC_ORDER)).to(i32)
    shift = ints(0, 16, (F, C)).to(i32)
    hdr_bits = (ints(6, 17, (F,)) * 8).to(i32)
    return cfg, (chans, obits, wasted, constant, mode, sf_type, order, coefs,
                 shift, res, rc, hdr_bits, unfit)


def _on(dev, args, chans_on=None):
    """The case's arguments on the card; ``res`` stays ``chans`` where it
    is, and ``chans_on`` (a function of the card's samples) may give them
    another layout."""
    chans, res = args[0], args[9]
    moved = [a.to(dev) if isinstance(a, torch.Tensor)
             else {k: v.to(dev) for k, v in a.items()} if isinstance(a, dict)
             else a for a in args]
    if chans_on is not None:
        moved[0] = chans_on(moved[0])
    if res is chans:
        moved[9] = moved[0]
    return moved


def _finalize_equal(dev, cfg, args, chans_on=None):
    """Z's dict equals its plain version's, key by key, dtype and bytes;
    one launch where there are frames. Returns the plain version's dict."""
    plain_args = [a.clone() if isinstance(a, torch.Tensor) else a
                  for a in args]
    if args[9] is args[0]:
        plain_args[9] = plain_args[0]
    want = frame.finalize_analysis_plain(cfg, *plain_args)
    before = frame.finalize_analysis.launches
    got = frame.finalize_analysis(cfg, *_on(dev, args, chans_on))
    torch.cuda.synchronize()
    assert frame.finalize_analysis.launches \
        == before + (args[0].shape[0] > 0)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g.cpu(), w), k
    return want


@pytest.mark.parametrize("path,overrides,C,bps,n,L,F", [
    ("lpc", ("constant",), 2, 16, 4096, 4096, 64),
    ("lpc", ("unfit",), 2, 32, 4096, 4096, 64),
    ("lpc", ("oversize",), 2, 16, 4096, 4096, 64),
    ("lpc", ("constant", "unfit", "oversize"), 2, 32, 4608, 4608, 64),
    ("lpc", ("constant", "unfit", "oversize"), 1, 24, 4608, 4608, 33),
    ("lpc", ("constant", "unfit", "oversize"), 6, 16, 1152, 1152, 40),
    ("lpc", ("constant", "unfit", "oversize"), 8, 32, 4096, 4096, 17),
    ("lpc", ("constant", "oversize"), 2, 16, 4096, 2048, 64),
    ("lpc", ("constant", "unfit", "oversize"), 2, 32, 1554, 777, 16),
    ("lpc", ("constant", "oversize"), 2, 16, 333, 333, 24),
    ("lpc", (), 2, 16, 4096, 4096, 512),
    ("lpc", ("constant", "unfit", "oversize"), 2, 16, 4096, 4096, 0),
    ("lpc", ("constant", "unfit", "oversize"), 2, 16, 4096, 4096, 1),
    ("lpc", ("constant", "unfit", "oversize"), 2, 16, 1152, 1152, 12288),
    ("fixed", ("constant", "oversize"), 2, 16, 1152, 1152, 64),
    ("fixed", ("constant", "oversize"), 6, 24, 777, 777, 9),
    ("fixed", ("constant", "oversize"), 8, 32, 4608, 4608, 12),
    ("verbatim", ("constant", "oversize"), 2, 16, 4, 4, 64),
    ("verbatim", ("constant", "oversize"), 8, 32, 1152, 1152, 9)])
def test_finalize_kernel(dev, path, overrides, C, bps, n, L, F):
    """Z's outputs equal its plain version's, byte for byte, on made-up
    tables that force each override alone (CONSTANT rows, unfit rows of
    32-bit input, over-size frames) and all of them mixed in a frame
    (unfit rows in over-size frames among them), on the LPC, FIXED and
    VERBATIM paths (where ``res`` is ``chans`` and no exact bits come), at
    1, 2, 6 and 8 channels and 16, 24 and 32 bits, on rows of 4,096, 4,608,
    1,152, 777 and 333 samples (odd rows start off a 16-byte boundary), on
    an sp rank's half of a block (the row length the residual's, the sizes
    the block's), and on 0, 1, 64 and 12,288 frames; and where no override
    fires."""
    cfg, args = _finalize_case(np.random.default_rng(C * L + bps + F), path,
                               overrides, C, bps, n, L, F)
    want = _finalize_equal(dev, cfg, args)
    raw = want["sf_type"] <= frame.SF_VERBATIM
    if F > 1 and path != "verbatim":
        assert bool(raw.any()) == bool(overrides)
        assert not bool(raw.all())
    if "oversize" in overrides and F > 1 and path != "verbatim":
        vb = (want["sf_type"] == frame.SF_VERBATIM).all(dim=-1)
        assert bool(vb.any()) and not bool(vb.all())


@pytest.mark.parametrize("layout", ["permuted", "offset", "strided"])
def test_finalize_kernel_sample_layouts(dev, layout):
    """Z reads samples in any layout: a permuted view of [F, B, C] (the sp
    path's samples without the stereo estimate), rows one int off the
    residual's 16-byte phase (int loads in place of int4), and a column
    slice of wider rows."""
    rng = np.random.default_rng(7)
    cfg, args = _finalize_case(rng, "lpc", ("constant", "unfit", "oversize"),
                               2, 32, 4096, 4096, 48)

    def permuted(c):
        return c.permute(0, 2, 1).contiguous().permute(0, 2, 1)

    def offset(c):
        buf = torch.empty(c.numel() + 1, dtype=c.dtype, device=c.device)
        view = buf[1:].view(c.shape)
        view.copy_(c)
        assert view.data_ptr() % 16 == 4
        return view

    def strided(c):
        wide = torch.zeros(c.shape[:-1] + (c.shape[-1] + 8,), dtype=c.dtype,
                           device=c.device)
        wide[..., 3:3 + c.shape[-1]] = c
        return wide[..., 3:3 + c.shape[-1]]

    fn = {"permuted": permuted, "offset": offset, "strided": strided}[layout]
    _finalize_equal(dev, cfg, args, chans_on=fn)


def _cpu_copy(args):
    """A call's arguments copied to the CPU; ``res`` stays ``chans`` where
    it is."""
    out = [a.cpu().clone() if isinstance(a, torch.Tensor)
           else {k: v.cpu() for k, v in a.items()} if isinstance(a, dict)
           else a for a in args]
    if args[10] is args[1]:
        out[10] = out[1]
    return out


@pytest.mark.parametrize("level,n,prediction", [
    (8, 4096, None), (5, 4608, None), (2, 1152, None), (8, 4, None),
    (8, 1152, "NONE")])
def test_analyze_frames_launches_z_once(dev, level, n, prediction,
                                        monkeypatch):
    """``analyze_frames`` on the card launches Z once a call on the LPC
    (levels 8 and 5), FIXED (level 2) and VERBATIM (blocks under 5 samples,
    prediction NONE) paths and runs no plain finalize; its dict equals the
    plain version's on the same inputs, frames with silent, constant and
    full-scale rows among them."""
    p = P.set_defaults(level)
    if prediction:
        p.prediction_type = int(P.Prediction[prediction])
    cfg = frame.FrameConfig.from_params(p, 2, 16, block_size=n)
    x = _head_frames(np.random.default_rng(level + n), 16, n, 2, 16)
    plain, kern, calls = frame.finalize_analysis_plain, \
        frame.finalize_analysis, []

    @functools.wraps(kern)      # carries .launches, which Z counts on
    def rec(*args):
        calls.append(_cpu_copy(args))
        return kern(*args)

    monkeypatch.setattr(frame, "finalize_analysis", rec)
    monkeypatch.setattr(frame, "finalize_analysis_plain", None)
    got = frame.analyze_frames(x.to(dev), cfg, torch.full(
        (16,), 48, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    assert rec.launches == kern.launches + 1 and len(calls) == 1
    want = plain(*calls[0])
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k].cpu(), w), k
    if prediction or n < 5:
        assert (want["sf_type"] <= frame.SF_VERBATIM).all()
    else:
        assert (want["sf_type"] <= frame.SF_VERBATIM).any()


def test_finalize_launches_on_encoder_and_entry_paths(dev):
    """The Encoder launches Z once a batch, and the pipeline entry
    (``graft_entry.entry``) once a step."""
    from flake_tpu_torch import graft_entry

    cfg = P.StreamConfig(channels=2, sample_rate=44100, bits_per_sample=16,
                         params=P.set_defaults(8))
    pcm = np.zeros((3 * 4096 * 8 + 777, 2), dtype=np.int32)
    pcm[4096:] = np.random.default_rng(3).integers(
        -9000, 9000, (pcm.shape[0] - 4096, 2))
    enc = flake_tpu_torch.Encoder(cfg, device=dev, batch_frames=8)
    before = frame.finalize_analysis.launches
    got = enc.encode_stream(pcm)
    torch.cuda.synchronize()
    assert frame.finalize_analysis.launches - before == enc.stats["batches"]
    assert got == flake_tpu_torch.Encoder(
        cfg, device="cpu", batch_frames=8).encode_stream(pcm)
    fn, args = graft_entry.entry(device=dev)
    before = frame.finalize_analysis.launches
    fn(*args)
    torch.cuda.synchronize()
    assert frame.finalize_analysis.launches == before + 1


def test_finalize_refuses_other_types(dev):
    cfg, args = _finalize_case(np.random.default_rng(1), "lpc",
                               ("constant",), 2, 16, 64, 64, 4)
    args = _on(dev, args)
    bad = list(args)
    bad[0] = args[0].to(torch.int64)
    with pytest.raises(ValueError, match="chans"):
        frame.finalize_analysis(cfg, *bad)
    bad = list(args)
    bad[1] = args[1][:3]
    with pytest.raises(ValueError, match="obits"):
        frame.finalize_analysis(cfg, *bad)
