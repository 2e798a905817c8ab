"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need an NVIDIA GPU and skip without one. They import no JAX,
so they run on a machine that has only PyTorch with CUDA:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` keeps ``tests/conftest.py``, which imports JAX, out.)
Shapes cover the level-8 main path, the level-11/12 sub-blocks of 4096
and 8192 samples at order 32 with 256 partitions, and the edges: odd
block sizes, a partition size of 253, K2 at order 32 with 256 partitions
(more than 48 KiB of shared memory), K4 with partitions larger than its
granule and with 300 streams, 24-bit and 32-bit content, and blocks
under 32; K5 and the four U1 variants on encoder slots, on random slot
tables whose chunks span three word rows, and on a word block above
48 KiB of shared memory; the merge prototypes ``merge_v2`` and ``merge_v3``
at fb = 1, 8 and 16 and the combined-node merges ``merge_v5a`` and
``merge_v5b`` on the tools' ``music`` and ``noise`` batches at full frame
width and on those random tables, where they leave K5's words or flag both
spill sets; the row-layout merges ``merge_v5d`` and ``merge_v5c`` on the
same four at fb = 1 and 8 and at four and two static rows (the random
tables and two rows overflow), and their zero floors.
"""

import numpy as np
import pytest
import torch

import flake_tpu_torch
from flake_tpu_torch import params as P
from flake_tpu_torch.ops import autocorr as k1
from flake_tpu_torch.ops import bitmerge as k3
from flake_tpu_torch.ops import bitpack, frame, lpc
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


@pytest.mark.parametrize("B,F,bps", [(4096, 8, 16), (20, 2, 16),
                                     (256, 4, 32)])
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


@pytest.mark.parametrize("case", ["level8", "random", "random_120_rows"])
@pytest.mark.parametrize("variant", list(prof_merge.VARIANTS))
def test_prof_merge_kernels(dev, variant, case):
    """Each U1 kernel against its plain version."""
    if case == "level8":
        slots, wr = _level8_slots(dev)
    else:
        slots, wr = _random_slots(5, 3000, seed=9)
        slots = tuple(t.to(dev) for t in slots)
        if case == "random_120_rows":
            wr = 120
    parts = bitpack.aligned_parts(*slots)
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
        for fb in (1, 8):
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
