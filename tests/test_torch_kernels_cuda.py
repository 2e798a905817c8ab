"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need an NVIDIA GPU and skip without one. They import no JAX,
so they run on a machine that has only PyTorch with CUDA:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` keeps ``tests/conftest.py``, which imports JAX, out.)
Shapes cover the level-8 main path and the edges: odd block sizes, a
partition size of 253, order 32 with 256 partitions (more than 48 KiB
of shared memory), 24-bit and 32-bit content, and blocks under 32.
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

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tonal(N, B, bps, seed):
    """int32 [N, B] tonal streams with light noise; row 1 silent, row 2
    constant (the autocorrelation's +2.0 bias cases)."""
    rng = np.random.default_rng(seed)
    t = np.arange(B)
    amp = (1 << (bps - 2))
    x = amp * np.sin(2 * np.pi * rng.uniform(40, 700, (N, 1)) * t / 44100) \
        + rng.normal(0, amp / 100, (N, B))
    x[1] = 0
    x[2] = 1234
    return torch.from_numpy(x.astype(np.int32))


@pytest.mark.parametrize("B,max_order", [(4096, 12), (777, 32),
                                         (65535, 8), (20, 12)])
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
    (8192, 32, 8, 16), (4096, 32, 6, 24), (20, 12, 2, 16)])
def test_sweep_kernel(dev, B, max_order, pmax_static, bps):
    x = _tonal(9, B, bps, seed=B + bps)
    x[3] = torch.from_numpy(np.random.default_rng(3).integers(
        -(1 << (bps - 1)), 1 << (bps - 1), B).astype(np.int32))
    x = x.to(dev)
    autoc = lpc.autocorr(x, max_order, lpc.welch_window_on(B, dev))
    rows, _ = lpc.levinson_all_orders(autoc)
    qc, sh = lpc.quantize_lpc_coefs(rows, 15)
    got = k2.sweep_sums(x, qc, sh, max_order, pmax_static)
    want = k2.sweep_sums_plain(x, qc, sh, max_order, pmax_static)
    assert torch.equal(got, want)


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
