"""The port's variable-block-size path (levels 9-12) against the JAX encoder.

At reduced depth (1024-sample superblocks, order 8 for level 12): the
section sums on the device and the bucket layout must equal the JAX
package's, and ``Encoder(device="cpu").encode_stream`` must write the
JAX encoder's bytes for level 12, for level 9 with a tail that is split
as a superblock of its own, and for ``allow_vbs`` without variable
block sizes (frames numbered by sample). Each stream must decode
losslessly with its MD5 and state a minimum block size of 16.
Everything is integer, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flake_tpu
from flake_tpu import encoder as jencoder
from flake_tpu import params as JP
from flake_tpu.decoder import decode_stream

import flake_tpu_torch
from flake_tpu_torch import encoder as tencoder
from flake_tpu_torch import params as TP

from conftest import make_test_signal

B = 1024


def _signal(n, seed):
    """Tonal stereo with loudness steps every 700 samples and short
    bursts, so the split decision yields many sub-block sizes."""
    pcm = make_test_signal(n, 2, 16, seed=seed).astype(np.int64)
    rng = np.random.default_rng(seed)
    for start in range(0, n, 700):
        pcm[start:start + 700] = \
            pcm[start:start + 700] * rng.choice([1, 1, 1, 3]) // 3
    for b in rng.integers(0, n - 200, 6):
        pcm[b:b + rng.integers(30, 200)] += rng.integers(-8000, 8000, (1, 2))
    return np.clip(pcm, -32768, 32767).astype(np.int32)


def _config(level, **overrides):
    cfg = JP.StreamConfig(channels=2, sample_rate=44100, bits_per_sample=16,
                          params=JP.set_defaults(level))
    cfg.params.block_size = B
    for key, value in overrides.items():
        setattr(cfg.params, key, value)
    return cfg


def _sub_blocks(pcm):
    """The (superblock, first sample, size) table of the full
    superblocks of ``pcm``."""
    n_full = pcm.shape[0] // B
    frames = torch.from_numpy(pcm[:n_full * B].reshape(n_full, B, 2))
    res = tencoder.vbs_section_sums(frames, B // 8)
    return tencoder.vbs_layout(res.numpy(), B // 8)


def test_section_sums_match_jax():
    rng = np.random.default_rng(4)
    frames = _signal(6 * B, seed=4).reshape(6, B, 2)
    frames[2] = rng.integers(-32768, 32768, (B, 2))
    frames[3] = 0
    want = np.asarray(jencoder._vbs_section_sums(jnp.asarray(frames),
                                                 B // 8))
    got = tencoder.vbs_section_sums(torch.from_numpy(frames), B // 8)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_bucket_layout_matches_jax(monkeypatch):
    """The batches each encoder hands its device path: block size, frame
    numbers and samples, in the same order."""
    pcm = _signal(12 * B, seed=9)
    seen = {"jax": [], "port": []}

    def recorder(key):
        def run(self, frames, block_size, nums, *rest):
            seen[key].append((block_size, np.array(nums), frames.copy()))
            return b"", np.zeros(frames.shape[0], np.int64)
        return run

    monkeypatch.setattr(flake_tpu.Encoder, "_run_batches", recorder("jax"))
    monkeypatch.setattr(flake_tpu_torch.Encoder, "_run_batches",
                        recorder("port"))
    jcfg = _config(9)
    flake_tpu.Encoder(jcfg).encode(pcm)
    flake_tpu_torch.Encoder(TP.from_reference(jcfg), device="cpu") \
        .encode(pcm)
    assert len(seen["port"]) == len(seen["jax"]) >= 3
    for (bs_p, nums_p, fr_p), (bs_j, nums_j, fr_j) in zip(seen["port"],
                                                          seen["jax"]):
        assert bs_p == bs_j
        np.testing.assert_array_equal(nums_p, nums_j)
        np.testing.assert_array_equal(fr_p, fr_j)


# seeds chosen so that three superblocks split into three sub-block
# sizes with one or two batch shapes each: every new shape costs the JAX
# encoder seconds of compile
@pytest.mark.parametrize("level,seed,tail,overrides", [
    (12, 0, 0, {"max_prediction_order": 8}),
    (9, 11, 520, {}),                  # the tail splits as a superblock
    (8, 8, 300, {"allow_vbs": 1}),     # numbered by sample, fixed blocks
])
def test_encode_stream_matches_jax(level, seed, tail, overrides):
    pcm = _signal(3 * B + tail, seed=seed)
    jcfg = _config(level, **overrides)
    if jcfg.params.variable_block_size:
        sizes = np.unique(_sub_blocks(pcm)[2])
        assert sizes.size >= 3, sizes
    if tail == 520:
        sec = tail // 8
        res = tencoder.vbs_section_sums(torch.from_numpy(pcm[None, -tail:]),
                                        sec)
        assert tencoder.vbs_layout(res.numpy(), sec)[2].size > 1
    want = flake_tpu.Encoder(jcfg, batch_frames=8).encode_stream(pcm)
    enc = flake_tpu_torch.Encoder(TP.from_reference(jcfg), device="cpu",
                                  batch_frames=8)
    got = enc.encode_stream(pcm)
    assert got == want
    dec = decode_stream(got)
    assert dec.md5_ok
    np.testing.assert_array_equal(dec.samples, pcm)
    assert dec.streaminfo.min_block_size == 16
    assert dec.streaminfo.max_block_size == B
