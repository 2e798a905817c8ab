"""The port's encoder against the JAX encoder at widths other than 16-bit
stereo: 24-bit/96 kHz stereo, 6 and 8 channels, 32-bit stereo, the
24-bit recording at 11,025 Hz (the custom sample-rate header field),
level 9's variable block sizes at 24 bits, and 32-bit frames whose
residual leaves int32, where the port keeps the stream lossless and the
JAX encoder does not.

``Encoder(device="cpu")`` bytes must equal ``flake_tpu.Encoder`` bytes,
and the stream must decode with its MD5. Blocks of 512 samples keep each
case to a few seconds; every stream ends in a partial block.
"""

import pathlib

import numpy as np
import pytest
import torch

import flake_tpu
from flake_tpu import params as JP
from flake_tpu.decoder import decode_stream
from flake_tpu.io import open_pcm

import flake_tpu_torch
from flake_tpu_torch import encoder as tencoder
from flake_tpu_torch import params as TP
from flake_tpu_torch.ops import frame as tframe

from conftest import make_test_signal

B = 512
N = 6 * B + 131
DATA = pathlib.Path(__file__).resolve().parent / "data"


def _encode_both(pcm, sample_rate, bps, level):
    cfg = JP.StreamConfig(channels=pcm.shape[1], sample_rate=sample_rate,
                          bits_per_sample=bps, params=JP.set_defaults(level))
    cfg.params.block_size = B
    want = flake_tpu.Encoder(cfg, batch_frames=4).encode_stream(pcm)
    got = flake_tpu_torch.Encoder(TP.from_reference(cfg), device="cpu",
                                  batch_frames=4).encode_stream(pcm)
    return got, want


@pytest.mark.parametrize("channels,bps,sample_rate,level", [
    (2, 24, 96000, 5), (2, 24, 96000, 8),
    (6, 16, 48000, 5), (6, 16, 48000, 8),
    (2, 32, 44100, 8), (8, 24, 96000, 5)])
def test_width_matches_jax(channels, bps, sample_rate, level):
    pcm = make_test_signal(N, channels, bps, seed=channels * 100 + bps)
    # a noise block in the middle takes the verbatim path at full width
    pcm[2 * B:3 * B] = make_test_signal(B, channels, bps, seed=level,
                                        kind="noise")
    got, want = _encode_both(pcm, sample_rate, bps, level)
    assert got == want
    dec = decode_stream(got)
    assert dec.md5_ok
    assert dec.streaminfo.bits_per_sample == bps
    assert dec.streaminfo.channels == channels
    np.testing.assert_array_equal(dec.samples, pcm)


def test_recording_at_11025_matches_jax():
    with open(DATA / "pluck-pcm24.wav", "rb") as f:
        reader = open_pcm(f)
        info = reader.info
        pcm = reader.read_all()
    assert (info.sample_rate, info.bits_per_sample) == (11025, 24)
    assert TP.samplerate_code(info.sample_rate)[0] in (12, 13, 14)
    got, want = _encode_both(pcm, info.sample_rate, info.bits_per_sample, 8)
    assert got == want
    dec = decode_stream(got)
    assert dec.md5_ok
    assert dec.streaminfo.sample_rate == 11025
    np.testing.assert_array_equal(dec.samples, pcm)


def test_level9_at_24_bits_matches_jax():
    """Variable block sizes at 24 bits (BASELINE config 4 at another
    width), reduced as ``test_torch_vbs.py`` reduces level 12: superblocks
    of 1024 samples, whose 24-bit/96 kHz content with loudness steps every
    700 samples splits into several sub-block sizes; a 300-sample tail."""
    sb = 1024
    pcm = make_test_signal(3 * sb + 300, 2, 24, seed=9).astype(np.int64)
    rng = np.random.default_rng(9)
    for start in range(0, pcm.shape[0], 700):
        pcm[start:start + 700] = \
            pcm[start:start + 700] * rng.choice([1, 1, 1, 3]) // 3
    pcm = pcm.astype(np.int32)
    cfg = JP.StreamConfig(channels=2, sample_rate=96000, bits_per_sample=24,
                          params=JP.set_defaults(9))
    cfg.params.block_size = sb
    frames = torch.from_numpy(pcm[:3 * sb].reshape(3, sb, 2))
    sizes = tencoder.vbs_layout(
        tencoder.vbs_section_sums(frames, sb // 8).numpy(), sb // 8)[2]
    assert np.unique(sizes).size >= 2, sizes
    want = flake_tpu.Encoder(cfg, batch_frames=8).encode_stream(pcm)
    got = flake_tpu_torch.Encoder(TP.from_reference(cfg), device="cpu",
                                  batch_frames=8).encode_stream(pcm)
    assert got == want
    dec = decode_stream(got)
    assert dec.md5_ok
    assert dec.streaminfo.bits_per_sample == 24
    assert dec.streaminfo.min_block_size == 16
    np.testing.assert_array_equal(dec.samples, pcm)


@pytest.mark.parametrize("level,lossy", [(8, True), (2, False)])
def test_32bit_residual_outside_int32(level, lossy):
    """Full-scale binary noise entering the left channel of a 32-bit frame
    near its end: the chosen predictor's residual leaves int32 there (LPC
    at level 8, FIXED at level 2), and both encoders wrap it to int32, as
    the reference's cast does. The shifted LPC prediction then decodes to
    other samples: the JAX stream fails its MD5 (a fault of the reference,
    ROADMAP.md section 3), and the port stores that subframe verbatim, the
    other one as it was, and stays lossless. The FIXED prediction is an
    integer sum, so its wrapped residual decodes back modulo 2^32: both
    streams are lossless and the bytes are the JAX encoder's."""
    top = (1 << 31) - 1
    pcm = make_test_signal(N, 2, 32, seed=232)
    start = 3 * B - 16
    pcm[start:4 * B, 0] = np.random.default_rng(level).choice(
        [-top - 1, top], 4 * B - start)
    cfg = JP.StreamConfig(channels=2, sample_rate=44100, bits_per_sample=32,
                          params=JP.set_defaults(level))
    cfg.params.block_size = B
    want = flake_tpu.Encoder(cfg, batch_frames=4).encode_stream(pcm)
    got = flake_tpu_torch.Encoder(TP.from_reference(cfg), device="cpu",
                                  batch_frames=4).encode_stream(pcm)
    dec = decode_stream(got)
    assert dec.md5_ok
    np.testing.assert_array_equal(dec.samples, pcm)
    if not lossy:
        assert got == want
        return
    with pytest.raises(Exception, match="MD5"):
        decode_stream(want)
    frames = torch.from_numpy(pcm[:N // B * B].reshape(-1, B, 2))
    fcfg = tframe.FrameConfig.from_params(TP.set_defaults(level), 2, 32,
                                          block_size=B)
    kinds = tframe.analyze_frames(
        frames, fcfg, torch.full((frames.shape[0],), 48))["sf_type"]
    assert kinds[2].tolist() == [tframe.SF_VERBATIM, tframe.SF_LPC]
