"""The port's encoder against the JAX encoder at widths other than 16-bit
stereo: 24-bit/96 kHz stereo, 6 and 8 channels, 32-bit stereo, and the
24-bit recording at 11,025 Hz (the custom sample-rate header field).

``Encoder(device="cpu")`` bytes must equal ``flake_tpu.Encoder`` bytes,
and the stream must decode with its MD5. Blocks of 512 samples keep each
case to a few seconds; every stream ends in a partial block.
"""

import pathlib

import numpy as np
import pytest

import flake_tpu
from flake_tpu import params as JP
from flake_tpu.decoder import decode_stream
from flake_tpu.io import open_pcm

import flake_tpu_torch
from flake_tpu_torch import params as TP

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
