"""The EST and 2/4/8-LEVEL order methods and levels 0-7 against JAX.

``schur_refs`` and ``levinson_from_refs`` must equal the jitted JAX
functions bit for bit in float64 (XLA:CPU fuses every multiply-add of
both; EST reads ``|ref| > 0.10`` and the quantizer truncates, so an ulp
can move an order or a coefficient); ``select_order`` must pick the JAX
order for EST and LEVEL2/4/8 on random bit counts with ties and on
order ranges whose candidates repeat or clamp to 0; ``analyze_frames``
must equal ``analyze_frames_jit`` key by key at levels 5 and 7; and
``Encoder(device="cpu")`` bytes must equal ``flake_tpu.Encoder``'s at
levels 0 to 7, mono included, with tails that take the LPC
path below 32 samples, FIXED and VERBATIM, decoded with MD5 by both
decoders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flake_tpu
from flake_tpu import decoder as jdecoder
from flake_tpu import params as JP
from flake_tpu.ops import frame as jframe
from flake_tpu.ops import lpc as jlpc

import flake_tpu_torch
from flake_tpu_torch import decoder as tdecoder
from flake_tpu_torch import params as TP
from flake_tpu_torch.ops import frame as tframe
from flake_tpu_torch.ops import lpc as tlpc

from conftest import make_test_signal


def _autoc(N, B, max_order, seed):
    """float64 [N, max_order+1] windowed autocorrelations of tonal
    streams with noise; row 1 is silent (all lags 2.0, the bias)."""
    rng = np.random.default_rng(seed)
    t = np.arange(B)
    x = 8000 * np.sin(2 * np.pi * rng.uniform(50, 3000, (N, 1)) * t / 44100) \
        + rng.normal(0, rng.uniform(1, 2000, (N, 1)), (N, B))
    x[1] = 0
    return tlpc.autocorr(torch.from_numpy(x.astype(np.int32)), max_order,
                         torch.from_numpy(tlpc.welch_window(B))).numpy()


@pytest.mark.parametrize("max_order", [8, 6, 32])
def test_schur_and_seeded_levinson_bitwise(max_order):
    autoc = _autoc(300, 512, max_order, seed=max_order)
    want_refs = np.asarray(jax.jit(jlpc.schur_refs)(jnp.asarray(autoc)))
    got_refs = tlpc.schur_refs(torch.from_numpy(autoc)).numpy()
    np.testing.assert_array_equal(got_refs, want_refs)
    want_rows = np.asarray(
        jax.jit(jlpc.levinson_from_refs)(jnp.asarray(want_refs)))
    got_rows = tlpc.levinson_from_refs(torch.from_numpy(got_refs)).numpy()
    assert got_rows.shape == (300, max_order, max_order)
    np.testing.assert_array_equal(got_rows, want_rows)


def test_estimate_order_matches_jax():
    rng = np.random.default_rng(1)
    refs = rng.uniform(-0.3, 0.3, (500, 8))
    refs[0] = 0.05                      # none above: order 1
    refs[1] = [0.5, 0, 0, 0.10, 0, 0, 0, 0]     # 0.10 is not above
    refs[2] = [0, 0, 0, 0, 0, 0, 0, -0.11]
    refs[3, :] = np.nextafter(0.10, 1)
    want = np.asarray(jlpc.estimate_order(jnp.asarray(refs), 8))
    got = tlpc.estimate_order(torch.from_numpy(refs), 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:4].tolist() == [1, 1, 8, 8]


@pytest.mark.parametrize("min_o,max_o", [(1, 8), (1, 6), (1, 12), (3, 3),
                                         (1, 2), (1, 32), (1, 1)])
@pytest.mark.parametrize("method", [JP.OrderMethod.LEVEL2,
                                    JP.OrderMethod.LEVEL4,
                                    JP.OrderMethod.LEVEL8,
                                    JP.OrderMethod.EST])
def test_select_order_matches_jax(method, min_o, max_o):
    """Random bit counts in a narrow range, so candidates tie; row 0 ties
    everywhere. Small order ranges give candidates that repeat or clamp
    to order index 0 (``frame.py:176-177``)."""
    rng = np.random.default_rng(int(method) * 100 + max_o)
    bits = rng.integers(1000, 1004, (256, max_o)).astype(np.int64)
    bits[0] = 7
    refs = rng.uniform(-0.2, 0.2, (256, max_o))
    p = JP.set_defaults(5)
    p.order_method = method
    p.min_prediction_order, p.max_prediction_order = min_o, max_o
    jcfg = jframe.FrameConfig.from_params(p, 2, 16)
    want = np.asarray(jframe.select_order(
        jcfg, jnp.asarray(bits), jnp.asarray(refs), (256,)))
    got = tframe.select_order(TP.from_reference(jcfg),
                              torch.from_numpy(bits), torch.from_numpy(refs),
                              (256,), torch.device("cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("level", [5, 7])
def test_analyze_frames_matches_jax(level):
    F, B = 4, 1024
    rng = np.random.default_rng(level)
    frames = make_test_signal(F * B, 2, 16, seed=level).reshape(F, B, 2)
    frames[1] = 0                                          # silent
    frames[2] = rng.integers(-32768, 32768, (B, 2))        # noise
    frames[3, :, 1] = frames[3, :, 0] // 2 + 7             # mid/side
    hdr = np.full(F, 48, np.int32)
    cfg = jframe.FrameConfig.from_params(JP.set_defaults(level), 2, 16,
                                         block_size=B)
    want = jframe.analyze_frames_jit(jnp.asarray(frames), cfg,
                                     jnp.asarray(hdr))
    got = tframe.analyze_frames(torch.from_numpy(frames),
                                TP.from_reference(cfg),
                                torch.from_numpy(hdr))
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(w),
                                      err_msg=key)
    assert 32 in np.asarray(want["sf_type"])
    orders = np.asarray(want["order"])[np.asarray(want["sf_type"]) == 32]
    assert len(set(orders.tolist())) >= 2     # the method did choose


def _stream_config(level, channels, block_size):
    cfg = JP.StreamConfig(channels=channels, sample_rate=44100,
                          bits_per_sample=16, params=JP.set_defaults(level))
    cfg.params.block_size = block_size
    return cfg


# levels 0-2 keep their preset block of 1152; the LPC levels run at 1024.
# Tails: 777 takes the level's own path, 20 the LPC path below 32 samples
# (FIXED at levels 0-2), 10 FIXED (n <= max order at level 7 too), 3
# VERBATIM
@pytest.mark.parametrize("level,channels,block_size,tail", [
    (5, 2, 1024, 777), (5, 2, 1024, 20), (5, 2, 1024, 10), (5, 2, 1024, 3),
    (2, 2, 1152, 777), (2, 2, 1152, 20), (2, 2, 1152, 10), (2, 2, 1152, 3),
    (0, 2, 1152, 777), (3, 2, 1024, 20), (7, 2, 1024, 777),
    (5, 1, 1024, 10), (0, 1, 1152, 3),
    (1, 2, 1152, 20), (4, 2, 1024, 20), (6, 2, 1024, 20)])
def test_encode_stream_matches_jax(level, channels, block_size, tail):
    n = 6 * block_size + tail
    pcm = make_test_signal(n, channels, 16, seed=level * 1000 + tail)
    pcm[block_size:2 * block_size] = 0
    pcm[3 * block_size:4 * block_size] = np.random.default_rng(tail).choice(
        [-32768, 32767], (block_size, channels))
    jcfg = _stream_config(level, channels, block_size)
    want = flake_tpu.Encoder(jcfg, batch_frames=4).encode_stream(pcm)
    enc = flake_tpu_torch.Encoder(TP.from_reference(jcfg), device="cpu",
                                  batch_frames=4)
    got = enc.encode_stream(pcm)
    assert got == want
    assert enc.stats["frames"] == 7
    for decode in (jdecoder.decode_stream, tdecoder.decode_stream):
        dec = decode(got)
        assert dec.md5_ok
        np.testing.assert_array_equal(dec.samples, pcm)


@pytest.mark.parametrize("level", range(13))
def test_every_preset_constructs_and_encodes(level):
    """Every preset 0-12 encodes a short stream that decodes lossless."""
    cfg = TP.StreamConfig(channels=2, sample_rate=44100, bits_per_sample=16,
                          params=TP.set_defaults(level))
    cfg.params.block_size = 256
    cfg.params.max_prediction_order = min(
        cfg.params.max_prediction_order, 8)
    pcm = make_test_signal(3 * 256 + 40, 2, 16, seed=level)
    blob = flake_tpu_torch.Encoder(cfg, device="cpu",
                                   batch_frames=4).encode_stream(pcm)
    dec = tdecoder.decode_stream(blob)
    assert dec.md5_ok
    np.testing.assert_array_equal(dec.samples, pcm)
