"""The port's level-8 slice against the JAX encoder, end to end.

``analyze_frames`` must equal ``analyze_frames_jit`` key by key on
silent, noise, mid/side and tonal frames; ``Encoder(device="cpu")``
bytes must equal ``flake_tpu.Encoder`` bytes for tails that take the
LPC path below 32 samples, FIXED and VERBATIM (the JAX encoder sends
tails to its scalar oracle, the port through its device path); and the
stream must decode losslessly with its MD5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import flake_tpu
from flake_tpu import params as JP
from flake_tpu.decoder import decode_stream
from flake_tpu.ops.frame import FrameConfig, analyze_frames_jit
from flake_tpu.parallel.mesh import make_mesh as jax_make_mesh

import flake_tpu_torch
from flake_tpu_torch import params as TP
from flake_tpu_torch.ops import frame as tframe
from flake_tpu_torch.parallel.mesh import make_mesh

from conftest import make_test_signal

B = 1024


def _level8(block_size=B):
    cfg = JP.StreamConfig(channels=2, sample_rate=44100, bits_per_sample=16,
                          params=JP.set_defaults(8))
    cfg.params.block_size = block_size
    return cfg


def test_analyze_frames_matches_jax():
    F = 8
    rng = np.random.default_rng(8)
    frames = make_test_signal(F * B, 2, 16, seed=8).reshape(F, B, 2)
    frames[1] = 0                                          # silent
    frames[2] = rng.choice([-32768, 32767], (B, 2))        # verbatim
    frames[6] = rng.integers(-32768, 32768, (B, 2))        # noise
    frames[3, :, 1] = frames[3, :, 0] // 2 + 7             # mid/side
    frames[4, :, 1] = frames[4, :, 0]                      # side = 0
    frames[5] = (frames[5] >> 4) << 4                      # wasted bits
    hdr = np.full(F, 48, np.int32)
    cfg = FrameConfig.from_params(JP.set_defaults(8), 2, 16, block_size=B)
    want = analyze_frames_jit(jnp.asarray(frames), cfg, jnp.asarray(hdr))
    got = tframe.analyze_frames(torch.from_numpy(frames),
                                TP.from_reference(cfg),
                                torch.from_numpy(hdr))
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(w),
                                      err_msg=key)
    assert len(set(np.asarray(want["ch_mode"]).tolist())) >= 3
    assert {0, 1, 32} <= set(np.asarray(want["sf_type"]).ravel().tolist())


@pytest.mark.parametrize("tail", [777, 20, 10, 3])
def test_encode_stream_matches_jax(tail):
    n = 8 * B + tail
    pcm = make_test_signal(n, 2, 16, seed=tail)
    pcm[B:2 * B] = 0
    pcm[3 * B:4 * B] = np.random.default_rng(tail).choice(
        [-32768, 32767], (B, 2))
    jcfg = _level8()
    want = flake_tpu.Encoder(jcfg, batch_frames=4).encode_stream(pcm)
    enc = flake_tpu_torch.Encoder(TP.from_reference(jcfg), device="cpu",
                                  batch_frames=4)
    got = enc.encode_stream(pcm)
    assert got == want
    assert enc.stats["frames"] == 9
    dec = decode_stream(got)
    assert dec.md5_ok
    np.testing.assert_array_equal(dec.samples, pcm)


def test_refuses_what_is_not_ported():
    cfg = TP.from_reference(_level8())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            flake_tpu_torch.Encoder(cfg, device="cuda")
    for level in range(13):          # every preset constructs
        flake_tpu_torch.Encoder(
            TP.StreamConfig(params=TP.set_defaults(level)), device="cpu")
    # the JAX Encoder's arguments: the port takes every one, the mesh too
    for kwargs in ({"pack_backend": "host"}, {"pack_backend": "device"},
                   {"vorbis_entries": ["TITLE=x"]},
                   {"lpc_dtype": "float32"}):
        flake_tpu.Encoder(_level8(), **kwargs)
        enc = flake_tpu_torch.Encoder(cfg, device="cpu", **kwargs)
        name, value = next(iter(kwargs.items()))
        assert getattr(enc, name) == value
    mesh = make_mesh(devices=["cpu"] * 4)
    enc = flake_tpu_torch.Encoder(cfg, mesh=mesh, batch_frames=8)
    assert enc.mesh is mesh
    # as in the JAX package, the batch must divide by the mesh size
    with pytest.raises(ValueError):
        flake_tpu.Encoder(_level8(), mesh=jax_make_mesh(8), batch_frames=6)
    with pytest.raises(ValueError):
        flake_tpu_torch.Encoder(cfg, mesh=mesh, batch_frames=6)
    enc = flake_tpu_torch.Encoder(cfg, device="cpu")
    for name in ("save_state", "load_state"):
        assert hasattr(flake_tpu.Encoder, name) and hasattr(enc, name)
    assert set(enc.save_state()) == set(
        flake_tpu.Encoder(_level8()).save_state())
    with pytest.raises(ValueError):
        flake_tpu_torch.Encoder(cfg, device="meta")
