"""The port's runner and dp mesh against the JAX package, on the CPU.

- ``shard_ranges`` equals the JAX function over a grid of stream lengths,
  block sizes and host counts;
- ``encode_stream_multihost(device="cpu")`` at 1-3 hosts writes the bytes
  of the JAX ``encode_stream_multihost`` and of one JAX ``Encoder``, at
  levels 1 and 8 (256-sample blocks, a ragged tail); with ``allow_vbs``
  (frames numbered by sample) too, and at level 12 reduced as
  ``test_torch_vbs.py`` reduces it, the bytes of one port encoder;
- a port mesh of four CPU devices against the JAX package on its virtual
  8-device mesh: ``analyze_frames_sharded`` equals ``training_step_sharded``
  key by key and in ``global_max_frame_bytes``, ``make_sharded_packer``
  gives the same words and ``total_bits``, and ``Encoder(mesh=...)`` the
  same stream under both emissions; the batch must divide by the mesh;
  sp > 1 folds into dp at a FIXED level (the sp analysis at the LPC levels
  is ``test_torch_sp.py``'s).

Everything is integer, so every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import flake_tpu
from flake_tpu import params as JP
from flake_tpu.decoder import decode_stream
from flake_tpu.ops import bitpack as jbitpack
from flake_tpu.ops.frame import FrameConfig as JFrameConfig
from flake_tpu.parallel import mesh as jmesh
from flake_tpu.parallel import runner as jrunner

import flake_tpu_torch
from flake_tpu_torch import params as TP
from flake_tpu_torch.ops import bitpack as tbitpack
from flake_tpu_torch.ops import frame as tframe
from flake_tpu_torch.parallel import mesh as tmesh
from flake_tpu_torch.parallel import runner as trunner

from conftest import make_test_signal

B = 256
CPU4 = ["cpu"] * 4


def _cfg(level, block_size=B, **overrides):
    cfg = JP.StreamConfig(channels=2, sample_rate=44100, bits_per_sample=16,
                          params=JP.set_defaults(level))
    cfg.params.block_size = block_size
    for key, value in overrides.items():
        setattr(cfg.params, key, value)
    return cfg


@pytest.mark.parametrize("n_hosts", [1, 2, 3, 4, 7])
def test_shard_ranges_match_jax(n_hosts):
    for n in (0, 1, 255, 256, 257, 10 * 256 + 37, 4096 * 9 + 100):
        for block in (16, 256, 4096):
            want = jrunner.shard_ranges(n, block, n_hosts)
            assert trunner.shard_ranges(n, block, n_hosts) == want
            assert want[-1][1] == n


@pytest.mark.parametrize("level", [1, 8])
@pytest.mark.parametrize("n_hosts", [1, 2, 3])
def test_multihost_matches_jax(level, n_hosts):
    # 12 frames: every host's batches take the JAX encoder's one shape of
    # 4 frames (each new shape costs it seconds of compile)
    pcm = make_test_signal(B * 12 + 37, 2, 16, seed=3)
    jcfg = _cfg(level)
    single = flake_tpu.Encoder(jcfg, batch_frames=4).encode_stream(pcm)
    want = jrunner.encode_stream_multihost(pcm, jcfg, n_hosts,
                                           batch_frames=4)
    got = trunner.encode_stream_multihost(pcm, TP.from_reference(jcfg),
                                          n_hosts, device="cpu",
                                          batch_frames=4)
    assert want == single
    assert got == want
    dec = decode_stream(got)
    assert dec.md5_ok
    np.testing.assert_array_equal(dec.samples, pcm)


def test_multihost_numbers_by_sample():
    """``allow_vbs`` numbers frames by their first sample: a host's first
    frame takes its span's start sample."""
    pcm = make_test_signal(B * 12 + 100, 2, 16, seed=4)
    jcfg = _cfg(8, allow_vbs=1)
    want = flake_tpu.Encoder(jcfg, batch_frames=4).encode_stream(pcm)
    got = trunner.encode_stream_multihost(pcm, TP.from_reference(jcfg), 3,
                                          device="cpu", batch_frames=4)
    assert got == want
    assert trunner.first_frame_number(TP.from_reference(jcfg), 3 * B) \
        == 3 * B


def test_multihost_variable_blocks():
    """Level 12 at 1024-sample superblocks and order 8: the spans split
    into sub-blocks numbered by sample, as one encoder numbers them."""
    n = 6 * 1024 + 300
    pcm = make_test_signal(n, 2, 16, seed=6).astype(np.int64)
    rng = np.random.default_rng(6)
    for start in range(0, n, 700):
        pcm[start:start + 700] = \
            pcm[start:start + 700] * rng.choice([1, 1, 1, 3]) // 3
    pcm = np.clip(pcm, -32768, 32767).astype(np.int32)
    cfg = TP.from_reference(_cfg(12, 1024, max_prediction_order=8))
    single = flake_tpu_torch.Encoder(cfg, device="cpu",
                                     batch_frames=8).encode_stream(pcm)
    got = trunner.encode_stream_multihost(pcm, cfg, 2, device="cpu",
                                          batch_frames=8)
    assert got == single
    dec = decode_stream(got)
    assert dec.md5_ok and dec.streaminfo.min_block_size == 16
    np.testing.assert_array_equal(dec.samples, pcm)


def _frames(F, block, seed):
    return make_test_signal(F * block, 2, 16, seed=seed).reshape(F, block, 2)


def test_analyze_frames_sharded_matches_jax():
    F = 16
    jcfg = JFrameConfig.from_params(JP.set_defaults(5), 2, 16, block_size=B)
    samples = _frames(F, B, seed=0)
    samples[3] = 0
    samples[9] = np.random.default_rng(9).integers(-32768, 32768, (B, 2))
    hdr = np.full((F,), 48, np.int32)
    want = jmesh.training_step_sharded(samples, jcfg, hdr, jmesh.make_mesh(8))
    got = tmesh.training_step_sharded(samples, TP.from_reference(jcfg), hdr,
                                      tmesh.make_mesh(devices=CPU4))
    for key in ("sf_type", "order", "porder", "method", "coefs", "shift",
                "residual", "frame_bytes", "rice_params", "obits", "wasted",
                "ch_mode", "type_code"):
        assert len(got[key]) == 4
        np.testing.assert_array_equal(torch.cat(got[key]).numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert int(got["global_max_frame_bytes"]) \
        == int(want["global_max_frame_bytes"])


def test_sharded_packer_matches_jax():
    F = 8
    jcfg = JFrameConfig.from_params(JP.set_defaults(8), 2, 16, block_size=B)
    samples = _frames(F, B, seed=2)
    samples[5] = np.random.default_rng(5).choice([-32768, 32767], (B, 2))
    nums = np.arange(F, dtype=np.int64)
    hdr_bytes, hdr_nb = jbitpack.frame_header_bytes(
        nums, bs_code=JP.blocksize_code(B), sr_code=JP.samplerate_code(44100),
        allow_vbs=0)
    hdr_bits = (hdr_nb * 8).astype(np.int32)
    run, _, nsh = jmesh.make_sharded_packer(jcfg, jmesh.make_mesh(8))
    want = run(samples, hdr_bits, hdr_bytes, hdr_nb)
    trun, gather, groups = tmesh.make_sharded_packer(
        TP.from_reference(jcfg), tmesh.make_mesh(devices=CPU4))
    got = trun(samples.astype(np.int16), hdr_bits, hdr_bytes, hdr_nb)
    assert (nsh, groups) == (8, 4)
    np.testing.assert_array_equal(torch.cat(got["words"]).numpy(),
                                  np.asarray(want["words"]))
    np.testing.assert_array_equal(torch.cat(got["total_bits"]).numpy(),
                                  np.asarray(want["total_bits"]))
    assert int(got["global_max_frame_bytes"]) \
        == int(want["global_max_frame_bytes"])
    assert not bool(got["overflow"]) and not bool(want["overflow"])
    # the groups' compacted bytes are the frames' bytes in frame order
    fb = torch.cat(got["frame_bytes"])
    whole = tbitpack.compact(torch.cat(got["words"]), fb)
    for n in (F, 5, 1):
        parts = gather(got["words"], got["frame_bytes"], n)
        np.testing.assert_array_equal(
            torch.cat(parts).numpy(), whole[:int(fb[:n].sum())].numpy())


def test_encoder_mesh_matches_jax():
    """``test_sharding.py``'s stream: 16 frames of 1024 and a tail of 137
    under a mesh, batches of 8."""
    p = dataclasses.replace(JP.set_defaults(8), block_size=1024)
    pcm = make_test_signal(16 * 1024 + 137, 2, 16, seed=41)
    jcfg = JP.StreamConfig(channels=2, sample_rate=44100, bits_per_sample=16,
                           samples=pcm.shape[0], params=p)
    want = flake_tpu.Encoder(jcfg, mesh=jmesh.make_mesh(8),
                             pack_backend="device",
                             batch_frames=8).encode_stream(pcm)
    for backend in ("device", "host"):
        enc = flake_tpu_torch.Encoder(
            TP.from_reference(jcfg), mesh=tmesh.make_mesh(devices=CPU4),
            pack_backend=backend, batch_frames=8)
        assert enc.encode_stream(pcm) == want, backend
        assert enc.device == torch.device("cpu")
        assert set(enc._sharded_packers if backend == "device"
                   else enc._sharded_analyzers)    # cached by config


def test_encoder_mesh_refusals():
    cfg = TP.from_reference(_cfg(8))
    mesh = tmesh.make_mesh(devices=CPU4)
    with pytest.raises(ValueError):
        flake_tpu_torch.Encoder(cfg, mesh=mesh, batch_frames=6)
    with pytest.raises(ValueError):
        flake_tpu_torch.Encoder(cfg, mesh=mesh, device="cpu")
    with pytest.raises(TypeError):
        flake_tpu_torch.Encoder(cfg)
    with pytest.raises(TypeError):
        flake_tpu_torch.Encoder(cfg, mesh=object())
    with pytest.raises(ValueError):
        tmesh.make_mesh(3, sp=2, devices=CPU4)
    with pytest.raises(ValueError):
        tmesh.make_mesh(5, devices=CPU4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmesh.make_mesh()
        with pytest.raises(RuntimeError):
            tmesh.make_mesh(devices=["cuda:0", "cuda:0"])
    m = tmesh.make_mesh(devices=CPU4, sp=2)
    assert (m.shape, m.size) == ({"dp": 2, "sp": 2}, 4)


def test_sp_folds_into_dp_at_a_fixed_level():
    """Level 1 (FIXED) is outside the sp analysis: an sp = 2 mesh splits
    the frames over all four devices, as the JAX package folds it."""
    jcfg = _cfg(1)
    fcfg = tframe.FrameConfig.from_params(TP.from_reference(jcfg).params,
                                          2, 16)
    mesh = tmesh.make_mesh(devices=CPU4, sp=2)
    assert not tmesh.sp_supported(fcfg, 2)
    assert not jmesh.sp_supported(
        JFrameConfig.from_params(jcfg.params, 2, 16), 2)
    samples = _frames(8, B, seed=7)
    hdr = np.full((8,), 48, np.int32)
    got = tmesh.analyze_frames_sharded(samples, fcfg, hdr, mesh)
    dense = tframe.analyze_frames(torch.from_numpy(samples), fcfg,
                                  torch.from_numpy(hdr))
    assert len(got["residual"]) == 4
    for key, value in dense.items():
        np.testing.assert_array_equal(torch.cat(got[key]).numpy(),
                                      value.numpy(), err_msg=key)
    pcm = make_test_signal(B * 12 + 37, 2, 16, seed=3)
    want = flake_tpu.Encoder(jcfg, batch_frames=4).encode_stream(pcm)
    got = flake_tpu_torch.Encoder(TP.from_reference(jcfg), mesh=mesh,
                                  batch_frames=4).encode_stream(pcm)
    assert got == want
