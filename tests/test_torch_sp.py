"""The port's sample-sharded (sp) analysis and emission against the JAX
package and the port's dense path, on the CPU.

- ``autocorr_sp`` over eight shards against JAX ``autocorr_sp`` under
  ``shard_map`` and the port's dense ``ops.lpc.autocorr``, within
  ``K1_REL_TOL`` (5e-11, ``tests/test_pallas_autocorr.py:55``) relative per
  element;
- the sharded analyzer over ``make_mesh(devices=["cpu"] * 4, sp=2)``
  against JAX ``make_sharded_analyzer`` over its virtual 8-device mesh with
  sp = 2, on ``test_sharding.py``'s constant and full-scale noise frames:
  every key that test checks, the residual joined over its shards, each of
  which holds half of every frame's samples;
- the port's sp analysis equal to its dense analysis (which the other
  tests hold against JAX) at levels 3, 5, 7 and 8, over 2 and 4 ranks, at
  16 and 24 bits, and on the near-threshold EST content of
  ``test_sharding.py``;
- the sp packer's words and bit counts against the single-device packer;
- ``Encoder(mesh=..., sp=2)`` against the JAX encoder over its sp mesh,
  byte for byte, under both emissions, decoding with its MD5;
- ``lpc_dtype="float32"`` over sp: lossless, and the same bytes twice.

The JAX computations are module-scope fixtures: each compiles once.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as PS

import flake_tpu
from flake_tpu import params as JP
from flake_tpu.decoder import decode_stream
from flake_tpu.ops import lpc as jlpc
from flake_tpu.ops.frame import FrameConfig as JFrameConfig
from flake_tpu.parallel import mesh as jmesh

import flake_tpu_torch
from flake_tpu_torch import params as TP
from flake_tpu_torch.ops import bitpack as tbitpack
from flake_tpu_torch.ops import frame as tframe
from flake_tpu_torch.ops import lpc as tlpc
from flake_tpu_torch.parallel import mesh as tmesh

from conftest import make_test_signal

K1_REL_TOL = 5e-11
CPU4 = ["cpu"] * 4
B = 1024
# test_sharding.py's keys
KEYS = ("sf_type", "order", "porder", "method", "coefs", "shift", "residual",
        "frame_bytes", "rice_params", "obits", "wasted", "ch_mode",
        "type_code")


def _frames(F, block, seed, bps=16):
    return make_test_signal(F * block, 2, bps, seed=seed).reshape(F, block, 2)


def _fcfg(level, bps=16, block=B, **overrides):
    cfg = tframe.FrameConfig.from_params(TP.set_defaults(level), 2, bps,
                                         block_size=block)
    return dataclasses.replace(cfg, **overrides)


# -- (a) the halo autocorrelation ---------------------------------------------

@pytest.fixture(scope="module")
def autocorr_case():
    """``test_sharding.py:67-88``'s inputs through JAX ``autocorr_sp`` at
    sp = 8."""
    n, max_order = 512, 12
    chans = make_test_signal(n, 2, 16, seed=3).T[None]       # [1, 2, n]
    window = jlpc.welch_window(n)
    shard = jax.shard_map(
        lambda c, w: jmesh.autocorr_sp(c, max_order, w),
        mesh=jmesh.make_mesh(8, sp=8),
        in_specs=(PS(None, None, "sp"), PS("sp")), out_specs=PS(),
        check_vma=False)
    want = np.asarray(shard(jnp.asarray(chans), jnp.asarray(window)))
    return chans, max_order, want


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1.0)))


def test_autocorr_sp_matches_jax_and_dense(autocorr_case):
    chans, max_order, want = autocorr_case
    x = torch.from_numpy(chans.reshape(2, -1))
    got = tmesh.autocorr_sp(list(x.chunk(8, dim=-1)), max_order).numpy()
    dense = tlpc.autocorr(x, max_order, tlpc.welch_window_on(
        x.shape[-1], torch.device("cpu"))).numpy()
    assert got.dtype == np.float64 and got.shape == (2, max_order + 1)
    assert _rel(got, want.reshape(2, -1)) < K1_REL_TOL
    assert _rel(got, dense) < K1_REL_TOL


@pytest.mark.parametrize("sp", [2, 3, 4])
def test_autocorr_sp_is_rank_deterministic(sp):
    """The partial sums add in rank order, so two runs give the same bits,
    and a 32-sample halo serves order 32 at 24 bits."""
    x = torch.from_numpy(make_test_signal(768, 2, 24, seed=5).T.copy())
    shards = list(x.chunk(sp, dim=-1))
    a = tmesh.autocorr_sp(shards, 32)
    assert torch.equal(a, tmesh.autocorr_sp(shards, 32))
    dense = tlpc.autocorr(x, 32, tlpc.welch_window_on(768,
                                                      torch.device("cpu")))
    assert _rel(a.numpy(), dense.numpy()) < K1_REL_TOL


def test_halo_wider_than_a_shard_is_refused():
    x = torch.zeros(2, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="halo"):
        tmesh.autocorr_sp(list(x.chunk(8, dim=-1)), 12)


# -- (b) the sharded analyzer against JAX -------------------------------------

def _analyzer_inputs():
    """``test_sharding.py:91-119``: a constant frame and a full-scale noise
    frame among music."""
    samples = _frames(8, B, seed=11)
    samples[1] = -5
    samples[2] = np.random.default_rng(5).integers(-32768, 32768,
                                                   samples[2].shape)
    return samples, np.full((8,), 48, np.int32)


@pytest.fixture(scope="module")
def jax_sp_analysis():
    samples, hdr = _analyzer_inputs()
    jcfg = JFrameConfig.from_params(JP.set_defaults(8), 2, 16, block_size=B)
    out = jmesh.make_sharded_analyzer(jcfg, jmesh.make_mesh(8, sp=2))(
        samples, hdr)
    return {k: np.asarray(out[k]) for k in KEYS}


def test_sharded_analyzer_matches_jax(jax_sp_analysis):
    samples, hdr = _analyzer_inputs()
    cfg = _fcfg(8)
    mesh = tmesh.make_mesh(devices=CPU4, sp=2)
    assert tmesh.sp_supported(cfg, 2)
    assert tmesh.frame_groups(cfg, mesh) == [tuple(r) for r in mesh.devices]
    got = tmesh.make_sharded_analyzer(cfg, mesh)(samples, hdr)
    # two groups of four frames, each frame's samples over two ranks
    assert [[tuple(s.shape) for s in g] for g in got["residual"]] \
        == [[(4, 2, B // 2)] * 2] * 2
    for key in KEYS:
        np.testing.assert_array_equal(tmesh.on_host(got[key]).numpy(),
                                      jax_sp_analysis[key], err_msg=key)
    assert int(got["global_max_frame_bytes"]) \
        == int(jax_sp_analysis["frame_bytes"].max())
    assert {tframe.SF_CONSTANT, tframe.SF_LPC} \
        <= set(tmesh.on_host(got["sf_type"]).numpy().ravel())


# -- (c) sp against the port's dense path -------------------------------------

def _equal_to_dense(samples, cfg, sp, devices=CPU4):
    hdr = np.full((samples.shape[0],), 48, np.int32)
    mesh = tmesh.make_mesh(devices=devices, sp=sp)
    assert tmesh.sp_supported(cfg, sp)
    got = tmesh.analyze_frames_sharded(samples, cfg, hdr, mesh)
    assert len(got["residual"][0]) == sp
    dense = tframe.analyze_frames(torch.from_numpy(samples), cfg,
                                  torch.from_numpy(hdr))
    for key, value in dense.items():
        np.testing.assert_array_equal(tmesh.on_host(got[key]).numpy(),
                                      value.numpy(), err_msg=key)
    return got


@pytest.mark.parametrize("bps", [16, 24])
@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("level", [3, 5, 7, 8])
def test_sp_equals_dense(level, sp, bps):
    samples = _frames(8, B, seed=level * 10 + bps, bps=bps)
    samples[3] = 7 << (bps - 12)           # constant, with wasted bits
    samples[5] = np.random.default_rng(level).integers(
        -(1 << (bps - 1)), 1 << (bps - 1), samples[5].shape)
    samples[6] = (samples[6] >> 3) << 3    # three wasted bits
    top = (1 << (bps - 1)) - 1                 # full-scale binary noise
    samples[7] = np.random.default_rng(bps).choice([-top - 1, top], (B, 2))
    got = _equal_to_dense(samples, _fcfg(level, bps), sp)
    assert {tframe.SF_CONSTANT, tframe.SF_VERBATIM, tframe.SF_LPC} \
        <= set(tmesh.on_host(got["sf_type"]).numpy().ravel())


def test_sp_equals_dense_near_the_est_threshold():
    """``test_sharding.py:145-181``: AR(1) content whose first reflection
    coefficient sits within ulps of EST's ``|ref| > 0.10``."""
    rng = np.random.default_rng(7)
    frames = []
    for a in (-0.0999999, -0.1, -0.1000001, -0.100001, -0.09999,
              0.1, 0.0999999, -0.2):
        noise = rng.standard_normal(B + 64) * 400
        x = np.zeros(B + 64)
        for t in range(1, B + 64):
            x[t] = -a * x[t - 1] + noise[t]
        pcm = np.stack([x[64:], x[64:] * 0.97], axis=1)
        frames.append(np.clip(pcm, -30000, 30000).astype(np.int32))
    samples = np.stack(frames)
    for method in (TP.OrderMethod.EST, TP.OrderMethod.LOG):
        _equal_to_dense(samples, _fcfg(6, order_method=int(method)), 2)


def test_sp_equals_dense_on_other_widths():
    """A 32-bit frame whose side channel would not fit int32 (the veto of
    side modes takes the max over ranks) and one whose left residual
    leaves int32 on the last rank (stored verbatim, the fold over ranks),
    6 channels, and level 12's order 32 over a 32-sample halo."""
    top = (1 << 31) - 1
    wide = _frames(4, B, seed=2, bps=32).astype(np.int64)
    wide[1, :, 0], wide[1, :, 1] = top, -top - 1
    wide[2, -16:, 0] = np.random.default_rng(2).choice([-top - 1, top], 16)
    got = _equal_to_dense(wide.astype(np.int32), _fcfg(8, bps=32), 2)
    assert tmesh.on_host(got["sf_type"])[2].tolist() \
        == [tframe.SF_VERBATIM, tframe.SF_LPC]
    six = make_test_signal(4 * B, 6, 16, seed=6).reshape(4, B, 6)
    cfg = tframe.FrameConfig.from_params(TP.set_defaults(8), 6, 16,
                                         block_size=B)
    _equal_to_dense(six, cfg, 4)
    _equal_to_dense(_frames(4, 2048, seed=12), _fcfg(12, block=2048), 2)


# -- (d) the sp packer --------------------------------------------------------

@pytest.mark.parametrize("sp", [2, 4])
def test_sp_packer_matches_one_device(sp):
    """``test_sharding.py:210-244``'s content: the words and bit counts of
    the single-device packer, every device of the mesh emitting its share
    of the frames."""
    F = 8
    samples = _frames(F, B, seed=31)
    samples[3] = -7
    samples[4] = np.random.default_rng(9).integers(-32768, 32768,
                                                   samples[4].shape)
    cfg = _fcfg(8)
    hb, hn = tbitpack.frame_header_bytes(
        np.arange(F, dtype=np.int64), bs_code=TP.blocksize_code(B),
        sr_code=TP.samplerate_code(44100), allow_vbs=0)
    hdr_bits = (hn * 8).astype(np.int32)
    dense = tframe.analyze_frames(torch.from_numpy(samples), cfg,
                                  torch.from_numpy(hdr_bits))
    w_ref, tb_ref = tbitpack.pack_frames_device(
        dense, torch.from_numpy(hb), torch.from_numpy(hn), cfg)
    run, gather, shards = tmesh.make_sharded_packer(
        cfg, tmesh.make_mesh(devices=CPU4, sp=sp))
    got = run(samples.astype(np.int16), hdr_bits, hb, hn)
    assert shards == 4 and len(got["words"]) == 4
    assert {w.shape[0] for w in got["words"]} == {F // 4}
    assert torch.equal(torch.cat(got["words"]), w_ref)
    assert torch.equal(torch.cat(got["total_bits"]), tb_ref)
    assert torch.equal(torch.cat(got["frame_bytes"]), dense["frame_bytes"])
    assert int(got["global_max_frame_bytes"]) \
        == int(dense["frame_bytes"].max())
    assert not bool(got["overflow"])
    whole = tbitpack.compact(w_ref, dense["frame_bytes"])
    for n in (F, 5, 1):
        parts = gather(got["words"], got["frame_bytes"], n)
        assert torch.equal(torch.cat(parts),
                           whole[:int(dense["frame_bytes"][:n].sum())])


# -- (e) the Encoder over sp against the JAX encoder --------------------------

def _stream_config():
    p = dataclasses.replace(JP.set_defaults(8), block_size=B)
    pcm = make_test_signal(16 * B + 137, 2, 16, seed=41)
    return JP.StreamConfig(channels=2, sample_rate=44100,
                           bits_per_sample=16, samples=pcm.shape[0],
                           params=p), pcm


@pytest.fixture(scope="module")
def jax_sp_stream():
    """``test_sharding.py:274-296``: 16 frames of 1024 and a tail of 137,
    batches of 8, over the JAX encoder's sp = 2 mesh."""
    jcfg, pcm = _stream_config()
    return flake_tpu.Encoder(jcfg, mesh=jmesh.make_mesh(8, sp=2),
                             pack_backend="device",
                             batch_frames=8).encode_stream(pcm)


@pytest.mark.parametrize("backend", ["device", "host"])
def test_encoder_over_sp_matches_jax(jax_sp_stream, backend):
    jcfg, pcm = _stream_config()
    enc = flake_tpu_torch.Encoder(
        TP.from_reference(jcfg), mesh=tmesh.make_mesh(devices=CPU4, sp=2),
        pack_backend=backend, batch_frames=8)
    got = enc.encode_stream(pcm)
    assert got == jax_sp_stream
    dec = decode_stream(got)
    assert dec.md5_ok
    np.testing.assert_array_equal(dec.samples, pcm)
    # the full frames took the sp path, the 137-sample tail folded into dp
    cache = enc._sharded_packers if backend == "device" \
        else enc._sharded_analyzers
    assert sorted(cfg.block_size for cfg in cache) == [137, B]
    assert tmesh.sp_supported(next(c for c in cache if c.block_size == B), 2)


# -- (f) float32 over sp ------------------------------------------------------

def test_float32_over_sp_is_lossless_and_deterministic():
    jcfg, pcm = _stream_config()
    cfg = TP.from_reference(jcfg)
    blobs = [flake_tpu_torch.Encoder(
        cfg, mesh=tmesh.make_mesh(devices=CPU4, sp=2), batch_frames=8,
        lpc_dtype="float32").encode_stream(pcm) for _ in range(2)]
    assert blobs[0] == blobs[1]
    dec = decode_stream(blobs[0])
    assert dec.md5_ok
    np.testing.assert_array_equal(dec.samples, pcm)
