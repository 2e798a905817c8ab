"""The port Encoder's arguments beside the device: ``pack_backend``,
``vorbis_entries``, ``save_state`` / ``load_state`` and ``lpc_dtype``,
each against ``flake_tpu.Encoder`` with the same argument.

- ``pack_backend="host"`` (the native packer) must give the JAX host
  packer's bytes and the port's device emission's, at level 8 with a
  tail.
- Vorbis comment entries must land in the header as in the JAX encoder;
  an invalid entry raises ``ValueError`` in both.
- An encode split by ``save_state`` / ``load_state`` into a new encoder
  must give the bytes of one pass, and the JAX encoder's.
- ``lpc_dtype="float32"``: the float32 Schur, Levinson and quantizer must
  give the JAX package's bits on the same float32 autocorrelation. The
  autocorrelation itself is a float32 sum whose order XLA:CPU chooses
  and PyTorch does not reproduce, so the stream is held to what the
  fallback asks: lossless with its MD5, within 0.1% of the JAX float32
  file's size, and coefficients that meet K4's precondition.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import flake_tpu
from flake_tpu import params as JP
from flake_tpu.decoder import decode_stream
from flake_tpu.ops import lpc as jlpc

import flake_tpu_torch
from flake_tpu_torch import metadata as tmeta
from flake_tpu_torch import params as TP
from flake_tpu_torch.ops import frame as tframe
from flake_tpu_torch.ops import lpc as tlpc

from conftest import make_test_signal

B = 512
N = 9 * B + 333


def _cfg(level: int):
    cfg = JP.StreamConfig(channels=2, sample_rate=44100, bits_per_sample=16,
                          params=JP.set_defaults(level))
    cfg.params.block_size = B
    return cfg


@functools.lru_cache(maxsize=None)
def _pcm():
    pcm = make_test_signal(N, 2, 16, seed=11)
    pcm[B:2 * B] = 0
    pcm[3 * B:4 * B] = np.random.default_rng(11).choice(
        [-32768, 32767], (B, 2))
    return pcm


@functools.lru_cache(maxsize=None)
def _jax_level8_host() -> bytes:
    return flake_tpu.Encoder(_cfg(8), batch_frames=4,
                             pack_backend="host").encode_stream(_pcm())


def _port(level=8, **kwargs):
    return flake_tpu_torch.Encoder(TP.from_reference(_cfg(level)),
                                   device="cpu", batch_frames=4, **kwargs)


@pytest.mark.parametrize("backend", ["host", "device", "auto"])
def test_pack_backend_matches_jax(backend):
    enc = _port(pack_backend=backend)
    got = enc.encode_stream(_pcm())
    assert got == _jax_level8_host()
    assert enc.stats["frames"] == 10
    assert enc.stats["bytes_out"] == len(got) - len(enc.header())
    dec = decode_stream(got)
    assert dec.md5_ok
    np.testing.assert_array_equal(dec.samples, _pcm())


def test_pack_backend_refuses_other_names():
    with pytest.raises(ValueError):
        _port(pack_backend="tpu")
    with pytest.raises(ValueError):
        _port(lpc_dtype="float16")


@pytest.mark.parametrize("entries", [
    ["TITLE=test song", "ARTIST=flake-tpu"], [], ["a=", "Z=été"]])
def test_vorbis_entries_match_jax(entries):
    pcm = make_test_signal(1000, 2, 16)
    want = flake_tpu.Encoder(_cfg(2), vorbis_entries=entries) \
        .encode_stream(pcm)
    got = _port(2, vorbis_entries=entries).encode_stream(pcm)
    assert got == want
    assert decode_stream(got).vorbis_entries == entries


@pytest.mark.parametrize("entry", ["no equals sign", "TAB\tKEY=x",
                                   "BAD~KEY=x"])
def test_invalid_vorbis_entry_raises(entry):
    assert not tmeta.validate_vorbiscomment_entry(entry)
    for enc in (flake_tpu.Encoder(_cfg(2), vorbis_entries=[entry]),
                _port(2, vorbis_entries=[entry])):
        with pytest.raises(ValueError):
            enc.header()


@pytest.mark.parametrize("split", [4 * B, 4 * B + 100, N - 10])
def test_save_load_state_resumes(split):
    pcm = _pcm()
    first = _port()
    body = first.encode(pcm[:split])
    state = first.save_state()
    state_copy = first.save_state()
    first.encode(pcm[split:split + 700])      # the old encoder moves on
    resumed = _port()
    resumed.load_state(state)
    body += resumed.encode(pcm[split:], last=True)
    resumed.sample_count = N
    blob = bytearray(resumed.header()) + body
    blob[8:8 + 34] = tmeta.write_streaminfo(resumed.streaminfo())
    assert bytes(blob) == _port().encode_stream(pcm)
    assert bytes(blob) == _jax_level8_host()
    # the saved state is a copy: the first encoder's later input left it
    assert state["md5_state"].digest() == state_copy["md5_state"].digest()
    np.testing.assert_array_equal(state["pending"], state_copy["pending"])


def _exact_exp2(s):
    """2^s exact in the dtype of ``s``, as the C reference's ``1 <<
    shift``."""
    return jnp.ldexp(jnp.ones_like(s), s.astype(jnp.int32))


@pytest.mark.parametrize("method", ["levinson", "schur"])
def test_float32_recursions_match_jax(method, monkeypatch):
    """Given the same float32 autocorrelation (JAX's), the float32
    recursions give JAX's bits, and so does the quantizer once JAX's is
    given exact powers of two: XLA:CPU's float32 ``exp2`` is off at
    integers (2^13 = 8192.0039, 2^15 = 32767.984), which moves
    coefficients by one; the port builds exact powers, as the C
    reference's ``1 << shift`` is."""
    x = make_test_signal(16 * B, 2, 16, seed=5).T.reshape(32, B).copy()
    x[3] //= 1000                                  # a quiet stream
    window = jlpc.welch_window(B)
    autoc = jax.jit(lambda v: jlpc.autocorr(
        v, 12, jnp.asarray(window), jnp.float32))(jnp.asarray(x))
    if method == "levinson":
        want_rows, want_refs = jax.jit(jlpc.levinson_all_orders)(autoc)
        got_rows, got_refs = tlpc.levinson_all_orders(
            torch.from_numpy(np.array(autoc)))
    else:
        want_refs = jax.jit(jlpc.schur_refs)(autoc)
        want_rows = jax.jit(jlpc.levinson_from_refs)(want_refs)
        got_refs = tlpc.schur_refs(torch.from_numpy(np.array(autoc)))
        got_rows = tlpc.levinson_from_refs(got_refs)
    assert got_rows.dtype == torch.float32
    np.testing.assert_array_equal(got_refs.numpy(), np.asarray(want_refs))
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(want_rows))
    assert float(jax.jit(jnp.exp2)(jnp.float32(15))) != 32768.0
    monkeypatch.setattr(jlpc.jnp, "exp2", _exact_exp2)
    want_q, want_s = jax.jit(lambda r: jlpc.quantize_lpc_coefs(
        r, JP.LPC_PRECISION))(want_rows)
    got_q, got_s = tlpc.quantize_lpc_coefs(got_rows, TP.LPC_PRECISION)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_float32_stream_against_jax():
    pcm = _pcm()
    want = flake_tpu.Encoder(_cfg(8), batch_frames=4,
                             lpc_dtype="float32").encode_stream(pcm)
    got = _port(lpc_dtype="float32").encode_stream(pcm)
    dec = decode_stream(got)
    assert dec.md5_ok
    np.testing.assert_array_equal(dec.samples, pcm)
    assert abs(len(got) - len(want)) <= 0.001 * len(want)
    # the coefficients stay inside K4's precondition (below 2^14, shifts
    # 0-15), and the float32 path runs no float64 autocorrelation
    cfg = tframe.FrameConfig.from_params(TP.set_defaults(8), 2, 16,
                                         block_size=B, lpc_dtype="float32")
    frames = torch.from_numpy(pcm[:8 * B].reshape(8, B, 2))
    calls = []
    real = tframe.autocorr
    tframe.autocorr = lambda *a: calls.append(a) or real(*a)
    try:
        out = tframe.analyze_frames(frames, cfg,
                                    torch.full((8,), 48, dtype=torch.int32))
    finally:
        tframe.autocorr = real
    assert not calls
    assert int(out["coefs"].abs().max()) < 1 << 14
    assert 0 <= int(out["shift"].min()) and int(out["shift"].max()) <= 15
