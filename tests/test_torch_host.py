"""The port's host-side modules against the JAX package's originals.

``flake_tpu_torch`` carries its own copies of the pure-Python host
modules (params, metadata, frame headers, the Welch window, the CRC
tables, the verification decoder) and its own native CRC patcher and
decoder helpers, because the JAX package's ``__init__`` imports JAX;
these tests hold the copies equal, and check that importing the port
pulls in no JAX.
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from flake_tpu import crc as jcrc
from flake_tpu import decoder as jdecoder
from flake_tpu import metadata as jmeta
from flake_tpu import native as jnative
from flake_tpu import params as JP
from flake_tpu.encoder import Encoder as JEncoder
from flake_tpu.native import crc_patch as jax_crc_patch
from flake_tpu.ops import bitpack as jbitpack
from flake_tpu.ops import lpc as jlpc
from flake_tpu.ops.frame import FrameConfig as JFrameConfig

import flake_tpu_torch
from flake_tpu_torch import crc as tcrc
from flake_tpu_torch import decoder as tdecoder
from flake_tpu_torch import metadata as tmeta
from flake_tpu_torch import native as tnative
from flake_tpu_torch import params as TP
from flake_tpu_torch.ops import autocorr as tautocorr
from flake_tpu_torch.ops import bitmerge as tbitmerge
from flake_tpu_torch.ops import bitpack as tbitpack
from flake_tpu_torch.ops import lpc as tlpc
from flake_tpu_torch.ops import sweep as tsweep
from flake_tpu_torch.ops.frame import FrameConfig as TFrameConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("level", range(13))
def test_from_reference_presets(level):
    jp = JP.set_defaults(level)
    tp = TP.from_reference(jp)
    assert isinstance(tp, TP.EncodeParams)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert dataclasses.asdict(TP.set_defaults(level)) \
        == dataclasses.asdict(jp)

    jcfg = JP.StreamConfig(channels=2, sample_rate=44100,
                           bits_per_sample=16, params=jp)
    tcfg = TP.from_reference(jcfg)
    assert isinstance(tcfg.params, TP.EncodeParams)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert TP.validate_params(tcfg) == JP.validate_params(jcfg)

    jf = JFrameConfig.from_params(jp, 2, 16)
    assert TP.from_reference(jf) == TFrameConfig.from_params(tp, 2, 16)


def test_param_tables_equal():
    for sr in (8000, 11025, 44100, 47999, 48000, 96000, 192000, 655350):
        assert TP.samplerate_code(sr) == JP.samplerate_code(sr)
    for bps in range(4, 33):
        assert TP.bps_code(bps) == JP.bps_code(bps)
    for bs in (16, 20, 192, 256, 777, 1152, 4096, 4608, 65535):
        assert TP.blocksize_code(bs) == JP.blocksize_code(bs)
        for ch, bps in ((1, 16), (2, 16), (2, 24), (6, 16)):
            assert TP.max_frame_size(bs, ch, bps) \
                == JP.max_frame_size(bs, ch, bps)


def test_write_headers_bytes():
    si = dict(min_block_size=4096, max_block_size=4096, min_frame_size=0,
              max_frame_size=12345, sample_rate=44100, channels=2,
              bits_per_sample=16, samples=7938000,
              md5sum=bytes(range(16)))
    for pad, entries in ((8192, []), (0, ["TITLE=x", "ARTIST=y"])):
        jvc = jmeta.VorbisComment(entries=list(entries))
        tvc = tmeta.VorbisComment(entries=list(entries))
        assert tmeta.write_headers(tmeta.StreamInfo(**si), pad, tvc) \
            == jmeta.write_headers(jmeta.StreamInfo(**si), pad, jvc)
    assert tmeta.DEFAULT_VENDOR == jmeta.DEFAULT_VENDOR


def test_frame_header_bytes():
    """Header bytes equal the JAX package's, and their count in bits is
    the JAX encoder's header bit count (the port derives one from the
    other: frame headers are whole bytes)."""
    nums = np.array([0, 1, 0x7F, 0x80, 0x7FF, 0x800, 0xFFFF, 0x1FFFF0,
                     0x3FFFFF0, 0x7FFFFFFF], dtype=np.int64)
    for bs in (4096, 777, 20, 200):
        for sr in (44100, 22000, 11025, 47999):
            kw = dict(bs_code=JP.blocksize_code(bs),
                      sr_code=JP.samplerate_code(sr), allow_vbs=0)
            jb, jn = jbitpack.frame_header_bytes(nums, **kw)
            tb, tn = tbitpack.frame_header_bytes(nums, **kw)
            np.testing.assert_array_equal(tb, jb)
            np.testing.assert_array_equal(tn, jn)
            jenc = JEncoder(JP.StreamConfig(sample_rate=sr,
                                            params=JP.set_defaults(8)))
            np.testing.assert_array_equal(
                tn * 8, jenc._hdr_bits(nums, JP.blocksize_code(bs)))


@pytest.mark.parametrize("n", [2, 16, 20, 777, 4096, 4097])
def test_welch_window(n):
    w = tlpc.welch_window(n)
    np.testing.assert_array_equal(w, jlpc.welch_window(n))
    np.testing.assert_array_equal(
        tlpc.welch_window_on(n, torch.device("cpu")).numpy(), w)


def test_crc_patch_matches_native():
    rng = np.random.default_rng(5)
    lengths = rng.integers(20, 400, 37).astype(np.int64)
    hdr_nb = rng.integers(5, 16, 37).astype(np.int32)
    buf = rng.integers(0, 256, int(lengths.sum())).astype(np.uint8)
    want = buf.copy()
    jax_crc_patch(want, lengths, hdr_nb)
    got = buf.copy()
    tnative.crc_patch(got, lengths, hdr_nb)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, buf)
    with pytest.raises(ValueError):
        tnative.crc_patch(buf.copy(), lengths + 1000, hdr_nb)


def test_crc_patch_is_built_from_the_ports_source():
    """The port's library comes from its own source, and returns what the
    JAX package's returns for malformed descriptors, writing nothing."""
    assert tnative.SRC.parent.name == "csrc"
    assert tnative.SRC.parent.parent.name == "flake_tpu_torch"
    rng = np.random.default_rng(6)
    lengths = rng.integers(20, 400, 9).astype(np.int64)
    hdr_nb = rng.integers(5, 16, 9).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(lengths[:-1])])
    buf = rng.integers(0, 256, int(lengths.sum())).astype(np.uint8)
    jlib, tlib = jnative.get_lib(), tnative.get_lib()
    cases = [(lengths, hdr_nb, offsets)]
    bad = lengths.copy()
    bad[4] = hdr_nb[4] + 1                      # no room for the CRC-16
    cases.append((bad, hdr_nb, offsets))
    short = hdr_nb.copy()
    short[7] = 4                                # header under 5 bytes
    cases.append((lengths, short, offsets))
    neg = offsets.copy()
    neg[0] = -1
    cases.append((lengths, hdr_nb, neg))
    over = lengths.copy()
    over[8] += 1                                # past the buffer's end
    cases.append((over, hdr_nb, offsets))
    for (ln, hn, off), want_rc in zip(cases, (0, 5, 8, 1, 9)):
        a, b = buf.copy(), buf.copy()
        rcs = [lib.flake_crc_patch(x, x.shape[0], 9, off.astype(np.int64),
                                   ln, hn) for lib, x in ((jlib, a),
                                                          (tlib, b))]
        assert rcs == [want_rc, want_rc]
        np.testing.assert_array_equal(a, b)
        assert (want_rc == 0) != np.array_equal(b, buf)


def test_crc_tables_equal():
    np.testing.assert_array_equal(tcrc.CRC8_TABLE, jcrc.CRC8_TABLE)
    np.testing.assert_array_equal(tcrc.CRC16_TABLE, jcrc.CRC16_TABLE)
    data = bytes(np.random.default_rng(7).integers(0, 256, 500,
                                                   dtype=np.uint8))
    assert tcrc.crc8(data) == jcrc.crc8(data)
    assert tcrc.crc16(data) == jcrc.crc16(data)


def _small_stream(level):
    """(pcm, the JAX encoder's bytes, the port's bytes) for a short
    stereo stream with a silent and a full-scale block."""
    rng = np.random.default_rng(level)
    B = 1152 if level < 3 else 1024
    n = 5 * B + 300
    t = np.arange(n)
    pcm = np.stack([9000 * np.sin(2 * np.pi * 220 * t / 44100),
                    7000 * np.sin(2 * np.pi * 330 * t / 44100)], 1) \
        + rng.normal(0, 200, (n, 2))
    pcm = np.clip(np.rint(pcm), -32768, 32767).astype(np.int32)
    pcm[B:2 * B] = 0
    pcm[2 * B:3 * B] = rng.choice([-32768, 32767], (B, 2))
    jcfg = JP.StreamConfig(channels=2, sample_rate=44100, bits_per_sample=16,
                           params=JP.set_defaults(level))
    jcfg.params.block_size = B
    return (pcm, JEncoder(jcfg, batch_frames=4).encode_stream(pcm),
            flake_tpu_torch.Encoder(TP.from_reference(jcfg), device="cpu",
                                    batch_frames=4).encode_stream(pcm))


@pytest.mark.parametrize("level", [2, 8])
@pytest.mark.parametrize("use_native", [True, False])
def test_decoder_copy_matches_original(level, use_native, monkeypatch):
    """The port's decoder gives what the original gives on a stream each
    encoder wrote (samples, STREAMINFO, frame count, MD5 flag), with the
    native helpers and with the pure-Python loops, and both reject a
    corrupted byte (CRC) and a wrong MD5."""
    monkeypatch.setattr(tdecoder, "USE_NATIVE", use_native)
    pcm, jblob, tblob = _small_stream(level)
    for blob in (jblob, tblob):
        want = jdecoder.decode_stream(blob)
        got = tdecoder.decode_stream(blob)
        np.testing.assert_array_equal(got.samples, want.samples)
        np.testing.assert_array_equal(got.samples, pcm)
        assert got.md5_ok and want.md5_ok
        assert got.frames == want.frames == 6
        assert dataclasses.asdict(got.streaminfo) \
            == dataclasses.asdict(want.streaminfo)
    broken = bytearray(tblob)
    broken[len(broken) // 2] ^= 0x10            # inside a frame
    with pytest.raises(jdecoder.FlacDecodeError):
        jdecoder.decode_stream(bytes(broken))
    with pytest.raises(tdecoder.FlacDecodeError):
        tdecoder.decode_stream(bytes(broken))
    wrong_md5 = bytearray(tblob)
    wrong_md5[8 + 18] ^= 0xFF                   # first MD5 byte
    with pytest.raises(jdecoder.FlacDecodeError, match="MD5"):
        jdecoder.decode_stream(bytes(wrong_md5))
    with pytest.raises(tdecoder.FlacDecodeError, match="MD5"):
        tdecoder.decode_stream(bytes(wrong_md5))
    assert tdecoder.decode_stream(bytes(wrong_md5),
                                  verify_md5=False).md5_ok \
        == jdecoder.decode_stream(bytes(wrong_md5), verify_md5=False).md5_ok


@pytest.mark.parametrize("modules", [
    "flake_tpu_torch, flake_tpu_torch.encoder, flake_tpu_torch.ops.bitpack",
    "flake_tpu_torch.bench", "flake_tpu_torch.util.corpus",
    "flake_tpu_torch.util.bench_matrix", "flake_tpu_torch.util.level_matrix",
    "flake_tpu_torch.util.prof_an5"])
def test_import_pulls_in_no_jax(modules):
    """Neither ``jax`` nor anything of the JAX package or ``util/``."""
    code = (f"import sys, {modules}; "
            "bad = [m for m in sys.modules if m in ('jax', 'flake_tpu', "
            "'util') or m.startswith(('jax.', 'flake_tpu.', 'util.'))]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert flake_tpu_torch.Encoder is not None


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for a CPU tensor; any other
    device gets its kernel or an error, never a silent fallback."""
    x = torch.zeros((2, 64), dtype=torch.int32, device="meta")
    w = torch.zeros(64, dtype=torch.float64, device="meta")
    c = torch.zeros((2, 4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tautocorr.autocorr(x, w, 4)
    with pytest.raises(ValueError):
        tsweep.sweep_sums(x, c, c[:, 0], 4, 2)
    with pytest.raises(ValueError):
        tbitmerge.merge_words(x, x, x, 1)
