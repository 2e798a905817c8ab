"""The port's host-side modules against the JAX package's originals.

``flake_tpu_torch`` carries its own copies of the pure-Python host
modules (params, metadata, frame headers, the Welch window) because the
JAX package's ``__init__`` imports JAX; these tests hold the copies
equal, and check that importing the port pulls in no JAX.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from flake_tpu import metadata as jmeta
from flake_tpu import params as JP
from flake_tpu.encoder import Encoder as JEncoder
from flake_tpu.native import crc_patch as jax_crc_patch
from flake_tpu.ops import bitpack as jbitpack
from flake_tpu.ops import lpc as jlpc
from flake_tpu.ops.frame import FrameConfig as JFrameConfig

import flake_tpu_torch
from flake_tpu_torch import metadata as tmeta
from flake_tpu_torch import native as tnative
from flake_tpu_torch import params as TP
from flake_tpu_torch.ops import autocorr as tautocorr
from flake_tpu_torch.ops import bitmerge as tbitmerge
from flake_tpu_torch.ops import bitpack as tbitpack
from flake_tpu_torch.ops import lpc as tlpc
from flake_tpu_torch.ops import sweep as tsweep
from flake_tpu_torch.ops.frame import FrameConfig as TFrameConfig


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
    with pytest.raises(ValueError):
        tnative.crc_patch(buf.copy(), lengths + 1000, hdr_nb)


def test_import_pulls_in_no_jax():
    code = ("import sys, flake_tpu_torch, flake_tpu_torch.encoder, "
            "flake_tpu_torch.ops.bitpack; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'flake_tpu.')) or m == 'flake_tpu']; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
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
