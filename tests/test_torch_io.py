"""The port's input layer (``flake_tpu_torch.io``) against the JAX
package's (``flake_tpu.io``): the same bytes in must give equal
``PcmInfo`` fields and equal int32 samples, and ``write_wave`` must write
the same file. The cases are those of ``tests/test_io.py`` (round trips at
8-32 bits, IEEE float, WAVE_FORMAT_EXTENSIBLE, a hand-built AIFF, the raw
fallback, seeks, the forward-only pipe, the conversion matrix) and the
recorded plucks in ``tests/data``.
"""

import dataclasses
import io
import pathlib
import struct

import numpy as np
import pytest

from flake_tpu import io as jio
from flake_tpu.io import convert as jconvert
from flake_tpu.io import wav as jwav

from flake_tpu_torch import io as tio
from flake_tpu_torch.io import convert as tconvert
from flake_tpu_torch.io import wav as twav

from conftest import make_test_signal

DATA = pathlib.Path(__file__).parent / "data"


def _read(mod, blob: bytes):
    """(info fields, all samples) of ``blob`` through ``mod.open_pcm``."""
    r = mod.open_pcm(io.BytesIO(blob))
    info = dataclasses.asdict(r.info)
    return info, r.info.samples, r.read_all()


def _assert_same(blob: bytes):
    want_info, want_n, want = _read(jio, blob)
    got_info, got_n, got = _read(tio, blob)
    assert got_info == want_info
    assert got_n == want_n
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    return got_info, got


@pytest.mark.parametrize("name", ["pluck-pcm16.wav", "pluck-pcm24.wav",
                                  "pluck-pcm16.aiff"])
def test_recorded_files(name):
    blob = (DATA / name).read_bytes()
    info, pcm = _assert_same(blob)
    assert info["sample_rate"] == 11025
    assert pcm.shape[0] > 1000 and np.abs(pcm).max() > 0


@pytest.mark.parametrize("bps", [8, 16, 24, 32])
def test_wave_roundtrip(tmp_path, bps):
    pcm = make_test_signal(1000, 2, bps, seed=bps)
    twav.write_wave(tmp_path / "t.wav", pcm, 48000, bps)
    jwav.write_wave(tmp_path / "j.wav", pcm, 48000, bps)
    blob = (tmp_path / "t.wav").read_bytes()
    assert blob == (tmp_path / "j.wav").read_bytes()
    info, got = _assert_same(blob)
    assert (info["bits_per_sample"], info["sample_rate"]) == (bps, 48000)
    np.testing.assert_array_equal(got, pcm)


def _float_wav():
    n = 200
    f32 = (np.sin(np.arange(n) * 0.1) * 0.5).astype("<f4")
    hdr = (b"RIFF" + struct.pack("<I", 36 + 4 * n) + b"WAVE"
           + b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, 44100,
                                   44100 * 4, 4, 32)
           + b"data" + struct.pack("<I", 4 * n))
    return hdr + f32.tobytes()


def _extensible_wav():
    pcm = make_test_signal(64, 2, 16)
    ext = struct.pack("<HHIH14s", 22, 16, 0x3, 1, b"\x00" * 14)
    fmt = struct.pack("<HHIIHH", 0xFFFE, 2, 44100, 44100 * 4, 4, 16) + ext
    data = pcm.reshape(-1).astype("<i2").tobytes()
    return (b"RIFF" + struct.pack("<I", 20 + len(fmt) + len(data))
            + b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)


def _aiff():
    n = 100
    pcm = make_test_signal(n, 1, 16)
    ext = struct.pack(">HQ", 16398, 0xAC44 << 48)     # 44100, 80-bit
    comm = struct.pack(">hIh", 1, n, 16) + ext
    ssnd = struct.pack(">II", 0, 0) + pcm[:, 0].astype(">i2").tobytes()
    return (b"FORM" + struct.pack(">I", 4 + 8 + len(comm) + 8 + len(ssnd))
            + b"AIFF"
            + b"COMM" + struct.pack(">I", len(comm)) + comm
            + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)


def _raw():
    return make_test_signal(500, 2, 16).reshape(-1).astype("<i2").tobytes()


@pytest.mark.parametrize("kind,want_format", [
    ("float", "wave"), ("extensible", "wave"), ("aiff", "aiff"),
    ("raw", "raw")])
def test_containers(kind, want_format):
    blob = {"float": _float_wav, "extensible": _extensible_wav,
            "aiff": _aiff, "raw": _raw}[kind]()
    info, pcm = _assert_same(blob)
    assert info["format_name"] == want_format
    if kind == "float":
        assert info["float_fmt"] and np.abs(pcm).max() > 1 << 28
    if kind == "extensible":
        assert info["channel_mask"] == 0x3


@pytest.mark.parametrize("magic", [
    b"RIFF\x00\x00\x00\x00WAVE", b"FORM\x00\x00\x00\x00AIFF",
    b"FORM\x00\x00\x00\x00AIFC", b"\x01\x02\x03\x04\x05\x06\x07\x08\x09"
    b"\x0a\x0b\x0c", b"RIFF"])
def test_probe_registry(magic):
    import flake_tpu.io.aiff  # noqa: F401  (the JAX package registers
    import flake_tpu.io.raw  # noqa: F401   its formats on first open)
    assert tio.probe_format(magic) == jio.probe_format(magic)
    assert [name for name, _, _ in tio.pcm._FORMATS] \
        == ["aiff", "raw", "wave"]


@pytest.mark.parametrize("moves", [
    [(300, 0, 100), (-50, 1, 10), (-100, 2, 200)],
    [(0, 2, 5), (10_000, 0, 5), (-10_000, 1, 3)]])
def test_seek_samples(tmp_path, moves):
    pcm = make_test_signal(1000, 2, 16)
    path = tmp_path / "seek.wav"
    twav.write_wave(path, pcm, 44100, 16)
    with open(path, "rb") as ft, open(path, "rb") as fj:
        rt, rj = tio.open_pcm(ft), jio.open_pcm(fj)
        for offset, whence, n in moves:
            assert rt.seek_samples(offset, whence) \
                == rj.seek_samples(offset, whence)
            got = rt.read_samples(n)
            np.testing.assert_array_equal(got, rj.read_samples(n))
            assert rt.position() == rj.position()
    assert rt.position() > 0


class _Pipe:
    """A read-only stream with no ``seek``."""

    def __init__(self, data):
        self.data, self.pos = data, 0

    def read(self, n=-1):
        n = len(self.data) - self.pos if n < 0 else n
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out


def test_seek_in_pipe_forward_only():
    pcm = make_test_signal(500, 2, 16)
    raw = pcm.reshape(-1).astype("<i2").tobytes()
    rt, rj = tio.open_pcm(_Pipe(raw)), jio.open_pcm(_Pipe(raw))
    assert rt.seek_samples(100) == rj.seek_samples(100) == 100
    got = rt.read_samples(50)
    np.testing.assert_array_equal(got, rj.read_samples(50))
    np.testing.assert_array_equal(got, pcm[100:150])
    for r in (rt, rj):
        with pytest.raises(ValueError):
            r.seek_samples(0)


_VALUES = {"u8": np.array([0, 1, 127, 128, 200, 255], dtype=np.uint8),
           "s16": np.array([-32768, -1, 0, 1, 12345, 32767], np.int32),
           "s20": np.array([-(1 << 19), -7, 0, 5, (1 << 19) - 1], np.int32),
           "s24": np.array([-(1 << 23), -1, 0, 1, (1 << 23) - 1], np.int32),
           "s32": np.array([-(1 << 31), -3, 0, 3, (1 << 31) - 1],
                           np.int32)}


@pytest.mark.parametrize("src", tconvert.FORMATS)
@pytest.mark.parametrize("dst", tconvert.FORMATS)
def test_convert_matrix(src, dst):
    assert tconvert.FORMATS == jconvert.FORMATS
    got = tconvert.convert(_VALUES[src], src, dst)
    want = jconvert.convert(_VALUES[src], src, dst)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_convert_rejects_unknown_formats():
    for mod in (tconvert, jconvert):
        with pytest.raises(ValueError):
            mod.convert(_VALUES["s16"], "s16", "s12")
