"""The port's dp mesh and distributed encode on the card.

These tests need an NVIDIA GPU and skip without one; they import no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py

A mesh of ``cuda:0`` twice, and of distinct cards where there are two or
more, must write the bytes of ``device="cpu"`` under both emissions, at a
fixed-block LPC level and at a variable-block one; two ``gloo`` ranks on
``cuda:0`` through the launcher must write them too. Over sp = 2 (the card
twice, dp 2 x sp 2 on the card four times, and distinct cards where there
are two) levels 5, 8 and 12 must decode losslessly with their MD5, give
the same bytes twice and under both emissions, and run no plain version of
K1-K4 on the card.
"""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import flake_tpu_torch
from flake_tpu_torch import decoder
from flake_tpu_torch import params as P
from flake_tpu_torch.io.wav import write_wave
from flake_tpu_torch.ops import bitmerge, lpc, sweep
from flake_tpu_torch.parallel.mesh import make_mesh

pytestmark = pytest.mark.cuda
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.cuda.device_count()


def _stream(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(seconds * 44100) / 44100
    pcm = np.stack([9000 * np.sin(2 * np.pi * 220 * t),
                    8000 * np.sin(2 * np.pi * 277 * t + 0.3)], axis=1)
    pcm += rng.normal(0, 150, pcm.shape)
    pcm[44100:44100 + 2000] = rng.integers(-32768, 32768, (2000, 2))
    return np.clip(np.rint(pcm), -32768, 32767).astype(np.int32)


def _cfg(level):
    return P.StreamConfig(channels=2, sample_rate=44100, bits_per_sample=16,
                          params=P.set_defaults(level))


@pytest.mark.parametrize("level", [8, 12])
@pytest.mark.parametrize("backend", ["device", "host"])
def test_mesh_on_the_card_equals_the_cpu(cards, level, backend):
    pcm = _stream(4, seed=level)
    want = flake_tpu_torch.Encoder(_cfg(level), device="cpu",
                                   batch_frames=16).encode_stream(pcm)
    meshes = [["cuda:0", "cuda:0"]]
    if cards >= 2:
        meshes.append([f"cuda:{i}" for i in range(cards)])
    for devices in meshes:
        enc = flake_tpu_torch.Encoder(
            _cfg(level), mesh=make_mesh(devices=devices),
            batch_frames=16 * len(devices), pack_backend=backend)
        assert enc.encode_stream(pcm) == want, devices


def test_two_ranks_share_the_card(cards, tmp_path):
    pcm = _stream(3, seed=1)
    wav = tmp_path / "in.wav"
    write_wave(wav, pcm, 44100, 16)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "flake_tpu_torch.parallel.launch",
         "--spawn", "2", "--backend", "gloo", "--device", "cuda:0",
         "--coordinator", f"127.0.0.1:{port}", "--level", "8",
         "--batch-frames", "16", str(wav), "-o", str(tmp_path / "o.flac")],
        env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0
    want = flake_tpu_torch.Encoder(_cfg(8), device="cpu",
                                   batch_frames=16).encode_stream(pcm)
    assert (tmp_path / "o.flac").read_bytes() == want


@pytest.mark.parametrize("level", [5, 8, 12])
def test_sp_mesh_on_the_card(cards, level, monkeypatch):
    def cpu_only(name, plain):
        def run(x, *args):
            assert x.device.type == "cpu", f"{name} ran on {x.device}"
            return plain(x, *args)
        return run

    for mod, name in ((lpc, "autocorr"), (sweep, "sweep_sums_plain"),
                      (sweep, "sweep_granules_plain"),
                      (bitmerge, "merge_words_plain")):
        monkeypatch.setattr(mod, name, cpu_only(name, getattr(mod, name)))
    pcm = _stream(3, seed=level)
    meshes = [["cuda:0"] * 2, ["cuda:0"] * 4]
    if cards >= 2:
        meshes.append(["cuda:0", "cuda:1"])
    blobs = []
    for devices in meshes:
        mesh = make_mesh(devices=devices, sp=2)
        got = [flake_tpu_torch.Encoder(
            _cfg(level), mesh=mesh, batch_frames=16 * len(devices),
            pack_backend=backend).encode_stream(pcm)
            for backend in ("device", "host", "device")]
        assert got[0] == got[1] == got[2], devices
        dec = decoder.decode_stream(got[0])
        assert dec.md5_ok
        np.testing.assert_array_equal(dec.samples, pcm)
        blobs.append(got[0])
    if cards >= 2:
        assert blobs[2] == blobs[0]
