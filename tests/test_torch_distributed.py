"""The port's distributed encode: ranks in processes of their own on a
``gloo`` group, on the CPU.

Each worker imports the port alone (it asserts that ``jax`` is not
loaded), joins the group and encodes the stream three ways:
``encode_stream_distributed`` (every rank returns the whole stream),
``encode_shard_distributed`` (each rank holding only its span) and
``encode_stream_to_file_distributed`` (each rank writes its span into one
file). At 2 and 3 ranks every rank's bytes and the file must equal one
JAX ``Encoder``'s, and so must the file of ``launch --spawn 2 --backend
gloo --device cpu``. Every wait has a timeout of its own, so a hang fails
the test.
"""

import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import flake_tpu
from flake_tpu import params as JP

from flake_tpu_torch.io.wav import write_wave

from conftest import make_test_signal

ROOT = pathlib.Path(__file__).resolve().parent.parent
B = 256
TIMEOUT = 120

_WORKER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    from flake_tpu_torch import params as P
    from flake_tpu_torch.io import open_pcm
    from flake_tpu_torch.parallel import distributed as D
    from flake_tpu_torch.parallel.runner import shard_ranges
    rank, nproc, port, wav, out, level, bs = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
        sys.argv[5], int(sys.argv[6]), int(sys.argv[7]))
    D.initialize(f"127.0.0.1:{port}", nproc, rank, "gloo")
    with open(wav, "rb") as fp:
        r = open_pcm(fp)
        pcm = r.read_all()
        cfg = P.StreamConfig(channels=r.info.channels,
                             sample_rate=r.info.sample_rate,
                             bits_per_sample=r.info.bits_per_sample,
                             samples=pcm.shape[0],
                             params=P.set_defaults(level))
    cfg.params.block_size = bs
    blob = D.encode_stream_distributed(pcm, cfg, device="cpu",
                                       batch_frames=4)
    with open(f"{out}.rank{rank}", "wb") as f:
        f.write(blob)
    lo, hi = shard_ranges(pcm.shape[0], bs, nproc)[rank]
    span = D.encode_shard_distributed(pcm[lo:hi], cfg, lo, pcm.shape[0],
                                      device="cpu", batch_frames=4)
    assert span == blob, "encode_shard_distributed differs"
    size = D.encode_stream_to_file_distributed(pcm, cfg, f"{out}.file",
                                               device="cpu", batch_frames=4)
    assert size == len(blob)
    D.dist.destroy_process_group()
    assert "jax" not in sys.modules, "a port worker imported jax"
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def _wait_all(procs):
    """Wait for every process, each with its own timeout; kill the rest
    when one hangs."""
    try:
        return [p.wait(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=TIMEOUT)


def _stream(tmp_path, n, seed):
    pcm = make_test_signal(n, 2, 16, seed=seed)
    wav = str(tmp_path / "in.wav")
    write_wave(wav, pcm, 44100, 16)
    return pcm, wav


def _jax_bytes(pcm, level, block_size=None):
    cfg = JP.StreamConfig(channels=2, sample_rate=44100, bits_per_sample=16,
                          samples=pcm.shape[0], params=JP.set_defaults(level))
    if block_size:
        cfg.params.block_size = block_size
    return flake_tpu.Encoder(cfg, batch_frames=4).encode_stream(pcm)


# 12 frames and a ragged tail: each rank's batches take one shape of the
# JAX encoder's, and the tail lands on the last rank
@pytest.mark.parametrize("nproc,level", [(2, 8), (3, 1)])
def test_ranks_match_single_host(tmp_path, nproc, level):
    pcm, wav = _stream(tmp_path, B * 12 + 37, seed=3)
    out = str(tmp_path / "out.flac")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(nproc), str(port), wav,
         out, str(level), str(B)], env=_env(), cwd=ROOT)
        for r in range(nproc)]
    single = _jax_bytes(pcm, level, B)
    assert _wait_all(procs) == [0] * nproc
    for r in range(nproc):
        assert pathlib.Path(f"{out}.rank{r}").read_bytes() == single, r
    assert pathlib.Path(f"{out}.file").read_bytes() == single


def test_launcher_spawn(tmp_path):
    pcm, wav = _stream(tmp_path, 1152 * 6 + 500, seed=5)
    out = tmp_path / "out.flac"
    proc = subprocess.Popen(
        [sys.executable, "-m", "flake_tpu_torch.parallel.launch",
         "--spawn", "2", "--backend", "gloo", "--device", "cpu",
         "--coordinator", f"127.0.0.1:{_free_port()}", "--level", "1",
         "--batch-frames", "4", wav, "-o", str(out)],
        env=_env(), cwd=ROOT)
    single = _jax_bytes(pcm, 1)
    assert _wait_all([proc]) == [0]
    assert out.read_bytes() == single


def test_launcher_refusals(tmp_path):
    """More ranks than cards under ``--device cuda``, and NCCL on the
    host, exit before joining a group."""
    _, wav = _stream(tmp_path, 4096, seed=1)
    for flags in (["--device", "cuda", "--num-processes", "64",
                   "--process-id", "0"],
                  ["--device", "cpu", "--backend", "nccl"]):
        proc = subprocess.run(
            [sys.executable, "-m", "flake_tpu_torch.parallel.launch", *flags,
             "--coordinator", f"127.0.0.1:{_free_port()}", wav, "-o",
             str(tmp_path / "x.flac")],
            env=_env(), cwd=ROOT, capture_output=True, text=True,
            timeout=TIMEOUT)
        assert proc.returncode != 0, flags
        assert not (tmp_path / "x.flac").exists()


def test_stats_line_is_one_write(monkeypatch):
    """A rank's ``--stats`` line reaches stdout in one write, newline and
    all, so ranks sharing a pipe cannot join their lines."""
    import io
    import json

    from flake_tpu_torch.parallel import launch

    writes = []

    class Recorder(io.StringIO):
        def write(self, s):
            writes.append(s)
            return super().write(s)

    monkeypatch.setattr(sys, "stdout", Recorder())
    launch.write_line({"rank": 1, "launches": {"autocorr": 3}})
    assert len(writes) == 1 and writes[0].endswith("\n")
    assert json.loads(writes[0]) == {"rank": 1, "launches": {"autocorr": 3}}


def test_stats_lines_of_ranks_sharing_a_pipe(tmp_path):
    """Two unbuffered processes writing stats lines together into one pipe,
    as ``--spawn``'s ranks do: every line read back is one JSON object."""
    import json

    writer = textwrap.dedent("""
        import sys
        from flake_tpu_torch.parallel.launch import write_line
        for i in range(20000):
            write_line({"rank": int(sys.argv[1]), "i": i, "pad": "x" * 360})
    """)
    env = dict(_env(), PYTHONUNBUFFERED="1")
    with subprocess.Popen(
            f"{sys.executable} -c '{writer}' 0 & "
            f"{sys.executable} -c '{writer}' 1; wait",
            shell=True, env=env, cwd=ROOT, stdout=subprocess.PIPE,
            text=True) as proc:
        out = proc.communicate(timeout=TIMEOUT)[0]
    lines = [json.loads(line) for line in out.splitlines()]
    assert proc.returncode == 0
    assert sorted((r["rank"], r["i"]) for r in lines) == [
        (r, i) for r in range(2) for i in range(20000)]
