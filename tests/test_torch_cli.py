"""The port's command line (``flake_tpu_torch.cli``, ``--device cpu``)
against the JAX package's (``flake_tpu.cli``) on the same WAV files: the
FLAC files must be equal byte for byte, and exit codes equal. Cases:
BASELINE config 1 at a small size (``-5 -b 4608`` on 3 x 4608 + 777
samples, with both emissions), ``-2 -b 512``, the parameter flags of
``tests/test_cli.py``, multi-file input with default naming, and stdin to
stdout. Also: same-name rejection, ``-h``, invalid options, the port's
``wavinfo`` text against the original's, ``--device cuda`` without CUDA
(an error, never the CPU), and ``examples/api_example_torch.py``.
"""

import importlib.util
import io
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

from flake_tpu import cli as jcli
from flake_tpu import wavinfo as jwavinfo

from flake_tpu_torch import cli as tcli
from flake_tpu_torch import wavinfo as twavinfo
from flake_tpu_torch.decoder import decode_stream
from flake_tpu_torch.io.wav import write_wave

from conftest import make_test_signal

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
CONFIG1_SAMPLES = 3 * 4608 + 777


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """name -> (path, samples): the config-1 WAV and a short one."""
    d = tmp_path_factory.mktemp("wavs")
    out = {}
    for name, n, seed in (("config1", CONFIG1_SAMPLES, 1),
                          ("short", 4000, 0)):
        pcm = make_test_signal(n, 2, 16, seed=seed)
        pcm[n // 3:n // 3 + 600] = 0                    # silence
        path = d / f"{name}.wav"
        write_wave(path, pcm, 44100, 16)
        out[name] = (path, pcm)
    return out


def _encode(mod, args, wav, out):
    rc = mod.main([*map(str, args), str(wav), "-o", str(out)])
    return rc, out.read_bytes() if out.exists() else None


def _port_args(args):
    return ["--device", "cpu", *args]


@pytest.mark.parametrize("wav_name,args", [
    ("config1", ["-q", "-5", "-b", "4608"]),
    ("config1", ["-q", "-5", "-b", "4608", "--pack-backend", "host"]),
    ("short", ["-q", "-2", "-b", "512"]),
    ("short", ["-q", "-b", "512", "-t", "1", "-l", "0,4", "-r", "2,4",
               "-s", "0", "-p", "0"]),
], ids=["config1", "config1-host", "level2", "param-flags"])
def test_cli_bytes_equal_jax(wavs, tmp_path, wav_name, args):
    wav, pcm = wavs[wav_name]
    rc_j, want = _encode(jcli, args, wav, tmp_path / "j.flac")
    rc_t, got = _encode(tcli, _port_args(args), wav, tmp_path / "t.flac")
    assert rc_t == rc_j == 0
    assert got == want
    dec = decode_stream(got)
    assert dec.md5_ok
    np.testing.assert_array_equal(dec.samples, pcm)
    assert dec.streaminfo.samples == pcm.shape[0]
    if wav_name == "config1":
        si = dec.streaminfo
        assert (si.min_block_size, si.max_block_size, si.sample_rate,
                si.channels, si.bits_per_sample) == (4608, 4608, 44100, 2, 16)


def test_multi_file_default_naming(tmp_path):
    paths = {}
    for who in ("j", "t"):
        (tmp_path / who).mkdir()
        paths[who] = []
        for i in range(2):
            p = tmp_path / who / f"m{i}.wav"
            write_wave(p, make_test_signal(2000 + 300 * i, 2, 16, seed=i),
                       44100, 16)
            paths[who].append(str(p))
    args = ["-q", "-1", "-b", "512"]
    assert jcli.main(args + paths["j"]) == 0
    assert tcli.main(_port_args(args) + paths["t"]) == 0
    for pj, pt in zip(paths["j"], paths["t"]):
        got = pathlib.Path(pt).with_suffix(".flac").read_bytes()
        assert got == pathlib.Path(pj).with_suffix(".flac").read_bytes()
    assert tcli.main(_port_args(args) + paths["t"] + ["-o", "x.flac"]) == 1


def test_stdin_to_stdout(wavs, monkeypatch):
    wav, _ = wavs["short"]
    outs = []
    for mod, args in ((jcli, ["-q", "-1", "-b", "512"]),
                      (tcli, _port_args(["-q", "-1", "-b", "512"]))):
        stdout = io.BytesIO()
        monkeypatch.setattr(sys, "stdin",
                            io.TextIOWrapper(io.BytesIO(wav.read_bytes())))
        monkeypatch.setattr(sys, "stdout", io.TextIOWrapper(stdout))
        assert mod.main([*args, "-"]) == 0
        sys.stdout.flush()
        outs.append(stdout.getvalue())
    assert outs[0] and outs[1] == outs[0]


@pytest.mark.parametrize("argv,rc", [
    (["-h"], 0), (["-z", "x"], 1), ([], 1), (["-q"], 1),
    (["--lpc-dtype", "float16", "x.wav"], 1),
    (["--pack-backend", "tpu", "x.wav"], 1), (["--nope", "x.wav"], 1),
    (["-b"], 1)])
def test_exit_codes(argv, rc, capsys):
    assert jcli.main(list(argv)) == rc
    j_out = capsys.readouterr()
    assert tcli.main(list(argv)) == rc
    t_out = capsys.readouterr()
    if argv == ["-h"]:
        # the reference's options read the same; the extensions name the
        # GPU and add --device
        head = jcli.HELP.split("TPU-native extensions")[0]
        assert t_out.out.startswith(head) and j_out.out.startswith(head)
        assert "--device cuda|cpu" in t_out.out and "TPU" not in t_out.out


def test_same_name_rejected(wavs):
    wav, _ = wavs["short"]
    for mod in (jcli, tcli):
        assert mod.main(["-q", str(wav), "-o", str(wav)]) == 1
    assert tcli.main(["--device", "gpu", str(wav)]) == 1


def test_device_cuda_without_cuda_fails(wavs, tmp_path, monkeypatch,
                                        capsys):
    wav, _ = wavs["short"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "never.flac"
    for argv in (["-q", str(wav), "-o", str(out)],
                 ["-q", "--device", "cuda", str(wav), "-o", str(out)]):
        assert tcli.main(argv) != 0
        assert "CUDA is not available" in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("name", ["short", "config1", "pluck-pcm16.wav",
                                  "pluck-pcm24.wav"])
def test_wavinfo_text_equal(wavs, name, capsys):
    path = wavs[name][0] if name in wavs else DATA / name
    rc_j = jwavinfo.main([str(path)])
    j_out = capsys.readouterr()
    rc_t = twavinfo.main([str(path)])
    t_out = capsys.readouterr()
    assert (rc_t, t_out.out, t_out.err) == (rc_j, j_out.out, j_out.err)
    assert rc_t == 0 and "Data Size:" in t_out.out


def test_wavinfo_on_other_files(tmp_path, capsys):
    """The port reports a file that is not WAVE and exits 1; the JAX
    package's ``parse_wave`` asserts instead, which escapes ``main``."""
    aiff = DATA / "pluck-pcm16.aiff"
    with pytest.raises(AssertionError):
        jwavinfo.main([str(aiff)])
    capsys.readouterr()
    assert twavinfo.main([str(aiff)]) == 1
    assert "error reading" in capsys.readouterr().err
    assert twavinfo.main([]) == jwavinfo.main([]) == 1
    assert twavinfo.main([str(tmp_path / "missing.wav")]) == 1


def test_api_example(wavs, tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "api_example_torch", ROOT / "examples" / "api_example_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    wav, pcm = wavs["short"]
    out = tmp_path / "ex.flac"
    assert example.main(["x", str(wav), str(out), "cpu"]) == 0
    assert example.main(["x"]) == 1
    capsys.readouterr()
    cli_out = tmp_path / "cli.flac"
    shutil.copy(wav, tmp_path / "in.wav")
    assert tcli.main(_port_args(["-q", "-5", str(tmp_path / "in.wav"),
                                 "-o", str(cli_out)])) == 0
    assert out.read_bytes() == cli_out.read_bytes()
    dec = decode_stream(out.read_bytes())
    assert dec.md5_ok
    np.testing.assert_array_equal(dec.samples, pcm)
