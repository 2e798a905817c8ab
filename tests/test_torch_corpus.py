"""The benchmark corpus and the level matrix (``flake_tpu_torch.util.corpus``,
``flake_tpu_torch.util.level_matrix``) against ``util/corpus.py`` and
``util/level_matrix.py``.

Every class's WAV bytes equal the JAX tool's; one level-matrix cell
(``music_16_44``, 0.3 s, level 5, on the CPU) gives ``flake_tpu.Encoder``'s
bytes and decodes with its MD5; the rows and the table keep the JAX
tool's keys, columns and cells.
"""

import ast
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import flake_tpu
from flake_tpu import params as JP
from flake_tpu.decoder import decode_stream

from flake_tpu_torch.util import corpus as tcorpus
from flake_tpu_torch.util import level_matrix as tlm

ROOT = pathlib.Path(__file__).resolve().parent.parent
SECONDS = 0.5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six test workers with a thread pool each slow small encodes to
    minutes; the shapes here gain nothing from threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_jax", ROOT / "util" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """(port's paths, JAX tool's paths) of a corpus of SECONDS a file."""
    jcorpus = _load("corpus")
    assert list(jcorpus.CLASSES) == list(tcorpus.CLASSES)
    assert jcorpus.BITS == tcorpus.BITS
    return (tcorpus.build(tmp_path_factory.mktemp("port"), SECONDS),
            jcorpus.build(tmp_path_factory.mktemp("jax"), SECONDS))


@pytest.mark.parametrize("name", list(tcorpus.CLASSES))
def test_corpus_bytes_equal_jax(corpora, name):
    port, jax_paths = corpora
    got = port[name].read_bytes()
    assert len(got) > 44
    assert got == jax_paths[name].read_bytes()


def test_level_matrix_cell_matches_jax_encoder():
    pcm, rate = tcorpus.music(0.3)
    blob, dt = tlm.encode_cell(pcm, rate, 16, 5, device="cpu")
    assert dt > 0
    cfg = JP.StreamConfig(channels=2, sample_rate=rate, bits_per_sample=16,
                          samples=pcm.shape[0], params=JP.set_defaults(5))
    assert blob == flake_tpu.Encoder(cfg).encode_stream(pcm)
    dec = decode_stream(blob)
    assert dec.md5_ok
    np.testing.assert_array_equal(dec.samples, pcm)


def _jax_tool():
    """(row keys, table header, FULL_FILES, SPOT_LEVELS) of
    ``util/level_matrix.py``, read from its source without running it."""
    tree = ast.parse((ROOT / "util" / "level_matrix.py").read_text())
    keys = header = None
    consts = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "file"
                for k in node.keys):
            keys = [k.value for k in node.keys]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.startswith("| file |"):
            header = node.value
        elif isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Name) and node.targets[0].id in (
                    "FULL_FILES", "SPOT_LEVELS"):
            consts[node.targets[0].id] = ast.literal_eval(node.value)
    return keys, header, consts["FULL_FILES"], consts["SPOT_LEVELS"]


def test_level_matrix_rows_and_table_match_jax(tmp_path):
    keys, header, full_files, spot_levels = _jax_tool()
    assert tlm.FULL_FILES == full_files and tlm.SPOT_LEVELS == spot_levels
    row = tlm.cell_row("music_16_44", 5, 0.3, 1000, 4000, 0.1, None)
    assert list(row) == keys
    assert tlm.TABLE_HEADER == header
    # the JAX tool's cells: every level on the full files, spot levels on
    # the others, none above 8 on more than two channels
    assert tlm.cells("music_16_44", 2, False) == list(range(13))
    assert tlm.cells("music_16_44", 2, True) == list(spot_levels)
    assert tlm.cells("speech_16_44", 2, False) == list(spot_levels)
    assert tlm.cells("surround6_16_48", 6, False) == [2, 5, 8]
    out = tmp_path / "RESULTS.md"
    tlm.write_table(out, [row], "cpu", 0.3)
    lines = out.read_text().splitlines()
    at = lines.index(header.rstrip("\n"))
    assert lines[at + 2] == "| music_16_44 | 5 | 1000 | 0.2500 | 3x | — | — |"
