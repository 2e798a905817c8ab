"""The port's bench (``flake_tpu_torch.bench``) and bench matrix
(``flake_tpu_torch.util.bench_matrix``) on the CPU, against ``bench.py``,
``util/bench_matrix.py`` and the JAX pipeline.

The bench at a small size prints exactly ``bench.py``'s keys with a
verified end-to-end stream; on the same numpy batch its emission checksum
and compressed ratio equal JAX's ``analyze_frames`` + ``pack_frames_device``
(jitted, as the JAX package's CPU tests run them); the matrix's level-8 row
has the JAX tool's keys plus ``peak_mib`` and holds device-pack parity.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flake_tpu import params as JP
from flake_tpu.ops import bitpack as jbitpack
from flake_tpu.ops.frame import FrameConfig as JFrameConfig
from flake_tpu.ops.frame import analyze_frames as janalyze

from flake_tpu_torch import bench
from flake_tpu_torch import params as TP
from flake_tpu_torch.graft_entry import pipeline_step
from flake_tpu_torch.util import bench_matrix

ROOT = pathlib.Path(__file__).resolve().parent.parent
FRAMES, BLOCK = 4, 256


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The bench is thousands of small torch calls; six test workers with
    a thread pool each slow it to minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dict_keys(path: pathlib.Path, name: str) -> list:
    """The keys of the dict literal assigned to ``name`` in ``path``, and
    of every later ``name["key"] = ...``, in order; read with ``ast``."""
    keys = []
    for node in ast.walk(ast.parse(path.read_text())):
        if not isinstance(node, ast.Assign):
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name) and target.id == name \
                and isinstance(node.value, ast.Dict):
            keys += [k.value for k in node.value.keys]
        elif isinstance(target, ast.Subscript) and isinstance(
                target.value, ast.Name) and target.value.id == name:
            keys.append(target.slice.value)
    return keys


@pytest.fixture(scope="module")
def result():
    return bench.run(device="cpu", frames=FRAMES, block=BLOCK,
                     e2e_seconds=0.2)


def test_bench_prints_the_jax_keys(result, capsys):
    assert list(result) == _dict_keys(ROOT / "bench.py", "result")
    assert list(result["e2e_breakdown"]) == _dict_keys(ROOT / "bench.py",
                                                       "breakdown")
    assert result["device"] == "cpu"
    assert result["host_pack_gbps"] > 0
    assert result["vs_baseline"] is None or result["vs_baseline"] > 0


def test_bench_e2e_verified(result):
    assert result["e2e_verified"] is True
    assert result["e2e_breakdown"]["bytes_out"] > 0


def test_bench_emission_matches_jax(result):
    x = bench.make_batches(FRAMES, BLOCK)[0]
    cfg = bench.level8_config(BLOCK)
    jcfg = JFrameConfig.from_params(JP.set_defaults(8), channels=2, bps=16,
                                    block_size=BLOCK)
    assert TP.from_reference(jcfg) == cfg
    hb, hn = bench.frame_headers(FRAMES, BLOCK)
    # the JAX bench gives every frame 48 header bits; so do these frames
    np.testing.assert_array_equal(hn * 8, 48)

    @jax.jit
    def jax_emit(x, hbits, hb, hn):
        out = janalyze(x, jcfg, hbits)
        words, tb, _ = jbitpack.pack_frames_device(out, hb, hn, jcfg)
        check = jnp.sum(tb.astype(jnp.int64)) + jnp.sum(
            words[:, ::7, ::11].astype(jnp.int64))
        return check, jnp.sum(out["frame_bytes"])

    want, total = jax_emit(jnp.asarray(x), jnp.full((FRAMES,), 48, jnp.int32),
                           jnp.asarray(hb), jnp.asarray(hn))
    hdr = [torch.from_numpy(a) for a in (hn.astype(np.int32) * 8, hb, hn)]
    out = pipeline_step(cfg)(torch.from_numpy(x), *hdr)
    got = out["total_bits"].to(torch.int64).sum() \
        + out["words"][:, ::7, ::11].to(torch.int64).sum()
    assert int(got) == int(want)
    assert result["compressed_ratio"] == round(
        int(total) / (FRAMES * BLOCK * 4), 4)


def test_bench_matrix_row(capsys):
    rows = bench_matrix.run(device="cpu", only="level8_cd", frames=2)
    assert len(rows) == 1
    row = rows[0]
    jax_keys = _dict_keys(ROOT / "util" / "bench_matrix.py", "row")
    assert list(row) == jax_keys + ["peak_mib"]
    assert row["device_pack_parity"] is True
    assert row["peak_mib"] is None and row["device"] == "cpu"
    assert (row["block_size"], row["batch_frames"]) == (4096, 2)
    assert 0 < row["ratio_vs_raw"] < 1
    assert capsys.readouterr().out.count("\n") == 1
    tree = ast.parse((ROOT / "util" / "bench_matrix.py").read_text())
    configs = next(ast.literal_eval(n.value) for n in ast.walk(tree)
                   if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", None) == "CONFIGS")
    assert bench_matrix.CONFIGS == configs
    assert bench_matrix.batch_frames(8192, 2) == 256
    assert bench_matrix.batch_frames(4096, 6) == 170
