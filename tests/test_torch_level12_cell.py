"""Flake's level 12 at fixed 8,192-sample blocks as a benchmark cell
(``flakebench``'s ``level12_8192.bulk``), on the CPU at a test's size.

The configuration is the ``-12`` preset with VBS off and frames numbered
by frame, the two keys that ``BENCHMARK.json`` lists as reduced; its batch of 4,096 frames keeps the
emission's bit count below 2^31; the port's pipeline equals the plain
reference on every content class of the cell's pool; the comparison that
decides ``correct`` counts nothing on the port and more than the cell's
limit on its float32 control; ``sweep_ms`` reads the candidate sweep's
kernels from a traced run's breakdown. ``test_torch_level12_jax.py``
holds the pipeline against the JAX package at this configuration.
"""

import contextlib
import json
import pathlib

import numpy as np
import pytest
import torch

from flake_tpu_torch import params as P
from flake_tpu_torch.graft_entry import pipeline_step
from flake_tpu_torch.ops import bitpack
from flakebench import check, control, run
from flakebench.reference import flac_plain as R

REPO = pathlib.Path(__file__).resolve().parents[1]
CELL = "level12_8192.bulk"
CONFIG = "level12_8192"
FRAMES = 2                      # a class: the pool holds 12 frames


@pytest.fixture
def cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield torch.device("cpu")
    torch.set_num_threads(threads)


def _bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_configuration_is_the_preset_but_vbs():
    cfg = run.load("configs", CONFIG)
    p = P.set_defaults(cfg["level"])
    assert cfg["level"] == 12
    for key in ("block_size", "min_prediction_order", "max_prediction_order",
                "min_partition_order", "max_partition_order"):
        assert cfg[key] == getattr(p, key), key
    assert P.Prediction[cfg["prediction_type"]] == p.prediction_type
    assert P.OrderMethod[cfg["order_method"]] == p.order_method
    assert P.StereoMethod[cfg["stereo_method"]] == p.stereo_method
    assert cfg["precision"] == P.LPC_PRECISION
    assert cfg["lpc_dtype"] == "float64"
    assert (cfg["channels"], cfg["bits_per_sample"],
            cfg["sample_rate"]) == (2, 16, 44100)
    # the cuts: VBS on in the preset, off here; and, as ``-v 0`` leaves
    # allow_vbs set, frames numbered by sample there, by frame here
    assert p.variable_block_size == 1 and cfg["variable_block_size"] == 0
    assert p.allow_vbs == 1 and cfg["allow_vbs"] == 0
    hb, _ = R.frame_header_bytes(np.arange(3, dtype=np.int64),
                                 R.Config.from_file(cfg))
    assert (hb[:, 1] == 0xF8).all()     # fixed blocking
    entry, = [c for c in _bench()["configs"] if c["name"] == CONFIG]
    assert entry["reduced"] == ["variable_block_size", "allow_vbs"]
    assert entry["file"] == f"flakebench/configs/{CONFIG}.json"


def test_cell_resolves_by_name():
    cell = run.load("cells", CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "bulk_4096", 1)
    mix = run.load("traffic", cell["traffic"])
    bulk = run.load("traffic", "bulk")
    assert mix["frames_per_batch"] == 4096
    assert {k: v for k, v in mix.items() if k != "frames_per_batch"} == {
        k: v for k, v in bulk.items() if k != "frames_per_batch"}
    entry, = [w for w in _bench()["workloads"] if w["name"] == CELL]
    assert (entry["config"], entry["traffic"], entry["chips"]) == (
        CONFIG, "bulk_4096", 1)
    assert 0 < cell["limits"]["differ_pct"] < 100


def test_batch_keeps_the_bit_bound():
    cfg = run.load("configs", CONFIG)
    mix = run.load("traffic", run.load("cells", CELL)["traffic"])
    rows = bitpack.word_rows(run.program_config(cfg))
    assert rows == R.word_rows(R.Config.from_file(cfg)) == 67
    assert cfg["assumed"]["frames_per_batch"] == mix["frames_per_batch"]
    assert mix["frames_per_batch"] * rows * 512 * 8 < 2 ** 31
    # the bulk mix's 12,288 frames would not
    assert 12288 * rows * 512 * 8 >= 2 ** 31


def _pool(seed, dev):
    cfg = run.load("configs", CONFIG)
    mix = run.load("traffic", run.load("cells", CELL)["traffic"])
    return cfg, mix, run.make_batches(mix, cfg, seed, dev, FRAMES)


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 11])
def test_pipeline_equals_the_reference(seed, cpu):
    cfg, mix, batches = _pool(seed, cpu)
    assert len(batches) == len(mix["pool"]) == 6
    fn = pipeline_step(run.program_config(cfg))
    ref_cfg = R.Config.from_file(cfg)
    for cls, batch in zip(mix["pool"], batches):
        got = fn(*batch)
        want = R.encode_batch(*batch, ref_cfg)
        for key in ("words", "total_bits", "frame_bytes"):
            assert torch.equal(got[key], want[key]), (cls, key)


def test_check_counts_no_difference_on_the_port(cpu):
    cfg, _, batches = _pool(17, cpu)
    step = run.pipeline(run.program_config(cfg), True)
    clock = run.Clock(cpu)
    ref_cfg = R.Config.from_file(cfg)
    for j, batch in enumerate(batches):
        out, _ = step(clock, batch, lambda name: contextlib.nullcontext())
        idx = check.pick(out["frame_bytes"], FRAMES, 17, j)
        assert check.differing(check.gather(batch, out, idx), ref_cfg) == 0


def test_control_reads_over_the_limit(cpu):
    limit = run.load("cells", CELL)["limits"]["differ_pct"]
    bad = control.readings(CELL, 23, "float32", cpu, frames=FRAMES)
    assert bad["frames"] == 6 * FRAMES
    assert bad["differ_pct"] > limit
    sound = control.readings(CELL, 23, "float64", cpu, frames=FRAMES)
    assert sound["frames_differ"] == 0 and sound["differ_pct"] == 0.0


def test_sweep_ms_reads_the_sweep_kernels():
    mod = run.readers()["sweep_ms"]
    assert (mod.UNIT, mod.TRACE) == ("ms", 1)
    ops = [["void (anonymous namespace)::granule_kernel<true>(int const*)",
            0.4],
           ["rice_scan_kernel", 0.1],
           ["final_pass_kernel<256>", 0.3],
           ["slot_layout_kernel", 0.2]]
    rec = {"profile": {"batches": 100, "device_ops": ops}}
    assert mod.read(rec) == pytest.approx(5.0)       # (0.4 + 0.1) s / 100
    rec["profile"]["device_ops"] = [["sweep_kernel<12>", 0.05]] + ops[1:]
    assert mod.read(rec) == pytest.approx(1.5)       # K2 and R1
    # one of the pair out of the breakdown's ten: no reading, not a smaller one
    rec["profile"]["device_ops"] = ops[:1] + ops[2:]
    assert mod.read(rec) is None
    rec["profile"]["device_ops"] = ops[1:]
    assert mod.read(rec) is None
    # EST: no sweep kernel ran
    rec["profile"]["device_ops"] = ops[2:]
    assert mod.read(rec) is None
    assert mod.read({"batches": 10}) is None         # an untraced run
    entry, = [m for m in _bench()["per_layer"] if m["name"] == "sweep_ms"]
    assert (entry["unit"], entry["source"], entry["moves"]) == (
        "ms", "device_trace", "chip_xrt")
    assert entry["workloads"] == ["level8_cd.bulk", CELL]
