"""Found by name: a cell, a configuration, a traffic mix and a metric are
files of their own, and the harness runs a new cell and a new metric
dropped into a copy of the benchmark with no other edit."""

import json
import shutil

from conftest import REPO, run_python

NEW_METRIC = '''"""Batches in the window (a test's metric)."""

UNIT = "batches"
TRACE = 0


def read(rec):
    return rec["batches"]
'''


def test_new_cell_and_metric_by_name(tmp_path):
    bench = tmp_path / "flakebench"
    shutil.copytree(REPO / "flakebench", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((bench / "traffic" / "bulk.json").read_text())
    mix.update(frames_per_batch=3, in_flight=2, pool=["pluck", "noise"],
               check_frames_per_batch=2, profile_batches=2)
    (bench / "traffic" / "tiny.json").write_text(json.dumps(mix))
    (bench / "cells" / "level5_cd.tiny.json").write_text(json.dumps(
        {"config": "level5_cd", "traffic": "tiny", "chips": 1,
         "limits": {"differ_pct": 0.0}}))
    (bench / "metrics" / "batches_seen.py").write_text(NEW_METRIC)
    code = """
import json, time, torch
from flakebench import run
for traced in (False, True):
    out = run.measure("level5_cd.tiny", 9, 0.2, traced, torch.device("cpu"),
                      t_start=time.perf_counter())
    print(json.dumps({"root": str(run.ROOT), **out["result"]}))
"""
    proc = run_python(code, cwd=tmp_path, path=[tmp_path, REPO])
    assert proc.returncode == 0, proc.stderr[-3000:]
    plain, traced = (json.loads(line)
                     for line in proc.stdout.strip().splitlines()[-2:])
    assert plain["root"] == str(bench)
    for res in (plain, traced):
        assert res["correct"] and res["compared"]["differ_pct"] == {
            "value": 0.0, "limit": 0.0}
        assert list(res)[-1] == "compared"
    assert plain["metrics"]["batches_seen"] == {
        "value": plain["attempted"], "unit": "batches"}
    assert "batches_seen" not in traced["metrics"]
    assert {"analysis_ms", "emission_ms", "enqueue_ms"} <= set(
        traced["metrics"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}


def test_every_workload_resolves_by_name():
    from flakebench import run

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    names = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = run.load("cells", w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (
            w["config"], w["traffic"], w["chips"])
        assert cell["config"] in names
        run.load("traffic", w["traffic"])
    for c in bench["configs"]:
        assert run.load("configs", c["name"]) == json.loads(
            (REPO / c["file"]).read_text())
    readers = run.readers()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]
        assert readers[m["name"]].TRACE == (m in bench["per_layer"])


def test_configs_are_the_presets():
    """Each configuration file is Flake's preset of its level, at its own
    block size."""
    from flake_tpu_torch import params as P
    from flakebench import run

    for name in ("level8_cd", "level5_cd"):
        cfg = run.load("configs", name)
        p = P.set_defaults(cfg["level"])
        assert cfg["variable_block_size"] == p.variable_block_size == 0
        for key in ("min_prediction_order", "max_prediction_order",
                    "min_partition_order", "max_partition_order"):
            assert cfg[key] == getattr(p, key), (name, key)
        assert P.OrderMethod[cfg["order_method"]] == p.order_method
        assert P.StereoMethod[cfg["stereo_method"]] == p.stereo_method
        assert P.Prediction[cfg["prediction_type"]] == p.prediction_type
