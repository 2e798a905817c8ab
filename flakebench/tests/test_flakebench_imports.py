"""Import guards: nothing that a run of a cell loads is JAX or the JAX
package, top-level names compared whole (``flake_tpu_torch`` begins with
``flake_tpu``), and the yardstick loads nothing of the program."""

import json
import shutil
import sys

from conftest import REPO, run_python

FORBIDDEN = {"jax", "jaxlib", "flax", "flake_tpu"}

_LOADED = """
import json, sys, time, torch
from flakebench import run
out = run.measure({cell!r}, 2 ** 31 + 77, 0.2, {traced}, torch.device("cpu"),
                  frames=4, t_start=time.perf_counter())
assert out["result"]["correct"], out["result"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax():
    for cell in ("level8_cd.bulk", "level5_cd.bulk"):
        names = _top_level(run_python(_LOADED.format(cell=cell,
                                                     traced=False)))
        assert "flake_tpu_torch" in names and "torch" in names
        assert not names & FORBIDDEN, names & FORBIDDEN


def test_traced_run_loads_no_jax():
    names = _top_level(run_python(_LOADED.format(cell="level5_cd.bulk",
                                                 traced=True)))
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_yardstick_loads_nothing_of_the_program():
    """The reference, the traffic, the check and the roofline counts."""
    code = """
import json, sys, numpy as np, torch
from flakebench import check, roofline, trace
from flakebench.reference import flac_plain as R
from flakebench.traffic import generator
cfg = json.load(open("flakebench/configs/level8_cd.json"))
mix = json.load(open("flakebench/traffic/bulk.json"))
pool = generator.make_pool(mix, cfg, 5, torch.device("cpu"), 2)
rc = R.Config.from_file(cfg)
hb, hn = R.frame_header_bytes(np.arange(2), rc)
R.encode_batch(pool[0], torch.from_numpy(hn * 8), torch.from_numpy(hb),
               torch.from_numpy(hn), rc)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    names = _top_level(run_python(code))
    assert "torch" in names
    assert not names & (FORBIDDEN | {"flake_tpu_torch"}), names


def test_forbidden_names_compared_whole(monkeypatch):
    from flakebench import run

    monkeypatch.setitem(sys.modules, "flake_tpu_torch_extra", sys)
    assert "flake_tpu_torch_extra" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flake_tpu.ops", sys)
    assert "flake_tpu" in run.forbidden_modules()


def test_no_result_without_a_card():
    """This machine has no card: the command prints no result."""
    proc = run_python("import sys; from flakebench import run; "
                      "sys.exit(run.main(['--workload', 'level8_cd.bulk', "
                      "'--seed', '1', '--seconds', '1']))")
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails before it measures and prints no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "flakebench", tmp_path / "flakebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = """
import time, torch
from flakebench import run
try:
    run.measure("level8_cd.bulk", 1, 0.2, False, torch.device("cpu"),
                frames=2, t_start=time.perf_counter())
except ModuleNotFoundError as exc:
    print("refused:", exc.name)
"""
    proc = run_python(code, cwd=tmp_path, path=[tmp_path])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "refused: flake_tpu_torch"
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    assert bench["command"][1:] == ["-m", "flakebench.run"]
    proc = run_python("import sys; from flakebench import run; "
                      "sys.exit(run.main(['--workload', 'level8_cd.bulk', "
                      "'--seed', '1', '--seconds', '1']))",
                      cwd=tmp_path, path=[tmp_path])
    assert proc.returncode != 0 and not proc.stdout.strip()
