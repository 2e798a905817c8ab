"""The analysis stage tool (``flake_tpu_torch.util.prof_an5``) on the CPU
against ``util/prof_an5.py``'s keys.

At levels 5 (EST: no sweep) and 8 (LOG: the sweep, on K4's route) on a
small batch, the tool prints the JAX tool's keys for that level plus
``sweep_route``, and every time is finite.
"""

import ast
import json
import math
import pathlib

import pytest
import torch

from flake_tpu_torch.util import prof_an5

ROOT = pathlib.Path(__file__).resolve().parent.parent
SWEEP_KEYS = {"sweep_bits_ms", "sweep_kernel_ms"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tool's stages are many small torch calls; six test workers
    with a thread pool each slow them to minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_keys() -> list:
    """The keys of ``res`` in ``util/prof_an5.py``, read with ``ast``."""
    keys = []
    for node in ast.walk(ast.parse(
            (ROOT / "util" / "prof_an5.py").read_text())):
        if isinstance(node, ast.Assign):
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id == "res":
                keys += [k.value for k in node.value.keys]
            elif isinstance(target, ast.Subscript) \
                    and getattr(target.value, "id", None) == "res":
                keys.append(target.slice.value)
    return keys


@pytest.mark.parametrize("level,route", [(5, None), (8, "K4")])
def test_prof_an5_keys_and_times(level, route, capsys):
    res = prof_an5.run(level, device="cpu", frames=4, block=1024)
    assert json.loads(capsys.readouterr().out) == res
    want = set(_jax_keys()) | {"sweep_route"}
    if route is None:
        want -= SWEEP_KEYS
    assert set(res) == want
    assert res["sweep_route"] == route
    assert (res["level"], res["B"]) == (level, 1024)
    times = [v for k, v in res.items() if k.endswith("_ms")]
    assert len(times) == len(want) - 5
    assert all(math.isfinite(t) and t > 0 for t in times)
