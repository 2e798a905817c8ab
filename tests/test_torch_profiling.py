"""The port's profiling module (``flake_tpu_torch.profiling``) against
``flake_tpu/profiling.py`` on the CPU: ``device_memory_stats`` is empty
without CUDA as JAX's is on the CPU, ``trace`` writes a Chrome trace that
holds the ``annotate`` ranges, also when its block raises.
"""

import json

import pytest
import torch

from flake_tpu import profiling as jprof

from flake_tpu_torch import profiling as tprof


def test_device_memory_stats_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    assert tprof.device_memory_stats() == []
    assert jprof.device_memory_stats() == []


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "t")) as prof:
        with tprof.annotate("sp order loop"):
            torch.ones(64).cumsum(0)
    files = list((tmp_path / "t").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "sp order loop" for e in events)
    assert any(e.key == "sp order loop" for e in prof.key_averages())
    with pytest.raises(KeyError):
        with tprof.trace(str(tmp_path / "t")):
            raise KeyError("the block failed")
    assert len(list((tmp_path / "t").glob("trace_*.json"))) == 2
