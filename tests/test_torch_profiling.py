"""The port's profiling module (``flake_tpu_torch.profiling``) against
``flake_tpu/profiling.py`` on the CPU: ``StageTimer.report`` writes JAX's
text for the same recorded seconds, ``device_memory_stats`` is empty
without CUDA as JAX's is on the CPU, ``trace`` writes a Chrome trace that
holds the ``annotate`` ranges, also when its block raises.
"""

import json

import pytest
import torch

from flake_tpu import profiling as jprof

from flake_tpu_torch import profiling as tprof

STAGES = {"analyze": (1.25, 3), "pack": (0.5, 1), "md5": (1e-7, 7),
          "a stage with a long name": (2.0, 2)}


def _timer(module):
    t = module.StageTimer()
    for name, (sec, calls) in STAGES.items():
        t.seconds[name] = sec
        t.calls[name] = calls
    return t


@pytest.mark.parametrize("samples,rate", [(None, 44100), (441000, 44100),
                                          (96000 * 7, 96000)])
def test_stage_timer_report_matches_jax(samples, rate):
    want = _timer(jprof).report(samples=samples, sample_rate=rate)
    assert _timer(tprof).report(samples=samples, sample_rate=rate) == want


def test_stage_timer_counts_each_stage():
    t = tprof.StageTimer()
    for _ in range(3):
        with t.stage("a"):
            pass
    with pytest.raises(ValueError):
        with t.stage("b"):
            raise ValueError
    assert t.calls == {"a": 3, "b": 1}
    assert all(v >= 0 for v in t.seconds.values())


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
