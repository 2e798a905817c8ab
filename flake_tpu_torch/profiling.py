"""Tracing and observability (port of ``flake_tpu/profiling.py``).

- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace of the host and the device into a directory;
- :func:`annotate`: a named range (``torch.profiler.record_function``),
  which shows as a span of its own in the trace;
- :class:`StageTimer`: host wall-clock counters per stage with a
  samples/sec report (the Encoder's ``stats`` dict is the always-on subset
  of this);
- :func:`device_memory_stats`: the live device memory of each CUDA device;
- :func:`card_name`: the card's name and power limit, which every
  measurement states beside its numbers.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the host and, where CUDA is present, the device while the
    block runs, and write a Chrome trace (``chrome://tracing``, Perfetto)
    into ``logdir`` as ``trace_<pid>_<ms>.json``, also when the block
    raises. Yields the ``torch.profiler.profile`` object, whose
    ``key_averages()`` sum the ops by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in torch.profiler.supported_activities()
                  and (a is ProfilerActivity.CPU
                       or torch.cuda.is_available())]
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{int(time.time() * 1000)}.json"))


def annotate(name: str):
    """Named range for trace legibility: ``with annotate("sp order loop"):
    ...`` (nests; a span of its own in the trace, costs a few
    microseconds of host time when no profiler runs)."""
    return torch.profiler.record_function(name)


class StageTimer:
    """Wall-clock accumulation per pipeline stage.

    >>> t = StageTimer()
    >>> with t.stage("analyze"):
    ...     ...
    >>> t.report(samples=n)
    """

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] = self.seconds.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1

    def report(self, samples: int | None = None,
               sample_rate: int = 44100) -> str:
        lines = []
        total = sum(self.seconds.values())
        for name, sec in sorted(self.seconds.items(),
                                key=lambda kv: -kv[1]):
            line = (f"{name:24s} {sec:9.4f}s  x{self.calls[name]:<6d}"
                    f" {sec / total * 100:5.1f}%")
            if samples:
                line += f"  {samples / max(sec, 1e-12):,.0f} smp/s"
            lines.append(line)
        if samples:
            xrt = (samples / sample_rate) / max(total, 1e-12)
            lines.append(f"{'TOTAL':24s} {total:9.4f}s"
                         f"  {xrt:,.1f}x realtime")
        return "\n".join(lines)


def device_memory_stats() -> list[dict]:
    """Live memory of each CUDA device this process has used, with the
    JAX package's keys (``bytes_limit`` is the card's whole memory, as no
    per-process cap is set). Empty without CUDA, as JAX's is on the
    CPU."""
    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if stats:
            out.append({
                "device": str(torch.device("cuda", i)),
                "bytes_in_use": stats.get("allocated_bytes.all.current"),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
                "bytes_limit": torch.cuda.get_device_properties(i)
                .total_memory,
            })
    return out


def card_name(device) -> str:
    """``"cpu"`` for the CPU; else the first card's name and power limit
    as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (the power limit sets how fast a card runs under load)."""
    if torch.device(device).type == "cpu":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
