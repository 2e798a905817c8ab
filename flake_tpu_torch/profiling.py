"""Tracing and observability (port of ``flake_tpu/profiling.py``).

- :func:`trace`: a context manager around ``torch.profiler`` that writes a
  Chrome trace of the host and the device into a directory;
- :func:`annotate`: the program's one span call, a named range
  (``torch.profiler.record_function``) while a profiler records on the
  calling thread, else a shared null context;
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


# whether a profiler records on the calling thread; the span off it
_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A named range in a ``torch.profiler`` trace: ``with annotate(
    "flake.analysis.head"): ...``. Ranges nest, and share the trace's
    clock with the device events of the launches made inside them.

    Where no profiler records on the calling thread (its state is
    thread-local: a thread started under a profiler is not recorded) it
    enters no ``record_function`` and returns a shared null context, so a
    span costs under a microsecond of host time on the hot path."""
    return torch.profiler.record_function(name) if _recording() else _OFF


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
