"""Reduce a ``torch.profiler`` trace of a stretch of batches to the records
the per-layer readers take: the card's busy seconds (the union of its
kernel, copy and fill intervals), its events, the device operations with
the most time, and the idle gaps by what the host was doing."""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

TOP = 10
# a name in the breakdown longer than this is shortened (:func:`short`)
NAME_CHARS = 120
_TAGS = re.compile(r"\w+_kernel_impl\b|\w+_kernel_cuda\b|\w*Functor\w*")
# the CPU events searched back for the innermost one that holds a gap
_LOOKBACK = 256


def union_us(spans: list) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def short(name: str) -> str:
    """A kernel's name for the breakdown: whole up to :data:`NAME_CHARS`;
    a longer one as its qualified name with a short template argument
    list (``final_pass_kernel<256>``), and for a templated ATen kernel
    the operators its arguments name (``where_kernel_impl``)."""
    if len(name) <= NAME_CHARS:
        return name
    bare = name.replace("(anonymous namespace)::", "")
    bare = bare[5:] if bare.startswith("void ") else bare
    base = re.match(r"[\w:]+(<[^<>()]{0,24}>)?", bare).group(0)
    tags = list(dict.fromkeys(_TAGS.findall(name)))
    return (f"{base} [{', '.join(tags)}]" if tags else base)[:NAME_CHARS]


def _gaps(spans: list) -> list:
    """The (start, end) idle intervals between the union's pieces."""
    gaps, end = [], None
    for s, e in sorted(spans):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


class HostIndex:
    """What the host was doing at a time: the innermost CPU event that
    holds it (the latest-starting one that has not ended)."""

    def __init__(self, cpu: list):
        self.cpu = sorted(cpu)                      # (start, end, name)
        self.starts = [c[0] for c in self.cpu]

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - _LOOKBACK, -1), -1):
            s, e, name = self.cpu[j]
            if e >= t:
                return name
        return "no host event"


def reduce_events(device: list, cpu: list) -> dict:
    """``device``: (start_us, end_us, name) of every kernel, copy and fill;
    ``cpu``: (start_us, end_us, name) of every host event. Returns busy
    seconds, the event count and the breakdown lists of [name, seconds],
    at most :data:`TOP` each, largest first."""
    spans = [(s, e) for s, e, _ in device]
    by_op = defaultdict(float)
    for s, e, name in device:
        by_op[short(name)] += (e - s) * 1e-6
    host = HostIndex(cpu)
    by_host = defaultdict(float)
    for s, e in _gaps(spans):
        by_host[short(host.at(s))] += (e - s) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": union_us(spans) * 1e-6, "device_events": len(device),
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}


def split_profile(events, spans=()) -> tuple[list, list]:
    """The device and host intervals of a profiler's ``events()``. The
    profiler also draws each ``record_function`` range (``spans``, the
    harness's own names) on the device's timeline, over its kernels and
    the gaps between them: those are no device work and are left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, cpu = [], []
    for ev in events:
        span = (ev.time_range.start, ev.time_range.end, ev.name)
        if ev.device_type != cuda:
            cpu.append(span)
        elif not (getattr(ev, "is_user_annotation", False)
                  or ev.name in spans):
            device.append(span)
    return device, cpu
