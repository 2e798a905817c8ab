"""Put the card's time in a ``torch.profiler`` trace down to the program's
stage spans: the ranges that ``flake_tpu_torch.profiling.annotate`` opens
while the profiler records, whose names start with ``flake.``.

A device event (a kernel, copy or fill) belongs to the innermost
``flake.`` span around the host call that launched it. That call is the
CPU op that the event's ``linked_correlation_id`` names, followed up its
``cpu_parent`` chain to the first span (ATen glue: ``aten::where``, then
its parents). A launch made outside any op (the port's own kernels, which
go through ctypes) links to no op, and a torch whose events carry no
``linked_correlation_id`` links none: the launch's runtime call
(``cudaLaunchKernel``, the CPU event with the device event's correlation
id) is then placed in the innermost span that holds its start on the
host's clock, which the trace shares with the card's. One thread
launches, so that place is exact.

For each span: its events, its busy seconds (the union of its own events'
intervals: self time, its inner spans' events are theirs) and its idle
seconds (each gap between the pieces of the card's busy union goes to the
span that launched the event ending the gap: the launch the card waited
for). What no span holds is :data:`UNATTRIBUTED`.
"""

from __future__ import annotations

import re
from collections import defaultdict

from flakebench.trace import HostIndex, union_us

PREFIX = "flake."
UNATTRIBUTED = "unattributed"
# a CUDA API call on the host (cudaLaunchKernel, cuLaunchKernel)
_RUNTIME = re.compile(r"cu(da)?[A-Z]")


def from_events(events) -> tuple[list, dict]:
    """A profiler's ``events()`` as :func:`attribute` takes them:
    ``device``, (start_us, end_us, launcher) of every kernel, copy and
    fill, the launcher a key of ``host`` or None; ``host``, by key,
    (start_us, end_us, name, parent key or None) of every host event. The
    ranges the profiler also draws on the device's timeline are no device
    work and are left out, as ``trace.split_profile`` leaves them out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    keys = {id(ev): k for k, ev in enumerate(events)}
    host, ops, runtime, dev = {}, {}, {}, []
    for k, ev in enumerate(events):
        if ev.device_type == cuda:
            if not (getattr(ev, "is_user_annotation", False)
                    or ev.name.startswith(PREFIX)
                    or ev.name.startswith("flakebench.")):
                dev.append(ev)
            continue
        parent = getattr(ev, "cpu_parent", None)
        host[k] = (ev.time_range.start, ev.time_range.end, ev.name,
                   keys.get(id(parent)) if parent is not None else None)
        (runtime if _RUNTIME.match(ev.name) else ops).setdefault(ev.id, k)
    device = []
    for ev in dev:
        linked = getattr(ev, "linked_correlation_id", 0)
        launcher = ops.get(linked) if linked else None
        if launcher is None:
            launcher = runtime.get(ev.id)
        device.append((ev.time_range.start, ev.time_range.end, launcher))
    return device, host


def attribute(device: list, host: dict) -> dict:
    """``device`` and ``host`` as :func:`from_events` gives them. Returns,
    by span name (and :data:`UNATTRIBUTED`), ``busy_s``, ``idle_s`` and
    ``events``."""
    # the innermost span that holds a host time (spans nest on the thread)
    index = HostIndex([(s, e, name) for s, e, name, _ in host.values()
                       if name.startswith(PREFIX)])
    owner_of = {}

    def owner(key) -> str:
        if key is None:
            return UNATTRIBUTED
        if key not in owner_of:
            k = key
            while k is not None and not host[k][2].startswith(PREFIX):
                k = host[k][3]
            if k is not None:
                owner_of[key] = host[k][2]
            else:
                name = index.at(host[key][0])
                owner_of[key] = name if name.startswith(PREFIX) \
                    else UNATTRIBUTED
        return owner_of[key]

    owners = [owner(launcher) for _, _, launcher in device]
    intervals = defaultdict(list)
    for (s, e, _), name in zip(device, owners):
        intervals[name].append((s, e))
    out = {name: {"busy_s": union_us(iv) * 1e-6, "idle_s": 0.0,
                  "events": len(iv)} for name, iv in intervals.items()}
    end = None
    for (s, e, _), name in sorted(zip(device, owners),
                                  key=lambda d: (d[0][0], d[0][1])):
        if end is not None and s > end:
            out[name]["idle_s"] += (s - end) * 1e-6
        end = e if end is None else max(end, e)
    return out


def per_batch_ms(rec: dict, name: str, key: str) -> float | None:
    """``key`` (``busy_s`` or ``idle_s``) of the profiled stretch's span
    ``name`` and the spans inside it (those whose names continue it after
    a dot), in ms a batch; None where the stretch has no such span (a
    program without it, or an order method that never opens it)."""
    p = rec.get("profile") or {}
    spans = p.get("spans") or {}
    inside = [v[key] for k, v in spans.items()
              if k == name or k.startswith(name + ".")]
    if not inside or not p.get("batches"):
        return None
    return 1e3 * sum(inside) / p["batches"]
