"""The card's time put down to the program's stage spans
(``flakebench/spans.py``), on synthetic traces: the innermost span wins,
ATen glue reaches its stage through its parents, a gap goes to the span
that launched the event ending it, what no span holds is unattributed,
and the readers divide by the stretch's batches."""

from types import SimpleNamespace

import pytest
import torch

from flakebench import spans

# host events by key: (start_us, end_us, name, parent key)
HOST = {
    0: (0, 100, "flake.analysis", None),
    1: (10, 30, "flake.analysis.head", 0),
    2: (40, 90, "flake.analysis.finalize", 0),
    3: (41, 60, "aten::where", 2),
    4: (42, 50, "aten::empty_strided", 3),
    5: (12, 14, "cudaLaunchKernel", None),      # a ctypes launch in head
    6: (92, 95, "cudaLaunchKernel", None),      # in flake.analysis alone
    7: (200, 210, "flakebench.wait", None),
    8: (202, 204, "cudaMemcpyAsync", 7),
}


def test_innermost_span_wins():
    out = spans.attribute([(100, 110, 5), (130, 140, 6)], HOST)
    assert out["flake.analysis.head"]["events"] == 1
    assert out["flake.analysis"]["events"] == 1
    assert out["flake.analysis.head"]["busy_s"] == pytest.approx(10e-6)


def test_aten_glue_reaches_its_stage_through_its_parents():
    # the op's start lies in no span's time that the chain would miss:
    # its parents, not the clock, decide
    host = dict(HOST)
    host[4] = (5, 6, "aten::empty_strided", 3)
    out = spans.attribute([(120, 125, 3), (125, 128, 4)], host)
    assert out == {"flake.analysis.finalize": {
        "busy_s": pytest.approx(8e-6), "idle_s": 0.0, "events": 2}}


def test_gap_goes_to_the_launch_that_ends_it():
    device = [(100, 110, 5), (115, 120, 3), (120, 130, 6), (140, 141, 5)]
    out = spans.attribute(device, HOST)
    assert out["flake.analysis.finalize"]["idle_s"] == pytest.approx(5e-6)
    assert out["flake.analysis.head"]["idle_s"] == pytest.approx(10e-6)
    assert out["flake.analysis"]["idle_s"] == 0.0
    # self time: the head's two events, nothing of the others
    assert out["flake.analysis.head"]["busy_s"] == pytest.approx(11e-6)


def test_outside_every_span_is_unattributed():
    out = spans.attribute([(300, 310, 8), (320, 330, None)], HOST)
    assert out == {spans.UNATTRIBUTED: {
        "busy_s": pytest.approx(20e-6), "idle_s": pytest.approx(10e-6),
        "events": 2}}


def test_readers_divide_by_the_batches():
    rec = {"profile": {"batches": 4, "spans": {
        "flake.analysis": {"busy_s": 0.001, "idle_s": 0.002, "events": 8},
        "flake.analysis.final": {"busy_s": 0.004, "idle_s": 0.0,
                                 "events": 4},
        "flake.analysis.finalize": {"busy_s": 0.008, "idle_s": 0.004,
                                    "events": 40}}}}
    assert spans.per_batch_ms(rec, "flake.analysis.final",
                              "busy_s") == pytest.approx(1.0)
    assert spans.per_batch_ms(rec, "flake.analysis",
                              "idle_s") == pytest.approx(1.5)
    assert spans.per_batch_ms(rec, "flake.analysis.sweep", "busy_s") is None
    assert spans.per_batch_ms(rec, "flake.emission", "idle_s") is None
    assert spans.per_batch_ms({"profile": {"batches": 4}}, "flake.analysis",
                              "idle_s") is None


def _ev(name, start, end, device=False, id=0, linked=0, parent=None,
        annotation=False):
    d = torch.autograd.DeviceType
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end), id=id,
        device_type=d.CUDA if device else d.CPU, linked_correlation_id=linked,
        cpu_parent=parent, is_user_annotation=annotation)


def test_from_events_follows_the_links():
    stage = _ev("flake.emission.slots", 0, 50, id=1)
    op = _ev("aten::fill_", 2, 4, id=2, parent=stage)
    launch = _ev("cudaLaunchKernel", 5, 6, id=2, linked=0)  # id of CUPTI's
    events = [stage, op, launch,
              _ev("fill", 60, 61, device=True, id=77, linked=2),
              _ev("slot_layout_kernel", 62, 70, device=True, id=2),
              _ev("flake.emission.slots", 0, 70, device=True,
                  annotation=True)]
    device, host = spans.from_events(events)
    assert [(s, e) for s, e, _ in device] == [(60, 61), (62, 70)]
    assert [host[k][2] for _, _, k in device] == ["aten::fill_",
                                                  "cudaLaunchKernel"]
    assert host[1][3] == 0
    out = spans.attribute(device, host)
    assert out["flake.emission.slots"]["events"] == 2
