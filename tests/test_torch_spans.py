"""The port's spans (``flake_tpu_torch.profiling.annotate``) on the CPU.

Off a profiler a span is a shared null context and enters no
``record_function``; under one it is a range on the calling thread.
``analyze_frames`` opens the documented stage spans once each, nested in
``flake.analysis``, for every order method's path; ``pack_frames_device``
opens ``flake.emission`` over its two stages; the Encoder's batch loop
opens its host spans around them. The benchmark's readers
(``flakebench/spans.py``) depend on these names.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flake_tpu_torch import params as P
from flake_tpu_torch import profiling
from flake_tpu_torch.encoder import Encoder
from flake_tpu_torch.ops import bitpack
from flake_tpu_torch.ops.frame import FrameConfig, analyze_frames

F, B = 4, 256
STAGES = {
    8: ("head", "lpc", "sweep", "select", "final", "finalize"),  # LOG
    5: ("head", "lpc", "select", "final", "finalize"),       # EST: no sweep
    1: ("head", "select", "final", "finalize"),              # FIXED: X
}


def _batch(level):
    cfg = FrameConfig.from_params(P.set_defaults(level), channels=2, bps=16,
                                  block_size=B)
    rng = np.random.default_rng(level)
    t = np.arange(F * B)
    tone = 9000 * np.sin(2 * np.pi * 440 * t / 44100)
    samples = np.stack([tone, 0.7 * tone], 1) \
        + rng.integers(-300, 300, (F * B, 2))
    return (cfg, torch.from_numpy(samples.astype(np.int32).reshape(F, B, 2)),
            torch.full((F,), 48, dtype=torch.int32))


def _spans(prof) -> dict:
    """The ``flake.`` ranges of a trace, by name."""
    out = {}
    for ev in prof.events():
        if ev.name.startswith("flake."):
            out.setdefault(ev.name, []).append(ev)
    return out


def test_annotate_off_a_profiler_enters_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) off a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = profiling.annotate("flake.analysis")
    assert profiling.annotate("flake.emission") is first
    with first:
        with profiling.annotate("flake.analysis.head"):
            torch.ones(4).sum()


def test_annotate_under_a_profiler_records_on_its_thread():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("flake.test"):
            torch.ones(4).sum()
    (span,) = _spans(prof)["flake.test"]
    children = [c for c in span.cpu_children if c.name == "aten::sum"]
    assert children and children[0].thread == span.thread


@pytest.mark.parametrize("level", sorted(STAGES))
def test_analysis_opens_each_stage_once(level):
    cfg, samples, hdr_bits = _batch(level)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        analyze_frames(samples, cfg, hdr_bits)
    spans = _spans(prof)
    want = {"flake.analysis"} | {f"flake.analysis.{s}"
                                 for s in STAGES[level]}
    assert set(spans) == want
    assert all(len(v) == 1 for v in spans.values())
    (root,) = spans["flake.analysis"]
    for name in want - {"flake.analysis"}:
        assert spans[name][0].cpu_parent is root, name


def test_emission_opens_slots_and_merge():
    cfg, samples, hdr_bits = _batch(5)
    hb, hn = bitpack.frame_header_bytes(
        np.arange(F), bs_code=P.blocksize_code(B),
        sr_code=P.samplerate_code(44100), allow_vbs=0)
    analysis = analyze_frames(samples, cfg, torch.from_numpy(hn * 8))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bitpack.pack_frames_device(analysis, torch.from_numpy(hb),
                                   torch.from_numpy(hn), cfg)
    spans = _spans(prof)
    assert set(spans) == {"flake.emission", "flake.emission.slots",
                          "flake.emission.merge"}
    (root,) = spans["flake.emission"]
    assert spans["flake.emission.slots"][0].cpu_parent is root
    assert spans["flake.emission.merge"][0].cpu_parent is root


def test_encoder_batches_open_their_host_spans():
    cfg = P.StreamConfig(channels=2, sample_rate=44100, bits_per_sample=16,
                         params=P.set_defaults(1))
    cfg.params.block_size = B
    _, samples, _ = _batch(1)
    pcm = samples.reshape(F * B, 2).numpy()
    enc = Encoder(cfg, device="cpu", batch_frames=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        enc.encode_stream(pcm)
    spans = _spans(prof)
    batches = enc.stats["batches"]
    for name in ("headers", "upload", "run", "wait", "compact", "fetch",
                 "crc_patch"):
        assert len(spans[f"flake.encoder.{name}"]) == batches, name
    runs = spans["flake.encoder.run"]
    for stage in ("flake.analysis", "flake.emission"):
        assert all(any(ev.cpu_parent is r for r in runs)
                   for ev in spans[stage]), stage
