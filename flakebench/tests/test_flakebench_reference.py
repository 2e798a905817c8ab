"""The plain reference against flake_tpu_torch on the CPU, at small
shapes of both configurations and every content class, and the control
(the port's float32 LPC path) failing the comparison."""

import contextlib
import json

import numpy as np
import pytest
import torch

from conftest import REPO
from flakebench import check, run
from flakebench.reference import flac_plain as R

CELLS = ("level8_cd.bulk", "level5_cd.bulk")


def _pool(cell, seed, frames, dev):
    c = run.load("cells", cell)
    cfg = run.load("configs", c["config"])
    mix = run.load("traffic", c["traffic"])
    return c, cfg, run.make_batches(mix, cfg, seed, dev, frames)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_the_port(cell, cpu):
    from flake_tpu_torch.graft_entry import pipeline_step

    _, cfg, batches = _pool(cell, 2 ** 31 + 5, 3, cpu)
    fn = pipeline_step(run.program_config(cfg))
    ref_cfg = R.Config.from_file(cfg)
    for batch in batches:
        got = fn(*batch)
        want = R.encode_batch(*batch, ref_cfg)
        for key in ("words", "total_bits", "frame_bytes"):
            assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("cell", CELLS)
def test_check_counts_no_difference_on_the_port(cell, cpu):
    _, cfg, batches = _pool(cell, 17, 3, cpu)
    step = run.pipeline(run.program_config(cfg), True)
    clock = run.Clock(cpu)
    ref_cfg = R.Config.from_file(cfg)
    for j, batch in enumerate(batches):
        out, _ = step(clock, batch, lambda name: contextlib.nullcontext())
        idx = check.pick(out["frame_bytes"], 2, 17, j)
        assert check.differing(check.gather(batch, out, idx), ref_cfg) == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, cpu):
    """The control, the port under ``lpc_dtype="float32"``, reads over the
    cell's limit (``flakebench.control``, at a test's size)."""
    from flakebench import control

    c = run.load("cells", cell)
    r = control.readings(cell, 23, "float32", cpu, frames=3)
    assert r["frames"] == 18
    assert r["differ_pct"] > c["limits"]["differ_pct"]
    sound = control.readings(cell, 23, "float64", cpu, frames=3)
    assert sound["frames_differ"] == 0


def test_pick_holds_the_largest_frame():
    fb = torch.tensor([5, 9, 3, 40, 7, 1, 2, 8])
    for seed in range(6):
        idx = check.pick(fb, 3, seed, 0)
        assert 3 in idx.tolist() and len(set(idx.tolist())) == 3
        assert torch.equal(idx, check.pick(fb, 3, seed, 0))


def test_header_bytes_match_the_port():
    from flake_tpu_torch import params as P
    from flake_tpu_torch.ops import bitpack

    nums = np.array([0, 1, 127, 128, 2047, 2048, 65535, 65536, 49151,
                     (1 << 31) - 1], dtype=np.int64)
    for name in ("level8_cd", "level5_cd"):
        cfg = json.loads((REPO / "flakebench/configs" / f"{name}.json")
                         .read_text())
        got = R.frame_header_bytes(nums, R.Config.from_file(cfg))
        want = bitpack.frame_header_bytes(
            nums, bs_code=P.blocksize_code(cfg["block_size"]),
            sr_code=P.samplerate_code(cfg["sample_rate"]), allow_vbs=0)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_reference_frames_decode_to_the_samples(cpu, monkeypatch):
    """Frames the reference emits, their CRCs patched in, decode with the
    port's decoder to the samples they were made from."""
    import types

    from flake_tpu_torch import crc, decoder

    monkeypatch.setattr(decoder, "USE_NATIVE", False)
    _, cfg, batches = _pool("level8_cd.bulk", 3, 2, cpu)
    rc = R.Config.from_file(cfg)
    si = types.SimpleNamespace(sample_rate=rc.sample_rate,
                               bits_per_sample=rc.bps)
    for samples, hdr_bits, hdr_bytes, hdr_nb in batches:
        out = R.encode_batch(samples, hdr_bits, hdr_bytes, hdr_nb, rc)
        for f in range(samples.shape[0]):
            nbytes, hn = int(out["frame_bytes"][f]), int(hdr_nb[f])
            raw = bytearray(out["words"][f].reshape(-1).numpy()
                            .astype(">i4").view(np.uint8)[:nbytes])
            raw[hn - 1] = crc.crc8(bytes(raw[:hn - 1]))
            raw[-2:] = crc.crc16(bytes(raw[:-2])).to_bytes(2, "big")
            got, end, _ = decoder.decode_frame(bytes(raw), 0, si)
            assert end == nbytes
            assert np.array_equal(got, samples[f].numpy())
