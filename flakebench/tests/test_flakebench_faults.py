"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run (set-up, the window, the check) on the CPU at a small batch, with a
fault planted in the step the window times. The cells run on one card,
so there is no exchange between chips to leave out."""

import time

import pytest
import torch

from flakebench import run

CELLS = ("level8_cd.bulk", "level5_cd.bulk")


def _run(cell, wrap=None, traced=False):
    return run.measure(cell, 2 ** 31 + 99, 1.0, traced, torch.device("cpu"),
                       frames=6, wrap_step=wrap,
                       t_start=time.perf_counter())["result"]


def stale(step):
    """The step returns its first outputs again: state left unchanged."""
    first = {}

    def broken(clock, batch, span):
        out, marks = step(clock, batch, span)
        return first.setdefault("out", out), marks
    return broken


def half_batch(step):
    """Only the first half of each batch is encoded; the rest is left out
    (its outputs zero)."""
    def broken(clock, batch, span):
        F = batch[0].shape[0]
        out, marks = step(clock, tuple(t[:F // 2] for t in batch), span)
        full = {}
        for key, v in out.items():
            z = torch.zeros((F,) + v.shape[1:], dtype=v.dtype)
            z[:F // 2] = v
            full[key] = z
        return full, marks
    return broken


def altered_word(step):
    """One bit of each frame's emitted words flipped where K3 writes
    them."""
    def broken(clock, batch, span):
        out, marks = step(clock, batch, span)
        words = out["words"].clone()
        words[:, 0, 9] ^= 1 << 7
        return {**out, "words": words}, marks
    return broken


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["attempted"] >= 6      # every batch of the pool is checked
    assert res["correct"] and res["failed"] == 0
    assert res["compared"]["differ_pct"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [stale, half_batch, altered_word])
def test_fault_is_not_correct(cell, fault):
    res = _run(cell, fault)
    assert not res["correct"]
    assert res["compared"]["differ_pct"]["value"] > \
        res["compared"]["differ_pct"]["limit"]


def test_fault_caught_in_a_traced_run():
    assert not _run("level8_cd.bulk", altered_word, traced=True)["correct"]


@pytest.mark.cuda
def test_cell_on_the_card():
    """A short run of each cell on the card at a small batch, its check
    included (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in CELLS:
        for traced in (False, True):
            res = run.measure(cell, 41, 0.5, traced, torch.device("cuda", 0),
                              frames=64, t_start=time.perf_counter())
            assert res["result"]["correct"], res["result"]
