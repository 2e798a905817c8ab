"""``merge_v2``'s carry rows in the closed form its kernel computes, and the
contract the kernel relies on, on the CPU without JAX.

The kernel builds the carry rows with a warp prefix minimum
(:func:`flake_tpu_torch.util.prof_merge2.v2_carry_rows_prefix_min` states
the same on the host); that equals the TPU's recurrence
(:func:`~flake_tpu_torch.util.prof_merge2.v2_carry_rows`) only where a
frame's chunk bounds do not decrease, which
:func:`flake_tpu_torch.ops.bitpack.aligned_parts` guarantees. Its chunk table
keeps a slot where ``0 <= w0 - cw < lim``; that equals the plain version's
three window rules. The wrappers keep refusing an ``fb`` that does not
divide the frames, though the kernels' launches no longer depend on it.
"""

import numpy as np
import pytest
import torch

from flake_tpu_torch.ops import bitpack
from flake_tpu_torch.util import prof_merge, prof_merge2, prof_merge3

from test_torch_kernels_cuda import _random_slots


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """As in ``tests/test_torch_prof_merge2.py``: the tool batches are many
    small torch calls, which six test workers' thread pools slow to
    minutes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nondecreasing_table(seed, F=4, nc=70):
    """Chunk bounds that do not decrease: many chunks inside a row, jumps of
    one to nine rows, a first chunk past row 2 in every other frame."""
    rng = np.random.default_rng(seed)
    steps = np.where(rng.random((F, nc + 1)) < 0.15,
                     rng.integers(3 * 4096, 9 * 4096, (F, nc + 1)),
                     rng.integers(0, 700, (F, nc + 1)))
    steps[::2, 0] = rng.integers(3 * 4096, 40 * 4096, (F + 1) // 2)
    return torch.from_numpy(np.cumsum(steps, axis=1).astype(np.int32))


@pytest.mark.parametrize("seed", range(6))
def test_prefix_min_equals_the_carry_recurrence(seed):
    cb = _nondecreasing_table(seed)
    rows = cb[:, :-1].to(torch.int64) >> 12
    assert bool((rows[::2, 0] > 2).all())
    assert int((rows[:, 1:] - rows[:, :-1]).max()) >= 3
    want = prof_merge2.v2_carry_rows(cb)
    assert bool((want < rows).any())   # chunks the carry does not reach
    assert torch.equal(prof_merge2.v2_carry_rows_prefix_min(cb), want)


def test_prefix_min_on_a_hand_made_table():
    """The table of ``test_v2_carry_rows_against_a_loop``, and the same
    with a first chunk at row 5."""
    base = [0, 100, 5 * 4096 + 7, 6 * 4096, 6 * 4096 + 1, 30 * 4096,
            30 * 4096 + 5, 31 * 4096]
    cb = torch.tensor([base, [5 * 4096 + b for b in base]],
                      dtype=torch.int32)
    got = prof_merge2.v2_carry_rows_prefix_min(cb)
    assert torch.equal(got, prof_merge2.v2_carry_rows(cb))
    assert got.tolist() == [[0, 0, 2, 4, 6, 8, 10], [2, 4, 6, 8, 10, 12, 14]]


def test_prefix_min_needs_rows_that_do_not_decrease():
    """Where a chunk's row falls below the carry the recurrence holds the
    carry and the closed form does not: the kernel's stated
    precondition."""
    cb = torch.tensor([[4 * 4096, 8 * 4096, 4096, 9 * 4096]],
                      dtype=torch.int32)
    assert prof_merge2.v2_carry_rows(cb).tolist() == [[2, 4, 4]]
    assert prof_merge2.v2_carry_rows_prefix_min(cb).tolist() == [[2, 4, 1]]


@pytest.mark.parametrize("kind", ["music", "noise", "random"])
def test_aligned_parts_chunk_bits_do_not_decrease(kind):
    """On the tools' batches (16 frames at full width) and on the random
    tables of ``tests/test_torch_prof_merge2.py``."""
    if kind == "random":
        slots, _ = _random_slots(4, 1000, 11)
    else:
        slots, _ = prof_merge.batch_slots(kind, 16, torch.device("cpu"))
    cb = bitpack.aligned_parts(*slots)[3]
    assert int(cb[:, 0].min()) >= 0
    assert bool((cb[:, 1:] >= cb[:, :-1]).all())
    assert torch.equal(prof_merge2.v2_carry_rows_prefix_min(cb),
                       prof_merge2.v2_carry_rows(cb))


@pytest.mark.parametrize("seed", range(3))
def test_window_limit_equals_the_window_rules(seed):
    """The kernel's chunk table keeps a slot where ``0 <= rel < lim``, with
    ``lim = 64 (1 + min(3, max(0, ext >> 6)))``: the plain version's rules
    (``rel >= 0``, ``p < 4``, and ``ext >= 64 p`` for ``p > 0``)."""
    rng = np.random.default_rng(seed)
    rel = torch.from_numpy(rng.integers(-100, 400, (5000, 1)))
    ext = torch.from_numpy(rng.integers(-1, 400, (1, 64)))
    p = rel >> 6
    want = (rel >= 0) & (p < prof_merge2.PASSES) & (
        (p == 0) | (ext >= p * prof_merge2.PASS_WORDS))
    lim = 64 * (1 + torch.clamp(ext >> 6, 0, 3))
    assert torch.equal((rel >= 0) & (rel < lim), want)
    assert bool(want.any()) and not bool(want.all())


@pytest.mark.parametrize("name", ["merge_v2", "merge_v3", "merge_zero_fb",
                                  "merge_zero_rows"])
def test_wrappers_refuse_an_fb_that_does_not_divide_the_frames(name):
    slots, wr = _random_slots(6, 300, 3)
    if name in ("merge_v2", "merge_v3"):
        fn = getattr(prof_merge2, name)
        operands = bitpack.aligned_parts(*slots)
    else:
        fn = getattr(prof_merge3, name)
        make = prof_merge3.v5c_parts if name == "merge_zero_fb" \
            else prof_merge3.v5d_parts
        *operands, _ = make(*slots)
    for fb in (4, 0, -2):
        with pytest.raises(ValueError, match="multiple"):
            fn(*operands, wr, fb)
    assert fn(*operands, wr, 3).shape == (6, wr, 128)
