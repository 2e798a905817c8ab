"""``merge_v3``'s chunk table in the form its kernel computes, against the
TPU body's rule, on the CPU without JAX.

The kernel keeps each chunk's ``row0`` and ``span`` and adds a word of row
``r`` where ``0 <= r - row0 <= span``
(:func:`flake_tpu_torch.util.prof_merge2.v3_chunk_rows` states the same on
the host). ``_frame_body_s2w`` (``util/prof_merge2.py:295``) adds row0
always and row0 + dr, dr = 1..3, where ``last_row >= row0 + dr``, in int32.
The two must agree on any chunk bounds: increasing, decreasing, negative,
and the int32 extremes, where ``cb[c + 1] - 1`` wraps. So must the rows
that ``merge_v3_plain`` and the U1 plain versions take from
:func:`flake_tpu_torch.util.prof_merge.chunk_rows`.
"""

import numpy as np
import pytest
import torch

from flake_tpu_torch.util import prof_merge, prof_merge2

INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def tpu_rule(chunk_bits: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """The TPU body's rule for a word of row ``rows[f, j, c]`` of chunk
    ``c``, in int32 as the TPU computes it: bool [F, J, nc]."""
    cb = chunk_bits.astype(np.int32)
    with np.errstate(over="ignore"):
        row0 = (cb[:, :-1] >> np.int32(12))[:, None, :]
        last = cb[:, 1:] - np.int32(1)
        last_row = (((last >> np.int32(5)) + np.int32(1))
                    >> np.int32(7))[:, None, :]
    keep = rows == row0
    for dr in range(1, 4):
        keep |= (rows == row0 + dr) & (last_row >= row0 + dr)
    return keep


def mirror_rule(chunk_bits: np.ndarray, rows: np.ndarray) -> np.ndarray:
    row0, span = (t.numpy()[:, None, :] for t in prof_merge2.v3_chunk_rows(
        torch.from_numpy(chunk_bits.astype(np.int32))))
    rel = rows.astype(np.int64) - row0
    return (rel >= 0) & (rel <= span)


def _rows_near(chunk_bits, rng, J=64):
    """Rows of words around each chunk's row0: from row0 - 2 to row0 + 6."""
    row0 = (chunk_bits[:, :-1].astype(np.int32) >> 12)[:, None, :]
    return row0.astype(np.int64) + rng.integers(
        -2, 7, (chunk_bits.shape[0], J, chunk_bits.shape[1] - 1))


@pytest.mark.parametrize("seed", range(6))
def test_table_equals_the_tpu_rule_on_any_bounds(seed):
    """Random bounds over the whole int32 range and near zero, in no
    order, the extremes among them."""
    rng = np.random.default_rng(seed)
    F, nc = 6, 40
    wide = rng.integers(INT32_MIN, INT32_MAX, (F, nc + 1), endpoint=True)
    near = rng.integers(-40 * 4096, 40 * 4096, (F, nc + 1))
    cb = np.where(rng.random((F, nc + 1)) < 0.5, wide, near)
    cb[0, :4] = [INT32_MIN, INT32_MAX, INT32_MIN, 0]
    cb[1] = np.sort(cb[1])[::-1]
    rows = _rows_near(cb, rng)
    want = tpu_rule(cb, rows)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(mirror_rule(cb, rows), want)


def test_table_on_a_hand_made_table():
    """Each span by hand: chunks reaching three, one, no and two rows on,
    one whose end lies before its start, one that ends below zero, and
    bounds at the int32 extremes (an end of INT32_MIN wraps to the largest
    row)."""
    cb = torch.tensor([[0, 4 * 4096, 5 * 4096 + 100, 5 * 4096 + 200,
                        7 * 4096, 6 * 4096, -3 * 4096, INT32_MIN,
                        INT32_MAX]], dtype=torch.int32)
    row0, span = prof_merge2.v3_chunk_rows(cb)
    assert row0.tolist() == [[0, 4, 5, 5, 7, 6, -3, -524288]]
    assert span.tolist() == [[3, 1, 0, 2, 0, 0, 3, 3]]
    rows = np.arange(-600000, 600000, 997)[None, :, None].repeat(8, -1)
    rows = np.concatenate([rows, _rows_near(cb.numpy(),
                                            np.random.default_rng(0))], 1)
    np.testing.assert_array_equal(mirror_rule(cb.numpy(), rows),
                                  tpu_rule(cb.numpy(), rows))


@pytest.mark.parametrize("seed", range(3))
def test_table_equals_the_plain_versions_rule(seed):
    """The table keeps what ``merge_v3_plain`` keeps (its rows from
    ``chunk_rows``), also where a chunk ends at INT32_MIN: every seed has
    one, after a chunk whose rows hold words."""
    rng = np.random.default_rng(100 + seed)
    cb = rng.integers(-40 * 4096, 40 * 4096, (6, 41))
    cb[seed, 7:9] = [3 * 4096 + 5, INT32_MIN]
    rows = _rows_near(cb, rng)
    row0, last_row = (r.numpy()[:, None, :] for r in prof_merge.chunk_rows(
        torch.from_numpy(cb.astype(np.int32))))
    assert last_row[seed, 0, 7] == 1 << 19
    plain = (rows >= row0) & (rows < row0 + 4) & (rows <= last_row)
    np.testing.assert_array_equal(mirror_rule(cb, rows), plain)


def tpu_rows(chunk_bits: np.ndarray):
    """``row0`` and ``last_row`` as ``k_fixedrow`` and ``k_nowin`` compute
    them (``util/prof_merge.py:190-192,216-218``), in int32."""
    cb = chunk_bits.astype(np.int32)
    with np.errstate(over="ignore"):
        row0 = cb[:, :-1] >> np.int32(12)
        last = cb[:, 1:] - np.int32(1)
        last_row = ((last >> np.int32(5)) + np.int32(1)) >> np.int32(7)
    return row0, np.maximum(last_row, row0)


@pytest.mark.parametrize("seed", range(4))
def test_chunk_rows_equal_the_tpu_rows_on_any_bounds(seed):
    """``chunk_rows`` gives the TPU bodies' ``row0`` and ``last_row`` on
    bounds over the whole int32 range and near zero, in no order, with
    INT32_MIN (where ``cb[c + 1] - 1`` wraps to the largest row) and
    INT32_MAX among them."""
    rng = np.random.default_rng(200 + seed)
    F, nc = 5, 40
    wide = rng.integers(INT32_MIN, INT32_MAX, (F, nc + 1), endpoint=True)
    near = rng.integers(-40 * 4096, 40 * 4096, (F, nc + 1))
    cb = np.where(rng.random((F, nc + 1)) < 0.5, wide, near)
    cb[seed, 1:6] = [INT32_MIN, INT32_MAX, INT32_MIN, 0, INT32_MIN]
    cb[F - 1] = np.sort(cb[F - 1])[::-1]
    row0, last_row = (r.numpy() for r in prof_merge.chunk_rows(
        torch.from_numpy(cb.astype(np.int32))))
    want0, want_last = tpu_rows(cb)
    np.testing.assert_array_equal(row0, want0)
    np.testing.assert_array_equal(last_row, want_last)
    assert (last_row[seed, [0, 2, 4]] == 1 << 19).all()
