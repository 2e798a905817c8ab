"""Small repairs of the port, each against the JAX package where it has one.

- ``Encoder._run_batches`` takes zero frames, as the JAX encoder's does.
- The Rice k scan and the stereo mode pick the first minimum on ties,
  by ``torch.min``'s stated rule, as ``jnp.argmin`` does (on the card:
  ``test_ties_on_the_card`` in ``tests/test_torch_kernels_cuda.py``).
- The Welch window, K1's input, is built once per (block size, device)
  and keeps :func:`welch_window`'s bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flake_tpu.ops import lpc as jlpc
from flake_tpu.ops import rice as jrice
from flake_tpu.ops import stereo as jstereo

import flake_tpu_torch
from flake_tpu_torch import params as TP
from flake_tpu_torch.ops import lpc as tlpc
from flake_tpu_torch.ops import rice as trice
from flake_tpu_torch.ops import stereo as tstereo


@pytest.mark.parametrize("level", [8, 12])
def test_run_batches_on_zero_frames(level):
    cfg = TP.StreamConfig(params=TP.set_defaults(level))
    enc = flake_tpu_torch.Encoder(cfg, device="cpu", batch_frames=4)
    bs = cfg.params.block_size
    blob, lengths = enc._run_batches(np.zeros((0, bs, 2), np.int32), bs,
                                     np.zeros(0, np.int64))
    assert blob == b""
    assert lengths.dtype == np.int64 and lengths.shape == (0,)
    assert enc.stats["frames"] == 0 and enc.stats["batches"] == 0


def _rice_sums():
    """Partition sums from 0 up, where neighbouring k often cost the same
    bits, and a few large ones."""
    return np.concatenate([np.arange(0, 3000), [1 << 20, (1 << 31) - 1,
                                                (1 << 33) + 5]])


@pytest.mark.parametrize("cnt", [1, 16, 255, 4096])
def test_rice_k_ties_take_the_first_minimum(cnt):
    sums = _rice_sums()
    want_k, want_bits = jrice.find_optimal_k(jnp.asarray(sums, jnp.uint64),
                                             cnt)
    got_k, got_bits = trice.find_optimal_k(torch.from_numpy(sums), cnt)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_bits.numpy(),
                                  np.asarray(want_bits).astype(np.int64))
    # the limb form, with an int count and with per-partition counts
    for c in (cnt, np.full(sums.shape, cnt, np.uint64)):
        jc = c if isinstance(c, int) else jnp.asarray(c)
        tc = c if isinstance(c, int) \
            else torch.from_numpy(c.astype(np.int64))
        want_k, want_bits = jrice.find_optimal_k_u32(
            jnp.asarray(sums, jnp.uint64), jc)
        got_k, got_bits = trice.find_optimal_k_u32(torch.from_numpy(sums),
                                                   tc)
        np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
        np.testing.assert_array_equal(got_bits.numpy(),
                                      np.asarray(want_bits).astype(np.int64))


def test_first_min_on_equal_counts():
    """Every row of equal counts and of two equal minima: the first."""
    rng = np.random.default_rng(0)
    nbits = rng.integers(10, 13, (200, 31)).astype(np.int64)
    nbits[0] = 7
    nbits[1, [3, 17]] = 2
    k, best = trice._first_min(torch.from_numpy(nbits))
    np.testing.assert_array_equal(k.numpy(),
                                  np.asarray(jnp.argmin(nbits, axis=-1)))
    np.testing.assert_array_equal(best.numpy(), nbits.min(-1))
    assert k[0] == 0 and k[1] == 3


def test_stereo_mode_ties_take_the_first_minimum():
    """Equal channels tie L+S with R+S (LEFT_SIDE wins); silence ties all
    four (LEFT_RIGHT wins); random frames as they fall."""
    rng = np.random.default_rng(4)
    F, B = 12, 256
    left = rng.integers(-3000, 3000, (F, B)).astype(np.int32)
    right = rng.integers(-3000, 3000, (F, B)).astype(np.int32)
    right[0] = left[0]
    left[1] = right[1] = 0
    left[2] = right[2] = 77
    right[3] = -left[3]
    want = np.asarray(jstereo.decorr_mode(jnp.asarray(left),
                                          jnp.asarray(right), B))
    got = tstereo.decorr_mode(torch.from_numpy(left), torch.from_numpy(right),
                              B)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == tstereo.LEFT_SIDE
    assert got[1] == got[2] == tstereo.LEFT_RIGHT


@pytest.mark.parametrize("n", [4096, 777, 20])
def test_welch_window_is_built_once(n):
    cpu = torch.device("cpu")
    first = tlpc.welch_window_on(n, cpu)
    assert tlpc.welch_window_on(n, cpu) is first
    assert first.dtype == torch.float64
    np.testing.assert_array_equal(first.numpy(), tlpc.welch_window(n))
    np.testing.assert_array_equal(first.numpy(), jlpc.welch_window(n))
