"""K2's plain version and the per-order Rice bit counts against JAX.

The port's int64 partition sums must equal the Pallas v3 sweep's 16-bit
limb sums recombined (interpret mode), and the per-order subframe bits
built from them must equal the JAX package's per-order XLA chain
(residual_lpc + subframe_bits), including order 32 and 24-bit content
that the TPU kernel does not take.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flake_tpu.ops import lpc as jlpc
from flake_tpu.ops import predict as jpredict
from flake_tpu.ops import rice as jrice
from flake_tpu.ops.pallas_sweep3 import sweep_partition_limbs3

from flake_tpu_torch.ops import rice as trice
from flake_tpu_torch.ops import sweep as tsweep


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_coefs(x, B, max_order):
    autoc = jlpc.autocorr(x, max_order, jnp.asarray(jlpc.welch_window(B)),
                          jnp.float64)
    rows, _ = jlpc.levinson_all_orders(autoc)
    return jlpc.quantize_lpc_coefs(rows, 15)


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _jax_bits_all(x, qc, sh, obits, B, max_order, narrow):
    """The JAX package's per-order chain (frame.py:451-458), one graph."""
    return jnp.stack([jrice.subframe_bits(
        jpredict.residual_lpc(x, qc[:, o - 1], sh[:, o - 1], o,
                              narrow=narrow), B, o, obits, 0, 6, 15, True)
        for o in range(1, max_order + 1)], axis=-1)


def _inputs(N, B, max_order, bps, seed):
    """Streams plus the JAX package's quantized coefficients for them."""
    rng = np.random.default_rng(seed)
    amp = 1 << (bps - 2)
    t = np.arange(B)
    x = (amp * np.sin(2 * np.pi * rng.uniform(50, 900, (N, 1)) * t / 44100)
         + rng.normal(0, amp / 50, (N, B)))
    x[0] = rng.integers(-2 * amp, 2 * amp, B)        # noise
    x = x.astype(np.int32)
    qc, sh = _jax_coefs(jnp.asarray(x), B, max_order)
    return x, np.array(qc), np.array(sh)


def test_plain_sums_match_pallas_limbs():
    B, max_order, pmax_static = 1024, 12, 6
    x, qc, sh = _inputs(8, B, max_order, 16, seed=3)
    lo, hi = sweep_partition_limbs3(
        jnp.asarray(x), jnp.asarray(qc), jnp.asarray(sh),
        max_order=max_order, pmax_static=pmax_static, interpret=True)
    want = np.asarray(lo).astype(np.int64) \
        + (np.asarray(hi).astype(np.int64) << 16)
    got = tsweep.sweep_sums(torch.from_numpy(x), torch.from_numpy(qc),
                            torch.from_numpy(sh), max_order, pmax_static)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,max_order,bps", [(777, 32, 16), (1024, 12, 24)])
def test_bits_all_matches_xla_chain(B, max_order, bps):
    N, pmin, pmax, prec = 6, 0, 6, 15
    x, qc, sh = _inputs(N, B, max_order, bps, seed=B)
    obits = np.full(N, bps + 1, np.int32)      # a side channel's width
    pmax_static = jrice.limit_max_partition_order(pmax, B, 1)

    want = np.asarray(_jax_bits_all(
        jnp.asarray(x), jnp.asarray(qc), jnp.asarray(sh), jnp.asarray(obits),
        B, max_order, bps <= 16))

    sums = tsweep.sweep_sums(torch.from_numpy(x), torch.from_numpy(qc),
                             torch.from_numpy(sh), max_order, pmax_static)
    orders = torch.arange(1, max_order + 1, dtype=torch.int32)
    got = trice.subframe_bits_from_sums(
        sums, B, orders.expand(N, max_order),
        torch.from_numpy(obits)[:, None], pmin, pmax, prec, True)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
