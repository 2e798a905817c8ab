"""K1's plain version and the LPC chain against the JAX package.

The port's plain float64 autocorrelation (what a CPU tensor runs, and
what the CUDA kernel is held against on the card) must agree with the
Pallas kernel (interpret mode) and with the JAX float64 formulation to
5e-11 relative, the bound tests/test_pallas_autocorr.py uses. Given the
same autocorrelation, Levinson and quantization must agree bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flake_tpu.ops import lpc as jlpc
from flake_tpu.ops.pallas_autocorr import autocorr_dd_pallas

from flake_tpu_torch.ops import autocorr as tautocorr
from flake_tpu_torch.ops import lpc as tlpc

REL_TOL = 5e-11

_jax_autocorr = jax.jit(jlpc.autocorr, static_argnums=(1, 3))
_jax_levinson = jax.jit(jlpc.levinson_all_orders)
_jax_quantize = jax.jit(jlpc.quantize_lpc_coefs, static_argnums=(1,))


def _streams(B, rows=8, seed=0):
    """Tonal, noisy, constant and silent int32 streams [rows, B]."""
    rng = np.random.default_rng(seed)
    t = np.arange(B)
    sigs = [
        12000 * np.sin(2 * np.pi * 440 * t / 44100)
        + 800 * rng.standard_normal(B),
        rng.integers(-32768, 32768, B),
        30000 * np.sin(2 * np.pi * 40 * t / 44100),
        np.full(B, 123.0),
        np.zeros(B),
    ]
    while len(sigs) < rows:
        sigs.append(rng.normal(0, 2 ** rng.integers(2, 15), B))
    return np.clip(np.stack(sigs[:rows]), -65536, 65535).astype(np.int32)


def _rel(a, b):
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))


@pytest.mark.parametrize("B,max_order", [(1024, 12), (1024, 32),
                                         (777, 12), (777, 32)])
def test_plain_autocorr_matches_jax(B, max_order):
    x = _streams(B, seed=B + max_order)
    w = jlpc.welch_window(B)
    got = tautocorr.autocorr(torch.from_numpy(x), torch.from_numpy(w),
                             max_order).numpy()
    ref = np.asarray(_jax_autocorr(jnp.asarray(x), max_order,
                                   jnp.asarray(w), jnp.float64))
    assert _rel(got, ref) < REL_TOL
    whi, wlo = jlpc.split_window_f32(w)
    pallas = np.asarray(autocorr_dd_pallas(
        jnp.asarray(x), jnp.asarray(whi), jnp.asarray(wlo),
        max_order=max_order, interpret=True)) + 2.0
    assert _rel(got, pallas) < REL_TOL


@pytest.mark.parametrize("B,max_order", [(1024, 12), (777, 32)])
def test_levinson_and_quantize_bit_exact(B, max_order):
    rng = np.random.default_rng(B)
    x = np.clip(rng.normal(0, 3000, (32, B)).cumsum(-1) * 0.05,
                -32768, 32767).astype(np.int32)
    x[:4] = _streams(B, rows=4, seed=1)
    w = jlpc.welch_window(B)
    autoc = np.array(_jax_autocorr(jnp.asarray(x), max_order,
                                   jnp.asarray(w), jnp.float64))
    j_rows, j_refs = _jax_levinson(jnp.asarray(autoc))
    t_rows, t_refs = tlpc.levinson_all_orders(torch.from_numpy(autoc))
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(j_rows))
    np.testing.assert_array_equal(t_refs.numpy(), np.asarray(j_refs))

    j_q, j_sh = _jax_quantize(j_rows, 15)
    t_q, t_sh = tlpc.quantize_lpc_coefs(t_rows, 15)
    np.testing.assert_array_equal(t_q.numpy(), np.asarray(j_q))
    np.testing.assert_array_equal(t_sh.numpy(), np.asarray(j_sh))
