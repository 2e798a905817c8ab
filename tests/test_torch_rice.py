"""The Rice search's plain versions against the JAX package, bit for bit.

R1's plain version (:func:`rice_scan_plain`, through :func:`rice_scan` on
CPU tensors) against ``_fold_pyramid`` + ``_dynamic_porder_scan`` on the
uint64 pyramid and, through :func:`subframe_bits_from_sums`, against
``subframe_bits_from_limbs``; R2's (:func:`rice_final_plain`, through
:func:`calc_rice_params_dynamic`) against ``calc_rice_params_dynamic``.
The kernels themselves are held against these plain versions on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).

Cases: the level-8 shape (n 4096, pmax 6, orders 1-12), the level-12 one
(n 8192, pmax 8, orders 1-32 and beyond, sums at twice the partitions'
resolution), orders whose warm-up exceeds a partition with pmin 2, n 4608
(18-sample partitions), n 1152 (the ``n ^ (n - 1)`` clamp) at order 0 and
1-4, the tails 777, 20 and 3, and a table of rows whose k scans and
partition-order scans tie. Rows of sums at or above 2^32 (and residuals
near the int32 limits, whose zigzag wraps) make the limb form's high half
nonzero and its counts wrap. Every input comes from a numpy seed; each JAX
function compiles once a case.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flake_tpu.ops import rice as jrice

from flake_tpu_torch import params as P
from flake_tpu_torch.ops import rice as trice

PRECISION = P.LPC_PRECISION

# name -> (n, pmin, pmax, orders of a stream's rows, streams, is_lpc)
CASES = {
    "level8": (4096, 0, 6, range(1, 13), 6, True),
    "level12": (8192, 0, 8, list(range(1, 33)) + [33, 40, 300, 9000], 3,
                True),
    "clamp": (4096, 2, 8, range(1, 33), 2, True),
    "n4608": (4608, 0, 8, range(0, 13), 4, True),
    "n1152": (1152, 0, 8, range(0, 5), 8, False),
    "tail777": (777, 0, 8, range(0, 33), 2, True),
    "tail20": (20, 0, 8, range(0, 20), 2, True),
    "tail3": (3, 0, 8, range(0, 3), 4, False),
    "ties": (64, 0, 3, None, None, True),
}
# the residual cases of R2 (the shapes the encoder's final pass sees)
FINAL_CASES = ["level8", "level12", "n4608", "n1152", "tail777", "tail20",
               "tail3", "ties"]
U32 = np.uint64(0xFFFFFFFF)


def _pyramid(top: np.ndarray, ps: int) -> list:
    levels = [None] * (ps + 1)
    levels[ps] = top.astype(np.uint64)
    for p in range(ps - 1, -1, -1):
        levels[p] = levels[p + 1][:, 0::2] + levels[p + 1][:, 1::2]
    return levels


def _count_grid(s: np.ndarray, cnt: np.ndarray) -> np.ndarray:
    """rice.h:48's count for k = 0..30, uint64 before its uint32 cut."""
    ks = np.arange(31, dtype=np.uint64)
    with np.errstate(over="ignore"):
        return cnt[..., None] * (ks + np.uint64(1)) \
            + (((s - (cnt >> np.uint64(1)))[..., None] >> ks) & U32)


def _level_scan(top: np.ndarray, n: int, order: np.ndarray, ps: int):
    """Each row's bits at every level [R, ps + 1], whether any of its
    partitions' k scans ties, and whether any count wrapped uint32."""
    ktie = np.zeros(top.shape[0], bool)
    wrapped = np.zeros(top.shape[0], bool)
    bits = []
    for p, s in enumerate(_pyramid(top, ps)):
        cnt = np.full(s.shape, n >> p, np.uint64)
        with np.errstate(over="ignore"):
            cnt[:, 0] = np.uint64(n >> p) - order.astype(np.uint64)
        grid = _count_grid(s, cnt)
        wrapped |= (grid > U32).any(axis=(1, 2))
        grid &= U32
        least = grid.min(-1)
        ktie |= ((grid == least[..., None]).sum(-1) > 1).any(-1)
        bits.append((least.sum(-1) + np.uint64(4 << p)) & U32)
    return np.stack(bits, 1), ktie, wrapped


def _tie_rows(rng):
    """Rows of 8 partitions of 8 samples (n 64, pmax 3) whose level scan
    ties at its least bits, half of them with a tied k scan too, and 16
    rows with a tied k scan only."""
    n, ps = 64, 3
    top = rng.integers(0, 1 + (1 << rng.integers(0, 5, (20000, 1))) * 8,
                       (20000, 8))
    top[:, 4:] *= rng.integers(1, 6, (20000, 1))
    order = rng.integers(0, 5, 20000)
    bits, ktie, _ = _level_scan(top, n, order, ps)
    ltie = (bits == bits.min(1, keepdims=True)).sum(1) > 1
    pick = np.concatenate([np.flatnonzero(ltie & ktie)[:24],
                           np.flatnonzero(ltie & ~ktie)[:24],
                           np.flatnonzero(~ltie & ktie)[:16]])
    return top[pick], order[pick].astype(np.int32)


def _stream_sums(rng, n, ps, rows, sub=1):
    """Partition sums as a sweep gives them: per-row magnitudes from 2^0
    to 2^20 a sample, a louder second half on some rows, some zero
    partitions; ``sub`` sums a partition."""
    psize = n >> ps
    parts = (1 << ps) * sub
    mean = 2.0 ** rng.uniform(0, 20, (rows, 1))
    loud = np.where(rng.random((rows, 1)) < 0.3, 8.0, 1.0)
    scale = np.where(np.arange(parts) >= parts // 2, mean * loud, mean)
    s = rng.gamma(4.0, scale / 4.0 * psize / sub).astype(np.int64)
    s[rng.random((rows, parts)) < 0.05] = 0
    return s


@functools.lru_cache(None)
def _sums_case(name):
    """(sums int64 [R, G], order int32 [R]) of a case."""
    n, pmin, pmax, orders, streams, _ = CASES[name]
    ps = trice.limit_max_partition_order(pmax, n, 1)
    rng = np.random.default_rng(list(CASES).index(name) + 100)
    if name == "ties":
        top, order = _tie_rows(rng)
        return top.astype(np.int64), order
    orders = np.asarray(list(orders), np.int32)
    sub = 2 if name == "level12" else 1
    rows = streams * orders.size
    sums = _stream_sums(rng, n, ps, rows, sub)
    order = np.tile(orders, streams)
    if name in ("level8", "level12"):
        # a stream of sums at or above 2^32: limb form with a high half,
        # counts that wrap uint32
        big = rng.integers(1 << 32, n << 32, (orders.size, sums.shape[1]))
        sums = np.concatenate([sums, big])
        order = np.concatenate([order, orders])
    return sums, order


def _jax_scan(name):
    """JAX's uint64 pyramid and partition-order scan on a case."""
    sums, order = _sums_case(name)
    n, pmin, pmax = CASES[name][:3]
    ps = jrice.limit_max_partition_order(pmax, n, 1)
    top = sums.reshape(sums.shape[0], 1 << ps, -1).sum(-1)

    def scan(top, order):
        levels = [None] * ps + [top]
        jrice._fold_pyramid(levels, ps)
        return jrice._dynamic_porder_scan(levels, n, order, pmin, pmax, ps,
                                          order.shape)[:4]

    return [np.asarray(a) for a in jax.jit(scan)(
        jnp.asarray(top.astype(np.uint64)), jnp.asarray(order))]


def _obits(order):
    return (np.arange(order.size) % 20 + 8).astype(np.int32)


@pytest.mark.parametrize("name", list(CASES))
def test_rice_scan_matches_jax(name):
    sums, order = _sums_case(name)
    n, pmin, pmax = CASES[name][:3]
    got = trice.rice_scan(torch.from_numpy(sums), torch.from_numpy(order),
                          n, pmin, pmax)
    want = _jax_scan(name)
    for key, g, w in zip(("bits", "porder", "method", "params"), got, want):
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype),
                                      err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_subframe_bits_from_sums_matches_limbs(name):
    sums, order = _sums_case(name)
    n, pmin, pmax, *_, is_lpc = CASES[name]
    obits = _obits(order)
    want = jax.jit(functools.partial(
        jrice.subframe_bits_from_limbs, n=n, pmin=pmin, pmax=pmax,
        precision=PRECISION, is_lpc=is_lpc))(
        jnp.asarray((sums & 0xFFFF).astype(np.int32)),
        jnp.asarray((sums >> 16).astype(np.int32)), order=jnp.asarray(order),
        obits=jnp.asarray(obits))
    got = trice.subframe_bits_from_sums(
        torch.from_numpy(sums), n, torch.from_numpy(order),
        torch.from_numpy(obits), pmin, pmax, PRECISION, is_lpc)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))


def test_the_tables_reach_ties_and_wraps():
    """The tie table ties in both scans, the big rows' limb form has a
    high half and their counts wrap uint32."""
    top, order = _sums_case("ties")
    bits, ktie, _ = _level_scan(top, 64, order, 3)
    ltie = (bits == bits.min(1, keepdims=True)).sum(1) > 1
    assert (ltie & ktie).sum() >= 8 and (ltie & ~ktie).sum() >= 8 \
        and (~ltie & ktie).sum() >= 8
    for name in ("level8", "level12"):
        sums, order = _sums_case(name)
        n, _, pmax = CASES[name][:3]
        ps = trice.limit_max_partition_order(pmax, n, 1)
        top = sums.reshape(sums.shape[0], 1 << ps, -1).sum(-1)
        _, _, wrapped = _level_scan(top, n, order, ps)
        assert (sums >= 1 << 32).any() and wrapped.any()


def _residuals(name):
    """(res int32 [N, n], order int32 [N]) of a final-pass case: Laplacian
    residuals of per-row scale 2^0 to 2^20, rows of residuals in -1..1,
    and rows at the int32 limits (zigzag wraps at |r| >= 2^30); for
    "ties", residuals whose partition sums are the tie table's."""
    n, _, pmax, orders, streams, _ = CASES[name]
    rng = np.random.default_rng(FINAL_CASES.index(name) + 200)
    if name == "ties":
        top, order = _sums_case("ties")
        z = np.zeros((top.shape[0], n), np.int64)
        for r, (row, o) in enumerate(zip(top, order)):
            for j, s in enumerate(row):
                lo = max(j * 8, int(o))
                idx = rng.integers(lo, j * 8 + 8, int(s))
                np.add.at(z[r], idx, 1)
        res = (z >> 1) ^ -(z & 1)
        return res.astype(np.int32), order
    orders = np.asarray(list(orders), np.int32)
    scale = 2.0 ** rng.uniform(0, 20, (streams, 1))
    res = [np.clip(rng.laplace(0, scale, (streams, n)), -2**31, 2**31 - 1),
           rng.integers(-1, 2, (1, n)),
           rng.integers(-2**31, 2**31, (1, n)),
           rng.choice([-2**30 - 1, -2**30, 2**30 - 1, 2**30], (1, n))]
    res = np.concatenate(res).astype(np.int32)
    res = np.repeat(res, orders.size, 0)
    return res, np.tile(orders, res.shape[0] // orders.size)


@pytest.mark.parametrize("name", FINAL_CASES)
def test_rice_final_matches_jax(name):
    res, order = _residuals(name)
    n, pmin, pmax = CASES[name][:3]
    want = jax.jit(jrice.calc_rice_params_dynamic, static_argnums=(1, 3, 4))(
        jnp.asarray(res), n, jnp.asarray(order), pmin, pmax)
    got = trice.calc_rice_params_dynamic(torch.from_numpy(res), n,
                                         torch.from_numpy(order), pmin, pmax)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key].numpy()
        np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype),
                                      err_msg=key)


def test_rice_final_keeps_leading_dims():
    """[F, C, n] residuals (the FIXED path's) give [F, C] outputs, the
    rows' own (55 rows as 11 frames of 5 channels)."""
    res, order = _residuals("n1152")
    flat = trice.rice_final(torch.from_numpy(res), torch.from_numpy(order),
                            1152, 0, 8)
    got = trice.rice_final(torch.from_numpy(res).reshape(-1, 5, 1152),
                           torch.from_numpy(order).reshape(-1, 5), 1152, 0,
                           8)
    for key, v in flat.items():
        assert torch.equal(got[key].reshape(v.shape), v), key


def test_rice_scan_refuses_what_no_version_takes():
    sums = torch.zeros((2, 48), dtype=torch.int64)
    order = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not fold"):
        trice.rice_scan(sums, order, 4096, 0, 6)
    with pytest.raises(ValueError, match="no kernel"):
        trice.rice_scan(sums[:, :32].to("meta"), order.to("meta"), 4096, 0,
                        5)
    with pytest.raises(ValueError, match="no kernel"):
        trice.rice_final(torch.zeros((2, 64), dtype=torch.int32,
                                     device="meta"), order.to("meta"), 64, 0,
                         3)
