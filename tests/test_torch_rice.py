"""The Rice search's plain versions against the JAX package, bit for bit.

R1's plain version (:func:`rice_scan_plain`, through :func:`rice_scan` on
CPU tensors) against ``_fold_pyramid`` + ``_dynamic_porder_scan`` on the
uint64 pyramid and, through :func:`subframe_bits_from_sums`, against
``subframe_bits_from_limbs``; the search from a residual
(:func:`rice_final_plain`) against ``calc_rice_params_dynamic``; R2's
(:func:`final_pass_plain`, through :func:`final_pass` on CPU tensors)
against ``predict.residual_lpc_dynamic`` (or, for the fixed predictors,
``predict.residual_fixed``) followed by ``calc_rice_params_dynamic``, its
fit flag against the port's ``fits_int32``; and the closed form of the k
search that the kernels take where no count wraps, against
:func:`find_optimal_k_u32`. The kernels themselves are held against these
plain versions on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).

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

from flake_tpu.ops import predict as jpredict
from flake_tpu.ops import rice as jrice

from flake_tpu_torch import params as P
from flake_tpu_torch.ops import predict as tpredict
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
    got = trice.rice_final_plain(torch.from_numpy(res),
                                 torch.from_numpy(order), n, pmin, pmax)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key].numpy()
        np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype),
                                      err_msg=key)


# R2's cases: name -> (n, pmin, pmax, largest order, taps, bits of the
# samples, shift or None for the fixed predictors)
PASS_CASES = {
    "n4096": (4096, 0, 6, 12, 12, 16, 12),
    "tail777": (777, 0, 8, 32, 32, 24, 14),
    "fixed": (1152, 0, 8, 4, 4, 16, None),
    "unfit": (1024, 0, 6, 32, 32, 32, 15),
}


def _pass_case(name):
    """(samples int32 [N, n], coefs int32 [N, taps], shift, order int32
    [N]): tones with noise at the case's bit depth (the "unfit" case at the
    int32 limits, where order-32 coefficients near +-2^14 and shift 15
    send some exact residuals past int32), rows of silence and of
    full-scale noise, orders 0..largest, coefficients a quantizer could
    give (or the fixed predictors' binomial ones, shift 0)."""
    n, _, _, top, taps, bps, sh = PASS_CASES[name]
    rng = np.random.default_rng(list(PASS_CASES).index(name) + 300)
    orders = np.arange(top + 1, dtype=np.int32)
    N = 3 * orders.size
    t = np.arange(n)
    amp = 2.0 ** (bps - 2)
    smp = amp * np.sin(2 * np.pi * rng.uniform(50, 4000, (N, 1)) * t / 44100) \
        + rng.normal(0, amp / 64, (N, n))
    smp[1::3] = 0
    smp[2::3] = rng.integers(-2**(bps - 1), 2**(bps - 1), (orders.size, n))
    smp = np.clip(np.rint(smp), -2**(bps - 1), 2**(bps - 1) - 1) \
        .astype(np.int32)
    order = np.repeat(orders, 3)
    if sh is None:
        coefs = tpredict.fixed_coefs(torch.from_numpy(order), taps).numpy()
        shift = np.zeros(N, np.int32)
    else:
        coefs = rng.integers(-2**14, 2**14, (N, taps)).astype(np.int32)
        if name != "unfit":
            coefs >>= rng.integers(2, 8, (N, 1)).astype(np.int32)
        shift = np.full(N, sh, np.int32)
    return smp, coefs, shift, order


@functools.lru_cache(None)
def _jax_pass(name):
    """JAX's final re-encode of a case: ``residual_lpc_dynamic`` (every
    order's ``residual_fixed``, picked by row, for the fixed predictors)
    and ``calc_rice_params_dynamic``, under one jit."""
    smp, coefs, shift, order = _pass_case(name)
    n, pmin, pmax, top, taps, _, sh = PASS_CASES[name]

    def final(smp, coefs, shift, order):
        if sh is None:
            res = jpredict.residual_fixed(smp, 0)
            for o in range(1, top + 1):
                res = jnp.where((order == o)[:, None],
                                jpredict.residual_fixed(smp, o), res)
        else:
            res = jpredict.residual_lpc_dynamic(smp, coefs, shift, order,
                                                taps)
        return res, jrice.calc_rice_params_dynamic(res, n, order, pmin,
                                                   pmax)

    res, rc = jax.jit(final)(*map(jnp.asarray, (smp, coefs, shift, order)))
    return np.asarray(res), {k: np.asarray(v) for k, v in rc.items()}


@pytest.mark.parametrize("name", list(PASS_CASES))
def test_final_pass_matches_jax(name):
    """R2's plain version, every output bit for bit; the residual wrapped
    as the JAX package wraps it, the fit flag the port's own check of the
    exact residual (both values reached where 32-bit samples meet shifted
    order-32 predictions)."""
    smp, coefs, shift, order = _pass_case(name)
    n, pmin, pmax = PASS_CASES[name][:3]
    got = trice.final_pass(*map(torch.from_numpy, (smp, coefs, shift,
                                                   order)), n, pmin, pmax)
    want_res, want = _jax_pass(name)
    np.testing.assert_array_equal(got["residual"].numpy(), want_res)
    assert set(got) == set(want) | {"residual", "fits"}
    for key, w in want.items():
        g = got[key].numpy()
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=key)
    res64 = tpredict.residual_lpc_dynamic64(
        *map(torch.from_numpy, (smp, coefs, shift, order)), coefs.shape[1])
    assert torch.equal(got["fits"], tpredict.fits_int32(res64))
    if name == "unfit":
        assert not got["fits"].all() and got["fits"].any()


def test_rice_final_keeps_leading_dims():
    """[F, C, n] samples (the FIXED path's) give [F, C] outputs, the rows'
    own (42 rows as 14 frames of 3 channels)."""
    smp, coefs, shift, order = map(torch.from_numpy, _pass_case("fixed"))
    flat = trice.final_pass(smp, coefs, shift, order, 1152, 0, 8)
    got = trice.final_pass(smp.reshape(-1, 3, 1152), coefs.reshape(-1, 3, 4),
                           shift.reshape(-1, 3), order.reshape(-1, 3), 1152,
                           0, 8)
    for key, v in flat.items():
        assert got[key].shape[:2] == (smp.shape[0] // 3, 3), key
        assert torch.equal(got[key].reshape(v.shape), v), key


def _closed_form_k(s, cnt):
    """The kernels' closed form of the k search (``csrc/rice.cu``,
    ``rice_k``) in numpy: (whether it applies, k). t = s - floor(cnt / 2);
    it applies where cnt >= 1 and t < 0 or t + 31 cnt < 2^32, and k is 0
    where t < 0, else the least k with t < (2 cnt + 1) 2^k, at most 30."""
    t = s.astype(np.int64) - (cnt >> 1)
    applies = (cnt >= 1) & ((t < 0) | (t + 31 * cnt < 1 << 32))
    m = 2 * cnt + 1
    tt = np.maximum(t, 0)
    # bit lengths, exact below 2^53
    k0 = np.maximum(np.frexp(tt.astype(np.float64))[1]
                    - np.frexp(m.astype(np.float64))[1], 0)
    k = np.minimum(k0 + ((tt >> k0) >= m), 30)
    return applies, np.where(t < 0, 0, k)


def test_closed_form_k_matches_the_scan():
    """Wherever it applies, the closed form is the 31-step scan's first
    minimum: on a grid of counts 1..65,535 and sums up to 2^33, and at the
    edges of its domain (t + 31 cnt = 2^32 - 1 applies, 2^32 does not;
    t < 0; cnt = 1; counts of 0 and below do not apply)."""
    rng = np.random.default_rng(16)
    cnt = np.concatenate([np.repeat(np.arange(1, 40), 2000),
                          rng.integers(1, 65536, 120000)])
    scale = 2.0 ** rng.uniform(0, 33, cnt.size)
    s = (rng.random(cnt.size) * scale * cnt / 8).astype(np.int64)
    edge_cnt = np.array([1, 1, 1, 7, 7, 4096, 4096, 65535, 1, 64, 0, -3, 2])
    half = edge_cnt >> 1
    edge_s = np.array([
        (1 << 32) - 1 - 31 + half[0], (1 << 32) - 31 + half[1], 0,
        (1 << 32) - 1 - 31 * 7 + half[3], (1 << 32) - 31 * 7 + half[4],
        (1 << 32) - 1 - 31 * 4096 + half[5], 1000, 0, 3, 31, 5, 9, 0])
    s = np.concatenate([s, edge_s])
    cnt = np.concatenate([cnt, edge_cnt])
    applies, k = _closed_form_k(s, cnt)
    assert applies[-13:].tolist() == [True, False, True, True, False, True,
                                      True, True, True, True, False, False,
                                      True]
    assert applies.mean() > 0.5
    want, _ = trice.find_optimal_k_u32(torch.from_numpy(s),
                                       torch.from_numpy(cnt))
    np.testing.assert_array_equal(k[applies], want.numpy()[applies])


def test_rice_scan_refuses_what_no_version_takes():
    sums = torch.zeros((2, 48), dtype=torch.int64)
    order = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not fold"):
        trice.rice_scan(sums, order, 4096, 0, 6)
    with pytest.raises(ValueError, match="no kernel"):
        trice.rice_scan(sums[:, :32].to("meta"), order.to("meta"), 4096, 0,
                        5)
    with pytest.raises(ValueError, match="no kernel"):
        smp = torch.zeros((2, 64), dtype=torch.int32, device="meta")
        trice.final_pass(smp, smp[:, :4], order.to("meta"), order.to("meta"),
                         64, 0, 3)
