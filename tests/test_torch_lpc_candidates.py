"""The LPC coefficient stage (``ops/lpc.candidates`` on CPU tensors, its
plain version) against the jitted JAX ``levinson_all_orders``,
``schur_refs``, ``levinson_from_refs`` and ``quantize_lpc_coefs``, bit for
bit in float64 (NaNs count as equal; the int32 image of a NaN tap is 0 in
both).

- Windowed autocorrelations of tonal, noisy, constant and silent streams
  (the silent stream's Schur divides by an error of 0) at orders 1, 12
  and 32, precisions 5 and 15, under Levinson and under EST.
- The shift search and its branches at precisions 5-15, through order-1
  rows: an autocorrelation [1, c, 0, ...] gives row 0 = c exactly, so c
  walks cmax over 0, subnormals, exact powers of two, the qmax * 2^-sh
  boundaries and their neighbours, the all-zero-out edge 2^-15 and values
  above qmax (the scale-down branch); the higher rows of the same
  autocorrelations are far from positive definite (errors of 0, inf and
  NaN reflection coefficients).
- float32 on JAX's float32 autocorrelation.

JAX's quantizer runs with exact powers of two in place of XLA:CPU's
``exp2``, which is off by ulps at most integers (2^15 = 32767.99...):
the port builds 2^s from its bits, as the C reference's ``1 << shift``
is, and the two differ only where cmax * 2^s lies within an ulp of qmax.
XLA:CPU flushes subnormals to zero and the port keeps them, as the C
reference does: on the rows of a subnormal cmax, which both zero out, the
coefficients and shifts are held against JAX's and the first reflection
coefficient to -c.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flake_tpu.ops import lpc as jlpc

from flake_tpu_torch.ops import lpc as tlpc


def _quantize_exact_pow2(rows, precision):
    """``jlpc.quantize_lpc_coefs`` traced with an exact ``exp2``."""
    exp2 = jnp.exp2
    jnp.exp2 = lambda s: jnp.ldexp(jnp.ones_like(s), s.astype(jnp.int32))
    try:
        return jlpc.quantize_lpc_coefs(rows, precision)
    finally:
        jnp.exp2 = exp2


_levinson = jax.jit(jlpc.levinson_all_orders)
_schur = jax.jit(jlpc.schur_refs)
_seeded = jax.jit(jlpc.levinson_from_refs)
_quantize = jax.jit(_quantize_exact_pow2, static_argnums=(1,))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Each recursion step is a few small torch calls on a small batch;
    six test workers with a thread pool each slow them down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_candidates(autoc: np.ndarray, est: bool, precision: int):
    a = jnp.asarray(autoc)
    if est:
        refs = _schur(a)
        rows = _seeded(refs)
    else:
        rows, refs = _levinson(a)
    q, sh = _quantize(rows, precision)
    return np.asarray(q), np.asarray(sh), np.asarray(refs)


def _assert_same(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    """Equal dtype, shape and bits; two NaNs count as equal."""
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype.kind == "f":
        nan = np.isnan(got) & np.isnan(want)
        bits = {4: np.int32, 8: np.int64}[got.itemsize]
        got, want = np.where(nan, 0, got.view(bits)), \
            np.where(nan, 0, want.view(bits))
    bad = np.flatnonzero(got != want)
    assert bad.size == 0, f"{what}: {bad.size} differ, first at {bad[:5]}"


def _check(autoc: np.ndarray, est: bool, precision: int,
           names=("qcoefs", "shifts", "refs")) -> tuple:
    """The port's three outputs on ``autoc``, each of ``names`` held
    against JAX's."""
    got = tlpc.candidates(torch.from_numpy(autoc), est, precision)
    want = _jax_candidates(autoc, est, precision)
    for name, g, w in zip(("qcoefs", "shifts", "refs"), got, want):
        if name in names:
            _assert_same(g, w, name)
    return got


def _autoc(N, B, max_order, seed):
    """[N, max_order + 1] windowed autocorrelations: tonal streams with
    noise, row 1 silent (every lag 2.0, the bias), row 2 constant, row 3
    quiet noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(B)
    x = 8000 * np.sin(2 * np.pi * rng.uniform(50, 3000, (N, 1)) * t / 44100) \
        + rng.normal(0, rng.uniform(1, 2000, (N, 1)), (N, B))
    x[1] = 0
    x[2] = 1234
    x[3] = rng.integers(-2, 3, B)
    return tlpc.autocorr(torch.from_numpy(x.astype(np.int32)), max_order,
                         torch.from_numpy(tlpc.welch_window(B))).numpy()


@pytest.mark.parametrize("est", [False, True], ids=["levinson", "est"])
@pytest.mark.parametrize("precision", [5, 15])
@pytest.mark.parametrize("max_order", [1, 12, 32])
def test_candidates_on_streams(max_order, precision, est):
    autoc = _autoc(12, 1024, max_order, seed=max_order + precision)
    q, sh, refs = _check(autoc, est, precision)
    assert q.shape == (12, max_order, max_order)
    assert sh.shape == refs.shape == (12, max_order)
    if max_order > 1:
        # row 0 of a tonal stream reaches the quantizer's every path but
        # the degenerate ones: nonzero coefficients and shifts
        assert (q[0] != 0).any() and (sh[0] > 0).any()


def _boundary_values(precision: int) -> np.ndarray:
    """cmax values at the quantizer's edges for ``precision``: 0, -0,
    subnormals, powers of two, qmax * 2^-sh for every sh with their
    neighbours, 2^-15 (the all-zero-out edge) and values above qmax."""
    qmax = (1 << (precision - 1)) - 1
    edges = [qmax * 2.0 ** -sh for sh in range(16)] \
        + [2.0 ** k for k in range(-20, 21)] \
        + [2.0 ** -15, qmax + 0.5, qmax + 1.0, 2.0 * qmax, 1e6, 1e30,
           1e300]
    vals = [0.0, -0.0, 5e-324, 1e-310, 2.2250738585072014e-308]
    for e in edges:
        vals += [np.nextafter(e, 0.0), e, np.nextafter(e, np.inf)]
    vals = np.asarray(vals)
    return np.concatenate([vals, -vals[vals != 0]])


@pytest.mark.parametrize("est", [False, True], ids=["levinson", "est"])
@pytest.mark.parametrize("precision", range(5, 16))
def test_shift_search_boundaries(precision, est):
    c = _boundary_values(precision)
    autoc = np.zeros((c.size, 5))
    autoc[:, 0] = 1.0
    autoc[:, 1] = c
    sub = (c != 0) & (np.abs(c) < np.finfo(np.float64).tiny)
    q, sh, refs = _check(autoc[~sub], est, precision)
    # subnormal rows: zeroed out by both; XLA's flush moves the signs of
    # the later (zero) reflection coefficients, so only the first, -c, is
    # held
    q_sub, sh_sub, refs_sub = _check(autoc[sub], est, precision,
                                     ("qcoefs", "shifts"))
    assert not q_sub.any() and not sh_sub.any()
    assert torch.equal(refs_sub[:, 0], torch.from_numpy(-c[sub]))
    c = c[~sub]
    qmax = (1 << (precision - 1)) - 1
    # row 0 is c itself: the search meets every branch
    assert (sh[:, 0] == 15).any() and (sh[:, 0] == 0).any()
    assert ((q[:, 0, 0] == 0) & torch.from_numpy(c != 0)).any()  # zeroed
    assert (q[:, 0, 0].abs() == qmax).any()                # scaled down


@pytest.mark.parametrize("est", [False, True], ids=["levinson", "est"])
def test_degenerate_autocorrelations(est):
    """Autocorrelations no stream gives: zero, negative and huge lags, a
    zero lag 0, inf and NaN, where errors reach 0 and the coefficients
    inf and NaN."""
    rng = np.random.default_rng(17)
    autoc = rng.normal(0, 1, (40, 9)) * 10.0 ** rng.integers(-5, 6, (40, 1))
    autoc[:, 0] = np.abs(autoc[:, 0])
    autoc[0] = 0.0
    autoc[1] = 2.0
    autoc[2, 0] = 0.0
    autoc[3, 0] = -1.0
    autoc[4, 3] = np.inf
    autoc[5, 2] = np.nan
    autoc[6] = [1.0, 1.0, 1.0, -1.0, 1e300, 0.0, 0.0, 0.0, 0.0]
    autoc[7, 1:] = 0.0
    q, _, refs = _check(autoc, est, 15)
    assert torch.isnan(refs).any() or torch.isinf(refs).any()


@pytest.mark.parametrize("est", [False, True], ids=["levinson", "est"])
def test_float32(est):
    """float32 on JAX's own float32 autocorrelation (the float32 sum's
    order is XLA's, so the port's would differ by ulps)."""
    x = np.random.default_rng(3).normal(0, 3000, (8, 2048)).cumsum(-1)
    x = np.clip(x * 0.02, -32768, 32767).astype(np.int32)
    x[1] = 0
    autoc = np.array(jax.jit(lambda v: jlpc.autocorr(
        v, 12, jnp.asarray(jlpc.welch_window(2048)), jnp.float32))(
            jnp.asarray(x)))
    assert autoc.dtype == np.float32
    q, _, refs = _check(autoc, est, 15)
    assert refs.dtype == torch.float32 and (q[0] != 0).any()


def test_wrapper_takes_no_other_device():
    """A tensor on neither the CPU nor a card raises: there is no quiet
    fallback to the plain version."""
    meta = torch.empty((4, 13), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        tlpc.candidates(meta, False, 15)


def test_frame_stage_is_the_wrapper():
    """``frame.lpc_candidates`` (the dense and the sp analysis) returns
    the wrapper's outputs under EST and under LOG."""
    from flake_tpu_torch import params as TP
    from flake_tpu_torch.ops import frame as tframe

    autoc = torch.from_numpy(_autoc(6, 1024, 12, seed=9))
    for level, est in ((5, True), (8, False)):
        cfg = tframe.FrameConfig.from_params(TP.set_defaults(level), 2, 16)
        got = tframe.lpc_candidates(cfg, autoc[:, :cfg.max_prediction_order
                                               + 1])
        want = tlpc.candidates_plain(
            autoc[:, :cfg.max_prediction_order + 1], est, cfg.precision)
        for g, w in zip(got, want):
            _assert_same(g, w.numpy(), "frame stage")


@pytest.mark.parametrize("precision", [5, 15])
def test_scale_down_rows(precision):
    """Rows of eight orders with coefficients of 10 to 10^5, a quarter or
    more of them above qmax with shift 0, where the plain version scales by
    ``reciprocal(cmax) * qmax`` (two roundings) and JAX by ``qmax /
    cmax``: the quantized coefficients agree."""
    rng = np.random.default_rng(precision)
    rows = np.zeros((20000, 8, 8))
    for o in range(8):
        rows[:, o, :o + 1] = rng.normal(0, 1, (20000, o + 1)) \
            * 10.0 ** rng.uniform(1, 5, (20000, 1))
    q, sh = tlpc.quantize_lpc_coefs(torch.from_numpy(rows), precision)
    want_q, want_sh = _quantize(jnp.asarray(rows), precision)
    _assert_same(q, np.asarray(want_q), "qcoefs")
    _assert_same(sh, np.asarray(want_sh), "shifts")
    assert (sh == 0).float().mean() > 0.25
