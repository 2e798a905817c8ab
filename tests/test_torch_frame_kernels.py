"""The plain versions of S, X, H and E against the JAX package, on the CPU.

S (``frame.select_order_bits_plain``): LOG and LEVEL4 at orders 12 and 32
and SEARCH on random int64 bit tables with forced ties and entries of
``U32_MASK``, against ``flake_tpu.ops.frame.select_order``; S with its
gather (``frame.select_candidate_plain``) under every order method at
orders 8, 12 and 32, EST on JAX ``lpc.schur_refs`` and the rule's edges in
float64 and float32, against that selection and the JAX analysis's row
select. X
(``rice.fixed_search_plain``): FIXED orders 0-4 at n = 1152, 20 and 10 on
16- and 32-bit content, against the JAX analysis's FIXED order loop
(``predict.residual_fixed`` and ``rice.subframe_bits``, ascending strict
<) under one jit a size; the kernel's contract, the FIXED residual as the
wrapped k-th difference of the samples, on the port's
``predict.residual_fixed`` alone. H (``frame.frame_head_plain``): the stereo mode on
tied estimates, the 32-bit side veto, all-zero, constant and 15-wasted-bit
frames at 1, 2 and 6 channels, against the JAX analysis's head
(``stereo.decorr_mode``, ``apply_decorr``, ``wasted.remove_wasted_bits``
and the constant test) under one jit a shape. E
(``bitpack.slot_layout_plain``): the three slot tables of the port's
analysis at 16, 24 and 32 bits (the wide (hi, lo) form) against JAX's
``pack_frames_device(debug=True)`` on the same analysis. Z's plain version
(``frame.finalize_analysis_plain``): made-up tables that force CONSTANT
rows, unfit rows and over-size frames on the LPC, FIXED and VERBATIM paths
against the JAX ``finalize_analysis`` under two jits. Each wrapper
refuses a tensor on a device it has no kernel for. The kernels themselves
are held against these plain versions on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flake_tpu import params as JP
from flake_tpu.ops import bitpack as jbitpack
from flake_tpu.ops import frame as jframe
from flake_tpu.ops import lpc as jlpc
from flake_tpu.ops import predict as jpredict
from flake_tpu.ops import rice as jrice
from flake_tpu.ops import stereo as jstereo
from flake_tpu.ops import wasted as jwasted

from flake_tpu_torch import params as TP
from flake_tpu_torch.ops import bitpack as tbitpack
from flake_tpu_torch.ops import frame as tframe
from flake_tpu_torch.ops import predict as tpredict
from flake_tpu_torch.ops import rice as trice
from flake_tpu_torch.ops.common import U32_MASK

from conftest import make_test_signal


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain versions are many small torch calls on small batches; six
    test workers with a thread pool each slow them down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- S: order selection ------------------------------------------------------

def _bit_table(rows: int, max_o: int, seed: int) -> np.ndarray:
    """int64 bit counts in a narrow range (ties everywhere), a row tied
    throughout, rows of ``U32_MASK`` (an unvisited order's value under LOG)
    and rows of full-range uint32 values."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(1000, 1004, (rows, max_o)).astype(np.int64)
    bits[0] = 7
    bits[1] = U32_MASK
    bits[2, ::2] = U32_MASK
    bits[3, 1::3] = U32_MASK
    bits[4:8] = rng.integers(0, 1 << 32, (4, max_o))
    bits[8, -1] = 0
    bits[9, 0] = 0
    return bits


@pytest.mark.parametrize("max_o", [12, 32])
@pytest.mark.parametrize("method", [JP.OrderMethod.LOG, JP.OrderMethod.LEVEL4,
                                    JP.OrderMethod.SEARCH])
def test_select_order_bits_matches_jax(method, max_o):
    for min_o in (1, 3):
        bits = _bit_table(512, max_o, seed=int(method) * 40 + max_o + min_o)
        p = JP.set_defaults(8)
        p.order_method = method
        p.min_prediction_order, p.max_prediction_order = min_o, max_o
        jcfg = jframe.FrameConfig.from_params(p, 2, 16)
        want = np.asarray(jframe.select_order(jcfg, jnp.asarray(bits), None,
                                              (512,)))
        got = tframe.select_order_bits_plain(torch.from_numpy(bits),
                                             int(method), min_o, max_o)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        # and through the dispatch the analysis calls
        via = tframe.select_order(TP.from_reference(jcfg),
                                  torch.from_numpy(bits), None, (512,),
                                  torch.device("cpu"))
        np.testing.assert_array_equal(via.numpy(), want)


@jax.disable_jit()
def _jax_candidate(jcfg, bits, refs, qcoefs, shifts):
    """The JAX analysis's selection and its one-hot row select
    (``flake_tpu/ops/frame.py:460-476``), the taps padded to 32, run op by
    op: a jit would compile each of the test's configurations again."""
    max_o = jcfg.max_prediction_order
    order = jframe.select_order(jcfg, bits, refs, (qcoefs.shape[0],))
    oh_row = (jnp.arange(max_o, dtype=jnp.int32)
              == (order - 1)[..., None].clip(0, max_o - 1))
    coefs = jnp.sum(jnp.where(oh_row[..., None], qcoefs, 0), axis=-2)
    shift = jnp.sum(jnp.where(oh_row, shifts, 0), axis=-1)
    return order, jnp.pad(coefs, ((0, 0), (0, 32 - max_o))), shift


def _est_refs(rows: int, max_o: int, seed: int) -> np.ndarray:
    """JAX ``lpc.schur_refs`` of AR(2) and noise rows, then rows at the
    rule's edges: 0.10 exactly and its float64 neighbours, NaN, zeros, and
    a last order above with every other order below."""
    rng = np.random.default_rng(seed)
    t = np.arange(256)
    x = np.sin(2 * np.pi * rng.uniform(0.01, 0.3, (rows, 1)) * t) \
        + rng.normal(0, rng.uniform(0.01, 1, (rows, 1)), (rows, 256))
    autoc = np.stack([(x[:, k:] * x[:, :256 - k]).sum(-1)
                      for k in range(max_o + 1)], -1)
    refs = np.array(jlpc.schur_refs(jnp.asarray(autoc)))
    refs[0] = 0.10
    refs[1] = np.nextafter(0.10, 1.0)
    refs[2, ::2] = -np.nextafter(0.10, 1.0)
    refs[3] = np.nan
    refs[4] = 0.0
    refs[5] = 0.05
    refs[5, -1] = -0.5
    refs[6, 1::3] = np.nan
    refs[7] = np.float32(0.10)
    return refs


@pytest.mark.parametrize("max_o", [8, 12, 32])
@pytest.mark.parametrize("method", list(JP.OrderMethod))
def test_select_candidate_matches_jax(method, max_o):
    """S with its gather (``frame.select_candidate`` on CPU tensors, its
    plain version) against the JAX selection and row select, every order
    method: bit tables with ties, U32_MASK entries and values past 2^32;
    EST on float64 and float32 reflection coefficients; min order 1 and
    3."""
    rows = 256
    rng = np.random.default_rng(int(method) * 50 + max_o)
    bits = _bit_table(rows, max_o, seed=int(method) * 41 + max_o)
    bits[10:14] = rng.integers(1 << 32, 1 << 40, (4, max_o))
    bits[14, ::3] = 1 << 32
    est = method == JP.OrderMethod.EST
    refs = _est_refs(rows, max_o, seed=max_o) if est else None
    qcoefs = rng.integers(-2**31, 2**31, (rows, max_o, max_o),
                          dtype=np.int64).astype(np.int32)
    shifts = rng.integers(-16, 16, (rows, max_o)).astype(np.int32)
    reads_bits = method > JP.OrderMethod.EST
    for min_o, dtype in ((1, np.float64), (3, np.float64),
                         (1, np.float32)):
        if dtype == np.float32 and method != JP.OrderMethod.EST:
            continue
        p = JP.set_defaults(8)
        p.order_method = method
        p.min_prediction_order, p.max_prediction_order = min_o, max_o
        jcfg = jframe.FrameConfig.from_params(p, 2, 16)
        r = refs.astype(dtype) if est else None
        want = _jax_candidate(
            jcfg, jnp.asarray(bits) if reads_bits else None,
            jnp.asarray(r) if est else None,
            jnp.asarray(qcoefs), jnp.asarray(shifts))
        got = tframe.select_candidate(
            torch.from_numpy(bits) if reads_bits else None,
            torch.from_numpy(r) if est else None, torch.from_numpy(qcoefs),
            torch.from_numpy(shifts), int(method), min_o, max_o)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- X: the FIXED order search -----------------------------------------------

@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _jax_fixed_orders(chans, obits, min_o, max_o, pmin, pmax):
    """The FIXED order loop of ``flake_tpu.ops.frame.analyze_frames``."""
    n = chans.shape[-1]
    best_bits = best_order = None
    for o in range(min_o, max_o + 1):
        bits = jrice.subframe_bits(jpredict.residual_fixed(chans, o), n, o,
                                   obits, pmin, pmax, 0, False)
        if best_bits is None:
            best_bits = bits
            best_order = jnp.full(chans.shape[:-1], o, jnp.int32)
        else:
            take = bits < best_bits
            best_bits = jnp.where(take, bits, best_bits)
            best_order = jnp.where(take, o, best_order)
    return best_order


def _fixed_input(n: int, seed: int):
    """[F, 2, n] channels: 16-bit tones and noise in frames 0-3, 32-bit
    full-range noise (whose fixed predictions wrap int32) and 32-bit ramps
    in 4-7, silence, a constant, and a step in 8-10; obits to match."""
    rng = np.random.default_rng(seed)
    F = 11
    t = np.arange(n)
    x = np.zeros((F, 2, n), np.int64)
    for f in range(4):
        x[f] = np.rint(12000 * np.sin(2 * np.pi * (f + 1) * 0.01 * t)
                       + rng.normal(0, 10 ** f, (2, n)))
    x[:4] = np.clip(x[:4], -32768, 32767)
    x[4:6] = rng.integers(-(1 << 31), 1 << 31, (2, 2, n))
    x[6] = (1 << 30) - 3 * (1 << 20) * t
    x[7] = -(1 << 31) + rng.integers(0, 4, (2, n))
    x[9] = 5
    x[10, :, n // 2:] = 1000
    obits = np.full((F, 2), 16, np.int32)
    obits[4:8] = 32
    obits[:, 1] += 1                         # a side channel
    return x.astype(np.int32), obits


@pytest.mark.parametrize("n", [1152, 20, 10])
def test_fixed_search_matches_jax(n):
    chans, obits = _fixed_input(n, seed=n)
    min_o, max_o, pmin, pmax = 0, 4, 0, 8
    want = np.asarray(_jax_fixed_orders(jnp.asarray(chans),
                                        jnp.asarray(obits), min_o, max_o,
                                        pmin, pmax))
    order, coefs = trice.fixed_search_plain(
        torch.from_numpy(chans), torch.from_numpy(obits), min_o, max_o,
        pmin, pmax)
    assert order.dtype == torch.int32 and coefs.shape == (11, 2, max_o)
    np.testing.assert_array_equal(order.numpy(), want)
    assert len(set(want.ravel().tolist())) >= 2
    table = np.array([[1, 0, 0, 0], [2, -1, 0, 0], [3, -3, 1, 0],
                      [4, -6, 4, -1]])
    for o in range(5):
        rows = coefs.numpy()[order.numpy() == o]
        np.testing.assert_array_equal(rows, np.broadcast_to(
            table[o - 1] if o else np.zeros(4, int), rows.shape))
    # a narrower range: orders 1-2
    order12, _ = trice.fixed_search_plain(torch.from_numpy(chans),
                                          torch.from_numpy(obits), 1, 2,
                                          pmin, pmax)
    want12 = np.asarray(_jax_fixed_orders(jnp.asarray(chans),
                                          jnp.asarray(obits), 1, 2, pmin,
                                          pmax))
    np.testing.assert_array_equal(order12.numpy(), want12)


def test_fixed_residual_is_the_wrapped_difference():
    """The contract X's kernel sums by (``csrc/rice.cu``, ``fixed_step``):
    past the warm-up, order k's FIXED residual (the int64 prediction
    wrapped to int32) is the k-th difference of the samples taken in
    wrapping 32-bit arithmetic, on rows of the int32 extremes, 0 and +-1,
    full-range noise and alternating INT32_MIN / INT32_MAX. No JAX."""
    rng = np.random.default_rng(21)
    n = 4000
    rows = np.stack([
        rng.choice(np.array([-2**31, 2**31 - 1, 0, 1, -1]), n),
        rng.integers(-2**31, 2**31, n),
        np.where(np.arange(n) % 2, 2**31 - 1, -2**31)]).astype(np.int32)
    x = torch.from_numpy(rows)
    diff = rows.view(np.uint32)
    for order in range(5):
        res = tpredict.residual_fixed(x, order).numpy()
        assert res.dtype == np.int32
        np.testing.assert_array_equal(res[:, :order], rows[:, :order])
        np.testing.assert_array_equal(res[:, order:], diff.view(np.int32))
        diff = np.diff(diff, axis=-1)          # uint32: wraps mod 2^32


# -- H: the frame head -------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(1,))
def _jax_head(samples, cfg):
    """The head of ``flake_tpu.ops.frame.analyze_frames``, lines 279-305."""
    n, C = cfg.block_size, cfg.channels
    F = samples.shape[0]
    chans = jnp.transpose(samples, (0, 2, 1))
    obits = jnp.full((F, C), cfg.bps, dtype=jnp.int32)
    if C == 2 and n > 32 and cfg.stereo_method == JP.StereoMethod.ESTIMATE:
        mode = jstereo.decorr_mode(chans[:, 0], chans[:, 1], n, cfg.bps)
        if cfg.bps >= 32:
            over = jnp.max(jnp.abs(chans[:, 0].astype(jnp.int64)
                                   - chans[:, 1].astype(jnp.int64)),
                           axis=-1) >= (1 << 31)
            mode = jnp.where(over, jstereo.LEFT_RIGHT, mode)
        ch0, ch1, extra = jstereo.apply_decorr(chans[:, 0], chans[:, 1],
                                               mode, cfg.bps)
        chans = jnp.stack([ch0, ch1], axis=1)
        obits = obits + extra
    elif C == 2:
        mode = jnp.full((F,), jstereo.LEFT_RIGHT, dtype=jnp.int32)
    else:
        mode = jnp.full((F,), jstereo.NOT_STEREO, dtype=jnp.int32)
    chans, wasted_bits = jwasted.remove_wasted_bits(chans, cfg.bps)
    obits = obits - wasted_bits
    constant = jnp.all(chans == chans[..., :1], axis=-1)
    return chans, obits, wasted_bits, mode, constant


def _head_input(C: int, bps: int, n: int, seed: int) -> np.ndarray:
    """[F, n, C] frames: music-like, all-zero, constant, 15 wasted bits,
    channels equal (a side of zeros), channels of a tie between modes, a
    mid/side frame, and at 32 bits full-scale opposites (|l - r| >= 2^31,
    the side veto) and values whose side still fits."""
    rng = np.random.default_rng(seed)
    lim = 1 << (bps - 1)
    x = make_test_signal(12 * n, C, bps, seed=seed).reshape(12, n, C) \
        .astype(np.int64)
    x[1] = 0
    x[2] = 7 << 2
    x[3] = (x[3] >> 15) << 15           # at 16 bits bps - 1: wasted 0
    x[4] = rng.integers(-lim, lim, (n, 1))
    x[5, :, -1] = x[5, :, 0]
    if C == 2:
        x[6, :, 1] = x[6, :, 0] // 2 + 7
        x[7, :, 0], x[7, :, 1] = np.arange(n) * 3, np.arange(n) * 3 + 1
        x[8, :, 0], x[8, :, 1] = lim - 1, -lim
        x[9, :, 0] = lim - 1 - rng.integers(0, 8, n)
        x[9, :, 1] = -lim + rng.integers(0, 8, n)
        x[10, :, 1] = -x[10, :, 0] // 2
    return np.clip(x, -lim, lim - 1).astype(np.int32)


@pytest.mark.parametrize("C,bps,estimate", [(2, 16, True), (2, 32, True),
                                             (2, 24, False), (1, 24, True),
                                             (6, 16, True)])
def test_frame_head_matches_jax(C, bps, estimate):
    n = 96
    x = _head_input(C, bps, n, seed=C * 100 + bps)
    p = JP.set_defaults(8)
    p.stereo_method = int(estimate)
    jcfg = jframe.FrameConfig.from_params(p, C, bps, block_size=n)
    want = [np.asarray(v) for v in _jax_head(jnp.asarray(x), jcfg)]
    got = tframe.frame_head_plain(torch.from_numpy(x),
                                  TP.from_reference(jcfg))
    for name, w, g in zip(("chans", "obits", "wasted", "mode", "constant"),
                          want, got):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    modes = set(want[3].tolist())
    if C == 2 and estimate:
        assert len(modes) >= 3, modes
    assert want[4][1].all() and want[4][2].all()           # constant
    if bps > 16:
        assert want[2][3].max() == 15                      # wasted
    if bps == 32 and estimate:
        assert want[3][8] == jstereo.LEFT_RIGHT            # the veto


def test_frame_head_ties_to_the_first_mode():
    """Frames whose four mode estimates tie pick L+R, the first; the
    analysis dispatch gives the head's mode."""
    n = 64
    x = np.zeros((3, n, 2), np.int32)
    x[1, :, 0] = x[1, :, 1] = np.arange(n) % 5
    x[2, :, 0] = np.arange(n) % 3
    p = JP.set_defaults(5)
    jcfg = jframe.FrameConfig.from_params(p, 2, 16, block_size=n)
    want = [np.asarray(v) for v in _jax_head(jnp.asarray(x), jcfg)]
    tcfg = TP.from_reference(jcfg)
    got = tframe.frame_head_plain(torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    assert want[3][0] == jstereo.LEFT_RIGHT
    out = tframe.analyze_frames(torch.from_numpy(x), tcfg,
                                torch.full((3,), 48, dtype=torch.int32))
    np.testing.assert_array_equal(out["ch_mode"].numpy(), want[3])
    np.testing.assert_array_equal(out["wasted"].numpy(), want[2])


# -- E: the slot layout ------------------------------------------------------

def _slot_case(bps: int, n: int, F: int, seed: int):
    """The port's analysis of a batch at level 8 (LPC, full-scale noise
    that falls back to verbatim, a silent frame), with its header
    bytes."""
    cfg = jframe.FrameConfig.from_params(JP.set_defaults(8), 2, bps,
                                         block_size=n)
    frames = make_test_signal(F * n, 2, bps, seed=seed).reshape(F, n, 2)
    rng = np.random.default_rng(seed)
    lim = 1 << (bps - 1)
    frames[1] = rng.choice([-lim, lim - 1], (n, 2))      # verbatim
    frames[2] = 0
    nums = np.arange(F, dtype=np.int64) * 300
    hdr_bytes, hdr_nb = jbitpack.frame_header_bytes(
        nums, bs_code=JP.blocksize_code(n),
        sr_code=JP.samplerate_code(44100), allow_vbs=0)
    tcfg = TP.from_reference(cfg)
    analysis = tframe.analyze_frames(torch.from_numpy(frames), tcfg,
                                     torch.from_numpy(hdr_nb * 8))
    return cfg, tcfg, analysis, hdr_bytes, hdr_nb


@pytest.mark.parametrize("bps", [16, 24, 32])
def test_slot_layout_matches_jax(bps):
    cfg, tcfg, analysis, hdr_bytes, hdr_nb = _slot_case(bps, 1024, 4,
                                                        seed=bps)
    assert tbitpack._split_wide(tcfg) == (bps == 32)
    kinds = set(analysis["sf_type"].numpy().ravel().tolist())
    assert {0, 1, 32} <= kinds, kinds
    want = jax.jit(functools.partial(
        jbitpack.pack_frames_device, cfg=cfg, debug=True))(
        {k: jnp.asarray(v.numpy()) for k, v in analysis.items()},
        jnp.asarray(hdr_bytes), jnp.asarray(hdr_nb))
    got = tbitpack.slot_layout_plain(analysis, torch.from_numpy(hdr_bytes),
                                     torch.from_numpy(hdr_nb), tcfg)
    via = tbitpack.slot_layout(analysis, torch.from_numpy(hdr_bytes),
                               torch.from_numpy(hdr_nb), tcfg)
    for name, w, g, v in zip(("lengths", "leading", "payload"), want, got,
                             via):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(
            g.numpy().view(np.uint32) if name == "payload" else g.numpy(),
            np.asarray(w), err_msg=name)
        assert torch.equal(g, v)
    assert (got[0].sum(dim=-1) % 8 == 0).all()


# -- Z: the analysis' finalize -----------------------------------------------

_FIN_F, _FIN_C, _FIN_N, _FIN_BPS = 16, 2, 64, 32


@functools.lru_cache(maxsize=None)
def _jax_finalize(with_exact: bool):
    """The JAX package's ``finalize_analysis`` under one jit: one compile
    with the exact Rice bits (the predicted paths), one without
    (VERBATIM)."""
    cfg = jframe.FrameConfig.from_params(JP.set_defaults(8), _FIN_C,
                                         _FIN_BPS, block_size=_FIN_N)

    def run(chans, obits, wasted, constant, mode, sf_type, order, coefs,
            shift, res, rc, hdr_bits):
        return jframe.finalize_analysis(cfg, chans, obits, wasted, constant,
                                        mode, sf_type, order, coefs, shift,
                                        res, rc, hdr_bits)
    return cfg, jax.jit(run)


def _finalize_tables(path: str, overrides: tuple, seed: int) -> dict:
    """Made-up numpy inputs of the finalize at 16 frames of 64 32-bit stereo
    samples: CONSTANT rows, unfit rows (LPC) and frames over the verbatim
    bound, as ``overrides`` names them; residual rows unlike the
    samples."""
    F, C, n = _FIN_F, _FIN_C, _FIN_N
    rng = np.random.default_rng(seed)
    sf = {"lpc": 32, "fixed": 8, "verbatim": 1}[path]
    vbits = 8 * TP.max_frame_size(n, C, _FIN_BPS)
    share = np.where(rng.random(F) < 0.5, 1.3, 0.7) \
        if "oversize" in overrides else np.full(F, 0.3)
    t = {"chans": rng.integers(-2**31, 2**31, (F, C, n)),
         "obits": rng.integers(29, 34, (F, C)),
         "wasted": rng.integers(0, 4, (F, C)),
         "constant": (rng.random((F, C)) < 0.25) & ("constant" in overrides),
         "mode": rng.integers(0, 11, F),
         "sf_type": np.full((F, C), sf),
         "order": (rng.integers(1, 33, (F, C)) if path == "lpc"
                   else rng.integers(0, 5, (F, C)) if path == "fixed"
                   else np.zeros((F, C))),
         "coefs": rng.integers(-(1 << 14), 1 << 14, (F, C, 32)),
         "shift": rng.integers(0, 16, (F, C)),
         "porder": rng.integers(0, 7, (F, C)),
         "method": rng.integers(0, 2, (F, C)),
         "params": rng.integers(0, 31, (F, C, 64)),
         "hdr_bits": rng.integers(6, 17, F) * 8,
         "exact": (share[:, None] * vbits / C).astype(np.int64)
         + rng.integers(0, 40, (F, C)),
         "unfit": (rng.random((F, C)) < 0.25) & ("unfit" in overrides)}
    t = {k: v.astype(np.int64 if k == "exact" else bool
                     if k in ("constant", "unfit") else np.int32)
         for k, v in t.items()}
    t["res"] = t["chans"] if path == "verbatim" \
        else t["chans"] ^ rng.integers(1, 1 << 30, (F, C, n)).astype(np.int32)
    return t


def _finalize_args(t: dict, lib, exact: bool, unfit: bool):
    """The finalize's positional arguments from the tables, as ``lib``'s
    arrays (``torch.from_numpy`` or ``jnp.asarray``)."""
    rc = {k: lib(t[k]) for k in ("porder", "method", "params")}
    if exact:
        rc["exact_rice_bits"] = lib(t["exact"])
    args = [lib(t[k]) for k in ("chans", "obits", "wasted", "constant",
                                "mode", "sf_type", "order", "coefs",
                                "shift")]
    args += [args[0] if t["res"] is t["chans"] else lib(t["res"]), rc,
             lib(t["hdr_bits"])]
    return args + ([lib(t["unfit"])] if unfit else [])


@pytest.mark.parametrize("path,overrides", [
    ("lpc", ("constant",)), ("lpc", ("oversize",)), ("lpc", ("unfit",)),
    ("lpc", ("constant", "unfit", "oversize")),
    ("fixed", ("constant", "oversize")),
    ("verbatim", ("constant", "oversize"))])
def test_finalize_plain_matches_jax(path, overrides):
    """``finalize_analysis_plain`` against the JAX package's
    ``finalize_analysis`` on made-up tables that force each override: the
    CONSTANT rows, the frames over the verbatim bound (on the LPC, FIXED
    and VERBATIM paths, the last with ``res`` the samples and no exact
    bits), every key. The JAX package has no unfit flag: the port stores an
    unfit subframe verbatim, which JAX gives where the subframe comes in
    VERBATIM with the samples as its residual (here every unfit frame lies
    within the bound before the override, so the port takes each unfit row
    that is not CONSTANT)."""
    t = _finalize_tables(path, overrides, seed=len(path) + 7 * len(overrides))
    exact, unfit = path != "verbatim", path == "lpc"
    cfg, run = _jax_finalize(exact)
    got = tframe.finalize_analysis_plain(
        TP.from_reference(cfg), *_finalize_args(t, torch.from_numpy, exact,
                                                unfit))
    if unfit:
        u = t["unfit"] & ~t["constant"]
        t["sf_type"] = np.where(u, 1, t["sf_type"]).astype(np.int32)
        t["order"] = np.where(u, 0, t["order"]).astype(np.int32)
        t["res"] = np.where(u[..., None], t["chans"], t["res"])
    want = run(*_finalize_args(t, jnp.asarray, exact, False))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == (torch.int64 if k == "frame_bytes"
                                else torch.int32), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                      err_msg=k)
    kinds = got["sf_type"].numpy()
    if "constant" in overrides:
        assert (kinds == 0).any()
    if "oversize" in overrides or "unfit" in overrides:
        assert (kinds == 1).any() and (kinds != 1).any()


# -- every wrapper refuses a device it has no kernel for ---------------------

def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def test_wrappers_refuse_meta_tensors():
    cfg = TP.from_reference(jframe.FrameConfig.from_params(
        JP.set_defaults(8), 2, 16, block_size=64))
    with pytest.raises(ValueError, match="no kernel for meta"):
        tframe.select_order_bits(
            _meta(torch.zeros((4, 12), dtype=torch.int64)),
            int(JP.OrderMethod.LOG), 1, 12)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tframe.select_candidate(
            None, None, _meta(torch.zeros((4, 12, 12), dtype=torch.int32)),
            _meta(torch.zeros((4, 12), dtype=torch.int32)),
            int(JP.OrderMethod.MAX), 1, 12)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tframe.frame_head(_meta(torch.zeros((4, 64, 2), dtype=torch.int32)),
                          cfg)
    with pytest.raises(ValueError, match="no kernel for meta"):
        trice.fixed_search(_meta(torch.zeros((4, 2, 64), dtype=torch.int32)),
                           _meta(torch.zeros((4, 2), dtype=torch.int32)),
                           0, 4, 0, 3)
    _, tcfg, analysis, hdr_bytes, hdr_nb = _slot_case(16, 64, 3, seed=1)
    with pytest.raises(ValueError, match="no kernel for meta"):
        tbitpack.slot_layout({k: _meta(v) for k, v in analysis.items()},
                             _meta(torch.from_numpy(hdr_bytes)),
                             _meta(torch.from_numpy(hdr_nb)), tcfg)
    meta = [_meta(a) if isinstance(a, torch.Tensor) else
            {k: _meta(v) for k, v in a.items()} if isinstance(a, dict) else a
            for a in _finalize_args(_finalize_tables("lpc", ("constant",), 1),
                                    torch.from_numpy, True, True)]
    with pytest.raises(ValueError, match="no kernel for meta"):
        tframe.finalize_analysis(tcfg, *meta)
    assert all(fn.launches == 0 for fn in (
        tframe.select_order_bits, tframe.select_candidate, tframe.frame_head,
        trice.fixed_search, tbitpack.slot_layout, tframe.finalize_analysis))
