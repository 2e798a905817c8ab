"""K4's plain version, its route and SEARCH ties against the JAX package.

The port's int64 granule sums must equal the Pallas v2 sweep's 16-bit
limb sums recombined (interpret mode) at every granule size the kernel
emits, including a partition larger than its 128-sample granule; the
port's copies of the two Pallas predicates must agree with the JAX
package's; the shape alone must send the level-11/12 sub-blocks of 1024,
2048, 4096 and 8192 samples to K4 and every other preset's shapes to K2;
and ``analyze_frames`` routed through K4 must equal
``analyze_frames_jit`` key by key. Everything is integer, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flake_tpu import params as JP
from flake_tpu.ops import pallas_sweep, pallas_sweep3
from flake_tpu.ops.frame import FrameConfig, analyze_frames_jit

from flake_tpu_torch import params as TP
from flake_tpu_torch.ops import frame as tframe
from flake_tpu_torch.ops import lpc as tlpc
from flake_tpu_torch.ops import rice as trice
from flake_tpu_torch.ops import sweep as tsweep

from conftest import make_test_signal


def _inputs(N, B, max_order, seed):
    """16-bit streams (one of them noise) and their quantized LPC
    coefficients through the port's Levinson."""
    x = make_test_signal(B, channels=N, seed=seed).T.copy()
    x[0] = np.random.default_rng(seed).integers(-32768, 32768, B)
    xt = torch.from_numpy(x)
    autoc = tlpc.autocorr(xt, max_order,
                          tlpc.welch_window_on(B, torch.device("cpu")))
    rows, _ = tlpc.levinson_all_orders(autoc)
    qc, sh = tlpc.quantize_lpc_coefs(rows, 15)
    return xt, qc.contiguous(), sh.contiguous()


@pytest.mark.parametrize("B,max_order,pmax_static", [
    (1024, 8, 6),     # psize 16 = gs
    (1024, 8, 5),     # psize 32 = gs
    (512, 6, 2),      # psize 128 = gs
    (1024, 8, 2),     # psize 256 > gs = 128
])
def test_plain_granules_match_pallas_limbs(B, max_order, pmax_static):
    x, qc, sh = _inputs(4, B, max_order, seed=B + pmax_static)
    lo, hi = pallas_sweep.sweep_partition_limbs(
        jnp.asarray(x.numpy()), jnp.asarray(qc.numpy()),
        jnp.asarray(sh.numpy()), max_order=max_order,
        pmax_static=pmax_static, interpret=True)
    want = np.asarray(lo).astype(np.uint64) \
        + (np.asarray(hi).astype(np.uint64) << 16)
    got = tsweep.sweep_granules(x, qc, sh, max_order, pmax_static)
    gs = min(B >> pmax_static, 128)
    assert got.dtype == torch.int64
    assert tuple(got.shape) == (4, max_order, B // gs)
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)
    # folded to partitions, the granules are K2's plain partition sums
    parts = 1 << pmax_static
    np.testing.assert_array_equal(
        got.reshape(4, max_order, parts, -1).sum(-1).numpy(),
        tsweep.sweep_sums_plain(x, qc, sh, max_order, pmax_static).numpy())


def test_bits_from_granules_fold_like_partitions():
    """Granules finer than the partitions fold to the same bit counts."""
    B, max_order, pmax, N = 1024, 8, 2, 4
    x, qc, sh = _inputs(N, B, max_order, seed=11)
    orders = torch.arange(1, max_order + 1, dtype=torch.int32) \
        .expand(N, max_order)
    obits = torch.full((N, 1), 17, dtype=torch.int32)
    args = (B, orders, obits, 0, pmax, 15, True)
    fine = trice.subframe_bits_from_sums(
        tsweep.sweep_granules(x, qc, sh, max_order, pmax), *args)
    coarse = trice.subframe_bits_from_sums(
        tsweep.sweep_sums(x, qc, sh, max_order, pmax), *args)
    assert torch.equal(fine, coarse)


def test_wrapper_checks_shapes_and_devices():
    x, qc, sh = _inputs(2, 1024, 8, seed=5)
    with pytest.raises(ValueError):       # pmax 9: outside K4's domain
        tsweep.sweep_granules(x, qc, sh, 8, 9)
    x3, qc3, sh3 = _inputs(2, 3072, 8, seed=6)
    with pytest.raises(ValueError):       # 12-sample granules
        tsweep.sweep_granules(x3, qc3, sh3, 8, 8)
    assert [tsweep.granule_fits(B, 8) for B in (1024, 2048, 3072, 8192)] \
        == [True, True, False, True]
    with pytest.raises(ValueError):       # neither CPU nor CUDA
        tsweep.sweep_granules(x.to("meta"), qc.to("meta"), sh.to("meta"),
                              8, 6)


def test_predicates_match_jax():
    cases = 0
    for B in (128, 256, 384, 512, 1024, 1152, 2048, 3072, 4096, 4608,
              8192, 16384):
        for bps in (16, 24):
            for pmax_static in range(9):
                assert tsweep.v2_supports(B, bps, pmax_static) \
                    == pallas_sweep.supports(B, bps, pmax_static), \
                    (B, bps, pmax_static)
                for order in (1, 8, 12, 32):
                    assert tsweep.v3_supports(B, bps, pmax_static, order) \
                        == pallas_sweep3.supports(B, bps, pmax_static,
                                                  order), \
                        (B, bps, pmax_static, order)
                    cases += 1
    assert cases == 12 * 2 * 9 * 4


@pytest.mark.parametrize("level", [7, 8, 9, 10, 11, 12])
def test_route_by_shape(level):
    """Every sub-block size of a preset, at its pmax_static: K4 exactly
    for the blocks it can sum, where it was faster than K2 on the card
    (the full 4096-sample blocks of levels 7-8, the 1024, 2048 and 4096
    sub-blocks of levels 9-10 and also the 8192 ones of levels 11-12),
    K2 for the rest (512, 1536, 2560, 3072, 3584 and 5120-7168)."""
    p = TP.set_defaults(level)
    bs = p.block_size
    sizes = [bs * k // 8 for k in range(1, 9)] if p.variable_block_size \
        else [bs]
    to_k4 = set()
    for n in sizes:
        pmax_static = trice.limit_max_partition_order(
            p.max_partition_order, n, 1)
        if tsweep.uses_granule_kernel(n, pmax_static):
            to_k4.add(n)
    assert to_k4 == ({4096} if level <= 8 else {1024, 2048, 4096}
                     if level <= 10 else {1024, 2048, 4096, 8192})


@pytest.mark.parametrize("pmax", [6, 2])
def test_analyze_frames_through_k4_matches_jax(monkeypatch, pmax):
    """The whole analysis with the sweep routed to K4 (pmax 2 folds
    128-sample granules into 256-sample partitions)."""
    F, B = 4, 1024
    frames = make_test_signal(F * B, 2, 16, seed=pmax).reshape(F, B, 2)
    frames[1] = np.random.default_rng(pmax).integers(-32768, 32768, (B, 2))
    frames[2, :, 1] = frames[2, :, 0] // 2 + 7             # mid/side
    p = JP.set_defaults(12)
    p.block_size = B
    p.max_prediction_order = 8
    p.max_partition_order = pmax
    cfg = FrameConfig.from_params(p, 2, 16, block_size=B)
    hdr = np.full(F, 56, np.int32)
    want = analyze_frames_jit(jnp.asarray(frames), cfg, jnp.asarray(hdr))

    calls = []

    def granules(*args):
        calls.append(args[0].shape)
        return tsweep.sweep_granules(*args)

    monkeypatch.setattr(tframe, "uses_granule_kernel", lambda *a: True)
    monkeypatch.setattr(tframe, "sweep_granules", granules)
    got = tframe.analyze_frames(torch.from_numpy(frames),
                                TP.from_reference(cfg), torch.from_numpy(hdr))
    assert calls == [(F * 2, B)]
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(w),
                                      err_msg=key)


def test_search_picks_the_lowest_order_on_ties():
    """SEARCH is an argmin: on equal bit counts the lowest order wins, as
    ``jnp.argmin`` picks it (``flake_tpu/ops/frame.py:181``)."""
    rng = np.random.default_rng(3)
    bits = rng.integers(100, 104, (64, 12)).astype(np.int64)
    bits[0] = 7                                           # all tied
    bits[1, [2, 9]] = 50                                  # two minima
    p = JP.set_defaults(10)
    cfg = TP.from_reference(FrameConfig.from_params(p, 2, 16))
    got = tframe.select_order(cfg, torch.from_numpy(bits), None, (64,),
                              torch.device("cpu"))
    want = np.asarray(jnp.argmin(jnp.asarray(bits), axis=-1)) + 1
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 1 and got[1] == 3


@pytest.mark.parametrize("level", [7, 8, 10, 12])
def test_quantized_coefs_fit_the_fp64_kernel(level):
    """K4 sums its products as float64 FMAs, exact only for |coef| < 2^14
    and shifts of 0-15 (``csrc/sweep_granules.cu``), and its wrapper does
    not check them. The encoder's frame configuration and
    ``quantize_lpc_coefs`` at its precision must stay inside that range for
    coefficient rows of every magnitude, so that a change of precision
    fails here and not in the sums."""
    cfg = tframe.FrameConfig.from_params(TP.set_defaults(level), 2, 16)
    assert cfg.precision == TP.LPC_PRECISION <= 15
    rng = np.random.default_rng(level)
    mag = 10.0 ** rng.uniform(-9, 9, (256, 32, 1))
    rows = torch.from_numpy(rng.standard_normal((256, 32, 32)) * mag)
    rows[0] = 0.0
    rows[1, :, 0] = 1e12
    qc, sh = tlpc.quantize_lpc_coefs(rows, cfg.precision)
    assert int(qc.abs().max()) < 1 << 14
    assert int(sh.min()) >= 0 and int(sh.max()) <= 15

