"""The operands E and L are launched with, built on the CPU.

``bitpack.slot_operands`` and ``lpc.candidates_operands`` check a batch
and allocate the outputs that E (``csrc/slots.cu``) and L (``csrc/lpc.cu``)
write; the wrappers and the first designs timed beside the kernels in
``chip_smoke.py`` take them as they are. Here they run on CPU tensors: the
tables' shapes must be the plain versions', the outputs int32 (refs in
the lags' dtype), contiguous and on a 16-byte boundary (the kernels' int4
stores), the ints the entry points' order, and what the kernels do not
take must raise. No JAX.
"""

import numpy as np
import pytest
import torch

from flake_tpu_torch import params as P
from flake_tpu_torch.ops import bitpack, frame, lpc, rice


def _analysis(F, C, n, bps, level, rp_extra=3, seed=0):
    """A made-up analysis of int32 CPU tables, every subframe type."""
    rng = np.random.default_rng(seed)
    cfg = frame.FrameConfig.from_params(P.set_defaults(level), C, bps,
                                        block_size=n)
    ps = rice.limit_max_partition_order(cfg.max_partition_order, n, 1)
    kinds = np.array([frame.SF_CONSTANT, frame.SF_VERBATIM, frame.SF_FIXED,
                      frame.SF_LPC])
    table = {
        "sf_type": kinds[rng.integers(0, 4, (F, C))],
        "order": rng.integers(0, 5, (F, C)),
        "obits": rng.integers(1, bps + 1, (F, C)),
        "wasted": rng.integers(0, 3, (F, C)),
        "method": rng.integers(0, 2, (F, C)),
        "porder": rng.integers(0, ps + 1, (F, C)),
        "type_code": rng.integers(0, 64, (F, C)),
        "shift": rng.integers(0, 16, (F, C)),
        "coefs": rng.integers(-100, 100, (F, C, P.MAX_LPC_ORDER)),
        "rice_params": rng.integers(0, 15, (F, C, (1 << ps) + rp_extra)),
        "residual": rng.integers(-1000, 1000, (F, C, n)),
        "ch_mode": rng.integers(0, 4, F)}
    analysis = {k: torch.from_numpy(np.asarray(v).astype(np.int32))
                for k, v in table.items()}
    hb = torch.from_numpy(rng.integers(0, 256, (F, bitpack.HDR_SLOTS))
                          .astype(np.uint8))
    hn = torch.from_numpy(rng.integers(6, 17, F).astype(np.int32))
    return analysis, hb, hn, cfg, ps


@pytest.mark.parametrize("F,C,n,bps,level", [
    (2, 2, 4096, 16, 8), (1, 2, 1024, 32, 12), (3, 8, 256, 24, 12),
    (2, 1, 777, 16, 5), (4, 2, 20, 16, 8)])
def test_slot_operands(F, C, n, bps, level):
    """E's outputs have the plain version's table shape; the ints are F,
    n, C, ps, rp, wide, precision and the bps code."""
    analysis, hb, hn, cfg, ps = _analysis(F, C, n, bps, level)
    ins, outs, ints = bitpack.slot_operands(analysis, hb, hn, cfg)
    want = bitpack.slot_layout_plain(analysis, hb, hn, cfg)
    assert len(ins) == 14 and len(outs) == 3
    for got, table in zip(outs, want):
        assert got.shape == table.shape and got.dtype == torch.int32
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert ints == (F, n, C, ps, (1 << ps) + 3, int(bitpack._split_wide(cfg)),
                    cfg.precision, P.bps_code(bps))


def test_slot_operands_refuse():
    """Fewer Rice parameters than groups, or a table of another dtype."""
    analysis, hb, hn, cfg, ps = _analysis(2, 2, 4096, 16, 8, rp_extra=0)
    analysis["rice_params"] = analysis["rice_params"][..., :(1 << ps) - 1]
    with pytest.raises(ValueError, match="Rice parameters"):
        bitpack.slot_operands(analysis, hb, hn, cfg)
    analysis, hb, hn, cfg, _ = _analysis(2, 2, 4096, 16, 8)
    analysis["order"] = analysis["order"].to(torch.int64)
    with pytest.raises(ValueError, match="order"):
        bitpack.slot_operands(analysis, hb, hn, cfg)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("est", [False, True])
def test_candidates_operands(dtype, est):
    """A strided [2, 3, 13] batch becomes one contiguous [6, 13] input;
    the outputs are [6, 12, 12] and [6, 12] int32 and refs [6, 12] in the
    lags' dtype; the ints are N, m, precision, est and float64."""
    autoc = torch.rand((2, 3, 26), dtype=dtype)[..., ::2]
    ins, outs, ints, batch = lpc.candidates_operands(autoc, est, 15)
    assert len(ins) == 1 and ins[0].shape == (6, 13)
    assert ins[0].is_contiguous() and torch.equal(ins[0].reshape(2, 3, 13),
                                                  autoc)
    qcoefs, shifts, refs = outs
    assert qcoefs.shape == (6, 12, 12) and qcoefs.dtype == torch.int32
    assert qcoefs.data_ptr() % 16 == 0
    assert shifts.shape == (6, 12) and shifts.dtype == torch.int32
    assert refs.shape == (6, 12) and refs.dtype == dtype
    assert ints == (6, 12, 15, int(est), int(dtype == torch.float64))
    assert batch == (2, 3)


@pytest.mark.parametrize("shape,dtype,precision,match", [
    ((4, 13), torch.int32, 15, "int32"), ((4, 34), torch.float64, 15,
                                          "max order"),
    ((4, 1), torch.float64, 15, "max order"),
    ((4, 13), torch.float64, 1, "precision"),
    ((4, 13), torch.float32, 17, "precision")])
def test_candidates_operands_refuse(shape, dtype, precision, match):
    """Integer lags, max orders 33 and 0, precisions 1 and 17."""
    with pytest.raises(ValueError, match=match):
        lpc.candidates_operands(torch.ones(shape, dtype=dtype), False,
                                precision)
