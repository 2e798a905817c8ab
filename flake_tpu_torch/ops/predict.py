"""Batched residuals: fixed predictors and quantized LPC (port of
``flake_tpu/ops/predict.py``, optimize.c:34-122).

Predictions accumulate in int64, are arithmetic-shifted, and the residual
wraps to int32 like the reference's C cast. The JAX package's ``narrow``
coefficient-limb split (an int32 economy for the TPU) is gone. Warm-up
samples pass through as-is (optimize.c:77-79).
:func:`residual_lpc_dynamic64` returns the exact residual before the wrap:
where it leaves int32 (32-bit input) and the prediction is shifted, the
wrapped one decodes to other samples, so the analysis stores that subframe
verbatim (:func:`fits_int32`).
"""

from __future__ import annotations

import torch

from flake_tpu_torch.ops.common import wrap_int32

# binomial coefficients of the fixed predictors, orders 1-4
# (optimize.c:45-66); coef[j] applies to smp[i-1-j]
FIXED_COEFS = {
    0: (),
    1: (1,),
    2: (2, -1),
    3: (3, -3, 1),
    4: (4, -6, 4, -1),
}


def _lagged(s: torch.Tensor, j: int, order: int, n: int) -> torch.Tensor:
    """s[..., order-1-j : n-1-j]: the lag-(j+1) window aligned to
    positions order..n."""
    return s[..., order - 1 - j:n - 1 - j]


def residual_fixed(smp: torch.Tensor, order: int) -> torch.Tensor:
    """Fixed-predictor residual (optimize.c:34-68), int32 [..., B]."""
    n = smp.shape[-1]
    if order == 0:
        return smp
    s = smp.to(torch.int64)
    pred = torch.zeros_like(s[..., order:])
    for j, c in enumerate(FIXED_COEFS[order]):
        pred = pred + c * _lagged(s, j, order, n)
    return torch.cat([smp[..., :order], wrap_int32(s[..., order:] - pred)],
                     dim=-1)


_fixed_tables: dict = {}


def fixed_coefs(order: torch.Tensor, max_order: int) -> torch.Tensor:
    """Each element's fixed predictor as LPC coefficients: FIXED_COEFS of
    its ``order`` (int32 [...], 0..max_order <= 4), zero-padded, int32
    [..., max_order]; with shift 0 the LPC residual is the fixed one. The
    table is built once a device and width, so no call copies it from the
    host."""
    key = (order.device, max_order)
    table = _fixed_tables.get(key)
    if table is None:
        table = torch.tensor([list(FIXED_COEFS[o]) + [0] * (max_order - o)
                              for o in range(max_order + 1)],
                             dtype=torch.int32).reshape(max_order + 1,
                                                        max_order)
        table = _fixed_tables.setdefault(key, table.to(order.device))
    return table[order.long()]


def fits_int32(res64: torch.Tensor) -> torch.Tensor:
    """Whether every exact residual of a subframe fits int32, so that its
    wrapped form decodes to the samples. bool [...]."""
    return ((res64 >= -(1 << 31)) & (res64 < (1 << 31))).all(dim=-1)


def residual_lpc(smp: torch.Tensor, coefs: torch.Tensor,
                 shift: torch.Tensor, order: int) -> torch.Tensor:
    """Quantized-LPC residual for one static order (optimize.c:70-122).
    ``coefs`` int32 [..., >=order] (taps beyond order ignored),
    ``shift`` int32 [...]."""
    n = smp.shape[-1]
    s = smp.to(torch.int64)
    pred = torch.zeros_like(s[..., order:])
    for j in range(order):
        pred = pred + coefs[..., j, None].to(torch.int64) \
            * _lagged(s, j, order, n)
    pred = pred >> shift[..., None].to(torch.int64)
    return torch.cat([smp[..., :order], wrap_int32(s[..., order:] - pred)],
                     dim=-1)


def residual_lpc_dynamic64(smp: torch.Tensor, coefs: torch.Tensor,
                           shift: torch.Tensor, order: torch.Tensor,
                           max_order: int) -> torch.Tensor:
    """Exact LPC residual with a per-element ``order`` (int32 [...]): taps
    j >= order contribute zero and positions i < order keep the sample —
    the batched re-encode of the selected order (optimize.c:273). int64
    [..., B]."""
    n = smp.shape[-1]
    s = smp.to(torch.int64)
    order_b = order[..., None].to(torch.int64)
    pred = torch.zeros_like(s)
    for j in range(max_order):
        lag = torch.nn.functional.pad(s, (j + 1, 0))[..., :n]
        tap = torch.where(j < order_b, coefs[..., j, None].to(torch.int64),
                          0)
        pred = pred + tap * lag
    pred = pred >> shift[..., None].to(torch.int64)
    idx = torch.arange(n, device=smp.device)
    return torch.where(idx < order_b, s, s - pred)
