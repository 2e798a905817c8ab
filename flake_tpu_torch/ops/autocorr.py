"""K1: Welch-windowed autocorrelation, a CUDA kernel written for Hopper.

Replaces the TPU kernel ``flake_tpu/ops/pallas_autocorr.py:
autocorr_dd_pallas`` (``_autocorr_kernel``). The kernel source is
``flake_tpu_torch/csrc/autocorr.cu``; its plain PyTorch version is
:func:`flake_tpu_torch.ops.lpc.autocorr`. Unlike the TPU kernel, both
return the reference's +2.0 bias per lag.
"""

from __future__ import annotations

import torch

from flake_tpu_torch import _cuda
from flake_tpu_torch.ops import lpc

MAX_ORDER = 32


def autocorr(x: torch.Tensor, window: torch.Tensor,
             max_order: int) -> torch.Tensor:
    """Autocorrelation of each stream for lags 0..max_order, plus 2.0.

    x int32 [N, B]; window float64 [B]. Returns float64
    [N, max_order + 1]. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel."""
    if x.device.type == "cpu":
        return lpc.autocorr(x, max_order, window)
    if x.device.type != "cuda":
        raise ValueError(f"autocorr: no kernel for {x.device}")
    if not 0 <= max_order <= MAX_ORDER or x.dim() != 2:
        raise ValueError(f"autocorr: bad max_order {max_order} or shape "
                         f"{tuple(x.shape)}")
    N, B = x.shape
    _cuda.check(x, "x", torch.int32, (N, B), x.device)
    _cuda.check(window, "window", torch.float64, (B,), x.device)
    out = torch.empty((N, max_order + 1), dtype=torch.float64,
                      device=x.device)
    _cuda.launch("flake_autocorr", x.device, x, window, out, N, B,
                 max_order)
    autocorr.launches += 1
    return out


autocorr.launches = 0
