"""K2: the candidate-order sweep, a CUDA kernel written for Hopper.

Replaces the TPU kernel ``flake_tpu/ops/pallas_sweep3.py:
sweep_partition_limbs3`` (``_sweep3_kernel``): for every order
1..max_order, the LPC residual (int32 wrap), its zigzag with the warm-up
samples zeroed, and the sums per partition at ``pmax_static``. The TPU
kernel emitted 16-bit limbs; the port's kernel
(``flake_tpu_torch/csrc/sweep.cu``) and :func:`sweep_sums_plain` emit
exact int64 sums, which
:func:`flake_tpu_torch.ops.rice.subframe_bits_from_sums` consumes.
"""

from __future__ import annotations

import torch

from flake_tpu_torch import _cuda
from flake_tpu_torch.ops import predict
from flake_tpu_torch.ops.rice import zigzag_u32

MAX_ORDER = 32
MAX_PMAX = 8


def sweep_sums_plain(x: torch.Tensor, coefs: torch.Tensor,
                     shifts: torch.Tensor, max_order: int,
                     pmax_static: int) -> torch.Tensor:
    """Plain PyTorch version: one residual pass per order."""
    N, B = x.shape
    parts = 1 << pmax_static
    idx = torch.arange(B, device=x.device)
    out = []
    for o in range(1, max_order + 1):
        r = predict.residual_lpc(x, coefs[:, o - 1, :], shifts[:, o - 1], o)
        z = torch.where(idx >= o, zigzag_u32(r), 0)
        out.append(z.reshape(N, parts, B // parts).sum(dim=-1))
    return torch.stack(out, dim=1)


def sweep_sums(x: torch.Tensor, coefs: torch.Tensor, shifts: torch.Tensor,
               max_order: int, pmax_static: int) -> torch.Tensor:
    """Partition sums of every candidate order's zigzag residual.

    x int32 [N, B]; coefs int32 [N, max_order, max_order] (row o-1 holds
    order o's taps, zero beyond); shifts int32 [N, max_order]. Returns
    int64 [N, max_order, 2^pmax_static]; B must be a multiple of
    2^pmax_static. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    if x.dim() != 2 or not 1 <= max_order <= MAX_ORDER \
            or not 0 <= pmax_static <= MAX_PMAX \
            or x.shape[1] % (1 << pmax_static):
        raise ValueError(f"sweep_sums: bad shape {tuple(x.shape)}, order "
                         f"{max_order} or pmax {pmax_static}")
    if x.device.type == "cpu":
        return sweep_sums_plain(x, coefs, shifts, max_order, pmax_static)
    if x.device.type != "cuda":
        raise ValueError(f"sweep_sums: no kernel for {x.device}")
    N, B = x.shape
    _cuda.check(x, "x", torch.int32, (N, B), x.device)
    _cuda.check(coefs, "coefs", torch.int32, (N, max_order, max_order),
                x.device)
    _cuda.check(shifts, "shifts", torch.int32, (N, max_order), x.device)
    out = torch.empty((N, max_order, 1 << pmax_static), dtype=torch.int64,
                      device=x.device)
    _cuda.launch("flake_sweep_sums", x.device, x, coefs, shifts, out, N, B,
                 max_order, pmax_static)
    sweep_sums.launches += 1
    return out


sweep_sums.launches = 0
