"""K2 and K4: the candidate-order sweep, CUDA kernels written for Hopper.

For every order 1..max_order, the LPC residual (int32 wrap), its zigzag
with the warm-up samples zeroed, and its sums over groups of samples.
The TPU kernels emitted 16-bit limbs; the port's kernels and their plain
versions emit exact int64 sums, which
:func:`flake_tpu_torch.ops.rice.subframe_bits_from_sums` consumes.

- K2, :func:`sweep_sums` (``flake_tpu_torch/csrc/sweep.cu``), replaces
  ``flake_tpu/ops/pallas_sweep3.py: sweep_partition_limbs3`` and sums per
  partition at ``pmax_static``.
- K4, :func:`sweep_granules` (``flake_tpu_torch/csrc/sweep_granules.cu``),
  replaces ``flake_tpu/ops/pallas_sweep.py: sweep_partition_limbs`` and
  sums per granule of ``min(psize, 128)`` samples.

:func:`v2_supports` and :func:`v3_supports` copy the JAX package's
predicates for its two kernels; :func:`uses_granule_kernel` sends a shape
to K4 exactly where ``analyze_frames`` under ``use_pallas="force"`` sends
it to the v2 kernel (``flake_tpu/ops/frame.py:413-437``).
"""

from __future__ import annotations

import torch

from flake_tpu_torch import _cuda
from flake_tpu_torch.ops import predict
from flake_tpu_torch.ops.rice import zigzag_u32

MAX_ORDER = 32
MAX_PMAX = 8
MAX_GRANULE = 128
LANE = 128


def v2_supports(block_size: int, bps: int, pmax_static: int) -> bool:
    """``flake_tpu/ops/pallas_sweep.py: supports`` (:49-67)."""
    if bps > 16:
        return False
    if block_size % 128 or block_size < 256 or block_size > 8192:
        return False
    psize = block_size >> pmax_static
    if psize * (1 << pmax_static) != block_size:
        return False
    if psize >= 128:
        return psize % 128 == 0
    return 128 % psize == 0 and psize >= 16


def v3_supports(block_size: int, bps: int, pmax_static: int,
                max_order: int) -> bool:
    """``flake_tpu/ops/pallas_sweep3.py: supports`` (:45-71), the TPU's
    VMEM estimate included: it is what refuses order 32 with 256
    partitions."""
    if bps > 16 or max_order > 32:
        return False
    psize = block_size >> pmax_static
    if psize * (1 << pmax_static) != block_size:
        return False
    if psize % 8 != 0 or psize < 8:
        return False
    halo = -(-max(max_order, 1) // 8) * 8
    parts = 1 << pmax_static
    ppc = max(1, min(parts, 1024 // psize))
    while parts % ppc:
        ppc -= 1
    chunk = ppc * psize
    est = (2 * (halo + block_size) * LANE * 4
           + 4 * max_order * parts * LANE * 4
           + 4 * max_order * max_order * LANE * 4
           + 6 * chunk * LANE * 4)
    return est <= 15 * 1024 * 1024


def uses_granule_kernel(block_size: int, bps: int, pmax_static: int,
                        max_order: int) -> bool:
    """Whether the sweep of this shape goes to K4 (else K2)."""
    return (v2_supports(block_size, bps, pmax_static)
            and not v3_supports(block_size, bps, pmax_static, max_order))


def granule_size(block_size: int, pmax_static: int) -> int:
    """K4's summing granularity, ``min(psize, 128)``."""
    return min(block_size >> pmax_static, MAX_GRANULE)


def granule_fits(block_size: int, pmax_static: int) -> bool:
    """Whether K4 can sum this shape: whole partitions, and a granule that
    is a power of two from 4 to 128 dividing the partition size (wider
    than the v2 kernel's domain, which needs psize >= 16)."""
    if not 0 <= pmax_static <= MAX_PMAX or block_size % (1 << pmax_static):
        return False
    gs = granule_size(block_size, pmax_static)
    return gs >= 4 and not gs & (gs - 1) \
        and (block_size >> pmax_static) % gs == 0


def _zigzag_sums(x, coefs, shifts, max_order: int, size: int):
    """Plain PyTorch: one residual pass per order, summed over groups of
    ``size`` samples. int64 [N, max_order, B // size]."""
    N, B = x.shape
    idx = torch.arange(B, device=x.device)
    out = []
    for o in range(1, max_order + 1):
        r = predict.residual_lpc(x, coefs[:, o - 1, :], shifts[:, o - 1], o)
        z = torch.where(idx >= o, zigzag_u32(r), 0)
        out.append(z.reshape(N, B // size, size).sum(dim=-1))
    return torch.stack(out, dim=1)


def sweep_sums_plain(x: torch.Tensor, coefs: torch.Tensor,
                     shifts: torch.Tensor, max_order: int,
                     pmax_static: int) -> torch.Tensor:
    """K2's plain version: sums per partition."""
    return _zigzag_sums(x, coefs, shifts, max_order,
                        x.shape[1] >> pmax_static)


def sweep_granules_plain(x: torch.Tensor, coefs: torch.Tensor,
                         shifts: torch.Tensor, max_order: int,
                         pmax_static: int) -> torch.Tensor:
    """K4's plain version: sums per granule of ``min(psize, 128)``."""
    return _zigzag_sums(x, coefs, shifts, max_order,
                        granule_size(x.shape[1], pmax_static))


def _check_inputs(name, x, coefs, shifts, max_order):
    N, B = x.shape
    _cuda.check(x, "x", torch.int32, (N, B), x.device)
    _cuda.check(coefs, "coefs", torch.int32, (N, max_order, max_order),
                x.device)
    _cuda.check(shifts, "shifts", torch.int32, (N, max_order), x.device)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")


def sweep_sums(x: torch.Tensor, coefs: torch.Tensor, shifts: torch.Tensor,
               max_order: int, pmax_static: int) -> torch.Tensor:
    """Partition sums of every candidate order's zigzag residual (K2).

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
    _check_inputs("sweep_sums", x, coefs, shifts, max_order)
    N, B = x.shape
    out = torch.empty((N, max_order, 1 << pmax_static), dtype=torch.int64,
                      device=x.device)
    _cuda.launch("flake_sweep_sums", x.device, x, coefs, shifts, out, N, B,
                 max_order, pmax_static)
    sweep_sums.launches += 1
    return out


sweep_sums.launches = 0


def sweep_granules(x: torch.Tensor, coefs: torch.Tensor,
                   shifts: torch.Tensor, max_order: int,
                   pmax_static: int) -> torch.Tensor:
    """Granule sums of every candidate order's zigzag residual (K4).

    Inputs as :func:`sweep_sums`. Returns int64 [N, max_order, B // gs]
    with gs = ``min(B >> pmax_static, 128)``; the shape must pass
    :func:`granule_fits` (every shape of the v2 kernel's domain does). A
    CPU tensor takes the plain version; a CUDA tensor launches the
    kernel."""
    if x.dim() != 2 or not 1 <= max_order <= MAX_ORDER \
            or not granule_fits(x.shape[1], pmax_static) \
            or x.shape[0] >= 65536:
        raise ValueError(f"sweep_granules: bad shape {tuple(x.shape)}, "
                         f"order {max_order} or pmax {pmax_static}")
    if x.device.type == "cpu":
        return sweep_granules_plain(x, coefs, shifts, max_order,
                                    pmax_static)
    _check_inputs("sweep_granules", x, coefs, shifts, max_order)
    N, B = x.shape
    gs = granule_size(B, pmax_static)
    out = torch.empty((N, max_order, B // gs), dtype=torch.int64,
                      device=x.device)
    _cuda.launch("flake_sweep_granules", x.device, x, coefs, shifts, out, N,
                 B, max_order, gs.bit_length() - 1)
    sweep_granules.launches += 1
    return out


sweep_granules.launches = 0
