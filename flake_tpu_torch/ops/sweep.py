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
predicates for its two kernels, held equal to them by the tests;
:func:`uses_granule_kernel` sends every shape K4 can sum to K4, which was
the faster of the two on the card there (the TPU's choice, the v2 kernel
wherever the v3 kernel's VMEM estimate refused a shape, is not the
H100's). K2's split of a stream over threads and blocks is
:func:`sweep_plan`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flake_tpu_torch import _cuda
from flake_tpu_torch.ops import predict
from flake_tpu_torch.ops.rice import zigzag_u32

MAX_ORDER = 32
MAX_PMAX = 8
MAX_GRANULE = 128
LANE = 128
# K2's split plan: threads a block (csrc/sweep.cu: kThreads), the segment
# lengths it tries, longest first, and the threads a launch should reach
# (132 SMs x 1024) before it stops shortening them
SWEEP_THREADS = 128
SWEEP_SEGMENTS = (32, 16, 8, 4)
SWEEP_FILL = 132 * 1024
SWEEP_ORDER_BUCKETS = (12, 32)    # the kernel's instantiations


class SweepPlan(NamedTuple):
    """How K2 splits a stream: every partition into ``spp`` segments of at
    most ``seg`` samples, one a thread, which reads the ``bucket`` samples
    before its segment as its halo; ``ppb`` whole partitions a block of
    :data:`SWEEP_THREADS`; ``blocks`` blocks a stream. ``bucket`` is the
    kernel's compile-time order, the least of
    :data:`SWEEP_ORDER_BUCKETS` that holds ``max_order``."""
    seg: int
    spp: int
    ppb: int
    blocks: int
    bucket: int


def sweep_plan(N: int, B: int, max_order: int,
               pmax_static: int) -> SweepPlan:
    """K2's split plan for N streams of B samples in 2^pmax_static
    partitions: the longest segment (a multiple of 4, or the whole
    partition) that still gives N * partitions * spp threads to fill the
    card, else the shortest; never more segments a partition than a block
    has threads."""
    psize, parts = B >> pmax_static, 1 << pmax_static
    least = -(-psize // SWEEP_THREADS)
    least = -(-least // 4) * 4
    for longest in SWEEP_SEGMENTS:
        seg = min(max(longest, least), psize)
        spp = -(-psize // seg)
        if N * parts * spp >= SWEEP_FILL:
            break
    ppb = SWEEP_THREADS // spp
    bucket = next(b for b in SWEEP_ORDER_BUCKETS if b >= max_order)
    return SweepPlan(seg, spp, ppb, -(-parts // ppb), bucket)


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


def uses_granule_kernel(block_size: int, pmax_static: int) -> bool:
    """Whether the sweep of this shape goes to K4 (else K2): every shape K4
    can sum (:func:`granule_fits`), where it was the faster of the two on
    an H100 (``PERF.md`` §6, the route table: order 8 at level 7, order 12
    at levels 8-10, order 32 at levels 11-12; within 5% of K2 only on
    launches of a few dozen streams). K2 takes the rest: sub-blocks whose
    partitions hold no power-of-two granule (3072, 5120, 6144, 7168) and
    most partial last blocks. Both give the same sums, so the route moves
    no byte."""
    return granule_fits(block_size, pmax_static)


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
                 max_order, pmax_static,
                 *sweep_plan(N, B, max_order, pmax_static))
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
    kernel, which sums on the FP64 pipe: exact for coefficients below
    2^14 in magnitude and shifts of 0-15, which is what
    :func:`flake_tpu_torch.ops.lpc.quantize_lpc_coefs` gives at the
    encoder's 15-bit precision."""
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
