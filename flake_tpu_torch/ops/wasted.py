"""Batched wasted-bits detection and removal (port of
``flake_tpu/ops/wasted.py``, encode.c:558-593).

The minimum trailing-zero count over a block's samples equals the
trailing-zero count of their OR; the all-zero block is the case with no
set bit.
"""

from __future__ import annotations

import torch

from flake_tpu_torch.ops.common import ctz32


def trailing_zeros(samples: torch.Tensor) -> torch.Tensor:
    """The fewest trailing zeros over the last axis, 32 where every sample
    is 0: the trailing-zero count of the samples' OR. int32 [...]."""
    return torch.where(samples != 0, ctz32(samples), 32).amin(dim=-1)


def wasted_from_zeros(tz: torch.Tensor, bps: int) -> torch.Tensor:
    """The reference's wasted-bit count from :func:`trailing_zeros`: capped
    at bps-1, and a result of exactly bps-1 (the all-zero block included)
    collapses to 0 (encode.c:570-585). int32 [...]."""
    wasted = torch.where(tz == 32, bps - 1, torch.clamp(tz, max=bps - 1))
    return torch.where(wasted == bps - 1, 0, wasted).to(torch.int32)


def remove_wasted_bits(samples: torch.Tensor, bps: int):
    """samples int32 [..., B]. Returns (shifted samples, wasted int32
    [...])."""
    wasted = wasted_from_zeros(trailing_zeros(samples), bps)
    return samples >> wasted[..., None], wasted
