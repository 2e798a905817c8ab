"""Batched wasted-bits detection and removal (port of
``flake_tpu/ops/wasted.py``, encode.c:558-593).

The minimum trailing-zero count over a block's samples equals the
trailing-zero count of their OR; the all-zero block is the case with no
set bit.
"""

from __future__ import annotations

import torch

from flake_tpu_torch.ops.common import ctz32


def remove_wasted_bits(samples: torch.Tensor, bps: int):
    """samples int32 [..., B]. Returns (shifted samples, wasted int32
    [...]) with the reference's edge semantics: the count is capped at
    bps-1 and a result of exactly bps-1 (including the all-zero block)
    collapses to 0 (encode.c:570-585)."""
    tz = torch.where(samples != 0, ctz32(samples), 32).amin(dim=-1)
    wasted = torch.where(tz == 32, bps - 1, torch.clamp(tz, max=bps - 1))
    wasted = torch.where(wasted == bps - 1, 0, wasted).to(torch.int32)
    return samples >> wasted[..., None], wasted
