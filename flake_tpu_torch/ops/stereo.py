"""Batched stereo decorrelation: mode estimation + transform (port of
``flake_tpu/ops/stereo.py``, encode.c:598-694).

The second-order residual sums run in int64, which is exact for every
bit depth, so the JAX package's int32 chunking (a TPU economy) is gone.
"""

from __future__ import annotations

import torch

from flake_tpu_torch.ops.common import wrap_int32
from flake_tpu_torch.ops.rice import _rice_count, find_optimal_k

# stereo modes (encode.h:42-46)
NOT_STEREO = 0
LEFT_RIGHT = 1
LEFT_SIDE = 8
RIGHT_SIDE = 9
MID_SIDE = 10


def second_diff_sums(lt: torch.Tensor, rt: torch.Tensor) -> torch.Tensor:
    """The four abs-sums the mode estimate reads (encode.c:606-625), from
    the channels' second differences ``lt``, ``rt`` (int64 [F, K], zeros
    where a difference does not count). Returns int64 [F, 4]: left,
    right, mid, side."""
    return torch.stack([lt.abs().sum(dim=-1), rt.abs().sum(dim=-1),
                        ((lt + rt) >> 1).abs().sum(dim=-1),
                        (lt - rt).abs().sum(dim=-1)], dim=-1)


def mode_from_sums(sums: torch.Tensor, n: int) -> torch.Tensor:
    """Cheapest stereo mode per frame (encode.c:627-643) from the
    :func:`second_diff_sums` of its whole block of ``n`` samples. Returns
    mode int32 [F]."""
    sums = sums * 2
    k, _ = find_optimal_k(sums, n)
    est = _rice_count(sums, n, k.to(torch.int64))          # [F, 4]
    score = torch.stack([
        est[..., 0] + est[..., 1],   # L+R
        est[..., 0] + est[..., 3],   # L+S
        est[..., 1] + est[..., 3],   # R+S
        est[..., 2] + est[..., 3],   # M+S
    ], dim=-1)
    # the first minimum wins ties, like the C scan: torch.min's stated rule
    best = torch.min(score, dim=-1).indices
    return torch.where(best == 0, LEFT_RIGHT,
                       torch.where(best == 1, LEFT_SIDE,
                                   torch.where(best == 2, RIGHT_SIDE,
                                               MID_SIDE))).to(torch.int32)


def decorr_mode(left: torch.Tensor, right: torch.Tensor,
                n: int) -> torch.Tensor:
    """Cheapest stereo mode per frame (encode.c:598-643). left/right
    int32 [F, B]; returns mode int32 [F]."""
    l64 = left.to(torch.int64)
    r64 = right.to(torch.int64)
    lt = l64[..., 2:] - 2 * l64[..., 1:-1] + l64[..., :-2]
    rt = r64[..., 2:] - 2 * r64[..., 1:-1] + r64[..., :-2]
    return mode_from_sums(second_diff_sums(lt, rt), n)


def apply_decorr(left: torch.Tensor, right: torch.Tensor,
                 mode: torch.Tensor):
    """Apply the chosen transform (encode.c:673-693). Returns (ch0, ch1,
    extra_bits int32 [F, 2]), the +1 obits of a side channel. Mid and
    side are formed in int64 and wrapped to int32 (the bps-32 callers
    veto side modes that would not fit)."""
    l64 = left.to(torch.int64)
    r64 = right.to(torch.int64)
    mid = ((l64 + r64) >> 1).to(torch.int32)
    side = wrap_int32(l64 - r64)
    m = mode[..., None]
    ch0 = torch.where(m == MID_SIDE, mid,
                      torch.where(m == RIGHT_SIDE, side, left))
    ch1 = torch.where((m == MID_SIDE) | (m == LEFT_SIDE), side, right)
    extra0 = (mode == RIGHT_SIDE).to(torch.int32)
    extra1 = ((mode == MID_SIDE) | (mode == LEFT_SIDE)).to(torch.int32)
    return ch0, ch1, torch.stack([extra0, extra1], dim=-1)
