"""Integer helpers shared by the ops (port of ``flake_tpu/ops/common.py``).

``torch.uint32``/``torch.uint64`` lack most CUDA operators, so every
unsigned quantity of the JAX package is held here as int64 and truncated
with ``& U32_MASK`` where the reference's uint32 accumulators wrap.
"""

from __future__ import annotations

import torch

U32_MASK = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 count: the reference's uint32 truncation
    (rice.c:34,110), kept non-negative in int64."""
    return x & U32_MASK


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (the C (int32_t)
    cast in optimize.c:120), written out so no backend's cast rule
    matters."""
    return (((x + (1 << 31)) & U32_MASK) - (1 << 31)).to(torch.int32)


def ctz32(x: torch.Tensor) -> torch.Tensor:
    """Count trailing zeros of the low 32 bits (0 for x == 0), int32."""
    x = x.to(torch.int64) & U32_MASK
    low = x & -x                                   # lowest set bit
    r = torch.zeros_like(x)
    for bits, mask in ((16, 0x0000FFFF), (8, 0x00FF00FF),
                       (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        r = r + bits * ((low & mask) == 0).to(torch.int64)
    return torch.where(x == 0, 0, r).to(torch.int32)
