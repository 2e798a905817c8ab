"""K3: the bitstream word merge, a CUDA kernel written for Hopper.

Replaces the TPU kernel ``flake_tpu/ops/pallas_bitmerge.py:
merge_combined`` (``_merge_combined_kernel``, ``_mxu_chunk``,
``_vals12``). It takes the slot layout of
:func:`flake_tpu_torch.ops.bitpack.slot_layout` directly, with no slot
combining, kmax specialisation or overflow re-pack: those exist only
for the TPU's matrix-unit merge. The kernel source is
``flake_tpu_torch/csrc/bitmerge.cu``; :func:`merge_words_plain` is the
JAX package's ``backend="xla"`` formulation (``bitpack.py:669-705``) with
``torch.cumsum`` and ``torch.searchsorted``.
"""

from __future__ import annotations

import torch

from flake_tpu_torch import _cuda
from flake_tpu_torch.ops.common import U32_MASK, wrap_int32

LANE = 128


def merge_words_plain(lengths: torch.Tensor, leading: torch.Tensor,
                      payload: torch.Tensor, word_rows: int):
    """Plain PyTorch version: each 32-bit word is a difference of running
    sums of the (at most two) word parts of the slots that start in it.
    Sums run in int64, so no wraparound is needed; disjoint fields keep
    every word below 2^32."""
    F, M = lengths.shape
    W = word_rows * LANE
    dev = lengths.device
    ln = lengths.to(torch.int64)
    offsets = torch.cumsum(ln, dim=-1) - ln
    paylen = ln - leading
    start = offsets + leading
    w0 = start >> 5
    t = paylen + (start & 31)
    first = t <= 32
    pay = payload.to(torch.int64) & U32_MASK
    hi = torch.where(first, (pay << torch.clamp(32 - t, 0, 31)) & U32_MASK,
                     pay >> torch.clamp(t - 32, 0, 31))
    lo = torch.where(first, 0,
                     (pay << torch.clamp(64 - t, 1, 31)) & U32_MASK)
    active = paylen > 0
    zero = torch.zeros((F, 1), dtype=torch.int64, device=dev)
    ex_hi = torch.cat([zero, torch.cumsum(torch.where(active, hi, 0), -1)],
                      dim=-1)
    ex_lo = torch.cat([zero, torch.cumsum(torch.where(active, lo, 0), -1)],
                      dim=-1)
    targets = torch.arange(W + 1, device=dev).expand(F, W + 1).contiguous()
    S = torch.searchsorted(w0.contiguous(), targets)  # first w0 >= w
    A = torch.gather(ex_hi, 1, S)
    B = torch.gather(ex_lo, 1, S)
    hi_term = A[:, 1:] - A[:, :-1]                     # slots with w0 == w
    lo_term = B - torch.cat([B[:, :1], B[:, :-1]], dim=-1)  # w0 == w - 1
    words = wrap_int32(hi_term + lo_term[:, :W]).reshape(F, word_rows, LANE)
    return words, ln.sum(dim=-1).to(torch.int32)


def merge_words(lengths: torch.Tensor, leading: torch.Tensor,
                payload: torch.Tensor, word_rows: int):
    """Merge each frame's slots into big-endian 32-bit words.

    lengths/leading/payload int32 [F, M] (payload holds the uint32 bit
    pattern). Returns (words int32 [F, word_rows, 128], total_bits int32
    [F]). A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel."""
    if lengths.device.type == "cpu":
        return merge_words_plain(lengths, leading, payload, word_rows)
    if lengths.device.type != "cuda":
        raise ValueError(f"merge_words: no kernel for {lengths.device}")
    if lengths.dim() != 2:
        raise ValueError(f"merge_words: bad shape {tuple(lengths.shape)}")
    F, M = lengths.shape
    dev = lengths.device
    for name, t in (("lengths", lengths), ("leading", leading),
                    ("payload", payload)):
        _cuda.check(t, name, torch.int32, (F, M), dev)
    words = torch.zeros((F, word_rows, LANE), dtype=torch.int32, device=dev)
    total_bits = torch.empty((F,), dtype=torch.int32, device=dev)
    _cuda.launch("flake_merge_words", dev, lengths, leading, payload, words,
                 total_bits, F, M, word_rows * LANE)
    merge_words.launches += 1
    return words, total_bits


merge_words.launches = 0
