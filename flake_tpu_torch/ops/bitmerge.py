"""K3 and K5: the bitstream word merges, CUDA kernels written for Hopper.

Both counterparts of ``flake_tpu/ops/pallas_bitmerge.py`` live here, and
their names cross: the port's :func:`merge_words` is **K3** and replaces
the TPU kernel ``merge_combined`` (:173, ``_merge_combined_kernel``,
``_mxu_chunk``, ``_vals12``), the merge the encoder runs; the TPU
kernel that is called ``merge_words`` there (:271, ``_merge_kernel``
:227) is **K5** and is :func:`merge_aligned` here.

K3 takes the slot layout of
:func:`flake_tpu_torch.ops.bitpack.slot_layout` directly, with no slot
combining, kmax specialisation or overflow re-pack: the TPU's
matrix-unit merge needs those, and in the port only the merge-prototype
tool runs them (``ops/bitpack.combined_parts``, ``kmax_for``;
:mod:`flake_tpu_torch.util.prof_merge3`). The kernel source is
``flake_tpu_torch/csrc/bitmerge.cu``; :func:`merge_words_plain` is the
JAX package's ``backend="xla"`` formulation (``bitpack.py:669-705``) with
``torch.cumsum`` and ``torch.searchsorted``.

K5 takes the pre-aligned form that
:func:`flake_tpu_torch.ops.bitpack.aligned_parts` makes of the same
slots: each slot's first word index ``w0`` and the two 32-bit words
``hi`` and ``lo`` its payload spans, in 128-slot chunks laid out
[F, 128, nc]. It adds ``hi`` into word ``w0`` and ``lo`` into word
``w0 + 1`` (payload bit extents are disjoint, so the sum is their OR),
and gives the words K3 gives for the same slots. No encoder path runs
it: it serves the emission-profiling tool
(:mod:`flake_tpu_torch.util.prof_merge`). The kernel source is
``flake_tpu_torch/csrc/bitmerge_aligned.cu``.
"""

from __future__ import annotations

import torch

from flake_tpu_torch import _cuda
from flake_tpu_torch.ops.common import U32_MASK, wrap_int32

LANE = 128


def slot_words(lengths: torch.Tensor, leading: torch.Tensor,
               payload: torch.Tensor):
    """Each slot's place in its frame's 32-bit words
    (``bitpack.py:669-684``): (offsets, w0, hi, lo) int64 [F, M]. Slot
    bit offsets are the exclusive running sum of the lengths; the
    payload starts ``leading`` bits in, in word ``w0``, and spans at
    most two words, ``hi`` in ``w0`` and ``lo`` in ``w0 + 1`` (uint32
    values; 0 for a slot without payload bits)."""
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
    return offsets, w0, torch.where(active, hi, 0), torch.where(active, lo, 0)


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
    _, w0, hi, lo = slot_words(lengths, leading, payload)
    zero = torch.zeros((F, 1), dtype=torch.int64, device=dev)
    ex_hi = torch.cat([zero, torch.cumsum(hi, -1)], dim=-1)
    ex_lo = torch.cat([zero, torch.cumsum(lo, -1)], dim=-1)
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


def sum_at(idx: torch.Tensor, val: torch.Tensor, n: int) -> torch.Tensor:
    """out[f, w] = the sum of val[f, s] over the s with idx[f, s] == w,
    for w in [0, n): int64 [F, n]. Indices outside [0, n) add nothing.
    Written without a scatter: the values are sorted by index, summed
    along the row, and each word is a difference of two running sums."""
    F = idx.shape[0]
    order = torch.argsort(idx, dim=-1)
    sorted_idx = torch.gather(idx, 1, order)
    zero = torch.zeros((F, 1), dtype=torch.int64, device=idx.device)
    run = torch.cat([zero, torch.cumsum(
        torch.gather(val.to(torch.int64), 1, order), -1)], dim=-1)
    targets = torch.arange(n + 1, device=idx.device).expand(F, n + 1) \
        .contiguous()
    at = torch.gather(run, 1, torch.searchsorted(sorted_idx.contiguous(),
                                                 targets))
    return at[:, 1:] - at[:, :-1]


def check_aligned(name, w0t, hit, lot, chunk_bits):
    """The K5 input contract, for K5 and the profiling variants."""
    if w0t.dim() != 3 or w0t.shape[1] != LANE:
        raise ValueError(f"{name}: bad shape {tuple(w0t.shape)}")
    F, _, nc = w0t.shape
    dev = w0t.device
    for label, t, shape in (("w0t", w0t, (F, LANE, nc)),
                            ("hit", hit, (F, LANE, nc)),
                            ("lot", lot, (F, LANE, nc)),
                            ("chunk_bits", chunk_bits, (F, nc + 1))):
        _cuda.check(t, f"{name}: {label}", torch.int32, shape, dev)


def merge_aligned_plain(w0t: torch.Tensor, hit: torch.Tensor,
                        lot: torch.Tensor, chunk_bits: torch.Tensor,
                        word_rows: int) -> torch.Tensor:
    """Plain PyTorch version of K5: word w is the int32 (wrapping) sum of
    the ``hi`` of the slots with w0 == w and the ``lo`` of the slots with
    w0 == w - 1."""
    F = w0t.shape[0]
    W = word_rows * LANE
    w0 = w0t.reshape(F, -1).to(torch.int64)
    words = sum_at(w0, hit.reshape(F, -1), W) \
        + sum_at(w0 + 1, lot.reshape(F, -1), W)
    return wrap_int32(words).reshape(F, word_rows, LANE)


def merge_aligned(w0t: torch.Tensor, hit: torch.Tensor, lot: torch.Tensor,
                  chunk_bits: torch.Tensor, word_rows: int) -> torch.Tensor:
    """K5: merge pre-aligned slot payloads into per-frame word blocks
    (the contract of ``pallas_bitmerge.py:271-280``).

    w0t/hit/lot int32 [F, 128, nc]: slot ``c * 128 + s`` of a frame at
    [f, s, c] (slot-in-chunk on the middle axis); hit/lot hold uint32 bit
    patterns; pad slots carry 0. chunk_bits int32 [F, nc + 1] is the bit
    cursor at each chunk boundary, the frame's total bits last; a slot's
    words follow from w0 alone, so K5 does not read it (the profiling
    variants do). Returns int32 [F, word_rows, 128]: word w of frame f at
    [f, w >> 7, w & 127], stream bit 0 in bit 31 of word 0. A word index
    outside the block adds nothing. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if w0t.device.type == "cpu":
        return merge_aligned_plain(w0t, hit, lot, chunk_bits, word_rows)
    if w0t.device.type != "cuda":
        raise ValueError(f"merge_aligned: no kernel for {w0t.device}")
    check_aligned("merge_aligned", w0t, hit, lot, chunk_bits)
    F, _, nc = w0t.shape
    words = torch.empty((F, word_rows, LANE), dtype=torch.int32,
                        device=w0t.device)
    _cuda.launch("flake_merge_aligned", w0t.device, w0t, hit, lot, words,
                 F, LANE * nc, word_rows * LANE)
    merge_aligned.launches += 1
    return words


merge_aligned.launches = 0
