"""Two prototypes of the pre-aligned word merge, timed on one GPU.

The port of the JAX package's ``util/prof_merge2.py``: the same two
level-8 batches of 512 frames of 4096 samples, 16-bit stereo (``music``, a
440 Hz tone plus noise, and ``noise``, uniform int16 that the encoder emits
verbatim, in chunks of 68 words), the same JSON keys. Both
prototypes take K5's inputs (:func:`flake_tpu_torch.ops.bitpack.aligned_parts`)
and are compared with K5 (:func:`flake_tpu_torch.ops.bitmerge.merge_aligned`,
the tool's ``merge_v1``) on the same parts; the tool reports whether their
words match and does not assert it.

**U2a, merge_v2** replaces the TPU kernel ``util/prof_merge2.py:224
merge_v2`` (body ``k_v2`` :193, ``_frame_body`` :111). On the TPU a chunk
of 128 slots is compared against a window of 64 words that starts at the
chunk's first word, up to four windows a chunk, and the first window's
words are carried in two row registers that follow the bit cursor. As a
function of its inputs that is K5's sum with three differences:

- a part whose word lies 256 or more words past its chunk's first word
  ``cw = chunk_bits[c] >> 5`` is dropped (the reference's docstring speaks
  of an overflow flag and a re-run; its code has neither), and so is a
  part before ``cw``;
- a part 64p to 64p + 63 words past ``cw`` (p = 1, 2, 3) is kept only where
  the chunk's last word ``((chunk_bits[c + 1] - 1) >> 5) - cw`` is at least
  64p;
- the carry row advances at most two rows a chunk, so where a chunk starts
  three or more rows past the row the carry has reached, the parts of its
  first window land that many rows too early: at word ``w - 128 * (r - ra)``
  with ``r = cw >> 7`` and ``ra = max(ra', min(r, ra' + 2))`` after the row
  ``ra'`` of the chunk before (0 before the first).

**U2b, merge_v3** replaces ``util/prof_merge2.py:353 merge_v3`` (body
``k_v3`` :328, ``_frame_body_s2w`` :295): K5's sum over a chunk's first
four word rows, row0 always and row0 + 1..3 where the chunk reaches them
(:func:`flake_tpu_torch.util.prof_merge.merge_first_rows_plain`).

Neither writes a word row at or past the block's. ``fb``, the frames a
TPU program takes, does not change the words; both wrappers keep it and
refuse one that does not divide the frames, as the TPU grid does. Both
kernels are one body (``flake_tpu_torch/csrc/prof_merge2.cu``) that
launches one block a frame whatever ``fb`` is and reads each chunk's rule
from a table: ``merge_v2`` builds its carry rows by a prefix minimum
(:func:`v2_carry_rows_prefix_min`), which needs chunk bounds that do not
decrease, as :func:`flake_tpu_torch.ops.bitpack.aligned_parts` makes them;
``merge_v3`` keeps a chunk's first row and span (:func:`v3_chunk_rows`)
and needs no order of the bounds. A CPU tensor takes the plain version
beside each wrapper.

    python3 -m flake_tpu_torch.util.prof_merge2 [--v3] [--device cpu] [--frames N]

Runs on the GPU unless ``--device cpu`` is given. Each ``*_ms`` key is one
kernel timed back to back with CUDA events
(:func:`flake_tpu_torch.util.prof_merge.time_ms`), in ms to four decimals;
on the CPU the plain versions on the host clock.
"""

from __future__ import annotations

import argparse
import json

import torch

from flake_tpu_torch import _cuda
from flake_tpu_torch.encoder import resolve_device
from flake_tpu_torch.ops import bitpack
from flake_tpu_torch.ops.bitmerge import (LANE, check_aligned, merge_aligned,
                                          sum_at)
from flake_tpu_torch.ops.common import wrap_int32
from flake_tpu_torch.util.prof_merge import (FRAMES, batch_slots,
                                             chunk_rows,
                                             merge_first_rows_plain, time_ms)

PASS_WORDS = 64     # words a window covers
PASSES = 4          # windows a chunk can get: parts under 256 words from cw
KINDS = ("music", "noise")


def chunk_ext_words(chunk_bits: torch.Tensor) -> torch.Tensor:
    """Each chunk's last word counted from its first, int64 [F, nc]
    (``ext`` of ``_frame_body`` :144)."""
    cb = chunk_bits.to(torch.int64)
    return ((cb[:, 1:] - 1) >> 5) - (cb[:, :-1] >> 5)


def v2_carry_rows(chunk_bits: torch.Tensor) -> torch.Tensor:
    """The row the two-row carry stands at when each chunk's first window
    is added, int64 [F, nc] (``_frame_body`` :122-142): it starts at 0 and
    moves up to the chunk's own row ``chunk_bits[c] >> 12``, by at most
    two rows a chunk."""
    r = chunk_bits[:, :-1].to(torch.int64) >> 12
    ra = torch.zeros_like(r[:, 0])
    rows = []
    for c in range(r.shape[1]):
        ra = torch.maximum(ra, torch.minimum(r[:, c], ra + 2))
        rows.append(ra)
    return torch.stack(rows, dim=1)


def v2_carry_rows_prefix_min(chunk_bits: torch.Tensor) -> torch.Tensor:
    """:func:`v2_carry_rows` in the closed form ``merge_v2``'s kernel
    computes with a warp prefix minimum, int64 [F, nc]: ``ra_c = 2 c +
    min(2, min_{j <= c} (r_j - 2 j))`` with ``r_j = chunk_bits[j] >> 12``.
    It equals the recurrence where the rows do not decrease and start at
    or above 0: the carry then never stands past ``r_c``, so the
    recurrence's ``max`` keeps nothing and unrolls to ``min(2 (c + 1),
    min_{j <= c} (r_j + 2 (c - j)))``."""
    r = chunk_bits[:, :-1].to(torch.int64) >> 12
    two_c = 2 * torch.arange(r.shape[1], device=r.device)
    return two_c + torch.clamp(torch.cummin(r - two_c, dim=1).values, max=2)


def v3_chunk_rows(chunk_bits: torch.Tensor):
    """``merge_v3``'s table, int64 [F, nc] each, in the form its kernel
    computes: ``row0 = chunk_bits[c] >> 12`` and ``span = max(0,
    min(last_row, row0 + 3) - row0)`` with ``last_row = (((chunk_bits[c +
    1] - 1) >> 5) + 1) >> 7`` in int32 (``- 1`` wraps at the int32
    minimum, as on the TPU). A word of row ``r`` adds where ``0 <= r - row0
    <= span``: row0 always, and row0 + 1..3 where ``last_row`` reaches them
    (``_frame_body_s2w`` :308-325), whatever order the bounds have. The
    rows are :func:`~flake_tpu_torch.util.prof_merge.chunk_rows`', whose
    ``last_row`` is at least ``row0``, so the span needs no clamp at 0."""
    row0, last_row = chunk_rows(chunk_bits)
    return row0, torch.minimum(last_row, row0 + 3) - row0


def merge_v2_plain(w0t, hit, lot, chunk_bits, word_rows):
    """Plain version of ``merge_v2``: K5's sum with the three differences
    the module's docstring lists."""
    F = w0t.shape[0]
    W = word_rows * LANE
    cw = chunk_bits[:, :-1].to(torch.int64) >> 5
    ext = chunk_ext_words(chunk_bits)[:, None, :]
    early = ((cw >> 7) - v2_carry_rows(chunk_bits))[:, None, :]
    w0 = w0t.to(torch.int64)
    rel = w0 - cw[:, None, :]
    p = rel >> 6
    keep = (rel >= 0) & (p < PASSES) & ((p == 0) | (ext >= p * PASS_WORDS))
    word = (w0 - torch.where(p == 0, early * LANE, 0)).reshape(F, -1)
    words = sum_at(word, torch.where(keep, hit, 0).reshape(F, -1), W) \
        + sum_at(word + 1, torch.where(keep, lot, 0).reshape(F, -1), W)
    return wrap_int32(words).reshape(F, word_rows, LANE)


def merge_v3_plain(w0t, hit, lot, chunk_bits, word_rows):
    """Plain version of ``merge_v3``: K5's sum over the parts in a chunk's
    first four word rows, rows after the first only where the chunk
    reaches them."""
    return merge_first_rows_plain(w0t, hit, lot, chunk_bits, word_rows,
                                  rows=4, reach=True)


def _prototype(name: str, plain):
    """The wrapper of one U2 kernel: K5's signature plus ``fb``, the frames
    a TPU program takes, which must divide the frames and does not shape
    the launch (one CUDA block a frame). A CPU tensor takes ``plain``; a
    CUDA tensor launches the kernel."""

    def run(w0t, hit, lot, chunk_bits, word_rows, fb: int = 8):
        F = w0t.shape[0]
        if fb < 1 or F % fb:
            raise ValueError(f"merge_{name}: {F} frames are no multiple of "
                             f"fb = {fb}")
        if w0t.device.type == "cpu":
            return plain(w0t, hit, lot, chunk_bits, word_rows)
        if w0t.device.type != "cuda":
            raise ValueError(f"merge_{name}: no kernel for {w0t.device}")
        check_aligned(f"merge_{name}", w0t, hit, lot, chunk_bits)
        nc = w0t.shape[-1]
        words = torch.empty((F, word_rows, LANE), dtype=torch.int32,
                            device=w0t.device)
        _cuda.launch(f"flake_prof_merge_{name}", w0t.device, chunk_bits, w0t,
                     hit, lot, words, F, nc, word_rows * LANE)
        run.launches += 1
        return words

    run.launches = 0
    run.__name__ = run.__qualname__ = f"merge_{name}"
    run.__doc__ = f"U2 ``merge_{name}``: see :func:`{plain.__name__}`."
    return run


merge_v2 = _prototype("v2", merge_v2_plain)
merge_v3 = _prototype("v3", merge_v3_plain)


def _run(name, kernel, time_fbs, device, frames, iters):
    """One prototype on both batches: whether its words match K5's at fb =
    1 and 8 and, on ``music``, its time at ``time_fbs``."""
    dev = resolve_device(device)
    if frames % 16:
        raise ValueError(f"--frames must be a multiple of 16, got {frames}")
    res = {}
    for kind in KINDS:
        slots, cfg = batch_slots(kind, frames, dev)
        parts = bitpack.aligned_parts(*slots)
        wr = bitpack.word_rows(cfg)
        if name == "v2":
            res[f"{kind}_max_chunk_ext_words"] = int(
                chunk_ext_words(parts[3]).max())
        ref = merge_aligned(*parts, wr)
        for fb in (1, 8):
            res[f"{kind}_{name}_fb{fb}_match"] = torch.equal(
                ref, kernel(*parts, wr, fb))
        if kind == "music":
            def ms(fn):
                return round(time_ms(fn, dev, iters, back_to_back=True), 4)

            if name == "v2":
                res["merge_v1_ms"] = ms(lambda: merge_aligned(*parts, wr))
            for fb in time_fbs:
                res[f"merge_{name}_fb{fb}_ms"] = ms(
                    lambda: kernel(*parts, wr, fb))
    print(json.dumps(res), flush=True)
    return res


def main(device="cuda", frames: int = FRAMES, iters: int = 20) -> dict:
    """``merge_v2`` against K5 on both batches, timed at fb = 1, 4, 8, 16
    beside K5 on ``music``; prints one JSON line and returns the dict."""
    return _run("v2", merge_v2, (1, 4, 8, 16), device, frames, iters)


def main_v3(device="cuda", frames: int = FRAMES, iters: int = 20) -> dict:
    """``merge_v3`` against K5 on both batches, timed at fb = 1, 8, 16 on
    ``music``; prints one JSON line and returns the dict."""
    return _run("v3", merge_v3, (1, 8, 16), device, frames, iters)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--v3", action="store_true",
                    help="run merge_v3 instead of merge_v2")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=FRAMES)
    args = ap.parse_args()
    (main_v3 if args.v3 else main)(args.device, args.frames)
