"""Slot combining and the combined-node word merges, timed on one GPU.

The port of the JAX package's ``util/prof_merge3.py`` (its ``main``,
``main_v5d`` and ``main_v5c``): adjacent slots are combined twice (pairs,
then quads) into nodes whose payload spans at most 64 bits, so the merge
sees a quarter of the slots, each with three words (A, B, C at ``w0``,
``w0 + 1``, ``w0 + 2``). A node that would not fit keeps its first half and
spills the second whole into a side set of full capacity, one set per
level (``sp1`` slots, ``sp2`` pairs); the spill sets are all zero on usual
content, and bit 31 of a chunk's entry in ``cb2`` / ``cb1`` says whether
the chunk of 128 has any spill at all. The combining is
:func:`flake_tpu_torch.ops.bitpack.combined_nodes`; :func:`v5_parts` lays
the nodes out in chunks [F, 128, nc], :func:`v5d_parts` in rows
[F, nc, 128] and :func:`v5c_parts` in both (each set's ``w0`` in chunks,
its words in rows), the last two with the per-frame overflow flag of
:func:`flake_tpu_torch.ops.bitpack.combined_parts`.

**U3a, merge_v5a** and **U3b, merge_v5b** replace the TPU kernels
``util/prof_merge3.py:344 merge_v5a`` (body ``k_v5a`` :307) and ``:440
merge_v5b`` (body ``k_v5b`` :403). Both compute one function: word w of a
frame is the int32 (wrapping) sum of every A with ``w0 == w``, B with
``w0 + 1 == w`` and C with ``w0 + 2 == w`` over the main set, the sp2
chunks whose ``cb2`` entry has bit 31 set and the sp1 chunks (A and B only)
whose ``cb1`` entry has; a word at or past the block's end adds nothing.
On the TPU they differ in how the loop over a chunk's word rows is
unrolled, which a scatter does not have, so on the GPU both launch one
kernel (each with its own entry point and launch count): every set read in
memory order, a spill set only where a frame flags its chunks. The CUDA
source is ``flake_tpu_torch/csrc/prof_merge3.cu``; :func:`merge_v5_plain`
is the plain version of both, which a CPU tensor takes.

**U3c, merge_v5d** and **U3d, merge_v5c** replace ``:653 merge_v5d`` (body
``k_v5d`` :612) and ``:714 merge_v5c`` (body ``k_v5c`` :677), which place a
chunk's nodes with one one-hot matrix product per word row, over a static
number of rows from the chunk's first. Both compute one function, and it
is v5a's sum inside a window: with ``row0 = (cb[c] & MASK31) >> 12`` of
its chunk ``c``, a node's word k (A, B, C for k = 0, 1, 2) is added at
``t = w0 + k`` only where ``w0 >= row0 * 128`` and ``t < (row0 + K) * 128``.
``K`` is ``kmax`` for the main and sp2 sets (both by cb2's ``row0``) and
``kmax1`` for sp1 (cb1's). Where no chunk of a frame spans more rows (the
overflow flag is clear) the words are v5a's and K5's. ``fb``, the frames a
TPU program takes, changes no word: the wrappers keep it and refuse one
that does not divide the frames, as the TPU grid does, and the kernels
launch one block a frame whatever it is. The TPU body of v5d always takes a
chunk's first two rows, so it is this function for ``kmax >= 2``. v5d reads
every array in rows; v5c reads each ``w0`` from the chunk layout (the
kernel reads it in place, a node at a time).
**U3e, merge_zero_fb** and **U3f, merge_zero_rows** (``:847``, ``:1019``)
take v5c's and v5d's operands, read nothing and write zeros: the
launch-and-store floor of the two. The CUDA source of the merges is
``flake_tpu_torch/csrc/prof_merge3_rows.cu``, that of the floors the tools'
one zero floor, ``flake_tpu_torch/csrc/zero_floor.cu``, whose launch does
not depend on ``fb``; :func:`merge_v5_rows_plain` is the plain version of
both merges and ``torch.zeros`` that of the floors.

The tool runs on the ``music`` and ``noise`` batches of
:mod:`flake_tpu_torch.util.prof_merge2`, compares the merges' words with
K5's on the same slots (reported, not asserted) and times them, each one
kernel back to back. Without a flag: v5a and v5b beside K5
(``merge_v1_ms``); ``prep_v5_ms`` is :func:`v5_parts` from ready slot
tables in a plain loop; the JAX tool's key of that name also holds the
analysis and the slot layout, which ``analysis_ms`` and ``prep_ms`` of
:mod:`flake_tpu_torch.util.prof_merge` time. ``--v5d``: per batch the
frames that overflow ``--kmax`` rows, whether v5d at ``fb = 8`` gives K5's
words on the other frames, and v5d at ``fb`` 16 and 32; on ``music`` also
:func:`v5d_parts` from ready slot tables (``prep_slope_ms``) and the
analysis (``analysis_slope_ms``), both in a plain loop, and
``merge_zero_rows`` at both ``fb`` (``zero_rows_fb16_ms``,
``zero_rows_fb32_ms``: the one pair of keys the JAX tool lacks, whose
``merge_zero_rows`` no path calls). The ``_slope_ms`` keys keep the JAX
tool's names; there they are the slope of a graph that repeats the kernel,
here the card's time of one kernel. ``--v5c``: the overflowing frames,
whether v5c at ``fb = 8`` gives K5's words, v5c at ``fb`` 4, 8 and 16,
:func:`v5c_parts` from ready slot tables in a plain loop
(``{kind}_prep_ms``) and, on ``music``, ``merge_zero_fb`` at ``fb`` 1 and 8.

    python3 -m flake_tpu_torch.util.prof_merge3 [--v5d | --v5c] [--kmax K]
        [--device cpu] [--frames N]

Runs on the GPU unless ``--device cpu`` is given. Each ``*_ms`` key is in
ms to four decimals.
"""

from __future__ import annotations

import argparse
import json

import torch

from flake_tpu_torch import _cuda
from flake_tpu_torch.encoder import resolve_device
from flake_tpu_torch.ops import bitpack
from flake_tpu_torch.ops.bitmerge import LANE, merge_aligned, sum_at
from flake_tpu_torch.ops.bitpack import FLAG, MASK31
from flake_tpu_torch.ops.common import wrap_int32
from flake_tpu_torch.ops.frame import analyze_frames
from flake_tpu_torch.util.prof_merge import (FRAMES, batch_slots, make_batch,
                                             time_ms)
from flake_tpu_torch.util.prof_merge2 import KINDS

KMAX, KMAX1 = 4, 3      # the JAX tool's static rows of a main / sp2, sp1 chunk


def v5_parts(lengths: torch.Tensor, leading: torch.Tensor,
             payload: torch.Tensor):
    """The combined-node form of a batch's slots in chunk layout
    (``build_v5_parts``, ``util/prof_merge3.py:193-271``, from the slot
    tables on): :func:`~flake_tpu_torch.ops.bitpack.combined_nodes` with
    ``main`` and ``sp2`` (w0, A, B, C) int32 [F, 128, nc2] and ``sp1``
    (w0, A, B) int32 [F, 128, nc1], then ``cb2`` and ``cb1``."""
    main, sp2, sp1, cb2, cb1 = bitpack.combined_nodes(lengths, leading,
                                                      payload)

    def chunked(nodes):
        return tuple(bitpack.to_chunks(v) for v in nodes)

    return chunked(main), chunked(sp2), chunked(sp1), cb2, cb1


def v5d_parts(lengths: torch.Tensor, leading: torch.Tensor,
              payload: torch.Tensor, kmax: int = KMAX, kmax1: int = KMAX1):
    """The operands of ``merge_v5d`` (``build_v5d_parts``,
    ``util/prof_merge3.py:1002``, from the slot tables on): ``(mainw,
    (A, B, C), sp2w, (A, B, C), sp1w, (A, B), cb2, cb1, overflow)``, every
    node array int32 [F, nc, 128], ``overflow`` bool [F] last
    (:func:`~flake_tpu_torch.ops.bitpack.combined_parts`)."""
    parts, overflow, _, _ = bitpack.combined_parts(lengths, leading, payload,
                                                   kmax, kmax1)
    return (*parts, overflow)


def v5c_parts(lengths: torch.Tensor, leading: torch.Tensor,
              payload: torch.Tensor, kmax: int = KMAX, kmax1: int = KMAX1):
    """The operands of ``merge_v5c`` (``build_v5c_parts``,
    ``util/prof_merge3.py:754``, from the slot tables on):
    :func:`v5d_parts` with each set's ``w0`` in chunk layout, contiguous
    int32 [F, 128, nc]."""
    mainw, mainr, sp2w, sp2r, sp1w, sp1r, *rest = v5d_parts(
        lengths, leading, payload, kmax, kmax1)

    def cols(rows):
        return rows.permute(0, 2, 1).contiguous()

    return (cols(mainw), mainr, cols(sp2w), sp2r, cols(sp1w), sp1r, *rest)


def check_v5(name, main, sp2, sp1, cb2, cb1):
    """The input contract of the v5 kernels."""
    if len(main) != 4 or len(sp2) != 4 or len(sp1) != 3:
        raise ValueError(f"{name}: expected 4 main, 4 sp2 and 3 sp1 arrays")
    if main[0].dim() != 3 or sp1[0].dim() != 3:
        raise ValueError(f"{name}: bad shape {tuple(main[0].shape)}")
    F, _, nc2 = main[0].shape
    nc1 = sp1[0].shape[-1]
    dev = main[0].device
    for label, group, nc in (("main", main, nc2), ("sp2", sp2, nc2),
                             ("sp1", sp1, nc1)):
        for i, t in enumerate(group):
            _cuda.check(t, f"{name}: {label}[{i}]", torch.int32,
                        (F, LANE, nc), dev)
    _cuda.check(cb2, f"{name}: cb2", torch.int32, (F, nc2 + 1), dev)
    _cuda.check(cb1, f"{name}: cb1", torch.int32, (F, nc1 + 1), dev)


def merge_v5_plain(main, sp2, sp1, cb2, cb1, word_rows):
    """Plain version of ``merge_v5a`` and ``merge_v5b``: the sum the
    module's docstring states."""
    F = main[0].shape[0]
    W = word_rows * LANE
    words = torch.zeros((F, W), dtype=torch.int64, device=main[0].device)
    for (w0, *vals), cb in ((main, None), (sp2, cb2), (sp1, cb1)):
        w0 = w0.to(torch.int64).reshape(F, -1)
        for k, val in enumerate(vals):
            if cb is not None:
                val = torch.where(cb[:, None, :-1] < 0, val, 0)
            words += sum_at(w0 + k, val.reshape(F, -1), W)
    return wrap_int32(words).reshape(F, word_rows, LANE)


def _merge_v5(name: str):
    """The wrapper of one v5 kernel. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel."""

    def run(main, sp2, sp1, cb2, cb1, word_rows):
        dev = main[0].device
        if dev.type == "cpu":
            return merge_v5_plain(main, sp2, sp1, cb2, cb1, word_rows)
        if dev.type != "cuda":
            raise ValueError(f"merge_{name}: no kernel for {dev}")
        check_v5(f"merge_{name}", main, sp2, sp1, cb2, cb1)
        F, _, nc2 = main[0].shape
        words = torch.empty((F, word_rows, LANE), dtype=torch.int32,
                            device=dev)
        _cuda.launch(f"flake_prof_merge_{name}", dev, cb2, cb1, *main, *sp2,
                     *sp1, words, F, nc2, sp1[0].shape[-1], word_rows * LANE)
        run.launches += 1
        return words

    run.launches = 0
    run.__name__ = run.__qualname__ = f"merge_{name}"
    run.__doc__ = f"U3 ``merge_{name}``: see :func:`merge_v5_plain`."
    return run


merge_v5a = _merge_v5("v5a")
merge_v5b = _merge_v5("v5b")


def check_v5_rows(name, mainw, mainr, sp2w, sp2r, sp1w, sp1r, cb2, cb1, fb,
                  dual: bool) -> torch.device:
    """The input contract of the row-layout kernels; ``dual`` says that
    each ``w0`` comes in chunk layout. Returns the operands' device."""
    dev = mainw.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {dev}")
    if len(mainr) != 3 or len(sp2r) != 3 or len(sp1r) != 2:
        raise ValueError(f"{name}: expected 3 main, 3 sp2 and 2 sp1 value "
                         "arrays")
    if not mainr[0].dim() == sp1r[0].dim() == 3:
        raise ValueError(f"{name}: bad shape {tuple(mainr[0].shape)}")
    F, nc2, _ = mainr[0].shape
    nc1 = sp1r[0].shape[1]
    for label, w0, vals, nc in (("main", mainw, mainr, nc2),
                                ("sp2", sp2w, sp2r, nc2),
                                ("sp1", sp1w, sp1r, nc1)):
        _cuda.check(w0, f"{name}: {label} w0", torch.int32,
                    (F, LANE, nc) if dual else (F, nc, LANE), dev)
        for i, t in enumerate(vals):
            _cuda.check(t, f"{name}: {label}[{i}]", torch.int32,
                        (F, nc, LANE), dev)
    _cuda.check(cb2, f"{name}: cb2", torch.int32, (F, nc2 + 1), dev)
    _cuda.check(cb1, f"{name}: cb1", torch.int32, (F, nc1 + 1), dev)
    if fb < 1 or F % fb:
        raise ValueError(f"{name}: {F} frames are no multiple of fb = {fb}")
    return dev


def merge_v5_rows_plain(mainw, mainr, sp2w, sp2r, sp1w, sp1r, cb2, cb1,
                        word_rows, kmax: int = KMAX, kmax1: int = KMAX1):
    """Plain version of ``merge_v5d`` and, with each ``w0`` brought to rows,
    of ``merge_v5c``: v5a's sum inside each chunk's window of static rows,
    as the module's docstring states it."""
    F = mainw.shape[0]
    W = word_rows * LANE
    words = torch.zeros((F, W), dtype=torch.int64, device=mainw.device)
    for w0, vals, cb, rows, spill in ((mainw, mainr, cb2, kmax, False),
                                      (sp2w, sp2r, cb2, kmax, True),
                                      (sp1w, sp1r, cb1, kmax1, True)):
        first = ((cb[:, :-1, None].to(torch.int64) & MASK31) >> 12) * LANE
        w0 = w0.to(torch.int64)
        inside = w0 >= first
        if spill:
            inside = inside & (cb[:, :-1, None] < 0)
        for k, val in enumerate(vals):
            keep = inside & (w0 + k < first + rows * LANE)
            words += sum_at((w0 + k).reshape(F, -1),
                            torch.where(keep, val, 0).reshape(F, -1), W)
    return wrap_int32(words).reshape(F, word_rows, LANE)


def _launch_rows(run, name, dev, operands, word_rows, *ints):
    """Launch one kernel of ``csrc/prof_merge3_rows.cu`` on checked
    operands and count it on its wrapper ``run``."""
    mainw, mainr, sp2w, sp2r, sp1w, sp1r, cb2, cb1 = operands
    F, nc2, _ = mainr[0].shape
    words = torch.empty((F, word_rows, LANE), dtype=torch.int32, device=dev)
    _cuda.launch(f"flake_prof_merge_{name}", dev, cb2, cb1, mainw, *mainr,
                 sp2w, *sp2r, sp1w, *sp1r, words, F, nc2, sp1r[0].shape[1],
                 word_rows * LANE, *ints)
    run.launches += 1
    return words


def _merge_rows(name: str, dual: bool):
    """The wrapper of ``merge_v5d`` (rows) or ``merge_v5c`` (``dual``). A
    CPU tensor takes the plain version; a CUDA tensor launches the
    kernel."""

    def run(mainw, mainr, sp2w, sp2r, sp1w, sp1r, cb2, cb1, word_rows,
            fb: int = 8, kmax: int = KMAX, kmax1: int = KMAX1):
        operands = (mainw, mainr, sp2w, sp2r, sp1w, sp1r, cb2, cb1)
        dev = check_v5_rows(f"merge_{name}", *operands, fb, dual)
        if kmax < 1 or kmax1 < 1:
            raise ValueError(f"merge_{name}: kmax = {kmax} and kmax1 = "
                             f"{kmax1} must be at least 1")
        if dev.type == "cpu":
            if dual:
                mainw, sp2w, sp1w = (w.permute(0, 2, 1)
                                     for w in (mainw, sp2w, sp1w))
            return merge_v5_rows_plain(mainw, mainr, sp2w, sp2r, sp1w, sp1r,
                                       cb2, cb1, word_rows, kmax, kmax1)
        return _launch_rows(run, name, dev, operands, word_rows, kmax, kmax1)

    run.launches = 0
    run.__name__ = run.__qualname__ = f"merge_{name}"
    run.__doc__ = (f"U3 ``merge_{name}``: see :func:`merge_v5_rows_plain`; "
                   + ("each ``w0`` int32 [F, 128, nc], " if dual else "")
                   + "every other node array int32 [F, nc, 128]; ``fb`` "
                   "must divide F and does not shape the launch.")
    return run


def _zero_floor(name: str, dual: bool):
    """The wrapper of a zero floor, with ``merge_v5c``'s operands (``dual``)
    or ``merge_v5d``'s. A CPU tensor takes ``torch.zeros``; a CUDA tensor
    launches the kernel."""

    def run(mainw, mainr, sp2w, sp2r, sp1w, sp1r, cb2, cb1, word_rows,
            fb: int = 8):
        operands = (mainw, mainr, sp2w, sp2r, sp1w, sp1r, cb2, cb1)
        dev = check_v5_rows(f"merge_{name}", *operands, fb, dual)
        if dev.type == "cpu":
            return torch.zeros((mainw.shape[0], word_rows, LANE),
                               dtype=torch.int32)
        return _launch_rows(run, name, dev, operands, word_rows, fb)

    run.launches = 0
    run.__name__ = run.__qualname__ = f"merge_{name}"
    run.__doc__ = (f"U3 ``merge_{name}``: zeros int32 [F, word_rows, 128]; "
                   "``fb`` must divide F and does not shape the launch; "
                   "reads nothing.")
    return run


merge_v5d = _merge_rows("v5d", dual=False)
merge_v5c = _merge_rows("v5c", dual=True)
merge_zero_fb = _zero_floor("zero_fb", dual=True)
merge_zero_rows = _zero_floor("zero_rows", dual=False)


def main(device="cuda", frames: int = FRAMES, iters: int = 20) -> dict:
    """Combine both batches' slots, compare ``merge_v5a`` and ``merge_v5b``
    with K5 and time the three and the combining; prints one JSON line and
    returns the dict."""
    dev = resolve_device(device)
    if frames % 16:
        raise ValueError(f"--frames must be a multiple of 16, got {frames}")
    res = {}
    for kind in KINDS:
        slots, cfg = batch_slots(kind, frames, dev)
        wr = bitpack.word_rows(cfg)
        aligned = bitpack.aligned_parts(*slots)
        ref = merge_aligned(*aligned, wr)
        parts = v5_parts(*slots)
        cb2, cb1 = parts[3], parts[4]
        got = merge_v5a(*parts, wr)
        res[f"{kind}_match"] = torch.equal(ref, got)
        if not res[f"{kind}_match"]:
            res[f"{kind}_first_bad"] = (ref != got).nonzero()[:3].tolist()
        res[f"{kind}_nc2"] = parts[0][0].shape[-1]
        res[f"{kind}_sp2_active_frac"] = round(
            float((cb2[:, :-1] < 0).double().mean()), 4)
        res[f"{kind}_sp1_active_frac"] = round(
            float((cb1[:, :-1] < 0).double().mean()), 4)
        res[f"{kind}_match_b"] = torch.equal(ref, merge_v5b(*parts, wr))

        def ms(fn, back_to_back=True):
            return round(time_ms(fn, dev, iters, back_to_back), 4)

        res[f"{kind}_merge_v1_ms"] = ms(lambda: merge_aligned(*aligned, wr))
        res[f"{kind}_merge_v5a_ms"] = ms(lambda: merge_v5a(*parts, wr))
        res[f"{kind}_merge_v5b_ms"] = ms(lambda: merge_v5b(*parts, wr))
        res[f"{kind}_prep_v5_ms"] = ms(lambda: v5_parts(*slots), False)
    print(json.dumps(res), flush=True)
    return res


def _slots_and_k5_words(kind, frames, dev):
    """A batch's slot tables, its word rows and K5's words of them."""
    slots, cfg = batch_slots(kind, frames, dev)
    wr = bitpack.word_rows(cfg)
    return slots, wr, merge_aligned(*bitpack.aligned_parts(*slots), wr)


def main_v5d(device="cuda", frames: int = FRAMES, iters: int = 20,
             kmax: int = KMAX) -> dict:
    """``merge_v5d`` against K5 on both batches, timed at fb = 16 and 32
    beside ``merge_zero_rows``, and on ``music`` the time of
    :func:`v5d_parts` and of the analysis; prints one JSON line and returns
    the dict."""
    dev = resolve_device(device)
    if frames % 32:
        raise ValueError(f"--frames must be a multiple of 32, got {frames}")
    res = {}
    for kind in KINDS:
        slots, wr, ref = _slots_and_k5_words(kind, frames, dev)
        *kin, overflow = v5d_parts(*slots, kmax)
        res[f"{kind}_overflow_frames"] = int(overflow.sum())
        got = merge_v5d(*kin, wr, 8, kmax)
        res[f"{kind}_match"] = torch.equal(ref[~overflow], got[~overflow])

        def ms(fn, back_to_back=True):
            return round(time_ms(fn, dev, iters, back_to_back), 4)

        for fb in (16, 32):
            res[f"{kind}_v5d_fb{fb}_slope_ms"] = ms(
                lambda: merge_v5d(*kin, wr, fb, kmax))
        if kind == "music":
            for fb in (16, 32):
                res[f"zero_rows_fb{fb}_ms"] = ms(
                    lambda: merge_zero_rows(*kin, wr, fb))
            res["prep_slope_ms"] = ms(lambda: v5d_parts(*slots, kmax), False)
            samples, _, _, cfg = make_batch(frames, kind)
            x = torch.from_numpy(samples).to(dev)
            hdr_bits = torch.full((frames,), 48, dtype=torch.int32,
                                  device=dev)
            res["analysis_slope_ms"] = ms(
                lambda: analyze_frames(x, cfg, hdr_bits), False)
    print(json.dumps(res), flush=True)
    return res


def main_v5c(device="cuda", frames: int = FRAMES, iters: int = 20,
             kmax: int = KMAX) -> dict:
    """``merge_v5c`` against K5 on both batches, timed at fb = 4, 8 and 16
    beside :func:`v5c_parts`, and on ``music`` ``merge_zero_fb`` at fb = 1
    and 8; prints one JSON line and returns the dict."""
    dev = resolve_device(device)
    if frames % 16:
        raise ValueError(f"--frames must be a multiple of 16, got {frames}")
    res = {}
    for kind in KINDS:
        slots, wr, ref = _slots_and_k5_words(kind, frames, dev)
        *kin, overflow = v5c_parts(*slots, kmax)
        res[f"{kind}_overflow_frames"] = int(overflow.sum())
        got = merge_v5c(*kin, wr, 8, kmax)
        res[f"{kind}_match"] = torch.equal(ref, got)
        if not res[f"{kind}_match"]:
            bad = (ref != got).nonzero()
            res[f"{kind}_first_bad"] = bad[:3].tolist()
            res[f"{kind}_nbad"] = bad.shape[0]

        def ms(fn, back_to_back=True):
            return round(time_ms(fn, dev, iters, back_to_back), 4)

        if kind == "music":
            for fb in (1, 8):
                res[f"zero_fb{fb}_ms"] = ms(
                    lambda: merge_zero_fb(*kin, wr, fb))
        for fb in (4, 8, 16):
            res[f"{kind}_v5c_fb{fb}_ms"] = ms(
                lambda: merge_v5c(*kin, wr, fb, kmax))
        res[f"{kind}_prep_ms"] = ms(lambda: v5c_parts(*slots, kmax), False)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--v5d", action="store_true",
                       help="run merge_v5d (row layout)")
    which.add_argument("--v5c", action="store_true",
                       help="run merge_v5c (dual layout)")
    ap.add_argument("--kmax", type=int, default=KMAX,
                    help="static word rows of a main / sp2 chunk "
                    "(--v5d, --v5c)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=FRAMES)
    args = ap.parse_args()
    if args.v5d:
        main_v5d(args.device, args.frames, kmax=args.kmax)
    elif args.v5c:
        main_v5c(args.device, args.frames, kmax=args.kmax)
    else:
        main(args.device, args.frames)
