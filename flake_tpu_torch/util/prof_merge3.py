"""Slot combining and the combined-node word merge, timed on one GPU.

The port of the combined-node path of the JAX package's
``util/prof_merge3.py`` (its ``main``): adjacent slots are combined twice
(pairs, then quads) into nodes whose payload spans at most 64 bits, so the
merge sees a quarter of the slots, each with three words (A, B, C at
``w0``, ``w0 + 1``, ``w0 + 2``). A node that would not fit keeps its first
half and spills the second whole into a side set of full capacity, one set
per level (``sp1`` slots, ``sp2`` pairs); the spill sets are all zero on
usual content, and bit 31 of a chunk's entry in ``cb2`` / ``cb1`` says
whether the chunk of 128 has any spill at all. The combining is
:func:`flake_tpu_torch.ops.bitpack.combine_level` and ``align3``;
:func:`v5_parts` applies it to a batch's slots.

**U3a, merge_v5a** and **U3b, merge_v5b** replace the TPU kernels
``util/prof_merge3.py:344 merge_v5a`` (body ``k_v5a`` :307) and ``:440
merge_v5b`` (body ``k_v5b`` :403). Both compute one function: word w of a
frame is the int32 (wrapping) sum of every A with ``w0 == w``, B with
``w0 + 1 == w`` and C with ``w0 + 2 == w`` over the main set, the sp2
chunks whose ``cb2`` entry has bit 31 set and the sp1 chunks (A and B only)
whose ``cb1`` entry has; a word at or past the block's end adds nothing.
On the TPU they differ in how the loop over a chunk's word rows is
unrolled, which a scatter does not have; on the GPU v5a tests each node's
chunk flag, and v5b first reduces a frame's flags and skips a spill set
that has none. The CUDA source is ``flake_tpu_torch/csrc/prof_merge3.cu``;
:func:`merge_v5_plain` is the plain version of both, which a CPU tensor
takes.

The tool runs both on the ``music`` and ``noise`` batches of
:mod:`flake_tpu_torch.util.prof_merge2`, compares their words with K5's on
the same slots (reported, not asserted) and times them beside K5
(``merge_v1_ms``), each one kernel back to back. ``prep_v5_ms`` is
:func:`v5_parts` from ready slot tables in a plain loop; the JAX tool's
key of that name also holds the analysis and the slot layout, which
``analysis_ms`` and ``prep_ms`` of :mod:`flake_tpu_torch.util.prof_merge`
time.

    python3 -m flake_tpu_torch.util.prof_merge3 [--device cpu] [--frames N]

Runs on the GPU unless ``--device cpu`` is given. The row-layout kernels
of the JAX tool (``--v5c``, ``--v5d``) are not ported yet.
"""

from __future__ import annotations

import argparse
import json

import torch

from flake_tpu_torch import _cuda
from flake_tpu_torch.encoder import resolve_device
from flake_tpu_torch.ops import bitpack
from flake_tpu_torch.ops.bitmerge import LANE, merge_aligned, sum_at
from flake_tpu_torch.ops.common import U32_MASK, wrap_int32
from flake_tpu_torch.util.prof_merge import FRAMES, batch_slots, time_ms
from flake_tpu_torch.util.prof_merge2 import KINDS

FLAG = -(1 << 31)       # bit 31 of a cb entry: the chunk has a spill
MASK31 = (1 << 31) - 1


def v5_parts(lengths: torch.Tensor, leading: torch.Tensor,
             payload: torch.Tensor):
    """The combined-node form of a batch's slots (``build_v5_parts``,
    ``util/prof_merge3.py:193-271``, from the slot tables on).

    int32 [F, M] each -> ``main`` (w0, A, B, C) of the quad nodes and
    ``sp2`` (w0, A, B, C) of the pairs that spilled at the second level,
    int32 [F, 128, nc2]; ``sp1`` (w0, A, B) of the slots that spilled at
    the first, int32 [F, 128, nc1]; ``cb2`` int32 [F, nc2 + 1] and ``cb1``
    [F, nc1 + 1], the bit offset of each chunk's first node with the
    frame's total bits last, bit 31 set on a chunk with a spill. Offsets
    are a plain running sum."""
    ln = bitpack.pad_even(lengths.to(torch.int64))
    sw = ln - bitpack.pad_even(leading.to(torch.int64))
    pay = bitpack.pad_even(payload.to(torch.int64) & U32_MASK)
    total_bits = ln.sum(dim=-1, keepdim=True)

    (ln1, *node1), (s1_sw, s1_rel, s1_pay) = bitpack.combine_level(
        ln, sw, torch.zeros_like(ln), pay)
    ln1p = bitpack.pad_even(ln1)
    (ln2, sw2, g2, pay2), (s2_sw, s2_rel, s2_pay) = bitpack.combine_level(
        ln1p, *(bitpack.pad_even(v) for v in node1))

    # bit offsets of the quads, and of the pairs inside them
    off2 = torch.cumsum(ln2, dim=-1) - ln2
    off1 = torch.stack([off2, off2 + ln1p[:, 0::2]], dim=-1) \
        .reshape(off2.shape[0], -1)[:, :ln1.shape[-1]]

    main = bitpack.align3(off2 + ln2 - g2 - sw2, sw2, pay2)
    sp2 = bitpack.align3(off2 + s2_rel, s2_sw, s2_pay)
    sp1 = bitpack.align3(off1 + s1_rel, s1_sw, s1_pay)[:3]  # <= 32 bits: no C

    def bounds(off, spill_sw):
        # a chunk's first node always exists (nc = ceil(M / 128)), so the
        # reference's edge padding of ``off`` before the stride adds nothing
        flagged = bitpack.to_rows(spill_sw).any(dim=-1)
        starts = off[:, ::LANE]
        return torch.cat([torch.where(flagged, starts | FLAG, starts),
                          total_bits], dim=-1).to(torch.int32)

    def chunked(nodes):
        return tuple(bitpack.to_chunks(v) for v in nodes)

    return chunked(main), chunked(sp2), chunked(sp1), \
        bounds(off2, s2_sw), bounds(off1, s1_sw)


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
            return round(time_ms(fn, dev, iters, back_to_back), 3)

        res[f"{kind}_merge_v1_ms"] = ms(lambda: merge_aligned(*aligned, wr))
        res[f"{kind}_merge_v5a_ms"] = ms(lambda: merge_v5a(*parts, wr))
        res[f"{kind}_merge_v5b_ms"] = ms(lambda: merge_v5b(*parts, wr))
        res[f"{kind}_prep_v5_ms"] = ms(lambda: v5_parts(*slots), False)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=FRAMES)
    args = ap.parse_args()
    main(args.device, args.frames)
