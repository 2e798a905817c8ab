"""The comparison that decides ``correct``: frames the timed path produced,
held against the plain reference (``flakebench.reference``).

Once the window has closed, each batch of the pool's last outputs gives
a sample of its frames, drawn from the seed, with its largest frame in
it. The frames' samples and headers (the benchmark's own inputs) and the
program's outputs for them come to the host; the reference encodes the
same frames on the CPU, in blocks, and a frame differs where its
``frame_bytes``, its ``total_bits`` or one of its bytes (the words up to
its length) is not the reference's. The number compared is the share of
the checked frames that differ, in percent, against the cell's limit
(``cells/<cell>.json``, ``limits.differ_pct``).
"""

from __future__ import annotations

import numpy as np
import torch

from flakebench.reference import flac_plain as R

BLOCK = 64
# CPU threads the reference takes once the window has closed
THREADS = 8


def pick(frame_bytes: torch.Tensor, k: int, seed: int, j: int) -> torch.Tensor:
    """``k`` distinct frames of a batch of ``len(frame_bytes)``, drawn from
    the seed, its largest frame among them; int64, sorted."""
    F = frame_bytes.shape[0]
    g = torch.Generator().manual_seed((int(seed) * 0x2545F491 + j)
                                      % (1 << 63))
    idx = torch.randperm(F, generator=g)[:min(k, F)]
    largest = int(torch.argmax(frame_bytes))
    if largest not in idx.tolist():
        idx[0] = largest
    return idx.sort().values


def gather(batch: tuple, out: dict, idx: torch.Tensor) -> dict:
    """The frames ``idx`` of one batch's inputs and the program's outputs,
    as CPU tensors."""
    samples, hdr_bits, hdr_bytes, hdr_nb = batch
    dev_idx = idx.to(samples.device)
    return {"samples": samples[dev_idx].cpu(),
            "hdr_bits": hdr_bits[dev_idx].cpu(),
            "hdr_bytes": hdr_bytes[dev_idx].cpu(),
            "hdr_nb": hdr_nb[dev_idx].cpu(),
            "words": out["words"][dev_idx].cpu(),
            "total_bits": out["total_bits"][dev_idx].cpu(),
            "frame_bytes": out["frame_bytes"][dev_idx].cpu()}


def sample(batches: list, outs: list, k: int, seed: int) -> list:
    """:func:`gather` of :func:`pick`'s frames of every batch that has
    outputs (``outs[j]`` None for a batch the window never ran)."""
    return [gather(batch, out, pick(out["frame_bytes"].cpu(), k, seed, j))
            for j, (batch, out) in enumerate(zip(batches, outs))
            if out is not None]


def count(picked: list, cfg: R.Config) -> list:
    """:func:`differing` of each of :func:`sample`'s batches, the
    reference on :data:`THREADS` CPU threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        return [differing(got, cfg) for got in picked]
    finally:
        torch.set_num_threads(threads)


def _frame_bytes_view(words: torch.Tensor) -> np.ndarray:
    """Big-endian byte view of [F, rows, 128] int32 words."""
    w = words.reshape(words.shape[0], -1).numpy().astype(">i4")
    return w.view(np.uint8).reshape(words.shape[0], -1)


def differing(got: dict, cfg: R.Config) -> int:
    """Frames of ``got`` (:func:`gather`'s dict) whose sizes or bytes are
    not the reference's."""
    bad = 0
    F = got["samples"].shape[0]
    for a in range(0, F, BLOCK):
        sl = slice(a, min(a + BLOCK, F))
        ref = R.encode_batch(got["samples"][sl], got["hdr_bits"][sl],
                             got["hdr_bytes"][sl], got["hdr_nb"][sl], cfg)
        fb_got = got["frame_bytes"][sl].to(torch.int64)
        fb_ref = ref["frame_bytes"].to(torch.int64)
        same = (fb_got == fb_ref) & (got["total_bits"][sl].to(torch.int64)
                                     == ref["total_bits"].to(torch.int64))
        b_got = _frame_bytes_view(got["words"][sl])
        b_ref = _frame_bytes_view(ref["words"])
        if b_got.shape != b_ref.shape:
            bad += sl.stop - sl.start
            continue
        pos = np.arange(b_ref.shape[1])
        upto = np.maximum(fb_got.numpy(), fb_ref.numpy())[:, None]
        bytes_same = ((b_got == b_ref) | (pos >= upto)).all(axis=1)
        bad += int((~(same.numpy() & bytes_same)).sum())
    return bad
