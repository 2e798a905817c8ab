"""Decompose the device-emission cost of a level-8 batch on one GPU.

The port of the JAX package's ``util/prof_merge.py``: the same batch (512
frames of 4096 samples, 16-bit stereo, a 440 Hz tone plus noise from
``default_rng(0)``, level 8), the same stages and the same JSON keys,
each stage timed alone with CUDA events (the least of three means over
20 calls). The stages of many launches (``analysis_ms``, ``emit_full_ms``,
``prep_ms``) are timed in a plain loop, as their caller sees them; each
single kernel (the ``merge_*_ms`` keys), which the host cannot enqueue as
fast as the card runs it, back to back behind a spinning kernel, so that
the events time the card and not the host (:func:`device_ms`):

  analysis_ms         the batched analysis alone
  emit_full_ms        analysis + device pack through K3 (the pipeline
                      metric; ``pipeline_xrt_now`` is the batch's audio
                      seconds over it)
  prep_ms             slot prep from a ready analysis: slot layout, then
                      the alignment into chunked (w0, hi, lo) parts
  merge_now_ms        K5, the pre-aligned merge kernel, alone
  merge_static2_ms    variant: a chunk's parts placed into its first two
                      word rows only
  merge_fixedrow_ms   variant: every row's window added into row 0 (wrong
                      words by design)
  merge_nowin_ms      variant: every row a chunk overlaps gets the chunk's
                      hi sum on all lanes (wrong words by design)
  merge_zero_ms       a kernel that only zeroes the output (the
                      launch-and-store floor)
  merge_k3_ms         K3, the direct slot merge, on the same slots, so the
                      pre-aligned form (prep + K5) stands beside it
  static2_matches     whether static2's words equal K5's on this content

The four variants are **U1**: they replace the TPU kernels that
``util/prof_merge.py:141 _mk`` builds around ``k_static2``, ``k_fixedrow``,
``k_nowin`` and ``k_zero``. Their CUDA source is
``flake_tpu_torch/csrc/prof_merge.cu``, and for ``zero`` the tools' one
zero floor, ``flake_tpu_torch/csrc/zero_floor.cu``; each has its plain
PyTorch version here, which a CPU tensor takes.

    python3 -m flake_tpu_torch.util.prof_merge [--device cpu] [--frames N]

Runs on the GPU unless ``--device cpu`` is given; on the CPU the stages
are the plain versions, timed on the host clock.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from flake_tpu_torch import _cuda
from flake_tpu_torch import params as P
from flake_tpu_torch.encoder import resolve_device
from flake_tpu_torch.ops import bitpack
from flake_tpu_torch.ops.bitmerge import (LANE, check_aligned,
                                          merge_aligned, merge_words, sum_at)
from flake_tpu_torch.ops.common import wrap_int32
from flake_tpu_torch.ops.frame import FrameConfig, analyze_frames

FRAMES, BLOCK, CHANNELS, BPS, SAMPLE_RATE = 512, 4096, 2, 16, 44100


def chunk_rows(chunk_bits: torch.Tensor):
    """The first and last word row each chunk can touch, int64 [F, nc]
    (``pallas_bitmerge.py:240-244``): the last is the row of the lo spill
    of a payload that ends at the chunk's end bit. ``row0 = cb[c] >> 12``;
    ``cb[c + 1] - 1`` is taken in int32, as the TPU bodies take it
    (``util/prof_merge.py:191,217``, ``util/prof_merge2.py:309``), so a
    chunk end of INT32_MIN wraps to the largest row, 524,288."""
    cb = chunk_bits.to(torch.int64)
    row0 = cb[:, :-1] >> 12
    last = wrap_int32(cb[:, 1:] - 1).to(torch.int64)
    last_row = torch.maximum(((last >> 5) + 1) >> 7, row0)
    return row0, last_row


def _parts(w0t, hit, lot):
    """(word index, value) of every hi and lo part: int64
    [F, 2, 128, nc]."""
    w0 = w0t.to(torch.int64)
    return (torch.stack([w0, w0 + 1], dim=1),
            torch.stack([hit, lot], dim=1).to(torch.int64))


def merge_first_rows_plain(w0t, hit, lot, chunk_bits, word_rows, rows: int,
                           reach: bool):
    """K5's sum over the parts whose word row is one of the chunk's first
    ``rows`` word rows, row0 to row0 + rows - 1. With ``reach`` a row after
    row0 counts only where the chunk reaches it (row <= last_row)."""
    F = w0t.shape[0]
    W = word_rows * LANE
    row0, last_row = (r[:, None, None, :] for r in chunk_rows(chunk_bits))
    word, val = _parts(w0t, hit, lot)
    row = word >> 7
    keep = (row >= row0) & (row < row0 + rows)
    if reach:
        keep &= row <= last_row
    words = sum_at(word.reshape(F, -1),
                   torch.where(keep, val, 0).reshape(F, -1), W)
    return wrap_int32(words).reshape(F, word_rows, LANE)


def merge_static2_plain(w0t, hit, lot, chunk_bits, word_rows):
    """Plain version of ``static2``: K5's sum over the parts whose word
    row is the chunk's row0 or row0 + 1."""
    return merge_first_rows_plain(w0t, hit, lot, chunk_bits, word_rows,
                                  rows=2, reach=False)


def merge_fixedrow_plain(w0t, hit, lot, chunk_bits, word_rows):
    """Plain version of ``fixedrow``: the parts whose word row lies in
    the chunk's row0..last_row, added into row 0 at their lane."""
    F = w0t.shape[0]
    row0, last_row = (r[:, None, None, :] for r in chunk_rows(chunk_bits))
    word, val = _parts(w0t, hit, lot)
    keep = ((word >> 7) >= row0) & ((word >> 7) <= last_row)
    out = torch.zeros((F, word_rows, LANE), dtype=torch.int32,
                      device=w0t.device)
    out[:, 0] = wrap_int32(sum_at(
        (word & (LANE - 1)).reshape(F, -1),
        torch.where(keep, val, 0).reshape(F, -1), LANE))
    return out


def merge_nowin_plain(w0t, hit, lot, chunk_bits, word_rows):
    """Plain version of ``nowin``: every row from a chunk's row0 to its
    last_row holds, on all lanes, the sum of the chunk's hi words."""
    row0, last_row = chunk_rows(chunk_bits)
    chunk_hi = hit.to(torch.int64).sum(dim=1)                  # [F, nc]
    rows = torch.arange(word_rows, device=w0t.device)
    inside = (rows >= row0[..., None]) & (rows <= last_row[..., None])
    row_sum = torch.where(inside, chunk_hi[..., None], 0).sum(dim=1)
    return wrap_int32(row_sum)[..., None].expand(-1, -1, LANE).contiguous()


def merge_zero_plain(w0t, hit, lot, chunk_bits, word_rows):
    """Plain version of ``zero``."""
    return torch.zeros((w0t.shape[0], word_rows, LANE), dtype=torch.int32,
                       device=w0t.device)


def _variant(name: str, plain):
    """The wrapper of one U1 kernel: K5's signature and output shape. A
    CPU tensor takes ``plain``; a CUDA tensor launches the kernel."""

    def run(w0t, hit, lot, chunk_bits, word_rows):
        if w0t.device.type == "cpu":
            return plain(w0t, hit, lot, chunk_bits, word_rows)
        if w0t.device.type != "cuda":
            raise ValueError(f"merge_{name}: no kernel for {w0t.device}")
        check_aligned(f"merge_{name}", w0t, hit, lot, chunk_bits)
        F, _, nc = w0t.shape
        words = torch.empty((F, word_rows, LANE), dtype=torch.int32,
                            device=w0t.device)
        _cuda.launch(f"flake_prof_merge_{name}", w0t.device, chunk_bits, w0t,
                     hit, lot, words, F, nc, word_rows * LANE)
        run.launches += 1
        return words

    run.launches = 0
    run.__name__ = run.__qualname__ = f"merge_{name}"
    run.__doc__ = f"U1 ``{name}``: see :func:`{plain.__name__}`."
    return run


merge_static2 = _variant("static2", merge_static2_plain)
merge_fixedrow = _variant("fixedrow", merge_fixedrow_plain)
merge_nowin = _variant("nowin", merge_nowin_plain)
merge_zero = _variant("zero", merge_zero_plain)
VARIANTS = {"static2": (merge_static2, merge_static2_plain),
            "fixedrow": (merge_fixedrow, merge_fixedrow_plain),
            "nowin": (merge_nowin, merge_nowin_plain),
            "zero": (merge_zero, merge_zero_plain)}


def make_batch(frames: int = FRAMES, kind: str = "music"):
    """The tools' batch: (samples int32 [frames, 4096, 2], header bytes,
    header byte counts, FrameConfig). ``music`` is a 440 Hz tone plus
    noise (``util/prof_merge.py:38-55``); ``noise`` is uniform int16 on
    both channels, which the encoder emits verbatim, the left channel drawn
    from ``default_rng(0)`` before the right (``util/prof_merge2.py:41-53``
    and ``util/prof_merge3.py:52-63`` draw the same stream)."""
    p = P.set_defaults(8)
    cfg = FrameConfig.from_params(p, CHANNELS, BPS, block_size=BLOCK)
    rng = np.random.default_rng(0)
    n = frames * BLOCK
    if kind == "music":
        sig = 12000 * np.sin(2 * np.pi * 440 * np.arange(n) / 44100) \
            + 800 * rng.standard_normal(n)
        left = np.clip(sig, -32768, 32767).astype(np.int32)
        right = np.clip(0.8 * sig, -32768, 32767).astype(np.int32)
    elif kind == "noise":
        left = rng.integers(-32768, 32767, n).astype(np.int32)
        right = rng.integers(-32768, 32767, n).astype(np.int32)
    else:
        raise ValueError(f"make_batch: unknown kind {kind!r}")
    samples = np.stack([left, right], -1).reshape(frames, BLOCK, CHANNELS)
    hdr_bytes, hdr_nb = bitpack.frame_header_bytes(
        np.arange(frames, dtype=np.uint32), bs_code=P.blocksize_code(BLOCK),
        sr_code=P.samplerate_code(SAMPLE_RATE), allow_vbs=p.allow_vbs)
    return samples, hdr_bytes, hdr_nb, cfg


def batch_slots(kind: str, frames: int, device: torch.device):
    """The slot tables of the tools' ``kind`` batch, analysed at level 8
    on ``device`` with 48 header bits a frame as the JAX tools analyse it:
    ((lengths, leading, payload) int32 [frames, M], FrameConfig)."""
    samples, hdr_bytes, hdr_nb, cfg = make_batch(frames, kind)
    analysis = analyze_frames(
        torch.from_numpy(samples).to(device), cfg,
        torch.full((frames,), 48, dtype=torch.int32, device=device))
    return bitpack.slot_layout(analysis, torch.from_numpy(hdr_bytes).to(device),
                               torch.from_numpy(hdr_nb).to(device), cfg), cfg


MAX_SPIN_US = 2_000_000


def spin(device: torch.device, ms: float) -> None:
    """Keep ``device``'s current stream busy for ``ms`` (at most 2 s): the
    timing aid ``flake_spin_us`` of ``csrc/prof_merge.cu``, which is no
    kernel of the encoder and replaces none."""
    _cuda.launch("flake_spin_us", device,
                 min(max(int(ms * 1e3), 1), MAX_SPIN_US))


def device_ms(fn, device: torch.device, iters: int = 20,
              back_to_back: bool = False) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls between two CUDA
    events. By default a plain loop: the stage as its caller sees it, the
    host's launch gaps included. ``back_to_back`` is for a single short
    kernel, which the card finishes sooner than the host can enqueue the
    next, so that the loop would time the host's launch rate: after the
    loop, which then only tells how long the host needs, the calls are
    enqueued again behind a spinning kernel that outlasts the enqueueing
    and run with no gap, and the reading is the card's time alone. The
    caller chooses; nothing is decided from a measurement. Back to back,
    the same inputs and outputs may stay in the card's L2 between calls."""
    def run(spin_ms):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin_ms:
            spin(device, spin_ms)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        return start.elapsed_time(end), host_ms

    with torch.cuda.device(device):
        total_ms, host_ms = run(0)
        if back_to_back:
            total_ms, _ = run(2 * host_ms + 0.5)
    return total_ms / iters


def time_ms(fn, device: torch.device, iters: int = 20,
            back_to_back: bool = False) -> float:
    """The least of three means of ``iters`` calls of ``fn``, in ms, after
    two warm-up calls: :func:`device_ms` on a GPU, the host clock on the
    CPU."""
    fn()
    fn()
    best = None
    for _ in range(3):
        if device.type == "cuda":
            ms = device_ms(fn, device, iters, back_to_back)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) * 1e3 / iters
        best = ms if best is None else min(best, ms)
    return best


def main(device="cuda", frames: int = FRAMES, iters: int = 20) -> dict:
    """Time every stage on ``device`` and print the result as one JSON
    line. Returns the dict."""
    dev = resolve_device(device)
    samples, hdr_bytes, hdr_nb, cfg = make_batch(frames)
    x = torch.from_numpy(samples).to(dev)
    hb = torch.from_numpy(hdr_bytes).to(dev)
    hn = torch.from_numpy(hdr_nb).to(dev)
    hdr_bits = torch.full((frames,), 48, dtype=torch.int32, device=dev)
    wr = bitpack.word_rows(cfg)

    analysis = analyze_frames(x, cfg, hdr_bits)
    slots = bitpack.slot_layout(analysis, hb, hn, cfg)
    parts = bitpack.aligned_parts(*slots)
    res = {"F": frames, "nc": parts[0].shape[-1], "wr": wr}

    def ms(fn, back_to_back=False):
        return round(time_ms(fn, dev, iters, back_to_back), 3)

    # the stages of many launches in a plain loop, each single kernel back
    # to back
    res["analysis_ms"] = ms(lambda: analyze_frames(x, cfg, hdr_bits))
    res["emit_full_ms"] = ms(lambda: bitpack.pack_frames_device(
        analyze_frames(x, cfg, hdr_bits), hb, hn, cfg))
    res["prep_ms"] = ms(lambda: bitpack.aligned_parts(
        *bitpack.slot_layout(analysis, hb, hn, cfg)))
    res["merge_now_ms"] = ms(lambda: merge_aligned(*parts, wr), True)
    for name, (kernel, _) in VARIANTS.items():
        res[f"merge_{name}_ms"] = ms(lambda: kernel(*parts, wr), True)
    res["merge_k3_ms"] = ms(lambda: merge_words(*slots, wr), True)

    # correctness spot check for static2 on this content
    res["static2_matches"] = torch.equal(merge_aligned(*parts, wr),
                                         merge_static2(*parts, wr))
    audio_s = frames * BLOCK / SAMPLE_RATE
    res["pipeline_xrt_now"] = round(audio_s / (res["emit_full_ms"] / 1e3), 1)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=FRAMES)
    args = ap.parse_args()
    main(args.device, args.frames)
