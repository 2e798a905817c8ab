"""The analysis pipeline of one batch by stage (port of
``util/prof_an5.py``).

The JAX tool's batch (F = 512 frames of B = 4096 16-bit stereo samples,
a 440 Hz tone plus noise from ``default_rng(0)``) at the level given, its
stages those of :func:`flake_tpu_torch.ops.frame._lpc_search`, on the
stereo channels as they are (``obits`` 17, as after decorrelation):

  autocorr_ms          K1 alone (``ops/autocorr.autocorr``)
  schur_lev_quant_ms   Levinson (Schur and seeded Levinson under EST) and
                       the quantizer (``frame.lpc_candidates``)
  sweep_bits_ms        the sweep and the Rice scan of every candidate
                       order (``frame.candidate_bits``)
  sweep_kernel_ms      the sweep's kernel alone
  final_res_rice_ms    the final residual and its Rice parameters at the
                       highest order (``frame.final_residual``)
  full_ms              ``analyze_frames`` end to end

The two sweep keys are there where the order method reads bit counts
(not under EST or MAX). One key is added to the JAX tool's: the port
routes a sweep to K4 wherever it can sum the shape and to K2 elsewhere
(``frame.sweep_route``), and ``sweep_route`` names the kernel timed
(``"K4"`` or ``"K2"``; null where no sweep runs); the JAX tool calls its
K2 directly.

Each stage is the least of three readings of ``prof_merge.time_ms``
(CUDA events, :func:`flake_tpu_torch.util.prof_merge.device_ms`): the
single kernels back to back, so that the card's time and not the host's
launch rate is read; the stages of many launches in a plain loop, with
the host's launch gaps, as the pipeline sees them.

    python -m flake_tpu_torch.util.prof_an5 [LEVEL] [--device cuda|cpu]
        [--frames 512] [--block 4096]

Prints one JSON line. ``--frames`` and ``--block`` are for a small run
on the CPU, where the stages are the plain versions on the host's clock.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from flake_tpu_torch import params as P
from flake_tpu_torch.encoder import resolve_device
from flake_tpu_torch.ops import frame, lpc
from flake_tpu_torch.ops.autocorr import autocorr
from flake_tpu_torch.ops.rice import limit_max_partition_order
from flake_tpu_torch.util.prof_merge import time_ms

FRAMES, BLOCK, CHANNELS, BPS = 512, 4096, 2, 16
ITERS = 10          # calls between the CUDA events of one reading


def make_batch(frames: int, block: int) -> np.ndarray:
    """int32 [frames, block, 2] (``util/prof_an5.py:225-231``)."""
    rng = np.random.default_rng(0)
    t = np.arange(frames * block)
    sig = 12000 * np.sin(2 * np.pi * 440 * t / 44100) \
        + 800 * rng.standard_normal(frames * block)
    l = np.clip(sig, -32768, 32767).astype(np.int32)
    r = np.clip(0.8 * sig, -32768, 32767).astype(np.int32)
    return np.stack([l, r], -1).reshape(frames, block, CHANNELS)


def run(level: int = 8, device="cuda", frames: int = FRAMES,
        block: int = BLOCK) -> dict:
    """Time every stage at ``level`` on ``device`` and print the result
    as one JSON line; returns the dict."""
    dev = resolve_device(device)
    cfg = frame.FrameConfig.from_params(P.set_defaults(level), CHANNELS,
                                        BPS, block_size=block)
    B = cfg.block_size
    max_o = cfg.max_prediction_order
    N = frames * CHANNELS
    samples = torch.from_numpy(make_batch(frames, B)).to(dev)
    hdr_bits = torch.full((frames,), 48, dtype=torch.int32, device=dev)
    cN = samples.permute(0, 2, 1).reshape(N, B).contiguous()
    obitsN = torch.full((N,), 17, dtype=torch.int32, device=dev)
    window = lpc.welch_window_on(B, dev)

    def ms(fn, back_to_back=False):
        return round(time_ms(fn, dev, ITERS, back_to_back), 3)

    # the stage inputs, made once
    autoc = autocorr(cN, window, max_o)
    qcoefs, shifts, _ = frame.lpc_candidates(cfg, autoc)
    qcoefs, shifts = qcoefs.contiguous(), shifts.contiguous()

    need_bits = cfg.order_method not in (P.OrderMethod.MAX,
                                         P.OrderMethod.EST)
    pmax_static = limit_max_partition_order(cfg.max_partition_order, B, 1)
    sweep, route = frame.sweep_route(B, pmax_static)
    res = {"level": level, "B": B, "max_o": max_o,
           "order_method": int(cfg.order_method),
           "sweep_route": route if need_bits else None}
    res["autocorr_ms"] = ms(lambda: autocorr(cN, window, max_o), True)
    res["schur_lev_quant_ms"] = ms(lambda: frame.lpc_candidates(cfg, autoc))
    if need_bits:
        res["sweep_bits_ms"] = ms(lambda: frame.candidate_bits(
            cfg, cN, qcoefs, shifts, obitsN))
        res["sweep_kernel_ms"] = ms(lambda: sweep(
            cN, qcoefs, shifts, max_o, pmax_static), True)
    order0 = torch.full((N,), max_o, dtype=torch.int32, device=dev)
    res["final_res_rice_ms"] = ms(lambda: frame.final_residual(
        cfg, cN, qcoefs, shifts, order0))
    res["full_ms"] = ms(lambda: frame.analyze_frames(samples, cfg,
                                                     hdr_bits))
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("level", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--block", type=int, default=BLOCK)
    args = ap.parse_args(argv)
    run(args.level, args.device, args.frames, args.block)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
