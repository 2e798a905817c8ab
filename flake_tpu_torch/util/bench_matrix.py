"""Benchmark matrix over the BASELINE.md configs on one GPU (port of
``util/bench_matrix.py``).

For each named config it times (a) the batched analysis
(:func:`~flake_tpu_torch.ops.frame.analyze_frames`) and (b) the analysis
plus the device emission (:func:`~flake_tpu_torch.ops.bitpack.
pack_frames_device`) of one batch, checks that a 3 s stream encodes to
the same bytes under the host and the device emission and decodes
losslessly with its MD5 (raising otherwise), and prints one JSON line a
config with the JAX tool's keys and one more, ``peak_mib``: the config's
peak device memory in MiB (null on the CPU), as the level-12 batch's Rice
k scan holds GiB of int64 grids.

A batch keeps the JAX tool's footprint rule, ``F = max(64, min(512,
512*4096*2 // (B*C)))`` frames of the preset's block size; levels 11-12
run fixed superblocks of 8192 samples, as the JAX tool does (their sweep
is K4's order-32 one). The four input batches are made once with numpy
and uploaded before the timing; each time is :func:`flake_tpu_torch.
bench.per_call_ms`'s (CUDA events around a plain loop of calls, the
host's launch gaps included, the upload excluded).

    python -m flake_tpu_torch.util.bench_matrix [--device cuda|cpu]
        [--quick] [--only NAME] [--frames F]

``--quick`` skips the parity encodes; ``--frames`` overrides F, for a
small run on the CPU.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from flake_tpu_torch import params as P
from flake_tpu_torch.bench import frame_headers, per_call_ms
from flake_tpu_torch.decoder import decode_stream
from flake_tpu_torch.encoder import Encoder, resolve_device
from flake_tpu_torch.graft_entry import pipeline_step
from flake_tpu_torch.ops.frame import FrameConfig, analyze_frames
from flake_tpu_torch.profiling import card_name

CONFIGS = [
    # name, level, bps, sample_rate, channels, block override
    ("level5_default", 5, 16, 44100, 2, None),
    ("level8_cd", 8, 16, 44100, 2, None),
    ("level8_hires_24_96", 8, 24, 96000, 2, None),
    ("level11_vbs_8192", 11, 16, 44100, 2, None),
    ("level12_vbs_8192", 12, 16, 44100, 2, None),
    ("level8_6ch_48", 8, 16, 48000, 6, None),
]


def batch_frames(block: int, channels: int) -> int:
    """The JAX tool's batch: about 4 Mi samples whatever the shape."""
    return max(64, min(512, (512 * 4096 * 2) // (block * channels)))


def make_audio(F: int, B: int, C: int, bps: int, seed: int) -> list:
    """Four int32 [F, B, C] batches: a 440 Hz tone at 0.4 of full scale,
    channel c at ``linspace(1.0, 0.6, C)[c]`` of it, plus noise at 0.02,
    from ``default_rng(seed + i)`` (``util/bench_matrix.py:34-50``)."""
    lim = np.float32((1 << (bps - 1)) - 1)
    t = np.arange(F * B, dtype=np.float32)
    sig = np.float32(0.4) * lim * np.sin(
        np.float32(2 * np.pi * 440.0 / 44100.0) * t)
    gains = np.linspace(1.0, 0.6, C, dtype=np.float32)
    out = []
    for i in range(4):
        noise = np.random.default_rng(seed + i).standard_normal(
            (F * B, C), dtype=np.float32)
        chans = sig[:, None] * gains[None, :] + np.float32(0.02) * lim * noise
        out.append(np.clip(chans, -lim, lim - 1).astype(np.int32)
                   .reshape(F, B, C))
    return out


def parity(level: int, bps: int, sr: int, C: int, device,
           seconds: float = 3.0) -> tuple[bool, float]:
    """Encode ``seconds`` of a tone plus noise under the host and the
    device emission: the bytes must be equal and decode losslessly with
    their MD5, else this raises. Returns (True, compressed / raw bytes)."""
    n = int(sr * seconds)
    rng = np.random.default_rng(level)
    lim = (1 << (bps - 1)) - 1
    t = np.arange(n)
    sig = (0.4 * lim * np.sin(2 * np.pi * 440 * t / sr))
    pcm = np.stack([sig * (1 - 0.05 * c) for c in range(C)], axis=1)
    pcm += rng.normal(0, 0.02 * lim, pcm.shape)
    pcm = np.clip(pcm, -lim, lim - 1).astype(np.int32)

    cfg = P.StreamConfig(channels=C, sample_rate=sr, bits_per_sample=bps,
                         samples=n, params=P.set_defaults(level))
    host = Encoder(cfg, device=device,
                   pack_backend="host").encode_stream(pcm)
    dev = Encoder(cfg, device=device,
                  pack_backend="device").encode_stream(pcm)
    if host != dev:
        raise AssertionError(f"level {level}: the device emission's "
                             "bytes differ from the host packer's")
    d = decode_stream(host)
    if not (d.md5_ok and np.array_equal(d.samples, pcm)):
        raise AssertionError(f"level {level}: the stream is not lossless")
    return True, len(host) / (n * C * ((bps + 7) // 8))


def run(device="cuda", quick: bool = False, only: str | None = None,
        frames: int | None = None) -> list[dict]:
    """One row a config (every config, or ``only``), each printed as a
    JSON line as it is done; returns the rows."""
    dev = resolve_device(device)
    card = card_name(dev)
    rows = []
    for name, level, bps, sr, C, bs_over in CONFIGS:
        if only and name != only:
            continue
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        p = P.set_defaults(level)
        B = bs_over or p.block_size
        F = frames or batch_frames(B, C)
        cfg = FrameConfig.from_params(p, C, bps, block_size=B)
        inputs = [torch.from_numpy(a).to(dev)
                  for a in make_audio(F, B, C, bps, seed=level)]
        hb, hn = frame_headers(F, B, sr, p.allow_vbs)
        hdr = [torch.from_numpy(a).to(dev)
               for a in (hn.astype(np.int32) * 8, hb, hn)]
        step = pipeline_step(cfg)
        per_a = per_call_ms(lambda x: analyze_frames(x, cfg, hdr[0]),
                            inputs, dev) / 1e3
        per_e = per_call_ms(lambda x: step(x, *hdr), inputs, dev) / 1e3
        row = {
            "config": name,
            "level": level, "bps": bps, "sample_rate": sr,
            "channels": C, "block_size": B, "batch_frames": F,
            "analysis_xrt": round(F * B / per_a / sr, 1),
            "analysis_ms_per_batch": round(per_a * 1000, 3),
            "emit_xrt": round(F * B / per_e / sr, 1),
            "emit_ms_per_batch": round(per_e * 1000, 3),
            "meets_10000x": F * B / per_a / sr >= 10000.0,
            "device": card,
        }
        if not quick:
            ok, ratio = parity(level, bps, sr, C, dev)
            row["device_pack_parity"] = ok
            row["ratio_vs_raw"] = round(ratio, 4)
        row["peak_mib"] = round(torch.cuda.max_memory_allocated(dev)
                                / 2 ** 20, 1) if dev.type == "cuda" else None
        print(json.dumps(row), flush=True)
        rows.append(row)
    if only and not rows:
        raise ValueError(f"no config named {only!r}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="skip the parity encode (device timing only)")
    ap.add_argument("--only", default=None,
                    help="run a single named config")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames a batch (default: the footprint rule)")
    args = ap.parse_args(argv)
    run(args.device, args.quick, args.only, args.frames)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
