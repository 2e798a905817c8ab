"""Scaling of the port across devices and ranks (port of
``util/scaling_report.py``).

Two tables:

1. the dp analysis (:func:`~flake_tpu_torch.parallel.mesh.
   make_sharded_analyzer`, level 8, stereo 16-bit frames) on meshes of 1,
   2, 4, ... of the devices: frames/s and the efficiency against linear
   scaling from one device;
2. the launcher (:mod:`flake_tpu_torch.parallel.launch`, ``--spawn r``)
   on a WAV of ``--seconds`` of stereo 16-bit audio at level 8, for r = 1,
   2, 4, ... ranks: the slowest rank's encode seconds, the x-realtime and
   the efficiency, beside the launcher's wall.

With one card the devices are that card twice (``cuda:0, cuda:0``) and the
ranks share it over ``gloo``; the output says so. With a card a device,
ranks take ``nccl``. ``--device cpu`` runs both tables on the host (two
"devices" that are the same cores). The last line is one JSON object of
every number, with the card's name and power limit.

    python -m flake_tpu_torch.util.scaling_report [--device cuda|cpu]
        [--frames-per-device 256] [--block 4096] [--seconds 60]
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

from flake_tpu_torch.profiling import card_name


def _sizes(n: int) -> list[int]:
    sizes, d = [], 1
    while d <= n:
        sizes.append(d)
        d *= 2
    return sizes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_table(devices: list, fpd: int, block: int, sync) -> list[dict]:
    """frames/s of the dp analysis on meshes of 1, 2, 4, ... of
    ``devices``."""
    from flake_tpu_torch import params as P
    from flake_tpu_torch.ops.frame import FrameConfig
    from flake_tpu_torch.parallel.mesh import make_mesh, make_sharded_analyzer

    cfg = FrameConfig.from_params(P.set_defaults(8), channels=2, bps=16,
                                  block_size=block)
    rng = np.random.default_rng(0)
    rows = []
    for nd in _sizes(len(devices)):
        run = make_sharded_analyzer(cfg, make_mesh(devices=devices[:nd]))
        F = fpd * nd
        samples = rng.integers(-30000, 30000, (F, block, 2)).astype(np.int32)
        hdr = np.full((F,), 48, np.int32)
        run(samples, hdr)
        sync()
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(3):
                out = run(samples, hdr)
            int(out["global_max_frame_bytes"])
            sync()
            dt = (time.perf_counter() - t0) / 3
            best = dt if best is None else min(best, dt)
        fps = F / best
        base = rows[0]["frames_per_s"] if rows else fps
        rows.append({"devices": nd, "frames_per_s": fps,
                     "x_realtime": fps * block / 44100,
                     "efficiency": fps / (base * nd)})
    return rows


def rank_table(n_ranks: int, device: str, backend: str,
               seconds: int) -> list[dict]:
    """The launcher at 1, 2, 4, ... ranks on one WAV: the slowest rank's
    encode seconds and the x-realtime."""
    from flake_tpu_torch.io.wav import write_wave

    rate = 44100
    n = seconds * rate
    t = np.arange(n) / rate
    rng = np.random.default_rng(1)
    pcm = np.stack([9000 * np.sin(2 * np.pi * 220 * t),
                    8000 * np.sin(2 * np.pi * 277 * t + 0.3)], axis=1)
    pcm = np.clip(np.rint(pcm + rng.normal(0, 150, pcm.shape)), -32768,
                  32767).astype(np.int32)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        wav = f"{tmp}/in.wav"
        write_wave(wav, pcm, rate, 16)
        for r in _sizes(n_ranks):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "flake_tpu_torch.parallel.launch",
                 "--spawn", str(r), "--backend", backend, "--device", device,
                 "--coordinator", f"127.0.0.1:{_free_port()}", "--level", "8",
                 "--stats", wav, "-o", f"{tmp}/out{r}.flac"],
                capture_output=True, text=True, timeout=900)
            wall = time.perf_counter() - t0
            if proc.returncode:
                raise RuntimeError(f"{r} ranks exited {proc.returncode}:\n"
                                   f"{proc.stderr[-4000:]}")
            stats = [json.loads(line) for line in proc.stdout.splitlines()
                     if line.startswith("{")]
            encode_s = max(s["encode_s"] for s in stats)
            base = rows[0]["x_realtime"] if rows else seconds / encode_s
            rows.append({"ranks": r, "encode_s": encode_s,
                         "x_realtime": seconds / encode_s,
                         "efficiency": seconds / encode_s / (base * r),
                         "launcher_wall_s": wall,
                         "peak_host_mib": max(s["peak_host_mib"]
                                              for s in stats)})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="scaling_report")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--frames-per-device", type=int, default=256)
    p.add_argument("--block", type=int, default=4096)
    p.add_argument("--seconds", type=int, default=60)
    args = p.parse_args(argv)

    import torch

    card = card_name(args.device)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("scaling_report: CUDA is not available", file=sys.stderr)
            return 1
        count = torch.cuda.device_count()
        shared = count == 1
        devices = ["cuda:0", "cuda:0"] if shared \
            else [f"cuda:{i}" for i in range(count)]
        rank_device, backend = ("cuda:0", "gloo") if shared \
            else ("cuda", "nccl")

        def sync():
            for i in range(count):
                torch.cuda.synchronize(i)
    else:
        shared = True
        devices, rank_device, backend = ["cpu", "cpu"], "cpu", "gloo"

        def sync():
            pass
    where = (f"{len(devices)} devices that are one {card} (shared)"
             if shared else f"{len(devices)} x {card}")
    print(f"dp analysis, level 8, {args.block}-sample stereo frames, "
          f"{args.frames_per_device} frames a device, on {where}")
    mesh_rows = mesh_table(devices, args.frames_per_device, args.block, sync)
    print("devices  frames/s   x-realtime   efficiency")
    for row in mesh_rows:
        print(f"{row['devices']:7d}  {row['frames_per_s']:8.0f}   "
              f"{row['x_realtime']:10.0f}   {row['efficiency']:9.1%}")
    print(f"\nlauncher, level 8, {args.seconds} s of stereo 16-bit, "
          f"--backend {backend} --device {rank_device}"
          + (f": the ranks share one {card}" if shared else ""))
    rank_rows = rank_table(len(devices), rank_device, backend, args.seconds)
    print("ranks  encode s   x-realtime   efficiency   launcher wall s")
    for row in rank_rows:
        print(f"{row['ranks']:5d}  {row['encode_s']:8.3f}   "
              f"{row['x_realtime']:10.1f}   {row['efficiency']:9.1%}   "
              f"{row['launcher_wall_s']:14.2f}")
    print(json.dumps({"card": card, "shared": shared,
                      "mesh": mesh_rows, "ranks": rank_rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
