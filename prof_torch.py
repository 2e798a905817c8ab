#!/usr/bin/env python3
"""Where the device time goes in ``Encoder.encode_stream`` on one GPU.

For each level asked for, encodes ``chip_smoke.py``'s deterministic stream
(180 s at levels 0-8, the encoder's default level 5 among them; the 60 s
stream with level jumps, bursts and silences at levels 9-12) once to warm
up, three times timed on the host clock, and
once under ``torch.profiler``. Prints the warm walls, the profiled wall,
the device's busy time (the union of its kernel and copy intervals), its
device events and the encoder's batches (and their ratio), the idle share
of the median warm wall that this leaves, the host ms a batch in each of
the program's ``flake.`` spans (the Encoder's and the stages', each whole,
the spans inside it included), and the operators with the most device
time.

    python3 prof_torch.py [--levels 8 5 12 11] [--rows 14]

Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import chip_smoke


def busy_ms(events) -> tuple[float, int]:
    """Union of the device events' intervals, in ms, and their count; the
    spans the profiler also draws on the device's timeline are no device
    work and are left out."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.name.startswith("flake."))
    total, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1000, len(spans)


def span_ms(events, batches: int) -> dict:
    """Host ms a batch in each ``flake.`` span, by name."""
    import torch

    out: dict = {}
    for e in events:
        if e.name.startswith("flake.") \
                and e.device_type == torch.autograd.DeviceType.CPU:
            out[e.name] = out.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1000 / batches
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--levels", type=int, nargs="+", default=[8, 5, 12, 11])
    ap.add_argument("--rows", type=int, default=14)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        chip_smoke.fail("CUDA is not available")
    sys.path.insert(0, str(chip_smoke.ROOT))
    from flake_tpu_torch import params as P
    from flake_tpu_torch.encoder import Encoder

    print(torch.cuda.get_device_name(0), flush=True)
    streams = {}
    for level in args.levels:
        key = "fixed" if level <= 8 else "vbs"
        if key not in streams:
            streams[key] = chip_smoke.make_stream(chip_smoke.SEED) \
                if key == "fixed" else chip_smoke.make_vbs_stream(
                    chip_smoke.SEED + 12, chip_smoke.VBS_SECONDS)
        pcm = streams[key]
        cfg = P.StreamConfig(channels=2, sample_rate=chip_smoke.SAMPLE_RATE,
                             bits_per_sample=16, params=P.set_defaults(level))

        def run():
            enc = Encoder(cfg, device="cuda")
            enc.encode_stream(pcm)
            torch.cuda.synchronize()
            return enc.stats["batches"]

        run()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            batches = run()
            prof_wall = time.perf_counter() - t0
        busy, n_ev = busy_ms(prof.events())
        warm = statistics.median(walls)
        secs = pcm.shape[0] / chip_smoke.SAMPLE_RATE
        print(f"level {level}, {secs:g} s: warm walls "
              f"{[round(w, 4) for w in walls]} s; profiled wall "
              f"{prof_wall * 1000:.1f} ms, device busy {busy:.1f} ms in "
              f"{n_ev} device events ({batches} batches, "
              f"{n_ev / batches:.1f} events a batch); idle share of the "
              f"median warm wall {1 - busy / 1000 / warm:.3f}", flush=True)
        print("host ms a batch by span: " + "; ".join(
            f"{k} {v:.4f}" for k, v in sorted(
                span_ms(prof.events(), batches).items())), flush=True)
        print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                        row_limit=args.rows), flush=True)


if __name__ == "__main__":
    main()
