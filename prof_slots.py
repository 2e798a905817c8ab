#!/usr/bin/env python3
"""Where the emission's device memory goes: ``ops/bitpack.slot_layout``.

Encodes ``chip_smoke.py``'s deterministic streams (180 s at level 8, the
60 s stream with level jumps, bursts and silences at level 12) with
``slot_layout`` run under ``chip_smoke.live_tensors`` and prints, for each
level, one JSON line: the peak device memory above its start of
``slot_layout``, of ``merge_words`` (K3) and of ``pack_frames_device`` (the
emission, with both inside it), the most bytes of the slot layout's own
tensors alive at once, the tensors alive then (operation, shape, dtype,
MiB), its operation count and the batch shape. Then one line for a level-8
batch of 512 frames: the CUDA kernels one ``slot_layout`` call launches and
their device time (``torch.profiler``), and five warm walls of the call.

    python3 prof_slots.py [CHECKOUT]

``CHECKOUT`` is the root of the checkout whose ``flake_tpu_torch`` is
traced (default: this one), so that two commits run in one call through
the same script. Needs one CUDA device.
"""

from __future__ import annotations

import functools
import json
import pathlib
import sys
import time

import chip_smoke


def main() -> None:
    root = pathlib.Path(sys.argv[1] if len(sys.argv) > 1
                        else chip_smoke.ROOT).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        chip_smoke.fail("CUDA is not available")
    from flake_tpu_torch import params as P
    from flake_tpu_torch.encoder import Encoder
    from flake_tpu_torch.ops import bitpack, frame

    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    print(f"{torch.cuda.get_device_name(0)}; tracing {bitpack.__file__}",
          flush=True)
    streams = (("level 8", 8, chip_smoke.make_stream(chip_smoke.SEED)),
               ("level 12", 12, chip_smoke.make_vbs_stream(
                   chip_smoke.SEED + 12, chip_smoke.VBS_SECONDS)))
    for label, level, pcm in streams:
        cfg = P.StreamConfig(channels=2, sample_rate=chip_smoke.SAMPLE_RATE,
                             bits_per_sample=16, params=P.set_defaults(level))
        peaks, layout = {}, {"live": 0}
        originals = {name: getattr(bitpack, name) for name in
                     ("slot_layout", "merge_words", "pack_frames_device")}

        def wrap(name, orig):
            # wraps carries the kernel wrapper's launch count, which it
            # bumps under the name it looks itself up by
            @functools.wraps(orig)
            def run(*args):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                start = torch.cuda.memory_allocated(dev)
                if name == "slot_layout":
                    out, live, at_peak, ops = chip_smoke.live_tensors(
                        lambda: orig(*args), top=30)
                    if live > layout["live"]:
                        layout.update(live=live, at_peak=at_peak, ops=ops,
                                      shape=list(args[0]["residual"].shape))
                else:
                    out = orig(*args)
                torch.cuda.synchronize()
                peaks[name] = max(peaks.get(name, 0), torch.cuda
                                  .max_memory_allocated(dev) - start)
                return out
            return run

        for name, orig in originals.items():
            setattr(bitpack, name, wrap(name, orig))
        try:
            Encoder(cfg, device="cuda").encode_stream(pcm)
        finally:
            for name, orig in originals.items():
                setattr(bitpack, name, orig)
        print(json.dumps({
            "label": label, "device": torch.cuda.get_device_name(0),
            "peak_above_start_mib": {k: round(v / 2**20, 1)
                                     for k, v in peaks.items()},
            "slot_layout_live_mib": round(layout["live"] / 2**20, 1),
            "slot_layout_operations": layout["ops"],
            "residual_shape": layout["shape"],
            "alive_at_peak": layout["at_peak"]}), flush=True)

    # the kernels of one slot layout of a level-8 batch
    F, B = 512, 4096
    pcm = streams[0][2]
    fcfg = frame.FrameConfig.from_params(P.set_defaults(8), 2, 16)
    hb, hnb = bitpack.frame_header_bytes(
        np.arange(F), bs_code=P.blocksize_code(B),
        sr_code=P.samplerate_code(chip_smoke.SAMPLE_RATE), allow_vbs=0)
    analysis = frame.analyze_frames(
        torch.from_numpy(pcm[:F * B].reshape(F, B, 2)).to(dev), fcfg,
        torch.from_numpy(hnb * 8).to(dev))
    args = (analysis, torch.from_numpy(hb).to(dev),
            torch.from_numpy(hnb).to(dev), fcfg)
    for _ in range(3):
        bitpack.slot_layout(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bitpack.slot_layout(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bitpack.slot_layout(*args)
        torch.cuda.synchronize()
        walls.append(round((time.perf_counter() - t0) * 1000, 3))
    print(json.dumps({
        "slot_layout_level8_batch": [F, B], "cuda_kernels": len(kernels),
        "device_ms": round(sum(e.device_time for e in kernels) / 1000, 4),
        "wall_ms": walls}), flush=True)


if __name__ == "__main__":
    main()
