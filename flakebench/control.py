"""Readings for the limits of ``correct``: the program and its control, held
against the plain reference on one card.

    python3 -m flakebench.control --workload <cell> --seeds 11 12 13 [--program]

For each seed it makes the cell's pool on the card, as a run does, passes
every batch once through the pipeline and compares as many frames as a
run does (``check.py``), for the control: the port's own lower precision,
``FrameConfig(lpc_dtype="float32")`` (the autocorrelation and the LPC
recursions in float32 in place of the configuration's float64), which
keeps a stream lossless and changes its bytes. With ``--program`` it
reads the program as configured on the same seeds too. One JSON line a
seed and side: ``{"side", "seed", "frames_differ", "frames",
"differ_pct"}``, the last the number a run compares. The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from flakebench import check, run
from flakebench.reference.flac_plain import Config


def readings(workload: str, seed: int, lpc_dtype: str, dev,
             frames=None) -> dict:
    """One pass of the pool through the pipeline under ``lpc_dtype``, and
    its frames that differ from the reference."""
    import torch

    cell = run.load("cells", workload)
    cfg = run.load("configs", cell["config"])
    mix = run.load("traffic", cell["traffic"])
    batches = run.make_batches(mix, cfg, seed, dev, frames)
    prog = dataclasses.replace(run.program_config(cfg), lpc_dtype=lpc_dtype)
    step = run.pipeline(prog, False)
    clock = run.Clock(dev)
    outs = [step(clock, batch, None)[0] for batch in batches]
    picked = check.sample(batches, outs, mix["check_frames_per_batch"], seed)
    del batches, outs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    differ = sum(check.count(picked, Config.from_file(cfg)))
    frames = sum(g["samples"].shape[0] for g in picked)
    return {"frames_differ": differ, "frames": frames,
            "differ_pct": 100.0 * differ / frames}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("flakebench.control: no CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    sides = [("control", "float32")]
    if args.program:
        sides.append(("program", run.load("configs", run.load(
            "cells", args.workload)["config"]).get("lpc_dtype", "float64")))
    for seed in args.seeds:
        for side, dtype in sides:
            r = readings(args.workload, seed, dtype, dev)
            print(json.dumps({"cell": args.workload, "side": side,
                              "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
