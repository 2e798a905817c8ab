#!/usr/bin/env python3
"""The card's busy and idle time in a benchmark cell, by the program's
stage spans (the ``flake.`` ranges of ``profiling.annotate``).

For each cell asked for, builds the cell's pool from the seed and warms it
as ``flakebench.run`` does, then profiles ``--batches`` batches of the
closed loop with the pipeline's two layer calls, as ``--trace 1``'s
profiled stretch does, and puts the trace down to the spans
(``flakebench/spans.py``). Prints, in ms a batch, each span's busy time
(its own events' union), the idle time its launches ended and its events;
the same for the analysis and the emission whole, their inner spans
included; then the stretch's busy union, host window and events, and the
share of busy time no span holds; last one JSON line a cell.

    python3 prof_spans.py [--cells level8_cd.bulk level5_cd.bulk]
                          [--seed 1] [--batches 100]

Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json


def profile_cell(cell_name: str, seed: int, count: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from flakebench import run, spans, trace

    cell = run.load("cells", cell_name)
    cfg = run.load("configs", cell["config"])
    mix = run.load("traffic", cell["traffic"])
    dev = torch.device("cuda", 0)
    batches = run.make_batches(mix, cfg, seed, dev)
    step = run.pipeline(run.program_config(cfg), layered=True)
    clock = run.Clock(dev)
    for batch in batches:
        step(clock, batch, lambda name: contextlib.nullcontext())
    clock.sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rec, _ = run.drive(step, batches, clock, mix["in_flight"],
                           count=count, span=record_function)
    clock.sync()
    events = prof.events()
    red = trace.reduce_events(*trace.split_profile(events, run.SPANS))
    by_span = spans.attribute(*spans.from_events(events))
    n = rec["batches"]
    whole = {"profile": {"batches": n, "spans": by_span}}
    return {"cell": cell_name, "seed": seed, "batches": n,
            "busy_ms": red["busy_s"] * 1e3 / n,
            "window_ms": rec["window_s"] * 1e3 / n,
            "events": red["device_events"] / n,
            # each layer's span with the spans inside it
            "layers": {k: {"busy_ms": spans.per_batch_ms(whole, k, "busy_s"),
                           "idle_ms": spans.per_batch_ms(whole, k, "idle_s")}
                       for k in ("flake.analysis", "flake.emission")},
            "spans": {k: {"busy_ms": v["busy_s"] * 1e3 / n,
                          "idle_ms": v["idle_s"] * 1e3 / n,
                          "events": v["events"] / n}
                      for k, v in sorted(by_span.items())}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="+",
                    default=["level8_cd.bulk", "level5_cd.bulk"])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--batches", type=int, default=100)
    args = ap.parse_args()
    for name in args.cells:
        out = profile_cell(name, args.seed, args.batches)
        print(f"{name}, seed {args.seed}, {out['batches']} batches; "
              "ms a batch (busy, idle, events):")
        for k, v in out["spans"].items():
            print(f"  {k:28s} {v['busy_ms']:.4f}  {v['idle_ms']:.4f}  "
                  f"{v['events']:g}")
        for k, v in out["layers"].items():
            if v["busy_ms"] is not None:
                print(f"  {k + ', whole':28s} {v['busy_ms']:.4f}  "
                      f"{v['idle_ms']:.4f}")
        held = sum(v["busy_ms"] for k, v in out["spans"].items()
                   if k.startswith("flake."))
        lost = out["spans"].get("unattributed", {}).get("busy_ms", 0.0)
        share = 100 * lost / out["busy_ms"] if out["busy_ms"] else 0.0
        print(f"  stretch busy {out['busy_ms']:.4f} of {out['window_ms']:.4f}"
              f", {out['events']:g} events; the spans hold {held:.4f}, "
              f"unattributed {share:.3f}% of busy", flush=True)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
