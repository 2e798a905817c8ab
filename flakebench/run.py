"""The benchmark of flake_tpu_torch's device pipeline on one NVIDIA H100.

    python3 -m flakebench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's pool of input batches on the card from the seed
(``traffic/generator.py``) and warms the pipeline's one shape on each.
The window then feeds the pool's batches in turn to the port's device
pipeline entry, ``flake_tpu_torch.graft_entry.pipeline_step``, in a
closed loop with ``in_flight`` batches queued: before it dispatches
batch i it waits on batch i - in_flight's completion event, and after
each batch it records one. When ``--seconds`` have passed it dispatches
no more and synchronises. With ``--trace 1`` the window makes the
pipeline's two layer calls itself (``analyze_frames``, then
``pack_frames_device``) with a CUDA event between them, takes the host
clock around each batch's enqueue, and then runs a stretch of batches
under ``torch.profiler``. Once the window has closed and the peak memory
is read, the frames of a sample of the last outputs are held against
the plain reference (``check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` (batches in the window), ``failed`` (checked batches that
hold a frame that differs), ``metrics`` (with ``--trace 0`` the readers
of ``metrics/`` that a plain run feeds, with ``--trace 1`` those a
traced run feeds), ``device``, with ``--trace 1`` ``breakdown``, and
last ``compared``: each number compared with its limit, which the last
lines of standard error repeat. Without a card, or with fewer cards than
the cell asks for, or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "flake_tpu")
# the harness's record_function ranges in a traced run
SPANS = ("flakebench.analysis", "flakebench.emission", "flakebench.wait")


def load(kind: str, name: str) -> dict:
    """``flakebench/<kind>/<name>.json``."""
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise LookupError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                          f"named {name!r} ({path})")
    return json.loads(path.read_text())


def readers() -> dict:
    """Every metric reader of ``flakebench/metrics``, by file name."""
    found = {}
    for path in sorted((ROOT / "metrics").glob("*.py")):
        name = path.name[:-3]
        spec = importlib.util.spec_from_file_location(
            f"flakebench_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        found[name] = mod
    return found


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``flake_tpu_torch`` is not ``flake_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def program_config(cfg: dict):
    """The port's ``FrameConfig`` for a configuration file."""
    from flake_tpu_torch import params as P
    from flake_tpu_torch.ops.frame import FrameConfig

    return FrameConfig(
        block_size=cfg["block_size"], channels=cfg["channels"],
        bps=cfg["bits_per_sample"],
        prediction_type=int(P.Prediction[cfg["prediction_type"]]),
        order_method=int(P.OrderMethod[cfg["order_method"]]),
        stereo_method=int(P.StereoMethod[cfg["stereo_method"]]),
        min_prediction_order=cfg["min_prediction_order"],
        max_prediction_order=cfg["max_prediction_order"],
        min_partition_order=cfg["min_partition_order"],
        max_partition_order=cfg["max_partition_order"],
        precision=cfg.get("precision", P.LPC_PRECISION),
        lpc_dtype=cfg.get("lpc_dtype", "float64"))


def make_batches(mix: dict, cfg: dict, seed: int, dev, frames=None) -> list:
    """The pool as the pipeline takes it: (samples int32 [F, B, C],
    header bits int32 [F], header bytes uint8 [F, 16], header byte counts
    int32 [F]) a batch, on ``dev``; frames numbered on from the mix's
    first number, batch after batch."""
    import numpy as np
    import torch

    from flakebench.reference.flac_plain import Config, frame_header_bytes
    from flakebench.traffic import generator

    pool = generator.make_pool(mix, cfg, seed, dev, frames)
    F = pool[0].shape[0]
    first = mix.get("first_frame_number", 0)
    out = []
    for j, samples in enumerate(pool):
        nums = np.arange(first + j * F, first + (j + 1) * F, dtype=np.int64)
        hb, hn = frame_header_bytes(nums, Config.from_file(cfg))
        out.append((samples, torch.from_numpy(hn * 8).to(dev),
                    torch.from_numpy(hb).to(dev),
                    torch.from_numpy(hn).to(dev)))
    return out


class Clock:
    """Marks on the card's stream (CUDA events), or on the host clock for
    the CPU runs of the tests."""

    def __init__(self, dev):
        import torch

        self.torch = torch
        self.cuda = dev.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def pipeline(cfg, layered: bool):
    """The timed step, ``step(clock, batch, span) -> (outputs, marks)``:
    ``graft_entry.pipeline_step(cfg)``, or with ``layered`` its two layer
    calls with a mark before each, ``span(name)`` around each."""
    from flake_tpu_torch import graft_entry as G

    if not layered:
        fn = G.pipeline_step(cfg)

        def step(clock, batch, span):
            return fn(*batch), ()
        return step

    def step(clock, batch, span):
        samples, hdr_bits, hdr_bytes, hdr_nb = batch
        m0 = clock.mark()
        with span("flakebench.analysis"):
            analysis = G.analyze_frames(samples, cfg, hdr_bits)
        m1 = clock.mark()
        with span("flakebench.emission"):
            words, total_bits = G.bitpack.pack_frames_device(
                analysis, hdr_bytes, hdr_nb, cfg)
        return ({"words": words, "total_bits": total_bits,
                 "frame_bytes": analysis["frame_bytes"]}, (m0, m1))
    return step


def drive(step, batches, clock, in_flight: int, seconds=None, count=None,
          span=None) -> dict:
    """The closed loop: for ``seconds`` of the host clock, or ``count``
    batches, dispatch the pool's batches in turn with ``in_flight``
    queued, then synchronise. Returns the loop's records and each pool
    batch's last outputs."""
    span = span or (lambda name: contextlib.nullcontext())
    done, marks, enqueue = [], [], []
    last = [None] * len(batches)
    t0 = time.perf_counter()
    i = 0
    while True:
        if i >= in_flight:
            with span("flakebench.wait"):
                clock.wait(done[i - in_flight])
        if (count is not None and i >= count) or \
                (count is None and time.perf_counter() - t0 >= seconds):
            break
        j = i % len(batches)
        h0 = time.perf_counter()
        out, ms = step(clock, batches[j], span)
        enqueue.append((time.perf_counter() - h0) * 1e3)
        done.append(clock.mark())
        marks.append(ms)
        last[j] = out
        i += 1
    clock.sync()
    t1 = time.perf_counter()
    rec = {"batches": i, "window_s": t1 - t0, "enqueue_ms": enqueue,
           "batch_ms": [clock.ms(done[k - 1], done[k])
                        for k in range(1, len(done))]}
    if marks and marks[0]:
        rec["analysis_ms"] = [clock.ms(m[0], m[1]) for m in marks]
        rec["emission_ms"] = [clock.ms(m[1], d) for m, d in zip(marks, done)]
    return rec, last


def profile_stretch(step, batches, clock, in_flight: int, count: int) -> dict:
    """``count`` batches of the closed loop under ``torch.profiler``: the
    card's busy seconds and events, the stretch's host seconds and the
    breakdown (``trace.reduce_events``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from flakebench import trace

    acts = [ProfilerActivity.CPU]
    if clock.cuda:
        acts.append(ProfilerActivity.CUDA)
    clock.sync()
    with profile(activities=acts) as prof:
        rec, _ = drive(step, batches, clock, in_flight, count=count,
                       span=record_function)
    clock.sync()
    device, cpu = trace.split_profile(prof.events(), SPANS)
    red = trace.reduce_events(device, cpu)
    red["window_s"] = rec["window_s"]
    red["batches"] = rec["batches"]
    return red


def measure(workload: str, seed: int, seconds: float, traced: bool, dev,
            frames=None, wrap_step=None, t_start=None) -> dict:
    """One run of a cell on ``dev``; returns the result's fields and the
    records. ``frames`` (a smaller batch) and ``wrap_step`` (a step made
    to fail) serve the tests on the CPU."""
    import torch

    from flakebench import check
    from flakebench.reference.flac_plain import Config

    t_start = T_START if t_start is None else t_start
    cell = load("cells", workload)
    cfg = load("configs", cell["config"])
    mix = load("traffic", cell["traffic"])
    in_flight = mix["in_flight"]

    parts = {"start_s": time.perf_counter() - t_start}
    batches = make_batches(mix, cfg, seed, dev, frames)
    F = batches[0][0].shape[0]
    parts["pool_s"] = time.perf_counter() - t_start - parts["start_s"]
    prog_cfg = program_config(cfg)
    step = pipeline(prog_cfg, traced)
    if wrap_step is not None:
        step = wrap_step(step)
    clock = Clock(dev)
    for batch in batches:              # warm the one shape on every batch
        step(clock, batch, lambda name: contextlib.nullcontext())
    clock.sync()
    gc.collect()
    gc.freeze()
    rec = {"cell": workload, "config": cfg, "frames": F,
           "audio_s": F * cfg["block_size"] / cfg["sample_rate"]}
    rec["setup_s"] = time.perf_counter() - t_start
    parts["warm_s"] = rec["setup_s"] - parts["start_s"] - parts["pool_s"]

    win, last = drive(step, batches, clock, in_flight, seconds=seconds)
    rec.update(win)
    if traced:
        rec["profile"] = profile_stretch(step, batches, clock, in_flight,
                                         mix["profile_batches"])
    peak = torch.cuda.max_memory_allocated() if clock.cuda else 0

    # the check, once the window has closed and the peak is read
    picked = check.sample(batches, last, mix["check_frames_per_batch"], seed)
    del batches, last, win
    if clock.cuda:
        torch.cuda.empty_cache()
    differs = check.count(picked, Config.from_file(cfg))
    checked = sum(g["samples"].shape[0] for g in picked)
    pct = 100.0 * sum(differs) / checked if checked else 100.0
    limit = cell["limits"]["differ_pct"]
    compared = {"differ_pct": {"value": pct, "limit": limit}}
    correct = bool(picked) and pct <= limit

    found = readers()
    metrics = {}
    for name, mod in found.items():
        if mod.TRACE != int(traced):
            continue
        value = mod.read(rec)
        if value is not None:
            metrics[name] = {"value": value, "unit": mod.UNIT}
    device = {"platform": "gpu" if clock.cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if clock.cuda
              else "cpu",
              "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": rec["batches"],
              "failed": sum(1 for d in differs if d), "metrics": metrics,
              "device": device}
    if traced:
        p = rec["profile"]
        device["busy_s"] = p["busy_s"]
        device["window_s"] = p["window_s"]
        result["breakdown"] = {"device_ops": p["device_ops"],
                               "idle_gaps": p["idle_gaps"]}
    result["compared"] = compared
    return {"result": result, "rec": rec, "checked": checked,
            "differ": sum(differs), "setup_parts": parts}


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"
    return proc.stdout.strip() or proc.stderr.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = load("cells", args.workload)
    import torch

    if not torch.cuda.is_available():
        print("flakebench: no CUDA device; nothing measured", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"flakebench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    out = measure(args.workload, args.seed, args.seconds, bool(args.trace),
                  dev)
    bad = forbidden_modules()
    if bad:
        print(f"flakebench: loaded in the measuring process: {bad}",
              file=sys.stderr)
        return 4
    result = out["result"]
    parts = ", ".join(f"{k} {v:.3f}" for k, v in out["setup_parts"].items())
    print(f"flakebench: {args.workload} seed {args.seed}: "
          f"{result['attempted']} batches; set-up {parts}; "
          f"{out['differ']} of {out['checked']} frames checked differ from "
          f"the reference; {power_limit()}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
