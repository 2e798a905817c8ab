"""The launcher of a distributed encode (port of
``flake_tpu/parallel/launch.py``).

One process a rank:

    python -m flake_tpu_torch.parallel.launch \\
        --coordinator host0:9876 --num-processes 2 --process-id $RANK \\
        --backend nccl input.wav -o out.flac --level 8

``--spawn N`` forks N local ranks and waits for them; rank 0 writes the
output file. Two ranks sharing one card:

    python -m flake_tpu_torch.parallel.launch --spawn 2 --backend gloo \\
        --device cuda:0 input.wav -o out.flac --level 8

``--device cuda`` (the default) puts rank r on ``cuda:r`` and refuses a
job with more ranks than cards (name the card, ``--device cuda:0``, to
share one; NCCL needs a card a rank); ``--device cpu`` runs on the host.
``--stats`` prints one JSON line a rank: its device, the sha256 of the
stream it assembled, its wall, read and encode seconds, peak host and device
memory and its launches of each kernel.
Every rank reads the whole input, as the JAX launcher does; the bytes
equal one ``Encoder.encode_stream`` of it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import resource
import subprocess
import sys
import time


def _parse(argv):
    p = argparse.ArgumentParser(prog="flake-launch-torch")
    p.add_argument("input")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--level", type=int, default=5)
    p.add_argument("--coordinator", default="127.0.0.1:9876")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--spawn", type=int, default=None,
                   help="fork N local ranks and wait for them")
    p.add_argument("--device", default="cuda",
                   help="cuda (rank r on cuda:r), cuda:N (every rank on "
                        "that card) or cpu")
    p.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    p.add_argument("--batch-frames", type=int, default=512)
    p.add_argument("--lpc-dtype", default="float64")
    p.add_argument("--stats", action="store_true",
                   help="print one JSON line of counters a rank")
    return p.parse_args(argv)


def _spawn(args) -> int:
    """Fork ``args.spawn`` local ranks; their exit codes ORed."""
    base = [sys.executable, "-m", "flake_tpu_torch.parallel.launch",
            args.input, "-o", args.output, "--level", str(args.level),
            "--coordinator", args.coordinator,
            "--num-processes", str(args.spawn),
            "--device", args.device, "--backend", args.backend,
            "--batch-frames", str(args.batch_frames),
            "--lpc-dtype", args.lpc_dtype] + ["--stats"] * args.stats
    procs = [subprocess.Popen(base + ["--process-id", str(r)])
             for r in range(args.spawn)]
    rc = 0
    for p in procs:
        rc |= p.wait()
    return rc


def write_line(obj) -> None:
    """Write ``obj`` as one JSON line in a single write. The ranks of
    ``--spawn`` share their parent's stdout, and under ``python -u`` (or
    ``PYTHONUNBUFFERED``) ``print`` writes the text and its newline apart,
    so two ranks finishing together could join their lines into one. A
    single write of less than ``PIPE_BUF`` bytes to a pipe is atomic."""
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def rank_device(spec: str, rank: int, num_processes: int):
    """The device of rank ``rank``: ``cuda`` means ``cuda:rank``, one card
    a rank, and needs as many cards as ranks."""
    import torch

    from flake_tpu_torch.encoder import resolve_device

    if spec == "cuda":
        if torch.cuda.device_count() < num_processes:
            raise RuntimeError(
                f"--device cuda puts each of {num_processes} ranks on a card "
                f"of its own, and there are {torch.cuda.device_count()}; "
                "name one card (--device cuda:0) for ranks to share it")
        spec = f"cuda:{rank}"
    return resolve_device(spec)


def main(argv=None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])
    if args.spawn is not None:
        return _spawn(args)
    t_start = time.perf_counter()

    import torch

    from flake_tpu_torch import params as P
    from flake_tpu_torch.io import open_pcm
    from flake_tpu_torch.ops import autocorr, bitmerge, bitpack, frame, lpc
    from flake_tpu_torch.ops import rice, sweep
    from flake_tpu_torch.parallel import distributed

    rank = args.process_id if args.process_id is not None else 0
    device = rank_device(args.device, rank, args.num_processes)
    if args.backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device a rank")
        torch.cuda.set_device(device)
    distributed.initialize(args.coordinator, args.num_processes, rank,
                           args.backend)
    try:
        t0 = time.perf_counter()
        with open(args.input, "rb") as fp:
            reader = open_pcm(fp)
            pcm = reader.read_all()
            info = reader.info
        read_s = time.perf_counter() - t0
        cfg = P.StreamConfig(channels=info.channels,
                             sample_rate=info.sample_rate,
                             bits_per_sample=info.bits_per_sample,
                             samples=pcm.shape[0],
                             params=P.set_defaults(args.level))
        kernels = {"autocorr": autocorr.autocorr,
                   "sweep_sums": sweep.sweep_sums,
                   "sweep_granules": sweep.sweep_granules,
                   "merge_words": bitmerge.merge_words,
                   "rice_scan": rice.rice_scan,
                   "final_pass": rice.final_pass,
                   "candidates": lpc.candidates,
                   "select_candidate": frame.select_candidate,
                   "fixed_search": rice.fixed_search,
                   "frame_head": frame.frame_head,
                   "slot_layout": bitpack.slot_layout}
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        blob = distributed.encode_stream_distributed(
            pcm, cfg, device=device, batch_frames=args.batch_frames,
            lpc_dtype=args.lpc_dtype)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        encode_s = time.perf_counter() - t0
        if distributed.dist.get_rank() == 0:
            with open(args.output, "wb") as f:
                f.write(blob)
    finally:
        distributed.dist.destroy_process_group()
    if args.stats:
        write_line({
            "rank": rank, "device": str(device),
            "samples": int(pcm.shape[0]), "bytes": len(blob),
            "sha256": hashlib.sha256(blob).hexdigest(),
            "wall_s": time.perf_counter() - t_start, "read_s": read_s,
            "encode_s": encode_s,
            # ru_maxrss is KiB on Linux
            "peak_host_mib": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 1024,
            "peak_device_mib": (torch.cuda.max_memory_allocated(device)
                                / 2**20 if device.type == "cuda" else None),
            "launches": {k: fn.launches for k, fn in kernels.items()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
