"""The level matrix over the benchmark corpus (port of
``util/level_matrix.py``).

For each (corpus file, level) cell: encode with ``Encoder`` on the card
(a warm pass first, which builds the kernels and warms the allocator;
then the timed pass), decode with :mod:`flake_tpu_torch.decoder` (CRC-8/16
and MD5, the stand-in for ``flac -t``; a cell that does not decode to its
samples raises), and record size, ratio and whole-file wall x-realtime.
Where a reference binary was built into ``.refbuild/flake`` of this
checkout, its compressed size on the same WAV stands beside ours.

The cells are the JAX tool's: every level 0-12 on ``FULL_FILES``, the
``SPOT_LEVELS`` on the other files (all of them under ``--quick``, on 5 s
of corpus), and no level above 8 on the 6-channel file. The JAX tool skips
those because variable block sizes on more than two channels are slow to
compile for a spot check; the port keeps the same cells so that the two
tables line up row for row (the stereo files cover levels 9-12).

    python -m flake_tpu_torch.util.level_matrix [--device cuda|cpu]
        [--quick] [--seconds S] [--out build/RESULTS.md]

Each cell prints as a line as it is done; the table goes to ``--out``,
whose header names the card and its power limit.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import tempfile
import time

import numpy as np

from flake_tpu_torch import params as P
from flake_tpu_torch.decoder import decode_stream
from flake_tpu_torch.encoder import Encoder, resolve_device
from flake_tpu_torch.io import open_pcm
from flake_tpu_torch.profiling import card_name
from flake_tpu_torch.util.corpus import BITS, build

ROOT = pathlib.Path(__file__).resolve().parents[2]
REF_BIN = ROOT / ".refbuild" / "flake"

FULL_FILES = ("music_16_44", "pluck_real_16")
SPOT_LEVELS = (2, 5, 8, 11)
TABLE_HEADER = "| file | level | bytes | ratio | xrt | ref bytes | Δref |\n"


def encode_cell(pcm, rate, bits, level, device="cuda"):
    """(bytes, timed encode seconds) of one cell, decode-verified."""
    p = P.set_defaults(level)
    cfg = P.StreamConfig(channels=pcm.shape[1], sample_rate=rate,
                         bits_per_sample=bits, samples=pcm.shape[0],
                         params=p)
    Encoder(cfg, device=device).encode_stream(pcm)    # warm pass
    enc = Encoder(cfg, device=device)
    t0 = time.perf_counter()
    blob = enc.encode_stream(pcm)
    dt = time.perf_counter() - t0
    dec = decode_stream(blob)
    if not (dec.md5_ok and np.array_equal(dec.samples, pcm)):
        raise AssertionError(f"lossless verify FAILED at level {level}")
    return blob, dt


def ref_size(wav: pathlib.Path, level: int) -> int | None:
    if not REF_BIN.exists() or level > 12:
        return None
    out = wav.with_suffix(f".ref{level}.flac")
    try:
        subprocess.run([str(REF_BIN), "-q", f"-{level}", str(wav),
                        "-o", str(out)], check=True, capture_output=True,
                       timeout=600)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return None
    return out.stat().st_size


def cell_row(name, level, secs, nbytes, raw_bytes, dt, rs) -> dict:
    return {
        "file": name, "level": level, "secs": secs,
        "bytes": nbytes, "ratio": nbytes / raw_bytes,
        "xrt": secs / dt,
        "ref_bytes": rs,
        "delta_vs_ref": (nbytes - rs) / rs if rs else None,
    }


def cells(name: str, channels: int, quick: bool) -> list[int]:
    """The levels of one file's cells."""
    levels = range(13) if (name in FULL_FILES and not quick) \
        else SPOT_LEVELS
    return [lv for lv in levels if not (channels > 2 and lv > 8)]


def run(device="cuda", quick: bool = False,
        seconds: float | None = None) -> tuple[list[dict], float]:
    """Every cell on ``device`` over a corpus of ``seconds`` a file (5
    under ``quick``, else 10), in a temporary directory; returns (rows,
    seconds)."""
    dev = resolve_device(device)
    seconds = seconds or (5.0 if quick else 10.0)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, wav in build(pathlib.Path(tmp), seconds=seconds).items():
            bits = BITS.get(name, 16)
            with open(wav, "rb") as fh:
                r = open_pcm(fh)
                pcm = r.read_samples(10 ** 9)
                rate = r.info.sample_rate
            raw_bytes = pcm.shape[0] * pcm.shape[1] * ((bits + 7) // 8)
            secs = pcm.shape[0] / rate
            for level in cells(name, pcm.shape[1], quick):
                blob, dt = encode_cell(pcm, rate, bits, level, dev)
                rows.append(cell_row(name, level, secs, len(blob),
                                     raw_bytes, dt, ref_size(wav, level)))
                print(rows[-1], flush=True)
    return rows, seconds


def write_table(out: pathlib.Path, rows: list[dict], card: str,
                seconds: float) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w") as f:
        f.write("# RESULTS — level matrix on the benchmark corpus\n\n")
        f.write(f"Generated by `python -m flake_tpu_torch.util.level_matrix`"
                f" on {card}; {seconds:g}s per file. Every cell "
                "decode-verified losslessly (CRC-8/16 + MD5) by the "
                "independent decoder (`flake_tpu_torch.decoder`).\n\n")
        f.write("`xrt` is whole-file wall x-realtime of one warm "
                "`Encoder.encode_stream` (samples in host memory, FLAC "
                "bytes out); `Δref` is our compressed size vs the "
                "reference C encoder on the same WAV (negative = "
                "smaller), where its binary was built.\n\n")
        f.write(TABLE_HEADER)
        f.write("|---|---|---|---|---|---|---|\n")
        for r in rows:
            dref = f"{100 * r['delta_vs_ref']:+.2f}%" \
                if r["delta_vs_ref"] is not None else "—"
            rb = r["ref_bytes"] if r["ref_bytes"] else "—"
            f.write(f"| {r['file']} | {r['level']} | {r['bytes']} | "
                    f"{r['ratio']:.4f} | {r['xrt']:.0f}x | {rb} | "
                    f"{dref} |\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--quick", action="store_true",
                    help="spot levels only, 5s corpus")
    ap.add_argument("--out", default=str(ROOT / "build" / "RESULTS.md"))
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    rows, seconds = run(args.device, args.quick, args.seconds)
    out = pathlib.Path(args.out)
    write_table(out, rows, card_name(args.device), seconds)
    print(f"wrote {out} ({len(rows)} cells)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
