#!/usr/bin/env python3
"""The sha256 of each stream ``chip_smoke.py`` encodes, through one
checkout's encoder on the card, or two checkouts compared.

    python3 stream_digests.py [CHECKOUT]
    python3 stream_digests.py CHECKOUT_A CHECKOUT_B

With one checkout (default: this one) it encodes the smoke's 18 streams,
made by that checkout's ``chip_smoke.py`` from its seeds (levels 8, 5, 7,
3-0 and a 10-sample tail at level 8; the VBS stream at levels 12 and 11;
the other widths; 600 s at levels 12, 2 and 7), with that checkout's
``flake_tpu_torch`` on the device, and prints one JSON object, label to
hex digest. With two it runs itself once for each, one process a checkout,
prints whether each stream's digest is equal and exits 1 if any differs.
Needs one CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import subprocess
import sys


def digests(root: pathlib.Path) -> dict:
    """label -> sha256 of that stream's bytes from ``root``'s encoder."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from flake_tpu_torch import Encoder
    from flake_tpu_torch import params as P

    if pathlib.Path(cs.__file__).resolve().parent != root:
        raise RuntimeError(f"chip_smoke imported from {cs.__file__}")

    def cfg(level, channels=2, bps=16, rate=cs.SAMPLE_RATE):
        return P.StreamConfig(channels=channels, sample_rate=rate,
                              bits_per_sample=bps,
                              params=P.set_defaults(level))

    out = {}

    def enc(label, c, stream):
        blob = Encoder(c, device="cuda").encode_stream(stream)
        out[label] = hashlib.sha256(blob).hexdigest()
        print(label, out[label][:16], file=sys.stderr, flush=True)

    pcm = cs.make_stream(cs.SEED)
    enc("level 8", cfg(8), pcm)
    for level in (5, 7, 3, 2, 1, 0):
        secs = cs.LEVEL_SECONDS.get(level, cs.SECONDS)
        enc(f"level {level}", cfg(level), pcm[:secs * cs.SAMPLE_RATE])
    enc("level 8, 10-sample tail", cfg(8), pcm[:32 * cs.BLOCK + 10])
    vpcm = cs.make_vbs_stream(cs.SEED + 12, cs.VBS_SECONDS)
    for level in (12, 11):
        enc(f"level {level}", cfg(level), vpcm)
    for i, (label, (ch, bps, rate, level, secs)) in enumerate(
            cs.WIDE_STREAMS.items()):
        enc(label, cfg(level, ch, bps, rate),
            cs.make_wide_stream(cs.SEED + 24 + i, ch, bps, rate, secs))
    enc(f"level 12, {cs.LONG_SECONDS} s", cfg(12),
        cs.make_vbs_stream(cs.SEED + 16, cs.LONG_SECONDS))
    lpcm = cs.make_stream(cs.SEED, cs.LONG_SECONDS)
    for level in (2, 7):
        enc(f"level {level}, {cs.LONG_SECONDS} s", cfg(level), lpcm)
    return out


def main() -> None:
    roots = [pathlib.Path(a).resolve() for a in sys.argv[1:]]
    if len(roots) <= 1:
        root = roots[0] if roots else pathlib.Path(__file__).resolve().parent
        print(json.dumps(digests(root)), flush=True)
        return
    runs = []
    for r in roots:
        proc = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()), str(r)],
            capture_output=True, text=True)
        if proc.returncode:
            sys.exit(f"{r}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.splitlines()[-1]))
    a, b = runs
    differ = [k for k in a if a[k] != b.get(k)] + [k for k in b if k not in a]
    for k in a:
        print(f"{k}: {'equal' if a[k] == b.get(k) else 'DIFFERS'} "
              f"({a[k][:16]} / {b.get(k, '-')[:16]})", flush=True)
    print(f"{len(a)} / {len(b)} streams, "
          f"{'all equal' if not differ else 'differ: ' + ', '.join(differ)}",
          flush=True)
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
