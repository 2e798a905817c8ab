"""Deterministic benchmark corpus (port of ``util/corpus.py``).

The recorded guitar pluck of ``tests/data`` (16- and 24-bit, see
``tests/data/README.md``) plus labelled synthetic classes covering the
content families the reference's benchmark scripts are pointed at: tonal
"music", speech-shaped noise, transient trains, silence and quiet
passages, 6-channel beds, and 24-bit/96 kHz material. Everything comes
from fixed seeds, so the WAV files are the JAX tool's byte for byte.

    python -m flake_tpu_torch.util.corpus [DIR]   (default build/corpus)
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

from flake_tpu_torch.io import open_pcm
from flake_tpu_torch.io.wav import write_wave

ROOT = pathlib.Path(__file__).resolve().parents[2]
DATA = ROOT / "tests" / "data"


def _norm(x, bits, headroom=0.85):
    lim = (1 << (bits - 1)) - 1
    x = x / max(1e-9, np.abs(x).max())
    return np.round(x * lim * headroom).astype(np.int32)


def real_pluck(seconds: float, bits: int = 16):
    """The real guitar-pluck recording, loop-tiled to ``seconds``
    (the content is real, the duration is not)."""
    path = DATA / f"pluck-pcm{bits}.wav"
    with open(path, "rb") as fh:
        r = open_pcm(fh)
        pcm = r.read_samples(10 ** 7)
        rate = r.info.sample_rate
    reps = int(np.ceil(seconds * rate / pcm.shape[0]))
    return np.tile(pcm, (reps, 1))[: int(seconds * rate)], rate


def music(seconds: float, rate=44100, bits=16, seed=0):
    """Multitone + vibrato + harmonics, stereo-decorrelated."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    x = np.zeros(n)
    for f0 in (220.0, 277.2, 329.6, 440.0):
        vib = 1.0 + 0.002 * np.sin(2 * np.pi * 5.1 * t)
        for h in range(1, 6):
            x += np.sin(2 * np.pi * f0 * h * vib * t
                        + rng.uniform(0, 2 * np.pi)) / h ** 1.5
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 0.37 * t) ** 2
    x *= env
    noise = rng.standard_normal(n) * 0.01
    l = _norm(x + noise, bits)
    r = _norm(0.85 * x + rng.standard_normal(n) * 0.01, bits)
    return np.stack([l, r], 1), rate


def speech_like(seconds: float, rate=44100, bits=16, seed=1):
    """Filtered noise bursts with formant-ish resonances + pauses."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    x = np.zeros(n)
    pos = 0
    while pos < n:
        seg = int(rng.uniform(0.05, 0.25) * rate)
        if rng.uniform() < 0.7:  # voiced-ish burst
            f0 = rng.uniform(90, 220)
            t = np.arange(seg) / rate
            s = np.sign(np.sin(2 * np.pi * f0 * t)) * 0.3
            for fm in rng.uniform(300, 3000, 3):
                s += np.sin(2 * np.pi * fm * t) * 0.2
            s *= np.hanning(seg)
            x[pos:pos + seg] = s[: n - pos]
        pos += seg
    x += rng.standard_normal(n) * 0.002
    m = _norm(x, bits)
    return np.stack([m, m], 1), rate  # dual mono, stresses mid/side


def transients(seconds: float, rate=44100, bits=16, seed=2):
    """Click/drum train: worst case for fixed blocks, best for VBS."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    x = rng.standard_normal(n) * 0.003
    pos = int(0.05 * rate)
    while pos < n:
        dur = int(0.02 * rate)
        seg = np.exp(-np.arange(dur) / (0.002 * rate))
        tone = np.sin(2 * np.pi * rng.uniform(60, 2000)
                      * np.arange(dur) / rate)
        x[pos:pos + dur] += (seg * tone)[: n - pos]
        pos += int(rng.uniform(0.08, 0.4) * rate)
    l = _norm(x, bits)
    return np.stack([l, np.roll(l, 7)], 1), rate


def quiet(seconds: float, rate=44100, bits=16, seed=3):
    """Near-silence with a faint hum: wasted-bits / constant stress."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    x = (np.sin(2 * np.pi * 50 * t) * 40
         + rng.standard_normal(n) * 2).astype(np.int32) * 4  # wasted bits
    out = np.stack([x, x], 1)
    out[: n // 8] = 0  # leading digital silence
    return out, rate


def hires(seconds: float, seed=4):
    """24-bit/96 kHz sweep + noise floor (BASELINE.md's hi-res config)."""
    rate, bits = 96000, 24
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    f = 20 * (1000 ** (t / max(t[-1], 1e-9)))        # 20 Hz -> 20 kHz
    phase = np.cumsum(2 * np.pi * f / rate)
    x = np.sin(phase) * 0.5 + rng.standard_normal(n) * 1e-4
    l = _norm(x, bits)
    return np.stack([l, 0.9 * l], 1).astype(np.int32), rate


def surround6(seconds: float, rate=48000, bits=16, seed=5):
    """6-channel bed (BASELINE.md's multichannel config)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    chans = []
    for c in range(6):
        x = np.sin(2 * np.pi * (110 + 50 * c) * t) * (0.3 + 0.1 * c / 6)
        x += rng.standard_normal(n) * 0.005
        chans.append(_norm(x, bits))
    return np.stack(chans, 1), rate


CLASSES = {
    "pluck_real_16": lambda s: real_pluck(s, 16),
    "pluck_real_24": lambda s: real_pluck(s, 24),
    "music_16_44": music,
    "speech_16_44": speech_like,
    "transient_16_44": transients,
    "quiet_16_44": quiet,
    "hires_24_96": hires,
    "surround6_16_48": surround6,
}

BITS = {"pluck_real_24": 24, "hires_24_96": 24}


def build(outdir: pathlib.Path, seconds: float = 10.0) -> dict:
    """Write every class as ``outdir/<name>.wav``; returns name -> path."""
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, fn in CLASSES.items():
        pcm, rate = fn(seconds)
        bits = BITS.get(name, 16)
        p = outdir / f"{name}.wav"
        write_wave(str(p), pcm, rate, bits)
        paths[name] = p
    return paths


if __name__ == "__main__":
    out = pathlib.Path(sys.argv[1]) if len(sys.argv) > 1 \
        else ROOT / "build" / "corpus"
    for name, p in build(out).items():
        print(name, p, p.stat().st_size)
