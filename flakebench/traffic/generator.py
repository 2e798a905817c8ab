"""The one generator of the benchmark's traffic: pools of PCM batches.

A traffic mix is a JSON file beside this module (``<mix>.json``) that
names its parameters: frames a batch, batches in flight, the content
class of each batch of the pool, the frames each run checks, the batches
the traced run profiles. This module makes a mix's pool from a seed, on
the device it is given (the card in a run, the CPU in the tests), in a
few large tensor calls a batch.

The content classes are a PyTorch rewrite of the port's corpus
generators (``flake_tpu_torch/util/corpus.py``): tonal music with
vibrato, speech-like dual mono, transient trains, near-silence with
wasted bits and a leading digital silence, a real recorded guitar pluck
loop-tiled, and broadband noise. Two departures, both because a batch
here is a whole track of many minutes and not a 10 s clip: the music's
vibrato is a true frequency modulation of +-0.2% (the corpus multiplies
time by the vibrato, which at minutes into a track swings the pitch by
tens of times), and the segment and click trains are drawn all at once
and placed by search instead of in a Python loop. The seed changes
phases, noise, segment lengths and the pluck's offset; it changes no
size.
"""

from __future__ import annotations

import math
import pathlib
import wave

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
F64 = torch.float64


def _norm(x, bits: int, headroom: float = 0.85):
    lim = (1 << (bits - 1)) - 1
    x = x / x.abs().max().clamp_min(1e-9)
    return torch.round(x * (lim * headroom)).to(torch.int32)


def _uniform(k: int, lo: float, hi: float, g, dev):
    return lo + (hi - lo) * torch.rand(k, generator=g, device=dev, dtype=F64)


def music(n, rate, bits, g, dev):
    """Four tones with five harmonics each, a +-0.2% vibrato at 5.1 Hz, a
    slow envelope, a little noise; the right channel 0.85 of the left
    with noise of its own."""
    t = torch.arange(n, device=dev, dtype=F64) / rate
    w = 2 * math.pi * 5.1
    tv = t + 0.002 * (1 - torch.cos(w * t)) / w
    phases = _uniform(20, 0.0, 2 * math.pi, g, dev).tolist()
    x = torch.zeros(n, device=dev, dtype=F64)
    i = 0
    for f0 in (220.0, 277.2, 329.6, 440.0):
        for h in range(1, 6):
            x += torch.sin(2 * math.pi * f0 * h * tv + phases[i]) / h ** 1.5
            i += 1
    x *= 0.5 + 0.5 * torch.sin(2 * math.pi * 0.37 * t) ** 2
    left = _norm(x + 0.01 * torch.randn(n, generator=g, device=dev,
                                        dtype=F64), bits)
    right = _norm(0.85 * x + 0.01 * torch.randn(n, generator=g, device=dev,
                                                dtype=F64), bits)
    return torch.stack([left, right], dim=-1)


def speech(n, rate, bits, g, dev):
    """Segments of 50-250 ms, 70% of them voiced (a square wave at
    90-220 Hz and three formant-like tones under a Hann window), the rest
    pauses, over a faint noise floor; dual mono."""
    K = math.ceil(n / (0.05 * rate)) + 2
    seg = torch.floor(_uniform(K, 0.05, 0.25, g, dev) * rate).to(torch.int64)
    starts = torch.cumsum(seg, 0) - seg
    voiced = torch.rand(K, generator=g, device=dev) < 0.7
    f0 = _uniform(K, 90.0, 220.0, g, dev)
    fm = _uniform(3 * K, 300.0, 3000.0, g, dev).view(K, 3)
    idx = torch.arange(n, device=dev)
    k = torch.searchsorted(starts, idx, right=True) - 1
    d = (idx - starts[k]).to(F64)
    tt = d / rate
    s = 0.3 * torch.sign(torch.sin(2 * math.pi * f0[k] * tt))
    for j in range(3):
        s += 0.2 * torch.sin(2 * math.pi * fm[k, j] * tt)
    m = seg[k].to(F64)
    s *= 0.5 - 0.5 * torch.cos(2 * math.pi * d / (m - 1))
    x = torch.where(voiced[k], s, 0.0) \
        + 0.002 * torch.randn(n, generator=g, device=dev, dtype=F64)
    mono = _norm(x, bits)
    return torch.stack([mono, mono], dim=-1)


def transients(n, rate, bits, g, dev):
    """A train of 20 ms decaying tone bursts at 60-2000 Hz, 80-400 ms
    apart, over a noise floor; the right channel the left 7 samples
    later."""
    K = math.ceil(n / (0.08 * rate)) + 2
    gaps = torch.floor(_uniform(K, 0.08, 0.4, g, dev) * rate) \
        .to(torch.int64)
    pos = int(0.05 * rate) + torch.cumsum(gaps, 0) - gaps
    f = _uniform(K, 60.0, 2000.0, g, dev)
    idx = torch.arange(n, device=dev)
    k = torch.searchsorted(pos, idx, right=True) - 1
    d = (idx - pos[k.clamp_min(0)]).to(F64)
    on = (k >= 0) & (d < int(0.02 * rate))
    burst = torch.exp(-d / (0.002 * rate)) \
        * torch.sin(2 * math.pi * f[k.clamp_min(0)] * d / rate)
    x = 0.003 * torch.randn(n, generator=g, device=dev, dtype=F64) \
        + torch.where(on, burst, 0.0)
    left = _norm(x, bits)
    return torch.stack([left, torch.roll(left, 7)], dim=-1)


def quiet(n, rate, bits, g, dev):
    """A faint 50 Hz hum with noise, every sample a multiple of 4 (two
    wasted bits), the first eighth digital silence; both channels
    alike."""
    t = torch.arange(n, device=dev, dtype=F64) / rate
    x = (40 * torch.sin(2 * math.pi * 50 * t)
         + 2 * torch.randn(n, generator=g, device=dev, dtype=F64)) \
        .to(torch.int32) * 4
    x[:n // 8] = 0
    return torch.stack([x, x], dim=-1)


def _pluck_pcm(path: pathlib.Path) -> np.ndarray:
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: 16-bit PCM expected")
        raw = w.readframes(w.getnframes())
        chans = w.getnchannels()
    return np.frombuffer(raw, dtype="<i2").astype(np.int32) \
        .reshape(-1, chans)


def pluck(n, rate, bits, g, dev):
    """The recorded guitar pluck (``pluck-pcm16.wav``, 16-bit stereo),
    loop-tiled from an offset drawn from the seed, scaled to ``bits``."""
    pcm = torch.from_numpy(_pluck_pcm(HERE / "pluck-pcm16.wav")).to(dev)
    L = pcm.shape[0]
    off = int(torch.randint(L, (1,), generator=g, device=dev))
    x = pcm[(torch.arange(n, device=dev) + off) % L]
    return x << (bits - 16) if bits > 16 else x >> (16 - bits)


def noise(n, rate, bits, g, dev):
    """Independent Gaussian noise in each channel, peak at 85% of full
    scale: the least compressible content, the most words a frame."""
    return torch.stack([_norm(torch.randn(n, generator=g, device=dev,
                                          dtype=F64), bits)
                        for _ in range(2)], dim=-1)


CLASSES = {"music": music, "speech": speech, "transients": transients,
           "quiet": quiet, "pluck": pluck, "noise": noise}


def _generator(seed: int, j: int, dev: torch.device) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed((int(seed) * 0x9E3779B1 + 7919 * (j + 1)) % (1 << 63))
    return g


def make_batch(cls: str, seed: int, j: int, frames: int, cfg: dict,
               dev: torch.device) -> torch.Tensor:
    """Batch ``j`` of a pool: ``frames`` frames of the config's block, in
    content class ``cls``, from ``seed``. int32 [frames, block, channels]
    on ``dev``; a stereo class's channels are repeated, channel c taking
    channel c % 2 of the class 7 * (c // 2) samples later."""
    n = frames * cfg["block_size"]
    C = cfg["channels"]
    x = CLASSES[cls](n, cfg["sample_rate"], cfg["bits_per_sample"],
                     _generator(seed, j, dev), dev)
    if C != 2:
        x = torch.stack([torch.roll(x[:, c % 2], 7 * (c // 2))
                         for c in range(C)], dim=-1)
    return x.reshape(frames, cfg["block_size"], C).contiguous()


def make_pool(mix: dict, cfg: dict, seed: int, dev: torch.device,
              frames: int | None = None) -> list:
    """The mix's pool of batches from ``seed``: one int32 [F, block, C]
    tensor a content class of ``mix["pool"]``, on ``dev``. ``frames``
    overrides the mix's batch (the tests' small shapes)."""
    F = frames or mix["frames_per_batch"]
    return [make_batch(cls, seed, j, F, cfg, dev)
            for j, cls in enumerate(mix["pool"])]
