#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Builds the port's three CUDA kernels (K1 autocorrelation, K2 order
sweep, K3 word merge) and the host CRC patcher from this checkout, holds
each kernel against its plain PyTorch version on the inputs the first
batch of the stream gives it, then encodes 180 s of deterministic 16-bit
/ 44.1 kHz stereo at level 8 through ``Encoder.encode_stream`` (cold and
warm), checks that every kernel ran on that path, and decodes the stream
with the JAX package's independent decoder (numpy only), MD5 included.

    python3 chip_smoke.py

Needs one CUDA device of compute capability 9.0; fails without one. Any
failed phase exits non-zero before the final line, which is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 20260116
SAMPLE_RATE = 44100
SECONDS = 180
BLOCK = 4096
BATCH = 512
K1_REL_TOL = 5e-11    # tests/test_pallas_autocorr.py:55


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def make_stream(seed: int) -> "np.ndarray":
    """180 s of int32 [n, 2] 16-bit stereo: two different low tone pairs
    (every lag up to 12 stays well correlated), light noise, a silent
    second at 60 s (CONSTANT subframes) and a second of full-scale binary
    noise at 100 s (verbatim frames). The first batch (47.5 s) is
    tonal."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = SECONDS * SAMPLE_RATE
    t = np.arange(n) / SAMPLE_RATE
    env = 0.6 + 0.4 * np.sin(2 * np.pi * t / 23.0)
    left = env * (9000 * np.sin(2 * np.pi * 220 * t)
                  + 4000 * np.sin(2 * np.pi * 331 * t))
    right = env * (8000 * np.sin(2 * np.pi * 277 * t + 0.3)
                   + 3000 * np.sin(2 * np.pi * 440 * t))
    pcm = np.stack([left, right], axis=1) + rng.normal(0, 150, (n, 2))
    pcm[60 * SAMPLE_RATE:61 * SAMPLE_RATE] = 0
    burst = slice(100 * SAMPLE_RATE, 101 * SAMPLE_RATE)
    pcm[burst] = rng.choice([-32768, 32767], (SAMPLE_RATE, 2))
    return np.clip(np.rint(pcm), -32768, 32767).astype(np.int32)


def load_reference_decoder():
    """``flake_tpu.decoder`` under a bare ``flake_tpu`` parent module, so
    ``flake_tpu/__init__.py`` (which imports JAX) never runs."""
    pkg = types.ModuleType("flake_tpu")
    pkg.__path__ = [str(ROOT / "flake_tpu")]
    sys.modules["flake_tpu"] = pkg
    import flake_tpu.decoder as decoder

    if "jax" in sys.modules:
        fail("loading the reference decoder imported jax")
    return decoder


def time_pair(kernel, plain, reps: int = 20):
    """Mean ms per call of ``kernel`` and ``plain`` with CUDA events, in
    turns (plain, kernel, kernel, plain) after one warm-up call each."""
    import torch

    def run(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    kernel()
    plain()
    p1, k1, k2, p2 = run(plain), run(kernel), run(kernel), run(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def main() -> None:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        fail(f"missing dependency: {e}")
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not (ROOT / "flake_tpu_torch").is_dir():
        fail(f"no flake_tpu_torch package beside {__file__}")
    sys.path.insert(0, str(ROOT))

    # -- 1. the card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else "nvidia-smi unavailable"
    print(card, flush=True)
    cap = torch.cuda.get_device_capability(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"capability {cap}", flush=True)
    if cap != (9, 0):
        fail(f"need compute capability (9, 0), got {cap}")
    dev = torch.device("cuda", 0)

    from flake_tpu_torch import _cuda, native
    from flake_tpu_torch import params as P
    from flake_tpu_torch.encoder import Encoder
    from flake_tpu_torch.ops import autocorr as k1_mod
    from flake_tpu_torch.ops import bitmerge as k3_mod
    from flake_tpu_torch.ops import bitpack, frame, lpc
    from flake_tpu_torch.ops import sweep as k2_mod

    if "jax" in sys.modules:
        fail("importing flake_tpu_torch imported jax")

    # -- 2. builds ----------------------------------------------------------
    t0 = time.perf_counter()
    report = _cuda.build()
    print(f"build kernels {[str(s.relative_to(ROOT)) for s in _cuda.SOURCES]}"
          f": {time.perf_counter() - t0:.1f} s", flush=True)
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())
    t0 = time.perf_counter()
    native.build()
    print(f"build packer.cpp: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 3. kernel phases on the first batch's inputs -----------------------
    pcm = make_stream(SEED)
    n_full = pcm.shape[0] // BLOCK
    print(f"stream: {pcm.shape[0]} samples x 2 ch = {n_full} full frames "
          f"+ {pcm.shape[0] - n_full * BLOCK}-sample tail", flush=True)
    cfg = P.StreamConfig(channels=2, sample_rate=SAMPLE_RATE,
                         bits_per_sample=16, params=P.set_defaults(8))
    fcfg = frame.FrameConfig.from_params(cfg.params, 2, 16)

    def header_bytes(nums):
        return bitpack.frame_header_bytes(
            nums, bs_code=P.blocksize_code(BLOCK),
            sr_code=P.samplerate_code(SAMPLE_RATE), allow_vbs=0)

    captured = {}

    def recorder(mod, name):
        orig = getattr(mod, name)

        def rec(*args):
            captured[name] = args
            return orig(*args)
        return orig, rec

    hooks = [(frame, "autocorr"), (frame, "sweep_sums"),
             (bitpack, "merge_words")]
    originals = []
    for mod, name in hooks:
        orig, rec = recorder(mod, name)
        originals.append((mod, name, orig))
        setattr(mod, name, rec)
    try:
        batch = torch.from_numpy(
            pcm[:BATCH * BLOCK].reshape(BATCH, BLOCK, 2)).to(dev)
        hb, hnb = header_bytes(np.arange(BATCH, dtype=np.int64))
        analysis = frame.analyze_frames(batch, fcfg,
                                        torch.from_numpy(hnb * 8).to(dev))
        bitpack.pack_frames_device(analysis, torch.from_numpy(hb).to(dev),
                                   torch.from_numpy(hnb).to(dev), fcfg)
        torch.cuda.synchronize()
    finally:
        for mod, name, orig in originals:
            setattr(mod, name, orig)

    x, window, max_o = captured["autocorr"]
    sx, scoefs, sshifts, s_mo, s_pmax = captured["sweep_sums"]
    ml, mlead, mpay, mwr = captured["merge_words"]
    print(f"K1 inputs x {tuple(x.shape)}, max_order {max_o}; K2 inputs "
          f"coefs {tuple(scoefs.shape)}, pmax_static {s_pmax}; K3 inputs "
          f"slots {tuple(ml.shape)}, word_rows {mwr}", flush=True)

    kernels = []
    kernels_rel = [None]

    def phase(name, route_src, replaces, kern, plain, compare):
        out_k = kern()
        out_p = plain()
        torch.cuda.synchronize()
        err, ok, detail = compare(out_k, out_p)
        ms, plain_ms = time_pair(kern, plain)
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"{detail} -> {'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"{name} disagrees with its plain version ({detail})")
        kernels.append({"name": name, "route": "cuda", "source": route_src,
                        "replaces": replaces, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms})

    def cmp_rel(a, b):
        abs_err = (a - b).abs()
        rel = (abs_err / b.abs().clamp_min(1e-300)).max().item()
        kernels_rel[0] = rel
        return abs_err.max().item(), rel < K1_REL_TOL, \
            f"max rel err {rel:.3e} (tolerance {K1_REL_TOL:g})"

    def cmp_exact(a, b):
        if isinstance(a, tuple):
            same = all(torch.equal(u, v) for u, v in zip(a, b))
            err = max((u.to(torch.int64) - v.to(torch.int64)).abs().max()
                      .item() for u, v in zip(a, b))
        else:
            same = torch.equal(a, b)
            err = (a - b).abs().max().item()
        return float(err), same, f"bit-exact {same}"

    phase("autocorr", "flake_tpu_torch/csrc/autocorr.cu",
          "flake_tpu/ops/pallas_autocorr.py:158",
          lambda: k1_mod.autocorr(x, window, max_o),
          lambda: lpc.autocorr(x, max_o, window), cmp_rel)
    phase("sweep_sums", "flake_tpu_torch/csrc/sweep.cu",
          "flake_tpu/ops/pallas_sweep3.py:124",
          lambda: k2_mod.sweep_sums(sx, scoefs, sshifts, s_mo, s_pmax),
          lambda: k2_mod.sweep_sums_plain(sx, scoefs, sshifts, s_mo,
                                          s_pmax), cmp_exact)
    phase("merge_words", "flake_tpu_torch/csrc/bitmerge.cu",
          "flake_tpu/ops/pallas_bitmerge.py:173",
          lambda: k3_mod.merge_words(ml, mlead, mpay, mwr),
          lambda: k3_mod.merge_words_plain(ml, mlead, mpay, mwr), cmp_exact)

    kernels[0]["max_rel_err"] = kernels_rel[0]
    kernels[0]["tolerance"] = f"{K1_REL_TOL:g} relative per element"

    ac = lpc.autocorr(x, max_o, window)
    lev_dev = lpc.levinson_all_orders(ac)[0].cpu()
    lev_cpu = lpc.levinson_all_orders(ac.cpu())[0]
    print(f"info: Levinson on the card == on the host: "
          f"{torch.equal(lev_dev, lev_cpu)}", flush=True)

    # -- 4. the stream through Encoder.encode_stream ------------------------
    counted = (k1_mod.autocorr, k2_mod.sweep_sums, k3_mod.merge_words)
    for fn in counted:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    enc = Encoder(cfg, device="cuda")
    t0 = time.perf_counter()
    blob = enc.encode_stream(pcm)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = [fn.launches for fn in counted]
    peak = torch.cuda.max_memory_allocated(dev)
    for k, n in zip(kernels, launches):
        k["launches"] = n
    print(f"launches on the main path: "
          f"{dict(zip((k['name'] for k in kernels), launches))}",
          flush=True)
    if min(launches) < 1:
        fail("a kernel of the main path was never launched")
    print(f"batches {enc.stats['batches']}, frames {enc.stats['frames']}: "
          "total_bits == 8*frame_bytes held for every batch", flush=True)

    enc2 = Encoder(cfg, device="cuda")
    t0 = time.perf_counter()
    blob2 = enc2.encode_stream(pcm)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    if blob2 != blob:
        fail("the warm run's bytes differ from the cold run's")
    print(f"encode {SECONDS} s level 8 on {card}: cold {cold:.3f} s "
          f"({SECONDS / cold:.1f}x realtime), warm {warm:.3f} s "
          f"({SECONDS / warm:.1f}x realtime); {len(blob)} bytes "
          f"({len(blob) / (pcm.shape[0] * 4):.4f} of 16-bit PCM); "
          f"peak device memory {peak / 2**20:.0f} MiB; warm stats "
          f"{ {k: round(v, 4) for k, v in enc2.stats.items()} }",
          flush=True)

    # the silent and noise seconds take the CONSTANT and VERBATIM branches
    for label, first, want in (("silent second", 640, frame.SF_CONSTANT),
                               ("noise second", 1070, frame.SF_VERBATIM)):
        _, hnb = header_bytes(np.arange(first, first + 32, dtype=np.int64))
        got = frame.analyze_frames(
            torch.from_numpy(pcm[first * BLOCK:(first + 32) * BLOCK]
                             .reshape(32, BLOCK, 2)).to(dev), fcfg,
            torch.from_numpy(hnb * 8).to(dev))["sf_type"]
        kinds = {int(k): int(v) for k, v in
                 zip(*torch.unique(got, return_counts=True))}
        print(f"{label}: subframe types {kinds}", flush=True)
        if want not in kinds:
            fail(f"the {label} did not reach subframe type {want}")

    decoder = load_reference_decoder()
    t0 = time.perf_counter()
    dec = decoder.decode_stream(blob)
    if not dec.md5_ok:
        fail("decoded MD5 does not match STREAMINFO")
    if not np.array_equal(dec.samples, pcm):
        fail("decoded samples differ from the input")
    print(f"decode: lossless, MD5 ok, {dec.frames} frames "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # -- 5. results -----------------------------------------------------------
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
