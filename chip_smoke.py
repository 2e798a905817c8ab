#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Builds the port's four CUDA kernels (K1 autocorrelation, K2 and K4 order
sweeps, K3 word merge) and the host CRC patcher from this checkout, and
holds each kernel against its plain PyTorch version: K1-K3 on the inputs
the first level-8 batch gives them, K4 (and K1 at 33 lags, K3 on
8192-sample frames) on the inputs of a level-12 batch of 8192-sample
sub-blocks, with K2 timed on K4's inputs beside it. K2 is held against
its plain version on every shape the level-12 path gives it (order 32,
the sub-block sizes outside K4's domain and the tail), and timed beside
K4 where K4 can sum the same shape. Three seconds of the level-12 stream
that hold steady audio and noise bursts must give the same bytes through
``Encoder(device="cpu")`` (the plain versions) and
``Encoder(device="cuda")``, reaching both K2 and K4. Then three
main paths run through ``Encoder.encode_stream``, cold and warm, each
with the launch counts set to 0 just before it and read just after: 180 s
of deterministic 16-bit / 44.1 kHz stereo at level 8 (K1-K3 must
launch), and a second deterministic stream with level jumps, bursts and
silences at levels 12 and 11, whose variable block sizes must split into
at least four sub-block sizes, 4096 and 8192 among them (K1-K4 must
launch). Every stream is decoded with the JAX package's independent
decoder (numpy only), MD5 included.

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
VBS_SECONDS = 60        # the level-12 and level-11 stream
PARITY_WINDOW = (4, 7)  # seconds of it through the CPU and the CUDA encoder
SCENE = 10              # seconds per scene of that stream
K1_REL_TOL = 5e-11      # tests/test_pallas_autocorr.py:55


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


def make_vbs_stream(seed: int, seconds: int) -> "np.ndarray":
    """int32 [n, 2] 16-bit stereo in 10 s scenes for the variable block
    sizes: two tone pairs under a slow envelope and light noise, whose
    level jumps between 1 and 0.3 every 4096 samples for the first 2 s of
    a scene (4096-sample sub-blocks), six noise bursts of 300-3000
    samples at 5-7 s (short sub-blocks) and silence at 9-10 s (CONSTANT
    subframes); the rest is steady (8192-sample blocks, unsplit)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = seconds * SAMPLE_RATE
    scene = SCENE * SAMPLE_RATE
    t = np.arange(n) / SAMPLE_RATE
    env = 0.6 + 0.4 * np.sin(2 * np.pi * t / 17.0)
    left = env * (7000 * np.sin(2 * np.pi * 196 * t)
                  + 3000 * np.sin(2 * np.pi * 392.5 * t))
    right = env * (6000 * np.sin(2 * np.pi * 247 * t + 0.5)
                   + 2500 * np.sin(2 * np.pi * 523 * t))
    pcm = np.stack([left, right], axis=1) + rng.normal(0, 120, (n, 2))
    idx = np.arange(n)
    pcm[(idx % scene < 2 * SAMPLE_RATE) & ((idx // 4096) % 2 == 1)] *= 0.3
    for s0 in range(0, n, scene):
        lo = s0 + 5 * SAMPLE_RATE
        for b in rng.integers(lo, min(lo + 2 * SAMPLE_RATE, n), 6):
            burst = pcm[b:b + int(rng.integers(300, 3000))]
            burst += rng.normal(0, 6000, burst.shape)
        pcm[s0 + 9 * SAMPLE_RATE:s0 + scene] = 0
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
    from flake_tpu_torch.encoder import Encoder, vbs_layout, vbs_section_sums
    from flake_tpu_torch.ops import autocorr as k1_mod
    from flake_tpu_torch.ops import bitmerge as k3_mod
    from flake_tpu_torch.ops import bitpack, frame, lpc
    from flake_tpu_torch.ops import sweep as sweep_mod

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

    def stream_config(level):
        return P.StreamConfig(channels=2, sample_rate=SAMPLE_RATE,
                              bits_per_sample=16,
                              params=P.set_defaults(level))

    def header_bytes(nums, block_size, allow_vbs):
        return bitpack.frame_header_bytes(
            nums, bs_code=P.blocksize_code(block_size),
            sr_code=P.samplerate_code(SAMPLE_RATE), allow_vbs=allow_vbs)

    def capture(hooks, run):
        """Run ``run()`` with each (module, name) of ``hooks`` wrapped to
        record the arguments of its calls: name -> list, in call order."""
        got = {}
        originals = [(mod, name, getattr(mod, name)) for mod, name in hooks]

        def wrap(name, orig):
            def rec(*args):
                got.setdefault(name, []).append(args)
                return orig(*args)
            return rec

        for mod, name, orig in originals:
            setattr(mod, name, wrap(name, orig))
        try:
            run()
            torch.cuda.synchronize()
        finally:
            for mod, name, orig in originals:
                setattr(mod, name, orig)
        return got

    def analyze_and_pack(frames, fcfg, nums, allow_vbs):
        hb, hnb = header_bytes(nums, fcfg.block_size, allow_vbs)
        analysis = frame.analyze_frames(frames, fcfg,
                                        torch.from_numpy(hnb * 8).to(dev))
        bitpack.pack_frames_device(analysis, torch.from_numpy(hb).to(dev),
                                   torch.from_numpy(hnb).to(dev), fcfg)
        return analysis

    # -- 3. kernel phases on the first level-8 batch's inputs ---------------
    pcm = make_stream(SEED)
    n_full = pcm.shape[0] // BLOCK
    print(f"level-8 stream: {pcm.shape[0]} samples x 2 ch = {n_full} full "
          f"frames + {pcm.shape[0] - n_full * BLOCK}-sample tail", flush=True)
    cfg8 = stream_config(8)
    fcfg8 = frame.FrameConfig.from_params(cfg8.params, 2, 16)
    cap8 = capture(
        [(frame, "autocorr"), (frame, "sweep_sums"), (bitpack, "merge_words")],
        lambda: analyze_and_pack(
            torch.from_numpy(pcm[:BATCH * BLOCK].reshape(BATCH, BLOCK, 2))
            .to(dev), fcfg8, np.arange(BATCH, dtype=np.int64), 0))
    x, window, max_o = cap8["autocorr"][0]
    sx, scoefs, sshifts, s_mo, s_pmax = cap8["sweep_sums"][0]
    ml, mlead, mpay, mwr = cap8["merge_words"][0]
    print(f"K1 inputs x {tuple(x.shape)}, max_order {max_o}; K2 inputs "
          f"coefs {tuple(scoefs.shape)}, pmax_static {s_pmax}; K3 inputs "
          f"slots {tuple(ml.shape)}, word_rows {mwr}", flush=True)

    kernels = []
    rel_err = {}

    def check(name, kern, plain, compare):
        out_k = kern()
        out_p = plain()
        torch.cuda.synchronize()
        err, ok, detail = compare(name, out_k, out_p)
        if not ok:
            fail(f"{name} disagrees with its plain version ({detail})")
        return err, detail

    def phase(name, route_src, replaces, kern, plain, compare):
        err, detail = check(name, kern, plain, compare)
        ms, plain_ms = time_pair(kern, plain)
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"{detail} -> ok", flush=True)
        kernels.append({"name": name, "route": "cuda", "source": route_src,
                        "replaces": replaces, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms})

    def cmp_rel(name, a, b):
        abs_err = (a - b).abs()
        rel = (abs_err / b.abs().clamp_min(1e-300)).max().item()
        rel_err[name] = rel
        return abs_err.max().item(), rel < K1_REL_TOL, \
            f"max rel err {rel:.3e} (tolerance {K1_REL_TOL:g})"

    def cmp_exact(name, a, b):
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
    kernels[-1]["max_rel_err"] = rel_err["autocorr"]
    kernels[-1]["tolerance"] = f"{K1_REL_TOL:g} relative per element"
    phase("sweep_sums", "flake_tpu_torch/csrc/sweep.cu",
          "flake_tpu/ops/pallas_sweep3.py:124",
          lambda: sweep_mod.sweep_sums(sx, scoefs, sshifts, s_mo, s_pmax),
          lambda: sweep_mod.sweep_sums_plain(sx, scoefs, sshifts, s_mo,
                                          s_pmax), cmp_exact)
    phase("merge_words", "flake_tpu_torch/csrc/bitmerge.cu",
          "flake_tpu/ops/pallas_bitmerge.py:173",
          lambda: k3_mod.merge_words(ml, mlead, mpay, mwr),
          lambda: k3_mod.merge_words_plain(ml, mlead, mpay, mwr), cmp_exact)

    ac = lpc.autocorr(x, max_o, window)
    lev_dev = lpc.levinson_all_orders(ac)[0].cpu()
    lev_cpu = lpc.levinson_all_orders(ac.cpu())[0]
    print(f"info: Levinson on the card == on the host: "
          f"{torch.equal(lev_dev, lev_cpu)}", flush=True)

    # -- 4. K4 on a level-12 batch of 8192-sample sub-blocks ----------------
    vpcm = make_vbs_stream(SEED + 12, VBS_SECONDS)
    cfg12 = stream_config(12)
    vbs = cfg12.params.block_size
    n_super = vpcm.shape[0] // vbs
    supers = vpcm[:n_super * vbs].reshape(n_super, vbs, 2)
    sec = vbs // P.VBS_MAX_FRAMES
    res = vbs_section_sums(torch.from_numpy(supers).to(dev), sec)
    f_idx, starts, sizes = vbs_layout(res.cpu().numpy(), sec)
    hist = {int(k): int(v) for k, v in zip(*np.unique(sizes,
                                                      return_counts=True))}
    print(f"level-12/11 stream: {vpcm.shape[0]} samples x 2 ch = {n_super} "
          f"superblocks of {vbs} + {vpcm.shape[0] - n_super * vbs}-sample "
          f"tail; sub-block sizes {hist}", flush=True)
    if len(hist) < 4 or 4096 not in hist or vbs not in hist:
        fail("the split decision gave fewer than four sub-block sizes or "
             "missed 4096 or 8192")
    whole = np.flatnonzero(sizes == vbs)[:BATCH]
    fcfg12 = frame.FrameConfig.from_params(cfg12.params, 2, 16,
                                           block_size=vbs)
    cap12 = capture(
        [(frame, "autocorr"), (frame, "sweep_granules"),
         (bitpack, "merge_words")],
        lambda: analyze_and_pack(
            torch.from_numpy(supers[f_idx[whole]]).to(dev), fcfg12,
            f_idx[whole] * vbs, 1))
    gx, gcoefs, gshifts, g_mo, g_pmax = cap12["sweep_granules"][0]
    print(f"K4 inputs x {tuple(gx.shape)} ({whole.size} sub-blocks of "
          f"{vbs}), coefs {tuple(gcoefs.shape)}, pmax_static {g_pmax}, "
          f"granule {sweep_mod.granule_size(gx.shape[1], g_pmax)}", flush=True)

    def k4_run():
        return sweep_mod.sweep_granules(gx, gcoefs, gshifts, g_mo, g_pmax)

    def k2_run():
        return sweep_mod.sweep_sums(gx, gcoefs, gshifts, g_mo, g_pmax)

    phase("sweep_granules", "flake_tpu_torch/csrc/sweep_granules.cu",
          "flake_tpu/ops/pallas_sweep.py:147", k4_run,
          lambda: sweep_mod.sweep_granules_plain(gx, gcoefs, gshifts, g_mo,
                                              g_pmax), cmp_exact)
    folded = k4_run().reshape(gx.shape[0], g_mo, 1 << g_pmax, -1).sum(-1)
    if not torch.equal(folded, k2_run()):
        fail("K4's granules, folded to partitions, differ from K2's sums")
    k4_ms, k2_ms = time_pair(k4_run, k2_run)
    kernels[-1]["k2_ms_same_inputs"] = k2_ms
    kernels[-1]["ms_beside_k2"] = k4_ms
    print(f"info: on K4's inputs K4 {k4_ms:.4f} ms, K2 {k2_ms:.4f} ms "
          f"(same sums folded)", flush=True)

    ax, awin, a_mo = cap12["autocorr"][0]
    _, detail = check("autocorr", lambda: k1_mod.autocorr(ax, awin, a_mo),
                      lambda: lpc.autocorr(ax, a_mo, awin), cmp_rel)
    print(f"K1 at {a_mo + 1} lags on x {tuple(ax.shape)}: {detail}",
          flush=True)
    vl, vlead, vpay, vwr = cap12["merge_words"][0]
    _, detail = check("merge_words",
                      lambda: k3_mod.merge_words(vl, vlead, vpay, vwr),
                      lambda: k3_mod.merge_words_plain(vl, vlead, vpay, vwr),
                      cmp_exact)
    print(f"K3 on {vbs}-sample frames, slots {tuple(vl.shape)}, word_rows "
          f"{vwr}: {detail}", flush=True)

    # -- 5. K2 on every shape the level-12 path gives it ---------------------
    # the sub-block sizes outside K4's domain and the tail, at order 32 with
    # up to 256 partitions (64 KiB of shared accumulators); where K4 can sum
    # the same shape, both are timed on it, to measure the route on the card
    k2_calls = capture([(frame, "sweep_sums")],
                       lambda: Encoder(cfg12, device="cuda")
                       .encode_stream(vpcm))["sweep_sums"]
    k2_shapes = []
    for cx, cc, cs, c_mo, c_pmax in k2_calls:
        def k2c(cx=cx, cc=cc, cs=cs, c_mo=c_mo, c_pmax=c_pmax):
            return sweep_mod.sweep_sums(cx, cc, cs, c_mo, c_pmax)

        _, detail = check(
            "sweep_sums", k2c,
            lambda: sweep_mod.sweep_sums_plain(cx, cc, cs, c_mo, c_pmax),
            cmp_exact)
        line = (f"K2 on x {tuple(cx.shape)}, order {c_mo}, pmax_static "
                f"{c_pmax}: {detail}")
        if sweep_mod.granule_fits(cx.shape[1], c_pmax):
            def k4c(cx=cx, cc=cc, cs=cs, c_mo=c_mo, c_pmax=c_pmax):
                return sweep_mod.sweep_granules(cx, cc, cs, c_mo, c_pmax)

            folded = k4c().reshape(cx.shape[0], c_mo, 1 << c_pmax, -1).sum(-1)
            if not torch.equal(folded, k2c()):
                fail(f"K4 folded differs from K2 on x {tuple(cx.shape)}")
            k4_ms, k2_ms = time_pair(k4c, k2c)
            line += (f"; info: K4 {k4_ms:.4f} ms (granule "
                     f"{sweep_mod.granule_size(cx.shape[1], c_pmax)}, same "
                     f"sums folded), K2 {k2_ms:.4f} ms")
        print(line, flush=True)
        k2_shapes.append([*cx.shape, c_mo, c_pmax])
    if not any(s[2] == 32 and s[3] == 8 for s in k2_shapes):
        fail("the level-12 path gave K2 no shape at order 32, pmax 8")
    next(k for k in kernels if k["name"] == "sweep_sums")[
        "order32_shapes_checked"] = k2_shapes

    # -- 6. a level-12 segment through the CPU and the CUDA encoder ---------
    seg = vpcm[PARITY_WINDOW[0] * SAMPLE_RATE:PARITY_WINDOW[1] * SAMPLE_RATE]
    before = {fn: fn.launches for fn in (sweep_mod.sweep_sums,
                                         sweep_mod.sweep_granules)}
    t0 = time.perf_counter()
    on_card = Encoder(cfg12, device="cuda").encode_stream(seg)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    if any(fn.launches == n for fn, n in before.items()):
        fail("the level-12 parity segment did not reach both K2 and K4")
    t0 = time.perf_counter()
    on_host = Encoder(cfg12, device="cpu").encode_stream(seg)
    t_host = time.perf_counter() - t0
    print(f"parity: {PARITY_WINDOW[0]}-{PARITY_WINDOW[1]} s of level 12, "
          f"CUDA {t_card:.2f} s, CPU {t_host:.2f} s, {len(on_card)} bytes, "
          f"equal {on_card == on_host}", flush=True)
    if on_card != on_host:
        fail("the CPU and CUDA encoders disagree on the level-12 segment")

    # -- 7. the main paths through Encoder.encode_stream ---------------------
    counted = {"autocorr": k1_mod.autocorr, "sweep_sums": sweep_mod.sweep_sums,
               "merge_words": k3_mod.merge_words,
               "sweep_granules": sweep_mod.sweep_granules}
    launched = dict.fromkeys(counted, 0)
    decoder = load_reference_decoder()

    def drive(label, cfg, stream, needs):
        """One main path, cold then warm; the counts are set to 0 just
        before the cold run and read just after it."""
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        enc = Encoder(cfg, device="cuda")
        t0 = time.perf_counter()
        blob = enc.encode_stream(stream)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in counted.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"{label}: launches {counts}", flush=True)
        missing = [name for name in needs if counts[name] < 1]
        if missing:
            fail(f"{label}: {missing} never launched on the main path")
        for name, n in counts.items():
            launched[name] += n
        print(f"{label}: batches {enc.stats['batches']}, frames "
              f"{enc.stats['frames']}: total_bits == 8*frame_bytes held for "
              "every batch", flush=True)
        enc2 = Encoder(cfg, device="cuda")
        t0 = time.perf_counter()
        blob2 = enc2.encode_stream(stream)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        if blob2 != blob:
            fail(f"{label}: the warm run's bytes differ from the cold run's")
        secs = stream.shape[0] / SAMPLE_RATE
        print(f"encode {secs:g} s {label} on {card}: cold {cold:.3f} s "
              f"({secs / cold:.1f}x realtime), warm {warm:.3f} s "
              f"({secs / warm:.1f}x realtime); {len(blob)} bytes "
              f"({len(blob) / (stream.shape[0] * 4):.4f} of 16-bit PCM); "
              f"peak device memory {peak / 2**20:.0f} MiB; warm stats "
              f"{ {k: round(v, 4) for k, v in enc2.stats.items()} }",
              flush=True)
        t0 = time.perf_counter()
        dec = decoder.decode_stream(blob)
        if not dec.md5_ok:
            fail(f"{label}: decoded MD5 does not match STREAMINFO")
        if not np.array_equal(dec.samples, stream):
            fail(f"{label}: decoded samples differ from the input")
        print(f"{label} decode: lossless, MD5 ok, {dec.frames} frames, "
              f"STREAMINFO block sizes {dec.streaminfo.min_block_size}-"
              f"{dec.streaminfo.max_block_size} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        return dec

    k123 = ("autocorr", "sweep_sums", "merge_words")
    dec8 = drive("level 8", cfg8, pcm, k123)
    if dec8.streaminfo.min_block_size != BLOCK:
        fail("level 8: STREAMINFO min block is not the block size")
    # the silent and noise seconds take the CONSTANT and VERBATIM branches
    for label, first, want in (("silent second", 640, frame.SF_CONSTANT),
                               ("noise second", 1070, frame.SF_VERBATIM)):
        _, hnb = header_bytes(np.arange(first, first + 32, dtype=np.int64),
                              BLOCK, 0)
        got = frame.analyze_frames(
            torch.from_numpy(pcm[first * BLOCK:(first + 32) * BLOCK]
                             .reshape(32, BLOCK, 2)).to(dev), fcfg8,
            torch.from_numpy(hnb * 8).to(dev))["sf_type"]
        kinds = {int(k): int(v) for k, v in
                 zip(*torch.unique(got, return_counts=True))}
        print(f"{label}: subframe types {kinds}", flush=True)
        if want not in kinds:
            fail(f"the {label} did not reach subframe type {want}")

    for level in (12, 11):
        dec = drive(f"level {level}", stream_config(level), vpcm,
                    tuple(counted))
        if dec.streaminfo.min_block_size != 16:
            fail(f"level {level}: STREAMINFO min block is not 16")

    # -- 8. results -----------------------------------------------------------
    for k in kernels:
        k["launches"] = launched[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
