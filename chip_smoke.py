#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Builds the port's CUDA kernels (K1 autocorrelation, K2 and K4 order
sweeps, K3 word merge, K5 pre-aligned word merge, U1, the four merge
variants of the emission-profiling tool, U2, the merge prototypes
``merge_v2`` and ``merge_v3``, U3a/U3b, the combined-node merges
``merge_v5a`` and ``merge_v5b``, and U3c-U3f, their row-layout forms
``merge_v5d`` and ``merge_v5c`` with the zero floors ``merge_zero_rows`` and
``merge_zero_fb``) and its host libraries (CRC
patcher, decoder helpers) from this checkout, and holds each kernel
against its plain PyTorch version: K1-K3 on the inputs the first level-8
batch gives them, K4 (and K1 at 33 lags, K3 on 8192-sample frames) on the
inputs of a level-12 batch of 8192-sample sub-blocks, with K2 timed on
K4's inputs beside it; K5 and U1 on the aligned parts of the profiling
tool's own level-8 batch, K5 also on the first level-5 batch and the
level-12 8192 bucket, where its words must equal K3's. K2 is held against
its plain version on every shape the level-12 path gives it (order 32,
the sub-block sizes outside K4's domain and the tail), and timed beside
K4 where K4 can sum the same shape. Every kernel's time stands beside its
plain version's, its bound (the least time the card could take: bytes
over the memory rate or operations over the peak rate, whichever is
larger) and, where one PyTorch call computes the same function, that
call's time. U2 and U3 are held against their plain versions bit for bit
on the ``music`` and ``noise`` batches of their tools (512 frames of 4096;
the noise frames are verbatim, in chunks of 68 words, past the first
window of ``merge_v2``) and on a made-up slot table with unary runs of
thousands of bits, where ``merge_v2`` drops and misplaces parts,
``merge_v3`` drops rows and both spill sets of the combined nodes are
flagged; ``merge_v5a``, ``merge_v5b``, K5 and K3 must give the same words
on all three, and K5 is held against its plain version and K3 on the noise
batch too. ``merge_v5d`` and ``merge_v5c`` (at 1 and 8 frames a block) must
equal their plain version on all three, K5's and K3's words on the two
batches, where no frame may overflow the static rows, and K5's words on the
frames of the made-up table that do not overflow them (some must); the zero
floors must give ``torch.zeros``. The Schur and Levinson recursions of the EST order method
must give the same float64 bits on the card and on the host.

Three-second windows must give the same bytes through
``Encoder(device="cpu")`` (the plain versions) and
``Encoder(device="cuda")``: 4-7 s of the level-12 stream (steady audio
and noise bursts, reaching both K2 and K4) and 99-102 s of the fixed-block
stream (tones around the full-scale noise second) at levels 5, 7, 3, 2, 1
and 0. Each fixed-block stream (levels 8, 5, 7, 3, 2, 1, 0) is encoded
once with K1, K2 and K3 recorded, and every call they got, each 512-frame
batch and the partial last block, is held against the plain version again
(K1 at 13, 9 and 7 lags, K2 at orders 12 and 8, K3 on 4096- and
1152-sample frames). Then the main paths run, each with the launch counts set to 0 just before it
and read just after: the profiling tool
(``flake_tpu_torch.util.prof_merge.main``; K1-K3, K5 and U1 must launch),
the merge-prototype tools (``prof_merge2.main`` and ``main_v3``: K5 and
``merge_v2``, ``merge_v3``; ``prof_merge3.main``: K5, ``merge_v5a``,
``merge_v5b``; ``prof_merge3.main_v5d``: K5, ``merge_v5d``,
``merge_zero_rows``; ``prof_merge3.main_v5c``: K5, ``merge_v5c``,
``merge_zero_fb``) and, through ``Encoder.encode_stream``, cold and warm,
180 s of deterministic 16-bit / 44.1 kHz stereo at level 8 (K1-K3 must launch) and
at level 5 (EST: K1 and K3 must launch, K2 must not), 60 s of it at level
7 (K1-K3), 30 s at levels 3 (K1, K3) and 2, 1, 0 (block 1152, K3 only),
and a second deterministic stream with level jumps, bursts and silences
at levels 12 and 11, whose variable block sizes must split into at least
four sub-block sizes, 4096 and 8192 among them (K1-K4 must launch). Every
stream is decoded with the port's independent decoder
(``flake_tpu_torch.decoder``), MD5 included.

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

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 20260116
SAMPLE_RATE = 44100
SECONDS = 180
BLOCK = 4096
BATCH = 512
VBS_SECONDS = 60        # the level-12 and level-11 stream
PARITY_WINDOW = (4, 7)  # seconds of it through the CPU and the CUDA encoder
FIXED_PARITY_WINDOW = (99, 102)  # of the fixed-block stream, levels 5 and 7
# seconds of the fixed-block stream per level below 8 (level 8 takes it all)
LEVEL_SECONDS = {5: 180, 7: 60, 3: 30, 2: 30, 1: 30, 0: 30}
SCENE = 10              # seconds per scene of that stream
K1_REL_TOL = 5e-11      # tests/test_pallas_autocorr.py:55
# Published peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM3;
# 67 TFLOP/s float32 outside the tensor cores, float64 at half of it. An SM
# has half as many int32 lanes as float32 lanes, so int32 operations peak
# at half the float32 rate too.
HBM_BYTES_PER_MS = 3.35e9
FP64_OPS_PER_MS = 33.5e9
INT32_OPS_PER_MS = 33.5e9


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


def make_slot_table(seed: int, frames: int, slots: int):
    """A made-up slot table, int32 numpy [frames, slots] x 3 (lengths,
    leading zero bits, payload) and the word rows that hold its longest
    frame: fields of 0-32 payload bits, one in a hundred behind a unary run
    of up to 9,000 zero bits. Chunks of 128 slots then pass 256 words and
    four word rows, and neighbours do not fit a 64-bit node."""
    import numpy as np

    rng = np.random.default_rng(seed)
    paylen = rng.integers(0, 33, (frames, slots))
    leading = np.where(rng.random((frames, slots)) < 0.01,
                       rng.integers(1, 9000, (frames, slots)), 0)
    leading[paylen == 0] = 0
    payload = rng.integers(0, 1 << 32, (frames, slots)) & ((1 << paylen) - 1)
    lengths = paylen + leading
    word_rows = int(-(-lengths.sum(-1).max() // 4096)) + 1
    return (lengths.astype(np.int32), leading.astype(np.int32),
            payload.astype(np.uint32).view(np.int32)), word_rows


def bound(bytes_moved: float, ops: float, ops_per_ms: float):
    """The least ms the card could take for this much work, and which of
    bytes or operations sets it."""
    by_bytes = bytes_moved / HBM_BYTES_PER_MS
    by_ops = ops / ops_per_ms
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def time_turns(*fns, loop=(), reps: int = 20):
    """Mean ms per call of each function between two CUDA events, in turns
    (first to last, then last to first) after one warm-up call each. A
    function in ``loop`` (a plain version, a program of many launches) is
    timed in a plain loop, as its caller sees it; every other is one
    short kernel and is timed back to back, enqueued behind a spinning
    kernel, so that the card's time is read and not the host's launch
    rate (``flake_tpu_torch.util.prof_merge.device_ms``)."""
    import torch
    from flake_tpu_torch.util.prof_merge import device_ms

    dev = torch.device("cuda", 0)
    for fn in fns:
        fn()
    forth = [device_ms(fn, dev, reps, fn not in loop) for fn in fns]
    back = [device_ms(fn, dev, reps, fn not in loop)
            for fn in reversed(fns)][::-1]
    return [(f + b) / 2 for f, b in zip(forth, back)]


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

    from flake_tpu_torch import _cuda, decoder, native
    from flake_tpu_torch import params as P
    from flake_tpu_torch.encoder import Encoder, vbs_layout, vbs_section_sums
    from flake_tpu_torch.ops import autocorr as k1_mod
    from flake_tpu_torch.ops import bitmerge as k3_mod
    from flake_tpu_torch.ops import bitpack, frame, lpc
    from flake_tpu_torch.ops import sweep as sweep_mod
    from flake_tpu_torch.util import prof_merge as tool
    from flake_tpu_torch.util import prof_merge2 as tool2
    from flake_tpu_torch.util import prof_merge3 as tool3

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
    native.get_verifier()
    print(f"build crc_patch.cpp and verifier.cpp: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

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

    def phase(name, route_src, replaces, kern, plain, compare, reads, ops,
              ops_per_ms, library=None, plain_is_one_kernel=False,
              read_bytes=None):
        """Hold one kernel against its plain version, time both (and the
        library call, where there is one) in turns, and work out its
        bound: ``reads`` are the tensors the function must read, each
        once, its outputs are written once, ``ops`` the operations it
        does on these inputs at ``ops_per_ms`` peak; ``read_bytes`` stands
        in for the size of ``reads`` where the data decides how much of
        them is needed. The kernel and the
        library call are timed back to back, the plain version in a plain
        loop unless it is one kernel too."""
        err, detail = check(name, kern, plain, compare)
        out = kern()
        moved = (nbytes(*reads) if read_bytes is None else read_bytes) \
            + nbytes(*(out if isinstance(out, tuple) else (out,)))
        bound_ms, bound_by = bound(moved, ops, ops_per_ms)
        fns = (plain, kern) if library is None else (plain, kern, library)
        plain_ms, ms, *rest = time_turns(
            *fns, loop=() if plain_is_one_kernel else (plain,))
        library_ms = rest[0] if rest else None
        timed = {"ms": "back_to_back", "plain_ms": "back_to_back"
                 if plain_is_one_kernel else "loop"}
        print(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms by {bound_by} ({moved / 1e6:.1f} MB, "
              f"{ops / 1e9:.3f} G operations), library call "
              f"{'none' if library_ms is None else f'{library_ms:.4f} ms'}, "
              f"timed {timed}, {detail} -> ok", flush=True)
        kernels.append({"name": name, "route": "cuda", "source": route_src,
                        "replaces": replaces, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms,
                        "timed": timed})

    def sweep_ops(sx, order):
        """Operations of an order sweep: one 32x32->64-bit multiply-add per
        sample, candidate order and tap, each counted as four int32
        operations (a multiply and an add on two 32-bit halves)."""
        return 4 * sx.numel() * order * (order + 1) // 2

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
          lambda: lpc.autocorr(x, max_o, window), cmp_rel,
          # a window multiply per sample, a float64 multiply-add per sample
          # and lag
          (x, window), x.numel() * (1 + 2 * (max_o + 1)), FP64_OPS_PER_MS)
    kernels[-1]["max_rel_err"] = rel_err["autocorr"]
    kernels[-1]["tolerance"] = f"{K1_REL_TOL:g} relative per element"
    phase("sweep_sums", "flake_tpu_torch/csrc/sweep.cu",
          "flake_tpu/ops/pallas_sweep3.py:124",
          lambda: sweep_mod.sweep_sums(sx, scoefs, sshifts, s_mo, s_pmax),
          lambda: sweep_mod.sweep_sums_plain(sx, scoefs, sshifts, s_mo,
                                          s_pmax), cmp_exact,
          (sx, scoefs, sshifts), sweep_ops(sx, s_mo), INT32_OPS_PER_MS)
    phase("merge_words", "flake_tpu_torch/csrc/bitmerge.cu",
          "flake_tpu/ops/pallas_bitmerge.py:173",
          lambda: k3_mod.merge_words(ml, mlead, mpay, mwr),
          lambda: k3_mod.merge_words_plain(ml, mlead, mpay, mwr), cmp_exact,
          # about 16 int32 operations per slot: the scan, the shifts and
          # masks of its two word parts, two atomics
          (ml, mlead, mpay), 16 * ml.numel(), INT32_OPS_PER_MS)

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
                                              g_pmax), cmp_exact,
          (gx, gcoefs, gshifts), sweep_ops(gx, g_mo), INT32_OPS_PER_MS)
    folded = k4_run().reshape(gx.shape[0], g_mo, 1 << g_pmax, -1).sum(-1)
    if not torch.equal(folded, k2_run()):
        fail("K4's granules, folded to partitions, differ from K2's sums")
    k2_ms, k4_ms = time_turns(k2_run, k4_run)
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

    # -- 4b. K5 and U1 on the profiling tool's batch ---------------------------
    tF = tool.FRAMES
    tslots, tcfg = tool.batch_slots("music", tF, dev)
    parts = bitpack.aligned_parts(*tslots)
    twr = bitpack.word_rows(tcfg)
    w0t, hit, lot, cbits = parts
    nc = w0t.shape[-1]
    print(f"K5 and U1 inputs: aligned parts {tuple(w0t.shape)} of slots "
          f"{tuple(tslots[0].shape)}, chunk_bits {tuple(cbits.shape)}, "
          f"word_rows {twr}", flush=True)
    # the library yardstick: one scatter_add_ of every hi and lo word at its
    # word index (prepared outside the timed call) computes K5's words
    sc_idx = torch.cat([w0t, w0t + 1], dim=1).reshape(tF, -1).to(torch.int64)
    sc_val = torch.cat([hit, lot], dim=1).reshape(tF, -1)
    if int(sc_idx.min()) < 0 or int(sc_idx.max()) >= twr * 128:
        fail("the tool's batch has a word index outside its block")

    def k5_library():
        return torch.zeros((tF, twr * 128), dtype=torch.int32, device=dev) \
            .scatter_add_(1, sc_idx, sc_val).reshape(tF, twr, 128)

    def k5_run():
        return k3_mod.merge_aligned(*parts, twr)

    if not torch.equal(k5_library(), k5_run()):
        fail("scatter_add_ does not give K5's words")
    # about 6 int32 operations per slot: bounds checks and two atomics
    phase("merge_aligned", "flake_tpu_torch/csrc/bitmerge_aligned.cu",
          "flake_tpu/ops/pallas_bitmerge.py:271", k5_run,
          lambda: k3_mod.merge_aligned_plain(*parts, twr), cmp_exact,
          (w0t, hit, lot), 6 * w0t.numel(), INT32_OPS_PER_MS,
          library=k5_library)
    if not torch.equal(k5_run(), k3_mod.merge_words(*tslots, twr)[0]):
        fail("K5's words differ from K3's on the tool's slots")
    def prep_run():
        return bitpack.aligned_parts(*tslots)

    k5_ms, prep_ms, k3_ms = time_turns(
        k5_run, prep_run, lambda: k3_mod.merge_words(*tslots, twr),
        loop=(prep_run,))
    print(f"info: on the tool's slots K5 {k5_ms:.4f} ms after aligned_parts "
          f"{prep_ms:.4f} ms (in a plain loop), K3 {k3_ms:.4f} ms from the "
          "slots directly; the words are equal", flush=True)

    # what each variant must read: static2 and fixedrow everything, nowin
    # the hi words and the chunk bounds, zero nothing
    u1 = {"static2": (154, (cbits, w0t, hit, lot), 8 * w0t.numel()),
          "fixedrow": (178, (cbits, w0t, hit, lot), 10 * w0t.numel()),
          "nowin": (208, (cbits, hit), hit.numel()),
          "zero": (228, (), 0)}
    for name, (line, reads, ops) in u1.items():
        kern, plain = tool.VARIANTS[name]
        phase(f"prof_merge_{name}", "flake_tpu_torch/csrc/prof_merge.cu",
              f"util/prof_merge.py:141 (k_{name} :{line})",
              lambda kern=kern: kern(*parts, twr),
              lambda plain=plain: plain(*parts, twr), cmp_exact, reads, ops,
              INT32_OPS_PER_MS,
              library=(lambda: torch.zeros((tF, twr, 128), dtype=torch.int32,
                                           device=dev))
              if name == "zero" else None,
              plain_is_one_kernel=name == "zero")
    print(f"static2_matches: "
          f"{torch.equal(tool.merge_static2(*parts, twr), k5_run())}",
          flush=True)

    def k5_on(label, slots, wr):
        """K5 against its plain version and against K3 on ``slots``."""
        p5 = bitpack.aligned_parts(*slots)
        got = k3_mod.merge_aligned(*p5, wr)
        torch.cuda.synchronize()
        if not torch.equal(got, k3_mod.merge_aligned_plain(*p5, wr)):
            fail(f"K5 disagrees with its plain version on {label}")
        if not torch.equal(got, k3_mod.merge_words(*slots, wr)[0]):
            fail(f"K5's words differ from K3's on {label}")
        print(f"K5 on {label}: aligned parts {tuple(p5[0].shape)}, word_rows "
              f"{wr}: bit-exact against its plain version and K3", flush=True)

    k5_on(f"the level-12 bucket of {vbs}-sample frames", (vl, vlead, vpay),
          vwr)
    cfg5 = stream_config(5)
    fcfg5 = frame.FrameConfig.from_params(cfg5.params, 2, 16)
    cap5 = capture(
        [(frame, "autocorr"), (bitpack, "merge_words")],
        lambda: analyze_and_pack(
            torch.from_numpy(pcm[:BATCH * BLOCK].reshape(BATCH, BLOCK, 2))
            .to(dev), fcfg5, np.arange(BATCH, dtype=np.int64), 0))
    k5_on("the first level-5 batch", cap5["merge_words"][0][:3],
          cap5["merge_words"][0][3])

    # -- 4b2. U2 and U3 on the music and noise batches and a made-up table -----
    nslots, _ = tool.batch_slots("noise", tF, dev)
    k5_on("the tools' noise batch", nslots, twr)
    made_up, mwr2 = make_slot_table(SEED + 4, 64, tslots[0].shape[1])
    content = {"music": (tslots, twr), "noise": (nslots, twr),
               "made-up table": (tuple(torch.from_numpy(a).to(dev)
                                       for a in made_up), mwr2)}
    aligned = {k: bitpack.aligned_parts(*sl) for k, (sl, _) in content.items()}
    combined = {k: tool3.v5_parts(*sl) for k, (sl, _) in content.items()}
    in_rows = {k: tool3.v5d_parts(*sl) for k, (sl, _) in content.items()}
    in_dual = {k: tool3.v5c_parts(*sl) for k, (sl, _) in content.items()}
    for label, (slots_c, wr_c) in content.items():
        al, v5 = aligned[label], combined[label]
        k5_words = k3_mod.merge_aligned(*al, wr_c)
        if label == "made-up table":
            k5_on(f"the made-up table ({wr_c} word rows, "
                  f"{wr_c * 512 / 1024:.0f} KiB of shared words)", slots_c,
                  wr_c)
        same = {}
        for name, kern, plain in (("v2", tool2.merge_v2,
                                   tool2.merge_v2_plain),
                                  ("v3", tool2.merge_v3,
                                   tool2.merge_v3_plain)):
            want = plain(*al, wr_c)
            for fb in (1, 8):
                got = kern(*al, wr_c, fb)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"merge_{name} at fb {fb} disagrees with its plain "
                         f"version on {label}")
            same[name] = torch.equal(want, k5_words)
        want = tool3.merge_v5_plain(*v5, wr_c)
        for name, kern in (("v5a", tool3.merge_v5a), ("v5b", tool3.merge_v5b)):
            got = kern(*v5, wr_c)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"merge_{name} disagrees with its plain version on "
                     f"{label}")
        if not torch.equal(want, k5_words) or not torch.equal(
                want, k3_mod.merge_words(*slots_c, wr_c)[0]):
            fail(f"the combined nodes' words differ from K5's or K3's on "
                 f"{label}")
        ext = int(tool2.chunk_ext_words(al[3]).max())
        flagged = [float((cb[:, :-1] < 0).double().mean()) for cb in v5[3:]]
        print(f"U2, U3 on {label}: merge_v2, merge_v3 (fb 1, 8), merge_v5a, "
              f"merge_v5b bit-exact against their plain versions; v5a = v5b "
              f"= K5 = K3 words; widest chunk {ext} words; v2 gives K5's "
              f"words {same['v2']}, v3 {same['v3']}; flagged chunks sp2 "
              f"{flagged[0]:.4f}, sp1 {flagged[1]:.4f}", flush=True)
        in_domain = label != "made-up table"
        if same["v2"] != in_domain or same["v3"] != in_domain:
            fail(f"merge_v2 / merge_v3 against K5 on {label}: expected "
                 f"{in_domain}")
        if (flagged[0] > 0, flagged[1] > 0) != (True, not in_domain):
            fail(f"unexpected spill flags on {label}: {flagged}")
        # U3c-U3f: the same nodes in rows, placed over static rows
        *rows, overflow = in_rows[label]
        *dual, _ = in_dual[label]
        want = tool3.merge_v5_rows_plain(*rows, wr_c)
        zeros = torch.zeros_like(want)
        for kern, floor, kin in (
                (tool3.merge_v5d, tool3.merge_zero_rows, rows),
                (tool3.merge_v5c, tool3.merge_zero_fb, dual)):
            for fb in (1, 8):
                got, nothing = kern(*kin, wr_c, fb), floor(*kin, wr_c, fb)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"{kern.__name__} at fb {fb} disagrees with its "
                         f"plain version on {label}")
                if not torch.equal(nothing, zeros):
                    fail(f"{floor.__name__} at fb {fb} does not give zeros "
                         f"on {label}")
        n_over = int(overflow.sum())
        if bool(n_over) == in_domain:
            fail(f"{n_over} frames overflow the static rows on {label}")
        if not torch.equal(want[~overflow], k5_words[~overflow]) or (
                in_domain and not torch.equal(
                    want, k3_mod.merge_words(*slots_c, wr_c)[0])):
            fail(f"the row-layout merges' words differ from K5's or K3's on "
                 f"{label}")
        changed = int((want != k5_words).flatten(1).any(-1).sum())
        print(f"U3c-U3f on {label}: merge_v5d, merge_v5c (fb 1, 8) bit-exact "
              f"against their plain version, merge_zero_rows, merge_zero_fb "
              f"against torch.zeros; {n_over} of {want.shape[0]} frames "
              f"overflow {tool3.KMAX} / {tool3.KMAX1} static rows, {changed} "
              f"differ from K5's words, the others equal them", flush=True)

    # times and bounds on the music batch, the shapes the tools time; v2 and
    # v3 at fb = 8, the JAX tool's default. One scatter_add_ gives their
    # words too, since they equal K5's there.
    for name, line, body, ops in (("v2", 224, "k_v2 :193", 12),
                                  ("v3", 353, "k_v3 :328", 10)):
        kern = getattr(tool2, f"merge_{name}")
        plain = getattr(tool2, f"merge_{name}_plain")
        phase(f"prof_merge_{name}", "flake_tpu_torch/csrc/prof_merge2.cu",
              f"util/prof_merge2.py:{line} ({body})",
              lambda kern=kern: kern(*parts, twr, 8),
              lambda plain=plain: plain(*parts, twr), cmp_exact,
              (cbits, w0t, hit, lot), ops * w0t.numel(), INT32_OPS_PER_MS,
              library=k5_library)
        kernels[-1]["fb"] = 8

    def v5_read_bytes(v5):
        """What the v5 kernels must read of ``v5``: both cb tables, the
        main set, and the nodes of the flagged spill chunks."""
        main_p, _, _, cb2, cb1 = v5
        flagged2 = int((cb2[:, :-1] < 0).sum())
        flagged1 = int((cb1[:, :-1] < 0).sum())
        return nbytes(cb2, cb1, *main_p) + 128 * 4 * (4 * flagged2
                                                      + 3 * flagged1)

    for name, line, body in (("v5a", 344, "k_v5a :307"),
                             ("v5b", 440, "k_v5b :403")):
        kern = getattr(tool3, f"merge_{name}")
        v5 = combined["music"]
        # about 8 int32 operations per node: bounds checks and three atomics
        phase(f"prof_merge_{name}", "flake_tpu_torch/csrc/prof_merge3.cu",
              f"util/prof_merge3.py:{line} ({body})",
              lambda kern=kern, v5=v5: kern(*v5, twr),
              lambda v5=v5: tool3.merge_v5_plain(*v5, twr), cmp_exact, (),
              8 * v5[0][0].numel(), INT32_OPS_PER_MS,
              read_bytes=v5_read_bytes(v5))
        # the noise batch, every sp2 chunk flagged, beside it
        v5n = combined["noise"]
        noise_ms, = time_turns(lambda kern=kern, v5n=v5n: kern(*v5n, twr))
        noise_bound, _ = bound(v5_read_bytes(v5n) + tF * twr * 512, 0,
                               INT32_OPS_PER_MS)
        kernels[-1].update(noise_ms=noise_ms, noise_bound_ms=noise_bound)
        print(f"info: prof_merge_{name} on the noise batch {noise_ms:.4f} ms, "
              f"bound {noise_bound:.4f} ms by bytes", flush=True)

    def v5a_run():
        return tool3.merge_v5a(*combined["music"], twr)

    for name, line, body, parts_of in (("v5d", 653, "k_v5d :612", in_rows),
                                       ("v5c", 714, "k_v5c :677", in_dual)):
        kern = getattr(tool3, f"merge_{name}")
        *kin, _ = parts_of["music"]
        *rows, _ = in_rows["music"]
        # v5a's nodes, bytes and operations, at fb = 8, the JAX tool's default
        phase(f"prof_merge_{name}", "flake_tpu_torch/csrc/prof_merge3_rows.cu",
              f"util/prof_merge3.py:{line} ({body})",
              lambda kern=kern, kin=kin: kern(*kin, twr, 8),
              lambda rows=rows: tool3.merge_v5_rows_plain(*rows, twr),
              cmp_exact, (), 8 * kin[0].numel(), INT32_OPS_PER_MS,
              read_bytes=v5_read_bytes(combined["music"]))
        *kin_n, _ = parts_of["noise"]
        noise_ms, fb1_ms, v5a_ms = time_turns(
            lambda kern=kern, kin_n=kin_n: kern(*kin_n, twr, 8),
            lambda kern=kern, kin=kin: kern(*kin, twr, 1), v5a_run)
        noise_bound, _ = bound(v5_read_bytes(combined["noise"])
                               + tF * twr * 512, 0, INT32_OPS_PER_MS)
        kernels[-1].update(fb=8, noise_ms=noise_ms,
                           noise_bound_ms=noise_bound, fb1_ms=fb1_ms,
                           v5a_ms_same_batch=v5a_ms)
        print(f"info: prof_merge_{name} at fb 8 on the noise batch "
              f"{noise_ms:.4f} ms, bound {noise_bound:.4f} ms by bytes; at fb "
              f"1 on the music batch {fb1_ms:.4f} ms beside merge_v5a "
              f"{v5a_ms:.4f} ms on the same nodes in chunk layout",
              flush=True)

    def zeros_run():
        return torch.zeros((tF, twr, 128), dtype=torch.int32, device=dev)

    for name, line, parts_of in (("zero_fb", 847, in_dual),
                                 ("zero_rows", 1019, in_rows)):
        floor = getattr(tool3, f"merge_{name}")
        *kin, _ = parts_of["music"]
        phase(f"prof_merge_{name}", "flake_tpu_torch/csrc/prof_merge3_rows.cu",
              f"util/prof_merge3.py:{line} (k_{name})",
              lambda floor=floor, kin=kin: floor(*kin, twr, 8), zeros_run,
              cmp_exact, (), 0, INT32_OPS_PER_MS, library=zeros_run,
              plain_is_one_kernel=True)
        kernels[-1]["fb"] = 8

    def v5_prep_run():
        return tool3.v5_parts(*tslots)

    def v5d_prep_run():
        return tool3.v5d_parts(*tslots)

    def v5c_prep_run():
        return tool3.v5c_parts(*tslots)

    preps = (v5_prep_run, v5d_prep_run, v5c_prep_run, prep_run)
    v5_prep, v5d_prep, v5c_prep, al_prep = time_turns(*preps, loop=preps)
    print(f"info: on the tool's slots v5_parts {v5_prep:.4f} ms, v5d_parts "
          f"{v5d_prep:.4f} ms, v5c_parts {v5c_prep:.4f} ms beside "
          f"aligned_parts {al_prep:.4f} ms (all in a plain loop)",
          flush=True)

    # -- 4c. the EST recursions on the card and on the host --------------------
    # XLA:CPU fuses every multiply-add of Schur and Levinson, and the port
    # writes them as torch.addcmul; the card must round them the same way
    gen = torch.Generator().manual_seed(SEED)
    fa, fb, fc = (torch.randn(1 << 20, dtype=torch.float64, generator=gen)
                  for _ in range(3))
    on_card = torch.addcmul(fa.to(dev), fb.to(dev), fc.to(dev)).cpu()
    print(f"addcmul on 2^20 float64 triples: {int((on_card != torch.addcmul(fa, fb, fc)).sum())} "
          f"differ between card and host; {int((on_card != fa + fb * fc).sum())} "
          "differ from the unfused a + b*c", flush=True)
    ax5, awin5, a_mo5 = cap5["autocorr"][0]
    ac5 = k1_mod.autocorr(ax5, awin5, a_mo5)
    refs5 = lpc.schur_refs(ac5)
    for label, on_dev, on_host in (
            ("schur_refs", refs5, lpc.schur_refs(ac5.cpu())),
            ("levinson_from_refs", lpc.levinson_from_refs(refs5),
             lpc.levinson_from_refs(refs5.cpu())),
            ("levinson_all_orders", lpc.levinson_all_orders(ac5)[0],
             lpc.levinson_all_orders(ac5.cpu())[0])):
        on_dev = on_dev.cpu()
        differ = int(((on_dev != on_host)
                      & ~(on_dev.isnan() & on_host.isnan())).sum())
        print(f"{label} on {tuple(ac5.shape)} autocorrelations: {differ} of "
              f"{on_host.numel()} float64 values differ between card and "
              "host", flush=True)
        if differ:
            fail(f"{label} rounds differently on the card and on the host")
    est = lpc.estimate_order(refs5, a_mo5)
    print(f"EST orders of the first level-5 batch: "
          f"{ {int(k): int(v) for k, v in zip(*torch.unique(est, return_counts=True))} }",
          flush=True)

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
            k2_ms, k4_ms = time_turns(k2c, k4c)
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
    fseg = pcm[FIXED_PARITY_WINDOW[0] * SAMPLE_RATE:
               FIXED_PARITY_WINDOW[1] * SAMPLE_RATE]
    for level in LEVEL_SECONDS:
        on_card = Encoder(stream_config(level),
                          device="cuda").encode_stream(fseg)
        on_host = Encoder(stream_config(level),
                          device="cpu").encode_stream(fseg)
        print(f"parity: {FIXED_PARITY_WINDOW[0]}-{FIXED_PARITY_WINDOW[1]} s "
              f"of the fixed-block stream at level {level}, {len(on_card)} "
              f"bytes, equal {on_card == on_host}", flush=True)
        if on_card != on_host:
            fail(f"the CPU and CUDA encoders disagree at level {level}")

    # -- 6b. K1-K3 on every call of the fixed-block levels' main paths -------
    # levels 0-7: EST needs no sweep, the FIXED levels no autocorrelation
    # either; every stream here ends in a partial block
    k123 = ("autocorr", "sweep_sums", "merge_words")
    sweeps = ("sweep_sums", "sweep_granules")
    low_levels = ((5, ("autocorr", "merge_words"), sweeps),
                  (7, k123, ("sweep_granules",)),
                  (3, ("autocorr", "merge_words"), sweeps),
                  (2, ("merge_words",), ("autocorr",) + sweeps),
                  (1, ("merge_words",), ("autocorr",) + sweeps),
                  (0, ("merge_words",), ("autocorr",) + sweeps))

    def level_stream(level):
        return pcm[:LEVEL_SECONDS.get(level, SECONDS) * SAMPLE_RATE]

    # each stream is encoded once with the three wrappers recorded, and every
    # call they got (each batch and the partial last block) goes through the
    # kernel and its plain version again: the whole width and every shape of
    # the main path, which the 3 s parity windows above do not reach
    held = {"autocorr": (k1_mod.autocorr,
                         lambda cx, cw, mo: lpc.autocorr(cx, mo, cw), cmp_rel),
            "sweep_sums": (sweep_mod.sweep_sums, sweep_mod.sweep_sums_plain,
                           cmp_exact),
            "merge_words": (k3_mod.merge_words, k3_mod.merge_words_plain,
                            cmp_exact)}
    for level, needs, _ in ((8, k123, ()),) + low_levels:
        calls = capture(
            [(frame, "autocorr"), (frame, "sweep_sums"),
             (bitpack, "merge_words")],
            lambda: Encoder(stream_config(level), device="cuda")
            .encode_stream(level_stream(level)))
        if set(calls) != set(needs):
            fail(f"level {level} called {sorted(calls)}, expected "
                 f"{sorted(needs)}")
        for name, args_of_calls in calls.items():
            kern, plain, compare = held[name]
            worst = 0.0
            for args in args_of_calls:
                err, _ = check(f"{name} at level {level}",
                               lambda: kern(*args), lambda: plain(*args),
                               compare)
                worst = max(worst, rel_err.pop(f"{name} at level {level}",
                                               err))
            shapes = sorted({tuple(args[0].shape) for args in args_of_calls})
            what = (f", {args_of_calls[0][2] + 1} lags" if name == "autocorr"
                    else f", order {args_of_calls[0][3]}"
                    if name == "sweep_sums" else "")
            how = (f"max rel err {worst:.3e} (tolerance {K1_REL_TOL:g})"
                   if compare is cmp_rel else "bit-exact")
            print(f"level {level}: {name} on {len(args_of_calls)} calls, "
                  f"first-argument shapes {shapes}{what}: {how} against the "
                  "plain version", flush=True)
        del calls

    # -- 7. the main paths through Encoder.encode_stream ---------------------
    counted = {"autocorr": k1_mod.autocorr, "sweep_sums": sweep_mod.sweep_sums,
               "merge_words": k3_mod.merge_words,
               "sweep_granules": sweep_mod.sweep_granules,
               "merge_aligned": k3_mod.merge_aligned,
               **{f"prof_merge_{name}": kern
                  for name, (kern, _) in tool.VARIANTS.items()},
               "prof_merge_v2": tool2.merge_v2, "prof_merge_v3": tool2.merge_v3,
               "prof_merge_v5a": tool3.merge_v5a,
               "prof_merge_v5b": tool3.merge_v5b,
               "prof_merge_v5d": tool3.merge_v5d,
               "prof_merge_v5c": tool3.merge_v5c,
               "prof_merge_zero_fb": tool3.merge_zero_fb,
               "prof_merge_zero_rows": tool3.merge_zero_rows}
    launched = {name: {} for name in counted}   # name -> {path: count}

    def count_launches(label, run, needs, never=()):
        """Run one main path with every count set to 0 just before it and
        read just after; ``needs`` must have launched, ``never`` not."""
        for fn in counted.values():
            fn.launches = 0
        result = run()
        torch.cuda.synchronize()
        counts = {name: fn.launches for name, fn in counted.items()}
        print(f"{label}: launches { {k: v for k, v in counts.items() if v} }",
              flush=True)
        missing = [name for name in needs if counts[name] < 1]
        if missing:
            fail(f"{label}: {missing} never launched on the main path")
        unwanted = [name for name in never if counts[name]]
        if unwanted:
            fail(f"{label}: {unwanted} launched, and this path has no use "
                 "for them")
        for name, n in counts.items():
            if n:
                launched[name][label] = n
        return result

    # the emission-profiling tool: K5 and U1's main path; its counts are
    # those of its fixed timing passes (two warm-up calls and three times
    # one or two passes of 20, by how the stage is timed)
    res = count_launches(
        "profiling tool", lambda: tool.main(device="cuda"),
        k123 + ("merge_aligned",)
        + tuple(f"prof_merge_{name}" for name in tool.VARIANTS))
    if not res["static2_matches"] or (res["F"], res["nc"], res["wr"]) \
            != (tF, nc, twr):
        fail(f"the profiling tool's result is off: {res}")
    # the merge-prototype tools: U2's and U3's main paths. Their match keys
    # must hold on both batches: the widest noise chunk stays inside
    # merge_v2's 256 words and merge_v3's four rows
    analysis_k5 = ("autocorr", "sweep_sums", "merge_aligned")
    for label, run, needs in (
            ("prototype tool v2", tool2.main, ("prof_merge_v2",)),
            ("prototype tool v3", tool2.main_v3, ("prof_merge_v3",)),
            ("combined-node tool", tool3.main,
             ("prof_merge_v5a", "prof_merge_v5b")),
            ("row-layout tool v5d", tool3.main_v5d,
             ("prof_merge_v5d", "prof_merge_zero_rows")),
            ("dual-layout tool v5c", tool3.main_v5c,
             ("prof_merge_v5c", "prof_merge_zero_fb"))):
        res = count_launches(label, lambda: run(device="cuda"),
                             analysis_k5 + needs)
        wrong = [k for k, v in res.items() if "match" in k and v is not True]
        if wrong or any(k.endswith("first_bad") for k in res):
            fail(f"{label}: {wrong} not true in {res}")
        if any(v for k, v in res.items() if k.endswith("overflow_frames")):
            fail(f"{label}: frames of the tool's batches overflow the static "
                 f"rows: {res}")

    def drive(label, cfg, stream, needs, never=()):
        """One main path through the encoder, cold then warm; the counts
        are those of the cold run."""
        torch.cuda.reset_peak_memory_stats(dev)
        enc = Encoder(cfg, device="cuda")
        t0 = time.perf_counter()
        blob = count_launches(label, lambda: enc.encode_stream(stream),
                              needs, never)
        cold = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
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

    for level, needs, never in low_levels:
        cfg = stream_config(level)
        stream = level_stream(level)
        if stream.shape[0] % cfg.params.block_size == 0:
            fail(f"level {level}: the stream has no partial last block")
        dec = drive(f"level {level}", cfg, stream, needs, never)
        if dec.streaminfo.min_block_size != cfg.params.block_size:
            fail(f"level {level}: STREAMINFO min block is not the block size")

    for level in (12, 11):
        dec = drive(f"level {level}", stream_config(level), vpcm,
                    k123 + ("sweep_granules",))
        if dec.streaminfo.min_block_size != 16:
            fail(f"level {level}: STREAMINFO min block is not 16")

    # -- 8. results -----------------------------------------------------------
    for k in kernels:
        k["launches"] = sum(launched[k["name"]].values())
        k["launches_by_path"] = launched[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
