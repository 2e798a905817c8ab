#!/usr/bin/env python3
"""Where S's, H's and X's time goes inside one launch: phase stamps from
instrumented copies of ``flake_tpu_torch/csrc/select.cu``, ``head.cu``,
``rice.cu`` and X's first design, ``csrc/yardsticks/fixed_v1.cu``.

Each source is copied with a stamp written at the end of each phase and
built with nvcc into a library of its own beside the package's build
(``build/flake_tpu_torch/``):

- S (``frame.select_candidate``), ``clock64`` cycles a warp: the bits and
  shifts in hand, the order picked, the chosen row in hand, the stores; on
  the level-8 LOG batch (1,024 streams of 12 orders) and the level-12 8192
  SEARCH bucket (428 streams of 32).
- H (``frame.frame_head``), ``%globaltimer`` ns a block: the staging
  issued, the statistics held, the mode and shifts chosen, the stores, and
  the SM the block ran on; on the level-8 batch (512 frames of 4,096 stereo
  16-bit samples, the stereo estimate on) and the 8192 bucket (214 frames
  of 8,192).
- X (``rice.fixed_search``), ``clock64`` cycles: its first design
  (``csrc/yardsticks/fixed_v1.cu``, a block a stream, thread 0's clock)
  with the first sample in hand and, each order apart, the partition sums,
  the pyramid's fold, the level scan, the pick and the order compare with
  the barrier after it; the current design (``csrc/rice.cu``, a warp a
  stream, lane 0's clock) with the set-up, the lane's run summed for
  every order (the warm-up taken out), the pyramid, the fold above 32
  partitions, the scan, the pick, the order compare and the stores; on the
  level-2 batch (1,024 streams of 1,152 16-bit samples, orders 0-4, pmax
  3) and a level-8 10-sample tail (2 streams, orders 1-4, pmax 6).

The inputs are made from a seed, and the instrumented kernel's outputs must
equal the package's. Five launches warm it, three stamped launches follow;
one line a shape and stamped launch.

    python3 prof_stamps.py

Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from flake_tpu_torch import _build, _cuda  # noqa: E402
from flake_tpu_torch import params as P  # noqa: E402
from flake_tpu_torch.ops import frame  # noqa: E402

CSRC = ROOT / "flake_tpu_torch" / "csrc"
SEED = 20
V = ctypes.c_void_p

SETTER = """__device__ unsigned long long* g_stamps;
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int flake_set_stamps(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &p, sizeof(p)));
}
"""


def at(text: str, anchor: str, before: str = "", after: str = "") -> str:
    """``text`` with ``before`` and ``after`` around its one ``anchor``."""
    if text.count(anchor) != 1:
        raise RuntimeError(f"anchor not found once: {anchor!r}")
    return text.replace(anchor, before + anchor + after)


def build(name: str, src: str, entry: str,
          signature: str | None = None) -> ctypes.CDLL:
    """Build ``src`` into ``libflake_stamps_<name>.so``; bind ``entry`` as
    the package binds ``signature`` (default: ``entry``) and
    ``flake_set_stamps``."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"stamps_{name}.cu"
    cu.write_text(src)
    lib_path = _build.BUILD_DIR / f"libflake_stamps_{name}.so"
    _build.build([_cuda.nvcc(), *_cuda.ARCH, "-std=c++17", "-O3",
                  "-Xcompiler", "-fPIC", "-shared"], [cu], lib_path)
    lib = ctypes.CDLL(str(lib_path))
    getattr(lib, entry).argtypes = [*_cuda.SIGNATURES[signature or entry],
                                    V]
    getattr(lib, entry).restype = ctypes.c_int
    lib.flake_set_stamps.argtypes = [V]
    lib.flake_set_stamps.restype = ctypes.c_int
    return lib


def stamped(lib, call, stamps: torch.Tensor):
    """Five launches with the stamps off, then three with them on; yields
    the stamps of each of the three as float64 numpy."""
    assert lib.flake_set_stamps(V(0)) == 0
    for _ in range(5):
        assert call() == 0
    assert lib.flake_set_stamps(V(stamps.data_ptr())) == 0
    try:
        for _ in range(3):
            assert call() == 0
            torch.cuda.synchronize()
            yield stamps.cpu().numpy().astype(np.float64)
    finally:
        assert lib.flake_set_stamps(V(0)) == 0


def select_stamps() -> None:
    """S's phases a warp, in cycles: median and 90th percentile."""
    stamp = ("if (lane == 0 && g_stamps) "
             "g_stamps[s * 5 + {}] = clock64();\n")
    src = (CSRC / "select.cu").read_text()
    src = at(src, "namespace {\n", before=SETTER)
    src = at(src, "  if (s >= N) return;", after="\n  " + stamp.format(0))
    src = at(src, "  int best;  ", before='  asm volatile("" ::"l"(v), '
             '"r"(sh));\n  ' + stamp.format(1))
    src = at(src, "  if (lane == 0) order[s] = best + 1;",
             before="  " + stamp.format(2))
    row = "lane < max_o ? qcoefs[(s * max_o + best) * max_o + lane] : 0;\n"
    src = at(src, "  coefs[s * kMaxOrder + lane] =\n      " + row,
             before=f"  const int tap = {row}"
             '  asm volatile("" ::"r"(tap));\n  ' + stamp.format(3))
    src = src.replace("  coefs[s * kMaxOrder + lane] =\n      " + row,
                      "  coefs[s * kMaxOrder + lane] = tap;\n")
    src = at(src, "  if (lane == 0) shift[s] = sh;\n",
             after="  " + stamp.format(4))
    lib = build("select", src, "flake_select_candidate")
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    for label, N, m, method in (("level-8 batch, LOG", 1024, 12,
                                 P.OrderMethod.LOG),
                                ("8192 bucket, SEARCH", 428, 32,
                                 P.OrderMethod.SEARCH)):
        bits = torch.from_numpy(rng.integers(1000, 1100, (N, m))).to(dev)
        qc = torch.from_numpy(rng.integers(-2**31, 2**31, (N, m, m),
                                           dtype=np.int64)
                              .astype(np.int32)).to(dev)
        sh = torch.from_numpy(rng.integers(0, 16, (N, m))
                              .astype(np.int32)).to(dev)
        outs = (torch.empty(N, dtype=torch.int32, device=dev),
                torch.empty((N, 32), dtype=torch.int32, device=dev),
                torch.empty(N, dtype=torch.int32, device=dev))
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            return lib.flake_select_candidate(
                V(bits.data_ptr()), V(0), V(qc.data_ptr()), V(sh.data_ptr()),
                *(V(t.data_ptr()) for t in outs), N, m, int(method), 1, m, 1,
                V(stream))

        stamps = torch.zeros((N, 5), dtype=torch.int64, device=dev)
        for rep, s in enumerate(stamped(lib, call, stamps)):
            d = np.diff(s, axis=1)
            med, p90 = np.median(d, axis=0), np.percentile(d, 90, axis=0)
            phases = ", ".join(
                f"{k} {a:.0f}/{b:.0f}" for k, a, b in zip(
                    ("bits in hand", "pick", "chosen row in hand", "stores"),
                    med, p90))
            print(f"S {label}, launch {rep + 1} (cycles a warp, median/90%):"
                  f" {phases}; entry to end "
                  f"{np.median(s[:, 4] - s[:, 0]):.0f}", flush=True)
        want = frame.select_candidate(bits, None, qc, sh, int(method), 1, m)
        assert all(torch.equal(a, b) for a, b in zip(outs, want)), label


def head_stamps() -> None:
    """H's phases a block, in µs from the first block's entry."""
    stamp = ("if (threadIdx.x == 0 && g_stamps) "
             "g_stamps[blockIdx.x * 6 + {}] = now_ns();\n")
    src = (CSRC / "head.cu").read_text()
    src = at(src, "namespace {\n", before=SETTER)
    src = at(src, "  const int tid = threadIdx.x, lane = tid & 31;\n",
             after="  " + stamp.format(0) + "  if (threadIdx.x == 0 && "
             "g_stamps) {\n    unsigned sm;\n    asm(\"mov.u32 %0, "
             "%%smid;\" : \"=r\"(sm));\n    g_stamps[blockIdx.x * 6 + 5] = "
             "sm;\n  }\n")
    src = at(src, "    x = reinterpret_cast<const int*>(staged);\n",
             after="    " + stamp.format(1))
    src = at(src, "  // warp 0 picks the mode (a lane",
             before="  " + stamp.format(2))
    src = at(src, "  int src[kC], w[kC];\n", before="  " + stamp.format(3))
    src = at(src, "        out[static_cast<long long>(c) * n + i] = "
             "v >> w[c];\n      }\n    }\n  }\n",
             after="  __syncthreads();\n  " + stamp.format(4))
    lib = build("head", src, "flake_frame_head")
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    for label, F, n in (("level-8 batch", 512, 4096),
                        ("8192 bucket", 214, 8192)):
        t = np.arange(n)
        tone = 9000 * np.sin(2 * np.pi * rng.uniform(50, 4000, (F, 1, 1))
                             * t[:, None] / 44100 + [0, 0.3])
        x = np.clip(np.rint(tone + rng.normal(0, 300, (F, n, 2))),
                    -32768, 32767).astype(np.int32)
        x = torch.from_numpy(x).to(dev)
        outs = (torch.empty((F, 2, n), dtype=torch.int32, device=dev),
                torch.empty((F, 2), dtype=torch.int32, device=dev),
                torch.empty((F, 2), dtype=torch.int32, device=dev),
                torch.empty(F, dtype=torch.int32, device=dev),
                torch.empty((F, 2), dtype=torch.bool, device=dev))
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            return lib.flake_frame_head(
                *(V(a.data_ptr()) for a in (x, *outs)), F, n, 2, 16, 1,
                V(stream))

        stamps = torch.zeros((F, 6), dtype=torch.int64, device=dev)
        for rep, s in enumerate(stamped(lib, call, stamps)):
            e, i, d, c, w = (s[:, k] - s[:, 0].min() for k in range(5))
            per_sm = np.bincount(s[:, 5].astype(int))
            print(f"H {label}, launch {rep + 1} (µs): span "
                  f"{w.max() / 1e3:.2f}; entries within {e.max() / 1e3:.2f};"
                  f" a block's median: staging issued "
                  f"{np.median(i - e) / 1e3:.2f}, statistics "
                  f"{np.median(d - i) / 1e3:.2f} (max "
                  f"{np.max(d - i) / 1e3:.2f}), choice "
                  f"{np.median(c - d) / 1e3:.2f}, stores "
                  f"{np.median(w - c) / 1e3:.2f} (max "
                  f"{np.max(w - c) / 1e3:.2f}); SMs by blocks held "
                  f"{dict(enumerate(np.bincount(per_sm).tolist()))}",
                  flush=True)
        p = P.set_defaults(8)
        p.stereo_method = P.StereoMethod.ESTIMATE
        cfg = frame.FrameConfig.from_params(p, 2, 16, block_size=n)
        want = frame.frame_head(x, cfg)
        assert all(torch.equal(a, b) for a, b in zip(outs, want)), label


def fixed_inputs(rng, N: int, n: int) -> torch.Tensor:
    """[N, n] int32: tones with noise at 16 bits, as the level-2 batch."""
    t = np.arange(n)
    x = 9000 * np.sin(2 * np.pi * rng.uniform(50, 4000, (N, 1)) * t / 44100) \
        + rng.normal(0, 300, (N, n))
    return torch.from_numpy(np.clip(np.rint(x), -32768, 32767)
                            .astype(np.int32)).to("cuda")


# X's shapes: label, streams, samples, min_o, max_o, pmin, pmax
FIXED_SHAPES = (("level-2 batch", 1024, 1152, 0, 4, 0, 3),
                ("level-8 10-sample tail", 2, 10, 1, 4, 0, 6))


def fixed_stamps() -> None:
    """X's phases: the first design's a block (thread 0), each order apart,
    and the current design's a warp (lane 0), in cycles."""
    from flake_tpu_torch.ops import rice

    v1 = ("if (tid == 0 && g_stamps) "
          "g_stamps[s * 27 + ({})] = clock64();\n")
    src = (CSRC / "yardsticks" / "fixed_v1.cu").read_text()
    src = at(src, "namespace {\n", before=SETTER)
    src = at(src, "namespace {\n", after="__shared__ unsigned long long "
             "g_sums_at;\n")
    src = at(src, "  const int tid = threadIdx.x;\n  const long long s = "
             "blockIdx.x;\n  const int* x = smp + s * n;\n",
             after="  " + v1.format(0) + "  if (tid == 0 && g_stamps) {\n"
             "    const int v0 = x[0];\n    asm volatile(\"\" ::\"r\"(v0));"
             "\n    g_stamps[s * 27 + 1] = clock64();\n  }\n")
    src = at(src, "  for (int p = ps - 1; p >= 0; --p) {\n    for (int i = "
             "(1 << p) + tid; i < (2 << p); i += kThreads)\n",
             before="  if (tid == 0) g_sums_at = clock64();\n")
    k = "2 + 5 * (o - min_o)"
    src = at(src, "    partition_sums<kThreads>(pyr, quot_s, shares, zig, n, "
             "ps, tid);\n",
             after=f"    if (tid == 0 && g_stamps) g_stamps[s * 27 + {k}] = "
             "g_sums_at;\n    " + v1.format(k + " + 1"))
    src = at(src, "    scan_slots(pyr, ks, &lv, ps, n, o, lo, hi, tid, "
             "kThreads);\n    __syncthreads();\n",
             after="    " + v1.format(k + " + 2"))
    src = at(src, "      const Choice c = pick_level(&lv, lo, hi);\n",
             after='      asm volatile("" ::"r"(c.bits));\n      '
             + v1.format(k + " + 3"))
    src = at(src, "    __syncthreads();                // lv and the pyramid "
             "are rewritten\n", after="    " + v1.format(k + " + 4"))
    lib_v1 = build("fixed_v1", src, "flake_fixed_search_v1",
                   "flake_fixed_search")

    now = ("if ((threadIdx.x & 31) == 0 && g_stamps) g_stamps[(blockIdx.x *"
           " (blockDim.x >> 5) + (threadIdx.x >> 5)) * 9 + ({})] = "
           "clock64();\n")
    src = (CSRC / "rice.cu").read_text()
    src = at(src, "namespace {\n", before=SETTER)
    src = at(src, "  if (s >= N) return;                       // a whole "
             "warp\n", after="  " + now.format(0))
    src = at(src, "    // the lane's run: up to 32 partitions",
             before="    " + now.format(1))
    src = at(src, "      if (parts > 32) {\n#pragma unroll",
             before="      " + now.format(2))
    for k, anchor in enumerate((
            "    if (parts > 32) {\n      // the levels above",
            "    // the (order, slot) pairs",
            "    // lane j picks order",
            "    // the first order of the least estimate"), 3):
        src = at(src, anchor, before="    " + now.format(k))
    src = at(src, "  if (lane == 0) order_out[s] = best_o;\n",
             before="  " + now.format(7))
    src = at(src, "  if (lane < taps) coefs_out[s * taps + lane] = "
             "kFixedCoefs[best_o][lane];\n", after="  " + now.format(8))
    lib = build("fixed", src, "flake_fixed_search")

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    for label, N, n, min_o, max_o, pmin, pmax in FIXED_SHAPES:
        x = fixed_inputs(rng, N, n)
        obits = torch.full((N,), 16, dtype=torch.int32, device=dev)
        want = rice.fixed_search(x, obits, min_o, max_o, pmin, pmax)
        args = rice._search_args(n, pmin, pmax)[1:]
        orders = max_o - min_o + 1
        stream = torch.cuda.current_stream().cuda_stream
        for name, lib_x, entry, width in (
                ("first design", lib_v1, "flake_fixed_search_v1", 27),
                ("this design", lib, "flake_fixed_search", 9)):
            outs = (torch.empty(N, dtype=torch.int32, device=dev),
                    torch.empty((N, max_o), dtype=torch.int32, device=dev))

            def call(lib_x=lib_x, entry=entry, outs=outs):
                return getattr(lib_x, entry)(
                    V(x.data_ptr()), V(obits.data_ptr()),
                    *(V(t.data_ptr()) for t in outs), N, n, min_o, max_o,
                    max_o, *args, V(stream))

            stamps = torch.zeros((N, width), dtype=torch.int64, device=dev)
            for rep, st in enumerate(stamped(lib_x, call, stamps)):
                med = lambda a: float(np.median(a))  # noqa: E731
                if width == 27:
                    per = st[:, 2:2 + 5 * orders].reshape(N, orders, 5)
                    prev = np.concatenate(
                        [st[:, 1:2], per[:, :-1, 4]], axis=1)
                    d = np.diff(np.concatenate([prev[..., None], per],
                                               axis=2), axis=2)
                    phases = "; ".join(
                        f"order {min_o + o}: " + ", ".join(
                            f"{k} {med(d[:, o, j]):.0f}"
                            for j, k in enumerate(
                                ("sums", "fold", "scan", "pick",
                                 "compare and barrier")))
                        for o in range(orders))
                    total = per[:, -1, 4] - st[:, 0]
                    print(f"X {name}, {label}, launch {rep + 1} (cycles a "
                          f"block, median): first sample in hand "
                          f"{med(st[:, 1] - st[:, 0]):.0f}; {phases}; entry "
                          f"to end {med(total):.0f} (90% "
                          f"{np.percentile(total, 90):.0f})", flush=True)
                else:
                    d = np.diff(st, axis=1)
                    print(f"X {name}, {label}, launch {rep + 1} (cycles a "
                          f"warp, median): " + ", ".join(
                              f"{k} {med(d[:, j]):.0f}" for j, k in enumerate((
                                  "set up", "run summed", "pyramid",
                                  "fold above 32 partitions", "scan", "pick",
                                  "compare", "stores")))
                          + f"; entry to end {med(st[:, 8] - st[:, 0]):.0f} "
                          f"(90% {np.percentile(st[:, 8] - st[:, 0], 90):.0f})",
                          flush=True)
            assert all(torch.equal(a, b) for a, b in zip(outs, want)), \
                (name, label)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("prof_stamps.py needs a CUDA device")
    fixed_stamps()
    select_stamps()
    head_stamps()
    print(torch.cuda.get_device_name(0), flush=True)


if __name__ == "__main__":
    main()
