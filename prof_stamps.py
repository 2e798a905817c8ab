#!/usr/bin/env python3
"""Where S's and H's time goes inside one launch: phase stamps from
instrumented copies of ``flake_tpu_torch/csrc/select.cu`` and ``head.cu``.

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


def build(name: str, src: str, entry: str) -> ctypes.CDLL:
    """Build ``src`` into ``libflake_stamps_<name>.so``; bind ``entry`` as
    the package binds it and ``flake_set_stamps``."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"stamps_{name}.cu"
    cu.write_text(src)
    lib_path = _build.BUILD_DIR / f"libflake_stamps_{name}.so"
    _build.build([_cuda.nvcc(), *_cuda.ARCH, "-std=c++17", "-O3",
                  "-Xcompiler", "-fPIC", "-shared"], [cu], lib_path)
    lib = ctypes.CDLL(str(lib_path))
    getattr(lib, entry).argtypes = [*_cuda.SIGNATURES[entry], V]
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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("prof_stamps.py needs a CUDA device")
    select_stamps()
    head_stamps()
    print(torch.cuda.get_device_name(0), flush=True)


if __name__ == "__main__":
    main()
