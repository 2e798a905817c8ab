"""Entry points of the device pipeline (port of ``__graft_entry__.py``).

- :func:`entry`: the level-8 forward step, batched frame analysis and the
  device emission (K1, K4, K3) on 16 frames of 4096 stereo samples, as a
  function and its example tensors;
- :func:`dryrun_multichip`: one sharded analysis step and one sharded
  emission over ``n_devices`` (frames over dp, each frame's samples over
  sp = 2 where the count allows), held against one device.

    python -m flake_tpu_torch.graft_entry [--devices 4] [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from flake_tpu_torch import params as P
from flake_tpu_torch.encoder import resolve_device
from flake_tpu_torch.ops import bitpack
from flake_tpu_torch.ops.frame import FrameConfig, analyze_frames


def entry(device="cuda"):
    """``(fn, example_args)``: the level-8 analysis and the device emission
    of a [16, 4096, 2] batch (``__graft_entry__.py:6-40``, its seed-0
    samples), the example tensors on ``device``. ``fn`` returns the frames'
    ``words`` (their final bytes but for the CRCs), ``total_bits`` and
    ``frame_bytes``."""
    dev = resolve_device(device)
    block = 4096
    cfg = FrameConfig.from_params(P.set_defaults(8), channels=2, bps=16,
                                  block_size=block)
    rng = np.random.default_rng(0)
    F = 16
    samples = rng.integers(-20000, 20000, size=(F, block, 2), dtype=np.int32)
    hb, hn = bitpack.frame_header_bytes(
        np.arange(F, dtype=np.uint32), bs_code=P.blocksize_code(block),
        sr_code=P.samplerate_code(44100), allow_vbs=0)
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in (samples, hn.astype(np.int32) * 8, hb, hn))
    return pipeline_step(cfg), args


def pipeline_step(cfg: FrameConfig):
    """The device pipeline of one batch under ``cfg``: ``fn(samples,
    hdr_bits, hdr_bytes, hdr_nb)`` runs the analysis and the device
    emission and returns the frames' ``words``, ``total_bits`` and
    ``frame_bytes``."""
    def fn(samples, hdr_bits, hdr_bytes, hdr_nb):
        analysis = analyze_frames(samples, cfg, hdr_bits)
        words, total_bits = bitpack.pack_frames_device(analysis, hdr_bytes,
                                                       hdr_nb, cfg)
        return {"words": words, "total_bits": total_bits,
                "frame_bytes": analysis["frame_bytes"]}

    return fn


def _check(ok: bool, what: str) -> None:
    """Raise where ``assert`` would (and survive ``python -O``)."""
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One sharded analysis step and one sharded emission on a mesh of
    ``n_devices`` (``__graft_entry__.py:43-129``): distinct cards where
    there are ``n_devices`` of them, else the card repeated; ``device=
    "cpu"`` repeats the CPU. sp = 2 when ``n_devices`` is even and at least
    4. Checks what the JAX dry run checks, raising ``AssertionError`` on a
    miss: the largest frame, the residual really split to B/sp a rank, the
    sp selection equal to one device's, and the sharded emission's words
    and bit counts equal to the single-device packer's. Prints one line."""
    from flake_tpu_torch.parallel.mesh import (make_mesh, make_sharded_packer,
                                               on_host, training_step_sharded)

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    else:
        devices = [dev] * n_devices
    sp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(devices=devices, sp=sp)
    dp = n_devices // sp

    block = 256
    cfg = FrameConfig.from_params(P.set_defaults(8), channels=2, bps=16,
                                  block_size=block)
    F = dp * 2
    rng = np.random.default_rng(1)
    samples = rng.integers(-3000, 3000, size=(F, block, 2), dtype=np.int32)
    hdr_bits = np.full((F,), 48, np.int32)

    out = training_step_sharded(samples, cfg, hdr_bits, mesh)
    fb = on_host(out["frame_bytes"])
    gmax = int(out["global_max_frame_bytes"])
    _check(tuple(fb.shape) == (F,) and gmax == int(fb.max()),
           f"frame bytes {fb.tolist()}, largest {gmax}")
    _check(tuple(on_host(out["residual"]).shape) == (F, 2, block),
           "the residual's shape")
    if sp > 1:
        # each rank holds 1/sp of every frame's residual, and the sp
        # selection is the dense path's
        shapes = {tuple(s.shape) for g in out["residual"] for s in g}
        _check(shapes == {(F // dp, 2, block // sp)},
               f"residual shards {shapes}")
        dense = analyze_frames(torch.from_numpy(samples).to(devices[0]), cfg,
                               torch.from_numpy(hdr_bits).to(devices[0]))
        for key in ("order", "frame_bytes", "residual", "rice_params"):
            _check(torch.equal(on_host(out[key]), dense[key].cpu()),
                   f"{key} differs from one device's")

    # the sharded emission: the single-device packer's words
    hb, hn = bitpack.frame_header_bytes(
        np.arange(F, dtype=np.int64), bs_code=P.blocksize_code(block),
        sr_code=P.samplerate_code(44100), allow_vbs=0)
    hdr_bits2 = hn.astype(np.int32) * 8
    run, _, shards = make_sharded_packer(cfg, mesh)
    packed = run(samples, hdr_bits2, hb, hn)
    on = devices[0]
    dense2 = analyze_frames(torch.from_numpy(samples).to(on), cfg,
                            torch.from_numpy(hdr_bits2).to(on))
    w1, tb1 = bitpack.pack_frames_device(dense2, torch.from_numpy(hb).to(on),
                                         torch.from_numpy(hn).to(on), cfg)
    _check(torch.equal(on_host(packed["total_bits"]), tb1.cpu()),
           "sharded emission bit counts")
    _check(torch.equal(on_host(packed["words"]), w1.cpu()),
           "sharded device emission != single-device words")
    _check(shards == n_devices, f"{shards} emitting shards")
    print(f"dryrun_multichip ok: mesh dp={dp} sp={sp} on "
          f"{sorted({str(d) for d in devices})}, {F} frames, "
          f"max_frame_bytes={gmax}, sp_shards_samples={sp > 1}, "
          f"device_emission_sharded=bitwise-equal over {shards} shards",
          flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.devices, device=args.device)


if __name__ == "__main__":
    main()
