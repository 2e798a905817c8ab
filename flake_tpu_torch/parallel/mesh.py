"""Frames split over several devices (port of the dp part of
``flake_tpu/parallel/mesh.py``).

Frames are self-contained (their warm-up samples lie inside them, their
numbers follow from global offsets), so a batch splits into ``dp``
contiguous groups of frames, and each group is analysed
(:func:`~flake_tpu_torch.ops.frame.analyze_frames`) and emitted
(:func:`~flake_tpu_torch.ops.bitpack.pack_frames_device`) on its own
device, each launch on that device's current stream. The only state
across groups is the largest frame for STREAMINFO (``lax.pmax`` in the
JAX package), taken here as the max over the groups on the first device.

A :class:`Mesh` has the JAX mesh's two axes: ``dp`` (frames) and ``sp``
(samples within a frame). The sp analysis (``mesh.py:57-447`` and the sp
branch of ``make_sharded_packer``) is not ported yet: a config it would
cover raises ``NotImplementedError``; on any other config the sp axis
folds into dp, as the JAX package folds it (``mesh.py:460-468``).
"""

from __future__ import annotations

import numpy as np
import torch

from flake_tpu_torch import params as P
from flake_tpu_torch.encoder import resolve_device, upload
from flake_tpu_torch.ops import bitpack
from flake_tpu_torch.ops.frame import FrameConfig, analyze_frames
from flake_tpu_torch.ops.rice import limit_max_partition_order

SP_TODO = ("the sp analysis (a frame's samples split over devices) is not "
           "ported yet: ROADMAP.md section 1, the sp slice")


class Mesh:
    """Devices in a ``(dp, sp)`` grid; a device may appear more than once
    (two groups of frames then share one card)."""

    axis_names = ("dp", "sp")

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or not devices.size:
            raise ValueError("a mesh is a non-empty (dp, sp) grid")
        self.devices = devices

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: int | None = None, sp: int = 1,
              devices=None) -> Mesh:
    """A ``(dp, sp)`` mesh over the first ``n_devices`` of ``devices`` (all
    CUDA devices when none are named; CUDA must then be present)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; name the "
                               "mesh's devices")
        devices = range(torch.cuda.device_count())
    devices = [resolve_device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if not 1 <= n_devices <= len(devices) or n_devices % sp:
        raise ValueError(f"cannot make a mesh of {n_devices} devices with "
                         f"sp {sp} from {len(devices)}")
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices[:n_devices]
    return Mesh(grid.reshape(n_devices // sp, sp))


def sp_supported(cfg: FrameConfig, sp: int) -> bool:
    """Whether the sp analysis covers this config (``mesh.py:144-161``):
    LPC subframes, shards cut on Rice-partition boundaries, each shard
    wider than the LPC halo."""
    n = cfg.block_size
    if sp <= 1 or n % sp:
        return False
    if (n < 5 or cfg.prediction_type != P.Prediction.LEVINSON
            or n <= cfg.max_prediction_order):
        return False
    b_l = n // sp
    psize = n >> limit_max_partition_order(cfg.max_partition_order, n, 1)
    return b_l % psize == 0 and b_l >= cfg.max_prediction_order


def dp_devices(cfg: FrameConfig, mesh: Mesh) -> list[torch.device]:
    """The devices of the frame groups, in frame order: the mesh's dp
    axis, with the sp axis folded in where the sp analysis does not
    cover ``cfg`` (``mesh.py:460-468``)."""
    if mesh.shape["sp"] > 1 and sp_supported(cfg, mesh.shape["sp"]):
        raise NotImplementedError(SP_TODO)
    return list(mesh.devices.flat)


def _groups(x, n: int) -> list[torch.Tensor]:
    """A host batch (numpy or CPU tensor) cut into ``n`` contiguous groups
    of frames."""
    t = torch.as_tensor(np.ascontiguousarray(x))
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} frames do not split into {n} groups")
    return list(t.chunk(n))


def _global_max(per_group: list[torch.Tensor], device) -> torch.Tensor:
    """The max over the groups' maxima, a 0-d tensor on ``device``."""
    return torch.stack([t.max().to(device) for t in per_group]).max()


def analyze_frames_sharded(samples, cfg: FrameConfig, hdr_bits,
                           mesh: Mesh) -> dict:
    """Analyse a host batch ``samples`` [F, B, C] (int16 or int32, F a
    multiple of the groups) with ``hdr_bits`` [F], each group of frames on
    its device. Returns the analysis dict with each per-frame tensor a
    list of the groups' tensors, in frame order, and
    ``global_max_frame_bytes``."""
    devices = dp_devices(cfg, mesh)
    outs = [analyze_frames(upload(s, d).to(torch.int32), cfg, upload(h, d))
            for s, h, d in zip(_groups(samples, len(devices)),
                               _groups(hdr_bits, len(devices)), devices)]
    out = {k: [o[k] for o in outs] for k in outs[0]}
    out["global_max_frame_bytes"] = _global_max(out["frame_bytes"],
                                                devices[0])
    return out


def make_sharded_analyzer(cfg: FrameConfig, mesh: Mesh):
    """``run(samples, hdr_bits)``: :func:`analyze_frames_sharded` of
    ``cfg`` over ``mesh``, built once a config (``mesh.py:501-522``)."""
    dp_devices(cfg, mesh)

    def run(samples, hdr_bits):
        return analyze_frames_sharded(samples, cfg, hdr_bits, mesh)

    return run


def make_sharded_packer(cfg: FrameConfig, mesh: Mesh):
    """Analysis and emission on each group's device (``mesh.py:525-603``,
    its dp branch). Returns ``(run, gather, groups)``:

    - ``run(samples, hdr_bits, hdr_bytes, hdr_nb)`` gives the lists, in
      frame order, of the groups' ``words``, ``total_bits`` and
      ``frame_bytes``, with ``global_max_frame_bytes`` and ``overflow``
      (the port's K3 has no static row span to overflow, so it is always
      false);
    - ``gather(words, frame_bytes, n)`` compacts the first ``n`` frames of
      the batch, each group on its device
      (:func:`~flake_tpu_torch.ops.bitpack.compact`): the groups' exact
      bytes, in frame order, so a copy to the host moves about the
      compressed size. The JAX package's 4 KiB granules exist for the
      TPU's tile-aligned copies and are not ported (``mesh.py:606-629``).
    """
    devices = dp_devices(cfg, mesh)
    groups = len(devices)

    def run(samples, hdr_bits, hdr_bytes, hdr_nb):
        words, total_bits, frame_bytes = [], [], []
        for s, hb, hby, hn, d in zip(
                _groups(samples, groups), _groups(hdr_bits, groups),
                _groups(hdr_bytes, groups), _groups(hdr_nb, groups),
                devices):
            out = analyze_frames(upload(s, d).to(torch.int32), cfg,
                                 upload(hb, d))
            w, tb = bitpack.pack_frames_device(out, upload(hby, d),
                                               upload(hn, d), cfg)
            words.append(w)
            total_bits.append(tb)
            frame_bytes.append(out["frame_bytes"])
        return {"words": words, "total_bits": total_bits,
                "frame_bytes": frame_bytes,
                "global_max_frame_bytes": _global_max(frame_bytes,
                                                      devices[0]),
                "overflow": torch.zeros((), dtype=torch.bool,
                                        device=devices[0])}

    def gather(words, frame_bytes, n: int) -> list[torch.Tensor]:
        fs = words[0].shape[0]
        return [bitpack.compact(w[:k], fb[:k])
                for g, (w, fb) in enumerate(zip(words, frame_bytes))
                if (k := min(max(n - g * fs, 0), fs))]

    return run, gather, groups


def training_step_sharded(samples, cfg: FrameConfig, hdr_bits,
                          mesh: Mesh) -> dict:
    """The whole sharded analysis step (``mesh.py:632-636``)."""
    return make_sharded_analyzer(cfg, mesh)(samples, hdr_bits)
