"""Frames and samples split over several devices (port of
``flake_tpu/parallel/mesh.py``).

A :class:`Mesh` has the JAX mesh's two axes: ``dp`` (frames) and ``sp``
(samples within a frame). Frames are self-contained (their warm-up samples
lie inside them, their numbers follow from global offsets), so a batch
splits into ``dp`` contiguous groups of frames, one a row of the mesh.

- **dp** (``sp == 1``, or a config the sp analysis does not cover, whose
  sp axis folds into dp as the JAX package folds it, ``mesh.py:460-468``):
  each group of frames is analysed
  (:func:`~flake_tpu_torch.ops.frame.analyze_frames`) and emitted
  (:func:`~flake_tpu_torch.ops.bitpack.pack_frames_device`) on its own
  device.
- **sp** (``mesh.py:57-447``): within group ``g``, rank ``r`` holds samples
  ``[r*b_l, (r+1)*b_l)`` of every frame (``b_l = B / sp``) on
  ``mesh.devices[g, r]``, and :func:`analyze_frames_sp` runs the analysis
  on the shards. Each JAX collective is an explicit copy between the
  shards' devices, always in rank order: a ``ppermute`` halo is the last
  samples of rank ``r-1`` copied to rank ``r`` (zeros at rank 0); a
  ``psum`` sums the ranks' partials in rank order on the group's first
  device, so float sums are rank-deterministic; a tiled ``all_gather`` of
  partition sums is a ``torch.cat`` in rank order; the OR and constant
  folds run over the ranks' partials. Per-frame work that JAX replicates
  over sp (Levinson, quantization, the partition-order and k scans, order
  selection) runs once a group on its first device, and each rank gets
  only what it needs. Before emission one all-to-all hands rank ``r``
  whole frames ``[r*fs, (r+1)*fs)`` of its group (``fs = F_group / sp``),
  which it packs on its own device.

The only state across groups is the largest frame for STREAMINFO
(``lax.pmax`` in the JAX package), a max over the groups on the first
device. Every launch goes to its device's current stream. A device may
appear more than once in a mesh (two groups or two ranks then share one
card).

The sp stages are the port of ``mesh.py``'s own tensor code, which the
JAX package runs outside any Pallas kernel: the halo autocorrelation, the
per-order residuals and partition sums. They call no kernel and no plain
version of K1, K2 or K4; the emission runs K3.
"""

from __future__ import annotations

import numpy as np
import torch

from flake_tpu_torch import params as P
from flake_tpu_torch.encoder import resolve_device, upload
from flake_tpu_torch.ops import bitpack
from flake_tpu_torch.ops import lpc as lpc_ops
from flake_tpu_torch.ops import predict, stereo, wasted
from flake_tpu_torch.ops.common import wrap_int32
from flake_tpu_torch.ops.frame import (LPC_DTYPES, SF_LPC, FrameConfig,
                                       analyze_frames, finalize_analysis,
                                       lpc_candidates, select_candidate)
from flake_tpu_torch.ops.rice import (_partition_sums,
                                      limit_max_partition_order, rice_scan,
                                      subframe_bits_from_sums, zigzag_u32)
from flake_tpu_torch.profiling import annotate


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


def frame_groups(cfg: FrameConfig, mesh: Mesh) -> list[tuple]:
    """The devices of each group of frames, in frame order: the mesh's
    rows, each its sp ranks in rank order, where the sp analysis covers
    ``cfg``; else one device a group, the sp axis folded into dp
    (``mesh.py:460-468``)."""
    if sp_supported(cfg, mesh.shape["sp"]):
        return [tuple(row) for row in mesh.devices]
    return [(d,) for d in mesh.devices.flat]


def _groups(x, n: int) -> list[torch.Tensor]:
    """A host batch (numpy or CPU tensor) cut into ``n`` contiguous groups
    of frames."""
    t = torch.as_tensor(np.ascontiguousarray(x))
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} frames do not split into {n} groups")
    return list(t.chunk(n))


def on_host(groups: list) -> torch.Tensor:
    """A sharded key's tensors on the host in frame order: the groups
    joined, a group's sp shards (a list) first along the sample axis."""
    return torch.cat([torch.cat([s.cpu() for s in g], dim=-1)
                      if isinstance(g, list) else g.cpu() for g in groups])


def _global_max(per_group: list[torch.Tensor], device) -> torch.Tensor:
    """The max over the groups' maxima, a 0-d tensor on ``device``."""
    return torch.stack([t.max().to(device) for t in per_group]).max()


# -- the sp collectives -------------------------------------------------------

def _left_halo(xs: list, width: int) -> list[torch.Tensor]:
    """The ``ppermute`` halo (``mesh.py:173-180``): for each rank, the last
    ``width`` samples of its left neighbour's shard on its own device,
    zeros at rank 0 (the frame has no samples before it)."""
    if width > xs[0].shape[-1]:
        raise ValueError(f"a halo of {width} samples is wider than a shard "
                         f"of {xs[0].shape[-1]}")
    return [torch.zeros_like(xs[0][..., :width])] + [
        x[..., -width:].to(right.device) for x, right in zip(xs, xs[1:])]


def _rank_fold(parts: list, fn=torch.add) -> torch.Tensor:
    """The ranks' partials folded by ``fn`` in rank order on rank 0's
    device: ``psum`` with ``torch.add`` (float sums then do not depend on
    which rank finishes first), the OR and AND folds with their ops."""
    total = parts[0]
    for part in parts[1:]:
        total = fn(total, part.to(total.device))
    return total


def _to_ranks(x: torch.Tensor, shards: list) -> list[torch.Tensor]:
    """``x`` (on rank 0's device) copied to each rank's device."""
    return [x.to(s.device) for s in shards]


def autocorr_sp(xs: list, max_order: int,
                dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """The windowed autocorrelation with the sample axis split over ranks
    (``autocorr_sp`` and ``autocorr_sp_dd``, ``mesh.py:57-141``, as one
    function): each rank multiplies its windowed samples by those of its
    own shard and of a halo of ``max_order`` samples from its left
    neighbour, in ``dtype``, as the dense path does (float64 K1, or the
    plain float32 autocorrelation); the partial lag sums are summed in rank
    order on rank 0's device, and the reference's +2.0 is added once. The
    double-float split of ``autocorr_sp_dd`` exists only for the TPU.

    xs: the ranks' shards, int32 [N, B/sp] each, in rank order. Returns
    ``dtype`` [N, max_order + 1] on rank 0's device."""
    b_l = xs[0].shape[-1]
    n = b_l * len(xs)
    ds = [x.to(dtype) * lpc_ops.welch_window_on(n, x.device, dtype)[
        r * b_l:(r + 1) * b_l] for r, x in enumerate(xs)]
    with annotate("sp halo"):
        halos = _left_halo(ds, max_order)
    parts = []
    for d, halo in zip(ds, halos):
        ext = torch.cat([halo, d], dim=-1)
        parts.append(torch.stack(
            [(d * ext[..., max_order - lag:max_order - lag + b_l]).sum(dim=-1)
             for lag in range(max_order + 1)], dim=-1))
    return _rank_fold(parts) + 2.0


def _decorr_mode_sp(lefts: list, rights: list, n: int, bps: int,
                    gidx: list) -> torch.Tensor:
    """The stereo mode (encode.c:598-643) with the sample axis split over
    ranks (``mesh.py:183-215``): a 2-sample halo for the second
    differences, which count from the frame's sample 2 on, and the ranks'
    exact int64 abs-sums summed. At 32 bits the dense path's veto of side
    modes whose 33-bit side would not fit int32 takes the max over ranks.
    Returns mode int32 [F] on rank 0's device."""
    i64 = torch.int64
    sums, over = [], []
    for left, right, hl, hr, g in zip(lefts, rights, _left_halo(lefts, 2),
                                      _left_halo(rights, 2), gidx):
        el = torch.cat([hl, left], dim=-1).to(i64)
        er = torch.cat([hr, right], dim=-1).to(i64)
        lt = el[..., 2:] - 2 * el[..., 1:-1] + el[..., :-2]
        rt = er[..., 2:] - 2 * er[..., 1:-1] + er[..., :-2]
        lt, rt = torch.where(g >= 2, lt, 0), torch.where(g >= 2, rt, 0)
        sums.append(stereo.second_diff_sums(lt, rt))
        if bps >= 32:
            over.append((left.to(i64) - right.to(i64)).abs().amax(dim=-1))
    mode = stereo.mode_from_sums(_rank_fold(sums), n)
    if bps >= 32:
        mode = torch.where(_rank_fold(over, torch.maximum) >= (1 << 31),
                           stereo.LEFT_RIGHT, mode)
    return mode


def _residual_sp(ext: torch.Tensor, x: torch.Tensor, coefs: torch.Tensor,
                 shift: torch.Tensor, order, gidx: torch.Tensor
                 ) -> torch.Tensor:
    """The exact LPC residual on one rank's shard (``mesh.py:218-246``),
    before the int32 wrap, in int64 products: ``ext`` int64 [N, halo +
    B/sp] is the shard behind its left halo, so every position sees its
    whole lag window; ``coefs`` int64 [N, taps] (zero beyond each row's
    order), ``shift`` int64 [N]. The frame's warm-up positions (``gidx <
    order``, an int or int32 [N, 1]) pass the samples through. Returns
    int64 [N, B/sp]."""
    b_l = x.shape[-1]
    halo = ext.shape[-1] - b_l
    pred = torch.zeros_like(ext[..., halo:])
    for j in range(coefs.shape[-1]):
        pred = pred + coefs[..., j, None] \
            * ext[..., halo - 1 - j:halo - 1 - j + b_l]
    return torch.where(gidx < order, ext[..., halo:],
                       ext[..., halo:] - (pred >> shift[..., None]))


def _rice_sums(res: torch.Tensor, order, gidx: torch.Tensor, parts: int,
               psize: int):
    """A shard's zigzag residual with the warm-up zeroed, and its
    partition sums int64 [N, parts]."""
    z = torch.where(gidx >= order, zigzag_u32(res), 0)
    return z, _partition_sums(z, parts, psize)


def analyze_frames_sp(shards: list, cfg: FrameConfig,
                      hdr_bits: torch.Tensor) -> dict:
    """:func:`~flake_tpu_torch.ops.frame.analyze_frames` with each frame's
    samples split over the ranks of a group (``mesh.py:263-447``): stereo,
    wasted bits, constant detection, the halo autocorrelation, Levinson (or
    Schur under EST) and quantization, the per-order residuals and
    partition sums where the order method reads bit counts, order
    selection, the final residual and the partition search with exact
    bits. Every integer stage reduces exactly across ranks, so given the
    same autocorrelation every selection is the dense path's; the
    autocorrelation sums in another grouping.

    shards: int32 [F, B/sp, C] each, on its rank's device, in rank order;
    hdr_bits int32 [F] on rank 0's device. Returns the analyze_frames
    dict: every per-frame tensor on rank 0's device, ``residual`` the list
    of the ranks' shards int32 [F, C, B/sp] on their devices."""
    n = cfg.block_size
    C = cfg.channels
    F, b_l = shards[0].shape[:2]
    N = F * C
    dev = shards[0].device
    i32, i64 = torch.int32, torch.int64
    max_o = cfg.max_prediction_order
    pmin, pmax = cfg.min_partition_order, cfg.max_partition_order
    pmax_static = limit_max_partition_order(pmax, n, 1)
    psize = n >> pmax_static
    parts = b_l // psize
    gidx = [torch.arange(r * b_l, (r + 1) * b_l, device=s.device)
            for r, s in enumerate(shards)]

    chans = [s.permute(0, 2, 1) for s in shards]            # [F, C, B/sp]
    obits = torch.full((F, C), cfg.bps, dtype=i32, device=dev)
    if C == 2 and n > 32 and cfg.stereo_method == P.StereoMethod.ESTIMATE:
        mode = _decorr_mode_sp([c[:, 0] for c in chans],
                               [c[:, 1] for c in chans], n, cfg.bps, gidx)
        decorr = [stereo.apply_decorr(c[:, 0], c[:, 1], m)
                  for c, m in zip(chans, _to_ranks(mode, chans))]
        chans = [torch.stack([ch0, ch1], dim=1) for ch0, ch1, _ in decorr]
        obits = obits + decorr[0][2]
    elif C == 2:
        mode = torch.full((F,), stereo.LEFT_RIGHT, dtype=i32, device=dev)
    else:
        mode = torch.full((F,), stereo.NOT_STEREO, dtype=i32, device=dev)

    # wasted bits: the trailing zeros of the ranks' OR are the fewest of
    # theirs; a frame is constant where every rank holds rank 0's first
    # sample
    wasted_bits = wasted.wasted_from_zeros(_rank_fold(
        [wasted.trailing_zeros(c) for c in chans], torch.minimum), cfg.bps)
    chans = [c >> w[..., None]
             for c, w in zip(chans, _to_ranks(wasted_bits, chans))]
    obits = obits - wasted_bits
    constant = _rank_fold(
        [(c == first[..., None]).all(dim=-1)
         for c, first in zip(chans, _to_ranks(chans[0][..., 0], chans))],
        torch.logical_and)

    xs = [c.reshape(N, b_l) for c in chans]
    obitsN = obits.reshape(N)
    with annotate("sp autocorrelation"):
        autoc = autocorr_sp(xs, max_o, LPC_DTYPES[cfg.lpc_dtype])
    qcoefs, shifts, refs = lpc_candidates(cfg, autoc)
    with annotate("sp halo"):
        exts = [torch.cat([h, x], dim=-1).to(i64)
                for h, x in zip(_left_halo(xs, max_o), xs)]

    bits_all = None
    if cfg.order_method not in (P.OrderMethod.MAX, P.OrderMethod.EST):
        with annotate("sp order loop"):
            q_r = _to_ranks(qcoefs.to(i64), xs)
            s_r = _to_ranks(shifts.to(i64), xs)
            sums = []
            for o in range(1, max_o + 1):
                sums.append(torch.cat([
                    _rice_sums(wrap_int32(_residual_sp(
                        e, x, q[:, o - 1, :o], s[:, o - 1], o, g)),
                        o, g, parts, psize)[1].to(dev)
                    for e, x, q, s, g in zip(exts, xs, q_r, s_r, gidx)],
                    dim=-1))
            o_arr = torch.arange(1, max_o + 1, dtype=i32, device=dev)
            bits_all = subframe_bits_from_sums(
                torch.stack(sums, dim=1), n, o_arr.expand(N, max_o),
                obitsN[..., None], pmin, pmax, cfg.precision, True)
    # S: the order and its candidate's coefficients (zero-padded to 32
    # taps) and shift
    order, coefs, shift = select_candidate(
        bits_all, refs, qcoefs, shifts, cfg.order_method,
        cfg.min_prediction_order, max_o)
    with annotate("sp final search"):
        o_r = _to_ranks(order[:, None], xs)
        res64 = [_residual_sp(e, x, c, s, o, g) for e, x, c, s, o, g in zip(
            exts, xs, _to_ranks(coefs[:, :max_o].to(i64), xs),
            _to_ranks(shift.to(i64), xs), o_r, gidx)]
        res = [wrap_int32(r) for r in res64]
        unfit = (~_rank_fold([predict.fits_int32(r) for r in res64],
                             torch.logical_and) & (shift > 0)).reshape(F, C)
        zs = [_rice_sums(r, o, g, parts, psize)
              for r, o, g in zip(res, o_r, gidx)]
        _, porder, method, params = rice_scan(
            torch.cat([s.to(dev) for _, s in zs], dim=-1), order, n, pmin,
            pmax)
        # the winning k spread onto the 2^pmax_static partitions
        kgrid = torch.gather(params, 1, torch.arange(
            1 << pmax_static, device=dev) >> (pmax_static - porder[:, None]))
        # the exact Rice bits: each rank's quotients and unary/k bits over
        # its slice of the winning k grid, summed
        quotient, ovh = [], []
        for r, ((z, _), o, g) in enumerate(zip(zs, o_r, gidx)):
            k = kgrid[:, r * parts:(r + 1) * parts].to(z.device, i64) \
                .repeat_interleave(psize, dim=-1)
            quotient.append((z >> k).sum(dim=-1))
            ovh.append(torch.where(g >= o, 1 + k, 0).sum(dim=-1))
        exact = _rank_fold(quotient) + _rank_fold(ovh) \
            + (4 + method.to(i64)) * (1 << porder.to(i64))
    rc = {"porder": porder.reshape(F, C), "method": method.reshape(F, C),
          "params": params.reshape(F, C, -1),
          "exact_rice_bits": exact.reshape(F, C)}
    sf_type = torch.full((F, C), SF_LPC, dtype=i32, device=dev)
    out = finalize_analysis(cfg, chans[0], obits, wasted_bits, constant,
                            mode, sf_type, order.reshape(F, C),
                            coefs.reshape(F, C, P.MAX_LPC_ORDER),
                            shift.reshape(F, C), res[0].reshape(F, C, b_l),
                            rc, hdr_bits, unfit)
    # CONSTANT and VERBATIM subframes store the samples, on every rank
    raw = out["sf_type"] != SF_LPC
    out["residual"] = [torch.where(k[..., None], c, r.reshape(F, C, b_l))
                       for c, r, k in zip(chans, res, _to_ranks(raw, chans))]
    return out


# -- the sharded steps --------------------------------------------------------

def _analyze_group(samples: torch.Tensor, hdr_bits: torch.Tensor,
                   devices: tuple, cfg: FrameConfig) -> dict:
    """One host group of frames [F, B, C] analysed on its devices: the
    dense analysis on one, :func:`analyze_frames_sp` over sp ranks, each
    rank uploading only its samples."""
    if len(devices) == 1:
        return analyze_frames(upload(samples, devices[0]).to(torch.int32),
                              cfg, upload(hdr_bits, devices[0]))
    shards = [upload(s.contiguous(), d).to(torch.int32) for s, d in
              zip(samples.chunk(len(devices), dim=1), devices)]
    return analyze_frames_sp(shards, cfg, upload(hdr_bits, devices[0]))


def analyze_frames_sharded(samples, cfg: FrameConfig, hdr_bits,
                           mesh: Mesh) -> dict:
    """Analyse a host batch ``samples`` [F, B, C] (int16 or int32, F a
    multiple of the groups, and under sp of the mesh's size) with
    ``hdr_bits`` [F], each group of frames on its devices. Returns the
    analysis dict with each per-frame tensor a list of the groups'
    tensors, in frame order, and ``global_max_frame_bytes``; under sp a
    group's ``residual`` is the list of its ranks' shards."""
    groups = frame_groups(cfg, mesh)
    outs = [_analyze_group(s, h, d, cfg)
            for s, h, d in zip(_groups(samples, len(groups)),
                               _groups(hdr_bits, len(groups)), groups)]
    out = {k: [o[k] for o in outs] for k in outs[0]}
    out["global_max_frame_bytes"] = _global_max(out["frame_bytes"],
                                                groups[0][0])
    return out


def make_sharded_analyzer(cfg: FrameConfig, mesh: Mesh):
    """``run(samples, hdr_bits)``: :func:`analyze_frames_sharded` of
    ``cfg`` over ``mesh``, built once a config (``mesh.py:501-522``)."""
    frame_groups(cfg, mesh)

    def run(samples, hdr_bits):
        return analyze_frames_sharded(samples, cfg, hdr_bits, mesh)

    return run


def _all_to_all(out: dict, devices: tuple) -> list[dict]:
    """The analysis of a group as its ranks emit it: under sp the one
    ``all_to_all`` of ``mesh.py:553-566``, after which rank ``r`` holds
    whole frames ``[r*fs, (r+1)*fs)`` on its device, every rank's residual
    shard of them joined along the sample axis; one device keeps the
    group."""
    if len(devices) == 1:
        return [out]
    shards = out["residual"]
    fs = shards[0].shape[0] // len(devices)
    subs = []
    with annotate("sp all-to-all"):
        for r, d in enumerate(devices):
            frames = slice(r * fs, (r + 1) * fs)
            sub = {k: v[frames].to(d) for k, v in out.items()
                   if k != "residual"}
            sub["residual"] = torch.cat([x[frames].to(d) for x in shards],
                                        dim=-1)
            subs.append(sub)
    return subs


def make_sharded_packer(cfg: FrameConfig, mesh: Mesh):
    """Analysis and emission over the mesh (``mesh.py:525-603``). Each
    group is analysed on its devices; under sp the group's frames are then
    redistributed by one all-to-all, so every device of the mesh emits
    ``1/mesh.size`` of the batch's frames. Returns ``(run, gather,
    shards)``, ``shards`` the number of devices that emit (the mesh's
    size):

    - ``run(samples, hdr_bits, hdr_bytes, hdr_nb)`` gives the lists, in
      frame order, of the emitting devices' ``words``, ``total_bits`` and
      ``frame_bytes``, with ``global_max_frame_bytes`` and ``overflow``
      (the port's K3 has no static row span to overflow, so it is always
      false);
    - ``gather(words, frame_bytes, n)`` compacts the first ``n`` frames of
      the batch, each device its own
      (:func:`~flake_tpu_torch.ops.bitpack.compact`): the exact bytes, in
      frame order, so a copy to the host moves about the compressed size.
      The JAX package's 4 KiB granules exist for the TPU's tile-aligned
      copies and are not ported (``mesh.py:606-629``).
    """
    groups = frame_groups(cfg, mesh)

    def run(samples, hdr_bits, hdr_bytes, hdr_nb):
        words, total_bits, frame_bytes, group_bytes = [], [], [], []
        for s, hb, hby, hn, devices in zip(
                _groups(samples, len(groups)), _groups(hdr_bits, len(groups)),
                _groups(hdr_bytes, len(groups)), _groups(hdr_nb, len(groups)),
                groups):
            out = _analyze_group(s, hb, devices, cfg)
            group_bytes.append(out["frame_bytes"])
            for sub, hby_r, hn_r, d in zip(
                    _all_to_all(out, devices), hby.chunk(len(devices)),
                    hn.chunk(len(devices)), devices):
                w, tb = bitpack.pack_frames_device(sub, upload(hby_r, d),
                                                   upload(hn_r, d), cfg)
                words.append(w)
                total_bits.append(tb)
                frame_bytes.append(sub["frame_bytes"])
        return {"words": words, "total_bits": total_bits,
                "frame_bytes": frame_bytes,
                "global_max_frame_bytes": _global_max(group_bytes,
                                                      groups[0][0]),
                "overflow": torch.zeros((), dtype=torch.bool,
                                        device=groups[0][0])}

    def gather(words, frame_bytes, n: int) -> list[torch.Tensor]:
        fs = words[0].shape[0]
        return [bitpack.compact(w[:k], fb[:k])
                for g, (w, fb) in enumerate(zip(words, frame_bytes))
                if (k := min(max(n - g * fs, 0), fs))]

    return run, gather, mesh.size


def training_step_sharded(samples, cfg: FrameConfig, hdr_bits,
                          mesh: Mesh) -> dict:
    """The whole sharded analysis step (``mesh.py:632-636``)."""
    return make_sharded_analyzer(cfg, mesh)(samples, hdr_bits)
