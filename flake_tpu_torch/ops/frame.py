"""Batched per-frame analysis (port of ``flake_tpu/ops/frame.py``).

Everything the reference does per frame, channel and candidate order
runs as dense tensor ops over a [F, C, B] batch: stereo-mode estimation,
wasted-bit removal, LPC analysis, order selection (optimize.c:196-261)
and the Rice partition search. The LPC path runs K1 for the windowed
autocorrelation (under ``lpc_dtype="float32"`` a plain float32 one, as
the JAX package computes that dtype) and one of two kernels for the candidate-order sweep,
chosen by the shape alone (``ops/sweep.uses_granule_kernel``): K4
(granule sums) wherever its power-of-two granules fit the partitions,
where it was the faster on an H100, and K2 (partition sums) for the
rest. The JAX package chooses by its TPU kernels' limits instead
(``flake_tpu/ops/frame.py:413-437``); all give the same sums. The output
dict has the JAX package's keys, so the tests compare key by key.

Every order method is ported. EST (levels 3-6) takes its reflection
coefficients from the Schur recursion and seeds Levinson with them, and
runs no sweep; the 2/4/8-LEVEL methods (level 7) run the sweep and read
only their candidates' columns of the per-order bit counts.

Two more Hopper kernels take the analysis's eager launch chains, each with
its plain version beside it, which a CPU tensor takes: H,
:func:`frame_head` (``csrc/head.cu``), everything before the prediction
(the stereo mode and decorrelation, the wasted bits, the constant flags)
in one launch, and S, :func:`select_candidate` (``csrc/select.cu``), the
order selection under every order method and the gather of the chosen
order's coefficients and shift in one launch (:func:`select_order_bits`
is the same kernel without the gather). The FIXED order search is X
(``ops/rice.fixed_search``). The last step, :func:`finalize_analysis`
(the CONSTANT, unfit and over-size overrides, the frame sizes and type
codes), is Z (``csrc/finalize.cu``), one launch that copies the samples
only into the subframes it stores raw.
"""

from __future__ import annotations

import dataclasses

import torch

from flake_tpu_torch import _cuda
from flake_tpu_torch import params as P
from flake_tpu_torch.ops import lpc as lpc_ops
from flake_tpu_torch.ops import stereo, wasted
from flake_tpu_torch.ops.autocorr import autocorr
from flake_tpu_torch.ops.common import U32_MASK
from flake_tpu_torch.ops.rice import (final_pass, fixed_search,
                                      limit_max_partition_order,
                                      subframe_bits_from_sums)
from flake_tpu_torch.ops.sweep import (sweep_granules, sweep_sums,
                                       uses_granule_kernel)
from flake_tpu_torch.profiling import annotate

SF_CONSTANT = 0
SF_VERBATIM = 1
SF_FIXED = 8
SF_LPC = 32
LPC_DTYPES = {"float64": torch.float64, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class FrameConfig:
    """Static encoding configuration of one batch: block size, channels,
    bit depth and the search parameters that shape the computation."""

    block_size: int
    channels: int
    bps: int
    prediction_type: int
    order_method: int
    stereo_method: int
    min_prediction_order: int
    max_prediction_order: int
    min_partition_order: int
    max_partition_order: int
    precision: int = P.LPC_PRECISION
    # "float64" runs K1 and the recursions in the reference's doubles;
    # "float32" computes the autocorrelation in plain float32 tensor ops,
    # as the JAX package does outside its kernel, and the recursions in
    # float32 (``flake_tpu/ops/frame.py:277,371``)
    lpc_dtype: str = "float64"

    @classmethod
    def from_params(cls, p: P.EncodeParams, channels: int, bps: int,
                    block_size: int | None = None,
                    lpc_dtype: str = "float64") -> "FrameConfig":
        return cls(
            block_size=block_size or p.block_size,
            channels=channels, bps=bps,
            prediction_type=int(p.prediction_type),
            order_method=int(p.order_method),
            stereo_method=int(p.stereo_method),
            min_prediction_order=int(p.min_prediction_order),
            max_prediction_order=int(p.max_prediction_order),
            min_partition_order=int(p.min_partition_order),
            max_partition_order=int(p.max_partition_order),
            lpc_dtype=lpc_dtype,
        )


def _select_order_log(bits_all: torch.Tensor, min_order: int,
                      max_order: int) -> torch.Tensor:
    """The LOG step-halving search (optimize.c:239-261) on the full
    per-order bits tensor: the same candidates and strict-< updates, so
    the same order. bits_all int64 [..., max_order]; returns the order
    (1-based) int32 [...]."""
    batch = bits_all.shape[:-1]
    dev = bits_all.device
    opt = torch.full(batch, min_order - 1 + (max_order - min_order) // 3,
                     dtype=torch.int64, device=dev)
    visited = torch.zeros(batch + (max_order,), dtype=torch.bool,
                          device=dev)

    def at(t, i):
        idx = i.clamp(0, max_order - 1)[..., None]
        return torch.gather(t, -1, idx)[..., 0]

    for step in (16, 8, 4, 2, 1):
        last = opt
        for d in (-step, 0, step):
            i = last + d
            in_range = (i >= min_order - 1) & (i < max_order)
            fresh = in_range & ~at(visited, i)
            # bits of the current opt: UINT32_MAX until it is visited
            opt_bits = torch.where(at(visited, opt), at(bits_all, opt),
                                   U32_MASK)
            better = fresh & (at(bits_all, i) < opt_bits)
            visited = visited.scatter(
                -1, i.clamp(0, max_order - 1)[..., None],
                (fresh | at(visited, i))[..., None])
            opt = torch.where(better, i, opt)
    return (opt + 1).to(torch.int32)


def _select_order_level(bits_all: torch.Tensor,
                        cand: list[int]) -> torch.Tensor:
    """2/4/8-LEVEL selection (optimize.c:202-223): scan the candidates
    (0-based orders, highest first; they may repeat) with strict <, so a
    tie keeps the earlier, higher candidate. Returns the order (1-based)
    int32 [...]."""
    best_bits = bits_all[..., cand[0]]
    best_order = torch.full_like(best_bits, cand[0], dtype=torch.int32)
    for o in cand[1:]:
        take = bits_all[..., o] < best_bits
        best_bits = torch.where(take, bits_all[..., o], best_bits)
        best_order = torch.where(take, o, best_order)
    return best_order + 1


def select_order_bits_plain(bits_all: torch.Tensor, method: int,
                            min_o: int, max_o: int) -> torch.Tensor:
    """S's plain version: the order the LEVEL2/4/8, SEARCH or LOG method
    picks from the per-order bits ``bits_all`` int64 [..., >= max_o]
    (optimize.c:202-261). Returns the order (1-based) int32 [...]."""
    if method in (P.OrderMethod.LEVEL2, P.OrderMethod.LEVEL4,
                  P.OrderMethod.LEVEL8):
        levels = 1 << (method - 1)
        cand = [max(min_o + ((max_o - min_o + 1) * (i + 1)) // levels - 2, 0)
                for i in range(levels - 1, -1, -1)]
        return _select_order_level(bits_all, cand)
    if method == P.OrderMethod.SEARCH:
        # torch.argmin, like jnp.argmin, takes the first (lowest) order
        # among equal minima on every device
        idx = torch.argmin(bits_all[..., :max_o], dim=-1)
        return (idx + 1).to(torch.int32)
    if method == P.OrderMethod.LOG:
        return _select_order_log(bits_all, min_o, max_o)
    raise ValueError(f"bad order method {method}")


def select_order_bits(bits_all: torch.Tensor, method: int, min_o: int,
                      max_o: int) -> torch.Tensor:
    """:func:`select_order_bits_plain`'s function. A CPU tensor takes the
    plain version; a CUDA tensor launches S (``csrc/select.cu``) with its
    gather switched off, one warp a stream, whose orders equal the plain
    version's."""
    if bits_all.device.type == "cpu":
        return select_order_bits_plain(bits_all, method, min_o, max_o)
    if bits_all.device.type != "cuda":
        raise ValueError(f"select_order_bits: no kernel for "
                         f"{bits_all.device}")
    m = bits_all.shape[-1]
    if not 1 <= min_o <= max_o <= m <= P.MAX_LPC_ORDER:
        raise ValueError(f"select_order_bits: orders {min_o}-{max_o} of "
                         f"{m} columns; the kernel takes 1 <= min <= max <= "
                         f"columns <= {P.MAX_LPC_ORDER}")
    batch = bits_all.shape[:-1]
    N = batch.numel()
    dev = bits_all.device
    bits_all = bits_all.reshape(N, m).contiguous()
    _cuda.check(bits_all, "bits_all", torch.int64, (N, m), dev)
    order = torch.empty(N, dtype=torch.int32, device=dev)
    if N:
        _cuda.launch("flake_select_order", dev, bits_all, order, N, m,
                     int(method), min_o, max_o)
        select_order_bits.launches += 1
    return order.reshape(batch)


select_order_bits.launches = 0


def _order_of(method: int, min_o: int, max_o: int, bits_all, refs, batch,
              device: torch.device, by_bits) -> torch.Tensor:
    """Order-method dispatch (optimize.c:196-261). bits_all int64
    [..., >= max_order] (None for MAX and EST); refs [..., max_order], the
    reflection coefficients (read by EST only). Returns the order
    (1-based) int32 [batch]: MAX's constant, EST's rule, or ``by_bits``
    (:func:`select_order_bits` or its plain version) for the methods that
    read bits."""
    if method == P.OrderMethod.MAX:
        return torch.full(batch, max_o, dtype=torch.int32, device=device)
    if method == P.OrderMethod.EST:
        return lpc_ops.estimate_order(refs, max_o)
    return by_bits(bits_all, method, min_o, max_o)


def select_order(cfg: FrameConfig, bits_all, refs, batch,
                 device: torch.device) -> torch.Tensor:
    """The order alone: :func:`select_candidate_plain`'s dispatch, with
    the bit methods through S's order-only form
    (:func:`select_order_bits`)."""
    return _order_of(cfg.order_method, cfg.min_prediction_order,
                     cfg.max_prediction_order, bits_all, refs, batch,
                     device, select_order_bits)


def select_candidate_plain(bits_all, refs, qcoefs: torch.Tensor,
                           shifts: torch.Tensor, method: int, min_o: int,
                           max_o: int):
    """S's plain version with the gather: the order ``method`` picks (MAX's
    constant, EST's rule on ``refs`` (:func:`~flake_tpu_torch.ops.lpc.
    estimate_order`), or :func:`select_order_bits_plain` on ``bits_all``),
    then that order's row of L's candidates. ``qcoefs`` int32 [..., max_o,
    max_o], ``shifts`` int32 [..., max_o]; ``bits_all`` int64 [..., >=
    max_o] (read under LEVEL2/4/8, SEARCH and LOG), ``refs`` [..., max_o]
    (read under EST). Returns (order int32 [...] (1-based), coefs int32
    [..., 32], the chosen row zero-padded, shift int32 [...])."""
    batch = qcoefs.shape[:-2]
    order = _order_of(method, min_o, max_o, bits_all, refs, batch,
                      qcoefs.device, select_order_bits_plain)
    sel = (order.to(torch.int64) - 1).clamp(0, max_o - 1)
    coefs = torch.gather(qcoefs, -2, sel[..., None, None].expand(
        batch + (1, max_o)))[..., 0, :]
    shift = torch.gather(shifts, -1, sel[..., None])[..., 0]
    coefs = torch.nn.functional.pad(coefs, (0, P.MAX_LPC_ORDER - max_o))
    return order, coefs, shift


def select_candidate(bits_all, refs, qcoefs: torch.Tensor,
                     shifts: torch.Tensor, method: int, min_o: int,
                     max_o: int):
    """:func:`select_candidate_plain`'s function. A CPU tensor takes the
    plain version; a CUDA tensor launches S (``csrc/select.cu``), one warp
    a stream, whose outputs equal the plain version's."""
    dev = qcoefs.device
    if dev.type == "cpu":
        return select_candidate_plain(bits_all, refs, qcoefs, shifts,
                                      method, min_o, max_o)
    if dev.type != "cuda":
        raise ValueError(f"select_candidate: no kernel for {dev}")
    if not 1 <= min_o <= max_o <= P.MAX_LPC_ORDER:
        raise ValueError(f"select_candidate: orders {min_o}-{max_o}; the "
                         f"kernel takes 1 <= min <= max <= "
                         f"{P.MAX_LPC_ORDER}")
    batch = qcoefs.shape[:-2]
    N = batch.numel()
    qcoefs = qcoefs.reshape(N, max_o, max_o).contiguous()
    shifts = shifts.reshape(N, max_o).contiguous()
    _cuda.check(qcoefs, "qcoefs", torch.int32, (N, max_o, max_o), dev)
    _cuda.check(shifts, "shifts", torch.int32, (N, max_o), dev)
    m, f64 = max_o, 1
    if method == P.OrderMethod.EST:
        refs = refs.reshape(N, max_o).contiguous()
        f64 = int(refs.dtype == torch.float64)
        _cuda.check(refs, "refs", torch.float64 if f64 else torch.float32,
                    (N, max_o), dev)
    elif method != P.OrderMethod.MAX:
        m = bits_all.shape[-1]
        if not max_o <= m <= P.MAX_LPC_ORDER:
            raise ValueError(f"select_candidate: orders {min_o}-{max_o} of "
                             f"{m} columns")
        bits_all = bits_all.reshape(N, m).contiguous()
        _cuda.check(bits_all, "bits_all", torch.int64, (N, m), dev)
    order = torch.empty(N, dtype=torch.int32, device=dev)
    coefs = torch.empty((N, P.MAX_LPC_ORDER), dtype=torch.int32, device=dev)
    shift = torch.empty(N, dtype=torch.int32, device=dev)
    if N:
        _cuda.launch("flake_select_candidate", dev,
                     bits_all if method > P.OrderMethod.EST else 0,
                     refs if method == P.OrderMethod.EST else 0, qcoefs,
                     shifts, order, coefs, shift, N, m, int(method), min_o,
                     max_o, f64)
        select_candidate.launches += 1
    return (order.reshape(batch), coefs.reshape(batch + (P.MAX_LPC_ORDER,)),
            shift.reshape(batch))


select_candidate.launches = 0


def _analysis_dict(mode, obits, wasted_bits, sf_type, type_code, order,
                   coefs, shift, rc, res, frame_bytes) -> dict:
    i32 = torch.int32
    return {
        "ch_mode": mode.to(i32),             # [F]
        "obits": obits.to(i32),              # [F, C]
        "wasted": wasted_bits.to(i32),       # [F, C]
        "sf_type": sf_type.to(i32),          # [F, C] 0/1/8/32
        "type_code": type_code.to(i32),      # [F, C] 6-bit header code
        "order": order.to(i32),              # [F, C]
        "coefs": coefs.to(i32),              # [F, C, 32]
        "shift": shift.to(i32),              # [F, C]
        "porder": rc["porder"].to(i32),      # [F, C]
        "method": rc["method"].to(i32),      # [F, C]
        "rice_params": rc["params"].to(i32),  # [F, C, 2^pmax_static]
        "residual": res.to(i32),             # [F, C, B]
        "frame_bytes": frame_bytes,          # [F] int64
    }


def finalize_analysis_plain(cfg: FrameConfig, chans, obits, wasted_bits,
                            constant, mode, sf_type, order, coefs, shift,
                            res, rc, hdr_bits, unfit=None) -> dict:
    """Z's plain version: CONSTANT override (optimize.c:143-151), exact
    frame-size accounting, the verbatim fallback (encode.c:949-964),
    header type codes, and the output dict (``frame.py:188-261``).

    ``unfit`` (bool [F, C]) marks the LPC subframes whose exact residual
    leaves int32 under a shifted prediction, which only 32-bit input
    reaches: the reference's int32 cast (optimize.c:120) writes a residual
    that decodes to other samples, as the shift does not commute with the
    wrap (an unshifted prediction is an integer sum and decodes back modulo
    2^32). The JAX package writes it so, and its stream fails its MD5
    (ROADMAP.md section 3). Where the frame does not fall back to verbatim
    as a whole anyway, the port stores those subframes verbatim and sizes
    the frame again; every other frame keeps the JAX package's bytes."""
    n = cfg.block_size
    C = sf_type.shape[1]
    i64 = torch.int64

    sf_type = torch.where(constant, SF_CONSTANT, sf_type)
    order = torch.where(constant, 0, order)
    res = torch.where(constant[..., None], chans, res)

    ob64 = obits.to(i64)
    sub_hdr = 8 + wasted_bits.to(i64)           # header byte + unary
    exact_rice = rc.get("exact_rice_bits", 0)       # 0 on VERBATIM
    o64 = order.to(i64)
    body = torch.where(
        sf_type == SF_CONSTANT, ob64,
        torch.where(sf_type == SF_VERBATIM, n * ob64,
                    torch.where(sf_type == SF_FIXED,
                                o64 * ob64 + 6 + exact_rice,
                                o64 * ob64 + 9 + o64 * cfg.precision
                                + 6 + exact_rice)))
    total_bits = hdr_bits.to(i64) + (sub_hdr + body).sum(dim=-1)
    frame_bytes = ((total_bits + 7) >> 3) + 2      # align + CRC-16
    vsize = P.max_frame_size(n, C, cfg.bps)
    if unfit is not None:
        unfit = unfit & (sf_type != SF_CONSTANT) \
            & ~(frame_bytes > vsize)[..., None]
        sf_type = torch.where(unfit, SF_VERBATIM, sf_type)
        order = torch.where(unfit, 0, order)
        res = torch.where(unfit[..., None], chans, res)
        total_bits = hdr_bits.to(i64) + (
            sub_hdr + torch.where(unfit, n * ob64, body)).sum(dim=-1)
        frame_bytes = ((total_bits + 7) >> 3) + 2

    # verbatim re-encode of frames over the uncompressed bound; it
    # stores the decorrelated, wasted-shifted samples
    fb = frame_bytes > vsize
    sf_type = torch.where(fb[..., None], SF_VERBATIM, sf_type)
    order = torch.where(fb[..., None], 0, order)
    res = torch.where(fb[..., None, None], chans, res)
    vb_total = hdr_bits.to(i64) + (sub_hdr + n * ob64).sum(dim=-1)
    frame_bytes = torch.where(fb, ((vb_total + 7) >> 3) + 2,
                              frame_bytes)

    type_code = torch.where(
        sf_type == SF_FIXED, SF_FIXED + order,
        torch.where(sf_type == SF_LPC, SF_LPC + order - 1, sf_type))
    return _analysis_dict(mode, obits, wasted_bits, sf_type, type_code,
                          order, coefs, shift, rc, res, frame_bytes)


def finalize_analysis(cfg: FrameConfig, chans, obits, wasted_bits,
                      constant, mode, sf_type, order, coefs, shift, res,
                      rc, hdr_bits, unfit=None) -> dict:
    """:func:`finalize_analysis_plain`'s function. A CPU tensor takes the
    plain version; a CUDA tensor launches Z (``csrc/finalize.cu``), a warp
    a frame, whose outputs equal the plain version's. Z updates ``res`` in
    place, and only the rows stored raw (CONSTANT, unfit, or in a frame
    over the verbatim bound), where it copies ``chans``: ``res`` is the
    analysis' own tensor (R2's output, or ``chans`` itself on the VERBATIM
    path, where nothing is copied). The row length is ``res``'s (on the sp
    path a rank's slice of the block), the sizes take ``cfg.block_size``.
    """
    dev = chans.device
    if dev.type == "cpu":
        return finalize_analysis_plain(cfg, chans, obits, wasted_bits,
                                       constant, mode, sf_type, order, coefs,
                                       shift, res, rc, hdr_bits, unfit)
    if dev.type != "cuda":
        raise ValueError(f"finalize_analysis: no kernel for {dev}")
    F, C = sf_type.shape
    L = res.shape[-1]
    i32, i64, b8 = torch.int32, torch.int64, torch.bool
    if chans.dtype != i32 or tuple(chans.shape) != (F, C, L) \
            or chans.device != dev:
        raise ValueError(f"chans: expected {i32} {(F, C, L)} on {dev}, got "
                         f"{chans.dtype} {tuple(chans.shape)} on "
                         f"{chans.device}")
    res = res.to(i32).contiguous()
    copy = not (res.data_ptr() == chans.data_ptr()
                and res.stride() == chans.stride())
    tables = {"obits": (obits, i32), "wasted": (wasted_bits, i32),
              "constant": (constant, b8), "sf_type": (sf_type, i32),
              "order": (order, i32), "unfit": (unfit, b8),
              "exact": (rc.get("exact_rice_bits"), i64)}
    t = {}                          # an absent table passes a null pointer
    for name, (v, dtype) in tables.items():
        t[name] = 0
        if v is not None:
            t[name] = v.to(dtype).contiguous()
            _cuda.check(t[name], name, dtype, (F, C), dev)
    hdr = hdr_bits.to(i32).contiguous()
    _cuda.check(res, "res", i32, (F, C, L), dev)
    _cuda.check(hdr, "hdr_bits", i32, (F,), dev)
    sf_out = torch.empty((F, C), dtype=i32, device=dev)
    order_out = torch.empty((F, C), dtype=i32, device=dev)
    type_code = torch.empty((F, C), dtype=i32, device=dev)
    frame_bytes = torch.empty(F, dtype=i64, device=dev)
    if F:
        n = cfg.block_size
        _cuda.launch("flake_finalize", dev, chans, res, t["obits"],
                     t["wasted"], t["constant"], t["sf_type"], t["order"],
                     t["exact"], t["unfit"], hdr, sf_out, order_out,
                     type_code, frame_bytes, F, C, L, n,
                     P.max_frame_size(n, C, cfg.bps), cfg.precision,
                     *chans.stride(), int(copy))
        finalize_analysis.launches += 1
    return _analysis_dict(mode, obits, wasted_bits, sf_out, type_code,
                          order_out, coefs, shift, rc, res, frame_bytes)


finalize_analysis.launches = 0


def sweep_route(n: int, pmax_static: int):
    """(the sweep, its kernel's name) for streams of n samples at
    ``pmax_static``: K4 wherever it can sum the shape, else K2."""
    if uses_granule_kernel(n, pmax_static):
        return sweep_granules, "K4"
    return sweep_sums, "K2"


def lpc_candidates(cfg: FrameConfig, autoc: torch.Tensor):
    """Every candidate order's quantized coefficients from the
    autocorrelation: Levinson for all orders (under EST: Schur, then
    Levinson seeded with its reflection coefficients, lpc.c:125-162) and
    the quantizer, one launch of L on the card
    (:func:`~flake_tpu_torch.ops.lpc.candidates`). Returns (qcoefs int32
    [N, max_order, max_order], shifts int32 [N, max_order], refs [N,
    max_order])."""
    return lpc_ops.candidates(autoc, cfg.order_method == P.OrderMethod.EST,
                              cfg.precision)


def candidate_bits(cfg: FrameConfig, cN: torch.Tensor, qcoefs, shifts,
                   obitsN: torch.Tensor) -> torch.Tensor:
    """The sweep (K2 or K4, :func:`sweep_route`) and the Rice scan of
    every candidate order: estimated subframe bits int64 [N, max_order]."""
    N, n = cN.shape
    max_o = cfg.max_prediction_order
    pmax_static = limit_max_partition_order(cfg.max_partition_order, n, 1)
    sweep, _ = sweep_route(n, pmax_static)
    sums = sweep(cN, qcoefs.contiguous(), shifts.contiguous(), max_o,
                 pmax_static)
    o_arr = torch.arange(1, max_o + 1, dtype=torch.int32, device=cN.device)
    return subframe_bits_from_sums(
        sums, n, o_arr.expand(N, max_o), obitsN[..., None],
        cfg.min_partition_order, cfg.max_partition_order, cfg.precision,
        True)


def _lpc_search(cfg: FrameConfig, chans, obits):
    """The LPC path (optimize.c:192-275) on the flattened [N = F*C]
    stream batch: K1 (in float64; the plain float32 autocorrelation under
    ``lpc_dtype="float32"``), :func:`lpc_candidates`, the sweep and the
    Rice scan for every candidate order where the order method reads bit
    counts (:func:`candidate_bits`), the order selection and its
    candidate's coefficients and shift (S, :func:`select_candidate`), the
    final pass on them (R2, :func:`~flake_tpu_torch.ops.rice.final_pass`:
    the residual and its exact Rice parameters), and the subframes whose
    residual leaves int32 under a shifted prediction."""
    F, C, n = chans.shape
    N = F * C
    max_o = cfg.max_prediction_order
    dev = chans.device
    cN = chans.reshape(N, n).contiguous()
    obitsN = obits.reshape(N)
    with annotate("flake.analysis.lpc"):
        if cfg.lpc_dtype == "float64":
            autoc = autocorr(cN, lpc_ops.welch_window_on(n, dev), max_o)  # K1
        else:
            autoc = lpc_ops.autocorr(cN, max_o, lpc_ops.welch_window_on(
                n, dev, LPC_DTYPES[cfg.lpc_dtype]))
        qcoefs, shifts, refs = lpc_candidates(cfg, autoc)

    bits_all = None
    if cfg.order_method not in (P.OrderMethod.MAX, P.OrderMethod.EST):
        with annotate("flake.analysis.sweep"):
            bits_all = candidate_bits(cfg, cN, qcoefs, shifts, obitsN)
    with annotate("flake.analysis.select"):
        order, coefs, shift = select_candidate(
            bits_all, refs, qcoefs, shifts, cfg.order_method,
            cfg.min_prediction_order, max_o)
    with annotate("flake.analysis.final"):
        rc = final_pass(cN, coefs[:, :max_o], shift, order, n,
                        cfg.min_partition_order, cfg.max_partition_order)
    res, fits = rc.pop("residual"), rc.pop("fits")
    return (order.reshape(F, C), coefs.reshape(F, C, P.MAX_LPC_ORDER),
            shift.reshape(F, C), res.reshape(F, C, n),
            {k: v.reshape((F, C) + v.shape[1:]) for k, v in rc.items()},
            (~fits & (shift > 0)).reshape(F, C))


def _stereo_estimate(cfg: FrameConfig) -> bool:
    """Whether the batch estimates its stereo mode (encode.c:648-694)."""
    return cfg.channels == 2 and cfg.block_size > 32 \
        and cfg.stereo_method == P.StereoMethod.ESTIMATE


def frame_head_plain(samples: torch.Tensor, cfg: FrameConfig):
    """H's plain version: everything :func:`analyze_frames` does before the
    prediction, from ``samples`` int32 [F, B, C]: the stereo mode and
    decorrelation (encode.c:648-694), the wasted bits (encode.c:558-593)
    and the constant flags (optimize.c:143-151). Returns (chans int32 [F,
    C, B], obits int32 [F, C], wasted int32 [F, C], mode int32 [F],
    constant bool [F, C])."""
    n = cfg.block_size
    C = cfg.channels
    F = samples.shape[0]
    dev = samples.device
    i32 = torch.int32

    chans = samples.permute(0, 2, 1)                   # [F, C, B]
    obits = torch.full((F, C), cfg.bps, dtype=i32, device=dev)

    if _stereo_estimate(cfg):
        mode = stereo.decorr_mode(chans[:, 0], chans[:, 1], n)
        if cfg.bps >= 32:
            # a 33-bit side value cannot ride the int32 residual pipeline:
            # veto side modes where |l - r| would overflow
            over = (chans[:, 0].to(torch.int64)
                    - chans[:, 1].to(torch.int64)).abs().amax(dim=-1) \
                >= (1 << 31)
            mode = torch.where(over, stereo.LEFT_RIGHT, mode)
        ch0, ch1, extra = stereo.apply_decorr(chans[:, 0], chans[:, 1],
                                              mode)
        chans = torch.stack([ch0, ch1], dim=1)
        obits = obits + extra
    elif C == 2:
        mode = torch.full((F,), stereo.LEFT_RIGHT, dtype=i32, device=dev)
    else:
        mode = torch.full((F,), stereo.NOT_STEREO, dtype=i32, device=dev)

    chans, wasted_bits = wasted.remove_wasted_bits(chans, cfg.bps)
    obits = obits - wasted_bits
    constant = (chans == chans[..., :1]).all(dim=-1)
    return chans, obits, wasted_bits, mode, constant


def frame_head(samples: torch.Tensor, cfg: FrameConfig):
    """:func:`frame_head_plain`'s function. A CPU tensor takes the plain
    version; a CUDA tensor launches H (``csrc/head.cu``), one block a
    frame, whose outputs equal the plain version's (``chans``
    contiguous)."""
    if samples.device.type == "cpu":
        return frame_head_plain(samples, cfg)
    if samples.device.type != "cuda":
        raise ValueError(f"frame_head: no kernel for {samples.device}")
    n, C = cfg.block_size, cfg.channels
    F = samples.shape[0]
    dev = samples.device
    samples = samples.contiguous()
    _cuda.check(samples, "samples", torch.int32, (F, n, C), dev)
    chans = torch.empty((F, C, n), dtype=torch.int32, device=dev)
    obits = torch.empty((F, C), dtype=torch.int32, device=dev)
    wasted_bits = torch.empty((F, C), dtype=torch.int32, device=dev)
    mode = torch.empty(F, dtype=torch.int32, device=dev)
    constant = torch.empty((F, C), dtype=torch.bool, device=dev)
    if F:
        _cuda.launch("flake_frame_head", dev, samples, chans, obits,
                     wasted_bits, mode, constant, F, n, C, cfg.bps,
                     int(_stereo_estimate(cfg)))
        frame_head.launches += 1
    return chans, obits, wasted_bits, mode, constant


frame_head.launches = 0


def analyze_frames(samples: torch.Tensor, cfg: FrameConfig,
                   hdr_bits: torch.Tensor) -> dict:
    """Analyse a batch of frames.

    samples: int32 [F, B, C] (channels on the last axis).
    hdr_bits: int32 [F], each frame's header bit count incl. CRC-8, for
      the exact frame byte counts and the verbatim fallback
      (encode.c:949-964).
    Returns the dict of per-frame/channel selection tensors + residuals.

    Under ``torch.profiler`` the call is the span ``flake.analysis``, with
    a span a stage inside it: ``.head`` (H), ``.lpc`` (K1, L), ``.sweep``
    (K4 or K2, R1; where the order method reads bit counts), ``.select``
    (S, or X on the FIXED path), ``.final`` (R2), ``.finalize`` (Z).
    """
    n = cfg.block_size
    C = cfg.channels
    F = samples.shape[0]
    dev = samples.device
    i32 = torch.int32
    pmin, pmax = cfg.min_partition_order, cfg.max_partition_order

    with annotate("flake.analysis"):
        # stereo decorrelation, wasted bits and constant blocks (H)
        with annotate("flake.analysis.head"):
            chans, obits, wasted_bits, mode, constant = frame_head(samples,
                                                                   cfg)
        zeros32 = torch.zeros((F, C, P.MAX_LPC_ORDER), dtype=i32,
                              device=dev)
        if n < 5 or cfg.prediction_type == P.Prediction.NONE:
            # VERBATIM for every subframe (optimize.c:153-158)
            order = torch.zeros((F, C), dtype=i32, device=dev)
            sf_type = torch.full((F, C), SF_VERBATIM, dtype=i32, device=dev)
            shift = torch.zeros_like(order)
            coefs = zeros32
            res = chans
            rc = {"porder": torch.zeros_like(order),
                  "method": torch.zeros_like(order),
                  "params": torch.zeros((F, C, 1 << pmax), dtype=i32,
                                        device=dev)}
            unfit = None
        elif (cfg.prediction_type == P.Prediction.FIXED
              or n <= cfg.max_prediction_order):
            # FIXED path (optimize.c:167-190): the order search (X), then
            # the final pass (R2) with the chosen predictor's coefficients
            with annotate("flake.analysis.select"):
                order, fcoefs = fixed_search(
                    chans, obits, cfg.min_prediction_order,
                    min(cfg.max_prediction_order, 4), pmin, pmax)
            shift = torch.zeros_like(order)
            with annotate("flake.analysis.final"):
                rc = final_pass(chans, fcoefs, shift, order, n, pmin, pmax)
            res = rc.pop("residual")
            del rc["fits"]     # an unshifted prediction decodes mod 2^32
            unfit = None
            sf_type = torch.full((F, C), SF_FIXED, dtype=i32, device=dev)
            coefs = zeros32
        else:
            order, coefs, shift, res, rc, unfit = _lpc_search(cfg, chans,
                                                              obits)
            sf_type = torch.full((F, C), SF_LPC, dtype=i32, device=dev)

        with annotate("flake.analysis.finalize"):
            return finalize_analysis(cfg, chans, obits, wasted_bits,
                                     constant, mode, sf_type, order, coefs,
                                     shift, res, rc, hdr_bits, unfit)
