"""Batched LPC analysis: Welch window, autocorrelation, Levinson-Durbin,
coefficient quantization (port of ``flake_tpu/ops/lpc.py``, lpc.c).

- :func:`autocorr` is the plain windowed autocorrelation. In float64 it
  is the CPU path and the version K1
  (:mod:`flake_tpu_torch.ops.autocorr`) is held against on the card; in
  float32 it is the ``lpc_dtype="float32"`` path on every device, as the
  JAX package computes that dtype outside its kernel. The recursions and
  the quantizer below work in the dtype they are given.
- :func:`levinson_all_orders` keeps the recursion's one sequential
  dependency as a Python loop of at most 32 batch-wide steps, with the
  JAX package's float operations in the same order, so given the same
  autocorrelation the coefficients agree bit for bit: the reflection
  numerator is summed left to right, and ``1 - r*r`` and the symmetric
  update are fused multiply-adds (``torch.addcmul``), as XLA contracts
  them.
- :func:`quantize_lpc_coefs` reproduces the shift search, scale-down
  branch and error-feedback rounding (lpc.c:167-219). Powers of two are
  built exactly from their bits, as the reference's ``1 << shift`` is;
  XLA's ``exp2`` can be an ulp off, which moves a quantized coefficient
  only when ``error + tap * 2^shift + 0.5`` lies within an ulp of an
  integer.

- :func:`schur_refs`, :func:`levinson_from_refs` and
  :func:`estimate_order` are the EST order method's float path (levels
  3-6, lpc.c:125-162). XLA:CPU contracts every multiply-add of both
  recursions into a fused multiply-add (found by holding the eight
  fused/unfused combinations of Schur and the four of the seeded Levinson
  against the jitted JAX functions: only the all-fused ones agree bit
  for bit), so each is a ``torch.addcmul`` here. EST reads
  ``|ref| > 0.10`` and the quantizer truncates, so one ulp can move an
  order or a coefficient.

- :func:`candidates` is the whole coefficient stage: on a CUDA tensor one
  launch of ``csrc/lpc.cu`` (L), which runs the recursions and the
  quantizer with the plain versions' roundings; on a CPU tensor
  :func:`candidates_plain`, the composition of the functions above, which
  the kernel is held against on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from flake_tpu_torch import _cuda
from flake_tpu_torch import params as P


def welch_window(n: int) -> np.ndarray:
    """Welch window matching lpc.c:28-40 (host-computed float64)."""
    c = (2.0 / (n - 1.0)) - 1.0
    w = np.empty(n, dtype=np.float64)
    half = n >> 1
    i = np.arange(half, dtype=np.float64)
    wi = 1.0 - ((c - i) * (c - i))
    w[:half] = wi
    w[n - 1 - np.arange(half)] = wi
    if n & 1:
        w[half] = 1.0 - ((c - half) * (c - half))
    return w


@functools.lru_cache(maxsize=64)
def welch_window_on(n: int, device: torch.device,
                    dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """:func:`welch_window` as a ``dtype`` tensor on ``device`` (rounded
    from float64), copied from pinned memory without blocking the host.
    Built once per (n, device, dtype) and shared by every caller, which
    must not write to it."""
    w = torch.from_numpy(welch_window(n)).to(dtype)
    if device.type == "cuda":
        return w.pin_memory().to(device, non_blocking=True)
    return w.to(device)


def autocorr(x: torch.Tensor, max_order: int,
             window: torch.Tensor) -> torch.Tensor:
    """Windowed autocorrelation for lags 0..max_order in the window's
    dtype (lpc.c:46-71), with the reference's +2.0 bias per lag.

    ``x`` int32 [..., B]; ``window`` float64 or float32 [B]. Returns
    [..., max_order+1] in that dtype; a lag of B or more sums nothing
    (2.0), as K1 gives it for any B."""
    n = x.shape[-1]
    d = x.to(window.dtype) * window
    cols = [(d[..., lag:] * d[..., :max(n - lag, 0)]).sum(dim=-1) + 2.0
            for lag in range(max_order + 1)]
    return torch.stack(cols, dim=-1)


def levinson_all_orders(autoc: torch.Tensor):
    """Levinson-Durbin producing coefficients for every order at once
    (lpc.c:77-117), vectorised over the batch.

    Returns (lpc [..., max_order, max_order], refs [..., max_order]): row
    o-1 of ``lpc`` holds the negated coefficients of order o, zero beyond
    tap o; ``refs`` the reflection coefficient of each step."""
    max_order = autoc.shape[-1] - 1
    batch = autoc.shape[:-1]
    W = max_order
    tiny = torch.finfo(autoc.dtype).tiny
    zeros = autoc.new_zeros(batch + (W,))
    taps = torch.arange(W, device=autoc.device)

    def shift_in(vec, head):
        """[head, vec[0], ..., vec[W-2]]."""
        return torch.cat([head[..., None], vec[..., :-1]], dim=-1)

    # rev[j] = tmp[i-1-j] and ac_rev[j] = autoc[i-j], kept incrementally
    tmp, rev = zeros, zeros
    ac_rev = shift_in(zeros, autoc[..., 0])
    err = autoc[..., 0]
    rows, refs = [], []
    for i in range(max_order):
        a_next = autoc[..., i + 1]
        prods = tmp * ac_rev
        acc = torch.zeros_like(a_next)
        for j in range(i):               # the JAX reduction's order
            acc = acc + prods[..., j]
        r = -a_next - acc
        r = r / torch.where(err == 0.0, tiny, err)  # NaN guard only
        err = err * torch.addcmul(torch.ones_like(r), -r, r)
        rb = r[..., None]
        new_tmp = torch.where(taps < i, torch.addcmul(tmp, rb, rev), tmp)
        new_tmp = torch.where(taps == i, rb, new_tmp)
        rev = shift_in(torch.addcmul(rev, rb, tmp), r)
        ac_rev = shift_in(ac_rev, a_next)
        tmp = new_tmp
        rows.append(torch.where(taps <= i, -tmp, 0.0))
        refs.append(r)
    return torch.stack(rows, dim=-2), torch.stack(refs, dim=-1)


def schur_refs(autoc: torch.Tensor) -> torch.Tensor:
    """Schur recursion for the reflection coefficients (lpc.c:136-147),
    vectorised over the batch: the float path the reference's EST order
    method runs (Levinson's reflection coefficients are only
    algebraically equal; their rounding differs).

    ``autoc`` float64 [..., max_order+1]. Returns [..., max_order]."""
    max_order = autoc.shape[-1] - 1
    gen0 = autoc[..., 1:]
    gen1 = gen0
    error = autoc[..., 0]
    r = -gen1[..., 0] / error
    error = torch.addcmul(error, gen1[..., 0], r)
    refs = [r]
    zero_tail = torch.zeros_like(autoc[..., :1])
    for _ in range(1, max_order):
        g1s = torch.cat([gen1[..., 1:], zero_tail], dim=-1)
        rb = r[..., None]
        gen1 = torch.addcmul(g1s, rb, gen0)
        gen0 = torch.addcmul(gen0, g1s, rb)
        r = -gen1[..., 0] / error
        error = torch.addcmul(error, gen1[..., 0], r)
        refs.append(r)
    return torch.stack(refs, dim=-1)


def levinson_from_refs(refs: torch.Tensor) -> torch.Tensor:
    """The Levinson symmetric update seeded with given reflection
    coefficients, compute_lpc_coefs(NULL, order, ref, lpc) (lpc.c:77-117
    with the ``ref`` branch), as EST runs it after Schur. Row o-1 depends
    only on refs[..., :o], so all rows are produced and the estimated
    order's row is gathered.

    ``refs`` float64 [..., m]. Returns rows [..., m, m], negated like
    :func:`levinson_all_orders`'s."""
    m = refs.shape[-1]
    taps = torch.arange(m, device=refs.device)
    tmp = refs.new_zeros(refs.shape)
    rev = tmp
    rows = []
    for i in range(m):
        r = refs[..., i:i + 1]
        new_tmp = torch.where(taps < i, torch.addcmul(tmp, r, rev), tmp)
        new_tmp = torch.where(taps == i, r, new_tmp)
        rev = torch.cat([r, torch.addcmul(rev, r, tmp)[..., :-1]], dim=-1)
        tmp = new_tmp
        rows.append(torch.where(taps <= i, -tmp, 0.0))
    return torch.stack(rows, dim=-2)


def estimate_order(refs: torch.Tensor, max_order: int) -> torch.Tensor:
    """The EST order rule: the highest step with |ref| > 0.10, at least 1
    (lpc.c:149-156). Returns int32 [...]."""
    idx = torch.arange(1, max_order + 1, dtype=torch.int32,
                       device=refs.device)
    above = torch.where(refs.abs() > 0.10, idx, 0)
    return above.amax(dim=-1).clamp_min(1)


def _exp2i(s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """2.0**s for integer s, exact, from the bits: in float64 for s in
    [-1022, 1023]; in float32 inf above 127, as ``exp2`` gives it, and
    2^-126 below -126 (where the shift search reads the same)."""
    if dtype == torch.float32:
        s = s.to(torch.int32).clamp(-126, 128)
        return ((s + 127) << 23).view(torch.float32)
    return ((s.to(torch.int64) + 1023) << 52).view(torch.float64)


def quantize_lpc_coefs(lpc: torch.Tensor, precision: int):
    """Quantize per-order coefficient rows (lpc.c:167-219).

    ``lpc`` float64 or float32 [..., n_orders, W], row o-1 using taps
    [:o]. Returns (coefs int32 same shape, shift int32 [..., n_orders])."""
    n_orders, W = lpc.shape[-2], lpc.shape[-1]
    dev = lpc.device
    qmax = (1 << (precision - 1)) - 1
    taps = torch.arange(W, device=dev)
    valid = taps[None, :] < torch.arange(1, n_orders + 1,
                                         device=dev)[:, None]
    cmax = torch.where(valid, lpc.abs(), 0.0).amax(dim=-1)
    zero_out = cmax * (1 << 15) < 1.0

    # closed form of the downward shift scan (lpc.c:193-206): the largest
    # sh in [0, 15] with cmax * 2^sh <= qmax, resolved exactly in a +-2
    # window around the exponent of cmax's float32 image
    f32bits = cmax.to(torch.float32).view(torch.int32)
    s0 = (precision - 1) - (((f32bits >> 23) & 0xFF) - 126)
    sh = torch.full_like(s0, -(1 << 20))
    for d in (-2, -1, 0, 1):
        s = s0 + d
        ok = cmax * _exp2i(s, lpc.dtype) <= qmax
        sh = torch.where(ok, torch.maximum(sh, s), sh)
    sh = torch.clamp(sh, 0, 15)

    scale_down = (sh == 0) & (cmax > qmax)
    lpc_s = torch.where(
        scale_down[..., None],
        lpc * (qmax / torch.where(cmax == 0, 1.0, cmax))[..., None], lpc)

    mult = _exp2i(sh, lpc.dtype)
    error = torch.zeros_like(cmax)
    qs = []
    for t in range(W):
        tap_valid = valid[:, t]
        e2 = error + lpc_s[..., t] * mult
        q = torch.trunc(e2 + 0.5)
        q = torch.where(q <= -qmax, float(-qmax + 1), q)
        q = torch.where(q > qmax, float(qmax), q)
        q = torch.where(tap_valid, q, 0.0)
        error = torch.where(tap_valid, e2 - q, error)
        # a NaN tap casts to 0, as XLA's convert gives it (the host's
        # cvttsd2si and the card's float64 conversion give INT32_MIN)
        qs.append(torch.where(q.isnan(), 0.0, q).to(torch.int32))
    coefs = torch.stack(qs, dim=-1)
    coefs = torch.where(zero_out[..., None], 0, coefs)
    shift = torch.where(zero_out, 0, sh).to(torch.int32)
    return coefs, shift


def candidates_plain(autoc: torch.Tensor, est: bool, precision: int):
    """Every candidate order's quantized coefficients from the
    autocorrelation: :func:`levinson_all_orders` (or, under ``est``,
    :func:`schur_refs` then :func:`levinson_from_refs`) and
    :func:`quantize_lpc_coefs`. Returns (qcoefs int32 [..., m, m], shifts
    int32 [..., m], refs [..., m] in ``autoc``'s dtype), m the max order."""
    if est:
        refs = schur_refs(autoc)
        rows = levinson_from_refs(refs)
    else:
        rows, refs = levinson_all_orders(autoc)
    qcoefs, shifts = quantize_lpc_coefs(rows, precision)
    return qcoefs, shifts, refs


def candidates(autoc: torch.Tensor, est: bool, precision: int):
    """:func:`candidates_plain`'s function. ``autoc`` float64 or float32
    [..., m + 1], 1 <= m <= 32. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (``csrc/lpc.cu``), one warp a
    stream, whose outputs equal the plain version's bit for bit."""
    if autoc.device.type == "cpu":
        return candidates_plain(autoc, est, precision)
    if autoc.device.type != "cuda":
        raise ValueError(f"candidates: no kernel for {autoc.device}")
    if autoc.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"candidates: no kernel for {autoc.dtype}")
    m = autoc.shape[-1] - 1
    if not 1 <= m <= P.MAX_LPC_ORDER or not 2 <= precision <= 16:
        raise ValueError(f"candidates: max order {m}, precision "
                         f"{precision}; the kernel takes orders 1-"
                         f"{P.MAX_LPC_ORDER} and precisions 2-16")
    batch = autoc.shape[:-1]
    N = batch.numel()
    dev = autoc.device
    autoc = autoc.reshape(N, m + 1).contiguous()
    qcoefs = torch.empty((N, m, m), dtype=torch.int32, device=dev)
    shifts = torch.empty((N, m), dtype=torch.int32, device=dev)
    refs = torch.empty((N, m), dtype=autoc.dtype, device=dev)
    if N:
        _cuda.launch("flake_lpc_candidates", dev, autoc, qcoefs, shifts,
                     refs, N, m, precision, int(est),
                     int(autoc.dtype == torch.float64))
        candidates.launches += 1
    return (qcoefs.reshape(batch + (m, m)), shifts.reshape(batch + (m,)),
            refs.reshape(batch + (m,)))


candidates.launches = 0
