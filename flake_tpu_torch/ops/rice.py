"""Batched Rice partition-order and parameter search (port of
``flake_tpu/ops/rice.py``, rice.c).

Every serial scan of the reference is a dense reduction: partition sums
are a reshape-sum plus pairwise folds (rice.c:76-103), the k scan a
31-wide argmin (rice.c:30-45), the partition-order scan a select per
level (rice.c:105-139). Unsigned counts are int64 here; where the
reference truncates to uint32 the port masks with ``& U32_MASK``. For
``k <= 31`` the low 32 bits of ``t >> k`` do not depend on whether the
shift is arithmetic or logical, so the int64 forms are exact.

Three CUDA kernels written for Hopper (``flake_tpu_torch/csrc/rice.cu``)
run the per-element search on the card: R1, :func:`rice_scan`, the
partition-order and k scan from partition sums (the sweep's, and the sp
final search's), and R2, :func:`final_pass`, the final pass from the
samples and the selected predictor: the residual, its fit check and the
search with the exact bits in one launch. Neither holds a k grid in
device memory. :func:`rice_scan_plain` and :func:`final_pass_plain` are
their plain versions, which a CPU tensor takes; the second composes
:func:`~flake_tpu_torch.ops.predict.residual_lpc_dynamic64` and
:func:`rice_final_plain`, the search from a residual. The third, X,
:func:`fixed_search`, is the FIXED order search in one launch: its plain
version :func:`fixed_search_plain` runs the static search
(:func:`calc_rice_params`) once an order. The stereo mode's
:func:`find_optimal_k` belongs to H's plain version
(``ops/frame.frame_head_plain``).

Shapes: ``res`` is [..., B] with arbitrary leading batch dims.
"""

from __future__ import annotations

import torch

from flake_tpu_torch import _cuda
from flake_tpu_torch import params as P
from flake_tpu_torch.ops import predict
from flake_tpu_torch.ops.common import U32_MASK, u32, wrap_int32

MAX_K = P.MAX_RICE_PARAM  # 30


def log2i(v: int) -> int:
    return v.bit_length() - 1 if v > 0 else 0


def limit_max_partition_order(max_porder: int, n: int, order: int) -> int:
    """Static version of rice.c:148-155 (n and order are static here)."""
    porder = min(max_porder, log2i(n ^ (n - 1)))
    if order > 0:
        porder = min(porder, log2i(n // order))
    return porder


def zigzag_u32(res: torch.Tensor) -> torch.Tensor:
    """(2*r) ^ (r >> 31) stored in a uint32_t, wrapping for |r| >= 2^30
    exactly like rice.c:120-123; returned as int64 in [0, 2^32)."""
    d = res.to(torch.int64)
    return ((2 * d) ^ (d >> 63)) & U32_MASK


def _rice_count(sums, cnt, ks):
    """rice_encode_count (rice.h:48) with uint32 truncation."""
    return u32(cnt * (ks + 1) + ((sums - (cnt >> 1)) >> ks))


def _first_min(nbits: torch.Tensor):
    """(index int32, value) of the minimum over the last axis, in one
    reduction. The first minimum wins ties, as ``jnp.argmin`` and the
    reference's strict < have it: ``torch.min``'s stated rule ("the
    indices of the first minimal value are returned"), held on the CPU
    against JAX and on the card against the CPU by the tests."""
    best, k_opt = torch.min(nbits, dim=-1)
    return k_opt.to(torch.int32), best


def find_optimal_k(sums: torch.Tensor, cnt: int):
    """k = 0..30 scan (rice.c:30-45). Returns (k int32 [...], bits int64
    [...]); the first minimum wins ties, like the reference's strict <."""
    ks = torch.arange(MAX_K + 1, dtype=torch.int64, device=sums.device)
    nbits = _rice_count(sums[..., None], cnt, ks)
    return _first_min(nbits)


def find_optimal_k_u32(sums: torch.Tensor, cnt):
    """The JAX package's limb form of :func:`find_optimal_k`: the half
    count is truncated to 32 bits before the subtraction and the count
    multiplies mod 2^32. ``cnt`` is an int or an int64 tensor broadcast
    against ``sums`` (per-partition counts)."""
    ks = torch.arange(MAX_K + 1, dtype=torch.int64, device=sums.device)
    if isinstance(cnt, int):
        cnt2, cnt32 = (cnt >> 1) & U32_MASK, cnt & U32_MASK
    else:
        cnt2 = ((cnt >> 1) & U32_MASK)
        cnt32 = (cnt & U32_MASK)[..., None]
    t = (sums - cnt2)[..., None]
    nbits = u32(cnt32 * (ks + 1) + ((t >> ks) & U32_MASK))
    return _first_min(nbits)


def _partition_sums(z: torch.Tensor, parts: int, psize: int):
    """Exact int64 partition sums of [..., parts * psize] zigzag data."""
    return z.reshape(z.shape[:-1] + (parts, psize)).sum(dim=-1)


def _fold_pyramid(levels: list, pmax_static: int) -> list:
    """Fill levels[p] for p < pmax_static by pairwise adds
    (rice.c:96-102)."""
    for p in range(pmax_static - 1, -1, -1):
        prev = levels[p + 1]
        levels[p] = prev[..., 0::2] + prev[..., 1::2]
    return levels


def partition_pyramid(z32: torch.Tensor, n: int, order: int, pmax: int):
    """Partition sums for every level 0..pmax (rice.c:76-103), warm-up
    samples (the first ``order``) excluded."""
    if order > 0:
        z32 = torch.where(torch.arange(n, device=z32.device) >= order,
                          z32, 0)
    sums = [None] * (pmax + 1)
    sums[pmax] = _partition_sums(z32, 1 << pmax, n >> pmax)
    return _fold_pyramid(sums, pmax)


def calc_rice_params(res: torch.Tensor, n: int, order: int, pmin: int,
                     pmax: int):
    """Partition-order + k search for one static predictor order
    (rice.c:105-139), ties preferring the higher partition order
    (rice.c:131). Returns (bits, method) of the best partition order:
    the FIXED order search needs only the estimate."""
    pmin = limit_max_partition_order(pmin, n, order)
    pmax = limit_max_partition_order(pmax, n, order)
    sums = partition_pyramid(zigzag_u32(res), n, order, pmax)
    best = None
    for p in range(pmin, pmax + 1):
        parts = 1 << p
        cnts = torch.full((parts,), n >> p, dtype=torch.int64,
                          device=res.device)
        cnts[0] = (n >> p) - order
        k, kb = find_optimal_k_u32(sums[p], cnts)
        bits = u32(kb.sum(dim=-1) + 4 * parts)
        method = (k > P.MAX_RICE_PARAM_4BIT).any(dim=-1).to(torch.int32)
        if best is None:
            best = (bits, method)
            continue
        take = bits <= best[0]
        best = (torch.where(take, bits, best[0]),
                torch.where(take, method, best[1]))
    return best


def _ilog2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for positive int64 x (log2i, common.h:53-65)."""
    r = torch.zeros_like(x)
    v = x
    for s in (32, 16, 8, 4, 2, 1):
        big = v >= (1 << s)
        r = torch.where(big, r + s, r)
        v = torch.where(big, v >> s, v)
    return r.to(torch.int32)


def _dynamic_porder_scan(sums: list, n: int, order: torch.Tensor,
                         pmin: int, pmax: int, pmax_static: int,
                         want_kgrid: bool = False):
    """Partition-order scan with per-element predictor ``order``: the
    pmin/pmax clamps by log2(n/order) (rice.c:148-155,163-164), the k
    search per level and the tie-to-higher-porder rule (rice.c:131).

    ``sums[p]`` is int64 [..., 2^p]. Returns (bits, porder, method,
    params[..., 2^pmax_static], kgrid) — kgrid is the winning k spread
    onto the pmax_static grid (None unless requested)."""
    batch = order.shape
    dev = order.device
    ub = log2i(n ^ (n - 1))
    log2_no = _ilog2(n // torch.clamp(order.to(torch.int64), min=1))
    pmax_eff = torch.minimum(torch.full_like(log2_no, min(pmax, ub)),
                             torch.where(order > 0, log2_no, pmax))
    pmin_eff = torch.minimum(torch.full_like(log2_no, min(pmin, ub)),
                             torch.where(order > 0, log2_no, pmin))

    parts_max = 1 << pmax_static
    best_bits = torch.full(batch, U32_MASK, dtype=torch.int64, device=dev)
    best_porder = torch.zeros(batch, dtype=torch.int32, device=dev)
    best_method = torch.zeros(batch, dtype=torch.int32, device=dev)
    best_params = torch.zeros(batch + (parts_max,), dtype=torch.int32,
                              device=dev)
    best_kgrid = best_params.clone() if want_kgrid else None
    order64 = order.to(torch.int64)

    for p in range(pmax_static + 1):
        parts = 1 << p
        cnts = torch.full(batch + (parts,), n >> p, dtype=torch.int64,
                          device=dev)
        cnts[..., 0] = (n >> p) - order64
        k, kb = find_optimal_k_u32(sums[p], cnts)
        bits = u32(kb.sum(dim=-1) + 4 * parts)
        method = (k > P.MAX_RICE_PARAM_4BIT).any(dim=-1).to(torch.int32)
        params = torch.nn.functional.pad(k, (0, parts_max - parts))

        take = (p >= pmin_eff) & (p <= pmax_eff) & (bits <= best_bits)
        best_bits = torch.where(take, bits, best_bits)
        best_porder = torch.where(take, p, best_porder)
        best_method = torch.where(take, method, best_method)
        best_params = torch.where(take[..., None], params, best_params)
        if want_kgrid:
            kgrid = k.repeat_interleave(parts_max // parts, dim=-1)
            best_kgrid = torch.where(take[..., None], kgrid, best_kgrid)

    return best_bits, best_porder, best_method, best_params, best_kgrid


def _overhead_bits(bits, method, order, obits, precision: int,
                   is_lpc: bool):
    """Estimated subframe bits from the Rice section's estimate: warm-up,
    coefficient and header fields (rice.c:157-171), uint32-truncated."""
    o64 = order.to(torch.int64) if torch.is_tensor(order) else order
    ob64 = obits.to(torch.int64) if torch.is_tensor(obits) else obits
    overhead = o64 * ob64 + 2
    if is_lpc:
        overhead = overhead + (4 + 5 + o64 * precision)
    return u32(bits + overhead + method.to(torch.int64) + 4)


def rice_scan_plain(sums: torch.Tensor, order: torch.Tensor, n: int,
                    pmin: int, pmax: int):
    """R1's plain version: ``sums`` int64 [..., G], G a multiple of
    2^pmax_static (finer sums are folded to the pmax_static level first,
    ``flake_tpu/ops/rice.py:289-296``), ``order`` int32 [...]; the pyramid
    and the per-element scan (``_fold_pyramid``, ``_dynamic_porder_scan``).
    Returns (bits int64 [...] (the uint32 value), porder int32 [...],
    method int32 [...], params int32 [..., 2^pmax_static])."""
    pmax_static = limit_max_partition_order(pmax, n, 1)
    parts_max = 1 << pmax_static
    G = sums.shape[-1]
    if G != parts_max:
        sums = sums.reshape(sums.shape[:-1] + (parts_max, G // parts_max)) \
            .sum(dim=-1)
    levels = [None] * (pmax_static + 1)
    levels[pmax_static] = sums
    _fold_pyramid(levels, pmax_static)
    bits, porder, method, params, _ = _dynamic_porder_scan(
        levels, n, order.expand(sums.shape[:-1]), pmin, pmax, pmax_static)
    return bits, porder, method, params


def _search_args(n: int, pmin: int, pmax: int) -> tuple:
    """The kernels' trailing ints: n, pmin, pmax, pmax_static and
    log2i(n ^ (n - 1)), the clamp of rice.c:148-155."""
    return (n, pmin, pmax, limit_max_partition_order(pmax, n, 1),
            log2i(n ^ (n - 1)))


def rice_scan(sums: torch.Tensor, order: torch.Tensor, n: int, pmin: int,
              pmax: int):
    """The partition-order and k search of every row from its partition
    sums (R1). ``sums`` int64 [..., G], ``order`` int32 broadcast to
    [...]; returns what :func:`rice_scan_plain` returns. A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel
    (``csrc/rice.cu``)."""
    pmax_static = limit_max_partition_order(pmax, n, 1)
    G = sums.shape[-1]
    if not 0 <= pmax_static <= P.MAX_PARTITION_ORDER \
            or G % (1 << pmax_static):
        raise ValueError(f"rice_scan: {G} sums a row do not fold to "
                         f"2^{pmax_static} partitions")
    if sums.device.type == "cpu":
        return rice_scan_plain(sums, order, n, pmin, pmax)
    if sums.device.type != "cuda":
        raise ValueError(f"rice_scan: no kernel for {sums.device}")
    batch = sums.shape[:-1]
    R = batch.numel()
    parts = 1 << pmax_static
    sums = sums.reshape(R, G).contiguous()
    order = order.expand(batch).reshape(R).contiguous()
    _cuda.check(sums, "sums", torch.int64, (R, G), sums.device)
    _cuda.check(order, "order", torch.int32, (R,), sums.device)
    bits = torch.empty(R, dtype=torch.int64, device=sums.device)
    porder = torch.empty(R, dtype=torch.int32, device=sums.device)
    method = torch.empty(R, dtype=torch.int32, device=sums.device)
    params = torch.empty((R, parts), dtype=torch.int32, device=sums.device)
    if R:
        _cuda.launch("flake_rice_scan", sums.device, sums, order, bits,
                     porder, method, params, R, G,
                     *_search_args(n, pmin, pmax))
        rice_scan.launches += 1
    return (bits.reshape(batch), porder.reshape(batch),
            method.reshape(batch), params.reshape(batch + (parts,)))


rice_scan.launches = 0


def subframe_bits_from_sums(sums: torch.Tensor, n: int, order, obits,
                            pmin: int, pmax: int, precision: int,
                            is_lpc: bool) -> torch.Tensor:
    """Estimated subframe bits from zigzag sums (K2's or K4's int64
    output) instead of residuals: ``subframe_bits_from_limbs``
    (``flake_tpu/ops/rice.py:280-311``) without the limbs, its scan R1.
    ``sums`` int64 [..., G] with G a multiple of 2^pmax_static; ``order``
    int32 [...]."""
    bits, _, method, _ = rice_scan(sums, order, n, pmin, pmax)
    return _overhead_bits(bits, method, order, obits, precision, is_lpc)


def rice_final_plain(res: torch.Tensor, order: torch.Tensor, n: int,
                     pmin: int, pmax: int) -> dict:
    """The partition search and exact Rice bits of a residual ``res``
    int32 [..., n] under its ``order`` int32 [...]: the body of
    ``calc_rice_params_dynamic`` (``flake_tpu/ops/rice.py:314-376``), the
    plain version of R2's first design and the search in
    :func:`final_pass_plain`."""
    pmax_static = limit_max_partition_order(pmax, n, 1)
    parts_max = 1 << pmax_static
    psize = n >> pmax_static
    valid = torch.arange(n, device=res.device) \
        >= order[..., None].to(torch.int64)
    z32 = torch.where(valid, zigzag_u32(res), 0)

    levels = [None] * (pmax_static + 1)
    levels[pmax_static] = _partition_sums(z32, parts_max, psize)
    _fold_pyramid(levels, pmax_static)
    bits, porder, method, params, kgrid = _dynamic_porder_scan(
        levels, n, order, pmin, pmax, pmax_static, want_kgrid=True)

    k_samp = kgrid.to(torch.int64).repeat_interleave(psize, dim=-1)
    quotient = (z32 >> k_samp).sum(dim=-1)        # warm-up already 0
    ovh = torch.where(valid, 1 + k_samp, 0).sum(dim=-1)
    parts_dyn = 1 << porder.to(torch.int64)
    return {
        "bits": bits,
        "porder": porder,
        "method": method,
        "params": params,
        # residual-section bits excluding the 2+4 method/porder fields
        "exact_rice_bits": quotient + ovh
        + (4 + method.to(torch.int64)) * parts_dyn,
    }


# threads a block of R2 (csrc/rice.cu also takes 128 and 512)
FINAL_THREADS = 256


def final_pass_plain(smp: torch.Tensor, coefs: torch.Tensor,
                     shift: torch.Tensor, order: torch.Tensor, n: int,
                     pmin: int, pmax: int) -> dict:
    """R2's plain version: the exact residual
    (:func:`~flake_tpu_torch.ops.predict.residual_lpc_dynamic64`), wrapped to
    int32, its fit check (:func:`~flake_tpu_torch.ops.predict.fits_int32`)
    and :func:`rice_final_plain` on the wrapped residual."""
    res64 = predict.residual_lpc_dynamic64(smp, coefs, shift, order,
                                           coefs.shape[-1])
    res = wrap_int32(res64)
    return {**rice_final_plain(res, order, n, pmin, pmax), "residual": res,
            "fits": predict.fits_int32(res64)}


def final_pass(smp: torch.Tensor, coefs: torch.Tensor, shift: torch.Tensor,
               order: torch.Tensor, n: int, pmin: int, pmax: int) -> dict:
    """The final pass (R2): each stream's residual under its selected
    predictor and the partition search and exact Rice bits of it.
    ``smp`` int32 [..., n], ``coefs`` int32 [..., taps] (taps <= 32; those
    at j >= order add nothing), ``shift`` and ``order`` int32 [...]; the
    FIXED predictors pass their binomial coefficients with shift 0.
    Returns :func:`rice_final_plain`'s dict with ``residual`` (int32 [...,
    n], wrapped, warm-up samples passed through) and ``fits`` (bool [...]:
    every exact residual fits int32). A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel (``csrc/rice.cu``)."""
    if smp.device.type == "cpu":
        return final_pass_plain(smp, coefs, shift, order, n, pmin, pmax)
    if smp.device.type != "cuda":
        raise ValueError(f"final_pass: no kernel for {smp.device}")
    batch = smp.shape[:-1]
    N = batch.numel()
    taps = coefs.shape[-1]
    if taps > P.MAX_LPC_ORDER:
        raise ValueError(f"final_pass: {taps} taps, the kernel takes "
                         f"{P.MAX_LPC_ORDER}")
    parts = 1 << limit_max_partition_order(pmax, n, 1)
    dev = smp.device
    smp = smp.reshape(N, n).contiguous()
    coefs = coefs.reshape(N, taps).contiguous()
    shift = shift.reshape(N).contiguous()
    order = order.reshape(N).contiguous()
    _cuda.check(smp, "smp", torch.int32, (N, n), dev)
    _cuda.check(coefs, "coefs", torch.int32, (N, taps), dev)
    _cuda.check(shift, "shift", torch.int32, (N,), dev)
    _cuda.check(order, "order", torch.int32, (N,), dev)
    out = {"bits": torch.empty(N, dtype=torch.int64, device=dev),
           "porder": torch.empty(N, dtype=torch.int32, device=dev),
           "method": torch.empty(N, dtype=torch.int32, device=dev),
           "params": torch.empty((N, parts), dtype=torch.int32, device=dev),
           "exact_rice_bits": torch.empty(N, dtype=torch.int64, device=dev),
           "residual": torch.empty((N, n), dtype=torch.int32, device=dev),
           "fits": torch.empty(N, dtype=torch.bool, device=dev)}
    if N:
        _cuda.launch("flake_final_pass", dev, smp, coefs, shift, order,
                     out["residual"], out["fits"], out["bits"], out["porder"],
                     out["method"], out["params"], out["exact_rice_bits"], N,
                     taps, *_search_args(n, pmin, pmax), FINAL_THREADS)
        final_pass.launches += 1
    return {k: v.reshape(batch + v.shape[1:]) for k, v in out.items()}


final_pass.launches = 0


def subframe_bits(res: torch.Tensor, n: int, order: int, obits,
                  pmin: int, pmax: int, precision: int,
                  is_lpc: bool) -> torch.Tensor:
    """Estimated subframe bits for one static order (rice.c:157-171)."""
    bits, method = calc_rice_params(res, n, order, pmin, pmax)
    return _overhead_bits(bits, method, order, obits, precision, is_lpc)


def fixed_search_plain(chans: torch.Tensor, obits: torch.Tensor, min_o: int,
                       max_o: int, pmin: int, pmax: int):
    """X's plain version: the FIXED order loop of the analysis
    (optimize.c:167-190, ``flake_tpu/ops/frame.py:323-336``): each order
    ``min_o..max_o`` (<= 4)'s residual and static Rice search
    (:func:`subframe_bits`), ascending with strict <. ``chans`` int32 [...,
    n], ``obits`` int32 [...]. Returns (order int32 [...], its predictor's
    coefficients int32 [..., max_o], :func:`predict.fixed_coefs`)."""
    n = chans.shape[-1]
    best_bits = best_order = None
    for o in range(min_o, max_o + 1):
        bits = subframe_bits(predict.residual_fixed(chans, o), n, o, obits,
                             pmin, pmax, 0, False)
        if best_bits is None:
            best_bits = bits
            best_order = torch.full(bits.shape, o, dtype=torch.int32,
                                    device=chans.device)
        else:
            take = bits < best_bits
            best_bits = torch.where(take, bits, best_bits)
            best_order = torch.where(take, o, best_order)
    return best_order, predict.fixed_coefs(best_order, max_o)


def fixed_search(chans: torch.Tensor, obits: torch.Tensor, min_o: int,
                 max_o: int, pmin: int, pmax: int):
    """:func:`fixed_search_plain`'s function. A CPU tensor takes the plain
    version; a CUDA tensor launches X (``csrc/rice.cu``), one block a
    stream, whose order and coefficients equal the plain version's."""
    if chans.device.type == "cpu":
        return fixed_search_plain(chans, obits, min_o, max_o, pmin, pmax)
    if chans.device.type != "cuda":
        raise ValueError(f"fixed_search: no kernel for {chans.device}")
    batch = chans.shape[:-1]
    n = chans.shape[-1]
    if not 0 <= min_o <= max_o <= 4 or n <= max_o:
        raise ValueError(f"fixed_search: orders {min_o}-{max_o} on {n} "
                         "samples; the kernel takes 0 <= min <= max <= 4, "
                         "max < n")
    N = batch.numel()
    dev = chans.device
    chans = chans.reshape(N, n).contiguous()
    obits = obits.reshape(N).contiguous()
    _cuda.check(chans, "chans", torch.int32, (N, n), dev)
    _cuda.check(obits, "obits", torch.int32, (N,), dev)
    order = torch.empty(N, dtype=torch.int32, device=dev)
    coefs = torch.empty((N, max_o), dtype=torch.int32, device=dev)
    if N:
        _cuda.launch("flake_fixed_search", dev, chans, obits, order, coefs,
                     N, n, min_o, max_o, max_o,
                     *_search_args(n, pmin, pmax)[1:])
        fixed_search.launches += 1
    return order.reshape(batch), coefs.reshape(batch + (max_o,))


fixed_search.launches = 0
