"""The plain reference of one batch of the device pipeline, on the CPU.

It works out, from a batch's samples and frame headers alone, what the
port's ``graft_entry.pipeline_step`` returns for the batch: each frame's
analysis (stereo mode, wasted bits, LPC or FIXED prediction, order
selection, Rice partitions, exact sizes, the verbatim fallback) as
``frame_bytes``, and the frame's FLAC bytes as big-endian 32-bit
``words`` (CRC-8 and CRC-16 left as zero placeholders) with their
``total_bits``.

Every function is a frozen copy, in plain PyTorch on CPU tensors, of the
formulation that the port keeps beside each of its kernels (its
``*_plain`` functions), as named in each docstring; the sources are
under ``flake_tpu_torch/`` (``params.py``, ``ops/common.py``,
``ops/rice.py``, ``ops/predict.py``, ``ops/lpc.py``, ``ops/stereo.py``,
``ops/wasted.py``, ``ops/sweep.py``, ``ops/frame.py``,
``ops/bitpack.py``, ``ops/bitmerge.py``), and through them the reference
encoder's C (``libflake``). The copies are frozen so that a later change
to the program cannot move the yardstick. Nothing here imports the
program, JAX or the JAX package, and nothing takes a table the program
made.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# -- FLAC constants (params.py) --------------------------------------------

MAX_LPC_ORDER = 32
LPC_PRECISION = 15
MAX_RICE_PARAM_4BIT = 14
MAX_RICE_PARAM = 30
MAX_PARTITION_ORDER = 8
U32_MASK = 0xFFFFFFFF

# order methods (flake.h:38-46), stereo methods, prediction types
MAX, EST, LEVEL2, LEVEL4, LEVEL8, SEARCH, LOG = range(7)
ORDER_METHODS = {"MAX": MAX, "EST": EST, "LEVEL2": LEVEL2,
                 "LEVEL4": LEVEL4, "LEVEL8": LEVEL8, "SEARCH": SEARCH,
                 "LOG": LOG}
STEREO_METHODS = {"INDEPENDENT": 0, "ESTIMATE": 1}
PREDICTIONS = {"NONE": 0, "FIXED": 1, "LEVINSON": 2}

SF_CONSTANT, SF_VERBATIM, SF_FIXED, SF_LPC = 0, 1, 8, 32
NOT_STEREO, LEFT_RIGHT, LEFT_SIDE, RIGHT_SIDE, MID_SIDE = 0, 1, 8, 9, 10
HDR_SLOTS = 16
LANE = 128

FLAC_SAMPLERATES = (0, 0, 0, 0, 8000, 16000, 22050, 24000, 32000, 44100,
                    48000, 96000, 0, 0, 0, 0)
FLAC_BITDEPTHS = (0, 8, 12, 0, 16, 20, 24, 0)
FLAC_BLOCKSIZES = (0, 192, 576, 1152, 2304, 4608, 0, 0, 256, 512, 1024,
                   2048, 4096, 8192, 16384)


@dataclasses.dataclass(frozen=True)
class Config:
    """The encoding settings of a batch, read from a configuration file
    of ``flakebench/configs`` (``FrameConfig``'s fields)."""

    block_size: int
    channels: int
    bps: int
    sample_rate: int
    prediction_type: int
    order_method: int
    stereo_method: int
    min_prediction_order: int
    max_prediction_order: int
    min_partition_order: int
    max_partition_order: int
    precision: int = LPC_PRECISION
    lpc_dtype: str = "float64"

    @classmethod
    def from_file(cls, cfg: dict) -> "Config":
        return cls(
            block_size=int(cfg["block_size"]), channels=int(cfg["channels"]),
            bps=int(cfg["bits_per_sample"]),
            sample_rate=int(cfg["sample_rate"]),
            prediction_type=PREDICTIONS[cfg["prediction_type"]],
            order_method=ORDER_METHODS[cfg["order_method"]],
            stereo_method=STEREO_METHODS[cfg["stereo_method"]],
            min_prediction_order=int(cfg["min_prediction_order"]),
            max_prediction_order=int(cfg["max_prediction_order"]),
            min_partition_order=int(cfg["min_partition_order"]),
            max_partition_order=int(cfg["max_partition_order"]),
            precision=int(cfg.get("precision", LPC_PRECISION)),
            lpc_dtype=cfg.get("lpc_dtype", "float64"))


def blocksize_code(block_size: int) -> tuple[int, int]:
    """params.blocksize_code (encode.c:503-520)."""
    for i in range(15):
        if block_size == FLAC_BLOCKSIZES[i]:
            return i, -1
    if block_size <= 256:
        return 6, block_size - 1
    return 7, block_size - 1


def samplerate_code(sample_rate: int) -> tuple[int, int]:
    """params.samplerate_code (encode.c:400-422)."""
    for i in range(4, 12):
        if sample_rate == FLAC_SAMPLERATES[i]:
            return i, 0
    if sample_rate % 1000 == 0 and sample_rate <= 255000:
        return 12, sample_rate // 1000
    if sample_rate % 10 == 0 and sample_rate <= 655350:
        return 14, sample_rate // 10
    if sample_rate < 65535:
        return 13, sample_rate
    return 0, 0


def bps_code(bits_per_sample: int) -> int:
    """params.bps_code (encode.c:424-434)."""
    for i in range(1, 8):
        if bits_per_sample == FLAC_BITDEPTHS[i]:
            return i
    return 0


def max_frame_size(block_size: int, channels: int, bps: int) -> int:
    """params.max_frame_size (encode.c:446-450, 522-527)."""
    if channels == 2:
        return 16 + ((block_size * (bps + bps + 1) + 7) >> 3)
    return 16 + ((block_size * channels * bps + 7) >> 3)


def frame_header_bytes(nums: np.ndarray, cfg: Config):
    """bitpack.frame_header_bytes (encode.c:718-764) for frames numbered
    ``nums``, fixed block size: the header without its channel and depth
    byte (set from the analysis) and with a zero CRC-8. Returns (bytes
    uint8 [F, 16], nbytes int32 [F])."""
    bs_code = blocksize_code(cfg.block_size)
    sr_code = samplerate_code(cfg.sample_rate)
    F = nums.shape[0]
    out = np.zeros((F, HDR_SLOTS), dtype=np.uint8)
    nbytes = np.zeros(F, dtype=np.int32)
    for f in range(F):
        b = bytearray([0xFF, 0xF8, ((bs_code[0] & 0xF) << 4)
                       | (sr_code[0] & 0xF), 0])
        val = int(nums[f])
        if val < 0x80:
            b.append(val)
        else:
            lg = val.bit_length() - 1
            nb = (lg + 4) // 5
            shift = (nb - 1) * 6
            b.append((256 - (256 >> nb)) | (val >> shift))
            while shift >= 6:
                shift -= 6
                b.append(0x80 | ((val >> shift) & 0x3F))
        if bs_code[1] >= 0:
            if bs_code[1] < 256:
                b.append(bs_code[1])
            else:
                b += bytes([bs_code[1] >> 8, bs_code[1] & 0xFF])
        if sr_code[1] > 0:
            if sr_code[1] < 256:
                b.append(sr_code[1])
            else:
                b += bytes([sr_code[1] >> 8, sr_code[1] & 0xFF])
        b.append(0)
        out[f, :len(b)] = b
        nbytes[f] = len(b)
    return out, nbytes


# -- integer helpers (ops/common.py) ----------------------------------------

def u32(x):
    return x & U32_MASK


def wrap_int32(x):
    return (((x + (1 << 31)) & U32_MASK) - (1 << 31)).to(torch.int32)


def ctz32(x):
    x = x.to(torch.int64) & U32_MASK
    low = x & -x
    r = torch.zeros_like(x)
    for bits, mask in ((16, 0x0000FFFF), (8, 0x00FF00FF),
                       (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        r = r + bits * ((low & mask) == 0).to(torch.int64)
    return torch.where(x == 0, 0, r).to(torch.int32)


# -- Rice search (ops/rice.py: the plain versions) --------------------------

def log2i(v: int) -> int:
    return v.bit_length() - 1 if v > 0 else 0


def limit_max_partition_order(max_porder: int, n: int, order: int) -> int:
    porder = min(max_porder, log2i(n ^ (n - 1)))
    if order > 0:
        porder = min(porder, log2i(n // order))
    return porder


def zigzag_u32(res):
    d = res.to(torch.int64)
    return ((2 * d) ^ (d >> 63)) & U32_MASK


def _rice_count(sums, cnt, ks):
    return u32(cnt * (ks + 1) + ((sums - (cnt >> 1)) >> ks))


def _first_min(nbits):
    best, k_opt = torch.min(nbits, dim=-1)
    return k_opt.to(torch.int32), best


def find_optimal_k(sums, cnt: int):
    ks = torch.arange(MAX_RICE_PARAM + 1, dtype=torch.int64)
    return _first_min(_rice_count(sums[..., None], cnt, ks))


def find_optimal_k_u32(sums, cnt):
    ks = torch.arange(MAX_RICE_PARAM + 1, dtype=torch.int64)
    if isinstance(cnt, int):
        cnt2, cnt32 = (cnt >> 1) & U32_MASK, cnt & U32_MASK
    else:
        cnt2 = (cnt >> 1) & U32_MASK
        cnt32 = (cnt & U32_MASK)[..., None]
    t = (sums - cnt2)[..., None]
    return _first_min(u32(cnt32 * (ks + 1) + ((t >> ks) & U32_MASK)))


def _partition_sums(z, parts: int, psize: int):
    return z.reshape(z.shape[:-1] + (parts, psize)).sum(dim=-1)


def _fold_pyramid(levels: list, pmax_static: int) -> list:
    for p in range(pmax_static - 1, -1, -1):
        prev = levels[p + 1]
        levels[p] = prev[..., 0::2] + prev[..., 1::2]
    return levels


def calc_rice_params(res, n: int, order: int, pmin: int, pmax: int):
    """rice.calc_rice_params: the static search of one order (FIXED)."""
    pmin = limit_max_partition_order(pmin, n, order)
    pmax = limit_max_partition_order(pmax, n, order)
    z = zigzag_u32(res)
    if order > 0:
        z = torch.where(torch.arange(n) >= order, z, 0)
    sums = [None] * (pmax + 1)
    sums[pmax] = _partition_sums(z, 1 << pmax, n >> pmax)
    _fold_pyramid(sums, pmax)
    best = None
    for p in range(pmin, pmax + 1):
        parts = 1 << p
        cnts = torch.full((parts,), n >> p, dtype=torch.int64)
        cnts[0] = (n >> p) - order
        k, kb = find_optimal_k_u32(sums[p], cnts)
        bits = u32(kb.sum(dim=-1) + 4 * parts)
        method = (k > MAX_RICE_PARAM_4BIT).any(dim=-1).to(torch.int32)
        if best is None:
            best = (bits, method)
            continue
        take = bits <= best[0]
        best = (torch.where(take, bits, best[0]),
                torch.where(take, method, best[1]))
    return best


def _ilog2(x):
    r = torch.zeros_like(x)
    v = x
    for s in (32, 16, 8, 4, 2, 1):
        big = v >= (1 << s)
        r = torch.where(big, r + s, r)
        v = torch.where(big, v >> s, v)
    return r.to(torch.int32)


def _dynamic_porder_scan(sums: list, n: int, order, pmin: int, pmax: int,
                         pmax_static: int, want_kgrid: bool = False):
    """rice._dynamic_porder_scan (rice.c:105-164): the partition-order
    scan with a per-element predictor order, ties to the higher order."""
    batch = order.shape
    ub = log2i(n ^ (n - 1))
    log2_no = _ilog2(n // torch.clamp(order.to(torch.int64), min=1))
    pmax_eff = torch.minimum(torch.full_like(log2_no, min(pmax, ub)),
                             torch.where(order > 0, log2_no, pmax))
    pmin_eff = torch.minimum(torch.full_like(log2_no, min(pmin, ub)),
                             torch.where(order > 0, log2_no, pmin))
    parts_max = 1 << pmax_static
    best_bits = torch.full(batch, U32_MASK, dtype=torch.int64)
    best_porder = torch.zeros(batch, dtype=torch.int32)
    best_method = torch.zeros(batch, dtype=torch.int32)
    best_params = torch.zeros(batch + (parts_max,), dtype=torch.int32)
    best_kgrid = best_params.clone() if want_kgrid else None
    order64 = order.to(torch.int64)
    for p in range(pmax_static + 1):
        parts = 1 << p
        cnts = torch.full(batch + (parts,), n >> p, dtype=torch.int64)
        cnts[..., 0] = (n >> p) - order64
        k, kb = find_optimal_k_u32(sums[p], cnts)
        bits = u32(kb.sum(dim=-1) + 4 * parts)
        method = (k > MAX_RICE_PARAM_4BIT).any(dim=-1).to(torch.int32)
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
    o64 = order.to(torch.int64) if torch.is_tensor(order) else order
    ob64 = obits.to(torch.int64) if torch.is_tensor(obits) else obits
    overhead = o64 * ob64 + 2
    if is_lpc:
        overhead = overhead + (4 + 5 + o64 * precision)
    return u32(bits + overhead + method.to(torch.int64) + 4)


def rice_scan(sums, order, n: int, pmin: int, pmax: int):
    """rice.rice_scan_plain (R1's plain version)."""
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


def rice_final(res, order, n: int, pmin: int, pmax: int) -> dict:
    """rice.rice_final_plain: the search and exact Rice bits of a
    residual under its order."""
    pmax_static = limit_max_partition_order(pmax, n, 1)
    parts_max = 1 << pmax_static
    psize = n >> pmax_static
    valid = torch.arange(n) >= order[..., None].to(torch.int64)
    z32 = torch.where(valid, zigzag_u32(res), 0)
    levels = [None] * (pmax_static + 1)
    levels[pmax_static] = _partition_sums(z32, parts_max, psize)
    _fold_pyramid(levels, pmax_static)
    bits, porder, method, params, kgrid = _dynamic_porder_scan(
        levels, n, order, pmin, pmax, pmax_static, want_kgrid=True)
    k_samp = kgrid.to(torch.int64).repeat_interleave(psize, dim=-1)
    quotient = (z32 >> k_samp).sum(dim=-1)
    ovh = torch.where(valid, 1 + k_samp, 0).sum(dim=-1)
    parts_dyn = 1 << porder.to(torch.int64)
    return {"bits": bits, "porder": porder, "method": method,
            "params": params,
            "exact_rice_bits": quotient + ovh
            + (4 + method.to(torch.int64)) * parts_dyn}


# -- residuals (ops/predict.py) ---------------------------------------------

FIXED_COEFS = {0: (), 1: (1,), 2: (2, -1), 3: (3, -3, 1),
               4: (4, -6, 4, -1)}


def _lagged(s, j: int, order: int, n: int):
    return s[..., order - 1 - j:n - 1 - j]


def residual_fixed(smp, order: int):
    n = smp.shape[-1]
    if order == 0:
        return smp
    s = smp.to(torch.int64)
    pred = torch.zeros_like(s[..., order:])
    for j, c in enumerate(FIXED_COEFS[order]):
        pred = pred + c * _lagged(s, j, order, n)
    return torch.cat([smp[..., :order], wrap_int32(s[..., order:] - pred)],
                     dim=-1)


def fixed_coefs(order, max_order: int):
    table = torch.tensor([list(FIXED_COEFS[o]) + [0] * (max_order - o)
                          for o in range(max_order + 1)],
                         dtype=torch.int32).reshape(max_order + 1, max_order)
    return table[order.long()]


def fits_int32(res64):
    return ((res64 >= -(1 << 31)) & (res64 < (1 << 31))).all(dim=-1)


def residual_lpc(smp, coefs, shift, order: int):
    n = smp.shape[-1]
    s = smp.to(torch.int64)
    pred = torch.zeros_like(s[..., order:])
    for j in range(order):
        pred = pred + coefs[..., j, None].to(torch.int64) \
            * _lagged(s, j, order, n)
    pred = pred >> shift[..., None].to(torch.int64)
    return torch.cat([smp[..., :order], wrap_int32(s[..., order:] - pred)],
                     dim=-1)


def residual_lpc_dynamic64(smp, coefs, shift, order, max_order: int):
    n = smp.shape[-1]
    s = smp.to(torch.int64)
    order_b = order[..., None].to(torch.int64)
    pred = torch.zeros_like(s)
    for j in range(max_order):
        lag = torch.nn.functional.pad(s, (j + 1, 0))[..., :n]
        tap = torch.where(j < order_b, coefs[..., j, None].to(torch.int64),
                          0)
        pred = pred + tap * lag
    pred = pred >> shift[..., None].to(torch.int64)
    return torch.where(torch.arange(n) < order_b, s, s - pred)


def final_pass(smp, coefs, shift, order, n: int, pmin: int, pmax: int):
    """rice.final_pass_plain (R2's plain version)."""
    res64 = residual_lpc_dynamic64(smp, coefs, shift, order,
                                   coefs.shape[-1])
    res = wrap_int32(res64)
    return {**rice_final(res, order, n, pmin, pmax), "residual": res,
            "fits": fits_int32(res64)}


def subframe_bits(res, n: int, order: int, obits, pmin: int, pmax: int,
                  precision: int, is_lpc: bool):
    bits, method = calc_rice_params(res, n, order, pmin, pmax)
    return _overhead_bits(bits, method, order, obits, precision, is_lpc)


def fixed_search(chans, obits, min_o: int, max_o: int, pmin: int,
                 pmax: int):
    """rice.fixed_search_plain (X's plain version)."""
    n = chans.shape[-1]
    best_bits = best_order = None
    for o in range(min_o, max_o + 1):
        bits = subframe_bits(residual_fixed(chans, o), n, o, obits, pmin,
                             pmax, 0, False)
        if best_bits is None:
            best_bits = bits
            best_order = torch.full(bits.shape, o, dtype=torch.int32)
        else:
            take = bits < best_bits
            best_bits = torch.where(take, bits, best_bits)
            best_order = torch.where(take, o, best_order)
    return best_order, fixed_coefs(best_order, max_o)


# -- LPC (ops/lpc.py) -------------------------------------------------------

def welch_window(n: int) -> np.ndarray:
    """lpc.welch_window (lpc.c:28-40)."""
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


def autocorr(x, max_order: int, window):
    """lpc.autocorr (K1's plain version, lpc.c:46-71)."""
    n = x.shape[-1]
    d = x.to(window.dtype) * window
    cols = [(d[..., lag:] * d[..., :max(n - lag, 0)]).sum(dim=-1) + 2.0
            for lag in range(max_order + 1)]
    return torch.stack(cols, dim=-1)


def levinson_all_orders(autoc):
    """lpc.levinson_all_orders (lpc.c:77-117)."""
    max_order = autoc.shape[-1] - 1
    batch = autoc.shape[:-1]
    W = max_order
    tiny = torch.finfo(autoc.dtype).tiny
    zeros = autoc.new_zeros(batch + (W,))
    taps = torch.arange(W)

    def shift_in(vec, head):
        return torch.cat([head[..., None], vec[..., :-1]], dim=-1)

    tmp, rev = zeros, zeros
    ac_rev = shift_in(zeros, autoc[..., 0])
    err = autoc[..., 0]
    rows, refs = [], []
    for i in range(max_order):
        a_next = autoc[..., i + 1]
        prods = tmp * ac_rev
        acc = torch.zeros_like(a_next)
        for j in range(i):
            acc = acc + prods[..., j]
        r = -a_next - acc
        r = r / torch.where(err == 0.0, tiny, err)
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


def schur_refs(autoc):
    """lpc.schur_refs (lpc.c:136-147)."""
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


def levinson_from_refs(refs):
    """lpc.levinson_from_refs (lpc.c:77-117, the ``ref`` branch)."""
    m = refs.shape[-1]
    taps = torch.arange(m)
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


def estimate_order(refs, max_order: int):
    """lpc.estimate_order (lpc.c:149-156)."""
    idx = torch.arange(1, max_order + 1, dtype=torch.int32)
    above = torch.where(refs.abs() > 0.10, idx, 0)
    return above.amax(dim=-1).clamp_min(1)


def _exp2i(s, dtype):
    if dtype == torch.float32:
        s = s.to(torch.int32).clamp(-126, 128)
        return ((s + 127) << 23).view(torch.float32)
    return ((s.to(torch.int64) + 1023) << 52).view(torch.float64)


def quantize_lpc_coefs(lpc, precision: int):
    """lpc.quantize_lpc_coefs (lpc.c:167-219)."""
    n_orders, W = lpc.shape[-2], lpc.shape[-1]
    qmax = (1 << (precision - 1)) - 1
    taps = torch.arange(W)
    valid = taps[None, :] < torch.arange(1, n_orders + 1)[:, None]
    cmax = torch.where(valid, lpc.abs(), 0.0).amax(dim=-1)
    zero_out = cmax * (1 << 15) < 1.0
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
        qs.append(torch.where(q.isnan(), 0.0, q).to(torch.int32))
    coefs = torch.stack(qs, dim=-1)
    coefs = torch.where(zero_out[..., None], 0, coefs)
    shift = torch.where(zero_out, 0, sh).to(torch.int32)
    return coefs, shift


def candidates(autoc, est: bool, precision: int):
    """lpc.candidates_plain (L's plain version)."""
    if est:
        refs = schur_refs(autoc)
        rows = levinson_from_refs(refs)
    else:
        rows, refs = levinson_all_orders(autoc)
    qcoefs, shifts = quantize_lpc_coefs(rows, precision)
    return qcoefs, shifts, refs


# -- stereo and wasted bits (ops/stereo.py, ops/wasted.py) ------------------

def decorr_mode(left, right, n: int):
    """stereo.decorr_mode (encode.c:598-643)."""
    l64 = left.to(torch.int64)
    r64 = right.to(torch.int64)
    lt = l64[..., 2:] - 2 * l64[..., 1:-1] + l64[..., :-2]
    rt = r64[..., 2:] - 2 * r64[..., 1:-1] + r64[..., :-2]
    sums = torch.stack([lt.abs().sum(dim=-1), rt.abs().sum(dim=-1),
                        ((lt + rt) >> 1).abs().sum(dim=-1),
                        (lt - rt).abs().sum(dim=-1)], dim=-1) * 2
    k, _ = find_optimal_k(sums, n)
    est = _rice_count(sums, n, k.to(torch.int64))
    score = torch.stack([est[..., 0] + est[..., 1], est[..., 0] + est[..., 3],
                         est[..., 1] + est[..., 3], est[..., 2] + est[..., 3]],
                        dim=-1)
    best = torch.min(score, dim=-1).indices
    return torch.where(best == 0, LEFT_RIGHT,
                       torch.where(best == 1, LEFT_SIDE,
                                   torch.where(best == 2, RIGHT_SIDE,
                                               MID_SIDE))).to(torch.int32)


def apply_decorr(left, right, mode):
    """stereo.apply_decorr (encode.c:673-693)."""
    l64 = left.to(torch.int64)
    r64 = right.to(torch.int64)
    mid = ((l64 + r64) >> 1).to(torch.int32)
    side = wrap_int32(l64 - r64)
    m = mode[..., None]
    ch0 = torch.where(m == MID_SIDE, mid,
                      torch.where(m == RIGHT_SIDE, side, left))
    ch1 = torch.where((m == MID_SIDE) | (m == LEFT_SIDE), side, right)
    extra0 = (mode == RIGHT_SIDE).to(torch.int32)
    extra1 = ((mode == MID_SIDE) | (mode == LEFT_SIDE)).to(torch.int32)
    return ch0, ch1, torch.stack([extra0, extra1], dim=-1)


def remove_wasted_bits(samples, bps: int):
    """wasted.remove_wasted_bits (encode.c:558-593)."""
    tz = torch.where(samples != 0, ctz32(samples), 32).amin(dim=-1)
    wasted = torch.where(tz == 32, bps - 1, torch.clamp(tz, max=bps - 1))
    wasted = torch.where(wasted == bps - 1, 0, wasted).to(torch.int32)
    return samples >> wasted[..., None], wasted


# -- the analysis (ops/frame.py) --------------------------------------------

def _select_order_log(bits_all, min_order: int, max_order: int):
    """frame._select_order_log (optimize.c:239-261)."""
    batch = bits_all.shape[:-1]
    opt = torch.full(batch, min_order - 1 + (max_order - min_order) // 3,
                     dtype=torch.int64)
    visited = torch.zeros(batch + (max_order,), dtype=torch.bool)

    def at(t, i):
        idx = i.clamp(0, max_order - 1)[..., None]
        return torch.gather(t, -1, idx)[..., 0]

    for step in (16, 8, 4, 2, 1):
        last = opt
        for d in (-step, 0, step):
            i = last + d
            in_range = (i >= min_order - 1) & (i < max_order)
            fresh = in_range & ~at(visited, i)
            opt_bits = torch.where(at(visited, opt), at(bits_all, opt),
                                   U32_MASK)
            better = fresh & (at(bits_all, i) < opt_bits)
            visited = visited.scatter(
                -1, i.clamp(0, max_order - 1)[..., None],
                (fresh | at(visited, i))[..., None])
            opt = torch.where(better, i, opt)
    return (opt + 1).to(torch.int32)


def _select_order_level(bits_all, cand: list):
    """frame._select_order_level (optimize.c:202-223)."""
    best_bits = bits_all[..., cand[0]]
    best_order = torch.full_like(best_bits, cand[0], dtype=torch.int32)
    for o in cand[1:]:
        take = bits_all[..., o] < best_bits
        best_bits = torch.where(take, bits_all[..., o], best_bits)
        best_order = torch.where(take, o, best_order)
    return best_order + 1


def select_order_bits(bits_all, method: int, min_o: int, max_o: int):
    """frame.select_order_bits_plain (S's plain version, without the
    gather)."""
    if method in (LEVEL2, LEVEL4, LEVEL8):
        levels = 1 << (method - 1)
        cand = [max(min_o + ((max_o - min_o + 1) * (i + 1)) // levels - 2, 0)
                for i in range(levels - 1, -1, -1)]
        return _select_order_level(bits_all, cand)
    if method == SEARCH:
        return (torch.argmin(bits_all[..., :max_o], dim=-1) + 1) \
            .to(torch.int32)
    if method == LOG:
        return _select_order_log(bits_all, min_o, max_o)
    raise ValueError(f"bad order method {method}")


def select_candidate(bits_all, refs, qcoefs, shifts, method: int,
                     min_o: int, max_o: int):
    """frame.select_candidate_plain (S's plain version with the gather)."""
    batch = qcoefs.shape[:-2]
    if method == MAX:
        order = torch.full(batch, max_o, dtype=torch.int32)
    elif method == EST:
        order = estimate_order(refs, max_o)
    else:
        order = select_order_bits(bits_all, method, min_o, max_o)
    sel = (order.to(torch.int64) - 1).clamp(0, max_o - 1)
    coefs = torch.gather(qcoefs, -2, sel[..., None, None].expand(
        batch + (1, max_o)))[..., 0, :]
    shift = torch.gather(shifts, -1, sel[..., None])[..., 0]
    coefs = torch.nn.functional.pad(coefs, (0, MAX_LPC_ORDER - max_o))
    return order, coefs, shift


def frame_head(samples, cfg: Config):
    """frame.frame_head_plain (H's plain version): stereo mode and
    decorrelation, wasted bits, constant flags."""
    n, C = cfg.block_size, cfg.channels
    F = samples.shape[0]
    chans = samples.permute(0, 2, 1)
    obits = torch.full((F, C), cfg.bps, dtype=torch.int32)
    if C == 2 and n > 32 and cfg.stereo_method == 1:
        mode = decorr_mode(chans[:, 0], chans[:, 1], n)
        if cfg.bps >= 32:
            over = (chans[:, 0].to(torch.int64)
                    - chans[:, 1].to(torch.int64)).abs().amax(dim=-1) \
                >= (1 << 31)
            mode = torch.where(over, LEFT_RIGHT, mode)
        ch0, ch1, extra = apply_decorr(chans[:, 0], chans[:, 1], mode)
        chans = torch.stack([ch0, ch1], dim=1)
        obits = obits + extra
    elif C == 2:
        mode = torch.full((F,), LEFT_RIGHT, dtype=torch.int32)
    else:
        mode = torch.full((F,), NOT_STEREO, dtype=torch.int32)
    chans, wasted_bits = remove_wasted_bits(chans, cfg.bps)
    obits = obits - wasted_bits
    constant = (chans == chans[..., :1]).all(dim=-1)
    return chans, obits, wasted_bits, mode, constant


def finalize_analysis(cfg: Config, chans, obits, wasted_bits, constant,
                      mode, sf_type, order, coefs, shift, res, rc, hdr_bits,
                      unfit=None) -> dict:
    """frame.finalize_analysis: the CONSTANT override, exact sizes, the
    verbatim fallback (encode.c:949-964) and the type codes."""
    n = cfg.block_size
    C = sf_type.shape[1]
    i64 = torch.int64
    sf_type = torch.where(constant, SF_CONSTANT, sf_type)
    order = torch.where(constant, 0, order)
    res = torch.where(constant[..., None], chans, res)
    ob64 = obits.to(i64)
    sub_hdr = 8 + wasted_bits.to(i64)
    exact_rice = rc.get("exact_rice_bits", 0)
    o64 = order.to(i64)
    body = torch.where(
        sf_type == SF_CONSTANT, ob64,
        torch.where(sf_type == SF_VERBATIM, n * ob64,
                    torch.where(sf_type == SF_FIXED,
                                o64 * ob64 + 6 + exact_rice,
                                o64 * ob64 + 9 + o64 * cfg.precision
                                + 6 + exact_rice)))
    total_bits = hdr_bits.to(i64) + (sub_hdr + body).sum(dim=-1)
    frame_bytes = ((total_bits + 7) >> 3) + 2
    vsize = max_frame_size(n, C, cfg.bps)
    if unfit is not None:
        unfit = unfit & (sf_type != SF_CONSTANT) \
            & ~(frame_bytes > vsize)[..., None]
        sf_type = torch.where(unfit, SF_VERBATIM, sf_type)
        order = torch.where(unfit, 0, order)
        res = torch.where(unfit[..., None], chans, res)
        total_bits = hdr_bits.to(i64) + (
            sub_hdr + torch.where(unfit, n * ob64, body)).sum(dim=-1)
        frame_bytes = ((total_bits + 7) >> 3) + 2
    fb = frame_bytes > vsize
    sf_type = torch.where(fb[..., None], SF_VERBATIM, sf_type)
    order = torch.where(fb[..., None], 0, order)
    res = torch.where(fb[..., None, None], chans, res)
    vb_total = hdr_bits.to(i64) + (sub_hdr + n * ob64).sum(dim=-1)
    frame_bytes = torch.where(fb, ((vb_total + 7) >> 3) + 2, frame_bytes)
    type_code = torch.where(
        sf_type == SF_FIXED, SF_FIXED + order,
        torch.where(sf_type == SF_LPC, SF_LPC + order - 1, sf_type))
    i32 = torch.int32
    return {"ch_mode": mode.to(i32), "obits": obits.to(i32),
            "wasted": wasted_bits.to(i32), "sf_type": sf_type.to(i32),
            "type_code": type_code.to(i32), "order": order.to(i32),
            "coefs": coefs.to(i32), "shift": shift.to(i32),
            "porder": rc["porder"].to(i32), "method": rc["method"].to(i32),
            "rice_params": rc["params"].to(i32), "residual": res.to(i32),
            "frame_bytes": frame_bytes}


def _lpc_search(cfg: Config, chans, obits):
    """frame._lpc_search with the plain stages: autocorrelation,
    candidates, the candidate orders' partition sums and Rice scan, the
    selection, the final pass."""
    F, C, n = chans.shape
    N = F * C
    max_o = cfg.max_prediction_order
    cN = chans.reshape(N, n)
    obitsN = obits.reshape(N)
    dtype = torch.float64 if cfg.lpc_dtype == "float64" else torch.float32
    window = torch.from_numpy(welch_window(n)).to(dtype)
    autoc = autocorr(cN, max_o, window)
    qcoefs, shifts, refs = candidates(autoc, cfg.order_method == EST,
                                      cfg.precision)
    bits_all = None
    if cfg.order_method not in (MAX, EST):
        # ops/sweep._zigzag_sums at the partitions of pmax_static: every
        # order's residual, zigzag with the warm-up zeroed, its sums
        pmax_static = limit_max_partition_order(cfg.max_partition_order, n,
                                                1)
        idx = torch.arange(n)
        sums = []
        for o in range(1, max_o + 1):
            r = residual_lpc(cN, qcoefs[:, o - 1, :], shifts[:, o - 1], o)
            z = torch.where(idx >= o, zigzag_u32(r), 0)
            sums.append(_partition_sums(z, 1 << pmax_static,
                                        n >> pmax_static))
        sums = torch.stack(sums, dim=1)
        o_arr = torch.arange(1, max_o + 1, dtype=torch.int32).expand(N, max_o)
        bits, _, method, _ = rice_scan(sums, o_arr, n,
                                       cfg.min_partition_order,
                                       cfg.max_partition_order)
        bits_all = _overhead_bits(bits, method, o_arr, obitsN[..., None],
                                  cfg.precision, True)
    order, coefs, shift = select_candidate(
        bits_all, refs, qcoefs, shifts, cfg.order_method,
        cfg.min_prediction_order, max_o)
    rc = final_pass(cN, coefs[:, :max_o], shift, order, n,
                    cfg.min_partition_order, cfg.max_partition_order)
    res, fits = rc.pop("residual"), rc.pop("fits")
    return (order.reshape(F, C), coefs.reshape(F, C, MAX_LPC_ORDER),
            shift.reshape(F, C), res.reshape(F, C, n),
            {k: v.reshape((F, C) + v.shape[1:]) for k, v in rc.items()},
            (~fits & (shift > 0)).reshape(F, C))


def analyze_frames(samples, cfg: Config, hdr_bits) -> dict:
    """frame.analyze_frames with the plain stages. ``samples`` int32 [F,
    B, C], ``hdr_bits`` int32 [F]."""
    n, C = cfg.block_size, cfg.channels
    F = samples.shape[0]
    i32 = torch.int32
    chans, obits, wasted_bits, mode, constant = frame_head(samples, cfg)
    pmin, pmax = cfg.min_partition_order, cfg.max_partition_order
    zeros32 = torch.zeros((F, C, MAX_LPC_ORDER), dtype=i32)
    unfit = None
    if n < 5 or cfg.prediction_type == PREDICTIONS["NONE"]:
        order = torch.zeros((F, C), dtype=i32)
        sf_type = torch.full((F, C), SF_VERBATIM, dtype=i32)
        shift = torch.zeros_like(order)
        coefs = zeros32
        res = chans
        rc = {"porder": torch.zeros_like(order),
              "method": torch.zeros_like(order),
              "params": torch.zeros((F, C, 1 << pmax), dtype=i32)}
    elif (cfg.prediction_type == PREDICTIONS["FIXED"]
          or n <= cfg.max_prediction_order):
        order, fcoefs = fixed_search(chans, obits, cfg.min_prediction_order,
                                     min(cfg.max_prediction_order, 4), pmin,
                                     pmax)
        shift = torch.zeros_like(order)
        rc = final_pass(chans, fcoefs, shift, order, n, pmin, pmax)
        res = rc.pop("residual")
        del rc["fits"]
        sf_type = torch.full((F, C), SF_FIXED, dtype=i32)
        coefs = zeros32
    else:
        order, coefs, shift, res, rc, unfit = _lpc_search(cfg, chans, obits)
        sf_type = torch.full((F, C), SF_LPC, dtype=i32)
    return finalize_analysis(cfg, chans, obits, wasted_bits, constant, mode,
                             sf_type, order, coefs, shift, res, rc, hdr_bits,
                             unfit)


# -- the emission (ops/bitpack.py, ops/bitmerge.py) -------------------------

def word_rows(cfg: Config) -> int:
    """bitpack.word_rows: a frame's rows of 128 words."""
    vsize = max_frame_size(cfg.block_size, cfg.channels, cfg.bps)
    return (-(-(vsize + 8) // 512)) * 512 // 512


def _pairs(hi, lo):
    return torch.stack([hi, lo], dim=-1).flatten(-2)


def _low_mask(bits):
    return torch.bitwise_left_shift(-1, bits - 1).bitwise_left_shift_(1) \
        .bitwise_not_()


def slot_layout(analysis: dict, hdr_bytes, hdr_nbytes, cfg: Config):
    """bitpack.slot_layout_plain (E's plain version): each slot's bit
    length, leading zeros and payload, int32 [F, M]."""
    n, C = cfg.block_size, cfg.channels
    i32 = torch.int32
    pmax_static = limit_max_partition_order(cfg.max_partition_order, n, 1)
    G = 1 << pmax_static
    gs = n >> pmax_static
    sf = analysis["sf_type"]
    order = analysis["order"][..., None]
    obits = analysis["obits"][..., None]
    wasted_b = analysis["wasted"][..., None]
    method = analysis["method"][..., None]
    porder = analysis["porder"][..., None]
    res = analysis["residual"]
    F = sf.shape[0]
    zero = torch.zeros((), dtype=i32)
    pred = ((sf == SF_FIXED) | (sf == SF_LPC))[..., None]
    is_lpc = (sf == SF_LPC)[..., None]
    is_verb = (sf == SF_VERBATIM)[..., None]
    wide = cfg.bps + (1 if C == 2 else 0) > 32
    if wide:
        ob_lo = torch.clamp(obits, max=16)
        ob_hi = obits - ob_lo
        lo_mask = (1 << ob_lo) - 1
        hi_mask = (1 << ob_hi) - 1
    else:
        ob_mask = _low_mask(obits)
    j32 = torch.arange(32)
    warm_on = (pred & (j32 < order)) \
        | ((sf == SF_CONSTANT)[..., None] & (j32 == 0))
    w32 = torch.nn.functional.pad(res[..., :32], (0, max(0, 32 - n)))
    if wide:
        warm_len = _pairs(torch.where(warm_on, ob_hi, 0),
                          torch.where(warm_on, ob_lo, 0))
        warm_pay = _pairs(torch.where(warm_on, (w32 >> ob_lo) & hi_mask, 0),
                          torch.where(warm_on, w32 & lo_mask, 0))
    else:
        warm_len = torch.where(warm_on, obits, 0)
        warm_pay = torch.where(warm_on, w32 & ob_mask, 0)
    has_wasted = (wasted_b > 0).to(i32)
    coef_on = is_lpc & (j32 < order)
    fixed_len = torch.cat([
        torch.full_like(order, 8), wasted_b, warm_len,
        torch.where(is_lpc, 9, zero),
        torch.where(coef_on, cfg.precision, zero),
        torch.where(pred, 6, zero)], dim=-1)
    fixed_pay = torch.cat([
        (analysis["type_code"][..., None] << 1) | has_wasted, has_wasted,
        warm_pay,
        torch.where(is_lpc, ((cfg.precision - 1) << 5)
                    | (analysis["shift"][..., None] & 31), zero),
        torch.where(coef_on, analysis["coefs"] & ((1 << cfg.precision) - 1),
                    zero),
        torch.where(pred, (method << 4) | porder, zero)], dim=-1)
    n_fixed = fixed_len.shape[-1]
    spg = 2 * gs if wide else gs
    L = n_fixed + G * (1 + spg)
    M = HDR_SLOTS + C * L + 2
    lengths = torch.empty((F, M), dtype=i32)
    leading = torch.zeros((F, M), dtype=i32)
    payload = torch.empty((F, M), dtype=i32)

    def channels(t):
        return t[:, HDR_SLOTS:HDR_SLOTS + C * L].view(F, C, L)

    def body(t):
        return channels(t)[..., n_fixed:].view(F, C, G, 1 + spg)

    hdr_on = torch.arange(HDR_SLOTS) < hdr_nbytes[:, None]
    torch.mul(hdr_on, 8, out=lengths[:, :HDR_SLOTS])
    payload[:, :HDR_SLOTS] = hdr_bytes
    ch_mode = analysis["ch_mode"]
    payload[:, 3] = (torch.where(ch_mode > 0, ch_mode, C - 1) << 4) \
        | (bps_code(cfg.bps) << 1)
    channels(lengths)[..., :n_fixed] = fixed_len
    channels(payload)[..., :n_fixed] = fixed_pay
    po_shift = pmax_static - porder
    g_idx = torch.arange(G, dtype=i32)
    g_active = pred & ((g_idx & ((1 << po_shift) - 1)) == 0)
    k = torch.gather(analysis["rice_params"][..., :G], -1,
                     (g_idx >> po_shift).long())
    torch.where(g_active, 4 + method, zero, out=body(lengths)[..., 0])
    torch.where(g_active, k, zero, out=body(payload)[..., 0])
    r = res.reshape(F, C, G, gs)
    k = k[..., None]
    e = (k == 0).to(i32)
    sign = r >> 31
    q = torch.bitwise_xor(r, sign)
    q.bitwise_right_shift_(torch.clamp(k - 1, min=0))
    q.clamp_(max=(1 << 24) >> e).bitwise_left_shift_(e)
    q.bitwise_or_(sign & e).clamp_(max=1 << 24)
    pay = (r << 1).bitwise_xor_(sign)
    pay.bitwise_and_((1 << k) - 1).bitwise_or_(1 << k)
    active = torch.arange(n, dtype=i32).view(G, gs) \
        >= torch.where(pred, order, n)[..., None]
    verb_b = is_verb[..., None]
    if wide:
        def samples(t, part):
            return body(t)[..., 1:].view(F, C, G, gs, 2)[..., part]
        torch.where(active, q, zero, out=samples(leading, 0))
        torch.where(active, q.add_(k + 1),
                    torch.where(verb_b, ob_hi[..., None], zero),
                    out=samples(lengths, 0))
        torch.where(active, pay,
                    (r >> ob_lo[..., None])
                    & torch.where(verb_b, hi_mask[..., None], zero),
                    out=samples(payload, 0))
        samples(lengths, 1).copy_(
            torch.where(verb_b, ob_lo[..., None], zero).expand(F, C, G, gs))
        torch.bitwise_and(r, torch.where(verb_b, lo_mask[..., None], zero),
                          out=samples(payload, 1))
    else:
        torch.where(active, q, zero, out=body(leading)[..., 1:])
        torch.where(active, q.add_(k + 1),
                    torch.where(verb_b, obits[..., None], zero),
                    out=body(lengths)[..., 1:])
        torch.where(active, pay,
                    r & torch.where(verb_b, ob_mask[..., None], zero),
                    out=body(payload)[..., 1:])
    lengths[:, -2] = (-lengths[:, :-2].sum(dim=-1)) & 7
    lengths[:, -1] = 16
    payload[:, -2:] = 0
    return lengths, leading, payload


def merge_words(lengths, leading, payload, rows: int):
    """bitmerge.merge_words_plain (K3's plain version, with slot_words):
    each word a difference of running sums of the word parts of the slots
    that start in it. Returns (words int32 [F, rows, 128], total_bits
    int32 [F])."""
    F, M = lengths.shape
    W = rows * LANE
    ln = lengths.to(torch.int64)
    offsets = torch.cumsum(ln, dim=-1) - ln
    paylen = ln - leading
    start = offsets + leading
    w0 = start >> 5
    t = paylen + (start & 31)
    first = t <= 32
    pay = payload.to(torch.int64) & U32_MASK
    hi = torch.where(first, (pay << torch.clamp(32 - t, 0, 31)) & U32_MASK,
                     pay >> torch.clamp(t - 32, 0, 31))
    lo = torch.where(first, 0, (pay << torch.clamp(64 - t, 1, 31)) & U32_MASK)
    active = paylen > 0
    hi = torch.where(active, hi, 0)
    lo = torch.where(active, lo, 0)
    zero = torch.zeros((F, 1), dtype=torch.int64)
    ex_hi = torch.cat([zero, torch.cumsum(hi, -1)], dim=-1)
    ex_lo = torch.cat([zero, torch.cumsum(lo, -1)], dim=-1)
    targets = torch.arange(W + 1).expand(F, W + 1).contiguous()
    S = torch.searchsorted(w0.contiguous(), targets)
    A = torch.gather(ex_hi, 1, S)
    B = torch.gather(ex_lo, 1, S)
    hi_term = A[:, 1:] - A[:, :-1]
    lo_term = B - torch.cat([B[:, :1], B[:, :-1]], dim=-1)
    words = wrap_int32(hi_term + lo_term[:, :W]).reshape(F, rows, LANE)
    return words, ln.sum(dim=-1).to(torch.int32)


def encode_batch(samples, hdr_bits, hdr_bytes, hdr_nbytes,
                 cfg: Config) -> dict:
    """What ``pipeline_step`` returns for one batch, from CPU tensors:
    ``words`` int32 [F, rows, 128], ``total_bits`` int32 [F] and
    ``frame_bytes`` int64 [F]."""
    analysis = analyze_frames(samples, cfg, hdr_bits)
    lengths, leading, payload = slot_layout(analysis, hdr_bytes, hdr_nbytes,
                                            cfg)
    words, total_bits = merge_words(lengths, leading, payload,
                                    word_rows(cfg))
    return {"words": words, "total_bits": total_bits,
            "frame_bytes": analysis["frame_bytes"]}
