"""Device-side FLAC bitstream emission (port of ``flake_tpu/ops/bitpack.py``).

Every frame is a fixed layout of variable-length bit fields (header
bytes, subframe headers, warm-ups, coefficients, Rice parameters, one
Rice code per sample). :func:`slot_layout` turns a batch's analysis into
dense [F, M] slot tables (bit length, leading zero bits, payload): on the
card in one launch of E (``csrc/slots.cu``), on the CPU through its plain
version :func:`slot_layout_plain`. K3
(:mod:`flake_tpu_torch.ops.bitmerge`) places the payloads into each
frame's big-endian 32-bit words. CRC-8/CRC-16 placeholders are emitted
as zeros and patched on the host.

The JAX package's slot combining, its static row spans and its overflow
flag (``bitpack.py:192-396``) are ported for the merge-prototype tool
(:mod:`flake_tpu_torch.util.prof_merge3`): :func:`combine_level`,
:func:`align3`, :func:`combined_nodes` and its two layouts
(:func:`to_chunks` for ``merge_v5a`` / ``merge_v5b``, :func:`to_rows` in
:func:`combined_parts` for ``merge_v5d`` / ``merge_v5c``), :func:`kmax_for`
and :func:`chunk_row_span`. K3 merges raw slots, so the encoder runs none
of them and has no overflow re-pack; the 4 KiB granules
(``bitpack.py:738-763``) exist only for the TPU's tile-aligned DMA and are
not ported. One difference from the JAX layout code: the
warm-up view ``res[..., :32]`` is padded to 32 columns, so blocks shorter
than 32 samples (a stream's last frame) lay out instead of failing to
broadcast (``bitpack.py:479-485``).
"""

from __future__ import annotations

import numpy as np
import torch

from flake_tpu_torch import _cuda
from flake_tpu_torch import params as P
from flake_tpu_torch.ops.bitmerge import LANE, merge_words, slot_words
from flake_tpu_torch.ops.common import U32_MASK, wrap_int32
from flake_tpu_torch.ops.frame import (SF_CONSTANT, SF_FIXED, SF_LPC,
                                       SF_VERBATIM, FrameConfig)
from flake_tpu_torch.ops.rice import limit_max_partition_order, zigzag_u32

HDR_SLOTS = 16  # max header bytes: 4 fixed + 7 utf8 + 2 + 2 + crc8


def _split_wide(cfg: FrameConfig) -> bool:
    """Whether sample fields may exceed a 32-bit payload: obits = bps
    (+1 for a side channel)."""
    return cfg.bps + (1 if cfg.channels == 2 else 0) > 32


def slot_bytes(cfg: FrameConfig) -> int:
    """Static per-frame output slot size in bytes (multiple of 512 so
    the word view tiles as [wr, 128] int32 rows)."""
    vsize = P.max_frame_size(cfg.block_size, cfg.channels, cfg.bps)
    return (-(-(vsize + 8) // 512)) * 512


def word_rows(cfg: FrameConfig) -> int:
    """Rows of the [F, wr, 128] int32 per-frame word layout."""
    return slot_bytes(cfg) // 512


def frame_header_bytes(nums: np.ndarray, *, bs_code, sr_code,
                       allow_vbs: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side frame header bytes (encode.c:718-764) without the
    device-known channel-assignment/bps byte (set on the device) and with
    a zero CRC-8 placeholder (patched on the host).

    Returns (bytes uint8 [F, HDR_SLOTS], nbytes int32 [F])."""
    F = nums.shape[0]
    out = np.zeros((F, HDR_SLOTS), dtype=np.uint8)
    nbytes = np.zeros(F, dtype=np.int32)
    for f in range(F):
        b = bytearray()
        b.append(0xFF)
        b.append(0xF8 | (1 if allow_vbs else 0))
        b.append(((bs_code[0] & 0xF) << 4) | (sr_code[0] & 0xF))
        b.append(0)  # (ch_assign << 4) | (bps_code << 1) set on device
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
        b.append(0)  # CRC-8 placeholder
        out[f, :len(b)] = b
        nbytes[f] = len(b)
    return out, nbytes


def _pairs(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Interleave two [..., K] slot arrays as [..., 2K] (hi, lo) pairs."""
    return torch.stack([hi, lo], dim=-1).flatten(-2)


def _low_mask(bits: torch.Tensor) -> torch.Tensor:
    """The int32 image of 2^bits - 1 for bits in [1, 32] (int32 [...]):
    ~(-1 << bits), the shift taken in two steps because a shift by 32
    gives 0 and a left shift wraps."""
    return torch.bitwise_left_shift(-1, bits - 1).bitwise_left_shift_(1) \
        .bitwise_not_()


def slot_layout_plain(analysis: dict, hdr_bytes: torch.Tensor,
                      hdr_nbytes: torch.Tensor, cfg: FrameConfig):
    """E's plain version: the slot tables of a batch of analysed frames
    (``bitpack.py:421-625``).

    ``analysis`` is the :func:`~flake_tpu_torch.ops.frame.analyze_frames`
    dict; hdr_bytes uint8 [F, HDR_SLOTS] and hdr_nbytes int32 [F] come
    from :func:`frame_header_bytes`. Returns (lengths, leading, payload)
    int32 [F, M]: each slot's bit length, its leading zero bits (a Rice
    quotient) and its payload (the uint32 bit pattern).

    Every table is int32, and the per-sample slots are written straight
    into the three outputs (``out=`` on their strided views), so the
    batch's sample-sized memory is the outputs and four int32 temporaries
    at most: the JAX package fuses its int64 tables under one ``jit``, and
    eager int64 ones held 22 tables of [F, C, n] int64 at once. A zigzag
    value z < 2^32 is its half h = z >> 1 (= r ^ (r >> 31), below 2^31)
    and its low bit s; z >> k is h >> (k - 1) for k >= 1, and for k = 0
    the clamped quotient min(z, 2^24) is min(2 min(h, 2^23) + s, 2^24). A
    Rice payload (1 << k) | (z & (2^k - 1)) needs only z's low k <= 30
    bits, which the wrapped int32 image (r << 1) ^ (r >> 31) holds."""
    n = cfg.block_size
    C = cfg.channels
    i32 = torch.int32
    pmax_static = limit_max_partition_order(cfg.max_partition_order, n, 1)
    G = 1 << pmax_static
    gs = n >> pmax_static

    sf = analysis["sf_type"]                              # int32 [F, C]
    order = analysis["order"][..., None]                  # [F, C, 1]
    obits = analysis["obits"][..., None]
    wasted_b = analysis["wasted"][..., None]
    method = analysis["method"][..., None]
    porder = analysis["porder"][..., None]
    res = analysis["residual"]                            # [F, C, n]
    F = sf.shape[0]
    dev = sf.device
    zero = torch.zeros((), dtype=i32, device=dev)

    pred = ((sf == SF_FIXED) | (sf == SF_LPC))[..., None]  # [F, C, 1]
    is_lpc = (sf == SF_LPC)[..., None]
    is_verb = (sf == SF_VERBATIM)[..., None]
    wide = _split_wide(cfg)
    if wide:
        # (hi, lo) slot pairs; the hi part is the value arithmetic-shifted
        # (sign extension supplies bit 32 of a 33-bit field)
        ob_lo = torch.clamp(obits, max=16)
        ob_hi = obits - ob_lo
        lo_mask = (1 << ob_lo) - 1
        hi_mask = (1 << ob_hi) - 1
    else:
        ob_mask = _low_mask(obits)                        # obits <= 32

    # warm-up region: 32 slots, slot j active for j < order on the
    # predicted paths; slot 0 doubles as the CONSTANT value
    j32 = torch.arange(32, device=dev)
    warm_on = (pred & (j32 < order)) \
        | ((sf == SF_CONSTANT)[..., None] & (j32 == 0))
    w32 = torch.nn.functional.pad(res[..., :32], (0, max(0, 32 - n)))
    if wide:
        warm_len = _pairs(torch.where(warm_on, ob_hi, 0),
                          torch.where(warm_on, ob_lo, 0))
        warm_pay = _pairs(
            torch.where(warm_on, (w32 >> ob_lo) & hi_mask, 0),
            torch.where(warm_on, w32 & lo_mask, 0))
    else:
        warm_len = torch.where(warm_on, obits, 0)
        warm_pay = torch.where(warm_on, w32 & ob_mask, 0)

    # subframe header byte (pad + 6-bit type code + wasted flag), the
    # wasted-bits unary code (w-1 zeros then a 1 == value 1 in w bits), the
    # LPC header (4-bit precision-1 + 5-bit shift), the coefficients and
    # the Rice method (2 bits) + partition order (4 bits)
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
        torch.where(coef_on, analysis["coefs"]
                    & ((1 << cfg.precision) - 1), zero),
        torch.where(pred, (method << 4) | porder, zero)], dim=-1)
    n_fixed = fixed_len.shape[-1]                   # 68, or 100 if wide
    spg = 2 * gs if wide else gs
    L = n_fixed + G * (1 + spg)                     # a channel's slots
    M = HDR_SLOTS + C * L + 2

    lengths = torch.empty((F, M), dtype=i32, device=dev)
    leading = torch.zeros((F, M), dtype=i32, device=dev)
    payload = torch.empty((F, M), dtype=i32, device=dev)

    def channels(t):
        return t[:, HDR_SLOTS:HDR_SLOTS + C * L].view(F, C, L)

    def body(t):
        """[F, C, G, 1 + spg]: group g's parameter, then its samples."""
        return channels(t)[..., n_fixed:].view(F, C, G, 1 + spg)

    # header region; byte 3 (channel assignment + bps code) is known here
    hdr_on = torch.arange(HDR_SLOTS, device=dev) < hdr_nbytes.to(dev)[:, None]
    torch.mul(hdr_on, 8, out=lengths[:, :HDR_SLOTS])
    payload[:, :HDR_SLOTS] = hdr_bytes.to(dev)
    ch_mode = analysis["ch_mode"]
    payload[:, 3] = (torch.where(ch_mode > 0, ch_mode, C - 1) << 4) \
        | (P.bps_code(cfg.bps) << 1)
    channels(lengths)[..., :n_fixed] = fixed_len
    channels(payload)[..., :n_fixed] = fixed_pay
    del fixed_len, fixed_pay, warm_len, warm_pay

    # partition parameters on the pmax_static grid: group g starts a
    # partition when it is a multiple of 2^(pmax_static - porder)
    po_shift = pmax_static - porder                       # [F, C, 1]
    g_idx = torch.arange(G, device=dev, dtype=i32)
    g_active = pred & ((g_idx & ((1 << po_shift) - 1)) == 0)
    k = torch.gather(analysis["rice_params"][..., :G], -1,
                     (g_idx >> po_shift).long())          # [F, C, G]
    torch.where(g_active, 4 + method, zero, out=body(lengths)[..., 0])
    torch.where(g_active, k, zero, out=body(payload)[..., 0])

    # per-sample Rice codes, by parameter group [F, C, G, gs]: the q
    # leading zeros cost length only
    r = res.reshape(F, C, G, gs)
    k = k[..., None]                                      # [F, C, G, 1]
    e = (k == 0).to(i32)
    sign = r >> 31
    q = torch.bitwise_xor(r, sign)                        # z >> 1
    q.bitwise_right_shift_(torch.clamp(k - 1, min=0))     # z >> k, k >= 1
    q.clamp_(max=(1 << 24) >> e).bitwise_left_shift_(e)
    q.bitwise_or_(sign & e).clamp_(max=1 << 24)  # tames masked-out lanes
    pay = (r << 1).bitwise_xor_(sign)                     # z's int32 image
    del sign
    pay.bitwise_and_((1 << k) - 1).bitwise_or_(1 << k)
    active = torch.arange(n, device=dev, dtype=i32).view(G, gs) \
        >= torch.where(pred, order, n)[..., None]
    if wide:
        # a Rice code rides whole in the hi slot; a verbatim sample splits
        def samples(t, part):
            return body(t)[..., 1:].view(F, C, G, gs, 2)[..., part]
        verb_b = is_verb[..., None]
        torch.where(active, q, zero, out=samples(leading, 0))
        torch.where(active, q.add_(k + 1),
                    torch.where(verb_b, ob_hi[..., None], zero),
                    out=samples(lengths, 0))
        del q
        torch.where(active, pay,
                    (r >> ob_lo[..., None])
                    & torch.where(verb_b, hi_mask[..., None], zero),
                    out=samples(payload, 0))
        samples(lengths, 1).copy_(
            torch.where(verb_b, ob_lo[..., None], zero).expand(F, C, G, gs))
        torch.bitwise_and(r, torch.where(verb_b, lo_mask[..., None], zero),
                          out=samples(payload, 1))
    else:
        verb_b = is_verb[..., None]
        torch.where(active, q, zero, out=body(leading)[..., 1:])
        torch.where(active, q.add_(k + 1),
                    torch.where(verb_b, obits[..., None], zero),
                    out=body(lengths)[..., 1:])
        del q
        torch.where(active, pay,
                    r & torch.where(verb_b, ob_mask[..., None], zero),
                    out=body(payload)[..., 1:])
    del pay, active

    # byte-alignment pad + CRC-16 placeholder
    lengths[:, -2] = (-lengths[:, :-2].sum(dim=-1)) & 7
    lengths[:, -1] = 16
    payload[:, -2:] = 0
    return lengths, leading, payload


# E's inputs from the analysis dict: the per-channel tables, int32 [F, C]
_SLOT_TABLES = ("sf_type", "order", "obits", "wasted", "method", "porder",
                "type_code", "shift")


def slot_operands(analysis: dict, hdr_bytes: torch.Tensor,
                  hdr_nbytes: torch.Tensor, cfg: FrameConfig):
    """E's operands on the batch's CUDA device, in the order its entry
    point takes them: (inputs, outputs, ints). The outputs are the three
    int32 [F, M] tables, allocated here (``torch.empty``: 16-byte aligned,
    as E's int4 stores need); ``ints`` are F, n, C, pmax_static, rp, wide,
    precision and the bps code. Raises on a shape or dtype E does not
    take."""
    dev = analysis["sf_type"].device
    n, C = cfg.block_size, cfg.channels
    if C > 8:
        raise ValueError(f"slot_layout: {C} channels; the kernel takes 8")
    ps = limit_max_partition_order(cfg.max_partition_order, n, 1)
    F = analysis["sf_type"].shape[0]
    wide = _split_wide(cfg)
    L = (100 if wide else 68) + (1 << ps) * (1 + (2 if wide else 1)
                                             * (n >> ps))
    M = HDR_SLOTS + C * L + 2
    ins = []
    for key in _SLOT_TABLES:
        t = analysis[key].contiguous()
        _cuda.check(t, key, torch.int32, (F, C), dev)
        ins.append(t)
    coefs = analysis["coefs"].contiguous()
    _cuda.check(coefs, "coefs", torch.int32, (F, C, P.MAX_LPC_ORDER), dev)
    params = analysis["rice_params"].contiguous()
    rp = params.shape[-1]
    _cuda.check(params, "rice_params", torch.int32, (F, C, rp), dev)
    if rp < 1 << ps:
        raise ValueError(f"slot_layout: {rp} Rice parameters a subframe, "
                         f"the layout reads {1 << ps}")
    res = analysis["residual"].contiguous()
    _cuda.check(res, "residual", torch.int32, (F, C, n), dev)
    ch_mode = analysis["ch_mode"].contiguous()
    _cuda.check(ch_mode, "ch_mode", torch.int32, (F,), dev)
    hdr_bytes = hdr_bytes.to(dev).contiguous()
    _cuda.check(hdr_bytes, "hdr_bytes", torch.uint8, (F, HDR_SLOTS), dev)
    hdr_nbytes = hdr_nbytes.to(dev).contiguous()
    _cuda.check(hdr_nbytes, "hdr_nbytes", torch.int32, (F,), dev)
    outs = tuple(torch.empty((F, M), dtype=torch.int32, device=dev)
                 for _ in range(3))
    ins += [coefs, params, res, ch_mode, hdr_bytes, hdr_nbytes]
    return ins, outs, (F, n, C, ps, rp, int(wide), cfg.precision,
                       P.bps_code(cfg.bps))


def slot_layout(analysis: dict, hdr_bytes: torch.Tensor,
                hdr_nbytes: torch.Tensor, cfg: FrameConfig):
    """:func:`slot_layout_plain`'s function. A batch on the CPU (its
    ``sf_type``) takes the plain version; one on a CUDA device launches E
    (``csrc/slots.cu``), one thread-block cluster a frame, whose three
    tables equal the plain version's."""
    dev = analysis["sf_type"].device
    if dev.type == "cpu":
        return slot_layout_plain(analysis, hdr_bytes, hdr_nbytes, cfg)
    if dev.type != "cuda":
        raise ValueError(f"slot_layout: no kernel for {dev}")
    ins, outs, ints = slot_operands(analysis, hdr_bytes, hdr_nbytes, cfg)
    if ints[0]:
        _cuda.launch("flake_slot_layout", dev, *ins, *outs, *ints)
        slot_layout.launches += 1
    return outs


slot_layout.launches = 0


def pack_frames_device(analysis: dict, hdr_bytes: torch.Tensor,
                       hdr_nbytes: torch.Tensor, cfg: FrameConfig):
    """Emit a batch's frames: (words int32 [F, word_rows(cfg), 128] —
    each frame's bytes as big-endian words with zeroed CRC placeholders
    — and total_bits int32 [F], == 8*frame_bytes when the layout agrees
    with the analysis accounting)."""
    lengths, leading, payload = slot_layout(analysis, hdr_bytes,
                                            hdr_nbytes, cfg)
    return merge_words(lengths, leading, payload, word_rows(cfg))


def to_rows(x: torch.Tensor) -> torch.Tensor:
    """[F, M] -> int32 [F, nc, 128], zero-padded to nc = ceil(M / 128)
    chunks of 128: element ``c * 128 + s`` at [f, c, s] (``_to_rows``,
    ``bitpack.py:289``). Values wrap to their int32 images."""
    F, M = x.shape
    nc = -(-M // LANE)
    x = torch.nn.functional.pad(wrap_int32(x.to(torch.int64)),
                                (0, nc * LANE - M))
    return x.reshape(F, nc, LANE)


def to_chunks(x: torch.Tensor) -> torch.Tensor:
    """[F, M] -> contiguous int32 [F, 128, nc]: element ``c * 128 + s`` at
    [f, s, c], the column layout of K5's inputs and of the combined-node
    sets."""
    return to_rows(x).permute(0, 2, 1).contiguous()


def aligned_parts(lengths: torch.Tensor, leading: torch.Tensor,
                  payload: torch.Tensor):
    """The pre-aligned form of a batch's slots that K5
    (:func:`~flake_tpu_torch.ops.bitmerge.merge_aligned`) takes, from the
    :func:`slot_layout` tables (``util/prof_merge.py:95-127`` of the JAX
    package): every slot's first word index and the two 32-bit words its
    payload spans, cut into chunks of 128 slots.

    Returns (w0t, hit, lot) int32 [F, 128, nc], slot ``c * 128 + s`` at
    [f, s, c], hit/lot the int32 images of the uint32 words and pad slots
    0, and chunk_bits int32 [F, nc + 1], the bit offset of each chunk's
    first slot with the frame's total bits last. The offsets are a plain
    running sum; the JAX package's hierarchical one works around the
    TPU's scan."""
    offsets, w0, hi, lo = slot_words(lengths, leading, payload)
    total_bits = lengths.sum(dim=-1, dtype=torch.int64)
    chunk_bits = torch.cat([offsets[:, ::LANE], total_bits[:, None]],
                           dim=-1).to(torch.int32)
    return to_chunks(w0), to_chunks(hi), to_chunks(lo), chunk_bits


def words_to_slot_bytes(words: torch.Tensor) -> torch.Tensor:
    """Big-endian byte view of per-frame word blocks (MSB-first
    bitstream): [F, wr, 128] int32 -> uint8 [F, wr*512]."""
    F = words.shape[0]
    return words.contiguous().view(torch.uint8).reshape(F, -1, 4) \
        .flip(-1).reshape(F, -1)


def compact(words: torch.Tensor, frame_bytes: torch.Tensor) -> torch.Tensor:
    """The frames' exact bytes, back to back: the byte view of each
    frame's word block masked at ``pos < frame_bytes`` (uint8 [total]).
    One copy of the result brings a batch to the host; the 4 KiB granules
    of the JAX package exist only for the TPU's tile-aligned DMA."""
    slots = words_to_slot_bytes(words)
    pos = torch.arange(slots.shape[1], device=slots.device)
    return slots[pos < frame_bytes[:, None]]


# -- slot combining ---------------------------------------------------------
# A node is (ln, sw, g, pay): a string of ``ln`` bits whose nonzero bits lie
# in [ln - g - sw, ln - g), held as the integer ``pay`` < 2^sw. The JAX
# package splits ``pay`` into two uint32 words and shifts by 32 in two steps,
# because the TPU has no 64-bit integers; here it is one int64, all 64 bits
# of which a node may use (bit 63 is then the sign), so every right shift is
# logical (:func:`shr64`).

def shl64(pay: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """``pay << sh`` on int64 bit patterns, ``sh`` clamped to [0, 63]; the
    caller guarantees that no set bit leaves the 64 (``_shl64``,
    ``bitpack.py:199``)."""
    return pay << torch.clamp(sh, 0, 63)


def shr64(pay: torch.Tensor, sh: torch.Tensor) -> torch.Tensor:
    """Logical ``pay >> sh`` on int64 bit patterns for ``sh`` in [1, 64]
    (64 gives 0; ``torch.int64 >>`` is arithmetic, so the sign bit is
    cleared after a first shift by one)."""
    return ((pay >> 1) & 0x7FFFFFFFFFFFFFFF) >> torch.clamp(sh - 1, 0, 63)


def pad_even(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last axis to an even length."""
    return torch.nn.functional.pad(x, (0, x.shape[-1] % 2))


def combine_level(ln, sw, g, pay):
    """One pairwise combining level along the last, even-length axis
    (``_combine_level``, ``bitpack.py:220``). Neighbours A, B become one
    node of ``lnA + lnB`` bits: B's payload is ORed under A's, shifted left
    by ``sh = gA + lnB - gB``, where the result spans at most 64 bits;
    otherwise the node keeps A alone and B spills whole.

    int64 [.., M] each -> the combined nodes (ln, sw, g, pay) [.., M / 2]
    and the spills (sw, rel, pay), ``rel`` the payload's first bit counted
    from the pair's first bit, all 0 where nothing spilled."""
    lnA, lnB = ln[..., 0::2], ln[..., 1::2]
    swA, swB = sw[..., 0::2], sw[..., 1::2]
    gA, gB = g[..., 0::2], g[..., 1::2]
    payA, payB = pay[..., 0::2], pay[..., 1::2]

    sh = gA + lnB - gB                 # >= swB: the ORed fields stay disjoint
    sw_c = swA + sh
    fits = sw_c <= 64
    azero = swA == 0
    bzero = swB == 0
    keep_a = bzero | ~fits
    sw_n = torch.where(azero, swB, torch.where(keep_a, swA, sw_c))
    g_n = torch.where(azero, gB, torch.where(keep_a, gA + lnB, gB))
    pay_n = torch.where(azero, payB, torch.where(
        keep_a, payA, shl64(payA, torch.where(fits, sh, 0)) | payB))

    spill = ~azero & ~bzero & ~fits
    zero = torch.zeros_like(swB)
    return (lnA + lnB, sw_n, g_n, pay_n), \
        (torch.where(spill, swB, zero),
         torch.where(spill, lnA + lnB - gB - swB, zero),
         torch.where(spill, payB, zero))


def align3(ps, sw, pay):
    """The three 32-bit words of a payload of ``sw`` <= 64 bits whose first
    bit is stream bit ``ps`` (``_align3``, ``bitpack.py:259``): int64 in;
    (w0, A, B, C) out, ``w0 = ps >> 5`` int64 and A, B, C the int32 images
    of the words to OR into w0, w0 + 1, w0 + 2. All 0 where ``sw == 0``."""
    active = sw > 0
    z = 96 - ((ps & 31) + sw)          # left shift inside the 96-bit window
    low = shl64(pay, z)                # its low 64 bits, for z < 64
    A = torch.where(z >= 64, shl64(pay, z - 64), shr64(pay, 64 - z))
    B = torch.where(z >= 64, 0, low >> 32)     # masked to 32 bits below
    C = torch.where(z >= 32, 0, low)
    w0 = torch.where(active, ps >> 5, 0)
    return (w0, *(wrap_int32(torch.where(active, w & U32_MASK, 0))
                  for w in (A, B, C)))


# -- combined nodes ---------------------------------------------------------

FLAG = -(1 << 31)       # bit 31 of a cb entry: the chunk has a spill
MASK31 = (1 << 31) - 1


def combined_nodes(lengths: torch.Tensor, leading: torch.Tensor,
                   payload: torch.Tensor):
    """A batch's slots combined twice, pairs then quads, and aligned (the
    combining of ``build_combined_parts``, ``bitpack.py:319-341,350-371,
    390-394``, which ``build_v5_parts`` and ``build_v5c_parts`` of
    ``util/prof_merge3.py`` repeat), before any layout.

    int32 [F, M] each -> ``main`` (w0, A, B, C) of the quad nodes and
    ``sp2`` (w0, A, B, C) of the pairs that spilled at the second level,
    [F, M4] each; ``sp1`` (w0, A, B) of the slots that spilled at the
    first, [F, M2] (at most 32 bits: no C); w0 int64, the words int32.
    ``cb2`` int32 [F, nc2 + 1] and ``cb1`` [F, nc1 + 1] hold the bit offset
    of the first node of each chunk of 128, the frame's total bits last,
    with bit 31 (:data:`FLAG`) set on a chunk whose spill set (sp2 for
    cb2, sp1 for cb1) holds anything. Offsets are a plain running sum."""
    ln = pad_even(lengths.to(torch.int64))
    sw = ln - pad_even(leading.to(torch.int64))
    pay = pad_even(payload.to(torch.int64) & U32_MASK)
    total_bits = ln.sum(dim=-1, keepdim=True)

    (ln1, *node1), (s1_sw, s1_rel, s1_pay) = combine_level(
        ln, sw, torch.zeros_like(ln), pay)
    ln1p = pad_even(ln1)
    (ln2, sw2, g2, pay2), (s2_sw, s2_rel, s2_pay) = combine_level(
        ln1p, *(pad_even(v) for v in node1))

    # bit offsets of the quads, and of the pairs inside them
    off2 = torch.cumsum(ln2, dim=-1) - ln2
    off1 = torch.stack([off2, off2 + ln1p[:, 0::2]], dim=-1) \
        .reshape(off2.shape[0], -1)[:, :ln1.shape[-1]]

    main = align3(off2 + ln2 - g2 - sw2, sw2, pay2)
    sp2 = align3(off2 + s2_rel, s2_sw, s2_pay)
    sp1 = align3(off1 + s1_rel, s1_sw, s1_pay)[:3]

    def bounds(off, spill_sw):
        # a chunk's first node always exists (nc = ceil(M / 128)), so the
        # reference's edge padding of ``off`` before the stride adds nothing
        flagged = to_rows(spill_sw).any(dim=-1)
        starts = off[:, ::LANE]
        return torch.cat([torch.where(flagged, starts | FLAG, starts),
                          total_bits], dim=-1).to(torch.int32)

    return main, sp2, sp1, bounds(off2, s2_sw), bounds(off1, s1_sw)


def kmax_for(cfg: FrameConfig) -> tuple[int, int]:
    """The static word-row spans (kmax, kmax1) of a main / sp2 chunk and of
    an sp1 chunk (``kmax_for``, ``bitpack.py:298``): a main chunk of 128
    quads covers 512 slots, an sp1 chunk 256, and a slot of a frame that
    beat verbatim averages under ``obits + 3`` bits. A chunk that spans
    more trips :func:`combined_parts`' overflow flag."""
    ob = cfg.bps + (1 if cfg.channels == 2 else 0)
    return (-(-(512 * (ob + 3) + 95) // 4096) + 1,
            -(-(256 * (ob + 3) + 95) // 4096) + 1)


def chunk_row_span(cb: torch.Tensor) -> torch.Tensor:
    """The word rows each chunk of a ``cb2`` / ``cb1`` table can touch,
    int64 [F, nc] (``bitpack.py:373-376``): from the row of its first bit
    to the row of the third word of a node that ends at its last bit. Bit
    31 of an entry is a flag, not part of the offset."""
    bits = cb.to(torch.int64) & MASK31
    row0 = bits[:, :-1] >> 12
    last = (((bits[:, 1:] - 1) >> 5) + 2) >> 7
    return torch.maximum(last, row0) - row0 + 1


def combined_parts(lengths: torch.Tensor, leading: torch.Tensor,
                   payload: torch.Tensor, kmax: int, kmax1: int):
    """The combined nodes in row layout, with the static-row bookkeeping
    (``build_combined_parts``, ``bitpack.py:312``; the total bits are the
    sum of ``lengths``).

    Returns ``(mainw, (A, B, C), sp2w, (A, B, C), sp1w, (A, B), cb2, cb1)``,
    every node array int32 [F, nc, 128] (:func:`to_rows`), then ``overflow``
    bool [F]: the frame has a chunk that spans more than ``kmax`` word rows,
    or a flagged sp1 chunk that spans more than ``kmax1``, so a merge over
    that many static rows loses words of it; then ``need2`` and ``need1``,
    int32 scalars: the widest span of the batch's chunks (of its flagged
    sp1 chunks), clipped to [1, kmax] and [1, kmax1]."""
    main, sp2, sp1, cb2, cb1 = combined_nodes(lengths, leading, payload)
    mainw, *mainr = (to_rows(v) for v in main)
    sp2w, *sp2r = (to_rows(v) for v in sp2)
    sp1w, *sp1r = (to_rows(v) for v in sp1)
    span2, span1 = chunk_row_span(cb2), chunk_row_span(cb1)
    flagged1 = cb1[:, :-1] < 0
    overflow = (span2 > kmax).any(dim=-1) \
        | ((span1 > kmax1) & flagged1).any(dim=-1)
    need2 = span2.max().clamp(1, kmax).to(torch.int32)
    need1 = torch.where(flagged1, span1, 1).max().clamp(1, kmax1) \
        .to(torch.int32)
    return (mainw, tuple(mainr), sp2w, tuple(sp2r), sp1w, tuple(sp1r),
            cb2, cb1), overflow, need2, need1
