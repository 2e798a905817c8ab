"""The work a batch needs, counted from its shapes and configuration, and
its share of the card's roofline.

Each layer's bytes are its inputs read once and its outputs written once;
its operations are the sum of its stages' (the stages of the analysis
and the emission as the FLAC encoder defines them: lags, Levinson, the
candidate orders' residuals and partition sums, the Rice scan, the
selection, the final residual and Rice, the slots). Nothing here reads
what a kernel of the program loads, writes or launches, so the counts
stay the same whatever implements the stages, and a faster program
cannot push a share over 100%: a share above it means the work or the
time is counted wrong, and :func:`share` raises.

Where the work depends on the data (the order each stream chooses), the
count takes the configuration's largest order: the chosen one is at most
that, and every stage it touches is bound by its bytes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the 700 W power
limit): 3.35 TB/s of HBM3; integer and float64 operations at 33.5 T/s,
half the 67 TFLOP/s float32 rate (the sweep's float64 products, the
Rice search's int32 and int64 arithmetic).
"""

from __future__ import annotations

from flakebench.reference.flac_plain import (HDR_SLOTS, MAX_LPC_ORDER,
                                             limit_max_partition_order,
                                             word_rows, Config)

PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 33.5e12

LAYERS = ("analysis", "emission")

# operations a unit of work, as the bound column of PERF.md's kernel
# tables counts them
LAG_OPS = 2            # a product and a sum a lag and sample, + the window
SWEEP_OPS = 2          # a product and a sum a tap and sample and order
RESIDUAL_OPS = 5       # shift, subtract, zigzag (2) and the partition sum
RICE_PART_OPS = 20     # the closed-form k search a partition
SELECT_OPS = 150       # the order method's scan a stream
FINAL_OPS = 8          # the final residual's other work a sample
HEAD_OPS = 16          # the stereo estimate a sample
HEAD_CH_OPS = 8        # decorrelation and wasted bits a sample and channel
SLOT_OPS = 20          # a slot's length, zeros and payload


def _partitions(cfg: Config) -> int:
    """Partitions a stream over every partition order the search takes."""
    n = cfg.block_size
    pmax = limit_max_partition_order(cfg.max_partition_order, n, 1)
    return sum(1 << p for p in range(cfg.min_partition_order, pmax + 1))


def _lpc(cfg: Config) -> bool:
    return cfg.prediction_type == 2 and cfg.block_size > \
        cfg.max_prediction_order


def stage_work(frames: int, cfg: Config) -> dict:
    """Each stage's (bytes, operations) for a batch of ``frames`` frames:
    a stage's bytes are its own inputs and outputs, once."""
    F, n, C = frames, cfg.block_size, cfg.channels
    N = F * C
    m = cfg.max_prediction_order
    parts = _partitions(cfg)
    i32, f64 = 4, 8
    work = {"head": (F * n * C * i32 * 2, F * n * HEAD_OPS
                     + N * n * HEAD_CH_OPS)}
    if _lpc(cfg):
        work["lags"] = (N * n * i32 + n * f64 + N * (m + 1) * f64,
                        N * n * (LAG_OPS * (m + 1) + 1))
        work["levinson"] = (N * (m + 1) * f64 + N * m * (m + 1) * i32,
                            N * 5 * m * m)
        if cfg.order_method not in (0, 1):      # MAX and EST read no bits
            work["sweep"] = (N * n * i32 + N * m * (m + 1) * i32,
                             SWEEP_OPS * N * n * m * (m + 1) // 2)
            work["partition_sums"] = (N * m * parts * 8,
                                      N * n * m * RESIDUAL_OPS)
            work["rice_scan"] = (N * m * parts * 8,
                                 N * m * parts * RICE_PART_OPS)
        work["select"] = (N * m * 8, N * SELECT_OPS)
        taps = m
    else:
        taps = min(m, 4)
    work["final"] = (N * n * i32 * 2,
                     N * n * (SWEEP_OPS * taps + FINAL_OPS)
                     + N * parts * RICE_PART_OPS)
    ps = limit_max_partition_order(cfg.max_partition_order, n, 1)
    wide = cfg.bps + (1 if C == 2 else 0) > 32
    spg = (2 if wide else 1) * (n >> ps)
    slots = HDR_SLOTS + C * ((100 if wide else 68) + (1 << ps) * (1 + spg)) + 2
    work["slots"] = (_emission_bytes(F, cfg), F * slots * SLOT_OPS)
    return work


def _analysis_bytes(F: int, cfg: Config) -> int:
    n, C = cfg.block_size, cfg.channels
    rp = 1 << limit_max_partition_order(cfg.max_partition_order, n, 1)
    inputs = F * n * C * 4 + F * 4                  # samples, header bits
    outputs = (F * C * n * 4 + F * C * MAX_LPC_ORDER * 4 + F * C * rp * 4
               + 8 * F * C * 4 + F * 4 + F * 8)     # + tables, frame bytes
    return inputs + outputs


def _emission_bytes(F: int, cfg: Config) -> int:
    n, C = cfg.block_size, cfg.channels
    rp = 1 << limit_max_partition_order(cfg.max_partition_order, n, 1)
    inputs = (F * C * n * 4 + F * C * MAX_LPC_ORDER * 4 + F * C * rp * 4
              + 8 * F * C * 4 + F * 4 + F * (HDR_SLOTS + 4))
    outputs = F * word_rows(cfg) * 512 + F * 4      # words, total bits
    return inputs + outputs


def layer_work(layer: str, frames: int, cfg: Config) -> tuple[int, int]:
    """(bytes, operations) of ``layer`` ("analysis": the frame analysis,
    "emission": the slots and the words) for a batch."""
    stages = stage_work(frames, cfg)
    if layer == "analysis":
        return (_analysis_bytes(frames, cfg),
                sum(ops for name, (_, ops) in stages.items()
                    if name != "slots"))
    if layer == "emission":
        return _emission_bytes(frames, cfg), stages["slots"][1]
    raise ValueError(f"no layer {layer!r}; the layers are {LAYERS}")


def least_ms(nbytes: int, ops: int) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory bandwidth and the operations over the rate, in ms."""
    return 1e3 * max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S)


def share(least: float, measured_ms: float) -> float:
    """``least`` as a percentage of ``measured_ms``; raises above 100%,
    which only a miscount can give."""
    pct = 100.0 * least / measured_ms
    if pct > 100.0:
        raise ValueError(f"roofline share {pct:.2f}% over 100%: "
                         f"{least} ms of needed work in {measured_ms} ms")
    return pct
