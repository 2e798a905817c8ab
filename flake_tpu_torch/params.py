"""Encoding parameters, compression-level presets, and validation.

The port's copy of :mod:`flake_tpu.params` (the JAX package's ``__init__``
imports JAX, so the port cannot import it on a machine without JAX). The
tests hold the two equal. Reference: libflake/flake.h:59-161 for the param
struct, libflake/encode.c:158-266 for level presets, encode.c:268-373 for
validation and FLAC-Subset classification.

Everything here is plain Python: it runs once per stream, never per frame.
"""

from __future__ import annotations

import dataclasses
import enum


class OrderMethod(enum.IntEnum):
    """Prediction-order selection strategy (flake.h:38-46)."""

    MAX = 0
    EST = 1
    LEVEL2 = 2
    LEVEL4 = 3
    LEVEL8 = 4
    SEARCH = 5
    LOG = 6


class StereoMethod(enum.IntEnum):
    """Stereo decorrelation strategy (flake.h:48-51)."""

    INDEPENDENT = 0
    ESTIMATE = 1


class Prediction(enum.IntEnum):
    """Subframe prediction family (flake.h:53-57)."""

    NONE = 0
    FIXED = 1
    LEVINSON = 2


# FLAC format limits (encode.h:33-35)
MAX_CHANNELS = 8
MIN_BLOCKSIZE = 16
MAX_BLOCKSIZE = 65535

# Variable-block-size constants (vbs.h:26-27 via encode.c:998)
VBS_MAX_FRAMES = 8
VBS_MIN_BLOCK_SIZE = 128

# Rice coding limits (rice.h:30-34)
MAX_RICE_PARAM_4BIT = 14
MAX_RICE_PARAM_5BIT = 30
MAX_RICE_PARAM = MAX_RICE_PARAM_5BIT
MAX_PARTITION_ORDER = 8
MAX_PARTITIONS = 1 << MAX_PARTITION_ORDER

MAX_LPC_ORDER = 32  # lpc.h:25
LPC_PRECISION = 15  # encode.c:443 (fixed 15-bit coefficient precision)


@dataclasses.dataclass
class EncodeParams:
    """Mirror of FlakeEncodeParams (flake.h:59-161).

    ``compression`` is the 0-12 preset level; the remaining fields can be
    overridden individually after calling :func:`set_defaults`.
    """

    compression: int = 5
    order_method: int = OrderMethod.EST
    stereo_method: int = StereoMethod.ESTIMATE
    block_size: int = 4096
    padding_size: int = 8192
    min_prediction_order: int = 1
    max_prediction_order: int = 8
    prediction_type: int = Prediction.LEVINSON
    min_partition_order: int = 0
    max_partition_order: int = 5
    variable_block_size: int = 0
    allow_vbs: int = 0


def set_defaults(compression: int) -> EncodeParams:
    """Level -> parameter presets (encode.c:158-266).

    Returns a fresh :class:`EncodeParams` for ``compression`` in 0..12.
    """
    if compression < 0 or compression > 12:
        raise ValueError(f"compression level must be 0..12, got {compression}")

    p = EncodeParams(compression=compression)
    # level 5 is the baseline (encode.c:172-182); others diff from it.
    lvl = compression
    if lvl == 0:
        p.stereo_method = StereoMethod.INDEPENDENT
        p.block_size = 1152
        p.prediction_type = Prediction.FIXED
        p.min_prediction_order = 2
        p.max_prediction_order = 2
        p.max_partition_order = 3
    elif lvl == 1:
        p.block_size = 1152
        p.prediction_type = Prediction.FIXED
        p.min_prediction_order = 2
        p.max_prediction_order = 4
        p.max_partition_order = 3
    elif lvl == 2:
        p.block_size = 1152
        p.prediction_type = Prediction.FIXED
        p.min_prediction_order = 0
        p.max_prediction_order = 4
        p.max_partition_order = 3
    elif lvl == 3:
        p.stereo_method = StereoMethod.INDEPENDENT
        p.max_prediction_order = 6
        p.max_partition_order = 4
    elif lvl == 4:
        p.max_partition_order = 4
    elif lvl == 5:
        pass
    elif lvl == 6:
        p.max_partition_order = 6
    elif lvl == 7:
        p.order_method = OrderMethod.LEVEL4
        p.max_partition_order = 6
    elif lvl == 8:
        p.order_method = OrderMethod.LOG
        p.max_prediction_order = 12
        p.max_partition_order = 6
    elif lvl == 9:
        p.order_method = OrderMethod.LOG
        p.max_prediction_order = 12
        p.max_partition_order = 8
        p.allow_vbs = 1
        p.variable_block_size = 1
    elif lvl == 10:
        p.order_method = OrderMethod.SEARCH
        p.max_prediction_order = 12
        p.max_partition_order = 8
        p.allow_vbs = 1
        p.variable_block_size = 1
    elif lvl == 11:
        p.block_size = 8192
        p.order_method = OrderMethod.LOG
        p.max_prediction_order = 32
        p.max_partition_order = 8
        p.allow_vbs = 1
        p.variable_block_size = 1
    elif lvl == 12:
        p.block_size = 8192
        p.order_method = OrderMethod.SEARCH
        p.max_prediction_order = 32
        p.max_partition_order = 8
        p.allow_vbs = 1
        p.variable_block_size = 1
    return p


@dataclasses.dataclass
class StreamConfig:
    """Stream-level configuration: mirror of the user-set fields of
    FlakeContext (flake.h:163-211)."""

    channels: int = 2
    sample_rate: int = 44100
    bits_per_sample: int = 16
    samples: int = 0  # total stream samples; 0 = unknown
    params: EncodeParams = dataclasses.field(default_factory=EncodeParams)


def validate_params(cfg: StreamConfig) -> int:
    """Validate a stream configuration (encode.c:268-373).

    Returns 0 if valid and FLAC-Subset compliant, 1 if valid but outside
    the FLAC Subset. Raises ValueError on invalid configurations (the C
    API returns -1).
    """
    subset = 0
    p = cfg.params

    if cfg.channels < 1 or cfg.channels > MAX_CHANNELS:
        raise ValueError(f"channels must be 1..{MAX_CHANNELS}")
    if cfg.sample_rate < 1 or cfg.sample_rate > 655350:
        raise ValueError("sample_rate must be 1..655350")
    if cfg.bits_per_sample < 4 or cfg.bits_per_sample > 32:
        raise ValueError("bits_per_sample must be 4..32")
    if (cfg.bits_per_sample < 8 or cfg.bits_per_sample > 24
            or cfg.bits_per_sample % 4 != 0):
        subset = 1

    if p.compression < 0 or p.compression > 12:
        raise ValueError("compression must be 0..12")
    if p.order_method < 0 or p.order_method > 6:
        raise ValueError("order_method must be 0..6")
    if p.stereo_method not in (0, 1):
        raise ValueError("stereo_method must be 0..1")

    bs = p.block_size
    if bs < MIN_BLOCKSIZE or bs > MAX_BLOCKSIZE:
        raise ValueError(f"block_size must be {MIN_BLOCKSIZE}..{MAX_BLOCKSIZE}")
    if cfg.sample_rate <= 48000 and bs > 4608:
        subset = 1

    if p.prediction_type < 0 or p.prediction_type > 2:
        raise ValueError("prediction_type must be 0..2")
    if p.min_prediction_order > p.max_prediction_order:
        raise ValueError("min_prediction_order > max_prediction_order")
    if p.prediction_type == Prediction.FIXED:
        if not (0 <= p.min_prediction_order <= 4):
            raise ValueError("fixed min_prediction_order must be 0..4")
        if not (0 <= p.max_prediction_order <= 4):
            raise ValueError("fixed max_prediction_order must be 0..4")
    else:
        if not (1 <= p.min_prediction_order <= 32):
            raise ValueError("min_prediction_order must be 1..32")
        if not (1 <= p.max_prediction_order <= 32):
            raise ValueError("max_prediction_order must be 1..32")
        if cfg.sample_rate <= 48000 and p.max_prediction_order > 12:
            subset = 1

    if p.min_partition_order > p.max_partition_order:
        raise ValueError("min_partition_order > max_partition_order")
    if not (0 <= p.min_partition_order <= 8):
        raise ValueError("min_partition_order must be 0..8")
    if not (0 <= p.max_partition_order <= 8):
        raise ValueError("max_partition_order must be 0..8")

    if p.padding_size < 0 or p.padding_size >= (1 << 24):
        raise ValueError("padding_size must be 0..2^24-1")

    if p.variable_block_size not in (0, 1):
        raise ValueError("variable_block_size must be 0..1")
    if p.variable_block_size > 0 and not p.allow_vbs:
        raise ValueError("variable_block_size requires allow_vbs")
    if bs < VBS_MIN_BLOCK_SIZE and p.allow_vbs:
        raise ValueError(f"block_size must be >= {VBS_MIN_BLOCK_SIZE} with allow_vbs")

    return subset


# FLAC 4-bit header code tables (encode.c:33-49)
FLAC_SAMPLERATES = (0, 0, 0, 0,
                    8000, 16000, 22050, 24000, 32000, 44100, 48000, 96000,
                    0, 0, 0, 0)
FLAC_BITDEPTHS = (0, 8, 12, 0, 16, 20, 24, 0)
FLAC_BLOCKSIZES = (0, 192, 576, 1152, 2304, 4608, 0, 0,
                   256, 512, 1024, 2048, 4096, 8192, 16384)


def samplerate_code(sample_rate: int) -> tuple[int, int]:
    """FLAC frame-header sample-rate code (encode.c:400-422).

    Returns (code0, code1): code1 > 0 selects the custom 8/16-bit field.
    """
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
    """FLAC frame-header bits-per-sample code (encode.c:424-434)."""
    for i in range(1, 8):
        if bits_per_sample == FLAC_BITDEPTHS[i]:
            return i
    return 0


def blocksize_code(block_size: int) -> tuple[int, int]:
    """FLAC frame-header block-size code (encode.c:503-520).

    Returns (code0, code1): code1 >= 0 selects the custom 8/16-bit field.
    """
    for i in range(15):
        if block_size == FLAC_BLOCKSIZES[i]:
            return i, -1
    if block_size <= 256:
        return 6, block_size - 1
    return 7, block_size - 1


def max_frame_size(block_size: int, channels: int, bps: int) -> int:
    """Verbatim-mode frame-size bound (encode.c:446-450, 522-527)."""
    if channels == 2:
        return 16 + ((block_size * (bps + bps + 1) + 7) >> 3)
    return 16 + ((block_size * channels * bps + 7) >> 3)


def from_reference(obj):
    """The port's equal of a JAX-package ``EncodeParams``, ``StreamConfig``
    or ``FrameConfig``, read through :func:`dataclasses.asdict` so the
    port never imports the JAX package. The encoder has no weights: its
    state is this configuration plus constant tables."""
    kind = type(obj).__name__
    d = dataclasses.asdict(obj)
    if kind == "EncodeParams":
        return EncodeParams(**d)
    if kind == "StreamConfig":
        d["params"] = EncodeParams(**d["params"])
        return StreamConfig(**d)
    if kind == "FrameConfig":
        from flake_tpu_torch.ops.frame import FrameConfig

        # autocorrelation / sweep backend selectors of the JAX package
        d.pop("autocorr_mode", None)
        d.pop("use_pallas", None)
        return FrameConfig(**d)
    raise TypeError(f"cannot convert {kind}")
