"""Sample-format conversion matrix (port of ``flake_tpu/io/convert.py``).

Reference analogue: libpcm_io/convert.c:30-181 — conversions between
U8/S16/S20/S24/S32 with the reference's exact shift semantics (truncating
right-shifts when narrowing, plain widening without rescale, +/-128
bias for U8). The encoder itself always consumes native-range int32
(like the reference CLI, flake.c:401); this matrix exists for library
users reading/writing other widths.
"""

from __future__ import annotations

import numpy as np

# format name -> (valid bits, stored dtype kind)
FORMATS = ("u8", "s16", "s20", "s24", "s32")
_BITS = {"u8": 8, "s16": 16, "s20": 20, "s24": 24, "s32": 32}


def convert(samples: np.ndarray, src: str, dst: str) -> np.ndarray:
    """Convert native-range samples between formats (convert.c matrix).

    ``samples``: u8 as uint8 (biased), others int32 holding native-range
    values. Narrowing uses arithmetic right shifts; widening is
    unscaled, exactly like the reference."""
    if src not in FORMATS or dst not in FORMATS:
        raise ValueError(f"unknown format {src!r} or {dst!r}")

    # normalise to signed native range first (u8 -> signed, -128 bias)
    if src == "u8":
        signed = samples.astype(np.int32) - 128
        sbits = 8
    else:
        signed = samples.astype(np.int32)
        sbits = _BITS[src]

    dbits = _BITS[dst]
    if dbits >= sbits:
        out = signed  # widen: no rescale (convert.c:142-167)
    else:
        out = signed >> (sbits - dbits)  # narrow: truncate

    if dst == "u8":
        return (out + 128).astype(np.uint8)
    return out.astype(np.int32)
