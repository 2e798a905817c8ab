"""Audio input layer: WAVE/AIFF/RAW probing, parsing and sample conversion
(port of ``flake_tpu/io/``, numpy only).

The analogue of the reference's libpcm_io static library
(libpcm_io/pcm_io.c, formats.c, wav.c, aiff.c, raw.c, convert.c): a
format registry probed by magic bytes, chunked block-aligned reads, and
conversion of any supported sample format to native-range int32.
Importing the package registers the three containers, in the order the
JAX package's ``open_pcm`` imports them: AIFF and WAVE score 100 on their
magic, RAW 1 on anything.
"""

from flake_tpu_torch.io.pcm import (  # noqa: F401
    PcmInfo,
    PcmReader,
    open_pcm,
    probe_format,
    register_format,
)
from flake_tpu_torch.io import aiff, raw, wav  # noqa: F401,E402
