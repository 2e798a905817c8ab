"""Stream assembly from shards (port of ``flake_tpu/parallel/assemble.py``).

A FLAC stream needs little state across shards:

1. nothing for the frames themselves (each is self-contained, and its
   number follows from its global offset);
2. the largest frame, for STREAMINFO (a max over the shards);
3. the byte offset of each shard's frames (an exclusive scan of the
   shards' byte counts in rank order);
4. the stream MD5, one sequential chain over the raw input, carried across
   shard boundaries in rank order.

This module is that protocol on the host; :mod:`.runner` drives it in one
process, :mod:`.distributed` across processes.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from flake_tpu_torch.md5 import pcm_md5_bytes


@dataclasses.dataclass
class ShardResult:
    """What each shard contributes to the assembly."""

    rank: int
    frame_bytes: bytes          # its frames, back to back
    frame_lengths: np.ndarray   # [frames_in_shard]
    n_samples: int              # samples the shard consumed
    max_frame_size: int


def exclusive_offsets(lengths_per_shard: list[np.ndarray]) -> list[int]:
    """Byte offset of each shard's first frame in the stream (after the
    header)."""
    offsets = []
    acc = 0
    for lens in lengths_per_shard:
        offsets.append(acc)
        acc += int(lens.sum())
    return offsets


def chained_md5(pcm_shards: list[np.ndarray], bps: int) -> bytes:
    """The MD5 of the shards' sample bytes in shard order (md5.c:281-320:
    little-endian, (bps + 7) / 8 bytes a sample)."""
    h = hashlib.md5()
    for pcm in pcm_shards:
        h.update(pcm_md5_bytes(pcm, bps))
    return h.digest()


def assemble_stream(header: bytes, shards: list[ShardResult],
                    streaminfo_patch) -> bytes:
    """The shards' frames in rank order after ``header``, with STREAMINFO
    rewritten by ``streaminfo_patch(max_frame_size, total_samples)``,
    which returns the 34-byte body (the caller owns the MD5 and the
    metadata)."""
    shards = sorted(shards, key=lambda s: s.rank)
    out = bytearray(header)
    for s in shards:
        out += s.frame_bytes
    gmax = max(s.max_frame_size for s in shards)
    total = sum(s.n_samples for s in shards)
    out[8:8 + 34] = streaminfo_patch(gmax, total)
    return bytes(out)
