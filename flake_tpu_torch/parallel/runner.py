"""Encoding a stream in shards, one per host (port of
``flake_tpu/parallel/runner.py``).

The protocol of :mod:`.assemble` around the :class:`~flake_tpu_torch.
encoder.Encoder`:

- :func:`shard_ranges`: a frame-aligned split of a stream over hosts;
- :func:`encode_shard`: what each host runs on its span, with the global
  frame numbering, on one device or over a mesh of its devices;
- :func:`assemble`: the header, the shards' frames in rank order and the
  STREAMINFO rewrite with the global statistics;
- :func:`encode_stream_multihost`: the whole flow in one process, each
  shard encoded on its own (:mod:`.distributed` is the same flow across
  processes).

The bytes equal one ``Encoder.encode_stream`` of the whole stream. Every
function that builds an Encoder takes the caller's ``device`` or ``mesh``.
"""

from __future__ import annotations

import numpy as np

from flake_tpu_torch import metadata
from flake_tpu_torch import params as P
from flake_tpu_torch.encoder import Encoder
from flake_tpu_torch.parallel.assemble import ShardResult, chained_md5


def shard_ranges(n_samples: int, block_size: int,
                 n_hosts: int) -> list[tuple[int, int]]:
    """Frame-aligned [start, end) sample ranges, one a host: whole frames
    only (no frame reads another's samples); the remainder and the
    final partial frame go to the last host."""
    n_frames = n_samples // block_size
    per, extra = divmod(n_frames, n_hosts)
    ranges = []
    start = 0
    for r in range(n_hosts):
        end = start + (per + (r < extra)) * block_size
        if r == n_hosts - 1:
            end = n_samples
        ranges.append((start, end))
        start = end
    return ranges


def first_frame_number(cfg: P.StreamConfig, start_sample: int) -> int:
    """The header number of the frame at ``start_sample``: its index, or
    its first sample in a stream of variable block sizes
    (encode.c:970-975)."""
    if cfg.params.allow_vbs:
        return start_sample
    return start_sample // cfg.params.block_size


def encode_shard(pcm_local: np.ndarray, cfg: P.StreamConfig, rank: int,
                 start_sample: int, *, device=None, mesh=None,
                 batch_frames: int = 512,
                 lpc_dtype: str = "float64") -> ShardResult:
    """Encode one host's span; ``start_sample`` sets the global frame
    numbering."""
    enc = Encoder(cfg, device=device, mesh=mesh, batch_frames=batch_frames,
                  lpc_dtype=lpc_dtype)
    enc.frame_count = first_frame_number(cfg, start_sample)
    body = enc.encode(pcm_local, last=True)
    return ShardResult(
        rank=rank, frame_bytes=body,
        frame_lengths=np.array([len(body)], dtype=np.int64),
        n_samples=pcm_local.shape[0], max_frame_size=enc.max_frame_size)


def streaminfo_header(cfg: P.StreamConfig, total_samples: int,
                      max_frame_size: int, md5: bytes, *, device=None,
                      mesh=None, vendor_string: str | None = None,
                      vorbis_entries: list[str] | None = None) -> bytes:
    """The stream's header blocks with STREAMINFO carrying the global
    statistics: sample count, largest frame and MD5."""
    enc = Encoder(cfg, device=device, mesh=mesh,
                  vendor_string=vendor_string, vorbis_entries=vorbis_entries)
    enc.sample_count = total_samples
    header = bytearray(enc.header())
    si = enc.streaminfo()
    si.max_frame_size = max(max_frame_size, si.max_frame_size)
    si.samples = total_samples
    si.md5sum = md5
    header[8:8 + 34] = metadata.write_streaminfo(si)
    return bytes(header)


def assemble(cfg: P.StreamConfig, shards: list[ShardResult], md5: bytes, *,
             device=None, mesh=None, vendor_string: str | None = None,
             vorbis_entries: list[str] | None = None) -> bytes:
    """The header, then the shards' frames in rank order, STREAMINFO
    rewritten with the global statistics."""
    shards = sorted(shards, key=lambda s: s.rank)
    header = streaminfo_header(
        cfg, sum(s.n_samples for s in shards),
        max(s.max_frame_size for s in shards), md5, device=device,
        mesh=mesh, vendor_string=vendor_string,
        vorbis_entries=vorbis_entries)
    return header + b"".join(s.frame_bytes for s in shards)


def encode_stream_multihost(pcm: np.ndarray, cfg: P.StreamConfig,
                            n_hosts: int, *, device=None, mesh=None,
                            batch_frames: int = 512,
                            lpc_dtype: str = "float64") -> bytes:
    """The ``n_hosts`` flow in one process: each shard is encoded on its
    own, and only the protocol's state passes between them (the largest
    frame, the sample counts and the MD5 over the raw input in rank
    order)."""
    pcm = np.asarray(pcm, dtype=np.int32).reshape(-1, cfg.channels)
    ranges = shard_ranges(pcm.shape[0], cfg.params.block_size, n_hosts)
    shards = [encode_shard(pcm[lo:hi], cfg, rank, lo, device=device,
                           mesh=mesh, batch_frames=batch_frames,
                           lpc_dtype=lpc_dtype)
              for rank, (lo, hi) in enumerate(ranges)]
    md5 = chained_md5([pcm[lo:hi] for lo, hi in ranges], cfg.bits_per_sample)
    return assemble(cfg, shards, md5, device=device, mesh=mesh)
