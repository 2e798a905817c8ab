"""Encoding across processes on ``torch.distributed`` (port of
``flake_tpu/parallel/distributed.py``).

The transport of the protocol in :mod:`.runner`: every rank encodes its
frame-aligned span with the global frame numbering, and the only state
that crosses ranks is

1. each rank's byte count, largest frame and sample count: one
   ``all_gather_into_tensor`` of three int64s;
2. the ranks' bodies: one ``broadcast`` from each rank of exactly its byte
   count, so every rank receives the whole stream once;
3. the MD5 chain: 88 bytes of :class:`~flake_tpu_torch.md5.Md5Chain`
   state passed from rank to rank, each folding in its own raw samples,
   the one sequential piece;
4. then every rank assembles the header, the bodies and the STREAMINFO
   rewrite, the same bytes on every rank.

:func:`encode_stream_to_file_distributed` writes a shared file instead,
each rank its own span at its offset, so no frame bytes cross ranks.

The group's backend sets where the tensors of the exchange live: on the
rank's current CUDA device under ``nccl``, on the host under ``gloo``.
The job of ranks gives the bytes of one ``Encoder.encode_stream``.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

from flake_tpu_torch import params as P
from flake_tpu_torch.encoder import Encoder
from flake_tpu_torch.md5 import Md5Chain, pcm_md5_bytes
from flake_tpu_torch.parallel.runner import (first_frame_number,
                                             shard_ranges, streaminfo_header)

BACKENDS = ("nccl", "gloo")


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: str) -> None:
    """Join the job of ``num_processes`` ranks whose rank 0 listens at
    ``coordinator_address`` (host:port), over ``backend``: "nccl" (ranks
    on distinct CUDA devices; set each rank's current device first, with
    ``torch.cuda.set_device``) or "gloo" (the host)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not "
                         f"{backend!r}")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def _comm_device() -> torch.device:
    """Where the group's backend takes its tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _allgather(x: np.ndarray) -> np.ndarray:
    """[nproc, *x.shape]: every rank's ``x``, in rank order."""
    dev = _comm_device()
    t = torch.from_numpy(np.ascontiguousarray(x).reshape(-1)).to(dev)
    out = torch.empty(dist.get_world_size() * t.numel(), dtype=t.dtype,
                      device=dev)
    with warnings.catch_warnings():
        # newer releases rename it; the call is the same collective
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t)
    return out.cpu().numpy().reshape((-1,) + np.shape(x))


def _bcast_from(x: np.ndarray, src: int) -> np.ndarray:
    """``x`` of rank ``src`` on every rank; every rank passes an array of
    the same shape and dtype."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(_comm_device())
    dist.broadcast(t, src=src)
    return t.cpu().numpy()


def encode_stream_distributed(pcm: np.ndarray, cfg: P.StreamConfig, *,
                              device=None, mesh=None,
                              batch_frames: int = 512,
                              lpc_dtype: str = "float64",
                              vendor_string: str | None = None,
                              vorbis_entries: list[str] | None = None,
                              ) -> bytes:
    """Encode ``pcm``, the whole stream, which every rank holds, across
    the ranks of the group; each encodes its span on ``device`` (or
    ``mesh``). Collective: every rank calls it, and every rank returns
    the whole FLAC stream."""
    rank, nproc = dist.get_rank(), dist.get_world_size()
    pcm = np.asarray(pcm, dtype=np.int32).reshape(-1, cfg.channels)
    lo, hi = shard_ranges(pcm.shape[0], cfg.params.block_size, nproc)[rank]
    return _exchange_and_assemble(
        pcm[lo:hi], cfg, rank=rank, nproc=nproc, start_sample=lo,
        total_samples=pcm.shape[0], device=device, mesh=mesh,
        batch_frames=batch_frames, lpc_dtype=lpc_dtype,
        vendor_string=vendor_string, vorbis_entries=vorbis_entries)


def encode_shard_distributed(pcm_local: np.ndarray, cfg: P.StreamConfig,
                             start_sample: int, total_samples: int, *,
                             device=None, mesh=None,
                             batch_frames: int = 512,
                             lpc_dtype: str = "float64",
                             vendor_string: str | None = None,
                             vorbis_entries: list[str] | None = None,
                             ) -> bytes:
    """As :func:`encode_stream_distributed`, each rank holding only its
    own span, which starts at ``start_sample`` (frame-aligned, as
    :func:`~flake_tpu_torch.parallel.runner.shard_ranges` cuts it).
    Collective; returns the whole stream on every rank."""
    return _exchange_and_assemble(
        np.asarray(pcm_local, dtype=np.int32).reshape(-1, cfg.channels),
        cfg, rank=dist.get_rank(), nproc=dist.get_world_size(),
        start_sample=start_sample, total_samples=total_samples,
        device=device, mesh=mesh, batch_frames=batch_frames,
        lpc_dtype=lpc_dtype, vendor_string=vendor_string,
        vorbis_entries=vorbis_entries)


def _encode_span(pcm_local, cfg, start_sample, total_samples, *, device,
                 mesh, batch_frames, lpc_dtype):
    """Encode this rank's span and gather every rank's (byte count,
    largest frame, sample count). Returns (body, stats int64 [nproc, 3])."""
    enc = Encoder(cfg, device=device, mesh=mesh, batch_frames=batch_frames,
                  lpc_dtype=lpc_dtype)
    enc.frame_count = first_frame_number(cfg, start_sample)
    body = enc.encode(pcm_local, last=True)
    stats = _allgather(np.array(
        [len(body), enc.max_frame_size, pcm_local.shape[0]], dtype=np.int64))
    if int(stats[:, 2].sum()) != total_samples:
        raise ValueError(f"the ranks' spans hold {int(stats[:, 2].sum())} "
                         f"samples, not the stream's {total_samples}")
    return body, stats


def _exchange_and_assemble(pcm_local, cfg, *, rank, nproc, start_sample,
                           total_samples, device, mesh, batch_frames,
                           lpc_dtype, vendor_string, vorbis_entries) -> bytes:
    body, stats = _encode_span(pcm_local, cfg, start_sample, total_samples,
                               device=device, mesh=mesh,
                               batch_frames=batch_frames, lpc_dtype=lpc_dtype)
    # one broadcast of exactly each rank's bytes: every rank receives the
    # stream's bytes once (encode_stream_to_file_distributed sends none)
    own = np.frombuffer(bytearray(body), dtype=np.uint8)
    bodies = [_bcast_from(own if r == rank
                          else np.empty(int(stats[r, 0]), np.uint8), r)
              for r in range(nproc)]
    md5 = _md5_chain(pcm_local, cfg.bits_per_sample, rank, nproc)
    header = streaminfo_header(
        cfg, total_samples, int(stats[:, 1].max()), md5, device=device,
        mesh=mesh, vendor_string=vendor_string, vorbis_entries=vorbis_entries)
    out = bytearray(header)
    for b in bodies:
        out += b.data
    return bytes(out)


def _md5_chain(pcm_local, bps: int, rank: int, nproc: int) -> bytes:
    """The stream MD5 as a chain of exported states in rank order
    (md5.c:281-320 is sequential): ``nproc`` rounds of one 88-byte
    broadcast; rank r folds in its raw samples in round r."""
    state = np.frombuffer(bytearray(Md5Chain().export_state()), np.uint8)
    for r in range(nproc):
        if r == rank:
            h = Md5Chain.import_state(state.tobytes())
            h.update(pcm_md5_bytes(pcm_local, bps))
            state = np.frombuffer(bytearray(h.export_state()), np.uint8)
        state = _bcast_from(state, r)
    return Md5Chain.import_state(state.tobytes()).digest()


def _pwrite_all(fd: int, data, offset: int) -> None:
    """pwrite the whole buffer: POSIX permits short writes (and Linux caps
    one write near 2 GiB), so a large span loops until every byte lands
    at its offset."""
    view = memoryview(data)
    written = 0
    while written < len(view):
        n = os.pwrite(fd, view[written:], offset + written)
        if n <= 0:
            raise OSError(f"pwrite returned {n} at offset {offset + written}")
        written += n


def encode_stream_to_file_distributed(
        pcm: np.ndarray, cfg: P.StreamConfig, path, *, device=None,
        mesh=None, batch_frames: int = 512, lpc_dtype: str = "float64",
        vendor_string: str | None = None,
        vorbis_entries: list[str] | None = None) -> int:
    """Every rank writes its span's bytes into ``path`` (a shared file
    system) at its offset: no frame bytes cross ranks, only three int64s
    a rank and the 88-byte MD5 chain. Rank 0 writes the header with the
    rewritten STREAMINFO. Collective; returns the file's size on every
    rank once the file is whole."""
    rank, nproc = dist.get_rank(), dist.get_world_size()
    pcm = np.asarray(pcm, dtype=np.int32).reshape(-1, cfg.channels)
    total_samples = pcm.shape[0]
    lo, hi = shard_ranges(total_samples, cfg.params.block_size, nproc)[rank]
    pcm_local = pcm[lo:hi]
    body, stats = _encode_span(pcm_local, cfg, lo, total_samples,
                               device=device, mesh=mesh,
                               batch_frames=batch_frames, lpc_dtype=lpc_dtype)
    md5 = _md5_chain(pcm_local, cfg.bits_per_sample, rank, nproc)
    header = streaminfo_header(
        cfg, total_samples, int(stats[:, 1].max()), md5, device=device,
        mesh=mesh, vendor_string=vendor_string, vorbis_entries=vorbis_entries)
    offset = len(header) + int(stats[:rank, 0].sum())
    total_size = len(header) + int(stats[:, 0].sum())

    fd = os.open(str(path), os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        if rank == 0:
            os.truncate(fd, total_size)
            _pwrite_all(fd, header, 0)
        _pwrite_all(fd, body, offset)
        os.fsync(fd)
    finally:
        os.close(fd)
    # every rank returns only once the whole file is written
    _allgather(np.zeros(1, np.int32))
    return total_size
