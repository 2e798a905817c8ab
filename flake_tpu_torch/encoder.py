"""Batched FLAC encoder on one GPU (port of ``flake_tpu/encoder.py``).

The stream is cut into fixed-size frames; a batch of up to
``batch_frames`` frames is uploaded as int16, analysed on the device
(:func:`~flake_tpu_torch.ops.frame.analyze_frames`, kernels K1, and K2
or K4) and emitted as FLAC bytes on the device
(:func:`~flake_tpu_torch.ops.bitpack.pack_frames_device`, kernel K3).
The host fetches only the compacted frame bytes and patches their CRCs,
while MD5 runs over the raw input on a worker thread. Batches run two
deep: batch i+1 is enqueued before batch i is copied back. The final
partial frame takes the same device path as a batch of one frame.

Variable block sizes (levels 9-12, ``encoder.py:520-571`` of the JAX
package): each block is a superblock of eight sections whose
second-difference sums are taken on the device
(:func:`vbs_section_sums`); the split layout and the bucketing of
sub-frames by size stay on the host in numpy (:func:`vbs_layout`), and
each bucket is encoded as batches of its own block size. Under
``allow_vbs`` frames are numbered by their first sample.

API lifecycle mirrors the reference (flake.h:217-234): construct ->
header() -> encode chunks -> streaminfo() rewrite. Every preset level
0-12 encodes. The port has no device mesh, no host packing, no
save/load of encoder state and no Vorbis comment entries: its
constructor takes no such argument.
"""

from __future__ import annotations

import hashlib
import threading
import time

import numpy as np
import torch

from flake_tpu_torch import metadata
from flake_tpu_torch import params as P
from flake_tpu_torch.native import crc_patch
from flake_tpu_torch.ops import bitpack
from flake_tpu_torch.ops.frame import FrameConfig, analyze_frames

SPLIT_THRESHOLD = 50    # vbs.c:26


def vbs_section_sums(frames: torch.Tensor, sec: int) -> torch.Tensor:
    """Channel-averaged abs-sum of the 2nd-order residual per section
    (vbs.c:47-63), in int64 on the frames' device; each section's
    difference starts at its own third sample. frames int32 [F, bs, C];
    returns int64 [F, VBS_MAX_FRAMES], the +1 bias included."""
    F, bs, C = frames.shape
    s = frames.permute(0, 2, 1).to(torch.int64) \
        .reshape(F, C, P.VBS_MAX_FRAMES, sec)
    d = s[..., 2:] - 2 * s[..., 1:-1] + s[..., :-2]
    return d.abs().sum(dim=(-1, 1)) // C + 1


def vbs_layout(res: np.ndarray, sec: int):
    """Sub-frames of a batch of superblocks from their section sums
    (vbs.c:65-83): a section starts a sub-frame when its sum differs from
    the previous section's by more than SPLIT_THRESHOLD/200 of it; each
    sub-frame runs to the next start. Returns (superblock index, first
    sample, size) int64 [S], in stream order."""
    F, S = res.shape
    layout = np.zeros((F, S), dtype=bool)
    layout[:, 0] = True
    layout[:, 1:] = (np.abs(res[:, :-1] - res[:, 1:]) * 200 // res[:, :-1]
                     > SPLIT_THRESHOLD)
    # next start after each section: a reversed running minimum of the
    # start indices
    sec_idx = np.broadcast_to(np.arange(S), (F, S))
    marked = np.where(layout, sec_idx, S)
    nxt = np.concatenate([marked[:, 1:], np.full((F, 1), S)], axis=1)
    next_mark = np.minimum.accumulate(nxt[:, ::-1], axis=1)[:, ::-1]
    nsec = np.where(layout, next_mark - sec_idx, 0)
    sel = np.flatnonzero(layout.reshape(-1))   # row-major == stream order
    return (sel // S).astype(np.int64), (sel % S).astype(np.int64) * sec, \
        nsec.reshape(-1)[sel].astype(np.int64) * sec


def resolve_device(device) -> torch.device:
    """The device the caller asked for; CUDA must be present when asked
    for (there is no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class Encoder:
    """Batched FLAC encoder with the reference API lifecycle."""

    def __init__(self, cfg: P.StreamConfig, *, device,
                 batch_frames: int = 512,
                 vendor_string: str | None = None):
        self.device = resolve_device(device)
        P.validate_params(cfg)
        p = cfg.params
        if batch_frames < 1:
            raise ValueError("batch_frames must be >= 1")
        # device_wait_seconds: blocked on device results (device work not
        # hidden by the two-deep pipeline); fetch_seconds: compaction and
        # the device-to-host copy; pack_seconds: host CRC patching
        self.stats = {"frames": 0, "batches": 0,
                      "device_wait_seconds": 0.0, "fetch_seconds": 0.0,
                      "pack_seconds": 0.0, "bytes_out": 0}
        self.cfg = cfg
        self.params = p
        self.channels = cfg.channels
        self.bps = cfg.bits_per_sample
        self.sample_rate = cfg.sample_rate
        self.batch_frames = batch_frames
        self.vendor_string = vendor_string or metadata.DEFAULT_VENDOR
        self.sr_code = P.samplerate_code(cfg.sample_rate)
        self.max_frame_size = P.max_frame_size(p.block_size, self.channels,
                                               self.bps)
        self.frame_count = 0          # frames, or samples when allow_vbs
        self.sample_count = cfg.samples
        self.md5 = hashlib.md5()
        self._pending = np.zeros((0, self.channels), dtype=np.int32)
        self._finished = False

    # -- headers / metadata ----------------------------------------------

    def streaminfo(self) -> metadata.StreamInfo:
        p = self.params
        min_bs = 16 if (p.variable_block_size or p.allow_vbs) \
            else p.block_size
        return metadata.StreamInfo(
            min_block_size=min_bs, max_block_size=p.block_size,
            min_frame_size=0, max_frame_size=self.max_frame_size,
            sample_rate=self.sample_rate, channels=self.channels,
            bits_per_sample=self.bps, samples=self.sample_count,
            md5sum=self.md5.copy().digest())

    def header(self) -> bytes:
        vc = metadata.VorbisComment(vendor_string=self.vendor_string)
        return metadata.write_headers(self.streaminfo(),
                                      self.params.padding_size, vc)

    # -- encoding --------------------------------------------------------

    def encode(self, pcm: np.ndarray, last: bool = False) -> bytes:
        """Encode a chunk of interleaved samples (int32 [n, channels]).

        Buffers to whole frames; pass ``last=True`` (or call
        :meth:`finish`) to flush the final partial frame."""
        if self._finished:
            raise RuntimeError("encoder already finished")
        pcm = np.asarray(pcm, dtype=np.int32).reshape(-1, self.channels)
        if self._pending.shape[0]:
            pcm = np.concatenate([self._pending, pcm], axis=0)
        bs = self.params.block_size
        n_full = pcm.shape[0] // bs
        out = bytearray()
        self._pending = pcm[n_full * bs:].copy()
        if n_full:
            # MD5 of the raw input is the one serial chain across frames
            # (md5.c:281-320); it runs on a worker thread while the device
            # works (hashlib releases the GIL for large buffers), and its
            # failure fails the encode
            md5_err: list[BaseException] = []

            def md5_work(buf=pcm[:n_full * bs]):
                try:
                    self._md5_update(buf)
                except BaseException as e:  # re-raised after join
                    md5_err.append(e)

            md5_t = threading.Thread(target=md5_work)
            md5_t.start()
            try:
                out += self._encode_full_frames(
                    pcm[:n_full * bs].reshape(n_full, bs, self.channels))
            finally:
                md5_t.join()
                if md5_err:
                    raise md5_err[0]
        if last:
            out += self.finish()
        return bytes(out)

    def finish(self) -> bytes:
        """Flush the final partial frame (if any) through the device path
        as a batch of one frame of its own block size; under variable
        block sizes a tail that could be a superblock is split as one,
        as the reference's encode_frame does (vbs.c:36-119)."""
        if self._finished:
            return b""
        self._finished = True
        tail = self._pending
        if not tail.shape[0]:
            return b""
        self._pending = np.zeros((0, self.channels), dtype=np.int32)
        out = self._encode_full_frames(tail[None], quantize=False)
        self._md5_update(tail)
        return out

    def encode_stream(self, pcm: np.ndarray) -> bytes:
        """One-shot: full stream -> header + frames with the STREAMINFO
        already rewritten (the flake.c:624-678 loop equivalent)."""
        pcm = np.asarray(pcm, dtype=np.int32).reshape(-1, self.channels)
        self.sample_count = pcm.shape[0]
        body = self.encode(pcm, last=True)
        blob = bytearray(self.header())
        blob += body
        blob[8:8 + 34] = metadata.write_streaminfo(self.streaminfo())
        return bytes(blob)

    # -- internals -------------------------------------------------------

    def _md5_update(self, pcm: np.ndarray):
        if pcm.shape[0] == 0:
            return
        bps_bytes = (self.bps + 7) >> 3
        flat = np.ascontiguousarray(pcm.reshape(-1).astype("<i4"))
        raw = flat.view(np.uint8).reshape(-1, 4)[:, :bps_bytes]
        self.md5.update(np.ascontiguousarray(raw).tobytes())

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor; to a GPU from pinned memory
        without blocking the host."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _upload_samples(self, frames: np.ndarray) -> torch.Tensor:
        """Samples to the device as int32; bps <= 16 samples travel as
        int16 (exact, half the bytes), guarded by a range check so
        out-of-range input keeps int32."""
        up = frames
        if self.bps <= 16 and frames.size \
                and frames.min() >= -32768 and frames.max() < 32768:
            up = frames.astype(np.int16)
        return self._upload(up).to(torch.int32)

    def _encode_full_frames(self, frames: np.ndarray,
                            quantize: bool = True) -> bytes:
        """Encode [F, bs, C] frames of one block size: as superblocks
        under variable block sizes, else as they are
        (``encoder.py:274-289``)."""
        F, bs, _ = frames.shape
        p = self.params
        if (p.variable_block_size and bs % P.VBS_MAX_FRAMES == 0
                and bs >= P.VBS_MIN_BLOCK_SIZE):
            return self._encode_vbs_superblocks(frames, quantize)
        step = bs if p.allow_vbs else 1
        nums = self.frame_count + step * np.arange(F, dtype=np.int64)
        out, _ = self._run_batches(frames, bs, nums, quantize)
        self.frame_count += step * F
        return out

    def _encode_vbs_superblocks(self, frames: np.ndarray,
                                quantize: bool) -> bytes:
        """Split each [bs, C] superblock into sub-frames and encode them
        bucketed by size, one run of batches per size, in stream order
        (``encoder.py:520-571``)."""
        F, bs, _ = frames.shape
        sec = bs // P.VBS_MAX_FRAMES
        res = vbs_section_sums(self._upload_samples(frames), sec)
        f_idx, starts, sizes = vbs_layout(res.cpu().numpy(), sec)
        nums = self.frame_count + f_idx * bs + starts
        pieces: list = [None] * sizes.size
        for size in np.unique(sizes):
            idxs = np.flatnonzero(sizes == size)
            take = starts[idxs, None] + np.arange(size)[None, :]
            blob, lengths = self._run_batches(
                frames[f_idx[idxs, None], take], int(size), nums[idxs],
                quantize)
            bounds = np.concatenate([[0], np.cumsum(lengths)])
            for j, i in enumerate(idxs):
                pieces[i] = blob[bounds[j]:bounds[j + 1]]
        self.frame_count += F * bs
        return b"".join(pieces)

    def _run_batches(self, frames: np.ndarray, block_size: int,
                     nums: np.ndarray, quantize: bool = True):
        """Encode [F, block_size, C] frames in device batches, two deep.
        Returns (bytes, int64 [F] frame lengths)."""
        cfg = FrameConfig.from_params(self.params, self.channels, self.bps,
                                      block_size=block_size)
        bs_code = P.blocksize_code(block_size)
        F = frames.shape[0]
        bsz = self.batch_frames
        # short batches pad to the smallest of a few fixed shapes
        # (encoder.py:323-331), so a stream's last batch does not pay a
        # full batch_frames pass
        allowed = sorted({max(1, bsz // 64), max(1, bsz // 8), bsz})
        out = bytearray()
        all_lengths = []

        def dispatch(start):
            """Enqueue one batch; returns device tensors still computing."""
            chunk = frames[start:start + bsz]
            cnums = nums[start:start + bsz]
            n = chunk.shape[0]
            shape = next(b for b in allowed if b >= n) if quantize else n
            if n < shape:
                chunk = np.concatenate(
                    [chunk, np.zeros((shape - n,) + chunk.shape[1:],
                                     np.int32)])
                cnums = np.concatenate(
                    [cnums, np.zeros(shape - n, cnums.dtype)])
            hdr_bytes, hdr_nb = bitpack.frame_header_bytes(
                cnums, bs_code=bs_code, sr_code=self.sr_code,
                allow_vbs=self.params.allow_vbs)
            samples = self._upload_samples(chunk)
            # frame headers are whole bytes, CRC-8 included
            analysis = analyze_frames(samples, cfg, self._upload(hdr_nb * 8))
            words, total_bits = bitpack.pack_frames_device(
                analysis, self._upload(hdr_bytes), self._upload(hdr_nb),
                cfg)
            return words, total_bits, analysis["frame_bytes"], hdr_nb, n

        def drain(item):
            """Check one batch's bit counts, compact its frames to their
            exact bytes on the device, copy them back, patch the CRCs."""
            words, total_bits, frame_bytes, hdr_nb, n = item
            t0 = time.perf_counter()
            tb = total_bits.cpu().numpy()            # waits for the device
            fb = frame_bytes.cpu().numpy()
            t_ready = time.perf_counter()
            if not np.array_equal(tb[:n], fb[:n] * 8):
                raise AssertionError(
                    "device emission bit count mismatch: "
                    f"{tb[:8]} vs {fb[:8] * 8}")
            buf = bitpack.compact(words[:n], frame_bytes[:n]).cpu().numpy()
            t1 = time.perf_counter()
            lengths = fb[:n].astype(np.int64)
            crc_patch(buf, lengths, hdr_nb[:n])
            self.max_frame_size = max(self.max_frame_size,
                                      int(lengths.max(initial=0)))
            out.extend(buf.tobytes())
            all_lengths.append(lengths)
            self.stats["frames"] += n
            self.stats["batches"] += 1
            self.stats["device_wait_seconds"] += t_ready - t0
            self.stats["fetch_seconds"] += t1 - t_ready
            self.stats["pack_seconds"] += time.perf_counter() - t1
            self.stats["bytes_out"] += buf.shape[0]

        inflight: list = []
        for start in range(0, F, bsz):
            inflight.append(dispatch(start))
            if len(inflight) >= 2:
                drain(inflight.pop(0))
        for item in inflight:
            drain(item)
        lengths = np.concatenate(all_lengths) if all_lengths \
            else np.zeros(0, np.int64)
        return bytes(out), lengths
