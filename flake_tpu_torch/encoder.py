"""Batched FLAC encoder on one GPU (port of ``flake_tpu/encoder.py``).

The stream is cut into fixed-size frames; a batch of up to
``batch_frames`` frames is uploaded as int16, analysed on the device
(:func:`~flake_tpu_torch.ops.frame.analyze_frames`, kernels K1 and K2)
and emitted as FLAC bytes on the device
(:func:`~flake_tpu_torch.ops.bitpack.pack_frames_device`, kernel K3).
The host fetches only the compacted frame bytes and patches their CRCs,
while MD5 runs over the raw input on a worker thread. Batches run two
deep: batch i+1 is enqueued before batch i is copied back. The final
partial frame takes the same device path as a batch of one frame.

API lifecycle mirrors the reference (flake.h:217-234): construct ->
header() -> encode chunks -> streaminfo() rewrite. Not ported yet, and
refused: variable block sizes (levels 9-12), the EST and 2/4/8-LEVEL
order methods (levels 3-7), a device mesh, host packing and
save/load of encoder state.
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

PORTED_ORDER_METHODS = (P.OrderMethod.MAX, P.OrderMethod.SEARCH,
                        P.OrderMethod.LOG)


def _device(device) -> torch.device:
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
        self.device = _device(device)
        P.validate_params(cfg)
        p = cfg.params
        if p.variable_block_size or p.allow_vbs:
            raise NotImplementedError(
                "variable block sizes (levels 9-12) are not ported yet")
        if (p.prediction_type == P.Prediction.LEVINSON
                and p.order_method not in PORTED_ORDER_METHODS):
            raise NotImplementedError(
                f"order method {P.OrderMethod(p.order_method).name} is "
                "not ported yet")
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
        self.frame_count = 0
        self.sample_count = cfg.samples
        self.md5 = hashlib.md5()
        self._pending = np.zeros((0, self.channels), dtype=np.int32)
        self._finished = False

    # -- headers / metadata ----------------------------------------------

    def streaminfo(self) -> metadata.StreamInfo:
        p = self.params
        return metadata.StreamInfo(
            min_block_size=p.block_size, max_block_size=p.block_size,
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
                frames = pcm[:n_full * bs].reshape(n_full, bs,
                                                   self.channels)
                nums = self.frame_count + np.arange(n_full, dtype=np.int64)
                out += self._run_batches(frames, bs, nums)
                self.frame_count += n_full
            finally:
                md5_t.join()
                if md5_err:
                    raise md5_err[0]
        if last:
            out += self.finish()
        return bytes(out)

    def finish(self) -> bytes:
        """Flush the final partial frame (if any) through the device path
        as a batch of one frame of its own block size."""
        if self._finished:
            return b""
        self._finished = True
        tail = self._pending
        if not tail.shape[0]:
            return b""
        self._pending = np.zeros((0, self.channels), dtype=np.int32)
        out = self._run_batches(tail[None], tail.shape[0],
                                np.array([self.frame_count], np.int64),
                                quantize=False)
        self.frame_count += 1
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

    def _run_batches(self, frames: np.ndarray, block_size: int,
                     nums: np.ndarray, quantize: bool = True) -> bytes:
        """Encode [F, block_size, C] frames in device batches, two deep."""
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
                cnums, bs_code=bs_code, sr_code=self.sr_code, allow_vbs=0)
            # bps <= 16 samples upload as int16 (exact, half the bytes),
            # guarded by a range check so out-of-range input keeps int32
            up = chunk
            if self.bps <= 16 and chunk.size \
                    and chunk.min() >= -32768 and chunk.max() < 32768:
                up = chunk.astype(np.int16)
            samples = self._upload(up).to(torch.int32)
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
        return bytes(out)
