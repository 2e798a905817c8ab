"""Batched FLAC encoder on a GPU or a mesh of them (port of
``flake_tpu/encoder.py``).

The stream is cut into fixed-size frames; a batch of up to
``batch_frames`` frames is uploaded as int16, analysed on the device
(:func:`~flake_tpu_torch.ops.frame.analyze_frames`, kernels K1, and K2
or K4) and emitted by one of two backends (``pack_backend``):

- ``"device"`` (and ``"auto"``, which the JAX package resolves to the
  device emission for every legal config): FLAC bytes on the device
  (:func:`~flake_tpu_torch.ops.bitpack.pack_frames_device`, kernel K3);
  the host fetches only the compacted frame bytes and patches their CRCs.
- ``"host"``: the host fetches the analysis tensors and packs whole
  frames with the native packer (:func:`~flake_tpu_torch.native.
  pack_frames`), which checks its lengths against the device's
  ``frame_bytes``.

MD5 runs over the raw input on a worker thread. Batches run two deep:
batch i+1 is enqueued before batch i is copied back. The final partial
frame takes the same device analysis as a batch of one frame, then the
chosen emission.

Variable block sizes (levels 9-12, ``encoder.py:520-571`` of the JAX
package): each block is a superblock of eight sections whose
second-difference sums are taken on the device
(:func:`vbs_section_sums`); the split layout and the bucketing of
sub-frames by size stay on the host in numpy (:func:`vbs_layout`), and
each bucket is encoded as batches of its own block size. Under
``allow_vbs`` frames are numbered by their first sample.

API lifecycle mirrors the reference (flake.h:217-234): construct ->
header() -> encode chunks -> streaminfo() rewrite. Every preset level
0-12 encodes. The constructor takes the JAX package's arguments
(``lpc_dtype``, ``vorbis_entries``, ``pack_backend``, ``mesh``): with a
mesh (:mod:`flake_tpu_torch.parallel.mesh`) each batch's frames split
into contiguous groups, one a row of the mesh, and under sp each frame's
samples over the row's devices; the groups' bytes join in frame order.
One device is the mesh of one group. ``save_state`` /
``load_state`` resume an interrupted encode.
"""

from __future__ import annotations

import hashlib
import threading
import time

import numpy as np
import torch

from flake_tpu_torch import metadata
from flake_tpu_torch import params as P
from flake_tpu_torch.md5 import pcm_md5_bytes
from flake_tpu_torch.native import crc_patch, pack_frames
from flake_tpu_torch.ops import bitpack
from flake_tpu_torch.ops.frame import LPC_DTYPES, FrameConfig

PACK_BACKENDS = ("auto", "device", "host")

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


def upload(arr, device: torch.device) -> torch.Tensor:
    """Host array (numpy or CPU tensor) -> tensor on ``device``; to a GPU
    from pinned memory without blocking the host."""
    t = arr if isinstance(arr, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


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

    def __init__(self, cfg: P.StreamConfig, *, device=None,
                 batch_frames: int = 512,
                 lpc_dtype: str = "float64",
                 vendor_string: str | None = None,
                 vorbis_entries: list[str] | None = None,
                 mesh=None, pack_backend: str = "auto"):
        """``device``: where the batches run ("cuda", "cuda:N" or "cpu");
        required unless ``mesh`` names the devices instead.
        ``lpc_dtype``: "float64" (the reference's doubles; K1) or
        "float32" (plain float32 autocorrelation and recursions; the
        stream stays lossless). ``vorbis_entries``: "NAME=value" strings
        for the VORBIS_COMMENT block; an invalid one raises ``ValueError``
        from :meth:`header`. ``mesh``: a
        :class:`~flake_tpu_torch.parallel.mesh.Mesh`; each batch's frames
        split over its devices, and at an LPC level a frame's samples
        over its sp axis (``batch_frames`` a multiple of its size). ``pack_backend``: "device", "host" or "auto"
        (= "device"); the bytes are the same."""
        from flake_tpu_torch.parallel.mesh import Mesh, make_mesh

        if mesh is None:
            if device is None:
                raise TypeError("Encoder needs a device or a mesh")
            self.device = resolve_device(device)
        else:
            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a Mesh, not {type(mesh)}")
            if device is not None:
                raise ValueError("give the Encoder a device or a mesh, "
                                 "not both")
            # frames split over every device of the mesh (dp, dp and sp
            # folded together, or under sp each rank emitting its share of
            # its group's frames), so the batch must divide by its size
            if batch_frames % mesh.size:
                raise ValueError(f"batch_frames {batch_frames} must divide "
                                 f"by the mesh size {mesh.size}")
            self.device = mesh.devices.flat[0]
        self.mesh = mesh
        # the groups a batch splits into: one without a mesh
        self._groups = mesh if mesh is not None \
            else make_mesh(devices=[self.device])
        self._sharded_analyzers: dict = {}
        self._sharded_packers: dict = {}
        P.validate_params(cfg)
        p = cfg.params
        if batch_frames < 1:
            raise ValueError("batch_frames must be >= 1")
        if lpc_dtype not in LPC_DTYPES:
            raise ValueError(f"bad lpc_dtype {lpc_dtype!r}")
        if pack_backend not in PACK_BACKENDS:
            raise ValueError(f"bad pack_backend {pack_backend!r}")
        self.lpc_dtype = lpc_dtype
        self.pack_backend = pack_backend
        self.vorbis_entries = list(vorbis_entries or [])
        # device_wait_seconds: blocked on device results (device work not
        # hidden by the two-deep pipeline); fetch_seconds: the
        # device-to-host copy (of the compacted bytes, or of the analysis
        # tensors under the host emission); pack_seconds: host CRC
        # patching, or host packing
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
        self.bps_code = P.bps_code(cfg.bits_per_sample)
        self.ch_code = cfg.channels - 1
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
        for entry in self.vorbis_entries:
            if not metadata.add_vorbiscomment_entry(vc, entry):
                raise ValueError(f"invalid vorbis comment {entry!r}")
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

    # -- checkpoint / resume ---------------------------------------------

    def save_state(self) -> dict:
        """The encoder's state for resuming after an interruption: FLAC is
        append-only (header first, frames appended, STREAMINFO patched at
        the end), so a resume reopens the output at the last flushed byte
        and continues from here (``flake_tpu/encoder.py:217-237``)."""
        return {
            "frame_count": self.frame_count,
            "max_frame_size": self.max_frame_size,
            "sample_count": self.sample_count,
            "md5_state": self.md5.copy(),
            "pending": self._pending.copy(),
            "finished": self._finished,
        }

    def load_state(self, state: dict) -> None:
        self.frame_count = state["frame_count"]
        self.max_frame_size = state["max_frame_size"]
        self.sample_count = state["sample_count"]
        self.md5 = state["md5_state"].copy()
        self._pending = state["pending"].copy()
        self._finished = state["finished"]

    # -- internals -------------------------------------------------------

    def _md5_update(self, pcm: np.ndarray):
        if pcm.shape[0]:
            self.md5.update(pcm_md5_bytes(pcm, self.bps))

    def _narrow(self, frames: np.ndarray) -> np.ndarray:
        """The samples as they travel to the device: bps <= 16 samples as
        int16 (exact, half the bytes), guarded by a range check so
        out-of-range input keeps int32."""
        if self.bps <= 16 and frames.size \
                and frames.min() >= -32768 and frames.max() < 32768:
            return frames.astype(np.int16)
        return frames

    def _upload_samples(self, frames: np.ndarray) -> torch.Tensor:
        """Samples to the device as int32 (through :meth:`_narrow`)."""
        return upload(self._narrow(frames), self.device).to(torch.int32)

    def _sharded(self, cfg: FrameConfig, emit: bool):
        """The sharded packer (``emit``) or analyzer of ``cfg`` over the
        batch's groups, built once a config
        (``flake_tpu/encoder.py:241-250,298-307``)."""
        from flake_tpu_torch.parallel import mesh as mesh_mod

        cache = self._sharded_packers if emit else self._sharded_analyzers
        if cfg not in cache:
            cache[cfg] = (
                mesh_mod.make_sharded_packer(cfg, self._groups) if emit
                else mesh_mod.make_sharded_analyzer(cfg, self._groups))
        return cache[cfg]

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
        # the section sums a batch of superblocks at a time, so that the
        # device holds a batch's int64 temporaries, not the whole stream's
        res = np.concatenate([
            vbs_section_sums(self._upload_samples(
                frames[i:i + self.batch_frames]), sec).cpu().numpy()
            for i in range(0, max(F, 1), self.batch_frames)])
        f_idx, starts, sizes = vbs_layout(res, sec)
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
        from flake_tpu_torch.parallel.mesh import on_host

        cfg = FrameConfig.from_params(self.params, self.channels, self.bps,
                                      block_size=block_size,
                                      lpc_dtype=self.lpc_dtype)
        bs_code = P.blocksize_code(block_size)
        host_emission = self.pack_backend == "host"
        F = frames.shape[0]
        bsz = self.batch_frames
        dp = self._groups.size
        # short batches pad to the smallest of a few fixed shapes
        # (encoder.py:323-331), so a stream's last batch does not pay a
        # full batch_frames pass; under a mesh, those that split over it
        allowed = sorted({b for b in (max(1, bsz // 64), max(1, bsz // 8))
                          if b % dp == 0} | {bsz})
        out = bytearray()
        all_lengths = []

        def dispatch(start):
            """Enqueue one batch; returns, for each group of frames, device
            tensors still computing."""
            chunk = frames[start:start + bsz]
            cnums = nums[start:start + bsz]
            n = chunk.shape[0]
            shape = next(b for b in allowed if b >= n) if quantize \
                else -(-n // dp) * dp
            if n < shape:
                chunk = np.concatenate(
                    [chunk, np.zeros((shape - n,) + chunk.shape[1:],
                                     np.int32)])
                cnums = np.concatenate(
                    [cnums, np.zeros(shape - n, cnums.dtype)])
            hdr_bytes, hdr_nb = bitpack.frame_header_bytes(
                cnums, bs_code=bs_code, sr_code=self.sr_code,
                allow_vbs=self.params.allow_vbs)
            # frame headers are whole bytes, CRC-8 included
            hdr_bits = hdr_nb * 8
            up = self._narrow(chunk)
            if host_emission:
                analysis = self._sharded(cfg, False)(up, hdr_bits)
                analysis.pop("global_max_frame_bytes")
                return analysis, cnums, n
            run, gather, _ = self._sharded(cfg, True)
            packed = run(up, hdr_bits, hdr_bytes, hdr_nb)
            return (packed["words"], packed["total_bits"],
                    packed["frame_bytes"], gather, hdr_nb, n)

        def fetch(groups: list) -> np.ndarray:
            """The groups' tensors, to the host and joined in frame order
            (a residual split over sp ranks along the sample axis)."""
            return on_host(groups).numpy()

        def drain_host(item):
            """Copy one batch's analysis tensors back and pack its frames
            on the host (``flake_tpu/encoder.py:467-504``)."""
            analysis, cnums, n = item
            t0 = time.perf_counter()
            for t in analysis["frame_bytes"]:        # waits for the devices
                t.cpu()
            t_ready = time.perf_counter()
            host = {k: fetch(v)[:n] for k, v in analysis.items()}
            t1 = time.perf_counter()
            blob, lengths = pack_frames(
                host, cnums[:n].astype(np.uint64), block_size=block_size,
                channels=self.channels, bps_code=self.bps_code,
                sr_code=self.sr_code, bs_code=bs_code,
                allow_vbs=self.params.allow_vbs, precision=cfg.precision,
                ch_code=self.ch_code,
                max_frame_size=P.max_frame_size(block_size, self.channels,
                                                self.bps))
            # the device-predicted sizes must equal the packed bytes
            if not np.array_equal(host["frame_bytes"], lengths):
                raise AssertionError(
                    "device/host frame size mismatch: "
                    f"{host['frame_bytes'][:8]} vs {lengths[:8]}")
            finish(blob, lengths, n, t0, t_ready, t1)

        def finish(blob, lengths, n, t0, t_ready, t1):
            """Append one drained batch and count it."""
            self.max_frame_size = max(self.max_frame_size,
                                      int(lengths.max(initial=0)))
            out.extend(blob)
            all_lengths.append(lengths)
            self.stats["frames"] += n
            self.stats["batches"] += 1
            self.stats["device_wait_seconds"] += t_ready - t0
            self.stats["fetch_seconds"] += t1 - t_ready
            self.stats["pack_seconds"] += time.perf_counter() - t1
            self.stats["bytes_out"] += len(blob)

        def drain_device(item):
            """Check one batch's bit counts, compact its frames to their
            exact bytes on the device, copy them back, patch the CRCs."""
            words, total_bits, frame_bytes, gather, hdr_nb, n = item
            t0 = time.perf_counter()
            tb = fetch(total_bits)                   # waits for the devices
            fb = fetch(frame_bytes)
            t_ready = time.perf_counter()
            if not np.array_equal(tb[:n], fb[:n] * 8):
                raise AssertionError(
                    "device emission bit count mismatch: "
                    f"{tb[:8]} vs {fb[:8] * 8}")
            # each group compacts on its device; the CRC patch below runs
            # over the whole batch (flake_tpu/encoder.py:400-460)
            buf = fetch(gather(words, frame_bytes, n))
            t1 = time.perf_counter()
            lengths = fb[:n].astype(np.int64)
            crc_patch(buf, lengths, hdr_nb[:n])
            finish(buf.tobytes(), lengths, n, t0, t_ready, t1)

        drain = drain_host if host_emission else drain_device
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
