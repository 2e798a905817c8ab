"""The port's bitstream emission against the JAX package.

Given the same analysis (the JAX package's ``analyze_frames_jit``
output), the port's slot layout must equal ``pack_frames_device``'s
(``debug=True``), K3's plain merge must equal the ``backend="xla"``
words and bit counts, and the compacted, CRC-patched bytes must equal
the native host packer's, including blocks shorter than 32 samples that
the JAX layout cannot take.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flake_tpu import native as jnative
from flake_tpu import params as JP
from flake_tpu.ops import bitpack as jbitpack
from flake_tpu.ops.frame import FrameConfig, analyze_frames_jit

from flake_tpu_torch import native as tnative
from flake_tpu_torch import params as TP
from flake_tpu_torch.ops import bitpack as tbitpack

from conftest import make_test_signal


def _hdr_bits(hdr_nb):
    return hdr_nb.astype(np.int32) * 8


def _case(level, B, F, bps, seed):
    """A batch of frames, its JAX analysis and header bytes."""
    cfg = FrameConfig.from_params(JP.set_defaults(level), 2, bps,
                                  block_size=B)
    frames = make_test_signal(F * B, 2, bps, seed=seed).reshape(F, B, 2)
    rng = np.random.default_rng(seed)
    lim = 1 << (bps - 1)
    if F > 1:
        frames[1] = rng.integers(-lim, lim, (B, 2))          # verbatim
    if F > 2:
        frames[2] = 0                                        # constant
    nums = np.arange(F, dtype=np.int64) * 300                # utf8 widths
    hdr_bytes, hdr_nb = jbitpack.frame_header_bytes(
        nums, bs_code=JP.blocksize_code(B),
        sr_code=JP.samplerate_code(44100), allow_vbs=0)
    analysis = analyze_frames_jit(jnp.asarray(frames), cfg,
                                  jnp.asarray(_hdr_bits(hdr_nb)))
    host = {k: np.array(v) for k, v in analysis.items()}
    return cfg, analysis, host, nums, hdr_bytes, hdr_nb


def _torch(host):
    return {k: torch.from_numpy(v) for k, v in host.items()}


@pytest.mark.parametrize("level,B,F,bps", [(8, 1024, 4, 16),
                                           (8, 256, 3, 32)])
def test_layout_and_merge_match_jax(level, B, F, bps):
    cfg, analysis, host, nums, hdr_bytes, hdr_nb = _case(level, B, F, bps,
                                                         seed=B + bps)
    tcfg = TP.from_reference(cfg)
    want = jax.jit(functools.partial(
        jbitpack.pack_frames_device, cfg=cfg, debug=True))(
        analysis, jnp.asarray(hdr_bytes), jnp.asarray(hdr_nb))
    got = tbitpack.slot_layout(_torch(host), torch.from_numpy(hdr_bytes),
                               torch.from_numpy(hdr_nb), tcfg)
    for name, w, g in zip(("lengths", "leading", "payload"), want, got):
        np.testing.assert_array_equal(
            g.numpy().view(np.uint32) if name == "payload" else g.numpy(),
            np.asarray(w), err_msg=name)

    words_j, tb_j, _ = jax.jit(functools.partial(
        jbitpack.pack_frames_device, cfg=cfg, backend="xla"))(
        analysis, jnp.asarray(hdr_bytes), jnp.asarray(hdr_nb))
    words_t, tb_t = tbitpack.pack_frames_device(
        _torch(host), torch.from_numpy(hdr_bytes),
        torch.from_numpy(hdr_nb), tcfg)
    np.testing.assert_array_equal(words_t.numpy(), np.asarray(words_j))
    np.testing.assert_array_equal(tb_t.numpy(), np.asarray(tb_j))
    np.testing.assert_array_equal(tb_t.numpy(), host["frame_bytes"] * 8)


@pytest.mark.parametrize("B", [1024, 20, 10, 3])
def test_bytes_match_native_packer(B):
    """Device-emitted, compacted, CRC-patched bytes == the C++ packer's.
    B = 20 takes the LPC path, 10 the FIXED path, 3 VERBATIM; for
    B < 32 the JAX layout fails (bitpack.py:479-485) and the port's
    padded warm-up view does not."""
    # B = 1024 reuses the layout test's compiled analysis (same shapes)
    F = 4 if B >= 32 else 1
    cfg, _, host, nums, hdr_bytes, hdr_nb = _case(8, B, F, 16, seed=B)
    tcfg = TP.from_reference(cfg)
    words, total_bits = tbitpack.pack_frames_device(
        _torch(host), torch.from_numpy(hdr_bytes), torch.from_numpy(hdr_nb),
        tcfg)
    fb = host["frame_bytes"]
    np.testing.assert_array_equal(total_bits.numpy(), fb * 8)
    buf = tbitpack.compact(words, torch.from_numpy(fb)).numpy()
    tnative.crc_patch(buf, fb.astype(np.int64), hdr_nb)

    want, lengths = jnative.pack_frames(
        host, nums.astype(np.uint64), block_size=B, channels=2,
        bps_code=JP.bps_code(16), sr_code=JP.samplerate_code(44100),
        bs_code=JP.blocksize_code(B), allow_vbs=0,
        precision=JP.LPC_PRECISION, ch_code=1,
        max_frame_size=JP.max_frame_size(B, 2, 16))
    np.testing.assert_array_equal(lengths, fb)
    assert buf.tobytes() == want
