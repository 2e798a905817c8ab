"""The port's host packer (``flake_tpu_torch/csrc/packer.cpp`` through
``flake_tpu_torch.native``) against the JAX package's
(``flake_tpu/native/packer.cpp`` through ``flake_tpu.native``).

One JAX ``analyze_frames`` dict at level 8 (B = 512, 16-bit stereo, with
silent, verbatim and mid/side frames) and one at 24 bits go through both
``pack_frames``; bytes and lengths must be equal, and equal the frame
sizes the analysis predicted. CRC-8, CRC-16 and the MD5 block compress
must equal the originals, and an out-of-range analysis must raise in
both.
"""

import functools
import hashlib

import numpy as np
import pytest

import jax.numpy as jnp

from flake_tpu import native as jnative
from flake_tpu import params as JP
from flake_tpu.ops.frame import FrameConfig, analyze_frames_jit

from flake_tpu_torch import native as tnative
from flake_tpu_torch import params as TP
from flake_tpu_torch.ops import bitpack as tbitpack

from conftest import make_test_signal

B = 512
F = 8


@functools.lru_cache(maxsize=None)
def _analysis(bps: int):
    """(host analysis dict, pack keyword arguments, frame numbers) of F
    level-8 frames at ``bps`` bits, from the JAX package."""
    rng = np.random.default_rng(bps)
    frames = make_test_signal(F * B, 2, bps, seed=bps).reshape(F, B, 2)
    top = (1 << (bps - 1)) - 1
    frames[1] = 0                                           # constant
    frames[2] = rng.choice([-top - 1, top], (B, 2))         # verbatim
    frames[3, :, 1] = frames[3, :, 0] // 2 + 7              # mid/side
    nums = np.arange(100, 100 + F, dtype=np.int64)
    bs_code = TP.blocksize_code(B)
    sr_code = TP.samplerate_code(44100)
    _, hdr_nb = tbitpack.frame_header_bytes(nums, bs_code=bs_code,
                                            sr_code=sr_code, allow_vbs=0)
    cfg = FrameConfig.from_params(JP.set_defaults(8), 2, bps, block_size=B)
    out = analyze_frames_jit(jnp.asarray(frames), cfg,
                             jnp.asarray(hdr_nb * 8))
    host = {k: np.asarray(v) for k, v in out.items() if v is not None}
    kwargs = dict(block_size=B, channels=2, bps_code=TP.bps_code(bps),
                  sr_code=sr_code, bs_code=bs_code, allow_vbs=0,
                  precision=TP.LPC_PRECISION, ch_code=1,
                  max_frame_size=TP.max_frame_size(B, 2, bps))
    return host, kwargs, nums.astype(np.uint64)


@pytest.mark.parametrize("bps", [16, 24])
def test_pack_frames_matches_the_original(bps):
    host, kwargs, nums = _analysis(bps)
    want, want_len = jnative.pack_frames(host, nums, **kwargs)
    got, got_len = tnative.pack_frames(host, nums, **kwargs)
    assert got == want
    np.testing.assert_array_equal(got_len, want_len)
    np.testing.assert_array_equal(got_len, host["frame_bytes"])
    assert {0, 1, 32} <= set(host["sf_type"].ravel().tolist())


@pytest.mark.parametrize("field,value", [("rice_params", 31),
                                         ("order", 40), ("obits", 0)])
def test_out_of_range_analysis_raises(field, value):
    host, kwargs, nums = _analysis(16)
    bad = {k: v.copy() for k, v in host.items()}
    bad[field].reshape(-1)[0] = value
    for mod in (jnative, tnative):
        with pytest.raises(ValueError):
            mod.pack_frames(bad, nums, **kwargs)


def test_frame_over_its_slot_raises():
    host, kwargs, nums = _analysis(16)
    small = dict(kwargs, max_frame_size=16)
    for mod in (jnative, tnative):
        with pytest.raises(ValueError):
            mod.pack_frames(host, nums, **small)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 1000])
def test_crc8_crc16(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    jlib = jnative.get_lib()
    assert tnative.crc8(data.tobytes()) == jlib.flake_crc8(data, n)
    assert tnative.crc16(data.tobytes()) == jlib.flake_crc16(data, n)


@pytest.mark.parametrize("nblocks", [1, 3, 64])
def test_md5_blocks(nblocks):
    data = np.random.default_rng(nblocks).integers(
        0, 256, 64 * nblocks, dtype=np.uint8)
    init = np.array([0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476],
                    dtype=np.uint32)
    want, got = init.copy(), init.copy()
    jnative.get_lib().flake_md5_blocks(want, data, nblocks)
    tnative.md5_blocks(got, data.tobytes())
    np.testing.assert_array_equal(got, want)
    # one padded block more gives hashlib's digest of the message
    tail = np.zeros(64, np.uint8)
    tail[0] = 0x80
    tail[56:] = np.frombuffer(np.uint64(len(data) * 8).tobytes(), np.uint8)
    tnative.md5_blocks(got, tail.tobytes())
    assert got.tobytes() == hashlib.md5(data.tobytes()).digest()
    with pytest.raises(ValueError):
        tnative.md5_blocks(got, data.tobytes()[:63])
