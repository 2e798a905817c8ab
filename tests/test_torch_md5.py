"""The port's exportable MD5 chain against the JAX package's and hashlib.

``flake_tpu_torch.md5.Md5Chain`` must give ``hashlib.md5``'s digest and
``flake_tpu.md5.Md5Chain``'s at every cut of the input (0, 1, 63, 64, 65
and 4,097 bytes among them), export the JAX package's 88-byte blob byte
for byte, and take a blob of either package; ``pcm_md5_bytes`` must equal
the JAX function at 8-32 bits a sample.
"""

import hashlib

import numpy as np
import pytest

from flake_tpu import md5 as jmd5

from flake_tpu_torch import md5 as tmd5

CUTS = (0, 1, 63, 64, 65, 4097)


def _data(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


@pytest.mark.parametrize("first", CUTS)
@pytest.mark.parametrize("second", CUTS)
def test_chain_matches_hashlib_and_jax(first, second):
    data = _data(first + second + 7, seed=first * 31 + second)
    pieces = (data[:first], data[first:first + second],
              data[first + second:])
    t, j = tmd5.Md5Chain(), jmd5.Md5Chain()
    for piece in pieces:
        t.update(piece)
        j.update(piece)
        assert t.export_state() == j.export_state()
    assert t.digest() == j.digest() == hashlib.md5(data).digest()
    assert t.hexdigest() == hashlib.md5(data).hexdigest()
    # digest does not consume the chain
    t.update(b"x")
    assert t.digest() == hashlib.md5(data + b"x").digest()


@pytest.mark.parametrize("cut", CUTS)
def test_blobs_cross_import(cut):
    data = _data(2 * cut + 100, seed=cut)
    t, j = tmd5.Md5Chain(), jmd5.Md5Chain()
    t.update(data[:cut])
    j.update(data[:cut])
    blob = t.export_state()
    assert len(blob) == tmd5.STATE_BYTES and blob == j.export_state()
    from_jax = tmd5.Md5Chain.import_state(j.export_state())
    from_port = jmd5.Md5Chain.import_state(blob)
    from_jax.update(data[cut:])
    from_port.update(data[cut:])
    want = hashlib.md5(data).digest()
    assert from_jax.digest() == from_port.digest() == want
    copy = t.copy()
    copy.update(data[cut:])
    assert copy.digest() == want
    assert t.export_state() == blob          # the copy is independent


def test_numpy_input_and_bad_blob():
    arr = np.arange(1000, dtype=np.int32)
    t = tmd5.Md5Chain()
    t.update(arr)
    assert t.digest() == hashlib.md5(arr.tobytes()).digest()
    with pytest.raises(ValueError):
        tmd5.Md5Chain.import_state(b"\0" * 87)
    bad = bytearray(t.export_state())
    bad[24] = 64                             # a tail is under 64 bytes
    with pytest.raises(ValueError):
        tmd5.Md5Chain.import_state(bytes(bad))


@pytest.mark.parametrize("bps", [8, 12, 16, 20, 24, 32])
def test_pcm_md5_bytes_matches_jax(bps):
    rng = np.random.default_rng(bps)
    lo, hi = -(1 << (bps - 1)), (1 << (bps - 1))
    pcm = rng.integers(lo, hi, (777, 3), dtype=np.int64).astype(np.int32)
    got = tmd5.pcm_md5_bytes(pcm, bps)
    assert got == jmd5.pcm_md5_bytes(pcm, bps)
    assert len(got) == pcm.size * ((bps + 7) // 8)
