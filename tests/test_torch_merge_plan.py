"""K3's launch choice (``flake_tpu_torch.ops.bitmerge.merge_in_shared``).

The kernel (``flake_tpu_torch/csrc/bitmerge.cu``) has two instantiations
of one body: a frame's words staged in shared memory, or ORed into device
memory. The wrapper picks by the frame's word rows alone: every frame
whose words fit ``MERGE_SHARED_CAP`` bytes is staged, and the cap leaves
room for two blocks on an SM of an H100 (227 KiB a block, 228 KiB an SM).
The frame sizes are those of the streams the encoder is given.
"""

import pathlib
import re

import pytest

from flake_tpu_torch import _cuda
from flake_tpu_torch import params as P
from flake_tpu_torch.ops import bitmerge, bitpack, frame

SM_SHARED = 228 * 1024          # an H100 SM's shared memory for blocks
BLOCK_SHARED = 227 * 1024       # the most one block may take


def _word_rows(level, channels, bps, block_size=None):
    params = P.set_defaults(level)
    return bitpack.word_rows(frame.FrameConfig.from_params(
        params, channels, bps, block_size=block_size))


@pytest.mark.parametrize("level,channels,bps,block_size,staged", [
    (8, 2, 16, None, True),          # 17,408 bytes of words
    (12, 2, 16, 8192, True),         # 34,304
    (8, 2, 24, None, True),          # 25,600
    (5, 6, 16, None, True),          # 49,664: above the 48 KiB default
    (5, 8, 24, None, False),         # 98,816
    (8, 8, 32, 65535, False),        # about 2 MB: no card holds it
    (0, 2, 16, None, True),          # 1152-sample blocks
])
def test_instantiation_by_frame_words(level, channels, bps, block_size,
                                      staged):
    wr = _word_rows(level, channels, bps, block_size)
    assert bitmerge.merge_in_shared(wr) is staged
    assert (wr * bitmerge.LANE * 4 <= bitmerge.MERGE_SHARED_CAP) is staged


def test_cap_is_a_word_row_boundary_and_fits_the_card():
    cap = bitmerge.MERGE_SHARED_CAP
    rows = cap // (bitmerge.LANE * 4)
    assert rows * bitmerge.LANE * 4 == cap
    assert bitmerge.merge_in_shared(rows)
    assert not bitmerge.merge_in_shared(rows + 1)
    assert cap <= BLOCK_SHARED and 2 * (cap + 1024) <= SM_SHARED


def test_threads_are_an_instantiated_block_size():
    """The kernel compiles one block size, whole warps, and its entry
    takes no block size: the pointers, F, M, W, the instantiation and the
    stream."""
    src = (pathlib.Path(bitmerge.__file__).parents[1] / "csrc"
           / "bitmerge.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src)[1])
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert len(_cuda.SIGNATURES["flake_merge_words"]) == 9
