"""K2's split plan (``flake_tpu_torch.ops.sweep.sweep_plan``).

The kernel takes its geometry from the plan and derives each thread's
segment from its block and thread index as :func:`_segments` does
(``flake_tpu_torch/csrc/sweep.cu``: ``p0``, ``pl``, ``s``, ``s0``, ``len``).
For every shape the tests and the encoder give K2, the segments must cover
every sample of every partition exactly once, lie inside one partition,
and have every sample a counted prediction reads (the ``max_order``
samples before it) in the segment or its halo of ``bucket`` samples; a
block must hold whole partitions within its threads and its shared
memory. The level-12 buckets of few streams must spread over the card.
"""

import itertools

import pytest

from flake_tpu_torch.ops import sweep as tsweep

BLOCKS = (20, 777, 1024, 4048, 4096, 7168, 8192)
ORDERS = (1, 8, 12, 13, 32)
PMAX = (0, 2, 4, 6, 8)


def _segments(plan, B, pmax_static):
    """The segments of one stream under ``plan``, as the kernel derives
    them: (block, thread, partition, first sample, length) for every
    thread that has one."""
    psize, parts = B >> pmax_static, 1 << pmax_static
    for block in range(plan.blocks):
        p0 = block * plan.ppb
        for t in range(tsweep.SWEEP_THREADS):
            pl, s = divmod(t, plan.spp)
            if pl < min(plan.ppb, parts - p0):
                p = p0 + pl
                yield (block, t, p, p * psize + s * plan.seg,
                       min(plan.seg, psize - s * plan.seg))


def _shapes():
    for B, pmax in itertools.product(BLOCKS, PMAX):
        if B % (1 << pmax) == 0:
            yield B, pmax


@pytest.mark.parametrize("B,pmax", list(_shapes()))
def test_plan_covers_every_partition_once(B, pmax):
    psize, parts = B >> pmax, 1 << pmax
    for N, order in itertools.product((1, 12, 1024), ORDERS):
        plan = tsweep.sweep_plan(N, B, order, pmax)
        assert plan.bucket >= order and plan.bucket in \
            tsweep.SWEEP_ORDER_BUCKETS
        assert plan.spp * plan.ppb <= tsweep.SWEEP_THREADS
        assert plan.blocks * plan.ppb >= parts > (plan.blocks - 1) * plan.ppb
        # the combine's shared totals fit a block without the attribute
        assert plan.spp == 1 or 8 * order * plan.ppb <= 48 * 1024
        seen = [0] * B
        threads = set()
        for block, t, p, start, length in _segments(plan, B, pmax):
            assert (block, t) not in threads
            threads.add((block, t))
            assert 0 < length <= plan.seg
            assert p * psize <= start and start + length <= (p + 1) * psize
            assert t // plan.spp == p - block * plan.ppb
            for i in range(start, start + length):
                seen[i] += 1
            # what the thread reads: its halo and its segment
            first_read = start - plan.bucket
            assert first_read <= start - order
        assert seen == [1] * B, (N, order)


@pytest.mark.parametrize("N,B", [(190, 1024), (58, 2048), (32, 3072),
                                 (18, 5120), (16, 6144), (12, 7168)])
def test_plan_fills_the_card_at_level_12(N, B):
    """The order-32 buckets of the level-12 stream: 12-190 streams, yet
    more blocks than the card's 132 SMs (the first design ran one block a
    stream)."""
    plan = tsweep.sweep_plan(N, B, 32, 8)
    assert plan.bucket == 32
    assert N * plan.blocks >= 132
    assert plan.seg <= 16


def test_plan_at_level_8():
    """The level-8 batch: 64-sample partitions shared by a few threads,
    and a launch that fills the card."""
    plan = tsweep.sweep_plan(1024, 4096, 12, 6)
    assert plan.bucket == 12 and plan.spp > 1
    assert 1024 * 64 * plan.spp >= tsweep.SWEEP_FILL
