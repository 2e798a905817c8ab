"""The port's pipeline against the JAX package at Flake's level 12 with
fixed 8,192-sample blocks, the configuration of ``flakebench``'s
``level12_8192.bulk``: SEARCH over LPC orders 1-32, partition orders 0-8.

``pipeline_step`` and ``flake_tpu.ops.bitpack.analyze_and_pack_jit`` take
the same two frames of each of the cell's six content classes, with the
cell's headers, and give the same ``words``, ``total_bits`` and
``frame_bytes``. JAX compiles this configuration once for the file (its
candidate sweep unrolls all 32 orders, so the trace and compile take
most of the file's time); both seeds share that shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flake_tpu import params as JP
from flake_tpu.ops import bitpack as jbitpack
from flake_tpu.ops.frame import FrameConfig as JFrameConfig
from flake_tpu_torch import params as TP
from flake_tpu_torch.graft_entry import pipeline_step
from flakebench import run

CELL = "level12_8192.bulk"
FRAMES = 2                      # a class: the pool holds 12 frames


@pytest.fixture(scope="module")
def setup():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    cell = run.load("cells", CELL)
    cfg = run.load("configs", cell["config"])
    mix = run.load("traffic", cell["traffic"])
    jcfg = JFrameConfig.from_params(JP.set_defaults(cfg["level"]),
                                    cfg["channels"], cfg["bits_per_sample"],
                                    block_size=cfg["block_size"])
    fcfg = run.program_config(cfg)
    assert TP.from_reference(jcfg) == fcfg
    yield cfg, mix, jcfg, pipeline_step(fcfg)
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 11])
def test_pipeline_equals_jax(seed, setup):
    cfg, mix, jcfg, step = setup
    batches = run.make_batches(mix, cfg, seed, torch.device("cpu"), FRAMES)
    assert len(batches) == len(mix["pool"]) == 6
    # the six classes as one batch: one JAX call, one shape for both seeds
    args = [torch.cat([b[i] for b in batches]) for i in range(4)]
    assert args[0].shape == (6 * FRAMES, cfg["block_size"], 2)
    want = jbitpack.analyze_and_pack_jit(
        jnp.asarray(args[0].numpy()), jcfg,
        *[jnp.asarray(a.numpy()) for a in args[1:]])
    jax.block_until_ready(want)
    assert not bool(want["overflow"])
    got = step(*args)
    for key in ("words", "total_bits", "frame_bytes"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
