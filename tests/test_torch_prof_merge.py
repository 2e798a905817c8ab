"""K5, the U1 variants and the emission-profiling tool against JAX.

``aligned_parts`` must equal, array by array, what the JAX tool
``util/prof_merge.py`` computes for the same frames; K5's plain version
must equal the Pallas kernel ``pallas_bitmerge.merge_words`` in interpret
mode and the words of K3's plain version on the same slots; each U1 plain
version must equal its JAX kernel body run through ``pl.pallas_call`` in
interpret mode. Inputs are encoder slots at reduced block sizes (levels
2, 5, 8 and loud 24-bit content that falls back to verbatim) and random
slot tables with quotients of thousands of bits, whose chunks span three
word rows, so ``static2`` differs from K5 there.
"""

import functools
import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from flake_tpu import params as JP
from flake_tpu.ops import frame as jframe
from flake_tpu.ops import pallas_bitmerge

from flake_tpu_torch import params as TP
from flake_tpu_torch.ops import bitmerge as tbitmerge
from flake_tpu_torch.ops import bitpack as tbitpack
from flake_tpu_torch.ops import frame as tframe
from flake_tpu_torch.util import prof_merge as tprof

ROOT = pathlib.Path(__file__).resolve().parent.parent
LANE = 128


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX tool as a module. It builds its 512-frame batch at import
    (numpy only; nothing is analysed) and reads ``F``, ``wr``, ``cfg`` and
    the header arrays as globals, which the tests set on the module."""
    spec = importlib.util.spec_from_file_location(
        "jax_prof_merge", ROOT / "util" / "prof_merge.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frames(F, B, bps, seed, loud):
    """int32 [F, B, 2]: noise of amplitude ``loud`` and one tonal frame
    (``tests/test_pallas_bitmerge.py:14-19``)."""
    rng = np.random.default_rng(seed)
    sig = rng.integers(-loud, loud, size=(F, B, 2)).astype(np.int32)
    sig[F // 2] = (loud // 4 * np.sin(np.arange(B) * 0.01)) \
        .astype(np.int32)[:, None]
    return sig


def _encoder_slots(level, B, F, bps, seed, loud):
    """Slot tables of ``F`` analysed frames, from the port's own analysis
    on the CPU, and the frames' word rows."""
    cfg = tframe.FrameConfig.from_params(TP.set_defaults(level), 2, bps,
                                         block_size=B)
    hdr_bytes, hdr_nb = tbitpack.frame_header_bytes(
        np.arange(F, dtype=np.int64) * 70, bs_code=TP.blocksize_code(B),
        sr_code=TP.samplerate_code(44100), allow_vbs=0)
    analysis = tframe.analyze_frames(
        torch.from_numpy(_frames(F, B, bps, seed, loud)), cfg,
        torch.from_numpy(hdr_nb * 8))
    slots = tbitpack.slot_layout(analysis, torch.from_numpy(hdr_bytes),
                                 torch.from_numpy(hdr_nb), cfg)
    return slots, tbitpack.word_rows(cfg)


def _random_slots(F, M, seed):
    """Random slot tables: short fields, a few Rice quotients of up to
    9,000 zero bits (a chunk then spans three word rows), empty slots."""
    rng = np.random.default_rng(seed)
    paylen = rng.integers(0, 33, (F, M))
    leading = np.where(rng.random((F, M)) < 0.01,
                       rng.integers(1, 9000, (F, M)), 0)
    leading[paylen == 0] = 0
    payload = rng.integers(0, 1 << 32, (F, M)) & ((1 << paylen) - 1)
    lengths = paylen + leading
    wr = int(-(-lengths.sum(-1).max() // 4096)) + 1
    slots = tuple(torch.from_numpy(a.astype(np.int64)).to(torch.int32)
                  for a in (lengths, leading,
                            payload.astype(np.uint32).view(np.int32)))
    return slots, wr


CASES = {
    "level2": lambda: _encoder_slots(2, 1152, 3, 16, 2, 8000),
    "level5": lambda: _encoder_slots(5, 1024, 3, 16, 5, 8000),
    "level8": lambda: _encoder_slots(8, 1024, 3, 16, 8, 8000),
    "verbatim24": lambda: _encoder_slots(8, 1024, 3, 24, 3, 1 << 23),
    "random": lambda: _random_slots(3, 1000, 11),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    slots, wr = CASES[name]()
    return slots, tbitpack.aligned_parts(*slots), wr


def _jnp(parts):
    return tuple(jnp.asarray(p.numpy()) for p in parts)


def test_aligned_parts_matches_jax_tool(jax_tool):
    F, B = 4, 1024
    frames = _frames(F, B, 16, 8, 8000)
    frames[1] = 0
    jcfg = jframe.FrameConfig.from_params(JP.set_defaults(8), 2, 16,
                                          block_size=B)
    hdr_bytes, hdr_nb = tbitpack.frame_header_bytes(
        np.arange(F, dtype=np.int64) * 70, bs_code=JP.blocksize_code(B),
        sr_code=JP.samplerate_code(44100), allow_vbs=0)
    hdr_bits = (hdr_nb * 8).astype(np.int32)
    jax_tool.F, jax_tool.cfg = F, jcfg
    jax_tool.hdr_bits = jnp.asarray(hdr_bits)
    jax_tool.hbj, jax_tool.hnj = jnp.asarray(hdr_bytes), jnp.asarray(hdr_nb)
    want = jax.jit(jax_tool.aligned_parts)(jnp.asarray(frames))

    tcfg = TP.from_reference(jcfg)
    analysis = tframe.analyze_frames(torch.from_numpy(frames), tcfg,
                                     torch.from_numpy(hdr_bits))
    got = tbitpack.aligned_parts(*tbitpack.slot_layout(
        analysis, torch.from_numpy(hdr_bytes), torch.from_numpy(hdr_nb),
        tcfg))
    for name, g, w in zip(("w0t", "hit", "lot", "chunk_bits"), got, want):
        assert g.dtype == torch.int32 and g.is_contiguous(), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    nc = got[0].shape[-1]
    assert got[0].shape == (F, LANE, nc) and got[3].shape == (F, nc + 1)
    np.testing.assert_array_equal(got[3][:, -1].numpy(),
                                  analysis["frame_bytes"].numpy() * 8)


@pytest.mark.parametrize("name", list(CASES))
def test_merge_aligned_plain_matches_pallas_and_k3(name):
    slots, parts, wr = _case(name)
    want = np.asarray(pallas_bitmerge.merge_words(*_jnp(parts), wr=wr,
                                                  interpret=True))
    got = tbitmerge.merge_aligned(*parts, wr)       # CPU: the plain version
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    k3_words, k3_bits = tbitmerge.merge_words_plain(*slots, wr)
    assert torch.equal(got, k3_words)
    assert torch.equal(parts[3][:, -1], k3_bits)
    assert got.any()


def _pallas_variant(jax_tool, kernel_fn, F, nc, wr):
    """``util/prof_merge.py:141 _mk`` with ``interpret=True``."""
    z = jax_tool._z
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(F,),
        in_specs=[pl.BlockSpec((1, LANE, nc), lambda i, cb: (i, z(), z()))
                  for _ in range(3)],
        out_specs=pl.BlockSpec((1, wr, LANE), lambda i, cb: (i, z(), z())))
    return pl.pallas_call(
        functools.partial(kernel_fn, nc=nc), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((F, wr, LANE), jnp.int32),
        interpret=True)


@pytest.mark.parametrize("name", ["level8", "verbatim24", "random"])
@pytest.mark.parametrize("variant", list(tprof.VARIANTS))
def test_variant_plain_matches_pallas(jax_tool, variant, name):
    _, parts, wr = _case(name)
    F, _, nc = parts[0].shape
    jax_tool.wr = wr                    # the kernel bodies read it
    w0t, hit, lot, cb = _jnp(parts)
    want = np.asarray(_pallas_variant(
        jax_tool, getattr(jax_tool, f"k_{variant}"), F, nc, wr)(
        cb, w0t, hit, lot))
    wrapper, plain = tprof.VARIANTS[variant]
    got = wrapper(*parts, wr)           # CPU: the plain version
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, plain(*parts, wr))
    k5 = tbitmerge.merge_aligned_plain(*parts, wr)
    if variant == "static2":
        # equal to K5 unless a chunk spans three word rows
        row0, last_row = tprof.chunk_rows(parts[3])
        assert torch.equal(got, k5) == bool((last_row - row0 <= 1).all())
        assert torch.equal(got, k5) == (name != "random")
    elif variant == "zero":
        assert not got.any()
    else:
        assert got.any() and not torch.equal(got, k5)


def test_sum_at_against_numpy():
    rng = np.random.default_rng(4)
    idx = rng.integers(-5, 40, (6, 300))
    val = rng.integers(-(1 << 31), 1 << 31, (6, 300))
    want = np.zeros((6, 32), np.int64)
    for f in range(6):
        for i, v in zip(idx[f], val[f]):
            if 0 <= i < 32:
                want[f, i] += v
    got = tbitmerge.sum_at(torch.from_numpy(idx), torch.from_numpy(val), 32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_out_of_block_words_add_nothing():
    """A word index outside the block is dropped; lo lands when only
    w0 + 1 is inside."""
    w0t = torch.zeros((1, LANE, 1), dtype=torch.int32)
    hit = torch.zeros_like(w0t)
    lot = torch.zeros_like(w0t)
    w0t[0, :4, 0] = torch.tensor([-1, 127, 128, 5])
    hit[0, :4, 0] = torch.tensor([7, 1 << 30, 9, -(1 << 31)])
    lot[0, :4, 0] = torch.tensor([3, 11, 13, 0])
    cb = torch.tensor([[0, 4096]], dtype=torch.int32)
    got = tbitmerge.merge_aligned(w0t, hit, lot, cb, 1).reshape(-1)
    want = torch.zeros(LANE, dtype=torch.int32)
    want[0], want[127], want[5] = 3, 1 << 30, -(1 << 31)
    assert torch.equal(got, want)


def test_wrappers_refuse_other_devices():
    w = torch.zeros((2, LANE, 3), dtype=torch.int32, device="meta")
    cb = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    for fn in (tbitmerge.merge_aligned,
               *(k for k, _ in tprof.VARIANTS.values())):
        with pytest.raises(ValueError):
            fn(w, w, w, cb, 4)


def test_tool_runs_on_the_cpu(capsys):
    res = tprof.main(device="cpu", frames=2, iters=1)
    assert set(res) == {
        "F", "nc", "wr", "analysis_ms", "emit_full_ms", "prep_ms",
        "merge_now_ms", "merge_static2_ms", "merge_fixedrow_ms",
        "merge_nowin_ms", "merge_zero_ms", "merge_k3_ms", "static2_matches",
        "pipeline_xrt_now"}
    assert (res["F"], res["nc"], res["wr"]) == (2, 67, 34)
    assert res["static2_matches"] is True
    assert capsys.readouterr().out.strip().startswith('{"F": 2')


def test_tool_imports_no_jax():
    code = ("import sys, flake_tpu_torch.util.prof_merge, "
            "flake_tpu_torch.decoder; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'flake_tpu.')) or m == 'flake_tpu']; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
