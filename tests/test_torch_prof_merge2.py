"""The merge prototypes ``merge_v2`` and ``merge_v3`` and their tool
against JAX.

Each plain version must equal its JAX kernel body (``k_v2``, ``k_v3`` of
``util/prof_merge2.py``) run through ``pl.pallas_call`` in interpret mode
with the tool's grid specs, bit for bit and at every ``fb``: on encoder
slots at reduced block sizes (levels 2, 5, 8 and loud 24-bit content that
falls back to verbatim), where both give K5's words, and on a random slot
table with unary runs of thousands of bits, whose chunks pass 256 words
and start three rows past the one before, so that ``merge_v2`` drops and
misplaces parts and ``merge_v3`` drops rows; ``merge_v3``'s also on random
chunk bounds in no order, where its kernel's table must keep what the body
keeps.
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

from flake_tpu_torch.ops import bitmerge as tbitmerge
from flake_tpu_torch.ops import bitpack as tbitpack
from flake_tpu_torch.ops.common import wrap_int32
from flake_tpu_torch.util import prof_merge as tprof
from flake_tpu_torch.util import prof_merge2 as tprof2

from test_torch_prof_merge import _encoder_slots, _random_slots

ROOT = pathlib.Path(__file__).resolve().parent.parent
LANE = 128
FRAMES = 4

CASES = {
    "level2": lambda: _encoder_slots(2, 1152, FRAMES, 16, 2, 8000),
    "level5": lambda: _encoder_slots(5, 1024, FRAMES, 16, 5, 8000),
    "level8": lambda: _encoder_slots(8, 1024, FRAMES, 16, 8, 8000),
    "verbatim24": lambda: _encoder_slots(8, 1024, FRAMES, 24, 3, 1 << 23),
    "random": lambda: _random_slots(FRAMES, 1000, 11),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tools' stages are thousands of small torch calls. With a thread
    pool as wide as the machine in every test worker, the pools' spinning
    waits take the cores from each other, and a tool run that takes two
    seconds alone takes minutes; the shapes here gain nothing from
    threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def case(name):
    """(slots, aligned parts, word rows) of one case."""
    slots, wr = CASES[name]()
    return slots, tbitpack.aligned_parts(*slots), wr


def load_jax_tool(filename):
    """A JAX tool of ``util/`` as a module. It builds its header arrays at
    import (numpy only; nothing is analysed) and reads ``F``, ``wr``,
    ``cfg`` and the header arrays as globals, which the tests set."""
    spec = importlib.util.spec_from_file_location(
        "jax_" + filename.removesuffix(".py"), ROOT / "util" / filename)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tool():
    return load_jax_tool("prof_merge2.py")


def _pallas_prototype(jax_tool, body, F, nc, wr, fb):
    """``util/prof_merge2.py:224 merge_v2`` / ``:353 merge_v3`` with
    ``interpret=True``."""
    z = jax_tool._z
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(F // fb,),
        in_specs=[pl.BlockSpec((fb, LANE, nc), lambda i, cb: (i, z(), z()))
                  for _ in range(3)],
        out_specs=pl.BlockSpec((fb, wr, LANE), lambda i, cb: (i, z(), z())))
    return pl.pallas_call(
        functools.partial(body, nc=nc, fb=fb), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((F, wr, LANE), jnp.int32),
        interpret=True)


PROTOTYPES = {"v2": (tprof2.merge_v2, tprof2.merge_v2_plain),
              "v3": (tprof2.merge_v3, tprof2.merge_v3_plain)}


# a Pallas call in interpret mode takes seconds: fb = 2 on three cases
CASES_FB = [(name, fb) for name in CASES for fb in (1, 2)
            if fb == 1 or name in ("level8", "verbatim24", "random")]


@pytest.mark.parametrize("name,fb", CASES_FB)
@pytest.mark.parametrize("proto", list(PROTOTYPES))
def test_prototype_plain_matches_pallas(jax_tool, proto, name, fb):
    _, parts, wr = case(name)
    F, _, nc = parts[0].shape
    jax_tool.wr = wr                    # the kernel bodies read it
    w0t, hit, lot, cb = (jnp.asarray(p.numpy()) for p in parts)
    want = np.asarray(_pallas_prototype(
        jax_tool, getattr(jax_tool, f"k_{proto}"), F, nc, wr, fb)(
        cb, w0t, hit, lot))
    wrapper, plain = PROTOTYPES[proto]
    got = wrapper(*parts, wr, fb)       # CPU: the plain version
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, plain(*parts, wr))
    # K5's words inside the prototype's domain, other words outside it
    k5 = tbitmerge.merge_aligned_plain(*parts, wr)
    assert got.any() and torch.equal(got, k5) == (name != "random")


@pytest.mark.parametrize("seed", [0, 1])
def test_v3_plain_matches_pallas_on_unordered_bounds(jax_tool, seed):
    """``merge_v3``'s function needs no order of the chunk bounds: on random
    bounds, decreasing and negative ones among them, and a chunk that ends
    at INT32_MIN (``cb[c + 1] - 1`` wraps to the largest row, so ``k_v3``
    keeps its rows row0 to row0 + 3), the plain version and the kernel's
    table (:func:`v3_chunk_rows`) keep what ``k_v3`` keeps. Words stay
    below the block's last so that interpret mode, which clamps a row past
    the block to its last, adds nothing there."""
    rng = np.random.default_rng(seed)
    F, nc, wr = 2, 12, 10
    W = wr * LANE
    cb = rng.integers(-6 * 4096, (wr + 6) * 4096, (F, nc + 1))
    cb[0] = np.sort(cb[0])[::-1]
    cb[1, 5:7] = [2 * 4096 + 7, -1 << 31]
    w0t = rng.integers(0, W - 1, (F, LANE, nc))
    hit, lot = (rng.integers(-1 << 31, 1 << 31, (F, LANE, nc))
                for _ in range(2))
    arrays = [a.astype(np.int32) for a in (w0t, hit, lot, cb)]
    jax_tool.wr = wr
    want = np.asarray(_pallas_prototype(jax_tool, jax_tool.k_v3, F, nc, wr,
                                        1)(*(jnp.asarray(a) for a in
                                             (arrays[3], *arrays[:3]))))
    parts = [torch.from_numpy(a) for a in arrays]
    np.testing.assert_array_equal(tprof2.merge_v3_plain(*parts, wr).numpy(),
                                  want)
    row0, span = (t[:, None, None, :]
                  for t in tprof2.v3_chunk_rows(parts[3]))
    word = torch.stack([parts[0].long(), parts[0].long() + 1], 1)
    rel = (word >> 7) - row0
    keep = (rel >= 0) & (rel <= span)
    val = torch.stack([parts[1], parts[2]], 1).long()
    table = tbitmerge.sum_at(word.reshape(F, -1),
                             torch.where(keep, val, 0).reshape(F, -1), W)
    np.testing.assert_array_equal(
        wrap_int32(table).reshape(F, wr, LANE).numpy(), want)
    assert want.any()


def test_random_case_leaves_both_domains():
    """The random table has what the prototypes treat differently from
    K5: chunks wider than v2's 256 words, chunks that start three or more
    rows past v2's carry, chunks that reach past v3's four rows."""
    _, parts, wr = case("random")
    assert int(tprof2.chunk_ext_words(parts[3]).max()) >= 256
    row0, last_row = tprof.chunk_rows(parts[3])
    assert bool((tprof2.v2_carry_rows(parts[3]) < row0).any())
    assert bool((last_row - row0 >= 4).any())
    # and the encoder's slots have none of it
    _, parts, _ = case("verbatim24")
    assert torch.equal(tprof2.v2_carry_rows(parts[3]),
                       parts[3][:, :-1].to(torch.int64) >> 12)


def test_v2_carry_rows_against_a_loop():
    cb = torch.tensor([[0, 100, 5 * 4096 + 7, 6 * 4096, 6 * 4096 + 1,
                        30 * 4096, 30 * 4096 + 5, 31 * 4096]],
                      dtype=torch.int32)
    want, ra = [], 0
    for c in range(7):
        r = int(cb[0, c]) >> 12
        for _ in range(2):
            if ra < r:
                ra += 1
        want.append(ra)
    assert tprof2.v2_carry_rows(cb).tolist() == [want]
    assert want == [0, 0, 2, 4, 6, 8, 10]


def test_wrappers_refuse_bad_fb_and_other_devices():
    _, parts, wr = case("level8")
    meta = tuple(p.to("meta") for p in parts)
    for fn in (tprof2.merge_v2, tprof2.merge_v3):
        with pytest.raises(ValueError, match="multiple"):
            fn(*parts, wr, 3)
        with pytest.raises(ValueError, match="multiple"):
            fn(*parts, wr, 0)
        with pytest.raises(ValueError, match="no kernel"):
            fn(*meta, wr, 2)


def test_noise_batch_is_the_jax_tools(jax_tool):
    """``make_batch`` gives the samples of both JAX tools' ``noise`` and
    ``music`` batches."""
    tool3 = load_jax_tool("prof_merge3.py")
    for kind in tprof2.KINDS:
        got = tprof.make_batch(16, kind)[0]
        for tool in (jax_tool, tool3):
            tool.F = 16
            np.testing.assert_array_equal(
                got, np.asarray(tool.make_batch(kind)), err_msg=kind)


def test_tools_run_on_the_cpu(capsys):
    res = tprof2.main(device="cpu", frames=16, iters=1)
    assert set(res) == {
        "music_max_chunk_ext_words", "music_v2_fb1_match",
        "music_v2_fb8_match", "merge_v1_ms", "merge_v2_fb1_ms",
        "merge_v2_fb4_ms", "merge_v2_fb8_ms", "merge_v2_fb16_ms",
        "noise_max_chunk_ext_words", "noise_v2_fb1_match",
        "noise_v2_fb8_match"}
    assert res["music_v2_fb1_match"] is True
    assert res["music_v2_fb8_match"] is True
    assert res["music_max_chunk_ext_words"] < 64 \
        < res["noise_max_chunk_ext_words"] < 256
    assert res["noise_v2_fb8_match"] is True
    res3 = tprof2.main_v3(device="cpu", frames=16, iters=1)
    assert set(res3) == {
        "music_v3_fb1_match", "music_v3_fb8_match", "noise_v3_fb1_match",
        "noise_v3_fb8_match", "merge_v3_fb1_ms", "merge_v3_fb8_ms",
        "merge_v3_fb16_ms"}
    assert all(res3[k] is True for k in res3 if k.endswith("_match"))
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith('{"music_max_chunk')
    with pytest.raises(ValueError, match="multiple of 16"):
        tprof2.main(device="cpu", frames=8)


def test_tools_import_no_jax():
    code = ("import sys, flake_tpu_torch.util.prof_merge2, "
            "flake_tpu_torch.util.prof_merge3; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'flake_tpu.')) or m == 'flake_tpu']; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
