"""The slot combining, ``merge_v5a`` / ``merge_v5b`` and their tool
against JAX.

``combine_level`` and ``align3`` must equal ``flake_tpu.ops.bitpack``'s
``_combine_level`` and ``_align3`` on random nodes that use all 64 payload
bits; ``v5_parts`` must equal, array by array, what ``build_v5_parts`` of
``util/prof_merge3.py`` makes of the same frames and of a made-up slot
table (handed to the JAX function through stand-ins for its analysis and
slot layout); ``merge_v5_plain`` must equal both JAX kernel bodies
(``k_v5a``, ``k_v5b``) run through ``pl.pallas_call`` in interpret mode
and the words of K5's and K3's plain versions. The encoder's 16-bit slots
flag no spill chunk and the 24-bit verbatim ones only sp2; the made-up
table, with unary runs of thousands of bits, flags both spill sets.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from flake_tpu import params as JP
from flake_tpu.ops import bitpack as jbitpack
from flake_tpu.ops import frame as jframe

from flake_tpu_torch import params as TP
from flake_tpu_torch.ops import bitmerge as tbitmerge
from flake_tpu_torch.ops import bitpack as tbitpack
from flake_tpu_torch.ops import frame as tframe
from flake_tpu_torch.util import prof_merge3 as tprof3

from test_torch_prof_merge import _frames
from test_torch_prof_merge2 import (CASES, FRAMES, case, load_jax_tool,
                                     one_torch_thread)  # noqa: F401

LANE = 128
U32 = 0xFFFFFFFF


@pytest.fixture(scope="module")
def jax_tool():
    return load_jax_tool("prof_merge3.py")


def _random_nodes(n, seed):
    """Valid nodes (ln, sw, g, pay) as int64 numpy arrays: payload widths
    0..64 with every width's top bit set on some, gaps and lengths around
    them, so that pairs fit, just fit and spill."""
    rng = np.random.default_rng(seed)
    sw = rng.choice([0, 1, 5, 20, 31, 32, 33, 40, 63, 64], n)
    g = rng.choice([0, 0, 1, 7, 30, 3000], n)
    ln = sw + g + rng.choice([0, 0, 2, 11, 40, 5000], n)
    pay = rng.integers(0, 1 << 63, n, dtype=np.uint64) * 2 \
        + rng.integers(0, 2, n, dtype=np.uint64)
    pay >>= (64 - sw).astype(np.uint64).clip(0, 63)
    pay[sw == 0] = 0
    top = (sw > 0) & (rng.random(n) < 0.5)
    pay[top] |= np.uint64(1) << (sw[top] - 1).astype(np.uint64)
    g[sw == 0] = 0
    return ln, sw, g, pay.view(np.int64)


def _halves(pay):
    """int64 bit patterns -> (ph, pl) uint32 jnp arrays."""
    u = np.asarray(pay).view(np.uint64)
    return (jnp.asarray((u >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((u & np.uint64(U32)).astype(np.uint32)))


def _joined(ph, pl):
    return ((np.asarray(ph).astype(np.uint64) << np.uint64(32))
            | np.asarray(pl).astype(np.uint64)).view(np.int64)


def test_combine_level_matches_jax():
    ln, sw, g, pay = (a.reshape(6, -1) for a in _random_nodes(6 * 4000, 1))
    ph, pl_ = _halves(pay)
    want_node, want_spill = jbitpack._combine_level(
        *(jnp.asarray(a) for a in (ln, sw, g)), ph, pl_)
    got_node, got_spill = tbitpack.combine_level(
        *(torch.from_numpy(a) for a in (ln, sw, g, pay)))
    for name, got, want in zip(
            ("ln", "sw", "g", "pay", "s_sw", "s_rel", "s_pay"),
            (*got_node, *got_spill),
            (*want_node[:3], _joined(*want_node[3:]), *want_spill[:2],
             _joined(*want_spill[2:]))):
        assert got.dtype == torch.int64, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    # the cases worth having: full 64-bit nodes, bit 63 set, spills
    assert int(got_node[1].max()) == 64 and bool((got_node[3] < 0).any())
    assert bool((got_spill[0] > 0).any())


def test_align3_matches_jax():
    _, sw, _, pay = _random_nodes(20000, 2)
    ps = np.random.default_rng(3).integers(0, 1 << 20, sw.shape)
    ph, pl_ = _halves(pay)
    want = jbitpack._align3(jnp.asarray(ps), jnp.asarray(sw), ph, pl_)
    got = tbitpack.align3(*(torch.from_numpy(a) for a in (ps, sw, pay)))
    for name, g, w in zip(("w0", "A", "B", "C"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert all(g.dtype == torch.int32 for g in got[1:])
    assert bool((got[1] < 0).any()) and bool(got[3].any())


def test_to_rows_and_to_chunks():
    x = torch.arange(2 * 300).reshape(2, 300) - (1 << 31)
    rows = tbitpack.to_rows(x + (1 << 32))          # wraps to int32
    assert rows.dtype == torch.int32 and rows.shape == (2, 3, LANE)
    np.testing.assert_array_equal(
        rows.numpy(), np.asarray(jbitpack._to_rows(
            jnp.asarray(x.numpy().astype(np.int32)))))
    chunks = tbitpack.to_chunks(x)
    assert chunks.is_contiguous() and chunks.shape == (2, LANE, 3)
    assert torch.equal(chunks, rows.permute(0, 2, 1))
    assert int(chunks[1, 43, 2]) == 300 + 2 * LANE + 43 - (1 << 31)
    assert not chunks[:, 44:, 2].any()


def _assert_parts_equal(got, want):
    names = ([f"main[{i}]" for i in range(4)] + [f"sp2[{i}]" for i in range(4)]
             + [f"sp1[{i}]" for i in range(3)] + ["cb2", "cb1"])
    flat_got = [*got[0], *got[1], *got[2], got[3], got[4]]
    flat_want = [*want[0], *want[1], *want[2], want[3], want[4]]
    assert len(flat_got) == len(flat_want) == len(names)
    for name, g, w in zip(names, flat_got, flat_want):
        assert g.dtype == torch.int32 and g.is_contiguous(), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_v5_parts_matches_jax_on_frames(jax_tool):
    """Through the JAX tool's own analysis and slot layout."""
    B = 1024
    frames = _frames(FRAMES, B, 16, 8, 8000)
    frames[1] = 0
    jcfg = jframe.FrameConfig.from_params(JP.set_defaults(8), 2, 16,
                                          block_size=B)
    hdr_bytes, hdr_nb = tbitpack.frame_header_bytes(
        np.arange(FRAMES, dtype=np.int64) * 70, bs_code=JP.blocksize_code(B),
        sr_code=JP.samplerate_code(44100), allow_vbs=0)
    hdr_bits = (hdr_nb * 8).astype(np.int32)
    jax_tool.F, jax_tool.cfg = FRAMES, jcfg
    jax_tool.hdr_bits = jnp.asarray(hdr_bits)
    jax_tool.hbj, jax_tool.hnj = jnp.asarray(hdr_bytes), jnp.asarray(hdr_nb)
    want = jax.jit(jax_tool.build_v5_parts)(jnp.asarray(frames))

    tcfg = TP.from_reference(jcfg)
    analysis = tframe.analyze_frames(torch.from_numpy(frames), tcfg,
                                     torch.from_numpy(hdr_bits))
    got = tprof3.v5_parts(*tbitpack.slot_layout(
        analysis, torch.from_numpy(hdr_bytes), torch.from_numpy(hdr_nb),
        tcfg))
    _assert_parts_equal(got, want)
    np.testing.assert_array_equal(got[3][:, -1].numpy(),
                                  analysis["frame_bytes"].numpy() * 8)


def _jax_v5_parts_of_slots(jax_tool, slots, monkeypatch):
    """``build_v5_parts`` on given slot tables: the module's analysis and
    slot layout are replaced by stand-ins that hand the slots through."""
    lengths, leading, payload = (s.numpy() for s in slots)
    monkeypatch.setattr(jax_tool, "analyze_frames", lambda x, *_: x)
    monkeypatch.setattr(jax_tool, "bitpack", types.SimpleNamespace(
        pack_frames_device=lambda out, *_, **__: out,
        _exclusive_cumsum_hier=jbitpack._exclusive_cumsum_hier))
    return jax.jit(jax_tool.build_v5_parts)(
        (jnp.asarray(lengths), jnp.asarray(leading),
         jnp.asarray(payload.view(np.uint32))))


@pytest.mark.parametrize("name", ["random", "verbatim24"])
def test_v5_parts_matches_jax_on_slots(jax_tool, monkeypatch, name):
    slots, _, _ = case(name)
    got = tprof3.v5_parts(*slots)
    _assert_parts_equal(got, _jax_v5_parts_of_slots(jax_tool, slots,
                                                    monkeypatch))
    M = slots[0].shape[1]
    nc2, nc1 = -(-(-(-M // 4)) // LANE), -(-(-(-M // 2)) // LANE)
    assert got[0][0].shape == (FRAMES, LANE, nc2)
    assert got[2][0].shape == (FRAMES, LANE, nc1)
    flagged2 = bool((got[3][:, :-1] < 0).any())
    flagged1 = bool((got[4][:, :-1] < 0).any())
    assert flagged2 and flagged1 == (name == "random")


def _pallas_v5(jax_tool, body, F, nc2, nc1, wr):
    """``util/prof_merge3.py:344 merge_v5a`` / ``:440 merge_v5b`` with
    ``interpret=True``."""
    z = jax_tool._z

    def spec(ncx):
        return pl.BlockSpec((1, LANE, ncx), lambda i, *_: (i, z(), z()))

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(F,),
        in_specs=[spec(nc2)] * 8 + [spec(nc1)] * 3,
        out_specs=pl.BlockSpec((1, wr, LANE), lambda i, *_: (i, z(), z())))
    return pl.pallas_call(
        functools.partial(body, nc2=nc2, nc1=nc1), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((F, wr, LANE), jnp.int32),
        interpret=True)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("body", ["v5a", "v5b"])
def test_v5_plain_matches_pallas_k5_and_k3(jax_tool, body, name):
    slots, aligned, wr = case(name)
    parts = tprof3.v5_parts(*slots)
    main, sp2, sp1, cb2, cb1 = parts
    F, _, nc2 = main[0].shape
    nc1 = sp1[0].shape[-1]
    jax_tool.wr = wr                    # the kernel bodies read it
    want = np.asarray(_pallas_v5(
        jax_tool, getattr(jax_tool, f"k_{body}"), F, nc2, nc1, wr)(
        *(jnp.asarray(t.numpy()) for t in (cb2, cb1, *main, *sp2, *sp1))))
    got = getattr(tprof3, f"merge_{body}")(*parts, wr)   # CPU: plain
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, tprof3.merge_v5_plain(*parts, wr))
    # the combining loses nothing
    assert torch.equal(got, tbitmerge.merge_aligned_plain(*aligned, wr))
    assert torch.equal(got, tbitmerge.merge_words_plain(*slots, wr)[0])
    assert got.any()


def test_unflagged_spill_chunks_add_nothing():
    """A spill node counts only where its chunk's flag is set, whatever it
    holds; words at or past the block's end are dropped."""
    def zeros(n):
        return tuple(torch.zeros((1, LANE, 2), dtype=torch.int32)
                     for _ in range(n))

    main, sp2, sp1 = zeros(4), zeros(4), zeros(3)
    cb2 = torch.tensor([[0, 100 | tprof3.FLAG, 200]], dtype=torch.int32)
    cb1 = torch.tensor([[tprof3.FLAG, 50, 200]], dtype=torch.int32)
    main[0][0, 0, 0], main[1][0, 0, 0], main[3][0, 0, 0] = 126, 5, 7
    sp2[0][0, 3, 0], sp2[1][0, 3, 0] = 4, 11          # chunk 0: unflagged
    sp2[0][0, 3, 1], sp2[2][0, 3, 1] = 4, 13          # chunk 1: flagged
    sp1[0][0, 9, 0], sp1[1][0, 9, 0] = 2, -(1 << 31)  # chunk 0: flagged
    sp1[0][0, 9, 1], sp1[2][0, 9, 1] = 2, 17          # chunk 1: unflagged
    got = tprof3.merge_v5a(main, sp2, sp1, cb2, cb1, 1).reshape(-1)
    want = torch.zeros(LANE, dtype=torch.int32)
    want[126], want[5], want[2] = 5, 13, -(1 << 31)   # C at word 128: dropped
    assert torch.equal(got, want)


def test_wrappers_refuse_other_devices_and_shapes():
    slots, _, wr = case("level8")
    main, sp2, sp1, cb2, cb1 = tprof3.v5_parts(*slots)
    meta = [tuple(t.to("meta") for t in g) for g in (main, sp2, sp1)]
    for fn in (tprof3.merge_v5a, tprof3.merge_v5b):
        with pytest.raises(ValueError, match="no kernel"):
            fn(*meta, cb2.to("meta"), cb1.to("meta"), wr)
    with pytest.raises(ValueError, match="expected 4 main"):
        tprof3.check_v5("merge_v5a", main[:3], sp2, sp1, cb2, cb1)
    with pytest.raises(ValueError, match="cb1"):
        tprof3.check_v5("merge_v5a", main, sp2, sp1, cb2, cb2)
    with pytest.raises(ValueError, match=r"sp2\[1\]"):
        tprof3.check_v5("merge_v5a", main, (sp2[0], sp2[1].to(torch.int64),
                                            *sp2[2:]), sp1, cb2, cb1)


def test_tool_runs_on_the_cpu(capsys):
    res = tprof3.main(device="cpu", frames=16, iters=1)
    keys = ("match", "match_b", "nc2", "sp2_active_frac", "sp1_active_frac",
            "merge_v1_ms", "merge_v5a_ms", "merge_v5b_ms", "prep_v5_ms")
    assert set(res) == {f"{kind}_{k}" for kind in ("music", "noise")
                        for k in keys}
    for kind in ("music", "noise"):
        assert res[f"{kind}_match"] is True and res[f"{kind}_match_b"] is True
        assert res[f"{kind}_nc2"] == 17
        assert res[f"{kind}_sp1_active_frac"] == 0.0
    # the warm-up samples of a frame's first chunk do not fit quads
    assert res["music_sp2_active_frac"] == round(1 / 17, 4)
    assert res["noise_sp2_active_frac"] == 1.0
    assert capsys.readouterr().out.strip().startswith('{"music_match": true')
    with pytest.raises(ValueError, match="multiple of 16"):
        tprof3.main(device="cpu", frames=24)
