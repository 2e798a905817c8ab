"""The row-layout combined-node merges ``merge_v5d`` / ``merge_v5c``, their
parts, their zero floors and the tool's ``--v5d`` / ``--v5c`` paths against
JAX.

``kmax_for`` and ``combined_parts`` must equal ``flake_tpu.ops.bitpack``'s
``kmax_for`` and ``build_combined_parts``, overflow flag and row needs
included; ``v5d_parts`` / ``v5c_parts`` must equal, array by array, what
``build_v5d_parts`` / ``build_v5c_parts`` of ``util/prof_merge3.py`` make of
the same slot tables (handed to the JAX functions through stand-ins for
their analysis and slot layout); ``merge_v5_rows_plain`` must equal both
JAX kernel bodies (``k_v5d``, ``k_v5c``) run through ``pl.pallas_call`` in
interpret mode and the JAX encoder's own ``merge_combined`` at the same
static row counts, bit for bit, also where frames overflow them: the random
table's chunks span up to nine word rows, and at two rows the encoder's
slots overflow too. Where no frame overflows the words are K5's and K3's.
"""

import functools
import json
import os
import subprocess
import sys
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
from flake_tpu.ops import pallas_bitmerge

from flake_tpu_torch import params as TP
from flake_tpu_torch.ops import bitmerge as tbitmerge
from flake_tpu_torch.ops import bitpack as tbitpack
from flake_tpu_torch.ops import frame as tframe
from flake_tpu_torch.util import prof_merge3 as tprof3

from test_torch_prof_merge2 import (CASES, FRAMES, ROOT, case, load_jax_tool,
                                     one_torch_thread)  # noqa: F401

LANE = 128
FLAG = tprof3.FLAG
ROW_NAMES = (["mainw"] + [f"mainr[{i}]" for i in range(3)] + ["sp2w"]
             + [f"sp2r[{i}]" for i in range(3)] + ["sp1w"]
             + [f"sp1r[{i}]" for i in range(2)] + ["cb2", "cb1"])
# the static rows the encoder would give each case's slots (``kmax_for`` of
# 16-bit stereo, and of 24-bit stereo for the verbatim case), and two rows,
# which the encoder's slots overflow too
ENCODER_KMAX = {name: (5, 3) if name == "verbatim24" else (4, 3)
                for name in CASES}


@pytest.fixture(scope="module")
def jax_tool():
    return load_jax_tool("prof_merge3.py")


def _flat(parts):
    """(mainw, mainr, sp2w, sp2r, sp1w, sp1r, cb2, cb1) -> thirteen arrays."""
    mainw, mainr, sp2w, sp2r, sp1w, sp1r, cb2, cb1 = parts
    return [mainw, *mainr, sp2w, *sp2r, sp1w, *sp1r, cb2, cb1]


def _assert_rows_equal(got, want):
    flat_got, flat_want = _flat(got), _flat(want)
    assert len(flat_got) == len(flat_want) == len(ROW_NAMES)
    for name, g, w in zip(ROW_NAMES, flat_got, flat_want):
        assert g.dtype == torch.int32 and g.is_contiguous(), name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("channels", [1, 2, 6])
@pytest.mark.parametrize("bps", [16, 24])
def test_kmax_for_matches_jax(bps, channels):
    jcfg = jframe.FrameConfig.from_params(JP.set_defaults(8), channels, bps)
    tcfg = tframe.FrameConfig.from_params(TP.set_defaults(8), channels, bps)
    assert tbitpack.kmax_for(tcfg) == jbitpack.kmax_for(jcfg)
    if (bps, channels) == (16, 2):
        assert tbitpack.kmax_for(tcfg) == (tprof3.KMAX, tprof3.KMAX1)
    if (bps, channels) == (24, 2):
        assert tbitpack.kmax_for(tcfg) == ENCODER_KMAX["verbatim24"]


def test_chunk_row_span_reads_31_bits():
    """An entry's bit 31 is a flag; the span runs to the third word of a
    node that ends at the chunk's last bit."""
    cb = torch.tensor([[0, 4096 * 3 - 64, (4096 * 3 + 1) | FLAG, 4096 * 7,
                        4096 * 7]], dtype=torch.int32)
    # chunk 0 ends in word 381: + 2 = row 2; chunk 1 is one bit wide and
    # chunk 2 flagged; chunk 3 is empty
    assert tbitpack.chunk_row_span(cb).tolist() == [[3, 2, 5, 1]]
    flagged = cb.clone()
    flagged[:, :-1] |= FLAG
    assert torch.equal(tbitpack.chunk_row_span(flagged),
                       tbitpack.chunk_row_span(cb))


@pytest.mark.parametrize("kmax", ["encoder", (2, 2)])
@pytest.mark.parametrize("name", list(CASES))
def test_combined_parts_matches_jax(name, kmax):
    slots, _, _ = case(name)
    kmax, kmax1 = ENCODER_KMAX[name] if kmax == "encoder" else kmax
    lengths, leading, payload = (s.numpy() for s in slots)
    want, want_ov, want_n2, want_n1 = jbitpack.build_combined_parts(
        jnp.asarray(lengths), jnp.asarray(leading),
        jnp.asarray(payload.view(np.uint32)),
        jnp.asarray(lengths.sum(-1, dtype=np.int32)), kmax, kmax1)
    got, overflow, need2, need1 = tbitpack.combined_parts(*slots, kmax, kmax1)
    _assert_rows_equal(got, want)
    assert overflow.dtype == torch.bool
    np.testing.assert_array_equal(overflow.numpy(), np.asarray(want_ov))
    assert need2.dtype == need1.dtype == torch.int32
    assert (int(need2), int(need1)) == (int(want_n2), int(want_n1))
    # the random table overflows any static span; the encoder's slots only
    # two rows
    assert bool(overflow.any()) == (name == "random" or kmax == 2)
    assert bool(overflow.all()) == (name == "random")


def _jax_parts_of_slots(jax_tool, function, slots, monkeypatch, kmax):
    """``build_v5d_parts`` / ``build_v5c_parts`` on given slot tables: the
    module's analysis and slot layout are replaced by stand-ins that hand
    the slots through."""
    lengths, leading, payload = (s.numpy() for s in slots)
    monkeypatch.setattr(jax_tool, "analyze_frames", lambda x, *_: x)
    monkeypatch.setattr(jax_tool, "bitpack", types.SimpleNamespace(
        pack_frames_device=lambda out, *_, **__: out,
        _exclusive_cumsum_hier=jbitpack._exclusive_cumsum_hier))
    monkeypatch.setattr(jax_tool, "KMAX", kmax)
    build = getattr(jax_tool, function)
    # a jit of its own: the function reads KMAX while it is traced
    return jax.jit(lambda x: build(x))(
        (jnp.asarray(lengths), jnp.asarray(leading),
         jnp.asarray(payload.view(np.uint32))))


@pytest.mark.parametrize("name,kmax", [("random", 4), ("verbatim24", 4),
                                       ("level8", 2)])
@pytest.mark.parametrize("layout", ["v5d", "v5c"])
def test_row_parts_match_jax_on_slots(jax_tool, monkeypatch, layout, name,
                                      kmax):
    slots, _, _ = case(name)
    *want, want_ov = _jax_parts_of_slots(
        jax_tool, f"build_{layout}_parts", slots, monkeypatch, kmax)
    *got, overflow = getattr(tprof3, f"{layout}_parts")(*slots, kmax)
    _assert_rows_equal(got, want)
    np.testing.assert_array_equal(overflow.numpy(), np.asarray(want_ov))
    M = slots[0].shape[1]
    nc2, nc1 = -(-(-(-M // 4)) // LANE), -(-(-(-M // 2)) // LANE)
    w2, w1 = ((FRAMES, LANE, nc2), (FRAMES, LANE, nc1)) if layout == "v5c" \
        else ((FRAMES, nc2, LANE), (FRAMES, nc1, LANE))
    assert got[0].shape == got[2].shape == w2 and got[4].shape == w1
    assert got[1][0].shape == (FRAMES, nc2, LANE)
    assert got[5][0].shape == (FRAMES, nc1, LANE)
    assert bool(overflow.any()) == (name != "verbatim24")
    # the two layouts hold the same nodes, and v5_parts' too
    rows = tprof3.v5d_parts(*slots, kmax)
    chunks = tprof3.v5_parts(*slots)
    for r, c in zip(_flat(rows[:-1])[:11], [*chunks[0], *chunks[1],
                                            *chunks[2]]):
        assert torch.equal(r, c.permute(0, 2, 1))
    assert torch.equal(rows[6], chunks[3]) and torch.equal(rows[7], chunks[4])


def _pallas_rows(jax_tool, body, F, nc2, nc1, wr, fb):
    """``util/prof_merge3.py:653 merge_v5d`` / ``:714 merge_v5c`` with
    ``interpret=True``."""
    z = jax_tool._z

    def rspec(ncx):
        return pl.BlockSpec((fb, ncx, LANE), lambda i, *_: (i, z(), z()))

    def wspec(ncx):
        if body == "v5d":
            return rspec(ncx)
        return pl.BlockSpec((fb, LANE, ncx), lambda i, *_: (i, z(), z()))

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(F // fb,),
        in_specs=[wspec(nc2)] + [rspec(nc2)] * 3 + [wspec(nc2)]
        + [rspec(nc2)] * 3 + [wspec(nc1)] + [rspec(nc1)] * 2,
        out_specs=pl.BlockSpec((fb, wr, LANE), lambda i, *_: (i, z(), z())))
    return pl.pallas_call(
        functools.partial(getattr(jax_tool, f"k_{body}"), nc2=nc2, nc1=nc1,
                          fb=fb),
        grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((F, wr, LANE), jnp.int32),
        interpret=True)


def _pallas_words(jax_tool, monkeypatch, body, kin, wr, fb, kmax, kmax1):
    """The JAX body's words of the port's operands ``kin``."""
    mainw, mainr, sp2w, sp2r, sp1w, sp1r, cb2, cb1 = kin
    F, nc2, _ = mainr[0].shape
    nc1 = sp1r[0].shape[1]
    for name, value in (("wr", wr), ("KMAX", kmax), ("KMAX1", kmax1)):
        monkeypatch.setattr(jax_tool, name, value, raising=False)
    return np.asarray(_pallas_rows(jax_tool, body, F, nc2, nc1, wr, fb)(
        *(jnp.asarray(t.numpy()) for t in (cb2, cb1, *_flat(kin)[:11]))))


# a Pallas call in interpret mode takes seconds, nearly all of them to
# compile fb * (nc2 + nc1) * kmax matrix products: every case at four rows
# through one body, the two that flag spills through the other, and the
# overflowing ones at two rows through both
PALLAS_CASES = [("v5d", name, 2 if name in ("random", "level8") else 1, 4, 3)
                for name in CASES] \
    + [("v5c", "random", 2, 4, 3), ("v5c", "verbatim24", 1, 4, 3)] \
    + [(body, name, 1, 2, 2) for body in ("v5d", "v5c")
       for name in ("random", "level8")]


@pytest.mark.parametrize("body,name,fb,kmax,kmax1", PALLAS_CASES)
def test_rows_plain_matches_pallas(jax_tool, monkeypatch, body, name, fb,
                                   kmax, kmax1):
    slots, _, wr = case(name)
    *kin, overflow = getattr(tprof3, f"{body}_parts")(*slots, kmax, kmax1)
    want = _pallas_words(jax_tool, monkeypatch, body, kin, wr, fb, kmax, kmax1)
    got = getattr(tprof3, f"merge_{body}")(*kin, wr, fb, kmax, kmax1)
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.any()
    # inside the static rows the words are K3's; the frames that overflow
    # them lose words
    k3 = tbitmerge.merge_words_plain(*slots, wr)[0]
    assert torch.equal(got[~overflow], k3[~overflow])
    assert bool(overflow.any()) == (name == "random" or kmax == 2)
    assert all(not torch.equal(got[f], k3[f])
               for f in overflow.nonzero().flatten().tolist())


@pytest.mark.parametrize("name,kmax,kmax1", [("random", 4, 3),
                                             ("level8", 2, 2)])
def test_rows_plain_matches_the_encoders_merge_combined(name, kmax, kmax1):
    """The JAX encoder's K3 at static ``kmax`` is the same function."""
    slots, _, wr = case(name)
    kin, overflow, _, _ = tbitpack.combined_parts(*slots, kmax, kmax1)
    mainw, mainr, sp2w, sp2r, sp1w, sp1r, cb2, cb1 = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), kin)
    want = np.asarray(pallas_bitmerge.merge_combined(
        mainw, mainr, sp2w, sp2r, sp1w, sp1r, cb2, cb1, wr=wr, kmax=kmax,
        kmax1=kmax1, interpret=True))
    got = tprof3.merge_v5_rows_plain(*kin, wr, kmax, kmax1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(overflow.any())


@pytest.mark.parametrize("name,kmax", [(name, 4) for name in CASES]
                         + [("random", 2), ("level8", 2), ("level5", 9)])
def test_rows_words_against_v5a_k5_and_k3(name, kmax):
    """Where no chunk overflows the static rows, the row-layout merges give
    the words of ``merge_v5a``, K5 and K3; where one does, they differ in
    those frames only. ``merge_v5c`` and ``merge_v5d`` agree everywhere and
    ``fb`` changes nothing."""
    slots, aligned, wr = case(name)
    *kin, overflow = tprof3.v5d_parts(*slots, kmax, kmax)
    *kin_c, overflow_c = tprof3.v5c_parts(*slots, kmax, kmax)
    got = tprof3.merge_v5d(*kin, wr, 1, kmax, kmax)
    assert torch.equal(got, tprof3.merge_v5d(*kin, wr, 4, kmax, kmax))
    assert torch.equal(got, tprof3.merge_v5c(*kin_c, wr, 2, kmax, kmax))
    assert torch.equal(overflow, overflow_c)
    refs = (tprof3.merge_v5_plain(*tprof3.v5_parts(*slots), wr),
            tbitmerge.merge_aligned_plain(*aligned, wr),
            tbitmerge.merge_words_plain(*slots, wr)[0])
    for ref in refs:
        assert torch.equal(got[~overflow], ref[~overflow])
    differs = (got != refs[0]).flatten(1).any(-1)
    assert torch.equal(differs, overflow)
    assert bool(overflow.any()) == ((name == "random" and kmax < 9)
                                    or kmax == 2)


def _hand_made(wr):
    """One frame, two chunks a set, ``kmax = 2`` and ``kmax1 = 3``: the
    operands of ``merge_v5d`` and the words the rule gives, as {word:
    value}."""
    def zeros(n):
        return [torch.zeros((1, 2, LANE), dtype=torch.int32)
                for _ in range(n)]

    (mw, ma, mb, mc), (s2w, s2a, s2b, s2c), (s1w, s1a, s1b) = \
        zeros(4), zeros(4), zeros(3)
    # main and sp2: chunk 0 from row 0, chunk 1 from row 3 (sp2 flagged);
    # sp1: chunk 0 from row 1 (flagged), chunk 1 from row 2 (not flagged)
    cb2 = torch.tensor([[0, (3 * 4096) | FLAG, 4 * 4096]], dtype=torch.int32)
    cb1 = torch.tensor([[4096 | FLAG, 2 * 4096, 4 * 4096]],
                       dtype=torch.int32)

    def node(arrays, chunk, lane, w0, *vals):
        arrays[0][0, chunk, lane] = w0
        for arr, v in zip(arrays[1:], vals):
            arr[0, chunk, lane] = v

    main, sp2, sp1 = (mw, ma, mb, mc), (s2w, s2a, s2b, s2c), (s1w, s1a, s1b)
    want = {}
    node(main, 0, 0, 126, 5, 6, 7)        # C crosses into row 1: kept
    want.update({126: 5, 127: 6, 128: 7})
    node(main, 0, 1, 255, 1, 2, 3)        # B, C cross into row 2: dropped
    want[255] = 1
    node(main, 0, 2, 254, 0, 0, 9)        # C alone at word 256: dropped
    node(main, 0, 3, 256, 11, 12, 13)     # starts past the window: dropped
    node(main, 1, 0, 300, 13, 14, 15)     # starts before row0: dropped
    node(main, 1, 1, 400, 21, 0, -22)
    want.update({400: 21, 402: -22})
    node(main, 1, 2, 511, 23, 24, 25)     # crosses a row edge in the window
    want.update({511: 23, 512: 24, 513: 25})
    node(sp2, 0, 5, 10, 99, 98, 97)       # chunk not flagged: nothing
    node(sp2, 1, 5, 100, 77, 76, 75)      # before cb2's row0: dropped
    node(sp2, 1, 6, 638, 31, 32, 33)      # C at word 640 = (3 + 2) * 128
    want.update({638: 31, 639: 32})
    node(sp1, 0, 7, 383, 41, 42)          # kmax1 = 3: B at word 384 kept
    want.update({383: 41, 384: 42})
    node(sp1, 0, 8, 130, 43, -(1 << 31))
    want.update({130: 43, 131: -(1 << 31)})
    node(sp1, 0, 9, 127, 45, 46)          # before cb1's row0: dropped
    node(sp1, 0, 10, 511, 47, 48)         # B at word 512 = (1 + 3) * 128
    want[511] += 47
    node(sp1, 1, 0, 300, 55, 56)          # chunk not flagged: nothing
    words = torch.zeros(wr * LANE, dtype=torch.int32)
    for w, v in want.items():
        if w < wr * LANE:
            words[w] = v
    return (mw, (ma, mb, mc), s2w, (s2a, s2b, s2c), s1w, (s1a, s1b), cb2,
            cb1), words.reshape(1, wr, LANE)


def _dual(kin):
    """v5d's operands with each ``w0`` in chunk layout, as v5c takes it."""
    return tuple(t.permute(0, 2, 1).contiguous() if i in (0, 2, 4) else t
                 for i, t in enumerate(kin))


@pytest.mark.parametrize("body", ["v5d", "v5c"])
def test_hand_made_nodes_pin_the_window_rule(jax_tool, monkeypatch, body):
    """Each clause of the rule on a table of a few nodes, against the words
    written out by hand and against the JAX body; then with the block one
    row shorter, where the words at and past its end are dropped."""
    kin, want = _hand_made(6)
    if body == "v5c":
        kin = _dual(kin)
    merge = getattr(tprof3, f"merge_{body}")
    got = merge(*kin, 6, 1, 2, 3)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        got.numpy(), _pallas_words(jax_tool, monkeypatch, body, kin, 6, 1, 2,
                                   3))
    # the port never writes a word at or past the block's end; the JAX
    # bodies index row0 + dr without a bound, so they are not asked here
    assert torch.equal(merge(*kin, 4, 1, 2, 3), want[:, :4])
    assert bool(want[0, 4, :2].all()) and not want[0, 5].any()


def test_zero_floors_and_refusals():
    slots, _, wr = case("level8")
    *rows, _ = tprof3.v5d_parts(*slots)
    *dual, _ = tprof3.v5c_parts(*slots)
    for floor, kin in ((tprof3.merge_zero_rows, rows),
                       (tprof3.merge_zero_fb, dual)):
        got = floor(*kin, wr, 2)
        assert got.dtype == torch.int32 and got.shape == (FRAMES, wr, LANE)
        assert not got.any()
    pairs = ((tprof3.merge_v5d, rows), (tprof3.merge_zero_rows, rows),
             (tprof3.merge_v5c, dual), (tprof3.merge_zero_fb, dual))
    for fn, kin in pairs:
        with pytest.raises(ValueError, match="multiple"):
            fn(*kin, wr, 3)
        with pytest.raises(ValueError, match="multiple"):
            fn(*kin, wr, 0)
        meta = jax.tree_util.tree_map(lambda t: t.to("meta"), tuple(kin))
        with pytest.raises(ValueError, match="no kernel"):
            fn(*meta, wr, 2)
        # the other layout's w0
        other = dual if kin is rows else rows
        with pytest.raises(ValueError, match="main w0"):
            fn(other[0], *kin[1:], wr, 2)
        with pytest.raises(ValueError, match="sp1 w0"):
            fn(*kin[:4], other[4], *kin[5:], wr, 2)
        with pytest.raises(ValueError, match=r"sp2\[1\]"):
            fn(*kin[:3], (kin[3][0], kin[3][1].to(torch.int64), kin[3][2]),
               *kin[4:], wr, 2)
        with pytest.raises(ValueError, match="expected 3 main"):
            fn(kin[0], kin[1][:2], *kin[2:], wr, 2)
        with pytest.raises(ValueError, match="cb1"):
            fn(*kin[:7], kin[6], wr, 2)
    for fn, kin in pairs[::2]:
        with pytest.raises(ValueError, match="at least 1"):
            fn(*kin, wr, 2, 0)
        assert fn.launches == 0            # the CPU takes the plain version


def test_tool_v5d_runs_on_the_cpu(capsys):
    res = tprof3.main_v5d(device="cpu", frames=32, iters=1)
    keys = ("overflow_frames", "match", "v5d_fb16_slope_ms",
            "v5d_fb32_slope_ms")
    assert set(res) == {f"{kind}_{k}" for kind in ("music", "noise")
                        for k in keys} \
        | {"prep_slope_ms", "analysis_slope_ms", "zero_rows_fb16_ms",
           "zero_rows_fb32_ms"}
    for kind in ("music", "noise"):
        assert res[f"{kind}_match"] is True
        assert res[f"{kind}_overflow_frames"] == 0
    assert json.loads(capsys.readouterr().out.strip()) == res
    with pytest.raises(ValueError, match="multiple of 32"):
        tprof3.main_v5d(device="cpu", frames=16)
    # at two rows every frame overflows and is left out of the match
    res = tprof3.main_v5d(device="cpu", frames=32, iters=1, kmax=2)
    assert res["music_overflow_frames"] == res["noise_overflow_frames"] == 32
    assert res["music_match"] is True and res["noise_match"] is True


def test_tool_v5c_runs_on_the_cpu(capsys):
    res = tprof3.main_v5c(device="cpu", frames=16, iters=1)
    keys = ("overflow_frames", "match", "v5c_fb4_ms", "v5c_fb8_ms",
            "v5c_fb16_ms", "prep_ms")
    assert set(res) == {f"{kind}_{k}" for kind in ("music", "noise")
                        for k in keys} | {"zero_fb1_ms", "zero_fb8_ms"}
    for kind in ("music", "noise"):
        assert res[f"{kind}_match"] is True
        assert res[f"{kind}_overflow_frames"] == 0
    assert json.loads(capsys.readouterr().out.strip()) == res
    with pytest.raises(ValueError, match="multiple of 16"):
        tprof3.main_v5c(device="cpu", frames=24)


def _run_tool(*flags):
    """The tool as a command on the CPU, with one thread for the reason
    :func:`one_torch_thread` gives."""
    return subprocess.run(
        [sys.executable, "-m", "flake_tpu_torch.util.prof_merge3",
         "--device", "cpu", *flags],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1"})


def test_tool_takes_the_flags_on_the_command_line():
    """At two static rows every frame of both batches overflows, and
    ``--v5c`` says where the words differ; ``--v5d`` reaches its own main,
    which wants frames in multiples of 32."""
    proc = _run_tool("--v5c", "--frames", "16", "--kmax", "2")
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    for kind in ("music", "noise"):
        assert res[f"{kind}_overflow_frames"] == 16
        assert res[f"{kind}_match"] is False and res[f"{kind}_nbad"] > 0
        assert len(res[f"{kind}_first_bad"]) == 3
        assert f"{kind}_v5c_fb16_ms" in res
    proc = _run_tool("--v5d", "--frames", "16")
    assert proc.returncode != 0 and "multiple of 32" in proc.stderr


def test_tool_refuses_both_flags_at_once():
    proc = _run_tool("--v5c", "--v5d")
    assert proc.returncode != 0 and "not allowed with" in proc.stderr
