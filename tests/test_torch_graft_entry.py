"""The port's entry points (``flake_tpu_torch.graft_entry``) against
``__graft_entry__.py`` on the CPU.

``entry(device="cpu")`` builds the JAX entry's seed-0 batch, and its
function gives the JAX function's words, bit counts and frame bytes on the
same arguments; ``dryrun_multichip`` passes on meshes of 4 (dp 2 x sp 2)
and 8 (dp 4 x sp 2) CPU devices and of 3 (dp only), and a failed check
raises.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax

from flake_tpu_torch import graft_entry
from flake_tpu_torch.parallel import mesh as tmesh

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_entry():
    spec = importlib.util.spec_from_file_location(
        "graft_entry_jax", ROOT / "__graft_entry__.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    fn, args = module.entry()
    # jitted, as the entry is meant to be: about six times faster on the
    # CPU than running its ops one by one
    return [np.asarray(a) for a in args], \
        {k: np.asarray(v) for k, v in jax.jit(fn)(*args).items()}


def test_entry_matches_jax(jax_entry):
    jargs, want = jax_entry
    fn, args = graft_entry.entry(device="cpu")
    assert len(args) == len(jargs)
    for a, j in zip(args, jargs):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), j)
    got = fn(*args)
    assert set(got) == set(want) == {"words", "total_bits", "frame_bytes"}
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    assert torch.equal(got["total_bits"].to(torch.int64),
                       8 * got["frame_bytes"])


def test_entry_refuses_cuda_without_it():
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    with pytest.raises(RuntimeError):
        graft_entry.entry()


@pytest.mark.parametrize("n_devices,sp", [(4, 2), (8, 2), (3, 1)])
def test_dryrun_multichip_on_the_cpu(n_devices, sp, capsys):
    graft_entry.dryrun_multichip(n_devices, device="cpu")
    line = capsys.readouterr().out.strip()
    assert line.startswith(
        f"dryrun_multichip ok: mesh dp={n_devices // sp} sp={sp}")
    assert f"sp_shards_samples={sp > 1}" in line


def test_dryrun_multichip_raises_on_a_miss(monkeypatch):
    """A sharded packer that drops a frame's words must fail the dry run."""
    real = tmesh.make_sharded_packer

    def broken(cfg, mesh):
        run, gather, shards = real(cfg, mesh)

        def run_broken(*args):
            out = run(*args)
            out["words"][0] = torch.zeros_like(out["words"][0])
            return out

        return run_broken, gather, shards

    monkeypatch.setattr(tmesh, "make_sharded_packer", broken)
    with pytest.raises(AssertionError, match="words"):
        graft_entry.dryrun_multichip(4, device="cpu")
