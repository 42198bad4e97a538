"""The port's entry points (``homomorph_tpu_torch.entry``) and its
scaling harness (``homomorph_tpu_torch.bench_scaling``) against the JAX
package, on the CPU.

``entry()`` must give the JAX ``entry()``'s outputs on the same example
args, and its ciphertexts the JAX step's ``_encrypt_core`` limbs;
``dryrun_multichip(n)`` runs on grids of CPU places, where every sharded
encrypt gives the dense path's limbs; the scaling harness's grids give the
dense limbs too.  Tolerance 0: every comparison is of integer words or bits.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homomorph_tpu_torch import bench_scaling, entry
from homomorph_tpu_torch.gf2 import poly as tgf2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small shapes in long chains of tiny ops: one intra-op thread, so that
    the test runner's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_entry_module():
    spec = importlib.util.spec_from_file_location("_graft_entry", os.path.join(ROOT,
                                                                              "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def both_entries():
    jfn, jargs = jax_entry_module().entry()
    tfn, targs = entry.entry(device="cpu")
    return jfn, jargs, tfn, targs


def test_example_args_are_the_jax_args(both_entries):
    _, jargs, _, targs = both_entries
    assert len(jargs) == len(targs) == 4
    for j, t in zip(jargs, targs):
        assert np.array_equal(np.asarray(j).astype(np.int64), t.numpy().astype(np.int64))


def test_entry_gives_the_jax_outputs(both_entries):
    jfn, jargs, tfn, targs = both_entries
    want = [np.asarray(o) for o in jax.jit(jfn)(*jargs)]
    got = [o.numpy() for o in tfn(*targs)]
    assert [w.shape for w in want] == [g.shape for g in got] == [(256, 32)] * 2
    for w, g in zip(want, got):
        assert np.array_equal(w.astype(np.int64), g.astype(np.int64))
    # and on the JAX example args themselves, handed over as numpy arrays
    again = tfn(*(torch.from_numpy(np.asarray(a).astype(np.int32 if a.dtype == jnp.uint32
                                                        else np.uint8)) for a in jargs))
    for w, g in zip(want, again):
        assert np.array_equal(w.astype(np.int64), g.numpy().astype(np.int64))


def test_entry_ciphertexts_are_the_jax_limbs():
    """The step's encrypt of selections against the JAX step's
    ``_encrypt_core`` on the same key pair (``ThreefrySource(0)``)."""
    import homomorph_tpu as hm
    import homomorph_tpu_torch as ht
    from homomorph_tpu.cipher import _encrypt_core

    params = (128, 128, 16, 128)
    jctx = hm.Context(hm.Parameters(*params), source=hm.ThreefrySource(0))
    tctx = ht.Context(ht.Parameters(*params), source=ht.ThreefrySource(0), device="cpu")
    for c in (jctx, tctx):
        c.generate_secret_key()
        c.generate_public_key()
    rng = np.random.default_rng(4)
    sel = rng.integers(0, 2, size=(8, 4, 128)).astype(np.uint8)
    bits = rng.integers(0, 2, size=(8, 4)).astype(np.uint32)
    L = tgf2.limbs_for(tctx.parameters.pk_degree)
    want = np.asarray(_encrypt_core(jnp.asarray(sel), jctx.get_public_key().bit_planes(),
                                    jnp.asarray(bits), L))
    got = entry._encrypt_sel(torch.from_numpy(sel), tctx.get_public_key(),
                             torch.from_numpy(bits.astype(np.int32)), L)
    assert got.numpy().view(np.uint32).tobytes() == want.tobytes()


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu_places(n):
    out = entry.dryrun_multichip(n, device="cpu")
    assert out["places"] == n and out["device"] == "cpu"
    assert out["grid"] == {"data": n // 2, "tau": 2}
    assert out["limb_products_routed"] == 1


def test_entry_main_on_cpu(capsys):
    assert entry.main(["--device", "cpu", "--devices", "3"]) == 0
    out = capsys.readouterr().out
    assert "entry ok" in out and "'data': 3, 'tau': 1" in out


@pytest.mark.parametrize("n_data,n_tau", [(2, 1), (4, 1), (2, 2), (1, 4)])
def test_scaling_grids_give_the_dense_bytes(n_data, n_tau):
    """The harness's bulk encrypt on a grid of CPU places against the
    encrypt kernel's dense output on the same selections."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.gf2.encrypt_kernel import encrypt_bits_fused
    from homomorph_tpu_torch.parallel import bulk, make_mesh

    ctx = ht.Context(ht.Parameters(128, 128, 64, 128), source=ht.ThreefrySource(0),
                     device="cpu")
    ctx.generate_secret_key()
    ctx.generate_public_key()
    pk = ctx.get_public_key()
    L = tgf2.limbs_for(ctx.parameters.pk_degree)
    rng = np.random.default_rng(0)
    B = 256
    plain = torch.from_numpy(rng.integers(0, 2, size=(B, 1)).astype(np.int32))
    sel = torch.from_numpy(rng.integers(0, 2, size=(B, 1, 128)).astype(np.int8))
    got = bulk.sharded_encrypt_bits(make_mesh(n_data, n_tau, ["cpu"] * (n_data * n_tau)),
                                    sel, pk.limbs, plain, L)
    want = encrypt_bits_fused(tgf2.pack_bits(sel.reshape(B, 128)), pk.limbs,
                              plain.reshape(B), L)
    assert torch.equal(got.reshape(B, L), want)


def test_scaling_harness_on_cpu(capsys):
    assert bench_scaling.grids(8) == [1, 2, 4, 8] and bench_scaling.grids(5) == [1, 2, 4]
    assert bench_scaling.main(["--devices", "4", "--bits", "1024", "--steps", "1",
                               "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "scaling_efficiency_bulk_encrypt"
    assert set(out["throughput_bits_per_s"]) == {"1", "2", "4"}
    assert set(out["efficiency_vs_linear"]) == set(out["speedup_vs_single_device"]) == {"2", "4"}
    assert (out["platform"], out["devices"], out["places"], out["cards"]) == ("cpu", 1, 4, 0)
