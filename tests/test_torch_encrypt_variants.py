"""The tensor-core encrypt kernels' wrappers (K3, X1) and the kernel
selector, against the JAX package on the CPU.

On a CPU tensor ``encrypt_words_mma`` (K3) and ``encrypt_sel_mma`` (X1)
compute their plain versions; these are held against
``homomorph_tpu.cipher._encrypt_core`` on the same selection words, public
key and plaintext bits.  ``tests/test_torch_cuda.py`` holds the CUDA
kernels against the plain versions on the card.  Tolerance 0 (integer
GF(2) values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import homomorph_tpu as hm
import homomorph_tpu_torch as ht
from homomorph_tpu.cipher import _encrypt_core
from homomorph_tpu.gf2 import poly as jpoly
from homomorph_tpu_torch.experiments import exp_enc
from homomorph_tpu_torch.gf2 import encrypt_kernel as tenc
from homomorph_tpu_torch.gf2 import poly as tpoly


def T(arr):
    return tpoly.from_numpy(arr, "cpu")


def inputs(rng, tau, B, Lpk):
    W = -(-tau // 32)
    pk = rng.integers(0, 2**32, size=(tau, Lpk), dtype=np.uint32)
    selw = rng.integers(0, 2**32, size=(B, W), dtype=np.uint32)  # random beyond tau
    plain = rng.integers(0, 2, size=B).astype(np.uint32)
    return pk, selw, plain


def jax_reference(pk, selw, plain, tau, L):
    pk_bits = jpoly.unpack_bits(jnp.asarray(pk), 32 * pk.shape[1]).astype(jnp.bfloat16)
    sel = jpoly.unpack_bits(jnp.asarray(selw), tau)
    return np.asarray(_encrypt_core(sel, pk_bits, jnp.asarray(plain), L)), np.asarray(sel)


class TestPlainVersionsMatchJax:
    @pytest.mark.parametrize("tau,Lpk,L", [(32, 3, 3), (33, 9, 9), (128, 9, 9), (128, 5, 7)])
    @pytest.mark.parametrize("B", [64, 130])
    def test_k3_and_x1(self, rng, tau, Lpk, L, B):
        pk, selw, plain = inputs(rng, tau, B, Lpk)
        want, jsel = jax_reference(pk, selw, plain, tau, L)
        planes = tenc.pk_planes(tenc.pk_columns(T(pk)))
        k3 = tenc.encrypt_words_mma(T(selw), planes, T(plain), L)
        assert np.array_equal(tpoly.to_numpy(k3), want)
        sel = torch.from_numpy(jsel.astype(np.int8))
        x1 = tenc.encrypt_sel_mma(sel, planes, T(plain), L)
        assert np.array_equal(tpoly.to_numpy(x1), want)
        # the selection unpacked by torch ops, as the experiment does
        sel_t = tpoly.unpack_bits(T(selw), tau, dtype=torch.int8)
        assert torch.equal(tenc.encrypt_sel_mma(sel_t, planes, T(plain), L), x1)

    def test_planes_are_the_jax_bit_planes_transposed(self):
        ctx = hm.Context(hm.Parameters(40, 30, 3, 40), source=hm.ThreefrySource(4))
        ctx.generate_secret_key()
        ctx.generate_public_key()
        jpk = ctx.get_public_key()
        _, pk = ht.keys.keys_from_numpy(
            np.asarray(ctx.get_secret_key()._host), np.asarray(jpk._host), device="cpu")
        planes = pk.planes().numpy()
        bit_planes = np.asarray(jpk.bit_planes().astype(jnp.int8))
        assert planes.dtype == np.int8 and planes.shape == (bit_planes.shape[1], 64)
        assert np.array_equal(planes[:, :40].T, bit_planes)
        assert not planes[:, 40:].any()
        assert pk.planes() is pk.planes()  # built once per key


class TestSelector:
    def test_default_and_values(self, monkeypatch):
        monkeypatch.delenv(tenc.ENC_IMPL_ENV, raising=False)
        assert tenc.encrypt_impl() == "pallas"
        for impl in ("pallas", "pallas_v1"):
            monkeypatch.setenv(tenc.ENC_IMPL_ENV, impl)
            assert tenc.encrypt_impl() == impl

    @pytest.mark.parametrize("bad", ["xla", "pallas_v3", "", "PALLAS"])
    def test_unknown_value_raises(self, monkeypatch, rng, bad):
        monkeypatch.setenv(tenc.ENC_IMPL_ENV, bad)
        with pytest.raises(ValueError, match=tenc.ENC_IMPL_ENV):
            tenc.encrypt_impl()
        pk, selw, plain = inputs(rng, 33, 8, 2)
        with pytest.raises(ValueError, match=tenc.ENC_IMPL_ENV):
            tenc.encrypt_bits_fused(T(selw), T(pk), T(plain), 2)

    def test_both_kernels_give_the_same_bits(self, monkeypatch, rng):
        pk, selw, plain = inputs(rng, 100, 96, 4)
        key = T(pk)
        outs = []
        for impl in tenc.ENC_IMPLS:
            monkeypatch.setenv(tenc.ENC_IMPL_ENV, impl)
            outs.append(tenc.encrypt_bits_fused(T(selw), key, T(plain), 4))
            outs.append(tenc.encrypt_bits_fused(
                T(selw), key, T(plain), 4, planes=lambda: tenc.pk_planes(tenc.pk_columns(key))))
        assert all(torch.equal(o, outs[0]) for o in outs)


class TestWrappers:
    def test_reject_what_the_kernels_do_not_take(self, rng):
        pk, selw, plain = inputs(rng, 33, 8, 2)
        planes = tenc.pk_planes(tenc.pk_columns(T(pk)))
        s, p = T(selw), T(plain)
        sel = tpoly.unpack_bits(s, 33, dtype=torch.int8)
        with pytest.raises(TypeError):
            tenc.encrypt_words_mma(s, planes.to(torch.int32), p, 2)
        with pytest.raises(TypeError):
            tenc.encrypt_sel_mma(sel.to(torch.uint8), planes, p, 2)
        with pytest.raises(ValueError):  # planes width is 32*W, not tau
            tenc.encrypt_words_mma(s, planes[:, :33].contiguous(), p, 2)
        with pytest.raises(ValueError):
            tenc.encrypt_sel_mma(sel, planes[:, :32].contiguous(), p, 2)
        with pytest.raises(ValueError):  # D % 32
            tenc.encrypt_words_mma(s, planes[:40].contiguous(), p, 2)
        with pytest.raises(ValueError):
            tenc.encrypt_sel_mma(sel.T, planes, p, 2)  # non-contiguous
        with pytest.raises(ValueError):
            tenc.encrypt_words_mma(s, planes, p[:4], 2)
        with pytest.raises(ValueError):
            tenc.encrypt_sel_mma(sel, planes, p, 0)

    def test_cpu_tensors_take_the_plain_versions(self, rng):
        pk, selw, plain = inputs(rng, 33, 8, 2)
        planes = tenc.pk_planes(tenc.pk_columns(T(pk)))
        before = (tenc.encrypt_words_mma.launches, tenc.encrypt_sel_mma.launches,
                  tenc.encrypt_words_table.launches)
        tenc.encrypt_words_mma(T(selw), planes, T(plain), 2)
        tenc.encrypt_sel_mma(tpoly.unpack_bits(T(selw), 33, dtype=torch.int8), planes, T(plain), 2)
        tenc.encrypt_words_table(T(selw), T(pk), T(plain), 2)
        assert before == (tenc.encrypt_words_mma.launches, tenc.encrypt_sel_mma.launches,
                          tenc.encrypt_words_table.launches)

    def test_empty_batch(self, rng):
        pk, _, _ = inputs(rng, 33, 1, 2)
        planes = tenc.pk_planes(tenc.pk_columns(T(pk)))
        empty = torch.zeros((0, 2), dtype=torch.int32)
        out = tenc.encrypt_words_mma(empty, planes, torch.zeros(0, dtype=torch.int32), 3)
        assert out.shape == (0, 3)


def test_experiment_rows_agree_on_the_cpu():
    out = exp_enc.run(bits=512, device="cpu")
    assert set(out["rows"]) == {"pallas_v2", "pallas_v1", "pallas_v3"}
    assert all(r["mismatches"] == 0 and r["ms"] is None for r in out["rows"].values())
    assert (out["tau"], out["D"], out["L"]) == (128, 288, 9)
