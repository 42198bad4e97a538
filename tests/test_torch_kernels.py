"""The port's two kernel modules against the JAX package.

* ``homomorph_tpu_torch.gf2.kernels.clmul`` (K1's dispatcher and wrapper)
  against ``homomorph_tpu.gf2.kernels.clmul``;
* ``homomorph_tpu_torch.gf2.encrypt_kernel.encrypt_bits_fused`` (the
  entry to K2's wrapper) against
  ``homomorph_tpu.gf2.encrypt_kernel.encrypt_bits_fused`` on the same
  selection words, public key and plaintext bits.

On the CPU the wrappers compute their plain versions and the JAX
dispatchers fall to their XLA paths, so these are parity tests of the
plain versions and of the dispatch around the kernels; parity is bit-exact
(integer GF(2) values, tolerance 0).  ``tests/test_torch_cuda.py`` holds the
CUDA kernels against the plain versions on the card.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homomorph_tpu.gf2 import encrypt_kernel as jenc
from homomorph_tpu.gf2 import kernels as jk
from homomorph_tpu.gf2 import poly as jpoly
from homomorph_tpu_torch.gf2 import encrypt_kernel as tenc
from homomorph_tpu_torch.gf2 import kernels as tk
from homomorph_tpu_torch.gf2 import poly as tpoly


def T(arr, device="cpu"):
    return tpoly.from_numpy(arr, device)


def rand_u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


class TestClmul:
    @pytest.mark.parametrize("La,Lb", [(5, 5), (9, 9), (9, 64), (25, 40)])
    @pytest.mark.parametrize("batch", [1, 7, 130])
    def test_matches_jax(self, rng, La, Lb, batch):
        a, b = rand_u32(rng, (batch, La)), rand_u32(rng, (batch, Lb))
        got = tpoly.to_numpy(tk.clmul(T(a), T(b)))
        want = np.asarray(jk.clmul(jnp.asarray(a), jnp.asarray(b)))
        assert got.shape == (batch, La + Lb)
        assert np.array_equal(got, want)

    @pytest.mark.parametrize(
        "sa,sb", [((128, 5), (5,)), ((4, 1, 9), (3, 9)), ((9,), (2, 6, 24))]
    )
    def test_broadcast_matches_jax(self, rng, sa, sb):
        a, b = rand_u32(rng, sa), rand_u32(rng, sb)
        got = tpoly.to_numpy(tk.clmul(T(a), T(b)))
        want = np.asarray(jk.clmul(jnp.asarray(a), jnp.asarray(b)))
        assert np.array_equal(got, want)

    def test_plain_chunking_is_exact(self, rng, monkeypatch):
        a, b = rand_u32(rng, (300, 9)), rand_u32(rng, (300, 9))
        whole = tk.clmul_plain(T(a), T(b))
        monkeypatch.setattr(tk, "_PLAIN_ELEM_CAP", 4096)
        assert torch.equal(tk.clmul_plain(T(a), T(b)), whole)

    def test_wrapper_rejects_what_the_kernel_does_not_take(self, rng):
        a = T(rand_u32(rng, (4, 9)))
        with pytest.raises(TypeError):
            tk.clmul_flat(a.to(torch.int64), a)
        with pytest.raises(ValueError):
            tk.clmul_flat(a, T(rand_u32(rng, (3, 9))))
        with pytest.raises(ValueError):
            tk.clmul_flat(a.T, a.T)  # non-contiguous
        with pytest.raises(ValueError):
            tk.clmul_flat(a[:, :0], a)

    @pytest.mark.parametrize("La,Lb", [(5, 5), (9, 9), (9, 256), (256, 9), (9, 48)])
    def test_smoke_bound_counts_the_kernels_work(self, La, Lb):
        """The bit-serial count that chip_smoke.py keeps beside the comb's
        bound (``homomorph_tpu_torch.utils.profiling.clmul_ops``, which
        chip_smoke.py imports) counts the (limb, output limb) pairs that a
        bit-serial loop visits, 32 steps of 2 ops each."""
        from homomorph_tpu_torch.utils import profiling

        path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py")
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        assert smoke.clmul_ops is profiling.clmul_ops
        Ls, Lg = min(La, Lb), max(La, Lb)
        pairs = sum(
            min(Ls - 1, m) - max(0, m - Lg) + 1 for m in range(Ls + Lg)
        )  # the kernel's i0..i1 range for each output limb m
        assert profiling.clmul_ops(3, La, Lb) == 3 * pairs * 32 * 2

    def test_cpu_tensor_takes_the_plain_version(self, rng):
        before = tk.clmul_flat.launches
        a = T(rand_u32(rng, (4, 9)))
        tk.clmul_flat(a, a)
        assert tk.clmul_flat.launches == before


def make_encrypt_inputs(rng, tau, B, Lpk=9):
    W = -(-tau // 32)
    pk = rand_u32(rng, (tau, Lpk))
    selw = rand_u32(rng, (B, W))  # bits beyond tau are random, as on the device
    plain = rng.integers(0, 2, size=B).astype(np.uint32)
    return pk, selw, plain


class TestEncrypt:
    @pytest.mark.parametrize("tau", [16, 33, 128])
    @pytest.mark.parametrize("B", [128, 256])
    def test_matches_jax(self, rng, tau, B):
        pk, selw, plain = make_encrypt_inputs(rng, tau, B)
        L = 9
        pk_bits = jpoly.unpack_bits(jnp.asarray(pk), 32 * pk.shape[1]).astype(jnp.bfloat16)
        want = np.asarray(
            jenc.encrypt_bits_fused(jnp.asarray(selw), pk_bits, jnp.asarray(plain), L)
        )
        got = tenc.encrypt_bits_fused(T(selw), T(pk), T(plain), L)
        assert np.array_equal(tpoly.to_numpy(got), want)

    def test_pk_columns_layout(self, rng):
        pk = rand_u32(rng, (40, 3))
        cols = tpoly.to_numpy(tenc.pk_columns(T(pk)))
        assert cols.shape == (96, 2)
        for j in (0, 31, 32, 95):
            for i in (0, 31, 32, 39):
                want = (int(pk[i, j // 32]) >> (j % 32)) & 1
                assert (int(cols[j, i // 32]) >> (i % 32)) & 1 == want
        assert not (cols[:, 1] >> np.uint32(8)).any()  # rows beyond tau are zero

    def test_output_limbs_beyond_the_key_are_zero(self, rng):
        pk, selw, plain = make_encrypt_inputs(rng, 33, 64, Lpk=2)
        out = tenc.encrypt_bits_fused(T(selw), T(pk), T(plain), 4)
        host = tpoly.to_numpy(out)
        assert not host[:, 2:].any()
        assert np.array_equal(
            host[:, :2], tpoly.to_numpy(tenc.encrypt_plain(
                T(selw), tenc.pk_planes(tenc.pk_columns(T(pk))), T(plain), 2))
        )

    def test_wrapper_rejects_what_the_kernel_does_not_take(self, rng):
        pk, selw, plain = make_encrypt_inputs(rng, 33, 8)
        key, s, p = T(pk), T(selw), T(plain)
        with pytest.raises(TypeError):
            tenc.encrypt_bits_fused(s.to(torch.int64), key, p, 9)
        with pytest.raises(ValueError):
            tenc.encrypt_bits_fused(s, key[:, :0].contiguous(), p, 9)  # no limbs
        with pytest.raises(ValueError):
            tenc.encrypt_bits_fused(s, key[:1].contiguous(), p, 9)  # W != ceil(tau/32)
        with pytest.raises(ValueError):
            tenc.encrypt_bits_fused(s, key, p[:4], 9)
        with pytest.raises(ValueError):
            tenc.encrypt_bits_fused(s, key, p, 0)
