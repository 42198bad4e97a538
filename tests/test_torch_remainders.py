"""The port's remainder functions (``homomorph_tpu_torch.gf2.poly``) against
the JAX package's: ``clmul_chunked``, ``rem_iterative``, ``reduction_rows``
and ``rem_linear``, the reference's golden vectors
(src/polynomial.rs:522-591), and the secret key's rows cache.

On the CPU the JAX functions run their XLA paths (none of them reaches a
Pallas kernel); every comparison is bit-exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homomorph_tpu.gf2 import poly as jpoly
from homomorph_tpu_torch.gf2 import kernels as tk
from homomorph_tpu_torch.gf2 import poly as tpoly
from oracle import rem_int


def T(arr):
    return tpoly.from_numpy(np.asarray(arr, dtype=np.uint32), "cpu")


def L(*words):
    return T(np.array(words, dtype=np.uint32))


def as_int(limbs) -> int:
    return int.from_bytes(tpoly.to_numpy(limbs).tobytes(), "little")


def modulus(rng, sdeg):
    s_int = (1 << sdeg) | int(rng.integers(0, 1 << min(sdeg, 30)))
    s = np.frombuffer(s_int.to_bytes(16, "little"), dtype=np.uint32)[: sdeg // 32 + 1].copy()
    return s_int, s


class TestGoldenVectors:
    # src/polynomial.rs:537-582, through the port's dispatcher and remainders
    def test_mul(self):
        assert as_int(tk.clmul(L(0b1001), L(0b11))) == 0b11011
        assert as_int(tk.clmul(L(0b111), L(0b11))) == 0b1001
        assert as_int(tk.clmul(L(0xFFFFFFFF, 0xFFFFFFFF), L(0b11))) == (1 << 64) | 1
        assert as_int(tk.clmul(L(0), L(0b11))) == 0

    @pytest.mark.parametrize("c,s,sdeg,want", [
        (0b1001, 0b11, 1, 0), (0b1, 0b10, 1, 1), (0b1010101101, 0b11011, 4, 0b1010)])
    def test_rem(self, c, s, sdeg, want):
        assert as_int(tpoly.rem_iterative(L(c), L(s), sdeg)) == want
        rows = tpoly.reduction_rows(L(s), sdeg, 32)
        assert as_int(tpoly.rem_linear(L(c), rows)) == want


class TestAgainstJax:
    def test_clmul_chunked(self, rng, monkeypatch):
        a = rng.integers(0, 2**32, size=(300, 9), dtype=np.uint32)
        b = rng.integers(0, 2**32, size=(300, 9), dtype=np.uint32)
        want = np.asarray(jpoly.clmul(jnp.asarray(a), jnp.asarray(b)))
        assert np.array_equal(tpoly.to_numpy(tpoly.clmul_chunked(T(a), T(b))), want)
        monkeypatch.setattr(tpoly, "_CLMUL_ELEM_CAP", 4096)  # force chunks
        assert np.array_equal(tpoly.to_numpy(tpoly.clmul_chunked(T(a), T(b))), want)

    @pytest.mark.parametrize("sa,sb", [((5, 1, 9), (4, 9)), ((9,), (3, 2, 5)), ((7, 3), (7, 4))])
    def test_clmul_chunked_broadcasts(self, rng, monkeypatch, sa, sb):
        a = rng.integers(0, 2**32, size=sa, dtype=np.uint32)
        b = rng.integers(0, 2**32, size=sb, dtype=np.uint32)
        monkeypatch.setattr(tpoly, "_CLMUL_ELEM_CAP", 30)
        got = tpoly.to_numpy(tpoly.clmul_chunked(T(a), T(b)))
        assert np.array_equal(got, np.asarray(jpoly.clmul_chunked(jnp.asarray(a), jnp.asarray(b))))

    def test_rem_iterative_and_linear(self, rng):
        for _ in range(15):
            Lc = int(rng.integers(1, 5))
            c = rng.integers(0, 2**32, size=(3, Lc), dtype=np.uint32)
            sdeg = int(rng.integers(1, 50))
            s_int, s = modulus(rng, sdeg)
            it = tpoly.rem_iterative(T(c), T(s), sdeg)
            assert np.array_equal(
                tpoly.to_numpy(it),
                np.asarray(jpoly.rem_iterative(jnp.asarray(c), jnp.asarray(s), sdeg)))
            rows = tpoly.reduction_rows(T(s), sdeg, Lc * 32)
            lin = tpoly.rem_linear(T(c), rows)
            assert np.array_equal(
                tpoly.to_numpy(lin),
                np.asarray(jpoly.rem_linear(
                    jnp.asarray(c), jpoly.reduction_rows(jnp.asarray(s), sdeg, Lc * 32))))
            for i in range(3):
                ci = int.from_bytes(c[i].tobytes(), "little")
                assert as_int(it[i]) == rem_int(ci, s_int) == as_int(lin[i])

    @pytest.mark.parametrize("sdeg,n_rows", [(1, 32), (31, 64), (32, 96), (64, 128), (100, 320)])
    def test_reduction_rows(self, rng, sdeg, n_rows):
        _, s = modulus(rng, sdeg)
        got = tpoly.to_numpy(tpoly.reduction_rows(T(s), sdeg, n_rows))
        assert np.array_equal(got, np.asarray(jpoly.reduction_rows(jnp.asarray(s), sdeg, n_rows)))

    def test_reduction_rows_fits_a_padded_key(self, rng):
        """A key with a trailing zero limb (the reference's 64-bit byte
        format) gives the same table."""
        _, s = modulus(rng, 64)
        padded = np.concatenate([s, np.zeros(1, np.uint32)])
        assert torch.equal(tpoly.reduction_rows(T(padded), 64, 96),
                           tpoly.reduction_rows(T(s), 64, 96))

    def test_rem_linear_batched_and_wider_table(self, rng):
        sdeg = 40
        s_int, s = modulus(rng, sdeg)
        c = rng.integers(0, 2**32, size=(2, 3, 4), dtype=np.uint32)
        rows = tpoly.reduction_rows(T(s), sdeg, 32 * 6)  # more rows than c needs
        got = tpoly.to_numpy(tpoly.rem_linear(T(c), rows))
        assert got.shape == (2, 3, 2)
        for idx in np.ndindex(2, 3):
            ci = int.from_bytes(c[idx].tobytes(), "little")
            assert int.from_bytes(got[idx].tobytes(), "little") == rem_int(ci, s_int)

    def test_rem_linear_refuses_a_short_table(self, rng):
        _, s = modulus(rng, 10)
        with pytest.raises(ValueError):
            tpoly.rem_linear(T(np.ones((1, 3), np.uint32)), tpoly.reduction_rows(T(s), 10, 64))


class TestDecryptMask:
    def test_mask_matches_the_remainders_bit0(self, rng):
        sdeg = 33
        s_int, s = modulus(rng, sdeg)
        w = tpoly.decrypt_mask(T(s), sdeg, 4)
        assert np.array_equal(tpoly.to_numpy(w), tpoly.decrypt_mask_words(s, sdeg, 4))
        c = rng.integers(0, 2**32, size=(64, 4), dtype=np.uint32)
        got = tpoly.decipher_bits(T(c), w)
        rows = tpoly.reduction_rows(T(s), sdeg, 128)
        assert torch.equal(got, tpoly.rem_linear(T(c), rows)[:, 0] & 1)
        for i in range(64):
            assert int(got[i]) == rem_int(int.from_bytes(c[i].tobytes(), "little"), s_int) & 1

    @pytest.mark.parametrize("L", [1, 9, 65])
    def test_mask_equals_jax(self, rng, L):
        _, s = modulus(rng, 100)
        got = tpoly.to_numpy(tpoly.decrypt_mask(T(s), 100, L))
        assert np.array_equal(got, np.asarray(jpoly.decrypt_mask(jnp.asarray(s), 100, L)))


class TestSecretKeyCaches:
    def make(self):
        import homomorph_tpu as hm
        import homomorph_tpu_torch as ht

        jctx = hm.Context(hm.Parameters(64, 16, 1, 16), source=hm.ThreefrySource(5))
        jctx.generate_secret_key()
        tctx = ht.Context(ht.Parameters(64, 16, 1, 16), source=ht.ThreefrySource(5), device="cpu")
        tctx.generate_secret_key()
        return jctx.get_secret_key(), tctx.get_secret_key()

    def test_rows_and_masks_equal_jax_and_are_cached(self):
        jsk, sk = self.make()
        rows = sk.reduction_rows(3)
        assert np.array_equal(tpoly.to_numpy(rows), np.asarray(jsk.reduction_rows(3)))
        assert sk.reduction_rows(3) is rows
        w = sk.decrypt_mask(9)
        assert np.array_equal(tpoly.to_numpy(w), np.asarray(jsk.decrypt_mask(9)))
        assert sk.decrypt_mask(9) is w

    def test_zeroize_scrubs_the_rows_cache(self):
        from homomorph_tpu_torch.utils.errors import SecretKeyUnsetError

        _, sk = self.make()
        rows, w = sk.reduction_rows(3), sk.decrypt_mask(9)
        assert rows.any() and w.any()
        sk.zeroize()
        assert not rows.any() and not w.any()
        with pytest.raises(SecretKeyUnsetError):
            sk.reduction_rows(3)
