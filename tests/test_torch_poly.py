"""Limb engine of the PyTorch port (``homomorph_tpu_torch.gf2.poly``).

The golden vectors of ``tests/test_poly_golden.py`` (the reference's
hand-computed vectors, src/polynomial.rs:428-613), then random inputs made
with numpy fed to both ``homomorph_tpu.gf2.poly`` and the port.  Every
value is an integer GF(2) quantity, so parity is bit-exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homomorph_tpu.gf2 import poly as jpoly
from homomorph_tpu_torch.gf2 import poly as tpoly
from oracle import clmul_int, rem_int


def L(*words):
    return tpoly.from_numpy(np.array(words, dtype=np.uint32), "cpu")


def T(arr):
    return tpoly.from_numpy(arr, "cpu")


def as_int(limbs) -> int:
    return int.from_bytes(tpoly.to_numpy(limbs).tobytes(), "little")


def same(torch_out, jax_out):
    t = torch_out.numpy()
    j = np.asarray(jax_out)
    if j.dtype == np.uint32:
        t = tpoly.to_numpy(torch_out)
    assert t.shape == j.shape
    assert np.array_equal(t.astype(np.int64), j.astype(np.int64))


def rand_limbs(rng, shape, top_bit=True):
    x = rng.integers(0, 2**32, size=shape, dtype=np.uint32)
    if top_bit:
        x.reshape(-1)[::3] |= np.uint32(1 << 31)  # limbs negative as int32
    return x


class TestGolden:
    def test_compute_degree(self):
        assert int(tpoly.compute_degree(L(0b10010))) == 4
        assert int(tpoly.compute_degree(L(0b10010, 0b1))) == 32
        assert int(tpoly.compute_degree(L(0b10010, 0b0))) == 4
        assert int(tpoly.compute_degree(L(0, 0, 0))) == 0
        assert int(tpoly.compute_degree(L(0, 1 << 31))) == 63
        m = torch.stack([L(0b10010, 0), L(0, 0b1), L(0, 0)])
        assert tpoly.compute_degree(m).tolist() == [4, 32, 0]

    def test_monomial(self):
        for d in (5, 31, 32):
            assert int(tpoly.compute_degree(tpoly.monomial(d, device="cpu"))) == d

    def test_evaluate(self):
        p = L(0b1001)
        assert int(tpoly.evaluate(p, True)) == 0
        assert int(tpoly.evaluate(p, False)) == 1
        p = L(0b111100010, 0b1001)
        assert int(tpoly.evaluate(p, True)) == 1
        assert int(tpoly.evaluate(p, False)) == 0

    def test_add(self):
        assert as_int(tpoly.xor(L(0b1001), L(0b0011))) == 0b1010
        assert tpoly.to_numpy(tpoly.xor(L(0b1001, 0b1), L(0b0101, 0b1))).tolist() == [0b1100, 0]
        assert as_int(tpoly.xor_const_bit(L(0b1000), 1)) == 0b1001
        assert as_int(tpoly.xor_const_bit(L(0b1001), 1)) == 0b1000
        assert as_int(tpoly.xor_const_bit(L(0b1001), 0)) == 0b1001

    def test_mul(self):
        assert as_int(tpoly.clmul(L(0b1001), L(0b11))) == 0b11011
        assert as_int(tpoly.clmul(L(0b111), L(0b11))) == 0b1001
        assert as_int(tpoly.clmul(L(0xFFFFFFFF, 0xFFFFFFFF), L(0b11))) == (1 << 64) | 1
        assert as_int(tpoly.clmul(L(0), L(0b11))) == 0

    def test_mul_fuzz_vs_oracle(self, rng):
        for _ in range(40):
            La, Lb = int(rng.integers(1, 6)), int(rng.integers(1, 6))
            a, b = rand_limbs(rng, La), rand_limbs(rng, Lb)
            ai = int.from_bytes(a.tobytes(), "little")
            bi = int.from_bytes(b.tobytes(), "little")
            assert as_int(tpoly.clmul(T(a), T(b))) == clmul_int(ai, bi)

    def test_bytes(self):
        limbs = np.array([0b1001, 0b1000001101011010, 0, 1, 0], dtype=np.uint32)
        assert (tpoly.limbs_from_bytes(tpoly.limbs_to_bytes(T(limbs))) == limbs).all()
        with pytest.raises(ValueError):
            tpoly.limbs_from_bytes(b"")
        back = tpoly.limbs_from_bytes(bytes([5, 14, 8]))
        assert back.size == 1 and int(back[0]) == 5 | (14 << 8) | (8 << 16)

    def test_decrypt_mask_matches_rem_bit0(self, rng):
        sdeg = 33
        s_int = (1 << sdeg) | int(rng.integers(0, 1 << 30))
        s = np.frombuffer(s_int.to_bytes(8, "little"), dtype=np.uint32).copy()
        w = tpoly.decrypt_mask(T(s), sdeg, 4)
        c = rand_limbs(rng, (64, 4))
        got = tpoly.decipher_bits(T(c), w).tolist()
        for i in range(64):
            ci = int.from_bytes(c[i].tobytes(), "little")
            assert got[i] == (rem_int(ci, s_int) & 1)


class TestAgainstJax:
    @pytest.mark.parametrize("k", [0, 1, 31, 32, 33, 64, 100])
    def test_shifts(self, rng, k):
        x = rand_limbs(rng, (3, 4))
        same(tpoly.shift_left_static(T(x), k, 8), jpoly.shift_left_static(jnp.asarray(x), k, 8))
        same(
            tpoly.shift_left_dynamic(T(x), torch.tensor(k), 8),
            jpoly.shift_left_dynamic(jnp.asarray(x), jnp.int32(k), 8),
        )

    def test_compute_degree_with_bit31(self, rng):
        x = rand_limbs(rng, (50, 3))
        x[::4] = 0
        x[1::4, 1:] = 0
        x[2::4, 2] = np.uint32(1 << 31)
        same(tpoly.compute_degree(T(x)), jpoly.compute_degree(jnp.asarray(x)))

    def test_evaluate_and_null(self, rng):
        x = rand_limbs(rng, (20, 5))
        x[3] = 0
        same(tpoly.evaluate_at_one(T(x)), jpoly.evaluate_at_one(jnp.asarray(x)))
        same(tpoly.evaluate_at_zero(T(x)), jpoly.evaluate_at_zero(jnp.asarray(x)))
        assert tpoly.is_null(T(x)).tolist() == np.asarray(jpoly.is_null(jnp.asarray(x))).tolist()

    @pytest.mark.parametrize("n_bits", [5, 32, 70, 7 * 32])
    def test_unpack_pack(self, rng, n_bits):
        x = rand_limbs(rng, (3, 7))
        bits = tpoly.unpack_bits(T(x), n_bits)
        same(bits, jpoly.unpack_bits(jnp.asarray(x), n_bits))
        same(tpoly.pack_bits(bits), jpoly.pack_bits(jpoly.unpack_bits(jnp.asarray(x), n_bits)))

    def test_parity_pack(self, rng):
        counts = rng.integers(0, 300, size=(6, 100)).astype(np.float32)
        got = tpoly.parity_pack(torch.from_numpy(counts), 5)
        same(got, jpoly.parity_pack(jnp.asarray(counts), 5))

    @pytest.mark.parametrize("sdeg,n_limbs", [(33, 4), (64, 9), (128, 9), (127, 20)])
    def test_decrypt_mask_and_decipher(self, rng, sdeg, n_limbs):
        s_int = (1 << sdeg) | int(rng.integers(0, 2**62))
        Ls = tpoly.limbs_for(sdeg)
        s = np.frombuffer(s_int.to_bytes(4 * Ls, "little"), dtype=np.uint32).copy()
        w_t = tpoly.decrypt_mask(T(s), sdeg, n_limbs)
        w_j = jpoly.decrypt_mask(jnp.asarray(s), sdeg, n_limbs)
        same(w_t, w_j)
        c = rand_limbs(rng, (2, 40, n_limbs))
        same(tpoly.decipher_bits(T(c), w_t), jpoly.decipher_bits(jnp.asarray(c), w_j))

    @pytest.mark.parametrize("La,Lb", [(1, 1), (3, 5), (9, 9), (9, 24)])
    def test_clmul_plain_sweep(self, rng, La, Lb):
        a, b = rand_limbs(rng, (7, La)), rand_limbs(rng, (7, Lb))
        same(tpoly.clmul(T(a), T(b)), jpoly.clmul(jnp.asarray(a), jnp.asarray(b)))

    def test_shape_helpers(self, rng):
        for n in (1, 8, 9, 17, 65, 249, 1000):
            assert tpoly.bucket(n) == jpoly.bucket(n)
        for b in (0, 31, 32, 256, 2048):
            assert tpoly.limbs_for(b) == jpoly.limbs_for(b)
        x = rand_limbs(rng, (2, 3))
        same(tpoly.fit_limbs(T(x), 5), jpoly.fit_limbs(jnp.asarray(x), 5))
        same(tpoly.fit_limbs(T(x), 2), jpoly.fit_limbs(jnp.asarray(x), 2))
        with pytest.raises(ValueError):
            tpoly.pad_limbs(T(x), 2)
