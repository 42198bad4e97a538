"""The port's device randomness against ``jax.random`` (threefry), on the CPU.

``homomorph_tpu_torch.rng.threefry_key`` / ``threefry_split`` and
``homomorph_tpu_torch.prng.random_bits_plain`` (T1's plain version) against
``jax.random.key`` / ``split`` / ``bits``; then ``Context(encrypt_seed=s)``
in both packages, whose ciphertext bytes must be identical for the same
keys, on both branches of ``homomorph_tpu/cipher.py:355-377`` and with
either encrypt kernel selected.  Tolerance 0: every comparison is of
integer words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import homomorph_tpu as hm
import homomorph_tpu_torch as ht
from homomorph_tpu_torch import prng
from homomorph_tpu_torch import rng as trng
from homomorph_tpu_torch.gf2 import encrypt_kernel as tenc
from homomorph_tpu_torch.utils.profiling import counters

#: jax.random.bits(jax.random.key(seed), (8,), uint32), computed by the JAX
#: package on the CPU (JAX 0.9.0); chip_smoke.py holds T1 to the same words
JAX_BITS = {
    0: [4070199207, 4202968722, 1427181096, 2012915765,
        2447653815, 710830403, 1332275837, 2961296638],
    17: [1083326455, 3794755506, 3288344309, 1599061380,
         3175417854, 1130779688, 1775367574, 3399734426],
    1234: [3715183467, 3461522409, 1578076316, 3641478021,
           607760917, 2701805931, 3332195204, 1640115702],
}


def key_data(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def u32(t):
    return t.numpy().view(np.uint32)


class TestKeys:
    @pytest.mark.parametrize("seed", [0, 1, 17, 1234, 2**31, -1, 2**32 + 5])
    def test_key_matches_jax(self, seed):
        assert trng.threefry_key(seed) == key_data(jax.random.key(seed))

    def test_key_pins_jax_without_x64(self):
        assert trng.threefry_key(2**31) == (0, 2147483648)
        assert trng.threefry_key(-1) == (0, 4294967295)
        assert trng.threefry_key(2**32 + 5) == (0, 5)

    def test_known_answer(self):
        # Random123's threefry2x32_20 known answer: key 0, counter 0
        assert trng.threefry2x32((0, 0), 0, 0) == (0x6B200159, 0x99BA4EFE)

    @pytest.mark.parametrize("seed", [0, 9, 1234])
    def test_split_chain_matches_jax(self, seed):
        jk, tk = jax.random.key(seed), trng.threefry_key(seed)
        for _ in range(3):
            jk, jsub = jax.random.split(jk)
            tk, tsub = trng.threefry_split(tk)
            assert (tk, tsub) == (key_data(jk), key_data(jsub))

    def test_os_entropy_key_is_two_fresh_words(self):
        a, b = trng.os_entropy_key(), trng.os_entropy_key()
        assert len(a) == 2 and all(0 <= w < 2**32 for w in a)
        assert a != b


class TestRandomBits:
    @pytest.mark.parametrize("seed", [0, 17, 2**31 + 3])
    @pytest.mark.parametrize("shape", [(5, 1), (130, 2), (77, 4), (3, 8), (257, 8), (2, 3, 4)])
    def test_plain_matches_jax_bits(self, seed, shape):
        want = np.asarray(jax.random.bits(jax.random.key(seed), shape, jnp.uint32))
        got = prng.random_bits_plain(trng.threefry_key(seed), shape)
        assert tuple(got.shape) == shape
        assert np.array_equal(u32(got), want)

    def test_split_subkey_stream_matches_jax(self):
        _, jsub = jax.random.split(jax.random.key(5))
        want = np.asarray(jax.random.bits(jsub, (33, 4), jnp.uint32))
        _, tsub = trng.threefry_split(trng.threefry_key(5))
        assert np.array_equal(u32(prng.random_bits(tsub, (33, 4), "cpu")), want)

    @pytest.mark.parametrize("seed", sorted(JAX_BITS))
    def test_committed_constants(self, seed):
        want = np.asarray(jax.random.bits(jax.random.key(seed), (8,), jnp.uint32))
        assert want.tolist() == JAX_BITS[seed]
        assert u32(prng.random_bits(trng.threefry_key(seed), (8,), "cpu")).tolist() == JAX_BITS[seed]

    def test_card_script_holds_the_same_constants(self):
        import importlib.util
        import os

        path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py")
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        assert smoke.JAX_BITS == JAX_BITS

    def test_plain_chunking_is_exact(self, monkeypatch):
        whole = prng.random_bits_plain((3, 4), (100, 3))
        monkeypatch.setattr(prng, "_PLAIN_CHUNK", 64)
        assert np.array_equal(u32(prng.random_bits_plain((3, 4), (100, 3))), u32(whole))

    def test_cpu_does_not_count_and_bad_keys_raise(self):
        before = counters["T1"]
        assert prng.random_bits((0, 1), (0, 4), "cpu").shape == (0, 4)
        prng.random_bits((0, 1), (4,), "cpu")
        assert counters["T1"] == before
        with pytest.raises(ValueError):
            prng.random_bits((0, 2**32), (4,), "cpu")
        with pytest.raises(ValueError):
            prng.random_bits((-1, 0), (4,), "cpu")


def seeded_pair(params, seed):
    """Contexts of both packages with the same keys and encrypt seed."""
    p = hm.Parameters(*params)
    sk = hm.keys.generate_secret_key(p, hm.ThreefrySource(seed))
    pk = hm.keys.generate_public_key(p, sk, hm.ThreefrySource(seed + 1))
    jctx = hm.Context(p, encrypt_seed=seed)
    jctx.set_secret_key(sk)
    jctx.set_public_key(pk)
    tsk, tpk = ht.keys.keys_from_numpy(np.asarray(sk._host), np.asarray(pk._host), device="cpu")
    tctx = ht.Context(ht.Parameters(*params), encrypt_seed=seed, device="cpu")
    tctx.set_secret_key(tsk)
    tctx.set_public_key(tpk)
    return jctx, tctx


class TestSeededContexts:
    # (values, type, batch): 16 U8 values and one U128 are 128 bits (the
    # fused branch, total % 128 == 0); the others take the other branch
    CALLS = [
        (list(range(3, 19)), "U8", True),
        ([1, 2, 3], "U8", True),
        (2**127 + 11, "U128", False),
        (200, "U16", False),
        ([7, 2**32 - 1], "U32", True),
    ]

    @pytest.mark.parametrize("impl", tenc.ENC_IMPLS)
    @pytest.mark.parametrize("params", [(64, 16, 1, 16), (63, 65, 7, 33)])
    def test_ciphertext_bytes_match_jax(self, monkeypatch, impl, params):
        monkeypatch.setenv(tenc.ENC_IMPL_ENV, impl)
        jctx, tctx = seeded_pair(params, 21)
        for vals, name, batch in self.CALLS:  # one key chain across the calls
            jc = jctx.encrypt(vals, getattr(hm, name), batch=batch)
            tc = tctx.encrypt(vals, getattr(ht, name), batch=batch)
            assert tc.to_bytes() == jc.to_bytes(), (vals, name)
            got = tctx.decrypt(tc)
            assert (list(got) if batch else got) == vals

    def test_cipher_takes_exactly_one_randomness_mode(self):
        _, tctx = seeded_pair((64, 16, 1, 16), 3)
        pk = tctx.get_public_key()
        with pytest.raises(ValueError, match="key= or source="):
            ht.Ciphered.cipher(5, pk, ht.U8)
        with pytest.raises(ValueError, match="key= or source="):
            ht.Ciphered.cipher(5, pk, ht.U8, key=(0, 1), source=ht.ThreefrySource(1))
