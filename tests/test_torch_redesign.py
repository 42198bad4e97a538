"""The torch mirrors of the two redesigned kernels against the JAX package.

* ``encrypt_tables_plain`` follows K2's table decomposition (chunk tables
  built from the key's limbs, one lookup per chunk and limb, tiles of key
  limbs, passes of selection words); it is held against
  ``homomorph_tpu.cipher._encrypt_core`` on the same selection words, key
  and plaintext bits, at tau that are and are not multiples of the chunk,
  with L above the key's limbs and words with bit 31 set.
* ``clmul_comb_plain`` follows K1's 4-bit comb (the 16 multiples of the
  wider operand, the nibble walk with funnel shifts); it is held against
  ``homomorph_tpu.gf2.kernels.clmul``.

Inputs come from numpy with a seed; parity is bit-exact (integer GF(2)
values, tolerance 0).  ``tests/test_torch_cuda.py`` holds the kernels
against these mirrors on the card.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest

from homomorph_tpu.cipher import _encrypt_core
from homomorph_tpu.gf2 import kernels as jk
from homomorph_tpu.gf2 import poly as jpoly
from homomorph_tpu_torch.gf2 import encrypt_kernel as tenc
from homomorph_tpu_torch.gf2 import kernels as tk
from homomorph_tpu_torch.gf2 import poly as tpoly


def T(arr):
    return tpoly.from_numpy(arr, "cpu")


def encrypt_inputs(seed, tau, B, Lpk):
    rng = np.random.default_rng(seed)
    W = -(-tau // 32)
    pk = rng.integers(0, 2**32, size=(tau, Lpk), dtype=np.uint32)
    selw = rng.integers(0, 2**32, size=(B, W), dtype=np.uint32)  # random beyond tau
    selw[0] |= np.uint32(1 << 31)  # bit 31 set in every word of one row
    plain = rng.integers(0, 2, size=B).astype(np.uint32)
    return pk, selw, plain


def jax_encrypt(pk, selw, plain, tau, L):
    pk_bits = jpoly.unpack_bits(jnp.asarray(pk), 32 * pk.shape[1]).astype(jnp.bfloat16)
    sel = jpoly.unpack_bits(jnp.asarray(selw), tau)
    return np.asarray(_encrypt_core(sel, pk_bits, jnp.asarray(plain), L))


class TestEncryptTables:
    @pytest.mark.parametrize("tau", [1, 8, 9, 33, 128, 256, 300])
    @pytest.mark.parametrize("Lpk,L", [(3, 3), (3, 5)])
    def test_matches_jax(self, tau, Lpk, L):
        pk, selw, plain = encrypt_inputs(tau, tau, 70, Lpk)
        want = jax_encrypt(pk, selw, plain, tau, L)
        got = tenc.encrypt_tables_plain(T(selw), T(pk), T(plain), L)
        assert np.array_equal(tpoly.to_numpy(got), want)

    @pytest.mark.parametrize(
        "tau,Lpk,plan",
        [(256, 9, (2, 8)), (256, 9, (4, 2)), (300, 5, (2, 8)), (33, 4, (3, 1)),
         (128, 9, (9, 4)), (300, 5, (5, 3)), (9, 7, (4, 1)),
         # the launcher's (limbs per block, words per pass) on the H100
         (1, 2, (2, 1)), (33, 9, (9, 2)), (96, 9, (9, 4)), (256, 65, (7, 8)),
         (300, 3, (3, 8))],
    )
    def test_every_plan_gives_the_same_bits(self, tau, Lpk, plan):
        """Tiles of key limbs and passes of selection words: the layout
        changes, the bits do not."""
        pk, selw, plain = encrypt_inputs(7, tau, 40, Lpk)
        want = jax_encrypt(pk, selw, plain, tau, Lpk)
        got = tenc.encrypt_tables_plain(T(selw), T(pk), T(plain), Lpk, plan=plan)
        assert np.array_equal(tpoly.to_numpy(got), want)

    def test_fewer_output_limbs_than_the_key(self):
        pk, selw, plain = encrypt_inputs(3, 40, 30, 5)
        want = jax_encrypt(pk, selw, plain, 40, 3)
        got = tenc.encrypt_tables_plain(T(selw), T(pk), T(plain), 3)
        assert np.array_equal(tpoly.to_numpy(got), want)

    def test_kernel_wrapper_on_cpu_is_the_plain_version(self):
        pk, selw, plain = encrypt_inputs(5, 100, 50, 4)
        before = tenc.encrypt_words_table.launches
        got = tenc.encrypt_words_table(T(selw), T(pk), T(plain), 4)
        assert tenc.encrypt_words_table.launches == before
        assert np.array_equal(tpoly.to_numpy(got), jax_encrypt(pk, selw, plain, 100, 4))


class TestClmulComb:
    @pytest.mark.parametrize(
        "La,Lb", [(1, 1), (1, 9), (5, 5), (9, 9), (9, 256), (64, 64), (96, 192), (192, 96)]
    )
    def test_matches_jax(self, La, Lb):
        rng = np.random.default_rng(La * 1000 + Lb)
        a = rng.integers(0, 2**32, size=(3, La), dtype=np.uint32)
        b = rng.integers(0, 2**32, size=(3, Lb), dtype=np.uint32)
        a[0, 0] = b[0, -1] = np.uint32(0xFFFFFFFF)  # every nibble 15, bit 31 set
        want = np.asarray(jk.clmul(jnp.asarray(a), jnp.asarray(b)))
        got = tk.clmul_comb_plain(T(a), T(b))
        assert np.array_equal(tpoly.to_numpy(got), want)


def _smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


class TestSmokeBounds:
    @pytest.mark.parametrize("La,Lb", [(5, 5), (9, 9), (9, 256), (96, 192)])
    def test_comb_work_is_about_half_the_bit_serial_count(self, La, Lb):
        """At the card's per-SM rates (32 shared-memory words, 64 INT32
        operations a clock) the comb's loads take ~15/32 of the time of the
        bit-serial count's 64 operations per pair, and bind its own ops."""
        from homomorph_tpu_torch.utils import profiling  # chip_smoke.py's bounds live here

        smoke = _smoke()
        assert smoke.clmul_comb_work is profiling.clmul_comb_work
        smem_bytes, ops = smoke.clmul_comb_work(2, La, Lb)
        old = smoke.clmul_ops(2, La, Lb)
        t_loads = smem_bytes / profiling.SMEM_BYTES_PER_SM_PER_CLOCK
        assert t_loads / (old / profiling.INT32_OPS_PER_SM_PER_CLOCK) == pytest.approx(15 / 32)
        assert ops / profiling.INT32_OPS_PER_SM_PER_CLOCK < t_loads

    def test_encrypt_lookups(self):
        smoke = _smoke()
        assert smoke.encrypt_lookup_bytes(1 << 21, 128, 9) == (1 << 21) * 16 * 9 * 4
        assert smoke.encrypt_lookup_bytes(10, 33, 9) == 10 * 5 * 9 * 4
