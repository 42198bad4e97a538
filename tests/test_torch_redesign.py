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
* ``clmul_square_plain`` follows K1's square path (a row's ``L + 2``
  columns, ``k`` to a lane, each lane walking every limb once, the window
  stored twice, several rows a block); it is held against
  ``homomorph_tpu.gf2.kernels.clmul`` and the plain sweep at every square
  width up to 64, at every ``k`` the kernel has and at the widths where
  its table changes ``k``, and its layout's reads against the banks of the
  card's shared memory.

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
from homomorph_tpu_torch.utils.profiling import counters


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
        before = counters["K2"]
        got = tenc.encrypt_words_table(T(selw), T(pk), T(plain), 4)
        assert counters["K2"] == before
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


class TestClmulSquare:
    @pytest.mark.parametrize(
        "L,B", [(L, 70) for L in range(1, 65)] + [(L, 200) for L in (9, 32, 41, 48, 63)]
    )
    def test_matches_jax_and_the_sweep(self, L, B):
        """Random rows, all-ones rows and single-bit rows, over several blocks
        of rows with the last one partial; the JAX product is taken at 64
        limbs (the operands zero-padded: one compile for every width)."""
        rng = np.random.default_rng(L * 1000 + B)
        a = rng.integers(0, 2**32, size=(B, L), dtype=np.uint32)
        b = rng.integers(0, 2**32, size=(B, L), dtype=np.uint32)
        a[0] = b[0] = np.uint32(0xFFFFFFFF)
        a[1], b[1] = 0, 0
        a[1, -1], b[1, L // 2] = np.uint32(1 << 31), np.uint32(1 << (L % 32))
        a[2] = 0
        a[2, 0] = 1  # a single bit against a random row
        b[3] = 0
        b[3, -1] = np.uint32(1 << 31)
        pad = ((0, 0), (0, 64 - L))
        want = np.asarray(jk.clmul(jnp.asarray(np.pad(a, pad)), jnp.asarray(np.pad(b, pad))))
        assert not want[:, 2 * L:].any()
        got = tk.clmul_square_plain(T(a), T(b))
        assert np.array_equal(tpoly.to_numpy(got), want[:, : 2 * L])
        assert np.array_equal(tpoly.to_numpy(tk.clmul_plain(T(a), T(b))), want[:, : 2 * L])

    def test_refusals_off_the_card(self):
        a, b = T(np.ones((2, 3), np.uint32)), T(np.ones((2, 4), np.uint32))
        with pytest.raises(ValueError, match="square"):
            tk.clmul_square_plain(a, b)
        with pytest.raises(ValueError, match="cuda"):
            tk.clmul_mapping(a, a, True)
        before = counters["K1.square"]
        assert np.array_equal(tpoly.to_numpy(tk.clmul_flat(a, a)),
                              tpoly.to_numpy(tk.clmul_square_plain(a, a)))
        assert counters["K1.square"] == before  # a CPU call launches nothing

    @pytest.mark.parametrize("K", tk.SQUARE_KS)
    @pytest.mark.parametrize("L", [1, 2, 5, 9, 16, 32, 41, 48, 63])
    def test_every_k_matches_the_plain_product(self, L, K):
        """Each ``k`` the kernel has an instance of, at widths whose last
        lane owns columns past the row and whose last block is partial."""
        rng = np.random.default_rng(L * 100 + K)
        B = 2 * tk.square_layout(L, K)[0] + 3
        a = rng.integers(0, 2**32, size=(B, L), dtype=np.uint32)
        b = rng.integers(0, 2**32, size=(B, L), dtype=np.uint32)
        a[0] = b[0] = np.uint32(0xFFFFFFFF)
        want = tpoly.to_numpy(tk.clmul_plain(T(a), T(b)))
        assert np.array_equal(tpoly.to_numpy(tk.clmul_square_plain(T(a), T(b), K)), want)

    @pytest.mark.parametrize(
        "L", sorted({L for L0, _ in tk.SQUARE_COLUMNS[1:] for L in (L0 - 1, L0)})
    )
    def test_where_the_table_changes_k(self, L):
        """Each side of every width where ``SQUARE_COLUMNS`` changes ``k``,
        at the table's ``k``, the last block partial."""
        rng = np.random.default_rng(L)
        B = 2 * tk.square_layout(L)[0] + 1
        a = rng.integers(0, 2**32, size=(B, L), dtype=np.uint32)
        b = rng.integers(0, 2**32, size=(B, L), dtype=np.uint32)
        want = tpoly.to_numpy(tk.clmul_plain(T(a), T(b)))
        assert np.array_equal(tpoly.to_numpy(tk.clmul_square_plain(T(a), T(b))), want)

    def test_the_table_of_k(self):
        """``SQUARE_COLUMNS`` starts at one limb, rises, and names only a
        ``k`` the kernel has; ``square_layout`` refuses any other."""
        starts = [L0 for L0, _ in tk.SQUARE_COLUMNS]
        assert starts[0] == 1 and starts == sorted(set(starts))
        assert all(K in tk.SQUARE_KS for _, K in tk.SQUARE_COLUMNS)
        for K in (0, 2, 4, 7):
            with pytest.raises(ValueError, match="columns a lane"):
                tk.square_layout(32, K)

    @staticmethod
    def _distinct_banks(L, K):
        """At any step and any nibbles, the 32 lanes of a warp (of one, two
        or more rows) read 32 distinct banks in each of a nibble's ``k + 1``
        loads; the staging stores do too, and the rows' limbs of the smaller
        operand lie in distinct banks.  The block fits 1,024 threads and
        227 KB, and every read lies in its row's window."""
        import torch

        rows, row_words, nib_words, s_words, K = tk.square_layout(L, K)
        Q = -(-(L + 2) // K)
        assert rows * Q <= 1024 and (16 * nib_words + rows * s_words) * 4 <= 232448
        tid = torch.arange(rows * Q)
        r, t0 = tid // Q, tid % Q * K
        gen = torch.Generator().manual_seed(L)

        def distinct_a_warp(words, live=None):
            live = torch.ones_like(words, dtype=torch.bool) if live is None else live
            for w0 in range(0, len(words), 32):
                banks = words[w0 : w0 + 32][live[w0 : w0 + 32]] % 32
                assert len(banks.unique()) == len(banks)

        first = torch.ones_like(t0, dtype=torch.bool)
        first[1:] = r[1:] != r[:-1]
        first[::32] = True  # each row's first lane in each warp
        for i in sorted({0, 1, L // 2, L - 1} & set(range(L))):  # steps i < L
            nib = torch.randint(0, 16, (rows,), generator=gen)[r]
            at = tk.square_addresses(L, r, t0, i, nib, nib_words, row_words)
            for c in range(K + 1):
                distinct_a_warp(at + c - 1)
            pos = at - nib * nib_words - r * row_words
            assert int(pos.min()) - 1 >= 0 and int(pos.max()) + K - 1 < row_words
            distinct_a_warp(16 * nib_words + r * s_words + i, first)  # one word a row
        u = int(torch.randint(0, 16, (1,), generator=gen))
        for c in range(K):
            t = t0 + c
            distinct_a_warp(u * nib_words + r * row_words + L + t, t < L + 2)
            distinct_a_warp(u * nib_words + r * row_words + t - 2, (t >= 2) & (t < L + 2))

    @pytest.mark.parametrize("L", [1, 2, 3, 5, 9, 16, 30, 32, 33, 41, 48, 63, 64, 100, 255, 1022])
    def test_a_warps_reads_hit_distinct_banks(self, L):
        """The layout at the width's own ``k`` (:meth:`_distinct_banks`)."""
        self._distinct_banks(L, None)

    @pytest.mark.parametrize("K", tk.SQUARE_KS)
    @pytest.mark.parametrize("L", [1, 2, 9, 32, 41, 48, 63, 255, 1022])
    def test_every_k_reads_distinct_banks(self, L, K):
        """The layout at each ``k`` the kernel has (:meth:`_distinct_banks`)."""
        self._distinct_banks(L, K)


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
