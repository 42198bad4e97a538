"""The tensor-core encrypt kernels' wrappers (K3, X1) and the kernel
selector, against the JAX package on the CPU.

On a CPU tensor ``encrypt_words_mma`` (K3) and ``encrypt_sel_mma`` (X1)
compute their plain versions; these are held against
``homomorph_tpu.cipher._encrypt_core`` on the same selection words, public
key and plaintext bits.  ``tests/test_torch_cuda.py`` holds the CUDA
kernels against the plain versions on the card.  Tolerance 0 (integer
GF(2) values).
"""

import os
import re

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
from homomorph_tpu_torch.utils.profiling import counters


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
        before = (counters["K3"], counters["X1"], counters["K2"])
        tenc.encrypt_words_mma(T(selw), planes, T(plain), 2)
        tenc.encrypt_sel_mma(tpoly.unpack_bits(T(selw), 33, dtype=torch.int8), planes, T(plain), 2)
        tenc.encrypt_words_table(T(selw), T(pk), T(plain), 2)
        assert before == (counters["K3"], counters["X1"], counters["K2"])

    def test_empty_batch(self, rng):
        pk, _, _ = inputs(rng, 33, 1, 2)
        planes = tenc.pk_planes(tenc.pk_columns(T(pk)))
        empty = torch.zeros((0, 2), dtype=torch.int32)
        out = tenc.encrypt_words_mma(empty, planes, torch.zeros(0, dtype=torch.int32), 3)
        assert out.shape == (0, 3)


TAUS = [1, 31, 32, 33, 64, 127, 128, 255, 256, 257, 512]
BATCHES = [1, 63, 64, 65, 127, 129, 130]
# L below, at and above the key's D / 32 limbs
L_CASES = {"below": lambda lk: lk - 4, "equal": lambda lk: lk, "above": lambda lk: lk + 3}
# a cap that forces passes over K and several column slices at small shapes
TIGHT_CAP = tenc._mma_smem(tenc.MMA_TILE_LIMBS, 64)[0]


class TestMmaPlan:
    """K3's and X1's tile plan (``mma_plan``), which the wrappers pass to
    ``csrc/encrypt_mma.cu``: what the kernel's indexing relies on."""

    @pytest.mark.parametrize("case", list(L_CASES))
    @pytest.mark.parametrize("tau", TAUS)
    def test_plans_are_valid(self, tau, case):
        for Lpk in (9, 65):
            L = L_CASES[case](Lpk)
            for B in BATCHES:
                for cap in (tenc.MMA_SMEM_CAP, TIGHT_CAP):
                    self.check(tenc.mma_plan(B, tau, 32 * Lpk, L, smem_cap=cap), B, tau, Lpk, L, cap)

    @staticmethod
    def check(p, B, tau, Lpk, L, cap):
        assert (p.W, p.Kp, p.Lc) == (-(-tau // 32), 32 * -(-tau // 32), min(L, Lpk))
        # K padded to a run of k-steps the kernel unrolls: 1, 2, 4 or 8s
        steps = p.Kq // 32
        assert p.Kq % 32 == 0 and (steps in (1, 2, 4) or steps % 8 == 0)
        assert p.Kp <= p.Kq < max(2 * p.Kp, p.Kp + 256)
        # passes over K: every pass, the last too, a run the kernel unrolls
        assert p.kc in (32, 64, 128) or p.kc % 256 == 0
        assert (p.n_pass - 1) * p.kc < p.Kq <= p.n_pass * p.kc
        last = p.Kq - (p.n_pass - 1) * p.kc
        assert last in (32, 64, 128) or last % 256 == 0
        # slices cover the limbs that have key columns, none empty
        assert (p.n_slices - 1) * p.slice_limbs < p.Lc <= p.n_slices * p.slice_limbs
        for s in range(p.n_slices):
            limbs = min(p.slice_limbs, p.Lc - s * p.slice_limbs)
            tiles = p.col_tiles(limbs)
            assert tiles[0][0] == 0 and tiles[-1][1] == limbs
            assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
            assert all(1 <= hi - lo <= tenc.MMA_TILE_LIMBS for lo, hi in tiles)
        # shared memory: the slice's planes and the warpgroups' odd-strided stages fit
        assert p.stage_stride % 2 == 1 and p.slice_limbs <= p.stage_stride <= p.slice_limbs + 1
        assert p.smem_bytes == (p.slice_limbs * 32 * p.kc
                                + tenc.MMA_WARPGROUPS * tenc.MMA_TILE_ROWS * 4 * p.stage_stride)
        assert p.smem_bytes <= cap
        # the wgmma descriptor's 14-bit fields (16-byte units) hold the offsets
        assert p.smem_bytes < 1 << 18 and 4 * p.slice_limbs * 128 // 16 < 1 << 14
        # row tiles cover the batch; at most one block an SM unless slices need more
        assert (p.row_tiles - 1) * tenc.MMA_TILE_ROWS < B <= p.row_tiles * tenc.MMA_TILE_ROWS
        assert 1 <= p.groups <= -(-p.row_tiles // tenc.MMA_WARPGROUPS)
        assert p.groups * p.n_slices <= max(132, p.n_slices)

    def test_main_path_shapes(self):
        """The plans the card runs at 2^21 bits: one slice at tau = 128,
        three of 22 limbs at tau = 256, one pass each."""
        p = tenc.mma_plan(1 << 21, 128, 288, 9)
        assert (p.n_slices, p.slice_limbs, p.n_pass, p.groups) == (1, 9, 1, 132)
        assert p.col_tiles(9) == [(0, 3), (3, 6), (6, 9)]
        p = tenc.mma_plan(1 << 21, 256, 2080, 65)
        assert (p.n_slices, p.slice_limbs, p.n_pass, p.groups) == (3, 22, 1, 44)
        assert p.smem_bytes == 203_776
        p = tenc.mma_plan(5, 65535, 64, 3)  # the widest tau: passes over K
        assert p.n_pass == 19 and p.smem_bytes <= tenc.MMA_SMEM_CAP

    def test_no_plan_below_one_k_step(self):
        with pytest.raises(ValueError, match="shared memory"):
            tenc.mma_plan(64, 128, 288, 9, smem_cap=4000)

    def test_kernel_takes_the_plans_fields_in_order(self):
        """The kernel entries read the plan as int64 fields in ``MmaPlan``'s
        order (the ``Plan`` struct of ``csrc/encrypt_mma.cu``), and derive
        none of them."""
        src = open(os.path.join(os.path.dirname(tenc.__file__), "..", "csrc",
                                "encrypt_mma.cu")).read()
        body = re.search(r"struct Plan \{\s*long long ([^;]*);", src).group(1)
        assert [f.strip() for f in body.split(",")] == list(tenc.MmaPlan._fields)
        assert "kq_of" not in src and "slice_limbs | 1" not in src


class TestMmaWalkMatchesJax:
    """The torch walk of the plan (slices, passes, row and column tiles in
    the kernel's order) against ``_encrypt_core``, bit for bit, for K3's
    words and X1's int8 rows, on the default plan and a tight one."""

    @pytest.mark.parametrize("case", list(L_CASES))
    @pytest.mark.parametrize("tau", TAUS)
    def test_walk(self, rng, tau, case):
        Lpk = 9
        L = L_CASES[case](Lpk)
        B = BATCHES[(TAUS.index(tau) + list(L_CASES).index(case)) % len(BATCHES)]
        pk, selw, plain = inputs(rng, tau, B, Lpk)
        want, jsel = jax_reference(pk, selw, plain, tau, L)
        planes = tenc.pk_planes(tenc.pk_columns(T(pk)))
        sel = torch.from_numpy(jsel.astype(np.int8))
        tight = tenc.mma_plan(B, tau, 32 * Lpk, L, smem_cap=TIGHT_CAP)
        for a in (T(selw), sel):
            for plan in (None, tight):
                got = tenc.encrypt_mma_walk(a, planes, T(plain), L, plan)
                assert np.array_equal(tpoly.to_numpy(got), want), (a.dtype, plan)
        # the tight cap cuts the slice and K (a 32-byte K keeps five limbs whole)
        assert (tight.n_slices > 1 or tight.Kp == 32) and (tight.n_pass > 1 or tau <= 64)


def test_experiment_rows_agree_on_the_cpu():
    out = exp_enc.run(bits=512, device="cpu")
    assert set(out["rows"]) == {"pallas_v2", "pallas_v1", "pallas_v3"}
    assert all(r["mismatches"] == 0 and r["ms"] is None for r in out["rows"].values())
    assert (out["tau"], out["D"], out["L"]) == (128, 288, 9)
