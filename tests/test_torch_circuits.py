"""The port's multipliers, comparators and their markers against the JAX
package, on the CPU.

The same ciphertexts (the JAX package's, carried over as wire bytes) go
through ``homomorph_tpu.models.circuits`` and
``homomorph_tpu_torch.models.circuits``: limbs, ``bound``, ``noise``,
``zero_lanes`` and shape must be identical (tolerance 0), and the result
must decrypt to the plaintext answer.  The markers' requirements and their
refusals in the checked API must be the JAX markers'.
"""

import jax
import numpy as np
import pytest

import homomorph_tpu as hm
import homomorph_tpu_torch as ht
from homomorph_tpu.models import circuits as jcirc
from homomorph_tpu.models import numbers as jnum
from homomorph_tpu_torch.gf2 import poly as tpoly
from homomorph_tpu_torch.models import circuits as tcirc
from homomorph_tpu_torch.models import numbers as tnum

MUL = (160, 16, 1, 16)  # d/delta = 160 >= 65, the u8 tree bound (as tests/test_csa_mul.py)
SMALL = (64, 16, 1, 16)

U8_X = [0, 1, 6, 13, 99, 250, 255, 170]
U8_Y = [7, 255, 7, 11, 201, 3, 255, 85]
I8_X = [-6, -6, -128, -1, 127, 0, 5, -77]
I8_Y = [7, -7, -1, -1, 127, -128, -5, 3]

NEW_MARKERS = ["Multiplication", "Subtraction", "Negation", "LessThan", "GreaterThan",
               "Minimum", "Maximum", "Equality"]


def make_pair(params, seed):
    jctx = hm.Context(hm.Parameters(*params), source=hm.ThreefrySource(seed))
    jctx.generate_secret_key()
    jctx.generate_public_key()
    sk, pk = ht.keys.keys_from_numpy(
        np.asarray(jctx.get_secret_key()._host), np.asarray(jctx.get_public_key()._host),
        device="cpu")
    tctx = ht.Context(ht.Parameters(*params), device="cpu")
    tctx.set_secret_key(sk)
    tctx.set_public_key(pk)
    return jctx, tctx


def encrypt_both(jctx, vals, name):
    jc = jctx.encrypt(vals, getattr(hm, name), batch=True)
    return jc, ht.Ciphered.from_bytes(jc.to_bytes(), getattr(ht, name), device="cpu")


def same_cipher(tc, jc):
    jl = np.asarray(jax.device_get(jc.limbs), dtype=np.uint32)
    assert tpoly.to_numpy(tc.limbs).shape == jl.shape
    assert np.array_equal(tpoly.to_numpy(tc.limbs), jl)
    assert (tc.bound, tc.noise, tc.zero_lanes, len(tc)) == (
        jc.bound, jc.noise, jc.zero_lanes, len(jc))


def wrap8(v):
    return ((v + 128) % 256) - 128


@pytest.fixture(scope="module")
def mul_pair():
    return make_pair(MUL, 6)


@pytest.fixture(scope="module")
def small_pair():
    return make_pair(SMALL, 7)


class TestMultipliers:
    @pytest.mark.parametrize("name", ["mul_unsigned", "mul_unsigned_ref"])
    def test_unsigned_matches_jax(self, mul_pair, name):
        jctx, tctx = mul_pair
        (ja, ta), (jb, tb) = encrypt_both(jctx, U8_X, "U8"), encrypt_both(jctx, U8_Y, "U8")
        tc = getattr(tcirc, name)(ta, tb)
        same_cipher(tc, getattr(jcirc, name)(ja, jb))
        assert [int(v) for v in tctx.decrypt(tc)] == [(x * y) & 0xFF for x, y in zip(U8_X, U8_Y)]

    @pytest.mark.parametrize("name", ["mul_signed", "mul_signed_ref"])
    def test_signed_matches_jax(self, mul_pair, name):
        jctx, tctx = mul_pair
        (ja, ta), (jb, tb) = encrypt_both(jctx, I8_X, "I8"), encrypt_both(jctx, I8_Y, "I8")
        tc = getattr(tcirc, name)(ta, tb)
        same_cipher(tc, getattr(jcirc, name)(ja, jb))
        assert [int(v) for v in tctx.decrypt(tc)] == [wrap8(x * y) for x, y in zip(I8_X, I8_Y)]

    def test_lane_forms_decrypt(self, mul_pair):
        _, tctx = mul_pair
        a, b = tctx.encrypt([23, 200], ht.U8, batch=True), tctx.encrypt([11, 3], ht.U8, batch=True)
        lanes = tcirc.mul_unsigned_lanes(list(a), list(b))
        assert [int(v) for v in tctx.decrypt(ht.Ciphered.new_from_raw(lanes, ht.U8))] == [253, 88]
        a, b = tctx.encrypt([-6, 100], ht.I8, batch=True), tctx.encrypt([7, -2], ht.I8, batch=True)
        lanes = tcirc.mul_signed_lanes(list(a), list(b))
        assert [int(v) for v in tctx.decrypt(ht.Ciphered.new_from_raw(lanes, ht.I8))] == [-42, 56]

    def test_checked_marker_matches_jax(self, mul_pair):
        jctx, tctx = mul_pair
        (ja, ta), (jb, tb) = encrypt_both(jctx, U8_X, "U8"), encrypt_both(jctx, U8_Y, "U8")
        tc = tctx.apply2(tnum.HomomorphicMultiplication, ta, tb)
        same_cipher(tc, jctx.apply2(jnum.HomomorphicMultiplication, ja, jb))


class TestComparators:
    CASES = {
        "lt": lambda x, y: x < y, "gt": lambda x, y: x > y,
        "le": lambda x, y: x <= y, "ge": lambda x, y: x >= y,
        "eq": lambda x, y: x == y, "min_": min, "max_": max,
    }

    @pytest.mark.parametrize("name", sorted(CASES))
    @pytest.mark.parametrize("desc", ["U8", "I8"])
    def test_matches_jax(self, small_pair, name, desc):
        jctx, tctx = small_pair
        xs, ys = (U8_X, U8_Y) if desc == "U8" else (I8_X, I8_Y)  # each has an equal pair
        (ja, ta), (jb, tb) = encrypt_both(jctx, xs, desc), encrypt_both(jctx, ys, desc)
        tc = getattr(tcirc, name)(ta, tb)
        same_cipher(tc, getattr(jcirc, name)(ja, jb))
        got = [v if isinstance(v, bool) else int(v) for v in tctx.decrypt(tc)]
        assert got == [self.CASES[name](x, y) for x, y in zip(xs, ys)]

    @pytest.mark.parametrize("desc", ["U8", "I8"])
    def test_sub_and_neg_match_jax(self, small_pair, desc):
        jctx, tctx = small_pair
        xs, ys = (U8_X, U8_Y) if desc == "U8" else (I8_X, I8_Y)
        (ja, ta), (jb, tb) = encrypt_both(jctx, xs, desc), encrypt_both(jctx, ys, desc)
        fix = (lambda v: v & 0xFF) if desc == "U8" else wrap8
        ts, tn = tcirc.sub(ta, tb), tcirc.neg(ta)
        same_cipher(ts, jcirc.sub(ja, jb))
        same_cipher(tn, jcirc.neg(ja))
        assert [int(v) for v in tctx.decrypt(ts)] == [fix(x - y) for x, y in zip(xs, ys)]
        assert [int(v) for v in tctx.decrypt(tn)] == [fix(-x) for x in xs]

    def test_select_matches_jax(self, small_pair):
        jctx, tctx = small_pair
        (ja, ta), (jb, tb) = encrypt_both(jctx, U8_X, "U8"), encrypt_both(jctx, U8_Y, "U8")
        (jc, tc) = encrypt_both(jctx, [1, 0, 1, 0, 1, 1, 0, 0], "Bool")
        tout = tcirc.select(tc[0], ta, tb)
        same_cipher(tout, jcirc.select(jc[0], ja, jb))
        want = [x if c else y for x, y, c in zip(U8_X, U8_Y, [1, 0, 1, 0, 1, 1, 0, 0])]
        assert [int(v) for v in tctx.decrypt(tout)] == want

    def test_adder_carry_out_matches_jax(self, small_pair):
        jctx, tctx = small_pair
        (ja, ta), (jb, tb) = encrypt_both(jctx, U8_X, "U8"), encrypt_both(jctx, U8_Y, "U8")
        jbit = jcirc._adder_carry_out(ja, jcirc.gate_not(jb), hm.CipheredBit.one(ja.batch_shape))
        tbit = tcirc._adder_carry_out(
            ta, tcirc.gate_not(tb), ht.CipheredBit.one(ta.batch_shape, device="cpu"))
        assert np.array_equal(tpoly.to_numpy(tbit.limbs), np.asarray(jbit.limbs))
        assert (tbit.bound, tbit.noise) == (jbit.bound, jbit.noise)
        # carry out of a + ~b + 1 is a >= b
        got = tbit.decipher(tctx.get_secret_key()).tolist()
        assert got == [int(x >= y) for x, y in zip(U8_X, U8_Y)]


class TestMarkers:
    @pytest.mark.parametrize("name", NEW_MARKERS)
    def test_requirements_match_jax(self, name):
        jop, top = getattr(jnum, "Homomorphic" + name), getattr(tnum, "Homomorphic" + name)
        assert top.MIN_D_OVER_DELTA == jop.MIN_D_OVER_DELTA
        for jd, td in ((hm.U8, ht.U8), (hm.I16, ht.I16), (hm.U32, ht.U32)):
            zj, zt = hm.Ciphered.trivial(0, jd), ht.Ciphered.trivial(0, td, device="cpu")
            for noise in (0, 2, 5, 40):
                zj.noise = zt.noise = noise
                assert top.requirement_for(zt, zt) == jop.requirement_for(zj, zj), (jd, noise)

    @pytest.mark.parametrize("params", [SMALL, (32, 8, 2, 8), (40, 8, 1, 8)])
    def test_refusals_match_jax(self, params):
        jctx, tctx = make_pair(params, 2)
        (ja, ta), (jb, tb) = encrypt_both(jctx, [1, 2], "U8"), encrypt_both(jctx, [3, 4], "U8")
        for name in NEW_MARKERS:
            jop, top = getattr(jnum, "Homomorphic" + name), getattr(tnum, "Homomorphic" + name)
            args_j, args_t = ((ja,), (ta,)) if name == "Negation" else ((ja, jb), (ta, tb))
            try:
                jctx.validate_operation(jop, *args_j)
                refused = False
            except hm.InvalidParametersError as e:
                refused = str(e)
            if refused:
                with pytest.raises(ht.InvalidParametersError) as te:
                    tctx.validate_operation(top, *args_t)
                assert str(te.value) == refused
            else:
                tctx.validate_operation(top, *args_t)
        # u8 multiplication needs d/delta >= 65: refused at (64, 16, 1, 16)
        if params == SMALL:
            with pytest.raises(ht.InvalidParametersError):
                tctx.apply2(tnum.HomomorphicMultiplication, ta, tb)

    @pytest.mark.parametrize("name", [m for m in NEW_MARKERS if m != "Multiplication"])
    def test_checked_apply_matches_jax(self, small_pair, name):
        jctx, tctx = small_pair
        jop, top = getattr(jnum, "Homomorphic" + name), getattr(tnum, "Homomorphic" + name)
        (ja, ta), (jb, tb) = encrypt_both(jctx, U8_X, "U8"), encrypt_both(jctx, U8_Y, "U8")
        if name == "Negation":
            same_cipher(tctx.apply1(top, ta), jctx.apply1(jop, ja))
        else:
            same_cipher(tctx.apply2(top, ta, tb), jctx.apply2(jop, ja, jb))

    def test_exported_like_the_jax_package(self):
        import homomorph_tpu_torch.models as tmodels

        for name in NEW_MARKERS:
            assert getattr(tmodels, "Homomorphic" + name) is getattr(tnum, "Homomorphic" + name)
