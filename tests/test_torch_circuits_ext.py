"""The port's remaining circuits against the JAX package, on the CPU:
``sum_many``, ``popcount``, the shifts and rotates, ``abs_``, ``clamp``,
the ripple adder's full carries, and the ``HomomorphicSum`` /
``HomomorphicPopCount`` markers.

The same ciphertexts (the JAX package's, carried over as wire bytes) go
through both circuit libraries: limbs, ``bound``, ``noise``, ``zero_lanes``
and shape must be identical (tolerance 0), and the result must decrypt to
the plaintext answer.
"""

import pytest
from test_torch_circuits import encrypt_both, make_pair, same_cipher, wrap8

import homomorph_tpu as hm
import homomorph_tpu_torch as ht
from homomorph_tpu.models import circuits as jcirc
from homomorph_tpu.models import numbers as jnum
from homomorph_tpu_torch.models import circuits as tcirc
from homomorph_tpu_torch.models import numbers as tnum

MUL = (160, 16, 1, 16)  # d/delta 160: u8 sum of 8 (73), u32 popcount (65)
SMALL = (64, 16, 1, 16)
WIDE32 = (256, 16, 1, 16)  # d/delta 256: a u32 add whose carries run the whole chain

U8_X = [0, 1, 6, 13, 99, 250, 255, 170]
I8_X = [-6, -128, 127, -1, 0, 5, -77, 64]
U32_X = [0, 1, 0xFFFFFFFF, 123456789, 2**31, 0xDEADBEEF]


@pytest.fixture(scope="module")
def mul_pair():
    return make_pair(MUL, 16)


@pytest.fixture(scope="module")
def small_pair():
    return make_pair(SMALL, 17)


class TestSumAndPopcount:
    @pytest.mark.parametrize("k", [1, 2, 3, 8])
    def test_sum_many_matches_jax(self, mul_pair, k):
        jctx, tctx = mul_pair
        rows = [[(v * (o + 3) + o) % 256 for v in U8_X] for o in range(k)]
        pairs = [encrypt_both(jctx, r, "U8") for r in rows]
        tc = tcirc.sum_many([t for _, t in pairs])
        same_cipher(tc, jcirc.sum_many([j for j, _ in pairs]))
        assert [int(v) for v in tctx.decrypt(tc)] == [sum(c) % 256 for c in zip(*rows)]

    @pytest.mark.parametrize("desc,xs", [("U8", U8_X), ("U32", U32_X), ("I8", I8_X)])
    def test_popcount_matches_jax(self, mul_pair, desc, xs):
        jctx, tctx = mul_pair
        ja, ta = encrypt_both(jctx, xs, desc)
        tc = tcirc.popcount(ta)
        same_cipher(tc, jcirc.popcount(ja))
        bits = 32 if desc == "U32" else 8
        want = [bin(x % (1 << bits)).count("1") for x in xs]
        assert [int(v) for v in tctx.decrypt(tc)] == want

    def test_sum_many_refuses_mixed_widths(self, small_pair):
        jctx, _ = small_pair
        (_, a), (_, b) = encrypt_both(jctx, [1], "U8"), encrypt_both(jctx, [1], "U16")
        with pytest.raises(ValueError):
            tcirc.sum_many([a, b, a])
        with pytest.raises(ValueError):
            tcirc.sum_many([])


class TestShiftsAndRotates:
    @pytest.mark.parametrize("desc,xs", [("U8", U8_X), ("I8", I8_X)])
    @pytest.mark.parametrize("name", ["shl", "shr", "rotl", "rotr"])
    @pytest.mark.parametrize("k", [0, 3, 8, 11])
    def test_matches_jax(self, small_pair, desc, xs, name, k):
        jctx, tctx = small_pair
        ja, ta = encrypt_both(jctx, xs, desc)
        tc = getattr(tcirc, name)(ta, k)
        same_cipher(tc, getattr(jcirc, name)(ja, k))
        u = [x % 256 for x in xs]
        want = {
            "shl": [(x << k) % 256 for x in u],
            "shr": [x >> k for x in xs] if desc == "I8" else [x >> k for x in u],
            "rotl": [((x << k % 8) | (x >> (8 - k % 8))) % 256 for x in u],
            "rotr": [((x >> k % 8) | (x << (8 - k % 8))) % 256 for x in u],
        }[name]
        fix = wrap8 if desc == "I8" else (lambda v: v % 256)
        assert [int(v) for v in tctx.decrypt(tc)] == [fix(v) for v in want]

    @pytest.mark.parametrize("arithmetic", [True, False])
    def test_shr_override_matches_jax(self, small_pair, arithmetic):
        jctx, _ = small_pair
        for desc, xs in (("U8", U8_X), ("I8", I8_X)):
            ja, ta = encrypt_both(jctx, xs, desc)
            for k in (1, 7, 9):
                same_cipher(tcirc.shr(ta, k, arithmetic=arithmetic),
                            jcirc.shr(ja, k, arithmetic=arithmetic))

    def test_negative_shift_refused(self, small_pair):
        _, ta = encrypt_both(small_pair[0], U8_X, "U8")
        for fn in (tcirc.shl, tcirc.shr):
            with pytest.raises(ValueError):
                fn(ta, -1)

    def test_shift_of_a_bool_keeps_zero_lanes_dense(self, small_pair):
        """A compare result has implicit zero lanes; the remaps densify
        first, as the JAX package's do."""
        jctx, tctx = small_pair
        (ja, ta), (jb, tb) = encrypt_both(jctx, U8_X, "U8"), encrypt_both(jctx, U8_X[::-1], "U8")
        jl, tl = jcirc.lt(ja, jb), tcirc.lt(ta, tb)
        for name, k in (("shl", 1), ("rotr", 2)):
            same_cipher(getattr(tcirc, name)(tl, k), getattr(jcirc, name)(jl, k))


class TestAbsAndClamp:
    def test_abs_matches_jax_at_the_type_minimum(self, small_pair):
        jctx, tctx = small_pair
        ja, ta = encrypt_both(jctx, I8_X, "I8")
        tc = tcirc.abs_(ta)
        same_cipher(tc, jcirc.abs_(ja))
        assert [int(v) for v in tctx.decrypt(tc)] == [wrap8(abs(x)) for x in I8_X]  # -128 wraps

    @pytest.mark.parametrize("desc,xs,lo,hi", [("U8", U8_X, 10, 200), ("I8", I8_X, -50, 100)])
    def test_clamp_matches_jax(self, mul_pair, desc, xs, lo, hi):
        """Two comparisons and two muxes deep: d/delta 64 is too little for
        a decrypt, so at 160."""
        jctx, tctx = mul_pair
        ja, ta = encrypt_both(jctx, xs, desc)
        jlo, tlo = encrypt_both(jctx, [lo] * len(xs), desc)
        jhi, thi = encrypt_both(jctx, [hi] * len(xs), desc)
        tc = tcirc.clamp(ta, tlo, thi)
        same_cipher(tc, jcirc.clamp(ja, jlo, jhi))
        assert [int(v) for v in tctx.decrypt(tc)] == [min(max(x, lo), hi) for x in xs]


class TestRippleAdder:
    """Adds whose carries run the whole chain, and a subtraction with its
    trivial-one carry in, against the JAX package's default adder (the
    same ripple)."""

    @pytest.mark.parametrize("op,desc,params,seed,xs,ys", [
        ("add", "U16", SMALL, 23, [1000, 0xFFFF, 0, 40000], [2000, 1, 0, 40000]),
        ("add", "U32", WIDE32, 23, U32_X[:4], [0, 1, 1, 987654321]),
        ("sub", "U16", (128, 16, 1, 16), 24, [5000, 3], [4999, 7]),
    ])
    def test_matches_jax(self, op, desc, params, seed, xs, ys):
        jctx, tctx = make_pair(params, seed)
        (ja, ta), (jb, tb) = encrypt_both(jctx, xs, desc), encrypt_both(jctx, ys, desc)
        tc = getattr(tcirc, op)(ta, tb)
        same_cipher(tc, getattr(jcirc, op)(ja, jb))
        sign = 1 if op == "add" else -1
        mask = (1 << (16 if desc == "U16" else 32)) - 1
        assert [int(v) for v in tctx.decrypt(tc)] == [(x + sign * y) & mask
                                                      for x, y in zip(xs, ys)]


NEW_MARKERS = ["Sum", "PopCount"]


class TestMarkers:
    @pytest.mark.parametrize("name", NEW_MARKERS)
    def test_requirements_match_jax(self, name):
        jop, top = getattr(jnum, "Homomorphic" + name), getattr(tnum, "Homomorphic" + name)
        assert top.MIN_D_OVER_DELTA == jop.MIN_D_OVER_DELTA
        for jd, td in ((hm.U8, ht.U8), (hm.I16, ht.I16), (hm.U32, ht.U32)):
            zj, zt = hm.Ciphered.trivial(0, jd), ht.Ciphered.trivial(0, td, device="cpu")
            for noise in (0, 2, 5, 40):
                zj.noise = zt.noise = noise
                counts = (1,) if name == "PopCount" else (1, 2, 3, 8)
                for k in counts:
                    assert top.requirement_for(*[zt] * k) == jop.requirement_for(*[zj] * k), (
                        jd, noise, k)

    @pytest.mark.parametrize("params", [SMALL, (32, 8, 2, 8), MUL, (40, 8, 1, 8)])
    def test_refusals_match_jax(self, params):
        jctx, tctx = make_pair(params, 2)
        pairs = [encrypt_both(jctx, [1, 2], "U8") for _ in range(3)]
        (j32, t32) = encrypt_both(jctx, [5, 6], "U32")
        for name, args_j, args_t in (
            ("Sum", [j for j, _ in pairs], [t for _, t in pairs]),
            ("PopCount", [j32], [t32]),
        ):
            jop, top = getattr(jnum, "Homomorphic" + name), getattr(tnum, "Homomorphic" + name)
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

    def test_checked_apply_matches_jax(self, mul_pair):
        jctx, tctx = mul_pair
        pairs = [encrypt_both(jctx, [(v + o) % 256 for v in U8_X], "U8") for o in range(3)]
        tc = tctx.apply_n(tnum.HomomorphicSum, [t for _, t in pairs])
        same_cipher(tc, jctx.apply_n(jnum.HomomorphicSum, [j for j, _ in pairs]))
        ja, ta = encrypt_both(jctx, U32_X, "U32")
        tc = tctx.apply1(tnum.HomomorphicPopCount, ta)
        same_cipher(tc, jctx.apply1(jnum.HomomorphicPopCount, ja))
        assert [int(v) for v in tctx.decrypt(tc)] == [bin(x).count("1") for x in U32_X]

    def test_exported_like_the_jax_package(self):
        import homomorph_tpu.models as jmodels
        import homomorph_tpu_torch.models as tmodels

        for name in NEW_MARKERS:
            assert getattr(tmodels, "Homomorphic" + name) is getattr(tnum, "Homomorphic" + name)
            assert hasattr(jmodels, "Homomorphic" + name)
        assert set(tnum.__all__) == set(jnum.__all__)
