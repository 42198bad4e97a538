"""The port's main path against the JAX package, on the CPU.

keygen -> encrypt -> gates and the checked adder -> decrypt, run through
both ``homomorph_tpu`` and ``homomorph_tpu_torch`` from the same recorded
randomness: key bytes, ciphertext wire bytes, limbs, ``bound``, ``noise``
and decrypted values must be identical (integer GF(2) values, tolerance 0).
Also: the checked-in interop fixtures, ``keys_from_numpy``, wire bytes
moving between the packages, and the port's doctests.
"""

import doctest
import json
import os

import jax
import numpy as np
import pytest
import torch

import homomorph_tpu as hm
import homomorph_tpu_torch as ht
from homomorph_tpu.models import numbers as jnum
from homomorph_tpu_torch.gf2 import poly as tpoly
from homomorph_tpu_torch.models import numbers as tnum

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "interop_v1.json")
with open(FIXTURE) as f:
    CASES = json.load(f)["cases"]
CASE_IDS = ["d{d}dp{dp}delta{delta}tau{tau}".format(**c["params"]) for c in CASES]

SMALL = (64, 16, 1, 16)


def contexts(params, seed):
    jctx = hm.Context(hm.Parameters(*params), source=hm.ThreefrySource(seed))
    tctx = ht.Context(ht.Parameters(*params), source=ht.ThreefrySource(seed), device="cpu")
    for ctx in (jctx, tctx):
        ctx.generate_secret_key()
        ctx.generate_public_key()
    return jctx, tctx


def jlimbs(c):
    return np.asarray(jax.device_get(c.limbs), dtype=np.uint32)


def same_cipher(tc, jc):
    assert np.array_equal(tpoly.to_numpy(tc.limbs), jlimbs(jc))
    assert (tc.bound, tc.noise, tc.zero_lanes, len(tc)) == (
        jc.bound, jc.noise, jc.zero_lanes, len(jc))


def padded_eq(got: bytes, want: bytes) -> bool:
    n = max(len(got), len(want))
    return got.ljust(n, b"\0") == want.ljust(n, b"\0")


@pytest.fixture(scope="module")
def small_pair():
    return contexts(SMALL, 7)


class TestKeysAndEncryption:
    @pytest.mark.parametrize("params", [SMALL, (64, 32, 8, 32), (63, 65, 7, 33)])
    def test_key_and_ciphertext_bytes_match(self, params):
        jctx, tctx = contexts(params, 3)
        assert tctx.get_secret_key().to_bytes() == jctx.get_secret_key().to_bytes()
        assert tctx.get_public_key().to_bytes() == jctx.get_public_key().to_bytes()
        vals = [0, 1, 77, 255, 128]
        jc = jctx.encrypt(vals, hm.U8, batch=True)
        tc = tctx.encrypt(vals, ht.U8, batch=True)
        assert tc.to_bytes() == jc.to_bytes()
        assert list(tctx.decrypt(tc)) == vals
        single = tctx.encrypt(200, ht.U16)
        assert single.to_bytes() == jctx.encrypt(200, hm.U16).to_bytes()

    def test_generator_path_round_trips_and_is_seeded(self):
        params = ht.Parameters(*SMALL)
        outs = []
        for _ in range(2):
            ctx = ht.Context(params, encrypt_seed=9, device="cpu")
            sk = ht.keys.generate_secret_key(params, ht.ThreefrySource(1), device="cpu")
            ctx.set_secret_key(sk)
            ctx.set_public_key(ht.keys.generate_public_key(params, sk, ht.ThreefrySource(2)))
            vals = list(range(0, 250, 7))
            c = ctx.encrypt(vals, ht.U8, batch=True)
            assert list(ctx.decrypt(c)) == vals
            outs.append(c.to_bytes())
        assert outs[0] == outs[1]

    def test_unseeded_encrypt_uses_fresh_streams(self, small_pair):
        _, tctx = small_pair
        pk, sk = tctx.get_public_key(), tctx.get_secret_key()
        ctx = ht.Context(ht.Parameters(*SMALL), device="cpu")
        ctx.set_secret_key(sk)
        ctx.set_public_key(pk)
        a, b = ctx.encrypt(5, ht.U8), ctx.encrypt(5, ht.U8)
        assert ctx.decrypt(a) == ctx.decrypt(b) == 5
        assert not torch.equal(a.limbs, b.limbs)


class TestCircuits:
    def test_checked_u8_add_matches(self, small_pair):
        jctx, tctx = small_pair
        xs, ys = [0, 1, 200, 255, 17], [0, 255, 100, 255, 42]
        ja, jb = jctx.encrypt(xs, hm.U8, batch=True), jctx.encrypt(ys, hm.U8, batch=True)
        ta = ht.Ciphered.from_bytes(ja.to_bytes(), ht.U8, device="cpu")
        tb = ht.Ciphered.from_bytes(jb.to_bytes(), ht.U8, device="cpu")
        js = jctx.apply2(jnum.HomomorphicAddition, ja, jb)
        ts = tctx.apply2(tnum.HomomorphicAddition, ta, tb)
        same_cipher(ts, js)
        want = [(x + y) % 256 for x, y in zip(xs, ys)]
        assert list(tctx.decrypt(ts)) == list(jctx.decrypt(js)) == want

    @pytest.mark.parametrize("gate", ["AndGate", "OrGate", "XorGate", "NotGate"])
    def test_gates_match(self, small_pair, gate):
        jctx, tctx = small_pair
        xs, ys = [0b10110011, 0, 255], [0b01110110, 255, 255]
        ja, jb = jctx.encrypt(xs, hm.U8, batch=True), jctx.encrypt(ys, hm.U8, batch=True)
        ta = ht.Ciphered.from_bytes(ja.to_bytes(), ht.U8, device="cpu")
        tb = ht.Ciphered.from_bytes(jb.to_bytes(), ht.U8, device="cpu")
        jop, top = getattr(jnum, "Homomorphic" + gate), getattr(tnum, "Homomorphic" + gate)
        if gate == "NotGate":
            js, ts = jctx.apply1(jop, ja), tctx.apply1(top, ta)
        else:
            js, ts = jctx.apply2(jop, ja, jb), tctx.apply2(top, ta, tb)
        same_cipher(ts, js)
        assert list(tctx.decrypt(ts)) == list(jctx.decrypt(js))

    def test_add_lanes_matches_add(self, small_pair):
        from homomorph_tpu_torch.models import circuits

        _, tctx = small_pair
        a, b = tctx.encrypt(100, ht.U8), tctx.encrypt(99, ht.U8)
        lanes = circuits.add_lanes(a.bits(), b.bits())
        s = ht.Ciphered.new_from_raw(lanes, ht.U8)
        assert tctx.decrypt(s) == 199 == tctx.decrypt(circuits.add(a, b))

    def test_requirements_match(self, small_pair):
        jctx, tctx = small_pair
        for width, jd, td in ((8, hm.U8, ht.U8), (16, hm.U16, ht.U16), (32, hm.U32, ht.U32)):
            zero_j = hm.Ciphered.trivial(0, jd)
            zero_t = ht.Ciphered.trivial(0, td, device="cpu")
            for noise in (0, 2, 5, 40):
                zero_j.noise = zero_t.noise = noise
                for name in ("AndGate", "OrGate", "XorGate", "NotGate", "Addition"):
                    jop = getattr(jnum, "Homomorphic" + name)
                    top = getattr(tnum, "Homomorphic" + name)
                    assert top.requirement_for(zero_t, zero_t) == jop.requirement_for(
                        zero_j, zero_j), (width, noise, name)
                    assert top.MIN_D_OVER_DELTA == jop.MIN_D_OVER_DELTA
        fresh = ht.Ciphered.trivial(0, ht.U32, device="cpu")
        fresh.noise = 2
        assert tnum.HomomorphicAddition.requirement_for(fresh, fresh) == 65

    def test_checked_api_rejects_below_requirement(self):
        ctx = ht.Context(ht.Parameters(32, 8, 2, 8), source=ht.ThreefrySource(1), device="cpu")
        ctx.generate_secret_key()
        ctx.generate_public_key()
        a = ctx.encrypt(1, ht.U32)
        with pytest.raises(ht.InvalidParametersError):
            ctx.apply2(tnum.HomomorphicAddition, a, a)


class TestInteropFixtures:
    @pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
    def test_keygen_and_encryption_reproduce_fixture(self, case):
        p = case["params"]
        ctx = ht.Context(
            ht.Parameters(p["d"], p["dp"], p["delta"], p["tau"]),
            source=ht.RecordedSource(bytes.fromhex(case["stream_hex"])),
            device="cpu",
        )
        ctx.generate_secret_key()
        ctx.generate_public_key()
        assert padded_eq(ctx.get_secret_key().to_bytes(), bytes.fromhex(case["secret_key_hex"]))
        for got, want in zip(ctx.get_public_key().to_bytes(), case["public_key_hex"]):
            assert padded_eq(got, bytes.fromhex(want))
        for pt_hex, ct_hexes in zip(case["plaintexts_hex"], case["ciphertexts_hex"]):
            pt = bytes.fromhex(pt_hex)
            c = ctx.encrypt(pt, ht.BytesDescriptor(len(pt)))
            limbs = tpoly.to_numpy(c.limbs)
            for i, want in enumerate(ct_hexes):
                assert padded_eq(tpoly.limbs_to_bytes(limbs[i]), bytes.fromhex(want))
            assert ctx.decrypt(c) == pt

    @pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
    def test_fixture_keys_decrypt_fixture_ciphertexts(self, case):
        p = case["params"]
        sk = ht.SecretKey.from_bytes(bytes.fromhex(case["secret_key_hex"]), device="cpu")
        pk = ht.PublicKey.from_bytes(
            [bytes.fromhex(h) for h in case["public_key_hex"]], device="cpu")
        assert sk.degree == p["d"] and pk.tau == p["tau"]
        for pt_hex, ct_hexes in zip(case["plaintexts_hex"], case["ciphertexts_hex"]):
            rows = [tpoly.limbs_from_bytes(bytes.fromhex(h)) for h in ct_hexes]
            limbs = np.zeros((len(rows), max(r.size for r in rows)), dtype=np.uint32)
            for i, r in enumerate(rows):
                limbs[i, : r.size] = r
            c = ht.Ciphered.new_from_raw(
                tpoly.from_numpy(limbs, "cpu"), ht.BytesDescriptor(len(rows) // 8),
                bound=p["d"] + p["dp"], noise=2,
            )
            assert c.decipher(sk) == bytes.fromhex(pt_hex)


class TestStateMovesBetweenPackages:
    def test_keys_from_numpy_round_trip(self, small_pair):
        jctx, _ = small_pair
        jsk, jpk = jctx.get_secret_key(), jctx.get_public_key()
        sk, pk = ht.keys.keys_from_numpy(
            np.asarray(jsk._host), np.asarray(jpk._host), device="cpu")
        assert sk.to_bytes() == jsk.to_bytes()
        assert pk.to_bytes() == jpk.to_bytes()
        assert sk == ht.SecretKey.from_bytes(jsk.to_bytes(), device="cpu")
        assert pk == ht.PublicKey.from_bytes(jpk.to_bytes(), device="cpu")
        assert np.array_equal(tpoly.to_numpy(sk.decrypt_mask(9)),
                              np.asarray(jsk.decrypt_mask(9)))

    def test_wire_bytes_both_ways(self, small_pair):
        jctx, tctx = small_pair
        jc = jctx.encrypt([3, 250], hm.U8, batch=True)
        tc = ht.Ciphered.from_bytes(jc.to_bytes(), ht.U8, device="cpu")
        same_cipher(tc, jc)
        assert list(tctx.decrypt(tc)) == [3, 250]
        tc2 = tctx.encrypt([9, 8, 7], ht.U8, batch=True)
        jc2 = hm.Ciphered.from_bytes(tc2.to_bytes(), hm.U8)
        same_cipher(tc2, jc2)
        assert list(jctx.decrypt(jc2)) == [9, 8, 7]
        # a version-1 buffer (no noise field) loads as fresh in both
        v1 = bytearray(jc.to_bytes())
        v1[4:8] = (1).to_bytes(4, "little")
        del v1[24:28]
        assert ht.Ciphered.from_bytes(bytes(v1), ht.U8, device="cpu").noise == 2
        with pytest.raises(ht.DeserializeError):
            ht.Ciphered.from_bytes(b"\0" * 32, ht.U8, device="cpu")

    def test_lanes_and_densify(self, small_pair):
        _, tctx = small_pair
        c = tctx.encrypt(0b101, ht.U8)
        dense = ht.Ciphered(c.limbs[:5], c.bound, ht.U8, zero_lanes=3)
        assert len(dense) == 8 and dense.densify().limbs.shape[0] == 8
        assert dense[7].limbs.abs().sum() == 0
        assert tctx.decrypt(dense) == 0b101
        lo, hi = c.split_at(3)
        assert len(lo) == 3 and len(hi) == 5


class TestEntryPoints:
    def test_cuda_is_the_default_device(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device exists")
        with pytest.raises(RuntimeError, match="CUDA"):
            ht.SecretKey.from_bytes(b"\x05", device=None)
        with pytest.raises(RuntimeError, match="CUDA"):
            ht.Ciphered.trivial(1, ht.U8)

    def test_sharding_is_not_ported_yet(self, small_pair):
        # The name is older than the sharding it now checks: sharding= no
        # longer raises, Context takes a grid of places, and a sharded
        # encrypt gives the dense path's bytes for the same key
        from homomorph_tpu_torch.parallel import make_mesh

        cfg = make_mesh(1, 2, ["cpu"] * 2)
        ht.Context(ht.Parameters(*SMALL), sharding=cfg, device="cpu")
        _, tctx = small_pair
        pk = tctx.get_public_key()
        got = ht.Ciphered.cipher([1], pk, ht.U8, batch=True, key=(0, 1), sharding=cfg)
        want = ht.Ciphered.cipher([1], pk, ht.U8, batch=True, key=(0, 1))
        assert got.sharding is not None and got.to_bytes() == want.to_bytes()

    def test_zeroize(self, small_pair):
        _, tctx = small_pair
        sk = ht.SecretKey.from_bytes(tctx.get_secret_key().to_bytes(), device="cpu")
        limbs, w = sk.limbs, sk.decrypt_mask(4)
        sk.zeroize()
        assert not limbs.any() and not w.any()
        with pytest.raises(ht.SecretKeyUnsetError):
            sk.to_bytes()

    @pytest.mark.parametrize("module", ["homomorph_tpu_torch", "homomorph_tpu_torch.context",
                                        "homomorph_tpu_torch.operations"])
    def test_doctests(self, module):
        import importlib

        mod = importlib.import_module(module)
        result = doctest.testmod(mod, optionflags=doctest.IGNORE_EXCEPTION_DETAIL)
        assert result.attempted > 0 and result.failed == 0
