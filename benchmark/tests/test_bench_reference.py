"""The plain reference against itself and, at a tiny size, against the port."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import reference as ref


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_pack_and_unpack():
    bits = ref.random_bits(_gen(1), (3, 70), "cpu")
    limbs = ref.pack(bits)
    assert limbs.dtype == torch.int32 and limbs.shape == (3, 3)
    assert torch.equal(ref.unpack(limbs, 70), bits)
    assert int(ref.pack(torch.tensor([0] * 31 + [1], dtype=torch.uint8))[0]) == -(1 << 31)


def test_gf2_mul_against_schoolbook():
    a = ref.random_bits(_gen(2), (4, 50), "cpu")
    b = ref.random_bits(_gen(3), (4, 33), "cpu")
    got = ref.gf2_mul(a, b)
    for r in range(4):
        ai = sum(int(x) << i for i, x in enumerate(a[r]))
        bi = sum(int(x) << i for i, x in enumerate(b[r]))
        p = 0
        for i in range(33):
            if bi >> i & 1:
                p ^= ai << i
        assert [p >> i & 1 for i in range(82)] == got[r].tolist()


@pytest.mark.parametrize("d, n", [(5, 64), (37, 700), (128, 2048), (200, 4096)])
def test_mask_by_series_equals_the_definition(d, n):
    keys = ref.Keys(d, 16, 1, 8, _gen(d), "cpu")
    assert torch.equal(ref.mask(keys.s, n), ref.mask_by_recurrence(keys.s, n))


def test_mask_equals_the_ports_recurrence():
    from homomorph_tpu_torch.gf2 import poly

    keys = ref.Keys(128, 128, 1, 128, _gen(9), "cpu")
    n_limbs = 40
    want = poly.decrypt_mask_words(keys.secret_limbs().numpy().view(np.uint32), 128, n_limbs)
    got = ref.pack(ref.mask(keys.s, 32 * n_limbs), n_limbs).numpy().view(np.uint32)
    assert np.array_equal(got, want)


def _port_context(keys, params):
    import homomorph_tpu_torch as ht

    ctx = ht.Context(ht.Parameters(*params), device="cpu")
    ctx.set_secret_key(ht.SecretKey(keys.secret_limbs().numpy().view(np.uint32), device="cpu"))
    ctx.set_public_key(ht.PublicKey(keys.public_limbs().numpy().view(np.uint32), device="cpu"))
    return ctx


def test_reference_keys_hold_the_scheme():
    keys = ref.Keys(128, 128, 1, 128, _gen(4), "cpu")
    assert int(keys.s[0]) == 1 and int(keys.s[128]) == 1
    # every T_i is of exact degree d + dp, and reduces mod S to X R_i, whose constant term is 0
    assert bool((keys.t[:, 256] == 1).all())
    w = ref.pack(ref.mask(keys.s, 32 * 9), 9)
    assert not ref.decrypt(keys.public_limbs(), w).any()


def test_reference_and_port_agree_both_ways():
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.models import HomomorphicAddition

    keys = ref.Keys(128, 128, 1, 128, _gen(5), "cpu")
    ctx = _port_context(keys, (128, 128, 1, 128))
    vals = torch.tensor([0, 1, 0xFFFFFFFF, 123456789], dtype=torch.int64)
    limbs = ref.encrypt(keys, ref.value_bits(vals, 32).reshape(-1), _gen(6)).reshape(4, 32, 9)
    c = ht.Ciphered(limbs, 256, ht.U32)
    assert [int(v) for v in ctx.decrypt(c)] == vals.tolist()  # the port decrypts the reference's
    s = ctx.apply2(HomomorphicAddition, c, c)
    dec = ref.Decryptor(keys.s)
    want = ref.value_bits((vals + vals) & 0xFFFFFFFF, 32)
    assert torch.equal(dec(s.limbs), want)  # the reference decrypts the port's
    mine = ctx.encrypt([7, 9], ht.U32, batch=True)
    assert torch.equal(dec(mine.limbs), ref.value_bits(torch.tensor([7, 9]), 32))


def test_plaintext_ops_wrap():
    from benchmark.harness import load_module

    mul = load_module("ops", "HomomorphicMultiplication").expected
    add = load_module("ops", "HomomorphicAddition").expected
    a = torch.tensor([0xFFFFFFFF, 0x12345678, 3], dtype=torch.int64)
    b = torch.tensor([0xFFFFFFFF, 0x9ABCDEF0, 5], dtype=torch.int64)
    assert mul(a, b, 32).tolist() == [(x * y) % 2**32 for x, y in zip(a.tolist(), b.tolist())]
    assert add(a, b, 32).tolist() == [(x + y) % 2**32 for x, y in zip(a.tolist(), b.tolist())]
    assert mul(a & 0xFF, b & 0xFF, 8).tolist() == [((x & 0xFF) * (y & 0xFF)) % 256
                                                   for x, y in zip(a.tolist(), b.tolist())]


def test_the_pools_table_decrypts_to_its_plaintexts():
    from types import SimpleNamespace

    from benchmark import harness, operands

    g = _gen(11)
    keys = ref.Keys(128, 128, 1, 128, g, "cpu")
    run = SimpleNamespace(traffic={"op": "HomomorphicAddition", "pairs": 3, "pool": 5, "basis": 6},
                          config={"parameters": {"d": 128, "dp": 128}}, gen=g,
                          dev=torch.device("cpu"), bench=harness.BENCH, keys=keys)
    pool = operands.Pool(run, 32)
    dec = ref.Decryptor(keys.s)
    for side in ("a", "b"):
        ct = pool.ciphertexts(run, side)
        assert ct.shape == (5, 3, 32, 9)
        assert torch.equal(dec(ct), pool.bits(side))
        assert bool((ct != 0).any(-1).all())  # two distinct basis values, never a zero ciphertext
    values, i1, i2 = pool._basis["a"]
    assert bool((i1 != i2).all()) and torch.equal(pool.a.reshape(-1), values[i1] ^ values[i2])


def test_a_table_in_gib_sets_the_pool():
    from benchmark import operands

    pair_bytes = 2 * 32 * 81 * 4  # a u32 pair at d + dp = 2560
    n = operands.pool_batches({"pairs": 8, "table_gib": 1}, {"d": 2432, "dp": 128}, 32)
    assert n * 8 * pair_bytes <= 2**30 < (n + 1) * 8 * pair_bytes
    assert operands.pool_batches({"pairs": 8, "pool": 3, "table_gib": 1}, {}, 32) == 3
