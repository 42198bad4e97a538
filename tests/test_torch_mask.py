"""The decrypt mask as a power series (``homomorph_tpu_torch.gf2.mask_kernel``
and ``gf2.poly.decrypt_mask``) on the CPU, against the JAX package's device
scan (``homomorph_tpu.gf2.poly.decrypt_mask``), its secret key's bytes, the
native engines and ``X^i mod S`` on Python integers; and M1's plain version
(``square_plain``) against squaring on Python integers.

On the CPU the route runs on the plain versions of M1 and K1; the kernels
themselves are held against them on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 10).  Every comparison is bit-exact (integer GF(2)
values, tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homomorph_tpu import native as jnative
from homomorph_tpu.gf2 import poly as jpoly
from homomorph_tpu.keys import SecretKey as JSecretKey
from homomorph_tpu_torch import device as tdevice
from homomorph_tpu_torch import native
from homomorph_tpu_torch.gf2 import kernels as tk
from homomorph_tpu_torch.gf2 import mask_kernel as mk
from homomorph_tpu_torch.gf2 import poly as tpoly
from homomorph_tpu_torch.keys import SecretKey
from homomorph_tpu_torch.utils.profiling import counters

DEGREES = (1, 4, 31, 32, 33, 63, 64, 65, 128)
CLASSES = (1, 2, 9, 65, 256)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Chains of small torch ops: one intra-op thread, so that the test
    runner's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def key(d, seed, s0=1):
    """Limbs of a random S of exact degree ``d`` with constant term ``s0``."""
    s_int = int.from_bytes(np.random.default_rng(seed).bytes(d // 8 + 1), "little")
    s_int = (s_int & ((1 << d) - 1) & ~1) | (1 << d) | s0
    return to_limbs(s_int, tpoly.limbs_for(d))


def to_limbs(v, n_limbs):
    return np.frombuffer(v.to_bytes(4 * n_limbs, "little"), dtype="<u4").astype(np.uint32)


def to_int(limbs):
    return int.from_bytes(np.asarray(limbs, dtype="<u4").tobytes(), "little")


def route(s, d, n_limbs):
    return tpoly.to_numpy(tpoly.decrypt_mask(tpoly.from_numpy(s, "cpu"), d, n_limbs))


def x_pow_mod(e, s_int, d):
    """``X^e mod S`` by square-and-multiply on Python integers."""
    def mulmod(a, b):
        p = 0
        while b:
            low = b & -b
            p ^= a << (low.bit_length() - 1)
            b ^= low
        while p.bit_length() > d:
            p ^= s_int << (p.bit_length() - 1 - d)
        return p

    r, base = 1, 2
    while e:
        if e & 1:
            r = mulmod(r, base)
        base = mulmod(base, base)
        e >>= 1
    return r


@pytest.mark.parametrize("n_limbs", CLASSES)
@pytest.mark.parametrize("d", DEGREES)
def test_route_equals_the_jax_scan(d, n_limbs):
    """At degrees across limb boundaries and classes below, at and above
    ``d`` (``32 * n_limbs <= d`` gives ``monomial(0)``)."""
    s = key(d, 100 + d)
    want = np.asarray(jpoly.decrypt_mask(jnp.asarray(s), d, n_limbs))
    assert np.array_equal(route(s, d, n_limbs), want)


@pytest.mark.parametrize("d", DEGREES)
def test_secret_key_mask_equals_the_jax_keys_bytes(d):
    s = key(d, 200 + d)
    sk, jsk = SecretKey(s, device="cpu"), JSecretKey(s)
    for n_limbs in (2, 65):
        got = tpoly.limbs_to_bytes(sk.decrypt_mask(n_limbs))
        assert got == jpoly.limbs_to_bytes(np.asarray(jsk.decrypt_mask(n_limbs)))


def test_route_equals_native_where_the_jax_package_goes_native():
    """A class of 2^15 limbs at d = 2432, where the JAX package's key takes
    its native engine: the route equals both engines and the JAX key."""
    d, L = 2432, 1 << 15
    s = key(d, 7)
    jsk = JSecretKey(s)
    assert L >= jsk.NATIVE_MASK_MIN_LIMBS
    got = tpoly.to_numpy(SecretKey(s, device="cpu").decrypt_mask(L))
    assert np.array_equal(got, jnative.decrypt_mask(s, d, L))
    assert np.array_equal(got, native.decrypt_mask(s, d, L))
    assert np.array_equal(got, np.asarray(jsk.decrypt_mask(L)))


@pytest.mark.parametrize("d,n_limbs", [(5, 4), (64, 9), (130, 65), (33, 1)])
def test_s0_zero_key_gives_monomial_zero(d, n_limbs):
    s = key(d, 300 + d, s0=0)
    want = tpoly.to_numpy(tpoly.monomial(0, n_limbs, device="cpu"))
    assert np.array_equal(route(s, d, n_limbs), want)
    assert np.array_equal(want, tpoly.decrypt_mask_words(s, d, n_limbs))


@pytest.mark.parametrize("d", (3, 32, 97, 300))
def test_mask_of_a_class_is_the_prefix_of_the_wider_class(d):
    s = key(d, 400 + d)
    for n in (4, 16, 64):
        assert np.array_equal(route(s, d, 2 * n)[:n], route(s, d, n))


@pytest.mark.parametrize("d,n_limbs", [(31, 100), (200, 512), (1000, 4096)])
def test_last_bits_equal_x_pow_i_mod_s(d, n_limbs):
    """Chosen positions near the end of the class against ``(X^i mod S)(0)``
    by square-and-multiply on Python integers."""
    s = key(d, 500 + d)
    w = to_int(route(s, d, n_limbs))
    s_int = to_int(s)
    n = 32 * n_limbs
    for i in (n - 1, n - 2, n - 33, n - 64, n // 2 + 1, d, d + 1):
        assert (w >> i) & 1 == x_pow_mod(i, s_int, d) & 1, i


@pytest.mark.parametrize(
    "B,L,n_bits", [(1, 1, None), (1, 1, 1), (3, 5, None), (2, 7, 33), (4, 9, 200), (1, 33, 2048)]
)
def test_square_plain_equals_python_squaring(B, L, n_bits):
    x = np.random.default_rng(L).integers(0, 2**32, size=(B, L), dtype=np.uint32)
    got = tpoly.to_numpy(mk.square_plain(tpoly.from_numpy(x, "cpu"), n_bits))
    keep = 64 * L if n_bits is None else n_bits
    assert got.shape == (B, -(-keep // 32))
    for row, out in zip(x, got):
        v = to_int(row)
        sq = sum(1 << (2 * j) for j in range(32 * L) if v >> j & 1)
        assert to_int(out) == sq & ((1 << keep) - 1)


def test_square_wrapper_takes_the_plain_version_on_the_cpu_and_refuses_bad_input():
    x = tpoly.from_numpy(np.arange(1, 7, dtype=np.uint32).reshape(2, 3), "cpu")
    before = counters["M1"]
    assert torch.equal(mk.square(x, 100), mk.square_plain(x, 100))
    assert counters["M1"] == before  # a CPU call launches nothing
    with pytest.raises(ValueError):
        mk.square(x, 193)  # more bits than the whole square
    with pytest.raises(ValueError):
        mk.square(x, 0)
    with pytest.raises(TypeError):
        mk.square(x.to(torch.int64))
    with pytest.raises(ValueError):
        mk.square(x[0])
    with pytest.raises(ValueError):
        mk.square(x.t())
    with pytest.raises(ValueError):
        mk.square(torch.zeros((1, 2), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("d,n_bits", [(1, 1), (4, 7), (33, 64), (65, 1000), (128, 4097)])
def test_series_inverse_times_the_reversed_key_is_one(d, n_bits):
    s = tpoly.from_numpy(key(d, 600 + d), "cpu")
    sstar = mk.reversed_key(s, d)
    assert to_int(tpoly.to_numpy(sstar)) == int(bin(to_int(tpoly.to_numpy(s)))[2:][::-1], 2)
    inv = mk.series_inverse(sstar, n_bits)
    assert inv.shape == (-(-n_bits // 32),)
    v = to_int(tpoly.to_numpy(inv))
    assert v < 1 << n_bits
    prod = to_int(tpoly.to_numpy(tpoly.clmul(sstar, inv)))
    assert prod & ((1 << n_bits) - 1) == 1


@pytest.mark.parametrize("n_bits", [1, 2, 3, 31, 32, 33, 1000, 100_649_856])
def test_precisions_end_at_the_target_and_at_most_double(n_bits):
    steps = mk.precisions(n_bits)
    assert steps == sorted(steps) and (not steps or steps[-1] == n_bits)
    assert all(b <= 2 * a for a, b in zip([1] + steps, steps))
    assert len(steps) == (n_bits - 1).bit_length()


@pytest.mark.parametrize("d", (5, 64, 130))
def test_trailing_zero_limb_key_gives_the_same_mask(d):
    """A key read from the reference's 64-bit-word bytes carries a trailing
    zero limb when ``limbs_for(d)`` is odd; the mask is the same."""
    s = key(d, 700 + d)
    words = -(-(d + 1) // 64)
    wide = SecretKey.from_bytes(to_int(s).to_bytes(8 * words, "little"), device="cpu")
    assert wide.limbs.shape[-1] == 2 * words > tpoly.limbs_for(d)
    narrow = SecretKey(s, device="cpu")
    assert torch.equal(wide.decrypt_mask(65), narrow.decrypt_mask(65))
    assert torch.equal(tpoly.decrypt_mask(wide.limbs, d, 9), tpoly.decrypt_mask(narrow.limbs, d, 9))


def test_the_forced_karatsuba_route_gives_the_same_mask(monkeypatch):
    """The route's chunk and split steps on one row with a very unbalanced
    operand (as the u64 class's [1, 3,145,728] x [1, 421] product on the
    card), run over the plain version."""
    d, L = 300, 2048
    s = key(d, 9)
    want = native.decrypt_mask(s, d, L)
    monkeypatch.setenv(tk.FORCE_KARATSUBA_ENV, "1")
    monkeypatch.setenv(tk.KARATSUBA_MIN_ENV, "4")
    assert tk.route_plan(10, 2048, 4)[0][0] == "chunk"
    assert np.array_equal(route(s, d, L), want)
    steps = tk.route_plan(421, 3_145_728, 64)
    assert [k for k, *_ in steps] == ["chunk", "split", "split", "split"]
    assert steps[0][3] == -(-3_145_728 // 421)


def test_zeroize_scrubs_every_tensor_the_route_keeps():
    sk = SecretKey(key(70, 11), device="cpu")
    masks = [sk.decrypt_mask(n) for n in (3, 9)]
    sstar, limbs = sk._sstar, sk.limbs
    assert sstar is not None and bool(sstar.any()) and all(bool(w.any()) for w in masks)
    sk.zeroize()
    assert not bool(sstar.any()) and not bool(limbs.any())
    assert all(not bool(w.any()) for w in masks)
    assert sk._sstar is None and not sk._mask_cache


def test_decrypt_mask_raises_under_capture(monkeypatch):
    sk = SecretKey(key(40, 12), device="cpu")
    sk.decrypt_mask(4)
    monkeypatch.setattr(tdevice, "capturing", lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        sk.decrypt_mask(9)
    with pytest.raises(RuntimeError, match="capture"):
        sk.decrypt_mask(4)  # a cached class too
    assert 9 not in sk._mask_cache
