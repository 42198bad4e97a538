"""The decrypt mask's plan (``homomorph_tpu_torch.gf2.mask_kernel.mask_plan``)
and the plain versions of its fused kernels on the CPU: M2's
(``newton_step_plain``) against a square and a product, M3's
(``series_small_plain``) against the route (M1 and K1), the plan against
``precisions``, and the mask through every plan (``series_mask``, which
``decrypt_mask`` calls with the default plan) against the JAX package's
device scan (``homomorph_tpu.gf2.poly.decrypt_mask``).

On the CPU each wrapper runs its plain version; the kernels are held
against them on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 10).  Every comparison is bit-exact (integer GF(2) values, tolerance
0).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homomorph_tpu import native as jnative
from homomorph_tpu.gf2 import poly as jpoly
from homomorph_tpu_torch import native
from homomorph_tpu_torch.gf2 import kernels as tk
from homomorph_tpu_torch.gf2 import mask_kernel as mk
from homomorph_tpu_torch.gf2 import poly as tpoly
from homomorph_tpu_torch.keys import SecretKey

DEGREES = (1, 4, 31, 32, 33, 63, 64, 65, 128)
CLASSES = (1, 2, 9, 65, 256)
#: plans forcing every step onto one kind (M3 as far as its widest step,
#: then M2), and the measured default, for a class ``(d, n_limbs)``
PLANS = {"all-M3": lambda d, L: mk.mask_plan(d, L, mk.SMALL_MAX_LIMBS),
         "all-M2": lambda d, L: mk.mask_plan(d, L, 0),
         "all-route": lambda d, L: [("route", k) for _, k in mk.mask_plan(d, L)],
         "default": mk.mask_plan}


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
    return np.frombuffer(s_int.to_bytes(4 * tpoly.limbs_for(d), "little"),
                         dtype="<u4").astype(np.uint32)


def T(arr):
    return tpoly.from_numpy(np.asarray(arr, dtype=np.uint32), "cpu")


def to_int(limbs):
    return int.from_bytes(np.asarray(tpoly.to_numpy(limbs), dtype="<u4").tobytes(), "little")


def words(seed, n):
    return np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint32)


def clmul_int(a, b):
    p = 0
    while b:
        low = b & -b
        p ^= a << (low.bit_length() - 1)
        b ^= low
    return p


def mask(s, d, n_limbs, plan):
    """The class's mask by ``plan`` (a name of :data:`PLANS`) through
    ``series_mask``; ``decrypt_mask`` where ``32 n_limbs <= d`` leaves no
    step to plan."""
    s = s if isinstance(s, torch.Tensor) else T(s)
    if 32 * n_limbs <= d:
        assert PLANS[plan](d, n_limbs) == []
        return tpoly.decrypt_mask(s, d, n_limbs)
    return mk.series_mask(mk.reversed_key(s, d), d, n_limbs, PLANS[plan](d, n_limbs))


@functools.lru_cache(maxsize=None)
def jax_mask(d, n_limbs, s0):
    s = key(d, 100 + d, s0)
    return s, np.asarray(jpoly.decrypt_mask(jnp.asarray(s), d, n_limbs))


@pytest.mark.parametrize("Li,Ls,k", [
    (1, 1, 1), (1, 1, 2), (1, 3, 64), (2, 5, 33), (3, 9, 190), (4, 9, 250), (9, 2, 575),
    (40, 3, 2500), (64, 5, 4096), (33, 70, 2000),
])
def test_newton_step_plain_is_a_truncated_square_and_product(Li, Ls, k):
    """Ragged ``k`` (not a multiple of 32), ``Lo < Ls`` and ``Lo >> Ls``;
    the series' bits above ``k / 2`` set (they square past ``k``)."""
    inv, sstar = T(words(Li, Li)), T(words(Ls + 7, Ls))
    got = mk.newton_step_plain(inv, sstar, k)
    Lo = -(-k // 32)
    sq = mk.square_plain(inv.view(1, -1), k)
    want = tpoly.clmul_chunked(sstar.view(1, -1), sq)[0, :Lo]
    assert got.shape == (Lo,)
    assert to_int(got) == to_int(want) & ((1 << k) - 1)
    i = to_int(inv)
    square = sum(1 << (2 * j) for j in range(32 * Li) if i >> j & 1)
    assert to_int(got) == clmul_int(to_int(sstar), square) & ((1 << k) - 1)


@pytest.mark.parametrize("d,n_bits", [(1, 1), (4, 7), (33, 64), (65, 1000), (128, 4097),
                                      (300, 20000)])
def test_series_small_plain_equals_the_route(d, n_bits):
    """M3's plain version equals ``series_inverse`` on the route (M1
    and the clmul dispatcher at every step) and on the default plan."""
    sstar = mk.reversed_key(T(key(d, 600 + d)), d)
    got = mk.series_small_plain(sstar, n_bits)
    route = [("route", k) for k in mk.precisions(n_bits)]
    assert torch.equal(got, mk.series_inverse(sstar, n_bits, route))
    assert torch.equal(got, mk.series_inverse(sstar, n_bits))
    assert got.shape == (-(-n_bits // 32),) and to_int(got) < 1 << n_bits


@pytest.mark.parametrize("d,n_limbs", [(1, 1), (128, 9), (1024, 65), (1024, 8192), (2432, 98304),
                                       (5888, 262144), (13440, 3145728), (70000, 4096),
                                       (64, 2), (64, 1), (4096, 100)])
@pytest.mark.parametrize("cap", [mk.SMALL_CAP, 0, 1, 4096, 16])
def test_mask_plan_covers_the_precisions(d, n_limbs, cap):
    """Every precision once, in order; M3 steps first and within the cap
    and M3's widest step, M2 after them; all route where ``S*`` passes the
    kernels' tables, and nowhere else; no step where ``32 n_limbs <= d``."""
    plan = mk.mask_plan(d, n_limbs, cap)
    n_bits = 32 * n_limbs - d
    assert [k for _, k in plan] == (mk.precisions(n_bits) if n_bits > 0 else [])
    kinds = [kind for kind, _ in plan]
    assert kinds == sorted(kinds, key=("M3", "M2", "route").index)
    Ls = tpoly.limbs_for(d)
    for kind, k in plan:
        Lo = -(-k // 32)
        if Ls > mk.TABLE_MAX_LIMBS:
            assert kind == "route"
        elif kind == "M3":
            assert Lo <= min(cap, mk.SMALL_MAX_LIMBS)
        else:
            assert kind == "M2" and Lo > min(cap, mk.SMALL_MAX_LIMBS)


def test_the_small_classes_are_one_m3_step_list():
    """The 9- and 65-limb classes of the paths run wholly in M3 under the
    default plan (one launch on the card); the u64 class goes on to M2."""
    for d, n_limbs in ((128, 9), (1024, 65)):
        assert {kind for kind, _ in mk.mask_plan(d, n_limbs)} == {"M3"}
    assert [kind for kind, _ in mk.mask_plan(13440, 3145728)][-1] != "M3"


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("s0", (1, 0))
@pytest.mark.parametrize("n_limbs", CLASSES)
@pytest.mark.parametrize("d", DEGREES)
def test_decrypt_mask_through_the_plan_equals_the_jax_scan(d, n_limbs, s0, plan):
    """At the classes of ``test_torch_mask.py::test_route_equals_the_jax_scan``
    (``d % 32 == 0`` at 32, 64, 128; ``32 n_limbs <= d`` below), with
    ``S(0) = 0`` and 1, and the plan forced to one kind of step."""
    s, want = jax_mask(d, n_limbs, s0)
    got = mask(s, d, n_limbs, plan)
    assert np.array_equal(tpoly.to_numpy(got), want)


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_wide_class_through_the_plan_equals_both_native_engines(plan):
    """A class wide enough for M2 steps under the default plan (2,048 limbs
    at d = 300), against the port's and the JAX package's native engines."""
    d, L = 300, 2048
    s = key(d, 17)
    assert "M2" in {kind for kind, _ in mk.mask_plan(d, L)}
    got = tpoly.to_numpy(mask(s, d, L, plan))
    assert np.array_equal(got, native.decrypt_mask(s, d, L))
    assert np.array_equal(got, jnative.decrypt_mask(s, d, L))


def test_a_route_step_after_m2_gives_the_same_mask(monkeypatch):
    """Mixed plans: M3, then M2, then the route (a plan ``mask_plan`` does
    not give, which ``series_inverse`` runs all the same); the route's
    products cut by Karatsuba levels, as on the card, run over the plain
    version."""
    d, L = 200, 1024
    s = key(d, 23)
    plan = mk.mask_plan(d, L, 8)
    plan[-2:] = [("route", k) for _, k in plan[-2:]]
    assert [kind for kind, _ in plan].count("M2") >= 2
    monkeypatch.setenv(tk.FORCE_KARATSUBA_ENV, "1")
    monkeypatch.setenv(tk.KARATSUBA_MIN_ENV, "4")
    assert np.array_equal(tpoly.to_numpy(mk.series_mask(mk.reversed_key(T(s), d), d, L, plan)),
                          native.decrypt_mask(s, d, L))


def test_assembled_mask_equals_the_series_shifted():
    """M3's assembly (``series_small_plain`` with ``assemble``) equals the
    series shifted by ``d``, masked by ``S(0)``, with bit 0 set."""
    for d, n_limbs, s0 in ((32, 9, 1), (33, 9, 0), (100, 40, 1), (5, 2, 1)):
        sstar = mk.reversed_key(T(key(d, d, s0)), d)
        n_bits = 32 * n_limbs - d
        inv = to_int(mk.series_small_plain(sstar, n_bits))
        w = to_int(mk.series_small_plain(sstar, n_bits, (d, n_limbs)))
        assert w == 1 ^ ((inv << d) * s0 & ((1 << 32 * n_limbs) - 1))


def test_wrappers_take_the_plain_versions_on_the_cpu_and_refuse_bad_input():
    inv, sstar = T(words(1, 4)), T(words(2, 3))
    counts = mk.launch_counts()
    assert set(counts) == {"M1", "K1", "M2", "M3"}
    assert torch.equal(mk.newton_step(inv, sstar, 250), mk.newton_step_plain(inv, sstar, 250))
    assert torch.equal(mk.series_small(sstar, 100), mk.series_small_plain(sstar, 100))
    assert mk.launch_counts() == counts  # a CPU call launches nothing
    with pytest.raises(ValueError):
        mk.newton_step(inv, sstar, 257)  # more than twice the series' limbs
    with pytest.raises(ValueError):
        mk.newton_step(inv.view(2, 2), sstar, 100)
    with pytest.raises(TypeError):
        mk.newton_step(inv, sstar.to(torch.int64), 100)
    with pytest.raises(ValueError):
        mk.newton_step(inv, sstar, 0)
    with pytest.raises(ValueError):
        mk.series_small(sstar, 0)
    with pytest.raises(ValueError):
        mk.series_small(sstar, 100, assemble=(40, 5))  # 32 * 5 - 40 != 100
    with pytest.raises(ValueError):
        mk.newton_step(torch.zeros(2, dtype=torch.int32, device="meta"),
                       torch.zeros(2, dtype=torch.int32, device="meta"), 10)


def test_series_inverse_refuses_a_plan_it_cannot_run():
    sstar = mk.reversed_key(T(key(40, 3)), 40)
    good = mk.newton_plan(500, sstar.shape[0], 4)
    assert [kind for kind, _ in good] == ["M3"] * 7 + ["M2"] * 2  # Lo 1, 1, 1, 1, 1, 2, 4, 8, 16
    with pytest.raises(ValueError):
        mk.series_inverse(sstar, 500, good[:-1])  # a precision missing
    with pytest.raises(ValueError):
        mk.series_inverse(sstar, 500, [("M2", 2)] + good[1:])  # M3 after M2
    with pytest.raises(ValueError):
        mk.series_inverse(sstar, 500, good[:-1] + [("M4", 500)])
    with pytest.raises(ValueError):
        mk.series_mask(sstar, 40, 17, [("M3", k) for k in mk.precisions(500)])  # 504 bits
    assert torch.equal(mk.series_mask(sstar, 40, 17, PLANS["all-route"](40, 17)),
                       mk.series_mask(sstar, 40, 17))


def test_secret_key_masks_through_the_plan_and_zeroize():
    """A key's masks take the default plan; ``zeroize`` scrubs ``S*`` and
    every cached mask, and the plan's route keeps no other tensor."""
    d = 300
    sk = SecretKey(key(d, 29), device="cpu")
    masks = {L: sk.decrypt_mask(L) for L in (9, 65, 2048)}
    for L, w in masks.items():
        assert torch.equal(w, mask(sk.limbs, d, L, "all-route"))
    assert set(vars(sk)) >= {"_sstar", "_mask_cache"}
    tensors = [v for v in vars(sk).values() if isinstance(v, torch.Tensor)]
    assert all(t is sk._limbs or t is sk._sstar for t in tensors)
    sstar = sk._sstar
    sk.zeroize()
    assert not bool(sstar.any()) and all(not bool(w.any()) for w in masks.values())
