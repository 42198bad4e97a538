"""The Karatsuba route's glue kernels, R1 (split) and R2 (join), through their
torch mirrors on the CPU (``homomorph_tpu_torch.gf2.kernels``).

R1 builds every leaf in one pass from an index map (path digits, summed
``h`` offsets, the real width of each node on the path);
:func:`route_split_plain` follows that map, and is held here against the
level-by-level split (:func:`_split_levels`, the stack of ``_halves``).  R2
joins each level by a formula and fuses the bottom levels by subtree;
:func:`route_join_plain` follows its launches, and is held against
``_join_halves`` and ``_join_pieces`` level by level.  The forced route's
full product is held against the JAX dispatcher
(``homomorph_tpu.gf2.kernels.clmul`` with ``FORCE_KARATSUBA``).  The
kernels themselves are held against the same plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3b).

Products are integers of GF(2)[X]: every comparison is bit for bit
(tolerance 0).  Inputs come from numpy generators with fixed seeds.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homomorph_tpu.gf2 import kernels as jk
from homomorph_tpu_torch.gf2 import kernels as k
from homomorph_tpu_torch.gf2 import poly as gf2

KMINS = (2, 3, 8, 33, 64)
# odd widths, chunk tails narrower than the smaller operand (17 x 200: a
# last piece of 13 limbs), either operand the wider one, the smaller one
# padded at the first split (40 x 41, 64 x 90), widths whose odd halves pad
# x1 onto the neighbouring half's real limbs (10 x 10, 7 x 7)
SHAPES = [(7, 7), (10, 10), (9, 9), (65, 64), (33, 100), (100, 33), (40, 41), (17, 200),
          (3, 17), (64, 90), (64, 160), (129, 130), (5, 384), (130, 1000)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def words(seed, shape):
    return np.random.default_rng(seed).integers(0, 2**32, size=shape, dtype=np.uint32)


def operands(La, Lb, B=3):
    """[B, Ls] and [B, Lg] int32 rows on the CPU, the smaller first."""
    a = gf2.from_numpy(words(La * 1000 + Lb, (B, La)), "cpu")
    b = gf2.from_numpy(words(Lb * 1000 + La, (B, Lb)), "cpu")
    return (a, b) if La <= Lb else (b, a)


def routes():
    """(La, Lb, kmin) of every shape and threshold that takes a level."""
    return [(La, Lb, kmin) for kmin in KMINS for La, Lb in SHAPES
            if k.route_plan(min(La, Lb), max(La, Lb), kmin)]


@pytest.mark.parametrize("La,Lb,kmin", routes())
def test_split_index_map_matches_the_level_stack(La, Lb, kmin):
    small, big = operands(La, Lb)
    steps = k.route_plan(small.shape[1], big.shape[1], kmin)
    want_s, want_g = k._split_levels(small, big, steps)
    got_s, got_g = k.route_split_plain(small, big, steps)
    assert got_s.shape == want_s.shape == k.leaf_rows(small.shape[0], steps)
    assert torch.equal(got_s, want_s) and torch.equal(got_g, want_g)


@pytest.mark.parametrize("La,Lb,kmin", [(10, 10, 2), (7, 7, 2), (40, 41, 2), (17, 200, 4)])
def test_padded_offsets_read_as_zero(La, Lb, kmin):
    """Where a padded limb's summed offset lands on a real limb (of the
    row's other half, or of the next row), the leaf limb is zero: rows of
    all ones make every such limb visible.  The case is real: some leaf
    limb on a path of 0 and 1 digits has a summed offset inside the
    operand's rows but is zero in the level stack."""
    B = 2
    small = torch.full((B, min(La, Lb)), -1, dtype=torch.int32)
    big = torch.full((B, max(La, Lb)), -1, dtype=torch.int32)
    steps = k.route_plan(small.shape[1], big.shape[1], kmin)
    n, h, _ = k._levels(steps)
    want_s, want_g = k._split_levels(small, big, steps)
    got_s, got_g = k.route_split_plain(small, big, steps)
    assert torch.equal(got_s, want_s) and torch.equal(got_g, want_g)
    rows0 = B * max(n, 1)
    hazards = 0
    for leaf in range(want_s.shape[0]):
        v, digits = leaf // rows0, []
        for _ in h:
            digits.append(v % 3)
            v //= 3
        if 2 in digits:
            continue
        for x, want in ((small, want_s), (big, want_g)):
            for u in range(want.shape[1]):
                offset = u + sum(hh for t, hh in zip(digits, h) if t == 1)
                hazards += int(offset < x.numel() and int(want[leaf, u]) == 0)
    assert hazards > 0


@pytest.mark.parametrize("La,Lb,kmin", routes())
def test_join_formulas_match_the_level_joins(La, Lb, kmin):
    """R2's formulas, one launch a level and fused as far as the budget (or
    two levels) allows, against ``_join_halves`` and ``_join_pieces``; the
    leaves' products come from the plain clmul."""
    small, big = operands(La, Lb)
    B = small.shape[0]
    steps = k.route_plan(small.shape[1], big.shape[1], kmin)
    p = k.clmul_plain(*k._split_levels(small, big, steps))
    want = k._join_levels(p, B, steps)
    for fuse in (1, 2, None):
        assert torch.equal(k.route_join_plain(p, B, steps, fuse), want)
    assert torch.equal(want, k.clmul_plain(small, big))


@pytest.mark.parametrize("B,Ls,Lg,h", [(3, 7, 7, 4), (2, 10, 10, 5), (4, 40, 41, 21), (1, 1, 1, 1),
                                       (2, 33, 48, 24)])
def test_one_split_level_formula(B, Ls, Lg, h):
    """``p0[t] ^ p0[t-h] ^ pm[t-h] ^ p2[t-h] ^ p2[t-2h]`` truncated to
    ``Ls + Lg`` equals ``_join_halves`` on random products."""
    p = gf2.from_numpy(words(B * Ls + h, (3 * B, 2 * h)), "cpu")
    want = k._join_halves(p, B, Ls, Lg, h)
    got = k.route_join_plain(p, B, [("split", Ls, Lg, h)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,Ls,Lg,n", [(2, 5, 12, 3), (3, 17, 200, 12), (1, 64, 160, 3),
                                       (2, 4, 9, 3), (1, 3, 3, 1)])
def test_chunk_formula(B, Ls, Lg, n):
    """``piece[t/Ls][t%Ls] ^ piece[t/Ls-1][Ls+t%Ls]`` equals ``_join_pieces``."""
    p = gf2.from_numpy(words(B * Lg + n, (B * n, 2 * Ls)), "cpu")
    assert torch.equal(k.join_pieces_plain(p, B, Ls, Lg, n), k._join_pieces(p, B, Ls, Lg, n))


def test_join_halves_leaves_its_products_alone():
    p = gf2.from_numpy(words(5, (6, 8)), "cpu")
    kept = p.clone()
    k._join_halves(p, 2, 7, 8, 4)
    assert torch.equal(p, kept)


@functools.lru_cache(maxsize=None)
def jax_product(La, Lb):
    a, b = words(La * 1000 + Lb, (3, La)), words(Lb * 1000 + La, (3, Lb))
    saved = jk.FORCE_KARATSUBA
    jk.FORCE_KARATSUBA = True
    try:
        return a, b, np.asarray(jk.clmul(jnp.asarray(a), jnp.asarray(b)))
    finally:
        jk.FORCE_KARATSUBA = saved


@pytest.mark.parametrize("kmin", KMINS)
@pytest.mark.parametrize("La,Lb", [(7, 7), (65, 64), (33, 100), (100, 33), (40, 41), (17, 200),
                                   (64, 90), (129, 130)])
def test_forced_route_matches_jax(monkeypatch, La, Lb, kmin):
    """The forced route on the CPU (route_split -> the plain clmul ->
    route_join, all through the wrappers' plain versions) against the JAX
    dispatcher with ``FORCE_KARATSUBA``, limb for limb."""
    monkeypatch.setenv(k.FORCE_KARATSUBA_ENV, "1")
    monkeypatch.setenv(k.KARATSUBA_MIN_ENV, str(kmin))
    a, b, want = jax_product(La, Lb)
    got = k.clmul(gf2.from_numpy(a, "cpu"), gf2.from_numpy(b, "cpu"))
    assert np.array_equal(gf2.to_numpy(got), want)


@pytest.mark.parametrize("La,Lb,kmin", [(64, 64, 64), (17, 200, 4), (130, 1000, 8)])
def test_cpu_wrappers_compute_the_plain_versions(La, Lb, kmin):
    small, big = operands(La, Lb)
    steps = k.route_plan(small.shape[1], big.shape[1], kmin)
    counts = (k.route_split.launches, k.route_join.launches)
    leaves = k.route_split(small, big, steps)
    want = k._split_levels(small, big, steps)
    assert all(torch.equal(x, y) for x, y in zip(leaves, want))
    p = k.clmul_plain(*leaves)
    assert torch.equal(k.route_join(p, small.shape[0], steps), k._join_levels(p, small.shape[0], steps))
    assert (k.route_split.launches, k.route_join.launches) == counts  # CPU calls do not count


def test_wrappers_refuse_what_the_kernels_do_not_take():
    small, big = operands(100, 130)
    steps = k.route_plan(100, 130, 33)
    with pytest.raises(TypeError):
        k.route_split(small.to(torch.int64), big, steps)
    with pytest.raises(ValueError):
        k.route_split(big, small, steps)  # not the plan's widths
    with pytest.raises(ValueError):
        k.route_split(torch.zeros((100, 3), dtype=torch.int32).T, big, steps)
    with pytest.raises(ValueError):
        k.route_split(small, big, [])
    with pytest.raises(ValueError):
        k.route_split(small.to("meta"), big.to("meta"), steps)
    p = k.clmul_plain(*k.route_split(small, big, steps))
    with pytest.raises(TypeError):
        k.route_join(p.to(torch.int64), 3, steps)
    with pytest.raises(ValueError):
        k.route_join(p[:-1], 3, steps)
    with pytest.raises(ValueError):
        k.route_join(p.T.contiguous().T, 3, steps)


@pytest.mark.parametrize("La,Lb,kmin", [(1536, 8192, 64), (8192, 98304, 64), (64, 64, 64),
                                        (257, 256, 2), (17, 200, 4), (48, 1000, 16)])
def test_join_launch_plan(La, Lb, kmin):
    """The fused launch takes the bottom levels, as many as a block's shared
    memory holds (each at most ``ROUTE_SMEM_WORDS``), then one launch a
    level up to the first split, then the chunk step; ``fuse=1`` gives one
    launch a level."""
    steps = k.route_plan(La, Lb, kmin)
    n, h, lo = k._levels(steps)
    kk = len(h)
    for fuse in (None, 1, 2):
        plan = k.join_launches(steps, fuse)
        top, bottom = plan[0]
        m = bottom - top + 1
        assert bottom == kk - 1 and (fuse is None or m <= fuse)
        if m > 1:
            assert 3 ** m * 2 * h[-1] + 3 ** (m - 1) * lo[-1] <= k.ROUTE_SMEM_WORDS
        assert plan[1:] == [(i, i) for i in range(top - 1, -1, -1)] + ([(-1, -1)] if n else [])
    assert len(k.join_launches(steps, 1)) == kk + (1 if n else 0)


def test_the_u16_and_u32_routes_fuse_their_bottom_levels():
    """At the paths' leaves (32 and 48 limbs) the fused launch takes 4 levels,
    so the u16 product's busiest route is 3 launches of R2, not 7."""
    assert k.join_launches(k.route_plan(1536, 8192, 64)) == [(1, 4), (0, 0), (-1, -1)]
    assert k.join_launches(k.route_plan(8192, 98304, 64)) == [(4, 7)] + [(i, i) for i in (3, 2, 1, 0)] + [(-1, -1)]


def test_plan_words_follow_the_kernel_layout():
    """B, Ls, Lg, n (0 without a chunk), k, then each level's h and Ls+Lg,
    as ``read_route`` in ``csrc/route.cu`` reads them."""
    steps = k.route_plan(17, 200, 4)
    words = list(k._plan_words(5, steps))
    n, h, lo = k._levels(steps)
    assert words == [5, 17, 200, 12, len(h), *h, *lo]
    assert lo[0] == 34 and all(lo[i] == 2 * h[i - 1] for i in range(1, len(h)))
    assert list(k._plan_words(2, k.route_plan(40, 41, 2)))[3] == 0


def test_meta_tensors_stay_unrouted(monkeypatch):
    """The compiled pipelines' metadata pass runs the dispatcher on meta
    tensors: it calls neither wrapper of the route."""
    monkeypatch.setenv(k.KARATSUBA_MIN_ENV, "2")
    called = []
    monkeypatch.setattr(k, "route_split", lambda *a: called.append(a))
    out = k.clmul(torch.empty((4, 70), dtype=torch.int32, device="meta"),
                  torch.empty((4, 90), dtype=torch.int32, device="meta"))
    assert out.shape == (4, 160) and out.device.type == "meta" and not called
