"""The Karatsuba route's glue kernels, R1 (split) and R2 (join), through their
torch mirrors on the CPU (``homomorph_tpu_torch.gf2.kernels``).

The leaves are node-major: the leaves under any node are one run of rows
(``test_every_subtree_is_one_run_of_leaves``).  R1 stages each node of a
depth from its row by an index map (path digits, summed ``h`` offsets, the
real width of each node on the path) and splits below it;
:func:`route_split_plain` follows that design at every depth, and is held
here against the level-by-level split (:func:`_split_levels`, the stack of
``_halves``).  R2 ascends from the leaves' products to a depth in one
launch, tile by tile, each level's product built as its children come;
:func:`route_join_plain` follows its launches in that order, and is held
against ``_join_halves`` and ``_join_pieces`` level by level.  The launch
plans (:func:`split_plan`, :func:`join_launches`) are held to their rules.
The forced route's full product is held against the JAX dispatcher
(``homomorph_tpu.gf2.kernels.clmul`` with ``FORCE_KARATSUBA``).  The
kernels themselves are held against the same plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 3b).

Products are integers of GF(2)[X]: every comparison is bit for bit
(tolerance 0).  Inputs come from numpy generators with fixed seeds.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homomorph_tpu.gf2 import kernels as jk
from homomorph_tpu_torch.gf2 import kernels as k
from homomorph_tpu_torch.gf2 import poly as gf2
from homomorph_tpu_torch.utils.profiling import counters

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
    """Every leaf staged straight from its row (depth ``k``: the one-shot
    index map) equals the level-by-level split, node-major."""
    small, big = operands(La, Lb)
    steps = k.route_plan(small.shape[1], big.shape[1], kmin)
    want_s, want_g = k._split_levels(small, big, steps)
    got_s, got_g = k.route_split_plain(small, big, steps, depth=len(k._levels(steps)[1]))
    assert got_s.shape == want_s.shape == k.leaf_rows(small.shape[0], steps)
    assert torch.equal(got_s, want_s) and torch.equal(got_g, want_g)


@pytest.mark.parametrize("La,Lb,kmin", routes())
def test_staged_nodes_match_the_level_stack(La, Lb, kmin):
    """R1's design at every staging depth (nodes staged from their rows by
    their terms, then split level by level), and at the launch's own depth
    (:func:`split_plan`), equals the level-by-level split."""
    small, big = operands(La, Lb)
    steps = k.route_plan(small.shape[1], big.shape[1], kmin)
    want_s, want_g = k._split_levels(small, big, steps)
    for depth in [None, *range(len(k._levels(steps)[1]))]:
        got_s, got_g = k.route_split_plain(small, big, steps, depth)
        assert torch.equal(got_s, want_s) and torch.equal(got_g, want_g), depth


@pytest.mark.parametrize("La,Lb,kmin", [(10, 10, 2), (40, 41, 2), (17, 200, 4), (130, 1000, 8),
                                        (64, 160, 33), (100, 33, 3)])
def test_every_subtree_is_one_run_of_leaves(La, Lb, kmin):
    """Node-major leaves: split each node of every depth alone (its own
    levels below it) and its leaves are rows ``node * 3^(k-D)`` onward of
    the whole split, one run."""
    small, big = operands(La, Lb)
    steps = k.route_plan(small.shape[1], big.shape[1], kmin)
    chunk = int(steps[0][0] == "chunk")
    kk = len(steps) - chunk
    leaves = k._split_levels(small, big, steps)
    for depth in range(kk + 1):
        nodes = k._split_levels(small, big, steps[: chunk + depth])
        run = 3 ** (kk - depth)
        for nd in range(nodes[0].shape[0]):
            below = k._split_levels(nodes[0][nd : nd + 1], nodes[1][nd : nd + 1],
                                    steps[chunk + depth :])
            for got, whole in zip(below, leaves):
                assert torch.equal(got, whole[nd * run : (nd + 1) * run]), (depth, nd)


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
    for depth in (None, len(h)):
        got_s, got_g = k.route_split_plain(small, big, steps, depth)
        assert torch.equal(got_s, want_s) and torch.equal(got_g, want_g)
    hazards = 0
    for leaf in range(want_s.shape[0]):
        v = leaf % 3 ** len(h)
        digits = [(v // 3 ** (len(h) - 1 - i)) % 3 for i in range(len(h))]
        if 2 in digits:
            continue
        for x, want in ((small, want_s), (big, want_g)):
            for u in range(want.shape[1]):
                offset = u + sum(hh for t, hh in zip(digits, h) if t == 1)
                hazards += int(offset < x.numel() and int(want[leaf, u]) == 0)
    assert hazards > 0


@pytest.mark.parametrize("La,Lb,kmin", routes())
def test_join_formulas_match_the_level_joins(La, Lb, kmin):
    """R2's launches by their formulas, the ascent in its streaming order
    (tiles, then each level's product as its children come), for the
    launch plan and every other plan the kernel takes, against
    ``_join_halves`` and ``_join_pieces``; the leaves' products come from
    the plain clmul."""
    small, big = operands(La, Lb)
    B = small.shape[0]
    steps = k.route_plan(small.shape[1], big.shape[1], kmin)
    p = k.clmul_plain(*k._split_levels(small, big, steps))
    want = k._join_levels(p, B, steps)
    assert torch.equal(k.route_join_plain(p, B, steps), want)
    for plan in k.join_plans(B, steps):
        assert torch.equal(k.route_join_plain(p, B, steps, plan), want), plan
    assert torch.equal(want, k.clmul_plain(small, big))


@pytest.mark.parametrize("B,Ls,Lg,h", [(3, 7, 7, 4), (2, 10, 10, 5), (4, 40, 41, 21), (1, 1, 1, 1),
                                       (2, 33, 48, 24)])
def test_one_split_level_formula(B, Ls, Lg, h):
    """``p0[t] ^ p0[t-h] ^ pm[t-h] ^ p2[t-h] ^ p2[t-2h]`` truncated to
    ``Ls + Lg`` equals ``_join_halves`` on random products, as the level
    launch and as the ascent's one tile."""
    p = gf2.from_numpy(words(B * Ls + h, (3 * B, 2 * h)), "cpu")
    want = k._join_halves(p, B, Ls, Lg, h)
    steps = [("split", Ls, Lg, h)]
    for plan in (None, [(0, 0, 0)], [(0, 1, 1)], [(0, 1, 2)]):
        assert torch.equal(k.route_join_plain(p, B, steps, plan), want)


@pytest.mark.parametrize("B,Ls,Lg,h", [(3, 7, 7, 4), (2, 10, 10, 5), (1, 1, 1, 1), (2, 33, 48, 24)])
def test_children_add_up_to_the_join(B, Ls, Lg, h):
    """The ascent's accumulation: child 0 starts the product, children 1
    and 2 add their terms, in order: the same limbs as the formula."""
    p = gf2.from_numpy(words(B * Lg + h, (3 * B, 2 * h)), "cpu").view(B, 3, 2 * h)
    acc = None
    for t in range(3):
        acc = k._accumulate(acc, p[:, t], t, h, Ls + Lg)
    assert torch.equal(acc, k._join_terms(p[:, 0], p[:, 1], p[:, 2], h, Ls + Lg))


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
    counts = (counters["R1"], counters["R2"])
    leaves = k.route_split(small, big, steps)
    want = k._split_levels(small, big, steps)
    assert all(torch.equal(x, y) for x, y in zip(leaves, want))
    p = k.clmul_plain(*leaves)
    assert torch.equal(k.route_join(p, small.shape[0], steps), k._join_levels(p, small.shape[0], steps))
    assert (counters["R1"], counters["R2"]) == counts  # CPU calls do not count


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


# (B, La, Lb, kmin): the paths' routes (u16 busiest, u32 widest at d = 2432
# and 5888, u64 widest, the smallest u32 routes) and small ones
PLAN_ROUTES = [(512, 1536, 8192, 64), (8, 8192, 98304, 64), (8, 16384, 262144, 64),
               (1, 131072, 3145728, 64), (8, 384, 512, 64), (8192, 81, 81, 64), (1, 849, 849, 64),
               (3, 64, 64, 64), (2, 257, 256, 2), (3, 17, 200, 4), (3, 48, 1000, 16),
               (4, 1000, 1000, 100)]


@pytest.mark.parametrize("B,La,Lb,kmin", PLAN_ROUTES)
def test_join_launch_plan(B, La, Lb, kmin):
    """The ascent first: its tile the deepest of at most ``JOIN_TILE_WORDS``
    (below ``top``), ``top`` the least depth whose ascent fits
    ``JOIN_SMEM_WORDS`` and gives ``MIN_NODES`` blocks (or a block one
    tile); then one launch a level above ``top``, then the chunk step."""
    steps = k.route_plan(La, Lb, kmin)
    n, h, lo = k._levels(steps)
    kk, w2, rows0 = len(h), 2 * h[-1], B * max(n, 1)
    tile0 = max([1] + [m for m in range(1, kk + 1) if 3 ** m * w2 <= k.JOIN_TILE_WORDS])
    plan = k.join_launches(B, steps)
    top, tile, group = plan[0]
    assert tile == min(tile0, kk - top) >= 1
    assert group == k.ascent_group(h, rows0, top, tile) >= 1
    assert group == 1 or (top + tile == kk and rows0 * 3 ** top // group >= k.MIN_NODES
                          and group * 3 ** tile * w2 <= k.JOIN_TILE_WORDS)
    assert k.ascent_layout(h, lo, top, tile, group)["words"] <= k.JOIN_SMEM_WORDS
    assert rows0 * 3 ** top >= k.MIN_NODES or top >= kk - tile0
    for smaller in range(top):
        m = min(tile0, kk - smaller)
        g = k.ascent_group(h, rows0, smaller, m)
        assert (k.ascent_layout(h, lo, smaller, m, g)["words"] > k.JOIN_SMEM_WORDS
                or (rows0 * 3 ** smaller < k.MIN_NODES and smaller < kk - tile0))
    assert plan[1:] == ([(i, 0, 0) for i in range(top - 1, -1, -1)]
                        + ([(-1, 0, 0)] if n else []))


@pytest.mark.parametrize("B,La,Lb,kmin", PLAN_ROUTES)
def test_split_launch_plan(B, La, Lb, kmin):
    """R1's depth: the least whose layout fits ``SPLIT_SMEM_WORDS``, deepened
    to ``MIN_NODES`` nodes (or the leaves); rows grouped at depth 0 within
    the budget and ``MAX_GROUP``."""
    steps = k.route_plan(La, Lb, kmin)
    n, h, _ = k._levels(steps)
    kk, rows0 = len(h), B * max(n, 1)
    depth, group = k.split_plan(B, steps)
    assert k.split_layout(h, depth, group)["words"] <= k.SPLIT_SMEM_WORDS
    assert rows0 * 3 ** depth >= k.MIN_NODES or depth == kk
    if depth and rows0 * 3 ** (depth - 1) >= k.MIN_NODES:
        assert k.split_layout(h, depth - 1, 1)["words"] > k.SPLIT_SMEM_WORDS
    assert 1 <= group <= k.MAX_GROUP and (depth == 0 or group == 1)


def test_split_buffers_hold_each_level():
    """The two buffers take turns: the staged nodes and every other level's
    children in the first, the rest in the second, each the most it holds."""
    h = [768, 384, 192, 96, 48]  # the u16 product's busiest route
    # staged 2*768, level 0: 3 children of 2*384 (second), level 1: 9 of
    # 2*192 (first), level 2: 27 of 2*96 (second), level 3: 81 of 2*48 (first)
    assert k.split_buffers(h, 0, 1) == (81 * 96, 27 * 192)
    assert k.split_buffers(h, 0, 2) == (2 * 81 * 96, 2 * 27 * 192)
    assert k.split_buffers(h, 3, 1) == (2 * 96, 3 * 96)
    assert k.split_buffers(h, 5, 1) == (0, 0)


def regions_fit(regions, words):
    """Each ``(at, length, align)`` region lies in ``words`` and starts on
    a multiple of ``align`` (what ``csrc/route.cu`` checks of a layout);
    no two overlap."""
    for at, length, align in regions:
        assert at >= 0 and at % align == 0 and at + length <= words, (at, length, align, words)
    spans = sorted((at, at + length) for at, length, _ in regions if length)
    assert all(a_end <= b_start for (_, a_end), (b_start, _) in zip(spans, spans[1:])), spans


@pytest.mark.parametrize("B,La,Lb,kmin", PLAN_ROUTES)
def test_split_layout_holds_every_level_and_table(B, La, Lb, kmin):
    """R1's layout at every depth (and the plan's group): each level's input
    holds its parents, 16-byte aligned, and the row starts and terms fit;
    a level's input and its output (the next level's input) never
    overlap."""
    steps = k.route_plan(La, Lb, kmin)
    _, h, _ = k._levels(steps)
    depth0, group0 = k.split_plan(B, steps)
    for depth in range(len(h) + 1):
        group = group0 if depth == 0 else 1
        lay = k.split_layout(h, depth, group)
        assert len(lay["inputs"]) == len(h) - depth
        assert lay["cap"] >= (2 ** depth if depth else group)
        tables = [(lay["base"], 2 * group, 2), (lay["off"], lay["cap"], 1),
                  (lay["lim"], lay["cap"], 1)]
        levels = [(at, group * 3 ** i * 2 * h[depth + i], 4) for i, at in enumerate(lay["inputs"])]
        for pair in zip(levels, levels[1:]):
            regions_fit(tables + list(pair), lay["words"])
        regions_fit(tables + levels[:1], lay["words"])


@pytest.mark.parametrize("B,La,Lb,kmin", PLAN_ROUTES)
def test_ascent_layout_holds_the_ring_the_tile_and_each_level(B, La, Lb, kmin):
    """R2's layout for every ascent of every plan: the ring's slots hold a
    tile of each node of the block, a tile level's output (past the ring)
    holds its products and never overlaps the level it reads, and each
    level's product above the tile has its own region."""
    steps = k.route_plan(La, Lb, kmin)
    n, h, lo = k._levels(steps)
    kk = len(h)
    for plan in k.join_plans(B, steps):
        top, tile, group = plan[0]
        if not tile:
            continue
        bottom = kk - tile
        lay = k.ascent_layout(h, lo, top, tile, group)
        assert lay["slot"] >= group * 3 ** tile * 2 * h[-1] and lay["slot"] % 4 == 0
        ring = [(s * lay["slot"], lay["slot"], 4) for s in range(k.RING)]
        accs = [(at, lo[top + i], 4) for i, at in enumerate(lay["acc"])]
        assert len(lay["lvl"]) == tile and len(accs) == bottom - top
        outs = [(at, group * 3 ** (j - bottom) * lo[j], 4)
                for j, at in zip(range(bottom, kk), lay["lvl"]) if j != top]
        assert all(at == -1 for j, at in zip(range(bottom, kk), lay["lvl"]) if j == top)
        for pair in zip(outs, outs[1:]):
            regions_fit(ring + accs + list(pair), lay["words"])
        regions_fit(ring + accs + outs[:1], lay["words"])


def test_split_plan_refuses_a_route_past_18_levels():
    """The staging terms take ``2^depth`` words twice: at ``w = 32`` a route
    of 18 split levels still fits a depth, one of 19 none, and the wrapper
    raises rather than launch."""
    assert k.split_plan(1, k.route_plan(32 * 2**18, 32 * 2**18, 64)) == (13, 1)
    steps = k.route_plan(32 * 2**19, 32 * 2**19, 64)
    assert len(steps) == 19
    with pytest.raises(ValueError, match="19 split levels"):
        k.split_plan(1, steps)


def test_launch_words_follow_the_kernel_layout():
    """``hm_route_split``'s and ``hm_route_join``'s layout words, in the
    order ``csrc/route.cu`` reads them."""
    steps = k.route_plan(8192, 98304, 64)
    _, h, lo = k._levels(steps)
    lay = k.split_layout(h, 2, 1)
    assert list(k._split_words(h, 2, 1)) == [2, 1, lay["base"], lay["off"], lay["lim"],
                                            lay["cap"], lay["words"], *lay["inputs"]]
    assert len(lay["inputs"]) == len(h) - 2 and lay["cap"] == 4
    asc = k.ascent_layout(h, lo, 2, 5, 1)
    assert list(k._launch_words(h, lo, (2, 5, 1))) == [2, 5, 1, asc["slot"], asc["words"],
                                                       *asc["lvl"], *asc["acc"]]
    assert len(k._launch_words(h, lo, (2, 5, 1))) == 5 + len(h) - 2
    assert list(k._launch_words(h, lo, (1, 0, 0))) == [1, 0]
    assert list(k._launch_words(h, lo, (-1, 0, 0))) == [-1, 0]


def test_the_u16_and_u32_routes_fuse_their_bottom_levels():
    """The ascent joins every level below ``top`` in one launch: the u16
    product's busiest route (3,072 pieces) is the ascent to the pieces in
    tiles of 4 levels and the chunk step; the u32 product's widest (96
    pieces, fewer than ``MIN_NODES``, and an ascent to depth 1 past
    ``JOIN_SMEM_WORDS``) ascends to depth 2 in tiles of 5 levels, then levels
    1 and 0 and the chunk step."""
    assert k.join_launches(512, k.route_plan(1536, 8192, 64)) == [(0, 4, 1), (-1, 0, 0)]
    assert k.join_launches(8, k.route_plan(8192, 98304, 64)) == [
        (2, 5, 1), (1, 0, 0), (0, 0, 0), (-1, 0, 0)]
    # a route of one level takes many nodes a block: 64 x 64 at 32,264 rows
    assert k.join_launches(32264, k.route_plan(64, 64, 64)) == [(0, 1, 85)]
    assert k.split_plan(512, k.route_plan(1536, 8192, 64)) == (0, 1)
    assert k.split_plan(8, k.route_plan(8192, 98304, 64)) == (2, 1)


def test_r2_moves_the_functions_bytes_and_the_chunk_steps_at_the_u16_route():
    """``chip_smoke.py``'s byte count of R2's launches at the u16 product's
    busiest route: the leaf products read and the product written once
    (306.6 MB), plus the chunk step's pieces written and read (75.5 MB); no
    level in between passes through device memory."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    steps = k.route_plan(1536, 8192, 64)
    _, function, launches = smoke.route_bytes(512, 1536, 8192, steps)
    chunk = 2 * 4 * 3072 * 2 * 1536
    assert function == 4 * (746496 * 96 + 512 * 9728) and round(function / 1e6, 1) == 306.6
    assert launches == function + chunk and round(chunk / 1e6, 1) == 75.5


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
