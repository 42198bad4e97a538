"""The port's CUDA kernels (K1, R1, R2, K2, K3, X1, T1, M1, M2, M3, C1, C2, C3, D1)
against their plain torch versions (and K1 and K2 against the torch mirrors of their
designs), on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
False.  The file imports neither jax nor the JAX package and uses no
fixture of ``tests/conftest.py`` (which imports jax), so on a machine with a
card and no jax it runs as

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Parity is bit-exact (integer GF(2) values, tolerance 0).
"""

import ctypes
import importlib.util
import os

import numpy as np
import pytest
import torch

from homomorph_tpu_torch import prng
from homomorph_tpu_torch import rng as hrng
from homomorph_tpu_torch.gf2 import encrypt_kernel as enc
from homomorph_tpu_torch.gf2 import kernels as k
from homomorph_tpu_torch.gf2 import poly as gf2
from homomorph_tpu_torch.utils.profiling import counters

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def on_card(shape, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    arr = np.random.default_rng(seed).integers(0, 2**32, size=shape, dtype=np.uint32)
    return gf2.from_numpy(arr, "cuda")


@pytest.mark.parametrize(
    "B,La,Lb", [(1, 1, 1), (128, 5, 5), (4096, 9, 9), (257, 9, 256), (7, 96, 9), (3, 40, 25)]
)
def test_clmul_kernel_matches_plain(B, La, Lb):
    a, b = on_card((B, La), 1), on_card((B, Lb), 2)
    before = counters["K1"]
    got = k.clmul_flat(a, b)
    torch.cuda.synchronize()
    assert counters["K1"] == before + 1
    assert torch.equal(got, k.clmul_plain(a, b))


@pytest.mark.parametrize(
    "B,La,Lb",
    [(3, 1, 1), (5, 1, 9), (128, 5, 5), (65, 9, 9), (33, 9, 256), (9, 64, 64), (5, 96, 192),
     (2, 3, 600), (2, 130, 500)],
)
def test_clmul_kernel_matches_the_comb_mirror(B, La, Lb):
    """The redesign's shapes (and more than one output tile or window of
    the smaller operand) against the comb's torch mirror and the sweep."""
    a, b = on_card((B, La), 21), on_card((B, Lb), 22)
    got = k.clmul_flat(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, k.clmul_comb_plain(a, b))
    assert torch.equal(got, k.clmul_plain(a, b))


def square_counts():
    return counters["K1"], counters["K1.square"], counters["K1.square.tiled"]


def moved_since(before):
    return tuple(n - m for n, m in zip(square_counts(), before))


@pytest.mark.parametrize("L", range(1, 64))
def test_clmul_square_path_matches_plain_and_its_mirror(L):
    """Every square width a leaf or a direct product can have below the
    route: clmul_flat (the square path wherever K1 takes it, counted as
    ``K1.square``, and as ``K1.square.tiled`` too where its lanes own
    several columns) and the square mapping launched by name, over two
    blocks of rows and a partial third, against the plain sweep and the
    square path's torch mirror; all-ones rows too."""
    B = 2 * k.square_layout(L)[0] + 3
    a, b = on_card((B, L), 60 + L), on_card((B, L), 160 + L)
    a[0], b[0] = -1, -1
    before = square_counts()
    got = k.clmul_flat(a, b)
    torch.cuda.synchronize()
    columns = k.square_columns(L, L)
    assert moved_since(before) == (1, int(columns > 0), int(columns > 1))
    want = k.clmul_plain(a, b)
    assert torch.equal(got, want)
    assert torch.equal(k.clmul_mapping(a, b, True), want)
    assert torch.equal(k.clmul_square_plain(a, b), want)


@pytest.mark.parametrize("K", k.SQUARE_KS)
@pytest.mark.parametrize("L", [1, 5, 16, 32, 41, 48, 63, 128, 1022])
def test_clmul_square_path_at_each_k(L, K):
    """Each ``k`` the kernel has, named through ``hm_clmul_mapping``, over
    two blocks of rows and a partial third, against the plain sweep and
    the mirror at the same ``k``."""
    B = 2 * k.square_layout(L, K)[0] + 3
    a, b = on_card((B, L), 10 * L + K), on_card((B, L), 10 * L + K + 5)
    a[0], b[0] = -1, -1
    got = k.clmul_mapping(a, b, True, K)
    torch.cuda.synchronize()
    want = k.clmul_plain(a, b)
    assert torch.equal(got, want)
    assert torch.equal(k.clmul_square_plain(a, b, K), want)


def test_the_kernels_table_of_k_is_the_mirrors():
    """``hm_clmul_square`` gives, at every square width, the ``k`` of the
    mirror's copy of ``SQUARE_COLUMNS``, and 0 (the comb) off the square."""
    on_card((1,), 0)
    assert [k.square_columns(L, L) for L in range(1, 1023)] == [
        k.square_layout(L)[4] for L in range(1, 1023)]
    assert k.square_columns(1023, 1023) == k.square_columns(9, 256) == k.square_columns(48, 64) == 0


@pytest.mark.parametrize("B,L", [(1259712, 32), (384912, 48), (49152, 41)])
def test_clmul_square_path_at_the_u32_products_widest_leaf_launches(B, L):
    """The u32 product's (d = 2432) widest K1 launches at each leaf width,
    held in full: the square path at the table's ``k`` against the comb of
    unbalanced products and the plain sweep, and in chunks of rows against
    the square path's mirror."""
    a, b = on_card((B, L), 7 * L), on_card((B, L), 7 * L + 1)
    before = square_counts()
    got = k.clmul_flat(a, b)
    torch.cuda.synchronize()
    assert k.square_path(L, L)
    assert moved_since(before) == (1, 1, int(k.square_columns(L, L) > 1))
    assert torch.equal(got, k.clmul_plain(a, b))
    assert torch.equal(got, k.clmul_mapping(a, b, False))
    for r0 in range(0, B, 65536):
        part = slice(r0, r0 + 65536)
        assert torch.equal(got[part], k.clmul_square_plain(a[part], b[part]))


@pytest.mark.parametrize("B,La,Lb", [(4, 9, 256), (5, 48, 64), (6, 5, 9), (3, 96, 192), (7, 2, 1)])
def test_unbalanced_products_stay_on_the_comb(B, La, Lb):
    a, b = on_card((B, La), La), on_card((B, Lb), Lb)
    before = square_counts()
    got = k.clmul_flat(a, b)
    torch.cuda.synchronize()
    assert moved_since(before) == (1, 0, 0)
    assert not k.square_path(La, Lb)
    assert torch.equal(got, k.clmul_mapping(a, b, False))
    assert torch.equal(got, k.clmul_plain(a, b))
    with pytest.raises(RuntimeError, match="cudaError"):
        k.clmul_mapping(a, b, True)  # the square mapping takes La == Lb only


def test_the_u32_product_takes_the_square_path_in_every_product():
    """The checked u32 product at d = 2432 on 16 pairs as a CUDA graph, as
    the benchmark's ``mul_graph`` replays it: its 85 routed products each
    count one ``K1.square`` (every leaf is square) and, where the leaves'
    ``k`` is above 1 (all of them: 32-48 limbs), one ``K1.square.tiled``;
    the graph holds 419 work nodes as before the square path, and the
    products decrypt right."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.experiments.common import CHECK_SEED, context
    from homomorph_tpu_torch.models import HomomorphicMultiplication
    from homomorph_tpu_torch.models.compiled import compile_op2

    on_card((1,), 0)
    ctx = context((2432, 128, 1, 128), CHECK_SEED, "cuda")
    fn = compile_op2(HomomorphicMultiplication, ht.U32, ctx.parameters.pk_degree)
    rng = np.random.default_rng(19)
    xs = [int(v) for v in rng.integers(0, 2**32, size=16, dtype=np.uint64)]
    ys = [int(v) for v in rng.integers(0, 2**32, size=16, dtype=np.uint64)]
    a, b = ctx.encrypt(xs, ht.U32, batch=True), ctx.encrypt(ys, ht.U32, batch=True)
    got = fn(a, b)
    (manifest,) = fn.graphed.manifests
    assert manifest["K1"] == manifest["K1.square"] == manifest["K1.square.tiled"] == 85
    assert fn.graphed.launches == [419]
    before = square_counts()
    got = fn(a, b)
    torch.cuda.synchronize()
    assert moved_since(before) == (85, 85, 85)
    assert [int(v) for v in ctx.decrypt(got)] == [x * y % 2**32 for x, y in zip(xs, ys)]


@pytest.mark.parametrize(
    "B,La,Lb,kmin",
    [(64, 64, 64, 64), (9, 130, 129, 33), (2, 257, 256, 2), (4, 1000, 1000, 100),
     (5, 100, 400, 50), (3, 48, 1000, 16), (7, 400, 100, 64)],
)
def test_route_matches_the_direct_launch(monkeypatch, B, La, Lb, kmin):
    """Split levels (odd widths, a threshold of 2) and chunked operands
    (tails narrower than a piece, either operand the wider one): one K1
    launch per product, the same limbs as one direct launch."""
    a, b = on_card((B, La), 31), on_card((B, Lb), 32)
    monkeypatch.setenv(k.KARATSUBA_MIN_ENV, str(kmin))
    before = counters["K1"]
    got = k.clmul(a, b)
    torch.cuda.synchronize()
    assert counters["K1"] == before + 1
    assert k.route_plan(min(La, Lb), max(La, Lb), kmin)
    assert torch.equal(got, k.clmul_flat(a, b))
    assert torch.equal(got, k.clmul_plain(a, b))


ROUTE_SHAPES = [(64, 64, 64, 64), (9, 130, 129, 33), (2, 257, 256, 2), (4, 1000, 1000, 100),
                (5, 100, 400, 50), (3, 48, 1000, 16), (7, 400, 100, 64)]
# the paths' routes at their real rows: the u16 product's busiest, the u32
# product's widest at d = 2432 and at d = 5888, and one whose leaves are 37
# limbs wide (w % 4 != 0: the scalar path, and R2 without bulk copies)
PATH_ROUTES = [(512, 1536, 8192, 64), (8, 8192, 98304, 64), (8, 16384, 262144, 64),
               (4608, 73, 192, 64)]


def check_route_kernels(small, big, B, steps, plans):
    """R1 against the level-by-level split and its design's mirror, once
    launched; R2 through each plan (every plan the kernel takes where its
    ascent fits) against the level-by-level join and the plan's mirror."""
    before = counters["R1"]
    leaf_s, leaf_g = k.route_split(small, big, steps)
    torch.cuda.synchronize()
    assert counters["R1"] == before + 1
    want_s, want_g = k._split_levels(small, big, steps)
    assert torch.equal(leaf_s, want_s) and torch.equal(leaf_g, want_g)
    mirror_s, mirror_g = k.route_split_plain(small, big, steps)
    assert torch.equal(leaf_s, mirror_s) and torch.equal(leaf_g, mirror_g)
    del want_s, want_g, mirror_s, mirror_g
    p = k.clmul_flat(leaf_s, leaf_g)
    del leaf_s, leaf_g
    want = k._join_levels(p.clone(), B, steps)
    _, h, lo = k._levels(steps)
    for plan in plans:
        top, tile, group = plan[0]
        if tile and k.ascent_layout(h, lo, top, tile, group)["words"] > k.JOIN_SMEM_WORDS:
            continue
        before = counters["R2"]
        got = k._route_join(p, B, steps, plan)
        torch.cuda.synchronize()
        assert counters["R2"] == before + len(plan)
        assert torch.equal(got, want), plan
        assert torch.equal(got, k.route_join_plain(p, B, steps, plan)), plan
    return p, want


@pytest.mark.parametrize("B,La,Lb,kmin", ROUTE_SHAPES)
def test_route_kernels_match_plain(B, La, Lb, kmin):
    """R1 against the level-by-level split and its design's mirror; R2,
    through its launch plan and every other plan it takes, against the
    level-by-level join and the plan's mirror; on the card."""
    a, b = on_card((B, La), 41), on_card((B, Lb), 42)
    small, big = (a, b) if La <= Lb else (b, a)
    steps = k.route_plan(small.shape[1], big.shape[1], kmin)
    plans = [k.join_launches(B, steps)] + k.join_plans(B, steps)
    _, want = check_route_kernels(small, big, B, steps, plans)
    assert torch.equal(k.route_join(k.clmul_flat(*k.route_split(small, big, steps)), B, steps), want)
    assert torch.equal(want, k.clmul_plain(a, b))


@pytest.mark.parametrize("B,Ls,Lg,kmin", PATH_ROUTES)
def test_route_kernels_match_plain_at_the_paths_routes(B, Ls, Lg, kmin):
    """The paths' routes at their real rows: R1 and R2 (the launch plan, and
    one launch a level) against the plain versions, limb for limb."""
    small, big = on_card((B, Ls), 53), on_card((B, Lg), 54)
    steps = k.route_plan(Ls, Lg, kmin)
    n, h, _ = k._levels(steps)
    one_a_level = [[(i, 0, 0) for i in range(len(h) - 1, -1, -1)] + ([(-1, 0, 0)] if n else [])]
    check_route_kernels(small, big, B, steps, [k.join_launches(B, steps)] + one_a_level)


@pytest.mark.parametrize("B,Ls,Lg,kmin", [(64, 64, 64, 64), (4, 1000, 1000, 100), (6, 130, 300, 33),
                                          (512, 1536, 8192, 64)])
def test_route_kernels_take_unaligned_rows(B, Ls, Lg, kmin):
    """Operands and products that start 4 bytes past a 16-byte boundary
    (views into a larger buffer): no 16-byte access or bulk copy, the same
    limbs."""
    steps = k.route_plan(Ls, Lg, kmin)
    buf = on_card((B * (Ls + Lg) + 2,), 55)
    small = buf[1 : 1 + B * Ls].view(B, Ls)
    big = buf[1 + B * Ls : 1 + B * (Ls + Lg)].view(B, Lg)
    assert small.data_ptr() % 16 and big.data_ptr() % 16
    leaf_s, leaf_g = k.route_split(small, big, steps)
    want_s, want_g = k._split_levels(small, big, steps)
    torch.cuda.synchronize()
    assert torch.equal(leaf_s, want_s) and torch.equal(leaf_g, want_g)
    p = k.clmul_flat(leaf_s, leaf_g)
    held = torch.empty(p.numel() + 1, dtype=p.dtype, device=p.device)
    shifted = held[1:].view(p.shape)
    shifted.copy_(p)
    assert shifted.data_ptr() % 16
    got = k.route_join(shifted, B, steps)
    torch.cuda.synchronize()
    assert torch.equal(got, k._join_levels(p, B, steps))


def test_route_join_refuses_a_plan_past_its_budget():
    """An ascent whose layout passes the card's shared memory a block is
    refused by the kernel's entry, and the wrapper raises; so is a layout
    whose region passes its own words."""
    B, Ls, Lg = 1, 32768, 32768
    steps = k.route_plan(Ls, Lg, 64)
    _, h, lo = k._levels(steps)
    p = k.clmul_flat(*k.route_split(on_card((B, Ls), 56), on_card((B, Lg), 57), steps))
    # the opt-in limit a block (227 KB on the H100)
    props = torch.cuda.get_device_properties(0)
    optin = getattr(props, "shared_memory_per_block_optin", 227 * 1024)
    assert k.ascent_layout(h, lo, 0, 4, 1)["words"] * 4 > optin
    with pytest.raises(RuntimeError):
        k._route_join(p, B, steps, [(0, 4, 1)])
    plan = k.join_launches(B, steps)
    good = list(k._launch_words(h, lo, plan[0]))
    bad = good[:4] + [good[4] - 4] + good[5:]  # the last region now passes the words
    out = torch.empty((3 ** plan[0][0], lo[plan[0][0]]), dtype=torch.int32, device="cuda")
    err = k._route_kernel("hm_route_join")(p.data_ptr(), out.data_ptr(), k._plan_words(B, steps),
                                           k._words(bad), len(bad),
                                           torch.cuda.current_stream().cuda_stream)
    assert err != 0


@pytest.mark.parametrize("B,La,Lb,kmin", ROUTE_SHAPES)
def test_routed_product_launches_r1_k1_and_r2_only(monkeypatch, B, La, Lb, kmin):
    """A routed product is one R1 launch, one K1 launch and the R2 launches
    of join_launches, and no other device work: the device records of a
    call, each name counted as the most any of three traces holds (a trace
    can lose records), are exactly those kernels."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    a, b = on_card((B, La), 43), on_card((B, Lb), 44)
    monkeypatch.setenv(k.KARATSUBA_MIN_ENV, str(kmin))
    steps = k.route_plan(min(La, Lb), max(La, Lb), kmin)
    J = len(k.join_launches(B, steps))
    k.clmul(a, b)
    torch.cuda.synchronize()
    most = Counter()
    for _ in range(3):
        counts = (counters["R1"], counters["K1"], counters["R2"])
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got = k.clmul(a, b)
            torch.cuda.synchronize()
        assert (counters["R1"] - counts[0], counters["K1"] - counts[1],
                counters["R2"] - counts[2]) == (1, 1, J)
        seen = Counter(ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA)
        most = Counter({name: max(most[name], seen[name]) for name in most.keys() | seen.keys()})
    assert torch.equal(got, k.clmul_plain(a, b))
    if most:  # all three traces can come back without device records
        assert all(("route_" in n) or ("clmul" in n) for n in most), dict(most)
        assert sum(most.values()) == 2 + J, dict(most)


def test_routed_product_replays_in_a_cuda_graph(monkeypatch):
    """R1, K1 and R2 captured in one CUDA graph: each replay on new operands
    copied into the captured inputs equals the eager product, and a replay
    counts no launch."""
    monkeypatch.setenv(k.KARATSUBA_MIN_ENV, "33")
    a, b = on_card((6, 300), 45), on_card((6, 130), 46)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        k.clmul(a, b)  # warm-up: builds and loads the kernels
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = k.clmul(a, b)
    J = len(k.join_launches(6, k.route_plan(130, 300, 33)))
    before = (counters["R1"], counters["K1"], counters["R2"])
    for seed in (47, 48, 49):
        a.copy_(on_card(a.shape, seed))
        b.copy_(on_card(b.shape, seed + 100))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, k.clmul_plain(a, b))
        assert torch.equal(out, k.clmul(a, b))  # eager: counts 1, 1 and J
    after = (counters["R1"], counters["K1"], counters["R2"])
    assert after == (before[0] + 3, before[1] + 3, before[2] + 3 * J)


def test_route_wrappers_raise_on_unsupported_input():
    a, b = on_card((4, 100), 50), on_card((4, 130), 51)
    steps = k.route_plan(100, 130, 33)
    with pytest.raises(TypeError):
        k.route_split(a.to(torch.int64), b, steps)
    with pytest.raises(ValueError):
        k.route_split(on_card((100, 4), 52).T, b, steps)
    with pytest.raises(ValueError):
        k.route_split(a, b.cpu(), steps)
    with pytest.raises(ValueError):
        k.route_split(b, a, steps)  # widths not the plan's
    leaf_s, leaf_g = k.route_split(a, b, steps)
    p = k.clmul_flat(leaf_s, leaf_g)
    with pytest.raises(TypeError):
        k.route_join(p.to(torch.int64), 4, steps)
    with pytest.raises(ValueError):
        k.route_join(p.T.contiguous().T, 4, steps)
    with pytest.raises(ValueError):
        k.route_join(p[:-1], 4, steps)


def test_u16_product_row_routed_on_the_card(monkeypatch):
    """One u16 product row on the card with the route taking levels, equal
    to the CPU's plain path on the same ciphertexts, and decrypted."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.models import circuits

    on_card((1,), 0)
    params = ht.Parameters(420, 16, 1, 16)  # d/delta 420 >= 417, the u16 bound
    ctx = ht.Context(params, source=ht.ThreefrySource(33), device="cuda")
    ctx.generate_secret_key()
    ctx.generate_public_key()
    a, b = ctx.encrypt([54321], ht.U16, batch=True), ctx.encrypt([4321], ht.U16, batch=True)
    monkeypatch.setenv(k.KARATSUBA_MIN_ENV, "16")
    card = circuits.mul_unsigned(a, b)
    cpu = circuits.mul_unsigned(*(ht.Ciphered(c.limbs.cpu(), c.bound, ht.U16) for c in (a, b)))
    assert torch.equal(card.limbs.cpu(), cpu.limbs)
    assert (card.bound, card.noise) == (cpu.bound, cpu.noise)
    assert [int(v) for v in ctx.decrypt(card)] == [(54321 * 4321) % 65536]


def test_clmul_broadcast_on_card():
    q, s = on_card((128, 5), 3), on_card((5,), 4)
    assert torch.equal(k.clmul(q, s), k.clmul_plain(q, s.expand(128, 5).contiguous()))


@pytest.mark.parametrize("tau,Lpk,L", [(1, 2, 2), (33, 9, 9), (128, 9, 9), (256, 65, 65), (128, 9, 12)])
def test_encrypt_kernel_matches_plain(tau, Lpk, L):
    B = 4096
    pk = on_card((tau, Lpk), 5)
    selw = on_card((B, -(-tau // 32)), 6)
    plain = on_card((B,), 7) & 1
    before = counters["K2"]
    got = enc.encrypt_words_table(selw, pk, plain, L)
    torch.cuda.synchronize()
    assert counters["K2"] == before + 1
    assert torch.equal(got, enc.encrypt_plain(selw, enc.pk_planes(enc.pk_columns(pk)), plain, L))


@pytest.mark.parametrize(
    "tau,Lpk,L", [(1, 2, 3), (8, 3, 3), (9, 3, 5), (33, 9, 9), (128, 9, 9), (256, 65, 65),
                  (300, 3, 5), (128, 9, 7)],
)
def test_encrypt_table_kernel_matches_the_mirror(tau, Lpk, L):
    """The redesign's tau (not multiples of the chunk; more than 8 words,
    so more than one pass), L above and below the key's limbs, a row count
    that is not a multiple of a block's rows, every plan the rule gives."""
    B = 4099
    pk = on_card((tau, Lpk), 23)
    selw = on_card((B, -(-tau // 32)), 24)  # bit 31 set in about half the words
    plain = on_card((B,), 25) & 1
    got = enc.encrypt_words_table(selw, pk, plain, L)
    torch.cuda.synchronize()
    assert torch.equal(got, enc.encrypt_tables_plain(selw, pk, plain, L))
    assert torch.equal(got, enc.encrypt_plain(selw, enc.pk_planes(enc.pk_columns(pk)), plain, L))


@pytest.mark.parametrize("tau,Lpk", [(256, 65), (64, 300), (300, 40), (1, 500)])
def test_encrypt_table_kernel_plans_give_the_same_bits(tau, Lpk):
    """Keys whose tables the launcher tiles (10 tiles of 7 limbs, 11 of 28,
    6 of 7 in two passes, 3 of 167 on the H100), against the mirror's
    single tile and pass."""
    pk = on_card((tau, Lpk), 26)
    selw, plain = on_card((3000, -(-tau // 32)), 27), on_card((3000,), 28) & 1
    got = enc.encrypt_words_table(selw, pk, plain, Lpk)
    torch.cuda.synchronize()
    assert torch.equal(got, enc.encrypt_tables_plain(selw, pk, plain, Lpk))


@pytest.mark.parametrize(
    "tau,Lpk,L",
    [(1, 2, 2), (33, 9, 9), (128, 9, 9), (256, 65, 65), (128, 9, 12), (300, 3, 3), (512, 2, 2)],
)
def test_encrypt_mma_kernels_match_plain(tau, Lpk, L):
    B = 4099  # not a multiple of the 64-row tile
    planes = enc.pk_planes(enc.pk_columns(on_card((tau, Lpk), 9)))
    selw = on_card((B, -(-tau // 32)), 10)
    plain = on_card((B,), 11) & 1
    sel = gf2.unpack_bits(selw, tau, dtype=torch.int8)
    want = enc.encrypt_plain(selw, planes, plain, L)
    before = (counters["K3"], counters["X1"])
    k3 = enc.encrypt_words_mma(selw, planes, plain, L)
    x1 = enc.encrypt_sel_mma(sel, planes, plain, L)
    torch.cuda.synchronize()
    assert (counters["K3"], counters["X1"]) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(k3, want)
    assert torch.equal(x1, enc.encrypt_sel_plain(sel, planes, plain, L))
    assert torch.equal(x1, want)


MMA_TAUS = [1, 31, 32, 33, 64, 127, 128, 255, 256, 257, 512]
MMA_BATCHES = [1, 63, 64, 65, 127, 129, 130]


@pytest.mark.parametrize("case", ["below", "equal", "above"])
@pytest.mark.parametrize("tau", MMA_TAUS)
def test_wgmma_kernels_match_plain_and_the_walk(tau, case):
    """K3 and X1 on the plan grid: ragged last row tiles, L below, at and
    above the key's limbs, the slice tails of D = 288 (three tiles of three
    limbs) and D = 2080 (three slices of 22, 22 and 21 limbs), random
    selection bits beyond tau; against the plain versions and the walk."""
    for Lpk in (9, 65):
        L = {"below": Lpk - 4, "equal": Lpk, "above": Lpk + 3}[case]
        planes = enc.pk_planes(enc.pk_columns(on_card((tau, Lpk), 40 + tau)))
        for B in MMA_BATCHES:
            selw = on_card((B, -(-tau // 32)), B)
            plain = on_card((B,), B + 1) & 1
            sel = gf2.unpack_bits(selw, tau, dtype=torch.int8)
            want = enc.encrypt_plain(selw, planes, plain, L)
            k3 = enc.encrypt_words_mma(selw, planes, plain, L)
            x1 = enc.encrypt_sel_mma(sel, planes, plain, L)
            torch.cuda.synchronize()
            assert torch.equal(k3, want), (Lpk, B)
            assert torch.equal(x1, want), (Lpk, B)
            assert torch.equal(enc.encrypt_mma_walk(selw, planes, plain, L), want)


@pytest.mark.parametrize("tau,Lpk,L", [(512, 9, 9), (256, 65, 70), (2000, 3, 3), (7000, 1, 2)])
def test_wgmma_kernels_on_tight_plans(tau, Lpk, L):
    """Plans with several passes over K and several column slices, passed
    to the kernel entry directly (the wrapper always takes the default
    plan), against the plain version: the later passes XOR onto the
    earlier ones."""
    B = 1000
    planes = enc.pk_planes(enc.pk_columns(on_card((tau, Lpk), 50)))
    selw, plain = on_card((B, -(-tau // 32)), 51), on_card((B,), 52) & 1
    want = enc.encrypt_plain(selw, planes, plain, L)
    sel = gf2.unpack_bits(selw, tau, dtype=torch.int8)
    for cap in (enc._mma_smem(enc.MMA_TILE_LIMBS, 64)[0], 40_000, enc.MMA_SMEM_CAP):
        plan = enc.mma_plan(B, tau, planes.shape[0], L, smem_cap=cap)
        for symbol, a, k_arg in (("hm_encrypt_mma_words", selw, selw.shape[1]),
                                 ("hm_encrypt_mma_sel", sel, tau)):
            out = torch.empty((B, L), dtype=torch.int32, device="cuda")
            err = enc._kernel("encrypt_mma", symbol)(
                a.data_ptr(), planes.data_ptr(), plain.data_ptr(), out.data_ptr(), B, k_arg,
                planes.shape[0], L, plan_arg(plan), torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            assert err == 0
            assert torch.equal(out, want), (cap, symbol, plan)


def plan_arg(plan):
    """``mma_plan``'s fields as the kernel entries take them: int64, in order."""
    return (ctypes.c_longlong * len(plan))(*plan)


def test_wgmma_entry_refuses_a_plan_it_was_not_given():
    """The kernel takes the plan as it comes and refuses one whose fields
    disagree with the operands or with each other."""
    planes = enc.pk_planes(enc.pk_columns(on_card((128, 9), 53)))
    selw, plain = on_card((100, 4), 54), on_card((100,), 55) & 1
    out = torch.empty((100, 9), dtype=torch.int32, device="cuda")
    plan = enc.mma_plan(100, 128, 288, 9)
    fn = enc._kernel("encrypt_mma", "hm_encrypt_mma_words")
    stream = torch.cuda.current_stream().cuda_stream
    args = (selw.data_ptr(), planes.data_ptr(), plain.data_ptr(), out.data_ptr(), 100, 4, 288, 9)
    for bad in (dict(smem_bytes=plan.smem_bytes + 16), dict(W=3), dict(Kq=96),
                dict(kc=0), dict(n_slices=plan.n_slices + 1), dict(stage_stride=plan.slice_limbs - 1),
                dict(row_tiles=plan.row_tiles + 1), dict(Lc=8)):
        assert fn(*args, plan_arg(plan._replace(**bad)), stream) != 0, bad
    assert fn(*args, plan_arg(plan), stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, enc.encrypt_plain(selw, planes, plain, 9))


def test_selector_launches_k3_on_the_card(monkeypatch):
    pk = on_card((128, 9), 12)
    selw, plain = on_card((256, 4), 13), on_card((256,), 14) & 1
    monkeypatch.setenv(enc.ENC_IMPL_ENV, "pallas_v1")
    before = (counters["K2"], counters["K3"])
    got = enc.encrypt_bits_fused(selw, pk, plain, 9)
    assert (counters["K2"], counters["K3"]) == (
        before[0], before[1] + 1)
    assert torch.equal(got, enc.encrypt_words_table(selw, pk, plain, 9))


@pytest.mark.parametrize("shape", [(5,), (7, 8), ((1 << 20) + 3, 4)])
def test_threefry_kernel_matches_plain(shape):
    on_card((1,), 0)  # skips without a card
    before = counters["T1"]
    got = prng.random_bits((0x12345678, 0x9ABCDEF0), shape, "cuda")
    torch.cuda.synchronize()
    assert counters["T1"] == before + 1
    assert torch.equal(got, prng.random_bits_plain((0x12345678, 0x9ABCDEF0), shape, "cuda"))


def test_threefry_kernel_gives_the_jax_words():
    on_card((1,), 0)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for seed, words in smoke.JAX_BITS.items():
        got = prng.random_bits(hrng.threefry_key(seed), (8,), "cuda")
        assert [w & 0xFFFFFFFF for w in got.tolist()] == words


def test_wrappers_raise_on_unsupported_input():
    a = on_card((4, 9), 8)
    with pytest.raises(ValueError):
        k.clmul_flat(a.T, a.T)
    with pytest.raises(ValueError):
        k.clmul_flat(a, a.cpu())
    with pytest.raises(TypeError):
        enc.encrypt_words_table(a, a.to(torch.int64), a[:, 0].contiguous(), 9)
    planes = enc.pk_planes(enc.pk_columns(on_card((33, 2), 15)))
    skew = torch.zeros(planes.numel() + 1, dtype=torch.int8, device="cuda")[1:]
    skew = skew.view(planes.shape)  # contiguous but not 16-byte aligned
    selw, plain = on_card((8, 2), 16), on_card((8,), 17) & 1
    with pytest.raises(ValueError, match="aligned"):
        enc.encrypt_words_mma(selw, skew, plain, 2)
    with pytest.raises(ValueError):
        enc.encrypt_sel_mma(gf2.unpack_bits(selw, 33, dtype=torch.int8), planes.cpu(), plain, 2)


@pytest.mark.parametrize("key", [(0, 0), (0, 1234), (0xDEADBEEF, 0x12345678)])
def test_threefry_device_key_matches_plain(key):
    on_card((1,), 0)
    buf = prng.key_words(key).cuda()
    before = counters["T1.dkey"]
    got = prng.random_bits_device_key(buf, (4099, 4))
    torch.cuda.synchronize()
    assert counters["T1.dkey"] == before + 1
    assert torch.equal(got, prng.random_bits_plain(key, (4099, 4), "cuda"))
    assert torch.equal(got, prng.random_bits(key, (4099, 4), "cuda"))


def test_threefry_device_key_under_a_replayed_graph():
    """A captured draw reads the key buffer at each replay: after the
    buffer is rewritten, the replay gives the new key's words."""
    on_card((1,), 0)
    buf = prng.key_words((0, 1)).cuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        prng.random_bits_device_key(buf, (1000, 4))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = prng.random_bits_device_key(buf, (1000, 4))
    for key in ((0, 1), (7, 9), (0xFFFFFFFF, 0x80000000)):
        buf.copy_(prng.key_words(key))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, prng.random_bits_plain(key, (1000, 4), "cuda")), key


def card_context(params, seed):
    import homomorph_tpu_torch as ht

    on_card((1,), 0)
    ctx = ht.Context(params, encrypt_seed=seed, device="cuda")
    ctx.generate_secret_key()
    ctx.generate_public_key()
    return ctx


@pytest.mark.parametrize("op_name,params", [
    ("HomomorphicAddition", (64, 16, 1, 16)),
    ("HomomorphicLessThan", (128, 16, 1, 16)),
    ("HomomorphicMultiplication", (160, 16, 1, 16)),
])
def test_compiled_op2_replays_equal_eager(op_name, params):
    """Each replay of the captured graph gives eager's limbs and metadata,
    for new inputs of the same shape too; one graph for the shape."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch import models
    from homomorph_tpu_torch.models.compiled import compile_op2

    op = getattr(models, op_name)
    ctx = card_context(ht.Parameters(*params), 5)
    fn = compile_op2(op, ht.U8, ctx.parameters.pk_degree)
    rng = np.random.default_rng(6)
    for _ in range(3):
        xs, ys = rng.integers(0, 256, size=64).tolist(), rng.integers(0, 256, size=64).tolist()
        a, b = ctx.encrypt(xs, ht.U8, batch=True), ctx.encrypt(ys, ht.U8, batch=True)
        got, want = fn(a, b), op.unsafe_apply(a, b)
        assert torch.equal(got.limbs, want.limbs)
        assert (got.bound, got.noise, got.zero_lanes, got.desc) == (
            want.bound, want.noise, want.zero_lanes, want.desc)
        assert list(ctx.decrypt(got)) == list(ctx.decrypt(want))
    assert fn.graphed.graphs == 1


def test_compiled_roundtrip_on_card():
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch import rng as hrng
    from homomorph_tpu_torch.models import HomomorphicAddition
    from homomorph_tpu_torch.models.compiled import compile_roundtrip

    ctx = card_context(ht.Parameters(64, 16, 1, 16), 7)
    fn = compile_roundtrip(ctx, HomomorphicAddition, ht.U8)
    rng = np.random.default_rng(8)
    for seed in (1, 2):
        xs = rng.integers(0, 256, size=256).astype(np.uint8)
        ys = rng.integers(0, 256, size=256).astype(np.uint8)
        bits = [np.unpackbits(v[:, None], axis=1, bitorder="little") for v in (xs, ys)]
        out = fn(hrng.threefry_key(seed), *bits).cpu().numpy().astype(np.uint8)
        got = np.packbits(out, axis=1, bitorder="little").reshape(-1)
        assert (got == (xs + ys).astype(np.uint8)).all()


def test_compiled_roundtrip_through_k3_replays_equal_eager(monkeypatch):
    """Under ``HOMOMORPH_TPU_TORCH_ENC_IMPL=pallas_v1`` the captured round
    trip encrypts through K3 (launched at warm-up and capture, K2 never):
    each replay equals the same function run eagerly on the same keys, and
    decrypts to the sums; a captured encrypt alone equals eager limb for
    limb."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch import rng as hrng
    from homomorph_tpu_torch.models import HomomorphicAddition
    from homomorph_tpu_torch.models.compiled import Graphed, compile_roundtrip

    ctx = card_context(ht.Parameters(64, 16, 1, 16), 13)
    monkeypatch.setenv(enc.ENC_IMPL_ENV, "pallas_v1")
    fn = compile_roundtrip(ctx, HomomorphicAddition, ht.U8)
    rng = np.random.default_rng(14)
    before = (counters["K2"], counters["K3"])
    for seed in (3, 4, 5):
        xs = rng.integers(0, 256, size=300).astype(np.uint8)
        ys = rng.integers(0, 256, size=300).astype(np.uint8)
        bits = [np.unpackbits(v[:, None], axis=1, bitorder="little") for v in (xs, ys)]
        out = fn(hrng.threefry_key(seed), *bits)
        ka, kb = hrng.threefry_split(hrng.threefry_key(seed))
        keys = torch.stack([prng.key_words(ka), prng.key_words(kb)]).cuda()
        dev_bits = [torch.from_numpy(b.astype(np.int32)).cuda() for b in bits]
        assert torch.equal(out, fn.graphed._fn(keys, *dev_bits))
        got = np.packbits(out.cpu().numpy().astype(np.uint8), axis=1, bitorder="little")
        assert (got.reshape(-1) == (xs + ys).astype(np.uint8)).all()
    assert counters["K2"] == before[0]
    assert counters["K3"] > before[1]
    assert fn.graphed.graphs == 1

    pk = ctx.get_public_key()
    plain = on_card((4099,), 15) & 1

    def encrypt(key, bits):
        selw = prng.random_bits_device_key(key, (bits.shape[0], 1))
        return enc.encrypt_bits_fused(selw, pk.limbs, bits, 5, planes=pk.planes)

    graphed = Graphed(encrypt, "encrypt")
    for key in ((0, 1), (7, 8)):
        buf = prng.key_words(key).cuda()
        assert torch.equal(graphed(buf, plain), encrypt(buf, plain))
    assert graphed.graphs == 1


PROGRAM_KERNEL_EXCLUDED = ("Memcpy", "Memset", "at::", "void at::")


def program_kernels(prof) -> int:
    """Device records of a profile that are the program's own kernels (no
    copy, no torch kernel, no ``record_function`` shadow)."""
    from torch.autograd import DeviceType

    return sum(1 for ev in prof.events()
               if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False)
               and not ev.name.startswith(PROGRAM_KERNEL_EXCLUDED) and "at::" not in ev.name)


def device_work(prof) -> int:
    """Device records of a profile that ran work: kernels, copies and sets
    (no ``record_function`` shadow)."""
    from torch.autograd import DeviceType

    return sum(1 for ev in prof.events()
               if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False))


def test_a_replay_counts_its_manifest_as_the_profiler_sees_it():
    """A compiled u8 product: its capture counts no launch, each replay adds
    the capture's manifest (what the counters moved by at one replay), the
    manifest's kernel launches equal the program kernels the profiler
    records in one replay, the graph's work nodes (torch's as well) equal
    the replay's device records (the most of three traces, as
    ``device_records`` counts), and the call's span carries them."""
    import time

    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.models import HomomorphicMultiplication
    from homomorph_tpu_torch.models.compiled import compile_op2
    from homomorph_tpu_torch.utils import profiling
    from torch.profiler import ProfilerActivity, profile

    ctx = card_context(ht.Parameters(160, 16, 1, 16), 9)
    a, b = ctx.encrypt([3, 5], ht.U8, batch=True), ctx.encrypt([7, 11], ht.U8, batch=True)
    fn = compile_op2(HomomorphicMultiplication, ht.U8, ctx.parameters.pk_degree)
    fn(a, b)
    torch.cuda.synchronize()
    (manifest,) = fn.graphed.manifests
    (launches,) = fn.graphed.launches
    launched = sum(manifest.get(key, 0) for key in profiling.KERNELS)
    assert 0 < launched < launches and manifest["K1"] > 0
    for profiled in (True, False):
        if profiled:
            seen = []
            for _ in range(profiling.TRACES):  # a trace can come back short of device records
                with profiling.tracing():
                    pass  # a new session: this trace's records alone
                before = counters.snapshot()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    time.sleep(0.02)
                    out = fn(a, b)
                    torch.cuda.synchronize()
                seen.append((program_kernels(prof), device_work(prof)))
            assert max(k for k, _ in seen) == launched
            assert max(w for _, w in seen) == launches + 3  # and both inputs' copies, the clone
        else:
            before = counters.snapshot()
            with profiling.tracing():
                out = fn(a, b)
        after = counters.snapshot()
        assert {key: n - before.get(key, 0) for key, n in after.items()
                if n != before.get(key, 0)} == manifest
        calls = [r for r in profiling.records() if r.name == "compiled.call"]
        assert [r.counts for r in calls] == [  # the partial products' broadcast operands
            {"launches": launches, "expand_limbs": manifest["clmul.expand"]}]
        assert {r.name for r in profiling.records() if r.parent == calls[0].id} == {
            "graph.copy_in", "graph.replay", "graph.clone"}
    assert [int(v) for v in ctx.decrypt(out)] == [21, 55]


def test_the_round_trip_times_its_decrypt_on_the_card():
    """The round trip's graph records two timing events around its decrypt
    stage, captured whatever tracing is at its capture: inside
    ``tracing()`` each replay's decrypt milliseconds become a record in its
    call's request."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch import rng as hrng
    from homomorph_tpu_torch.models import HomomorphicAddition
    from homomorph_tpu_torch.models.compiled import compile_roundtrip
    from homomorph_tpu_torch.utils import profiling

    ctx = card_context(ht.Parameters(64, 16, 1, 16), 13)
    fn = compile_roundtrip(ctx, HomomorphicAddition, ht.U8)
    rng = np.random.default_rng(14)
    xs, ys = (rng.integers(0, 256, size=4096).astype(np.uint8) for _ in range(2))
    bits = [np.unpackbits(v[:, None], axis=1, bitorder="little") for v in (xs, ys)]
    fn(hrng.threefry_key(1), *bits)  # capture, tracing off
    with profiling.tracing():
        for seed in (2, 3, 4):
            out = fn(hrng.threefry_key(seed), *bits)
            torch.cuda.synchronize()
    recs = profiling.records()
    calls = {r.request: r for r in recs if r.name == "compiled.call"}
    decrypts = [r for r in recs if r.name == "roundtrip.decrypt"]
    assert len(calls) == 3 and [r.request for r in decrypts] == sorted(calls)
    assert all(0 < r.counts["device_ms"] < 1000 and r.parent == calls[r.request].id
               for r in decrypts)
    assert all(r.counts == {} for r in recs if r.name == "roundtrip.bits_in")
    assert [c.counts for c in calls.values()] == [{"launches": fn.graphed.launches[0]}] * 3
    got = np.packbits(out.cpu().numpy().astype(np.uint8), axis=1, bitorder="little")
    assert (got.reshape(-1) == (xs + ys).astype(np.uint8)).all()


def test_the_compiled_u32_max_times_its_tree_and_its_mux_on_the_card():
    """The checked u32 max at d = 128 as a CUDA graph, as the benchmark's
    ``max_graph`` replays it: inside ``tracing()`` each call's request holds
    one ``circuit.lt_tree`` and one ``circuit.select`` record with the
    card's milliseconds, together no more than the call's own device time;
    the call carries ``expand_limbs``, the mux's 384-limb condition copied
    to each of the 32 lanes of every pair; the maxima decrypt right."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.experiments.common import CHECK_SEED, context
    from homomorph_tpu_torch.models import HomomorphicMaximum
    from homomorph_tpu_torch.models.compiled import compile_op2
    from homomorph_tpu_torch.utils import profiling

    on_card((1,), 0)
    B = 2048
    ctx = context((128, 128, 1, 128), CHECK_SEED, "cuda")
    fn = compile_op2(HomomorphicMaximum, ht.U32, ctx.parameters.pk_degree)
    rng = np.random.default_rng(20)
    xs = [int(v) for v in rng.integers(0, 2**32, size=B, dtype=np.uint64)]
    ys = [int(v) for v in rng.integers(0, 2**32, size=B, dtype=np.uint64)]
    xs[:3], ys[:3] = [0, 2**32 - 1, 77], [0, 5, 77]
    a, b = ctx.encrypt(xs, ht.U32, batch=True), ctx.encrypt(ys, ht.U32, batch=True)
    fn(a, b)  # the capture, tracing off
    (manifest,) = fn.graphed.manifests
    assert manifest["clmul.expand"] == B * 32 * 384
    spans = []
    with profiling.tracing():
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(a, b)
            end.record()
            end.synchronize()
            spans.append(start.elapsed_time(end))
    recs = profiling.records()
    calls = [r for r in recs if r.name == "compiled.call"]
    assert len(calls) == 3
    for call, call_ms in zip(calls, spans):
        assert call.counts["expand_limbs"] == B * 32 * 384
        mine = [r for r in recs if r.request == call.request and r.name.startswith("circuit.")]
        assert sorted(r.name for r in mine) == ["circuit.lt_tree", "circuit.select"]
        assert all(r.parent == call.id and r.counts["device_ms"] > 0 for r in mine)
        assert sum(r.counts["device_ms"] for r in mine) <= call_ms
    assert [int(v) for v in ctx.decrypt(out)] == [max(x, y) for x, y in zip(xs, ys)]


@pytest.mark.parametrize("op_name,params,pairs,launches", [
    ("HomomorphicAddition", (128, 128, 1, 128), 16384, 63),
    ("HomomorphicMultiplication", (2432, 128, 1, 128), 16, 419),
])
def test_the_compiled_u32_add_and_product_hold_no_region(op_name, params, pairs, launches):
    """The benchmark's other graphs gain no node from the regions: their
    replays launch 63 and 419 work nodes as before, and their calls hold
    no region record."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch import models
    from homomorph_tpu_torch.experiments.common import CHECK_SEED, context
    from homomorph_tpu_torch.models.compiled import compile_op2
    from homomorph_tpu_torch.utils import profiling

    on_card((1,), 0)
    ctx = context(params, CHECK_SEED, "cuda")
    fn = compile_op2(getattr(models, op_name), ht.U32, ctx.parameters.pk_degree)
    rng = np.random.default_rng(21)
    xs, ys = ([int(v) for v in rng.integers(0, 2**32, size=pairs, dtype=np.uint64)]
              for _ in range(2))
    a, b = ctx.encrypt(xs, ht.U32, batch=True), ctx.encrypt(ys, ht.U32, batch=True)
    fn(a, b)
    assert fn.graphed.launches == [launches]
    with profiling.tracing():
        fn(a, b)
        torch.cuda.synchronize()
    recs = profiling.records()
    (call,) = [r for r in recs if r.name == "compiled.call"]
    assert call.counts["launches"] == launches
    assert not [r for r in recs if r.name in ("circuit.lt_tree", "circuit.select")]


def test_run_verification_on_card():
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.gf2 import kernels as k

    on_card((1,), 0)
    before = (counters["K1"], counters["K2"], counters["T1"])
    lines = []
    ht.run_verification(quick=True, log=lines.append)
    after = (counters["K1"], counters["K2"], counters["T1"])
    assert all(x > y for x, y in zip(after, before))
    assert any("route chunk+split" in line for line in lines), lines


@pytest.mark.parametrize("shape,tau", [((2, 2), 128), ((1, 4), 128), ((1, 3), 96), ((4, 1), 33)])
def test_sharded_encrypt_on_card_matches_k2(shape, tau):
    """Each tau shard's partial is X1 on the card (τ/n_tau = 32, 96, 33
    slices included); the combined bits equal K2's dense output and decrypt
    right through sharded_decrypt_bits."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.parallel import bulk, make_mesh

    ctx = card_context(ht.Parameters(64, 64, 8, tau), 3)
    pk, sk = ctx.get_public_key(), ctx.get_secret_key()
    L = gf2.limbs_for(pk.max_degree)
    B, n = 64, 32
    selw = on_card((B * n, -(-tau // 32)), 4)
    sel = gf2.unpack_bits(selw, tau, dtype=torch.int8).view(B, n, tau)
    plain = on_card((B, n), 5) & 1
    before = counters["X1"]
    cfg = make_mesh(*shape, ["cuda"] * (shape[0] * shape[1]))
    got = bulk.sharded_encrypt_bits(cfg, sel, pk.limbs, plain, L)
    torch.cuda.synchronize()
    assert counters["X1"] == before + shape[0] * shape[1]
    assert torch.equal(got.view(B * n, L), enc.encrypt_words_table(selw, pk.limbs, plain.view(-1), L))
    back = bulk.sharded_decrypt_bits(cfg, got, sk.decrypt_mask(L))
    assert torch.equal(back, plain)


@pytest.mark.parametrize("n,B,La,Lb", [(2, 3, 300, 9), (4, 8, 1024, 64), (3, 1, 200, 200)])
def test_sharded_clmul_on_card_matches_dense(n, B, La, Lb):
    from homomorph_tpu_torch.parallel import Mesh, limbmul, ppermute

    a, b = on_card((B, La), 6), on_card((B, Lb), 7)
    before = counters["K1"]
    ppermute.local_bytes = 0
    got = limbmul.sharded_clmul(a, b, Mesh(["cuda"] * n, ("limb",)))
    torch.cuda.synchronize()
    assert counters["K1"] == before + n
    assert ppermute.local_bytes == limbmul.comm_bytes_per_call(B, Lb, n)
    assert torch.equal(got, k.clmul(a, b))


def test_compiled_product_under_a_limb_mesh_on_card(monkeypatch):
    """A CUDA graph captured under ``use_limb_mesh`` keeps the limb
    sharding: the products that qualify take the mesh at warm-up and
    capture (not at a replay), and every replay equals eager without it."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.models import HomomorphicMultiplication
    from homomorph_tpu_torch.models.compiled import compile_op2
    from homomorph_tpu_torch.parallel import Mesh, limbmul

    monkeypatch.setattr(limbmul, "_SHARD_MIN_BLOCK", 1)
    ctx = card_context(ht.Parameters(512, 16, 1, 16), 8)
    fn = compile_op2(HomomorphicMultiplication, ht.U8, ctx.parameters.pk_degree)
    rng = np.random.default_rng(9)
    monkeypatch.setattr(limbmul.maybe_sharded_clmul, "taken", 0)
    for i in range(3):
        xs, ys = rng.integers(0, 256, size=64).tolist(), rng.integers(0, 256, size=64).tolist()
        a, b = ctx.encrypt(xs, ht.U8, batch=True), ctx.encrypt(ys, ht.U8, batch=True)
        want = HomomorphicMultiplication.unsafe_apply(a, b)
        with limbmul.use_limb_mesh(Mesh(["cuda"] * 2, (limbmul.LIMB_AXIS,))):
            got = fn(a, b)
        torch.cuda.synchronize()
        if i == 0:
            taken = limbmul.maybe_sharded_clmul.taken
            assert taken > 0, "no product took the limb mesh at capture"
        assert limbmul.maybe_sharded_clmul.taken == taken  # a replay routes nothing
        assert torch.equal(got.limbs, want.limbs)
        assert [int(v) for v in ctx.decrypt(got)] == [(x * y) & 0xFF for x, y in zip(xs, ys)]
    assert fn.graphed.graphs == 1


def _example_names():
    return sorted(n[:-3] for n in os.listdir(os.path.join(ROOT, "homomorph_tpu_torch", "examples"))
                  if n.endswith(".py") and n != "__init__.py")


@pytest.mark.parametrize("name", _example_names())
def test_example_on_card(name, capsys):
    on_card((1,), 0)
    before = counters["K1"] + counters["K2"]
    importlib.import_module(f"homomorph_tpu_torch.examples.{name}").main(device="cuda")
    assert counters["K1"] + counters["K2"] > before
    assert capsys.readouterr().out.strip()


def test_bench_quick_on_card(capsys):
    """The port's bench at ``--quick`` on the card: the verify gate, then
    one JSON line whose device-busy fields are numbers."""
    import json

    from homomorph_tpu_torch import bench

    on_card((1,), 0)
    before = (counters["K1"], counters["K2"], counters["T1"])
    assert bench.main(["--quick", "--json-only"]) == 0
    after = (counters["K1"], counters["K2"], counters["T1"])
    assert all(x > y for x, y in zip(after, before))
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ex = out["extras"]
    assert ex["platform"] == "gpu" and out["value"] > 0
    for key in ("encrypt_device_busy_bits_per_s", "decrypt_device_busy_bits_per_s",
                "add_u32_device_busy_per_s", "lt_u32_device_busy_per_s",
                "decrypt_u32_device_latency_us"):
        assert ex[key] is not None and ex[key] > 0, key


def test_entry_on_card():
    """``entry()``'s step on the card (checked by decrypt inside) gives the
    CPU step's outputs, and ``dryrun_multichip(2)`` passes on the card."""
    from homomorph_tpu_torch import entry

    on_card((1,), 0)
    fn, args = entry.entry("cuda")
    assert all(a.is_cuda for a in args)
    before = (counters["K1"], counters["K2"])
    out = [o.cpu() for o in fn(*args)]
    assert counters["K1"] > before[0] and counters["K2"] > before[1]
    cfn, cargs = entry.entry("cpu")
    for got, want in zip(out, cfn(*cargs)):
        assert torch.equal(got, want)
    assert entry.dryrun_multichip(2, "cuda")["places"] == 2


@pytest.mark.parametrize(
    "B,L,n_bits,offset",
    [(1, 1, 1, 0), (3, 7, 200, 0), (5, 33, None, 0), (2, 9, 288, 0), (1, 1000, 1500, 1),
     (1, 1572654, 100649856, 0), (1, 1572654, 100649855, 3)],
)
def test_square_kernel_matches_plain(B, L, n_bits, offset):
    """M1 against ``square_plain``: one limb, odd tails, rows whose
    addresses are not 16-byte aligned (the kernel's limb-by-limb branch),
    and the u64 class's last squaring."""
    from homomorph_tpu_torch.gf2 import mask_kernel as mk

    x = on_card((B, L + offset), 41)[:, offset:]
    x = x if B == 1 else x.contiguous()
    before = counters["M1"]
    got = mk.square(x, n_bits)
    torch.cuda.synchronize()
    assert counters["M1"] == before + 1
    assert torch.equal(got, mk.square_plain(x, n_bits))


def test_device_mask_equals_native_at_the_u32_class():
    """The decrypt mask of the d = 2432 u32 product's class (98,304 limbs)
    on the card equals the native engine word for word, through the plan
    (M3, then M2) and through the route (M1 and K1) forced."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch import native
    from homomorph_tpu_torch.gf2 import mask_kernel as mk

    on_card((1,), 0)
    sk = ht.SecretKey.random(2432, ht.ThreefrySource(1), device="cuda")
    assert int(sk.limbs[0].item()) & 1 == 1
    before = mk.launch_counts()
    w = sk.decrypt_mask(98304)
    torch.cuda.synchronize()
    made = {name: n - before[name] for name, n in mk.launch_counts().items()}
    assert made["M3"] == 1 and made["M2"] > 0
    host = gf2.to_numpy(sk.limbs)
    want = native.decrypt_mask(host, 2432, 98304)
    assert np.array_equal(gf2.to_numpy(w), want)
    route = [("route", kk) for _, kk in mk.mask_plan(2432, 98304)]
    m1, k1 = counters["M1"], counters["K1"]
    w_route = mk.series_mask(mk.reversed_key(sk.limbs, 2432), 2432, 98304, route)
    torch.cuda.synchronize()
    assert counters["M1"] > m1 and counters["K1"] > k1
    assert np.array_equal(gf2.to_numpy(w_route), want)


def test_u32_product_decrypts_right_with_the_device_mask():
    """A checked u32 product at ``Parameters(2432, 128, 1, 128)`` under a
    key with ``S(0) = 1`` (every coefficient of the product counts),
    decrypted with the mask computed on the card."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.experiments.common import CHECK_SEED, context, key_s0
    from homomorph_tpu_torch.gf2 import mask_kernel as mk
    from homomorph_tpu_torch.models import HomomorphicMultiplication

    on_card((1,), 0)
    ctx = context((2432, 128, 1, 128), CHECK_SEED, "cuda")
    assert key_s0(ctx) == 1
    xs, ys = [0xDEADBEEF, 12345, 0xFFFFFFFF], [0x12345678, 67890, 0xFFFFFFFF]
    prod = ctx.apply2(HomomorphicMultiplication, ctx.encrypt(xs, ht.U32, batch=True),
                      ctx.encrypt(ys, ht.U32, batch=True))
    before = counters["M2"]
    got = [int(v) for v in ctx.decrypt(prod).tolist()]
    assert counters["M2"] > before  # the product's class was new to the key
    assert got == [(x * y) & 0xFFFFFFFF for x, y in zip(xs, ys)]


def step_operands(Li, Ls, seed):
    """A series row of ``Li`` limbs and ``S*`` of ``Ls`` limbs (bit 0 set)
    on the card."""
    inv = on_card((Li,), seed)
    sstar = on_card((Ls,), seed + 1)
    sstar[0] |= 1
    return inv, sstar


@pytest.mark.parametrize("Li,Ls,k", [
    (1, 1, 2), (1, 5, 33), (3, 5, 190), (9, 33, 500), (40, 77, 2500), (300, 40, 19000),
    (600, 2, 38000), (4100, 185, 262000), (5000, 421, 320000), (2000, 2048, 128000),
    (50, 421, 3200),
])
def test_newton_step_kernel_matches_plain(Li, Ls, k):
    """M2 against ``newton_step_plain``: one limb, ragged ``k``, ``Lo <
    Ls`` and ``Lo >> Ls``, tiles split 1 to 8 ways over ``S*``'s limbs, and
    the widest ``S*`` its table holds (131 KB of shared memory)."""
    from homomorph_tpu_torch.gf2 import mask_kernel as mk

    inv, sstar = step_operands(Li, Ls, Li + Ls + k)
    before = counters["M2"]
    got = mk.newton_step(inv, sstar, k)
    torch.cuda.synchronize()
    assert counters["M2"] == before + 1
    assert torch.equal(got, mk.newton_step_plain(inv, sstar, k))


def test_newton_step_kernel_at_the_u64_class_last_step():
    """M2 at the u64 class's last step ([1,572,654] limbs to [3,145,308],
    ``S*`` of 421 limbs): its first and last 256 limbs against the plain
    version on the inputs they depend on."""
    from homomorph_tpu_torch.gf2 import mask_kernel as mk

    k_prev, k_last = mk.precisions(32 * 3145728 - 13440)[-2:]
    inv, sstar = step_operands(-(-k_prev // 32), 421, 77)
    got = mk.newton_step(inv, sstar, k_last)
    torch.cuda.synchronize()
    Lo, n = got.shape[0], 256
    assert Lo == 3145308
    assert torch.equal(got[:n], mk.newton_step_plain(inv[: n // 2], sstar, 32 * n))
    j0 = Lo - n - 421 - 1  # output limb m reads the square from limb m - Ls - 1 up
    assert k_last % 32 == 0  # so the last limb is not truncated
    sq = mk.square_plain(inv.view(1, -1), k_last)[:, j0:]
    want = k.clmul_plain(sstar.view(1, -1), sq)[0, Lo - n - j0 : Lo - j0]
    assert torch.equal(got[-n:], want)


@pytest.mark.parametrize("d,n_limbs,s0", [
    (1, 1, 1), (31, 9, 1), (32, 9, 1), (128, 9, 1), (128, 9, 0), (1024, 65, 1), (1024, 65, 0),
    (100, 40, 1), (13440, 421, 1), (2432, 106, 1), (5, 1024, 1), (64, 1026, 1),
])
def test_series_small_kernel_matches_plain(d, n_limbs, s0):
    """M3 against ``series_small_plain``, the series alone and the mask it
    assembles: ``d % 32 == 0``, ``S(0) = 0``, one step's class, the u64
    key's ``S*`` and series of the kernel's widest 1,024 limbs."""
    from homomorph_tpu_torch.gf2 import mask_kernel as mk

    on_card((1,), 0)
    rng = np.random.default_rng(d + n_limbs)
    s_int = int.from_bytes(rng.bytes(d // 8 + 1), "little")
    s_int = (s_int & ((1 << d) - 1) & ~1) | (1 << d) | s0
    s = gf2.from_numpy(np.frombuffer(s_int.to_bytes(4 * gf2.limbs_for(d), "little"),
                                     dtype="<u4").astype(np.uint32), "cuda")
    sstar = mk.reversed_key(s, d)
    n_bits = 32 * n_limbs - d
    for assemble in (None, (d, n_limbs)):
        before = counters["M3"]
        got = mk.series_small(sstar, n_bits, assemble)
        torch.cuda.synchronize()
        assert counters["M3"] == before + 1
        assert torch.equal(got, mk.series_small_plain(sstar, n_bits, assemble))
    with pytest.raises(ValueError):
        mk.series_small(sstar, 32 * 1025)


def test_masks_through_every_plan_on_the_card():
    """The plan's masks on the card equal native's at the small classes
    (one M3 launch each) and at wider ones, with the plan forced to all
    M2, all route, and split at other caps."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch import native
    from homomorph_tpu_torch.gf2 import mask_kernel as mk

    on_card((1,), 0)
    for d, n_limbs in ((128, 9), (1024, 65), (1024, 8192), (5888, 300)):
        sk = ht.SecretKey.random(d, ht.ThreefrySource(d), device="cuda")
        want = native.decrypt_mask(gf2.to_numpy(sk.limbs), d, n_limbs)
        sstar = mk.reversed_key(sk.limbs, d)
        route = [("route", k) for _, k in mk.mask_plan(d, n_limbs)]
        for plan in (mk.mask_plan(d, n_limbs), mk.mask_plan(d, n_limbs, 0), route,
                     mk.mask_plan(d, n_limbs, 64)[:-1] + route[-1:], mk.mask_plan(d, n_limbs, 1024)):
            before = counters["M3"]
            w = mk.series_mask(sstar, d, n_limbs, plan)
            torch.cuda.synchronize()
            assert np.array_equal(gf2.to_numpy(w), want), (d, n_limbs, plan)
            if all(kind == "M3" for kind, _ in plan):
                assert counters["M3"] == before + 1


# -- C1, C2, C3: the circuits' glue (csrc/circuit.cu) -------------------------


def circuit_counter(rec):
    """The launch counter's key of the kernel a recorded program runs."""
    from homomorph_tpu_torch.experiments import exp_circuit

    return exp_circuit.SPECS[rec["kernel"]].kernel


@pytest.mark.parametrize("path,widest,name", [
    (path, widest, name) for path, widest in (("u16", False), ("u32", True), ("u64", False))
    for name in ("C1", "C2", "C3", "C1 stack")] + [("add", False, "C1"), ("add", False, "C3")])
def test_circuit_kernels_match_plain_at_the_paths_programs(path, widest, name):
    """C1, C2 and C3 at the programs of the u16 product's busiest level and
    step, the u32 product's (d = 2432) widest, the u64 product's busiest and
    the u32 add's, on random limbs: every tensor equal to the plain
    version's, one launch counted for each the program takes."""
    from homomorph_tpu_torch.experiments import exp_circuit

    on_card((1,), 0)
    rec = exp_circuit.picks(path, widest)[name]
    kernel = circuit_counter(rec)
    before = counters[kernel]
    bad, err, _, _ = exp_circuit.kernel_case(rec, "cuda", seed=len(name))
    assert (bad, err) == (0, 0)
    assert counters[kernel] == before + rec["launches"]


def test_a_level_split_across_launches_on_card():
    """The u64 product's first level: 692 ops, three launches of C1 (240 ops
    a launch), equal to the plain version; its carries two launches of C2."""
    from homomorph_tpu_torch.experiments import exp_circuit

    on_card((1,), 0)
    recs = exp_circuit.recorded_programs("u64")
    for kernel, launches in (("csa_level_in", 3), ("csa_level_out", 2)):
        rec = exp_circuit.described(next(r for r in recs if r["kernel"] == kernel))
        assert rec["launches"] == launches
        before = counters[circuit_counter(rec)]
        bad, _, _, _ = exp_circuit.kernel_case(rec, "cuda", seed=launches)
        assert bad == 0
        assert counters[circuit_counter(rec)] == before + launches


@pytest.mark.parametrize("shift", [1, 2, 3])
def test_circuit_kernels_take_unaligned_rows(shift):
    """The u16 product's busiest level with every slot's tensor starting
    ``shift`` limbs into a buffer (no 16-byte row starts)."""
    from homomorph_tpu_torch.experiments import exp_circuit
    from homomorph_tpu_torch.models import circuit_kernels as ck

    on_card((1,), 0)
    rec = exp_circuit.picks("u16")["C1"]
    base = exp_circuit.slot_tensors([e + shift for e in rec["extents"]], "cuda", 7)
    got = [t[shift:] for t in base]
    want = [t.cpu() for t in got]
    ck.csa_level_in(rec["prog"], got, rec["rows"])
    ck.csa_level_in(rec["prog"], want, rec["rows"])
    torch.cuda.synchronize()
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def test_circuit_wrappers_refuse_on_card():
    from homomorph_tpu_torch.models import circuit_kernels as ck

    on_card((1,), 0)
    prog = np.array([[0, 0, 6, 3, 0, 10, 6, 3, 1, 0, 4, 4, 3]], dtype=np.int64)
    t = [torch.arange(20, dtype=torch.int32, device="cuda"),
         torch.zeros(8, dtype=torch.int32, device="cuda")]
    with pytest.raises(TypeError):
        ck.csa_level_out(prog, [t[0].to(torch.int64), t[1]], 2)
    with pytest.raises(ValueError):
        ck.csa_level_out(prog, [t[0], t[1].cpu()], 2)
    with pytest.raises(ValueError):  # a destination past its tensor
        ck.csa_level_out(prog, [t[0], t[1][:7]], 2)
    ck.csa_level_out(prog, t, 2)
    torch.cuda.synchronize()
    assert t[1].tolist() == [10, 10, 14, 0, 22, 22, 26, 0]


def test_compiled_u32_product_equals_eager_under_a_graph():
    """The u32 product at d = 2432 captured as a CUDA graph (the launches'
    pointers inside the graph's pool) equals eager limb for limb on new
    inputs of the same shape, and both equal the per-op glue's."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.experiments.common import CHECK_SEED, context
    from homomorph_tpu_torch.models import HomomorphicMultiplication, circuits
    from homomorph_tpu_torch.models.compiled import compile_op2

    on_card((1,), 0)
    ctx = context((2432, 128, 1, 128), CHECK_SEED, "cuda")
    fn = compile_op2(HomomorphicMultiplication, ht.U32, ctx.parameters.pk_degree)
    rng = np.random.default_rng(8)
    for _ in range(2):
        xs = [int(v) for v in rng.integers(0, 2**32, size=4, dtype=np.uint64)]
        ys = [int(v) for v in rng.integers(0, 2**32, size=4, dtype=np.uint64)]
        a, b = ctx.encrypt(xs, ht.U32, batch=True), ctx.encrypt(ys, ht.U32, batch=True)
        got, want = fn(a, b), HomomorphicMultiplication.unsafe_apply(a, b)
        saved = circuits._csa_accumulate
        circuits._csa_accumulate = circuits._csa_accumulate_per_op
        try:
            per_op = HomomorphicMultiplication.unsafe_apply(a, b)
        finally:
            circuits._csa_accumulate = saved
        for other in (want, per_op):
            assert torch.equal(got.limbs, other.limbs)
            assert (got.bound, got.noise) == (other.bound, other.noise)
        assert [int(v) for v in ctx.decrypt(got)] == [x * y % 2**32 for x, y in zip(xs, ys)]
    assert fn.graphed.graphs == 1


def card_limbs(shape, seed):
    """Random int32 limbs made on the card (the round trip's 3.2 GB sum is
    too large to draw on the host)."""
    on_card((1,), 0)
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(-2**31, 2**31, shape, generator=g, dtype=torch.int64,
                         device="cuda").to(torch.int32)


@pytest.mark.parametrize("rows,L", [(1, 1), (2**21, 9), (4097, 33), (2**21, 384), (1023, 385),
                                    (512, 98304), (1, 3145728)])
def test_decipher_kernel_matches_plain(rows, L):
    """D1 bit for bit against the torch expression at the paths' widths
    (sub-warp groups, a warp a row, rows cut into tasks), one launch each."""
    from homomorph_tpu_torch.gf2 import decrypt_kernel as dk

    c, w = card_limbs((rows, L), 40 + L), card_limbs((L,), 41 + L)
    before = counters["D1"]
    got = gf2.decipher_bits(c, w)
    torch.cuda.synchronize()
    assert counters["D1"] == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (rows,)
    assert torch.equal(got, gf2.decipher_bits_plain(c, w))
    assert torch.equal(dk.decipher(c, torch.full_like(w, -1)),
                       gf2.decipher_bits_plain(c, torch.full_like(w, -1)))


@pytest.mark.parametrize("name", ["wider rows, aligned", "wider rows, unaligned", "every other row",
                                  "batch of two dims", "unaligned mask", "permuted batch",
                                  "limbs not contiguous", "broadcast mask", "empty", "no limbs"])
def test_decipher_kernel_on_views(name):
    """D1 reads rows in place wherever they lie one stride apart, aligned
    or not; a permuted batch or limbs that are not contiguous are copied
    and launch D1 too, as does a mask that broadcasts; an empty batch and
    rows of no limbs launch nothing."""
    L = 385
    wide, wl = card_limbs((1023, 400), 50), card_limbs((L + 1,), 51)[1:]
    c, w, launches = {
        "wider rows, aligned": (wide[:, 8:8 + L], wl, 1),
        "wider rows, unaligned": (wide[:, 3:3 + L], wl, 1),
        "every other row": (wide[::2, :384], wl[:384], 1),
        "batch of two dims": (wide[:1020, :L].reshape(4, 255, L), wl, 1),
        "unaligned mask": (wide[:, :L], wl, 1),
        "permuted batch": (wide[:1020].reshape(4, 255, 400)[..., :L].transpose(0, 1), wl, 1),
        "limbs not contiguous": (wide[:L, :300].t(), wl, 1),
        "broadcast mask": (wide[:, :L], wl[:1], 1),
        "empty": (wide[:0, :L], wl, 0),
        "no limbs": (wide[:, :0], wl[:0], 0),
    }[name]
    before = counters["D1"]
    got = gf2.decipher_bits(c, w)
    torch.cuda.synchronize()
    assert counters["D1"] == before + launches
    assert got.dtype == torch.int32 and tuple(got.shape) == tuple(c.shape[:-1])
    assert torch.equal(got, gf2.decipher_bits_plain(c.contiguous(), w.contiguous()))


def test_decipher_kernel_refuses_other_dtypes():
    """On the card D1 takes int32 limbs and mask alone, and a mask on the
    limbs' device: anything else raises and launches nothing."""
    c, w = card_limbs((64, 9), 52), card_limbs((9,), 53)
    before = counters["D1"]
    for args in ((c.to(torch.int64), w), (c, w.to(torch.int64)), (c, w.cpu()),
                 (c, w.reshape(1, 9))):
        with pytest.raises((TypeError, ValueError)):
            gf2.decipher_bits(*args)
    assert counters["D1"] == before


@pytest.mark.parametrize("rows,L", [(65536, 384), (4097, 33), (64, 384), (512, 98304)])
def test_decipher_kernel_replays_in_a_cuda_graph(rows, L):
    """D1 captured in a CUDA graph (with its memset node where rows are cut
    into tasks) and replayed on new limbs equals eager."""
    from homomorph_tpu_torch.gf2 import decrypt_kernel as dk

    c, w = card_limbs((rows, L), 60 + L), card_limbs((L,), 61 + L)
    plan = dk.decipher_plan(rows, L, L % 4 == 0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gf2.decipher_bits(c, w)  # warm-up: builds, loads and asks the occupancy
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gf2.decipher_bits(c, w)
    for seed in (1, 2):
        c.copy_(card_limbs((rows, L), 70 + seed))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, gf2.decipher_bits(c, w))
        assert torch.equal(out, gf2.decipher_bits_plain(c, w))
    assert (plan.split > 1) == (rows < 65536)


def test_the_round_trip_at_the_cells_shape_decrypts_through_d1():
    """The compiled u32 add's round trip at the benchmark's 65,536 pairs
    (a [65,536, 32, 384] sum) decrypts to the plaintext sums, and each
    replay counts one D1 launch, its graph's only decrypt: 68 work nodes,
    where the torch expression made 91."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch import rng as hrng
    from homomorph_tpu_torch.experiments.common import CHECK_SEED, context
    from homomorph_tpu_torch.models import HomomorphicAddition
    from homomorph_tpu_torch.models.compiled import compile_roundtrip

    on_card((1,), 0)
    ctx = context((128, 128, 1, 128), CHECK_SEED, "cuda")
    fn = compile_roundtrip(ctx, HomomorphicAddition, ht.U32)
    rng = np.random.default_rng(22)
    xs, ys = (rng.integers(0, 2**32, size=65536, dtype=np.uint64).astype(np.uint32)
              for _ in range(2))
    bits = [np.unpackbits(v.view(np.uint8).reshape(-1, 4), axis=1, bitorder="little")
            .astype(np.int32) for v in (xs, ys)]
    for seed in (1, 2):
        before = counters["D1"]
        out = fn(hrng.threefry_key(seed), *bits)
        torch.cuda.synchronize()
        got = np.packbits(out.cpu().numpy().astype(np.uint8), axis=1, bitorder="little")
        assert (got.view("<u4").reshape(-1) == xs + ys).all()
    (manifest,) = fn.graphed.manifests
    assert manifest["D1"] == 1 and counters["D1"] == before + 1
    assert fn.graphed.launches == [68]
