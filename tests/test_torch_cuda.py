"""The port's CUDA kernels (K1, K2, K3, X1, T1) against their plain torch
versions (and K1 and K2 against the torch mirrors of their designs), on the
card.

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
    before = k.clmul_flat.launches
    got = k.clmul_flat(a, b)
    torch.cuda.synchronize()
    assert k.clmul_flat.launches == before + 1
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
    before = k.clmul_flat.launches
    got = k.clmul(a, b)
    torch.cuda.synchronize()
    assert k.clmul_flat.launches == before + 1
    assert k.route_plan(min(La, Lb), max(La, Lb), kmin)
    assert torch.equal(got, k.clmul_flat(a, b))
    assert torch.equal(got, k.clmul_plain(a, b))


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
    before = enc.encrypt_words_table.launches
    got = enc.encrypt_words_table(selw, pk, plain, L)
    torch.cuda.synchronize()
    assert enc.encrypt_words_table.launches == before + 1
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
    before = (enc.encrypt_words_mma.launches, enc.encrypt_sel_mma.launches)
    k3 = enc.encrypt_words_mma(selw, planes, plain, L)
    x1 = enc.encrypt_sel_mma(sel, planes, plain, L)
    torch.cuda.synchronize()
    assert (enc.encrypt_words_mma.launches, enc.encrypt_sel_mma.launches) == (
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
    before = (enc.encrypt_words_table.launches, enc.encrypt_words_mma.launches)
    got = enc.encrypt_bits_fused(selw, pk, plain, 9)
    assert (enc.encrypt_words_table.launches, enc.encrypt_words_mma.launches) == (
        before[0], before[1] + 1)
    assert torch.equal(got, enc.encrypt_words_table(selw, pk, plain, 9))


@pytest.mark.parametrize("shape", [(5,), (7, 8), ((1 << 20) + 3, 4)])
def test_threefry_kernel_matches_plain(shape):
    on_card((1,), 0)  # skips without a card
    before = prng.random_bits.launches
    got = prng.random_bits((0x12345678, 0x9ABCDEF0), shape, "cuda")
    torch.cuda.synchronize()
    assert prng.random_bits.launches == before + 1
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
    before = prng.random_bits_device_key.launches
    got = prng.random_bits_device_key(buf, (4099, 4))
    torch.cuda.synchronize()
    assert prng.random_bits_device_key.launches == before + 1
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
    before = (enc.encrypt_words_table.launches, enc.encrypt_words_mma.launches)
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
    assert enc.encrypt_words_table.launches == before[0]
    assert enc.encrypt_words_mma.launches > before[1]
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


def test_compiled_add_through_the_carry_scan(monkeypatch):
    """``compile_op2`` of a u32 add under ``HOMOMORPH_TPU_TORCH_CARRY_SCAN=1``
    captures (the scan's positions are views, no host-to-device copy): each
    replay equals the scan run eagerly, limb for limb, and decrypts right."""
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.models import HomomorphicAddition, circuits
    from homomorph_tpu_torch.models.compiled import compile_op2

    ctx = card_context(ht.Parameters(256, 16, 1, 16), 16)
    monkeypatch.setenv(circuits.CARRY_SCAN_ENV, "1")
    fn = compile_op2(HomomorphicAddition, ht.U32, ctx.parameters.pk_degree)
    rng = np.random.default_rng(17)
    for _ in range(3):
        xs, ys = (rng.integers(0, 2**32, size=256, dtype=np.uint64).tolist() for _ in range(2))
        a, b = ctx.encrypt(xs, ht.U32, batch=True), ctx.encrypt(ys, ht.U32, batch=True)
        got, want = fn(a, b), HomomorphicAddition.unsafe_apply(a, b)
        assert torch.equal(got.limbs, want.limbs)
        assert (got.bound, got.noise) == (want.bound, want.noise)
        assert [int(v) for v in ctx.decrypt(got)] == [(x + y) % (1 << 32) for x, y in zip(xs, ys)]
    assert fn.graphed.graphs == 1


def test_eager_sync_refuses_capture(monkeypatch):
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.models import HomomorphicMultiplication, circuits
    from homomorph_tpu_torch.models.compiled import compile_op2

    ctx = card_context(ht.Parameters(160, 16, 1, 16), 9)
    a, b = ctx.encrypt([3, 5], ht.U8, batch=True), ctx.encrypt([7, 11], ht.U8, batch=True)
    fn = compile_op2(HomomorphicMultiplication, ht.U8, ctx.parameters.pk_degree)
    monkeypatch.setenv(circuits.EAGER_SYNC_ENV, "1")
    with pytest.raises(RuntimeError, match=circuits.EAGER_SYNC_ENV):
        fn(a, b)


def test_run_verification_on_card():
    import homomorph_tpu_torch as ht
    from homomorph_tpu_torch.gf2 import kernels as k

    on_card((1,), 0)
    before = (k.clmul_flat.launches, enc.encrypt_words_table.launches, prng.random_bits.launches)
    lines = []
    ht.run_verification(quick=True, log=lines.append)
    after = (k.clmul_flat.launches, enc.encrypt_words_table.launches, prng.random_bits.launches)
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
    before = enc.encrypt_sel_mma.launches
    cfg = make_mesh(*shape, ["cuda"] * (shape[0] * shape[1]))
    got = bulk.sharded_encrypt_bits(cfg, sel, pk.limbs, plain, L)
    torch.cuda.synchronize()
    assert enc.encrypt_sel_mma.launches == before + shape[0] * shape[1]
    assert torch.equal(got.view(B * n, L), enc.encrypt_words_table(selw, pk.limbs, plain.view(-1), L))
    back = bulk.sharded_decrypt_bits(cfg, got, sk.decrypt_mask(L))
    assert torch.equal(back, plain)


@pytest.mark.parametrize("n,B,La,Lb", [(2, 3, 300, 9), (4, 8, 1024, 64), (3, 1, 200, 200)])
def test_sharded_clmul_on_card_matches_dense(n, B, La, Lb):
    from homomorph_tpu_torch.parallel import Mesh, limbmul, ppermute

    a, b = on_card((B, La), 6), on_card((B, Lb), 7)
    before = k.clmul_flat.launches
    ppermute.local_bytes = 0
    got = limbmul.sharded_clmul(a, b, Mesh(["cuda"] * n, ("limb",)))
    torch.cuda.synchronize()
    assert k.clmul_flat.launches == before + n
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
    before = k.clmul_flat.launches + enc.encrypt_words_table.launches
    importlib.import_module(f"homomorph_tpu_torch.examples.{name}").main(device="cuda")
    assert k.clmul_flat.launches + enc.encrypt_words_table.launches > before
    assert capsys.readouterr().out.strip()


def test_bench_quick_on_card(capsys):
    """The port's bench at ``--quick`` on the card: the verify gate, then
    one JSON line whose device-busy fields are numbers."""
    import json

    from homomorph_tpu_torch import bench

    on_card((1,), 0)
    before = (k.clmul_flat.launches, enc.encrypt_words_table.launches, prng.random_bits.launches)
    assert bench.main(["--quick", "--json-only"]) == 0
    after = (k.clmul_flat.launches, enc.encrypt_words_table.launches, prng.random_bits.launches)
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
    before = (k.clmul_flat.launches, enc.encrypt_words_table.launches)
    out = [o.cpu() for o in fn(*args)]
    assert k.clmul_flat.launches > before[0] and enc.encrypt_words_table.launches > before[1]
    cfn, cargs = entry.entry("cpu")
    for got, want in zip(out, cfn(*cargs)):
        assert torch.equal(got, want)
    assert entry.dryrun_multichip(2, "cuda")["places"] == 2
