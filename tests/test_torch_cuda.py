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
