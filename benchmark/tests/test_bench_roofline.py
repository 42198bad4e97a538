"""The roofline counts on shapes worked out by hand."""

from __future__ import annotations

import pytest

from benchmark import roofline

PK = roofline.peaks(132, 1980.0)


def test_depths_of_a_balanced_product():
    # 9 limbs: 9 -> 5 -> 3 -> 2 -> 1, rows times 3 a halving
    assert roofline.route_depths(9, 9) == [(1, 9, 9), (3, 5, 5), (9, 3, 3), (27, 2, 2), (81, 1, 1)]


def test_depths_after_the_chunk_step():
    # 4 x 16: 16 > 6, so four pieces of 4 limbs, then 4 -> 2 -> 1
    assert roofline.route_depths(4, 16) == [(1, 4, 16), (4, 4, 4), (12, 2, 2), (36, 1, 1)]


@pytest.mark.parametrize("B, La, Lb, least", [
    # 9 x 9: 9*10 = 90, 3*5*6 = 90, 9*3*4 = 108, 27*2*3 = 162, 81*1*2 = 162
    (1, 9, 9, 90),
    # 4 x 16 unrouted: 4*17 = 68; chunked 80; then 72, 72
    (1, 4, 16, 68),
    # 64 x 64: 4160, 3168, 2448, 1944, 1620, 1458, 1458: the deepest levels
    (1, 64, 64, 1458),
    # the operands' order does not matter, rows multiply
    (5, 16, 4, 5 * 68),
])
def test_least_leaf_pairs_over_every_depth(B, La, Lb, least):
    assert roofline.least_leaf_pairs(B, La, Lb) == least


def test_the_route_threshold_cannot_make_the_count_stale():
    # whatever threshold the program routes at, its leaves hold at least
    # the least pairs (the program's plan, frozen here as route_depths)
    for kmin in (2, 8, 64, 10**6):
        Ls, Lg, rows = 8192, 98304, 8
        if Ls >= kmin and Lg > (3 * Ls) // 2:
            rows, Lg = rows * -(-Lg // Ls), Ls
        while Ls >= kmin:
            Ls = Lg = (Lg + 1) // 2
            rows *= 3
        assert rows * Ls * (Lg + 1) >= roofline.least_leaf_pairs(8, 8192, 98304)


def test_the_bound_is_the_larger_of_bytes_and_work():
    # 1 x 1 limb, 2^20 rows: least pairs 2 a row; bytes 2*2*4*2^20 = 16 MiB
    B = 1 << 20
    t = roofline.clmul_bound_s(B, 1, 1, PK)
    smem = B * 2 * 15 * 4 / PK["smem_bw"]
    hbm = B * 2 * 8 / PK["hbm_bw"]
    assert t == pytest.approx(max(smem, hbm, B * 2 * 16 / PK["int32_ops"]))
    assert PK["smem_bw"] == 128 * 132 * 1980e6 and PK["int32_ops"] == 64 * 132 * 1980e6


def test_encrypt_bytes_by_hand():
    # 2^22 bits at tau = 128 (4 selection words), 9 limbs: (4 + 1 + 9) * 4 a bit, plus the key
    assert roofline.encrypt_bytes(1 << 22, 128, 9) == (1 << 22) * 14 * 4 + 128 * 9 * 4


def test_frozen_copies_match_the_program_today():
    from homomorph_tpu_torch.gf2 import kernels as k
    from homomorph_tpu_torch.utils import profiling as prof

    for B, La, Lb in [(8, 8192, 98304), (65536, 9, 256), (2048, 48, 64)]:
        assert roofline.clmul_bytes(B, La, Lb) == prof.clmul_bytes(B, La, Lb)
        smem, ops = prof.clmul_comb_work(B, La, Lb)
        d0 = B * min(La, Lb) * (max(La, Lb) + 1)
        assert smem == d0 * roofline.COMB_LOADS_PER_PAIR * 4 and ops == d0 * roofline.COMB_OPS_PER_PAIR
        steps = k.route_plan(min(La, Lb), max(La, Lb), k.karatsuba_min())
        if steps:
            rows, w = k.leaf_rows(B, steps)
            assert (rows // B, w, w) in roofline.route_depths(min(La, Lb), max(La, Lb))
    pk = prof.chip_peaks(sms=132, mhz=1980.0)
    assert all(pk[key] == PK[key] for key in ("hbm_bw", "int32_ops", "smem_bw"))
