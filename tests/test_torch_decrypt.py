"""The batched decrypt and D1's plan (``homomorph_tpu_torch.gf2.decrypt_kernel``).

``decipher_bits`` on CPU tensors (the torch expression, D1's plain version)
against the JAX package's ``decipher_bits``; D1's thread mapping, walked
here as ``csrc/decrypt.cu`` walks it, covers every (row, limb) of a shape
exactly once within the card's grid and block limits; and the operands the
wrapper hands to D1 for each layout.  D1 itself runs on the card
(``tests/test_torch_cuda.py``).  Every value is a GF(2) bit: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homomorph_tpu.gf2 import poly as jpoly
from homomorph_tpu_torch.gf2 import decrypt_kernel as dk
from homomorph_tpu_torch.gf2 import poly as tpoly
from homomorph_tpu_torch.utils.profiling import counters


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mask(kind, L, rng):
    if kind == "zero":
        return np.zeros(L, dtype=np.uint32)
    if kind == "ones":
        return np.full(L, 0xFFFFFFFF, dtype=np.uint32)
    return rng.integers(0, 2**32, size=L, dtype=np.uint32)


@pytest.mark.parametrize("kind", ["zero", "ones", "random"])
@pytest.mark.parametrize("batch", [(), (7,), (3, 5)])
@pytest.mark.parametrize("L", [1, 2, 9, 31, 33, 65, 384, 385])
def test_decipher_bits_matches_jax(L, batch, kind):
    rng = np.random.default_rng(1000 * L + 10 * len(batch) + len(kind))
    c = rng.integers(0, 2**32, size=batch + (L,), dtype=np.uint32)
    w = mask(kind, L, rng)
    before = counters["D1"]
    got = tpoly.decipher_bits(tpoly.from_numpy(c, "cpu"), tpoly.from_numpy(w, "cpu"))
    want = np.asarray(jpoly.decipher_bits(jnp.asarray(c), jnp.asarray(w)))
    assert counters["D1"] == before  # the CPU launches nothing
    assert got.dtype == torch.int32 and tuple(got.shape) == batch
    assert np.array_equal(got.numpy().astype(np.int64), want.astype(np.int64))
    if kind == "zero":
        assert not got.any()


def row_reads(plan, L):
    """Limb -> how many times one row's tasks read it, walked as the
    kernel's loops walk it: task part, lane, unrolled pass k, load u, then
    the row's tail limbs in the row's last task."""
    vec, group, split, chunk = plan.vec, plan.group, plan.split, plan.chunk
    nv = L // vec
    passes = -(-chunk // (group * dk.UNROLL))
    part = np.arange(split)[:, None, None, None]
    lane = np.arange(group)[None, :, None, None]
    k = np.arange(passes)[None, None, :, None]
    u = np.arange(dk.UNROLL)[None, None, None, :]
    i0 = part * chunk
    i1 = np.minimum(i0 + chunk, nv)
    i = i0 + lane + k * group * dk.UNROLL
    j = i + u * group
    j = j[(i < i1) & (j < i1)]
    limbs = (vec * j[:, None] + np.arange(vec)).ravel()
    tail = L - nv * vec
    tail_limbs = np.array([nv * vec + t for lane_ in range(group)
                           for t in range(lane_, tail, group)], dtype=np.int64)
    return np.bincount(np.concatenate([limbs, tail_limbs]), minlength=L)


def task_visits(plan, rows):
    """Task -> how many times the grid-stride loop of ``plan.blocks``
    blocks hands it to a group."""
    per_block = dk.THREADS // plan.group
    tasks = rows * plan.split
    passes = -(-tasks // (plan.blocks * per_block))
    b = np.arange(plan.blocks)[:, None, None]
    p = np.arange(passes)[None, :, None]
    slot = np.arange(per_block)[None, None, :]
    q = ((b + p * plan.blocks) * per_block + slot).ravel()
    return np.bincount(q[q < tasks], minlength=tasks)


PLAN_CASES = [
    (rows, L, aligned)
    for rows, L in [
        (0, 1), (0, 384), (1, 1), (1, 2), (1, 3), (1, 4), (3, 5), (1, 9), (2**21, 9), (17, 31),
        (4097, 33), (65, 65), (1, 384), (7, 384), (2**21, 384), (1023, 385), (8, 1024),
        (65536, 1025), (16, 4096), (3, 4097), (16, 8192), (512, 98304), (8, 98304),
        (2, 262144), (1, 3145728), (2**21, 3145728), (0, 3145728),
    ]
    for aligned in (True, False)
]


@pytest.mark.parametrize("rows,L,aligned", PLAN_CASES)
def test_decipher_plan_covers_each_limb_once(rows, L, aligned):
    plan = dk.decipher_plan(rows, L, aligned)
    assert plan.vec == dk.load_width(aligned, L) == (4 if aligned and L >= 4 else 1)
    assert plan.group & (plan.group - 1) == 0 and 1 <= plan.group <= dk.THREADS
    nv = L // plan.vec
    assert plan.chunk >= 1 and plan.chunk * plan.split >= nv > plan.chunk * (plan.split - 1)
    # every limb of a row once, every thread at most MAX_PASSES unrolled passes
    assert (row_reads(plan, L) == 1).all()
    assert -(-plan.chunk // (plan.group * dk.UNROLL)) <= dk.MAX_PASSES
    # the grid within the card's limits, and every task handed out once
    assert plan.blocks <= dk.H100_SMS * dk.SM_THREADS // dk.THREADS  # far below gridDim.x's limit
    assert (plan.blocks >= 1) == (rows > 0)  # no rows, no launch
    tasks = rows * plan.split
    if 0 < tasks <= 2**23:
        assert (task_visits(plan, rows) == 1).all()
    # a row is one task unless it is long or the rows are too few to fill the card
    if plan.split > 1:
        long_rows = nv > dk.MAX_PASSES * dk.UNROLL * plan.group
        assert long_rows or rows * plan.group < dk.H100_SMS * dk.SM_THREADS


@pytest.mark.parametrize("rows,L,sms,per_sm",
                         [(2**21, 384, 132, 6), (512, 98304, 114, 8), (1, 9, 1, 1)])
def test_decipher_plan_grid_follows_the_card(rows, L, sms, per_sm):
    """The grid is what the card holds at once, for the SMs and the
    occupancy the wrapper reads off the card; the mapping does not move."""
    plan = dk.decipher_plan(rows, L, True, sms, per_sm)
    assert plan.blocks == min(-(-rows * plan.split // (dk.THREADS // plan.group)), sms * per_sm)
    assert (task_visits(plan, rows) == 1).all()


def test_decipher_plan_at_the_paths_shapes():
    """The mappings the paths take: sub-warp groups at 9 limbs, a warp a row
    at the round trip's sum, block-wide tasks cut across the u32 product's
    rows and the u64's one row."""
    assert dk.decipher_plan(2**21, 9, False)[:3] == (1, 4, 1)
    assert dk.decipher_plan(2**21, 384, True)[:3] == (4, 32, 1)
    assert dk.decipher_plan(512, 98304, True)[:3] == (4, 256, 12)
    assert dk.decipher_plan(1, 3145728, True)[:3] == (4, 256, 1056)
    with pytest.raises(ValueError):
        dk.decipher_plan(4, 0, True)


def base(rows, width):
    return torch.arange(rows * width, dtype=torch.int32).reshape(rows, width)


@pytest.mark.parametrize("name,make,stride", [
    ("contiguous", lambda: base(6, 9), 9),
    ("no batch", lambda: base(1, 9)[0], 9),
    ("rows of a wider row", lambda: base(6, 12)[:, 3:12], 12),
    ("every other row", lambda: base(6, 9)[::2], 18),
    ("batch of two dims", lambda: base(12, 9).reshape(3, 4, 9), 9),
    ("sliced inner batch", lambda: base(12, 9).reshape(3, 4, 9)[:, :2], None),
    ("permuted batch", lambda: base(12, 9).reshape(3, 4, 9).transpose(0, 1), None),
    ("one row broadcast", lambda: base(1, 9).expand(5, 9), 0),
    ("size-1 dims", lambda: base(6, 9).reshape(1, 6, 1, 9), 9),
])
def test_row_stride_of_views(name, make, stride):
    """D1 reads a batch in place wherever its rows lie one stride apart;
    a batch without one stride is copied to a contiguous tensor, of stride
    L, which is the same limbs."""
    c = make()
    assert dk._row_stride(c) == stride
    w = torch.ones(c.shape[-1], dtype=torch.int32)
    got, got_w, got_stride = dk._operands(c, w)
    assert got_w is w or got_w.data_ptr() == w.data_ptr()
    if stride is None:
        assert got.is_contiguous() and got_stride == c.shape[-1]
    else:
        assert got is c and got_stride == stride
    assert torch.equal(got, c)
    assert torch.equal(tpoly.decipher_bits(c, w), tpoly.decipher_bits_plain(c.contiguous(), w))


def test_layouts_d1_does_not_take():
    """Layouts D1 does not read as they are become ones it reads: limbs
    that are not contiguous are copied, a mask that broadcasts is written
    out at the row's width.  Another dtype, a mask of more than one row or
    on another device raises."""
    c = base(6, 9)
    w = torch.ones(9, dtype=torch.int32)
    assert dk._operands(c, w)[0] is c
    ct, wt, stride = dk._operands(c.t(), torch.ones(6, dtype=torch.int32))  # limbs not contiguous
    assert ct.is_contiguous() and stride == 6 and torch.equal(ct, c.t())
    _, wb, _ = dk._operands(c, w[:1])  # a mask that broadcasts
    assert tuple(wb.shape) == (9,) and torch.equal(wb.contiguous(), w)
    _, w0, _ = dk._operands(c, torch.tensor(1, dtype=torch.int32))
    assert tuple(w0.shape) == (9,)
    none, _, _ = dk._operands(base(6, 0), torch.ones(0, dtype=torch.int32))
    assert tuple(none.shape) == (6, 0)
    with pytest.raises(TypeError):
        dk._operands(c.to(torch.int64), w)
    with pytest.raises(TypeError):
        dk._operands(c, w.to(torch.int64))
    with pytest.raises(ValueError):
        dk._operands(c, w.reshape(1, 9))
    with pytest.raises(ValueError):
        dk._operands(c, w.to("meta"))
    with pytest.raises(ValueError):
        dk._operands(torch.tensor(3, dtype=torch.int32), w)
    with pytest.raises(RuntimeError):
        dk._operands(c, w[:4])


def test_decipher_off_the_card_is_the_torch_expression():
    """The wrapper launches only for a CUDA tensor: the CPU and ``meta``
    devices get the torch expression and count no launch."""
    rng = np.random.default_rng(3)
    c = tpoly.from_numpy(rng.integers(0, 2**32, size=(5, 33), dtype=np.uint32), "cpu")
    w = tpoly.from_numpy(rng.integers(0, 2**32, size=33, dtype=np.uint32), "cpu")
    before = counters["D1"]
    assert torch.equal(dk.decipher(c, w), tpoly.decipher_bits_plain(c, w))
    out = dk.decipher(c.to("meta"), w.to("meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (5,)
    assert counters["D1"] == before
