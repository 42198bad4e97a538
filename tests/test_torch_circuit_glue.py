"""The glue of the carry-save tree and the ripples as plans and programs
(``homomorph_tpu_torch.models.circuit_kernels``), through the kernels' plain
versions on the CPU.

The plan replaces the per-op glue (``circuits._csa_accumulate_per_op``,
``add_per_op``): both run here on the same input bits, at odd and unequal
widths, and must give the same limbs, lane widths, bounds and noises.  The
port's circuits are held against the JAX package's on the same ciphertexts.
The plan must key its clmul groups as the per-op glue did, so every product
of a circuit has the same shape in the same order (K1, R1 and R2 launch as
before: 39 products at u16, 85 at u32).  The kernels C1-C3 themselves are
held against the same plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 3b).

Every comparison is bit for bit (tolerance 0).  Inputs come from numpy
generators with fixed seeds.
"""

from collections import OrderedDict

import jax
import numpy as np
import pytest
import torch

import homomorph_tpu as hm
import homomorph_tpu_torch as ht
from homomorph_tpu.models import circuits as jcirc
from homomorph_tpu_torch.experiments import exp_circuit
from homomorph_tpu_torch.gf2 import kernels as k
from homomorph_tpu_torch.gf2 import poly as gf2
from homomorph_tpu_torch.models import circuit_kernels as ck
from homomorph_tpu_torch.models import circuits, csaplan
from homomorph_tpu_torch.models.compiled import _derive_meta
from homomorph_tpu_torch.models.numbers import (
    HomomorphicAddition,
    HomomorphicMultiplication,
    HomomorphicPopCount,
    HomomorphicSubtraction,
)

PARAMS = (128, 64, 1, 64)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_bit(rng, batch, width, bound):
    """A bit of ``width`` limbs whose degree is at most ``bound``."""
    words = rng.integers(0, 2**32, size=batch + (width,), dtype=np.uint32)
    top = bound // 32
    words[..., top + 1:] = 0
    words[..., top] &= np.uint32((1 << (bound % 32 + 1)) - 1)
    return gf2.from_numpy(words, "cpu")


def input_bits(rng, ids, batch):
    """Input bits of odd and unequal widths: bound ``b``, width at least
    ``limbs_for(b)`` and up to two limbs more."""
    bits = {}
    for bid in ids:
        bound = int(rng.integers(1, 150))
        width = gf2.limbs_for(bound) + int(rng.integers(0, 3))
        bits[bid] = ht.CipheredBit(random_bit(rng, batch, width, bound), bound,
                                   noise=int(rng.integers(1, 9)))
    return bits


def plan_of(kind, n):
    return {"mul": lambda: csaplan.csa_plan(n), "sum": lambda: csaplan.sum_plan(n, 3),
            "popcount": lambda: csaplan.popcount_plan(n)}[kind]()


def input_ids(kind, n):
    return {"mul": [i * n + j for i in range(n) for j in range(n - i)],
            "sum": list(range(3 * n)), "popcount": list(range(n))}[kind]


def same_lanes(got: ck.Lanes, want: ck.Lanes):
    assert tuple(got.limbs.shape) == tuple(want.limbs.shape)
    assert torch.equal(got.limbs, want.limbs)
    assert got.lanes == want.lanes


@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("kind", ["mul", "sum", "popcount"])
def test_plan_matches_the_per_op_glue(kind, n):
    """The tree and its ripple from the plan, against the per-op glue:
    limbs, each lane's width, bound and noise."""
    rng = np.random.default_rng(1000 * n + len(kind))
    batch = (2,)
    bits = input_bits(rng, input_ids(kind, n), batch)
    plan = plan_of(kind, n)
    same_lanes(circuits._csa_accumulate(dict(bits), plan, batch),
               circuits._csa_accumulate_per_op(dict(bits), plan, batch))


@pytest.mark.parametrize("n", [3, 5, 9, 16])
@pytest.mark.parametrize("pattern", ["two-row", "mixed"])
def test_ripple_matches_the_per_op_glue(n, pattern):
    """The two-row ripple with single-row and empty columns (``None``
    lanes): a carry that starts late, stops at an empty column, or runs
    through a column with no ``g``."""
    rng = np.random.default_rng(n * 7 + len(pattern))
    batch = (3,)
    A, B = [], []
    for i in range(n):
        rows = 2 if pattern == "two-row" else int(rng.integers(0, 3))
        bits = list(input_bits(rng, range(rows), batch).values())
        A.append(bits[0] if rows > 0 else None)
        B.append(bits[1] if rows > 1 else None)
    if pattern == "mixed":  # both orders of a single-row column
        A[1], B[1] = None, A[1] or B[1]
    same_lanes(circuits._ripple_add_rows(A, B, batch),
               ck.Lanes.stack(circuits._ripple_add_rows_per_op(A, B, batch)))


@pytest.mark.parametrize("carry", ["none", "one", "bit"])
@pytest.mark.parametrize("La,Lb,n", [(3, 3, 8), (5, 2, 9), (2, 7, 16)])
def test_add_matches_the_per_op_glue(La, Lb, n, carry):
    """``add`` from its plan against the per-op ripple, at unequal widths and
    with a carry in (the trivial one of ``sub``, or a ciphered bit)."""
    rng = np.random.default_rng(La * 100 + Lb * 10 + n)
    batch = (4,)
    ba, bb = 32 * La - 5, 32 * Lb - 17
    a = ht.Ciphered(torch.stack([random_bit(rng, batch, La, ba) for _ in range(n)], -2), ba,
                    ht.U8, noise=3)
    b = ht.Ciphered(torch.stack([random_bit(rng, batch, Lb, bb) for _ in range(n)], -2), bb,
                    ht.U8, noise=5)
    cin = {"none": None, "one": ht.CipheredBit.one(batch, device="cpu"),
           "bit": ht.CipheredBit(random_bit(rng, batch, 2, 40), 40, noise=2)}[carry]
    got, want = circuits.add(a, b, cin), circuits.add_per_op(a, b, cin)
    assert tuple(got.limbs.shape) == tuple(want.limbs.shape)
    assert torch.equal(got.limbs, want.limbs)
    assert (got.bound, got.noise) == (want.bound, want.noise)


@pytest.mark.parametrize("carry", [False, True])
def test_add_lanes_matches_the_adder(carry):
    """``add_lanes`` runs the two-row ripple: its lanes stacked equal the
    per-op adder's sum, each lane at the per-op adder's own width."""
    rng = np.random.default_rng(31 + carry)
    batch = (3,)
    a = ht.Ciphered(torch.stack([random_bit(rng, batch, 3, 70) for _ in range(8)], -2), 70,
                    ht.U8, noise=2)
    b = ht.Ciphered(torch.stack([random_bit(rng, batch, 3, 90) for _ in range(8)], -2), 90,
                    ht.U8, noise=2)
    cin = ht.CipheredBit.one(batch, device="cpu") if carry else None
    lanes = circuits.add_lanes(a.bits(), b.bits(), cin)
    want = circuits.add_per_op(a, b, cin)
    got = ht.Ciphered.new_from_raw(lanes, ht.U8)
    assert torch.equal(got.limbs, want.limbs) and (got.bound, got.noise) == (want.bound,
                                                                               want.noise)


# -- the JAX package ---------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    jctx = hm.Context(hm.Parameters(*PARAMS), source=hm.ThreefrySource(5))
    jctx.generate_secret_key()
    jctx.generate_public_key()
    sk, pk = ht.keys.keys_from_numpy(
        np.asarray(jctx.get_secret_key()._host), np.asarray(jctx.get_public_key()._host),
        device="cpu")
    tctx = ht.Context(ht.Parameters(*PARAMS), device="cpu")
    tctx.set_secret_key(sk)
    tctx.set_public_key(pk)
    return jctx, tctx


def encrypt_both(jctx, vals, name):
    jc = jctx.encrypt(vals, getattr(hm, name), batch=True)
    return jc, ht.Ciphered.from_bytes(jc.to_bytes(), getattr(ht, name), device="cpu")


def same_cipher(tc, jc):
    jl = np.asarray(jax.device_get(jc.limbs), dtype=np.uint32)
    assert gf2.to_numpy(tc.limbs).shape == jl.shape
    assert np.array_equal(gf2.to_numpy(tc.limbs), jl)
    assert (tc.bound, tc.noise, tc.zero_lanes, len(tc)) == (jc.bound, jc.noise, jc.zero_lanes,
                                                           len(jc))


OPS = {
    "mul_unsigned": lambda m, a, b: m.mul_unsigned(a[0], b[0]),
    "mul_signed": lambda m, a, b: m.mul_signed(a[0], b[0]),
    "sum_many": lambda m, a, b: m.sum_many([a[0], b[0], a[1]]),
    "popcount": lambda m, a, b: m.popcount(a[0]),
    "add": lambda m, a, b: m.add(a[0], b[0]),
    "sub": lambda m, a, b: m.sub(a[0], b[0]),
}


@pytest.mark.parametrize("name", list(OPS))
@pytest.mark.parametrize("desc", ["U8", "U16"])
def test_circuits_match_jax(pair, name, desc):
    """The port's circuits, run from their plans, equal the JAX package's
    limb for limb on the same ciphertexts (numpy-seeded plaintexts)."""
    if desc == "U16" and name == "mul_signed":
        desc = "I16"
    jctx, tctx = pair
    bits = 16 if "16" in desc else 8
    rng = np.random.default_rng(bits + len(name))
    lo, hi = (-(2 ** (bits - 1)), 2 ** (bits - 1)) if desc.startswith("I") else (0, 2 ** bits)
    vals = [rng.integers(lo, hi, size=3).tolist() for _ in range(3)]
    ja, ta = zip(*(encrypt_both(jctx, v, desc) for v in vals[:2]))
    jb, tb = zip(*(encrypt_both(jctx, v, desc) for v in vals[2:]))
    same_cipher(OPS[name](circuits, ta, tb), OPS[name](jcirc, ja, jb))


# -- the launches ------------------------------------------------------------


def products(fn):
    shapes = []
    rows = k.clmul_rows

    def spy(af, bf):
        shapes.append((af.shape[0], af.shape[1], bf.shape[1]))
        return rows(af, bf)

    k.clmul_rows = spy
    try:
        fn()
    finally:
        k.clmul_rows = rows
    return shapes


def per_op(fn):
    saved = circuits._csa_accumulate, circuits.add
    circuits._csa_accumulate, circuits.add = circuits._csa_accumulate_per_op, circuits.add_per_op
    try:
        return fn()
    finally:
        circuits._csa_accumulate, circuits.add = saved


META_CASES = {
    "u16 product": (HomomorphicMultiplication, 1024, ht.U16, (512, 16), 39),
    "u32 product": (HomomorphicMultiplication, 2432, ht.U32, (8, 32), 85),
    "u64 product": (HomomorphicMultiplication, 13440, ht.U64, (1, 64), 166),
    "u32 add": (HomomorphicAddition, 128, ht.U32, (2048, 32), 31),
    "u32 sub": (HomomorphicSubtraction, 128, ht.U32, (64, 32), 32),
    "u32 popcount": (HomomorphicPopCount, 1024, ht.U32, (64, 32), None),
}


@pytest.mark.parametrize("case", list(META_CASES))
def test_products_keep_their_shapes_and_order(case):
    """The plan groups each level's products as ``_batched_clmul_pairs``
    did: the same clmuls, of the same shapes, in the same order (so the same
    K1, R1 and R2 launches); 39 at u16, 85 at u32, 166 at u64, 31 at the
    u32 add."""
    op, d, desc, shape, count = META_CASES[case]
    L = gf2.limbs_for(d + 128)
    shapes = [shape + (L,)] * (1 if op is HomomorphicPopCount else 2)

    def run():
        return _derive_meta(op.unsafe_apply, d + 128, desc, *shapes)

    got, want = products(run), per_op(lambda: products(run))
    assert got == want
    if count is not None:
        assert len(got) == count


@pytest.mark.parametrize("case", list(META_CASES))
def test_derived_metadata_is_unchanged(case):
    """``_derive_meta`` (the compiled pipelines' metadata, on the meta
    device) gives what the per-op glue gave."""
    op, d, desc, shape, _ = META_CASES[case]
    L = gf2.limbs_for(d + 128)
    shapes = [shape + (L,)] * (1 if op is HomomorphicPopCount else 2)
    got = _derive_meta(op.unsafe_apply, d + 128, desc, *shapes)
    assert got == per_op(lambda: _derive_meta(op.unsafe_apply, d + 128, desc, *shapes))


@pytest.mark.parametrize("n_ops,cap", [(0, 240), (1, 240), (240, 240), (241, 240), (692, 240),
                                       (692, 600), (1, 1), (5, 1), (17, 4)])
def test_launch_chunks_keep_every_op_once(n_ops, cap):
    chunks = ck.launch_chunks(n_ops, cap)
    ops = [i for start, stop in chunks for i in range(start, stop)]
    assert ops == list(range(n_ops))
    assert all(0 < stop - start <= cap for start, stop in chunks)
    assert len(chunks) == -(-n_ops // cap)


def test_a_level_split_across_launches_matches_one(monkeypatch):
    """The u32 product's first level (175 ops) run in launches of 7 ops
    gives every tensor limb for limb as one launch does."""
    rec = [r for r in exp_circuit.recorded_programs("u32") if r["kernel"] == "csa_level_in"][0]
    assert rec["prog"].shape[0] == 175
    one = exp_circuit.slot_tensors(rec["extents"], "cpu", 3)
    split = [t.clone() for t in one]
    ck.csa_level_in(rec["prog"], one, rec["rows"])
    monkeypatch.setattr(ck, "CSA_IN", ck.CSA_IN._replace(ops=7))
    ck.csa_level_in(rec["prog"], split, rec["rows"])
    assert all(torch.equal(a, b) for a, b in zip(one, split))


@pytest.mark.parametrize("path", ["u16", "u32", "u64", "add"])
def test_the_paths_programs_fit_their_launches(path):
    """Every program of a path: the u32 product's levels take one launch of
    C1 and of C2 each, the u64 product's first level (692 ops) three of C1
    and two of C2; every C3 program is one op; C1's ops write at most five
    destinations from at most three sources."""
    recs = exp_circuit.recorded_programs(path)
    for rec in recs:
        spec = exp_circuit.SPECS[rec["kernel"]]
        assert rec["prog"].shape == (rec["prog"].shape[0], spec.fields)
        if rec["kernel"] == "ripple_step":
            assert rec["prog"].shape[0] == 1
    c1 = [r["prog"].shape[0] for r in recs if r["kernel"] == "csa_level_in"]
    c2 = [r["prog"].shape[0] for r in recs if r["kernel"] == "csa_level_out"]
    if path == "u32":
        assert max(c1) <= ck.CSA_IN.ops and max(c2) <= ck.CSA_OUT.ops
        assert c1[:7] == [175, 116, 77, 51, 33, 18, 10]
    if path == "u64":
        assert c1[0] == 692 and len(ck.launch_chunks(c1[0], ck.CSA_IN.ops)) == 3
        assert len(ck.launch_chunks(c2[0], ck.CSA_OUT.ops)) == 2


def run_stacked_add(bits, batch):
    """``run_add`` of the first five bits against the last five, each side
    padded to one width and stacked into lanes."""
    sides = []
    for side in (bits[:5], bits[5:]):
        L = max(b.num_limbs for b in side)
        sides.append((torch.stack([b.pad_to(L).limbs for b in side], -2),
                      ck.Bit(L, max(b.bound for b in side), max(b.noise for b in side))))
    (a, a_bit), (b, b_bit) = sides
    return ck.run_add(a, b, a_bit, b_bit)


RUNNERS = {
    "tree": lambda bits, batch: ck.run_tree(dict(zip(input_ids("mul", 4), bits)),
                                            csaplan.csa_plan(4), batch),
    "add": run_stacked_add,
    "ripple": lambda bits, batch: ck.run_ripple(bits[:5], bits[5:], batch),
}


@pytest.mark.parametrize("kind", list(RUNNERS))
def test_programs_are_made_once_per_rows(kind, monkeypatch):
    """Every runner's programs are made once for each row count: a second
    call at the same rows makes none, another row count makes its own from
    the same plan (the cache's key is the plan's identity)."""
    made = []
    program = ck._program
    monkeypatch.setattr(ck, "_programs", OrderedDict(), raising=False)
    monkeypatch.setattr(ck, "_program", lambda *args: made.append(args) or program(*args))
    bits = list(input_bits(np.random.default_rng(9), range(10), (2,)).values())
    run = RUNNERS[kind]
    first = run(bits, (2,))
    assert made
    made.clear()
    again = run(bits, (2,))
    assert not made and torch.equal(again.limbs, first.limbs)
    run([ht.CipheredBit(b.limbs[:1], b.bound, noise=b.noise) for b in bits], (1,))
    assert made
    (plan, _), (other, _) = ck._programs.values()
    assert other is plan


def good_program():
    """One C2 op: two sources of 3 limbs into a destination of 4."""
    t = [torch.zeros(20, dtype=torch.int32), torch.zeros(8, dtype=torch.int32)]
    prog = np.array([[0, 0, 6, 3, 0, 10, 6, 3, 1, 0, 4, 4, 3]], dtype=np.int64)
    return prog, t


BAD = {
    "int64 limbs": lambda p, t: (p, [t[0].to(torch.int64), t[1]], TypeError),
    "two devices": lambda p, t: (p, [t[0], t[1].to("meta")], ValueError),
    "program shape": lambda p, t: (p[:, :-1], t, ValueError),
    "int32 program": lambda p, t: (p.astype(np.int32), t, ValueError),
    "slot past the tensors": lambda p, t: (_set(p, 8, 2), t, ValueError),
    "negative offset": lambda p, t: (_set(p, 1, -1), t, ValueError),
    "source past its tensor": lambda p, t: (_set(p, 5, 15), t, ValueError),
    "destination past its tensor": lambda p, t: (_set(p, 11, 5), t, ValueError),
    "mask past the sources": lambda p, t: (_set(p, 12, 4), t, ValueError),
    "no tensor": lambda p, t: (p, [], ValueError),
    "prepared at other rows": lambda p, t: (ck._prepare(ck.CSA_OUT, p, 1), t, ValueError),
}


def _set(prog, col, value):
    prog = prog.copy()
    prog[0, col] = value
    return prog


def test_a_good_program_runs():
    prog, t = good_program()
    t[0][:] = torch.arange(20, dtype=torch.int32)
    ck.csa_level_out(prog, t, 2)
    # row r: limbs 0-2 of t0[6r:] ^ t0[10 + 6r:], then a zero limb
    want = [0 ^ 10, 1 ^ 11, 2 ^ 12, 0, 6 ^ 16, 7 ^ 17, 8 ^ 18, 0]
    assert t[1].tolist() == want


@pytest.mark.parametrize("case", list(BAD))
def test_the_wrappers_refuse(case):
    prog, t = good_program()
    prog, t, err = BAD[case](prog, t)
    with pytest.raises(err):
        ck.csa_level_out(prog, t, 2)


@pytest.mark.parametrize("wrapper", [ck.csa_level_in, ck.ripple_step])
def test_each_wrapper_takes_its_own_fields(wrapper):
    """A program of C2's 13 fields is refused by C1 (35) and C3 (22)."""
    prog, t = good_program()
    with pytest.raises(ValueError):
        wrapper(prog, t, 2)
    with pytest.raises(ValueError):
        wrapper(ck._prepare(ck.CSA_OUT, prog, 2), t, 2)


def test_lanes_come_back_at_their_own_widths():
    """``mul_unsigned_lanes`` returns each lane at its own width (views of
    the stacked output), as the per-op glue returned them."""
    rng = np.random.default_rng(4)
    bits = input_bits(rng, range(16), (2,))
    a, b = [bits[i] for i in range(8)], [bits[8 + i] for i in range(8)]
    got = circuits.mul_unsigned_lanes(a, b)
    want = per_op(lambda: circuits.mul_unsigned_lanes(a, b))
    assert [(g.num_limbs, g.bound, g.noise) for g in got] == [
        (w.num_limbs, w.bound, w.noise) for w in want]
    assert all(torch.equal(g.limbs, w.limbs) for g, w in zip(got, want))
