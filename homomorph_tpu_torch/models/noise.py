"""Exact worst-case noise-degree bounds for the shipped circuits.

Decryption of ``C = S*q + e`` computes ``(C mod S)(0) = (e mod S)(0)``;
it equals the plaintext unconditionally iff ``deg e < d``.  Beyond that
envelope the result is ``a(0)*S(0) ^ e'(0)`` (with ``e = a*S ^ e'``), so
correctness degenerates to a property of the KEY: keys with ``S(0) = 0``
(half the keyspace) decrypt ANY circuit correctly, keys with ``S(0) = 1``
return garbage - verified empirically in tests/test_noise_bounds.py
(3/3 keys with S(0)=0 decrypt a beyond-envelope u8 product, 0/3 with
S(0)=1).  A correctness guarantee must therefore hold for EVERY key,
i.e. enforce ``deg e < d``.

Noise composes through the SAME polynomial circuit as the ciphertexts
(XOR -> polynomial add, AND -> carry-less mul), so the worst-case noise
degree of a circuit follows from two exact rules on degrees:
``deg(a*b) = deg a + deg b`` (GF(2) leading terms are 1, never cancel)
and ``deg(a^b) <= max(deg a, deg b)`` (equality in the worst case).
This module runs the circuits' own recurrences on integer degrees -
a sound (no-cancellation) upper bound, computed in microseconds for any
width.  Fresh-ciphertext noise ``X * sum_{i in U} R_i + x`` has degree
at most ``delta + 1`` (keygen forces ``deg R_i = delta`` exactly).

Consequence for the reference's published constants
(src/impls/numbers.rs:27-50): ``MIN_D_OVER_DELTA = 21`` (addition) and
``64`` (multiplication) are NOT sufficient - e.g. u8 multiplication at
``d = 64*delta`` has worst-case noise degree ``~105*delta`` and fails on
every ``S(0)=1`` key (measured).  The checked API here therefore
validates width-aware exact bounds via ``requirement_for`` while keeping
the reference's constants as the class-level defaults for parity.
"""

from __future__ import annotations

import functools

__all__ = [
    "fresh_noise_degree",
    "add_noise_degree",
    "mul_noise_degree",
    "mul_ref_noise_degree",
    "sum_noise_degree",
    "chained_sum_noise_degree",
    "popcount_noise_degree",
    "compare_noise_degree",
    "eq_noise_degree",
    "min_max_noise_degree",
    "div_noise_degree",
    "required_ratio",
    "add_noise_seeded",
    "mul_noise_seeded",
    "mul_ref_noise_seeded",
    "compare_noise_seeded",
    "eq_noise_seeded",
    "min_max_noise_seeded",
    "sum_noise_seeded",
    "popcount_noise_seeded",
]


def fresh_noise_degree(delta: int) -> int:
    """Worst-case noise degree of a fresh ciphertext: ``delta + 1``."""
    return delta + 1


def add_noise_seeded(
    n: int, na: int, nb: int, c0: int | None = None
) -> int:
    """Ripple-carry adder replay on OPERAND noise seeds ``na``/``nb``
    (normalized delta=1 units - cipher.FRESH_NOISE for fresh operands).

    Mirrors the majority recurrence ``c' = g ^ x*c`` (circuits.add,
    round 5): deg x = max(na, nb), deg g = na + nb,
    deg c_{i+1} = max(g, x + deg c_i).  ``c0`` seeds the carry chain
    (``None`` = trivial zero).  This is what the checked API evaluates
    per operand pair, so the envelope stays sound under COMPOSITION."""
    x = max(na, nb)
    g = na + nb
    c = c0
    out = max(x, c or 0)
    for _ in range(n - 1):
        c = g if c is None else max(g, x + c)
        out = max(out, x, c)
    return out


def add_noise_degree(n: int, delta: int, carry_in: bool = False) -> int:
    """Ripple-carry adder (circuits.add / common.rs:37-64) on fresh inputs
    (seeded replay: :func:`add_noise_seeded`).

    carry-in: a trivial one() has degree 0, but sub() feeds c0 = one
    (deg 0); model worst case as a fresh bit.
    """
    D0 = fresh_noise_degree(delta)
    return add_noise_seeded(n, D0, D0, c0=D0 if carry_in else None)


def mul_noise_degree(n: int, delta: int, signed: bool = False) -> int:
    """Carry-save tree multiplier (circuits.mul_unsigned) on fresh inputs.

    Exact replay of the SAME static plan the circuit executes
    (models/csaplan.py) on integer degrees, followed by the final
    ripple-carry add's per-lane recurrence (Baugh-Wooley sign flips are
    XORs with the trivial one - degree-free).  Each full adder's carry is
    ``x*y ^ (x^y)*z``: degree <= the sum of its two largest inputs; sums
    are affine.  The result grows polynomially with width instead of the
    reference circuit's exponential blowup (mul_ref_noise_degree):

    ========  ============  ====================
    width     tree (this)   reference circuit
    ========  ============  ====================
    u8        64            152
    u16       416           19,348
    u32       2,384         437,300,308
    u64       13,372        3.9e17
    ========  ============  ====================

    (values at delta=1, round-5 majority-form ripple; round 4's m-form
    ripple gave 148/1,012/5,872/33,376), making u16..u64 products
    reachable through the checked API at representable ``d``.

    Below ``TREE_MIN_WIDTH`` (= 4) the bounds tie and the reference
    accumulation runs; this function returns the bound of whichever
    circuit actually runs.
    """
    D0 = fresh_noise_degree(delta)
    return mul_noise_seeded(n, D0, D0, signed)


def mul_noise_seeded(n: int, na: int, nb: int, signed: bool = False) -> int:
    """Width-dispatched multiplier replay on operand noise seeds (the
    partial products seed at ``na + nb``); same circuit dispatch as
    :func:`mul_noise_degree`."""
    from .csaplan import TREE_MIN_WIDTH, csa_plan

    if n < TREE_MIN_WIDTH:
        return mul_ref_noise_seeded(n, na, nb)
    pp = na + nb
    deg = {i * n + j: pp for i in range(n) for j in range(n - i)}
    return _replay_csa(csa_plan(n), deg)


def _replay_csa(plan, deg: dict) -> int:
    """Exact degree replay of a carry-save plan (models/csaplan.py) plus
    its final two-row ripple add, on pre-seeded initial degrees.

    Shared by the multiplier (pp degrees 2*D0), the N-ary sum and
    popcount (fresh degrees D0) - the replay and the executed circuit
    consume the SAME plan object, so a plan change cannot silently
    diverge from the published bounds.
    """
    n = plan.n
    for level in plan.levels:
        for op in level:
            if op.z is None:
                dx, dy = deg[op.x], deg[op.y]
                deg[op.sum] = max(dx, dy)
                carry = dx + dy
            else:
                dx, dy, dz = deg[op.x], deg[op.y], deg[op.z]
                deg[op.sum] = max(dx, dy, dz)
                carry = sum(sorted((dx, dy, dz))[-2:])
            if op.carry is not None:
                deg[op.carry] = carry
    # final ripple add of the two remaining rows (circuits._ripple_add_rows
    # majority recurrence c' = g ^ x*c with x = a ^ b; the last carry is
    # dropped - wrapping).  None-aware exactly like the circuit: a
    # single-row column has g = a*0 = 0 (no max(g, .) term, chain step is
    # the bare x*c) and an empty column zeroes the carry outright.
    A = [deg[c[0]] if len(c) > 0 else None for c in plan.final_cols]
    B = [deg[c[1]] if len(c) > 1 else None for c in plan.final_cols]
    worst = 0
    carry: int | None = None
    for i in range(n):
        a, b = A[i], B[i]
        if a is None and b is not None:
            a, b = b, a
        x = a if b is None else max(a, b)  # None when both rows empty
        worst = max(worst, x or 0, carry or 0)  # out_i = x_i ^ c_i
        if i + 1 < n:
            g = None if (a is None or b is None) else a + b
            if x is None:
                carry = None
            elif carry is None:
                carry = g
            else:
                t = x + carry
                carry = t if g is None else max(g, t)
    return worst


def sum_noise_degree(n: int, delta: int, k: int) -> int:
    """N-ary wrapping sum (circuits.sum_many) of ``k`` fresh operands of
    width ``n``: exact replay of the shared sum plan.  For ``k <= 2`` the
    circuit dispatches to the two-operand adder, and so does this bound.
    Chained binary adds stack multiplicatively (folding add over k
    operands replays far higher); the tree keeps the growth near-linear
    in ``k``."""
    from .csaplan import sum_plan

    if k < 1:
        raise ValueError("operand count must be positive")
    if k == 1:
        return fresh_noise_degree(delta)
    if k == 2:
        return add_noise_degree(n, delta)
    D0 = fresh_noise_degree(delta)
    return sum_noise_seeded(n, [D0] * k)


def sum_noise_seeded(n: int, noises: "list[int]") -> int:
    """N-ary sum replay on per-operand noise seeds."""
    from .csaplan import sum_plan

    k = len(noises)
    if k == 1:
        return noises[0]
    if k == 2:
        return add_noise_seeded(n, noises[0], noises[1])
    deg = {o * n + j: noises[o] for o in range(k) for j in range(n)}
    return _replay_csa(sum_plan(n, k), deg)


def chained_sum_noise_degree(n: int, delta: int, k: int) -> int:
    """Worst noise degree of folding the two-operand adder over ``k``
    fresh operands (the alternative sum_many replaces): each fold reruns
    the ripple recurrence with one accumulated operand.  Documentation /
    comparison aid."""
    D0 = fresh_noise_degree(delta)
    acc = D0  # uniform per-lane worst bound of the accumulator
    for _ in range(k - 1):
        acc = add_noise_seeded(n, acc, D0)
    return acc


def popcount_noise_degree(n: int, delta: int) -> int:
    """Population count (circuits.popcount): exact replay of the
    popcount plan on fresh input degrees."""
    return popcount_noise_seeded(n, fresh_noise_degree(delta))


def popcount_noise_seeded(n: int, na: int) -> int:
    """Population-count replay on an operand noise seed."""
    from .csaplan import popcount_plan

    if n == 1:
        return na
    deg = {j: na for j in range(n)}
    return _replay_csa(popcount_plan(n), deg)


def mul_ref_noise_degree(n: int, delta: int, signed: bool = False) -> int:
    """The REFERENCE column multiplier (circuits.mul_unsigned_ref /
    common.rs:66-113) on fresh inputs: exact replay of
    ``_mul_accumulate``'s bookkeeping on integer degrees (Baugh-Wooley
    sign flips don't change degrees).  Kept for the parity oracle; the
    shipped default is the carry-save tree (mul_noise_degree)."""
    D0 = fresh_noise_degree(delta)
    return mul_ref_noise_seeded(n, D0, D0)


def mul_ref_noise_seeded(n: int, na: int, nb: int) -> int:
    """Reference column accumulation replay on operand noise seeds."""
    pp = na + nb  # every partial product a_i * b_j
    result = [0] * n  # degree 0 = the zero/constant lane
    carries: list[int] = []
    offset = 0
    for i in range(n):
        current_length = i * (i + 1) // 2
        for _ in range(i + 1):
            if i + 1 < n:
                carries.append(pp + result[i])
            result[i] = max(result[i], pp)
        for j in range(current_length):
            if i + 1 < n:
                carries.append(result[i] + carries[offset + j])
            result[i] = max(result[i], carries[offset + j])
        offset += current_length
    return max(result)


def compare_noise_degree(n: int, delta: int) -> int:
    """lt/gt/le/ge: the pairwise tree comparator (circuits._lt_tree).

    Exact replay of the tree recurrence on per-group degrees: lane seeds
    ``lt_i = ~a_i * b_i`` (2*D0) and affine ``eq_i`` (D0); each merge is
    ``lt' = lt_hi ^ eq_hi * lt_lo``, ``eq' = eq_hi * eq_lo``.  For
    power-of-two widths this is ``(n+1)*(delta+1)`` - ~3x tighter than
    the borrow-chain comparator it replaced (u8: 19 vs 49).
    """
    D0 = fresh_noise_degree(delta)
    return compare_noise_seeded(n, D0, D0)


def compare_noise_seeded(n: int, na: int, nb: int) -> int:
    """Tree comparator replay on operand noise seeds: lane seeds
    ``lt_i = ~a_i * b_i`` (na + nb) and affine ``eq_i`` (max)."""
    lt = [na + nb] * n
    eq = [max(na, nb)] * n
    while len(lt) > 1:
        half = len(lt) // 2
        nlt = [max(lt[2 * j + 1], eq[2 * j + 1] + lt[2 * j]) for j in range(half)]
        neq = [eq[2 * j + 1] + eq[2 * j] for j in range(half)]
        if len(lt) % 2:
            nlt.append(lt[-1])
            neq.append(eq[-1])
        lt, eq = nlt, neq
    return lt[0]


def eq_noise_degree(n: int, delta: int) -> int:
    """Equality: XNOR lanes (affine) + AND tree = product of n lanes."""
    return n * fresh_noise_degree(delta)


def eq_noise_seeded(n: int, na: int, nb: int) -> int:
    """Equality replay on operand noise seeds."""
    return n * max(na, nb)


def min_max_noise_degree(n: int, delta: int) -> int:
    """min/max (circuits.min_/max_): one borrow-chain comparison feeding a
    mux ``out = b ^ cond*(a^b)`` - one more AND of the compare result with
    a fresh-degree lane."""
    D0 = fresh_noise_degree(delta)
    return min_max_noise_seeded(n, D0, D0)


def min_max_noise_seeded(n: int, na: int, nb: int) -> int:
    """min/max replay on operand noise seeds: compare + the mux's AND of
    the compare bit with an operand lane."""
    return compare_noise_seeded(n, na, nb) + max(na, nb)


def div_noise_degree(n: int, delta: int) -> int:
    """Why there is NO HomomorphicDivision: exact replay of the best
    division circuit expressible from the shipped primitives.

    Restoring long division - n sequential steps, each a full-width tree
    comparison (``ge = shifted-out-bit OR NOT lt(R, D)``) feeding a
    conditional subtract (``R' = R ^ ge*(R ^ (R - D))``).  The quotient
    bit is data-dependent, so every step MULTIPLIES the remainder's
    degree by the comparison's (~n*deg per step) - doubly-exponential
    growth that no tree trick can flatten (the comparison's output
    necessarily carries the product of the lane degrees it inspected):

    ========  =====================================
    width     required d/delta (replay, delta=1)
    ========  =====================================
    4         2,287
    8         466,937,539
    16        ~8.0e21
    ========  =====================================

    ``d`` is a u16 (reference src/lib.rs Parameters), so u8 division
    exceeds the representable parameter field by about four orders of
    magnitude (and its ciphertext degree would be ~5e8 - petabyte
    ciphertexts - even under an S(0)=0 key where correctness holds
    beyond the envelope; NOISE.md section 6).  Documentation-grade:
    this replay exists to pin the impossibility, not to gate a circuit.
    """
    D0 = fresh_noise_degree(delta)
    r = [0] * n  # remainder starts as trivial zeros (degree 0)
    worst = 0
    for _step in range(n):
        t = r[-1]  # shifted-out top bit joins the >= decision via OR
        r = [D0] + r[:-1]  # shift left; LSB = next fresh dividend bit
        # tree compare lt(R, D): seeds lt_i = ~r_i*d_i, eq_i affine
        lt = [r[i] + D0 for i in range(n)]
        eq = [max(r[i], D0) for i in range(n)]
        while len(lt) > 1:
            half = len(lt) // 2
            nlt = [max(lt[2 * j + 1], eq[2 * j + 1] + lt[2 * j]) for j in range(half)]
            neq = [eq[2 * j + 1] + eq[2 * j] for j in range(half)]
            if len(lt) % 2:
                nlt.append(lt[-1])
                neq.append(eq[-1])
            lt, eq = nlt, neq
        ge = t + lt[0]  # OR(t, ~lt): a*b term dominates; NOT is affine
        # R - D: ripple subtract (add of ~D with trivial carry-in one)
        sub = []
        c: int | None = 0  # carry-in one(): degree 0
        for i in range(n):
            x = max(r[i], D0)
            sub.append(max(x, c))
            if i + 1 < n:
                g = r[i] + D0
                c = max(g, x + c)
        # conditional restore: r_i' = r_i ^ ge*(r_i ^ sub_i)
        r = [max(r[i], ge + max(r[i], sub[i])) for i in range(n)]
        worst = max(worst, ge, max(r))
    return worst


def required_ratio(noise_at_delta1: int) -> int:
    """Convert a noise bound into a sound ``d/delta`` requirement.

    The checked API validates ``d >= r * delta``.  With
    ``D(delta) = M*(delta+1) (+ c)`` and ``r = D(1) + 1``:
    ``r*delta >= D(delta) + 1`` holds for every ``delta >= 1``
    (delta=1 is the binding case), guaranteeing ``deg e < d``.
    """
    return noise_at_delta1 + 1
