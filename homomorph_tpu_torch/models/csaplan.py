"""Static carry-save reduction plans for the tree multiplier.

A wrapping ``n x n -> n`` bit multiplier sums the partial-product matrix
``pp[i][j] = a_i * b_j`` column-wise (column ``k`` holds the ``pp[i][j]``
with ``i + j = k``; columns ``>= n`` are dropped - the reference's
wrapping semantics, src/impls/numbers/common.rs:66-113).  The reference
accumulates each column sequentially, pushing AND-carries of
carries-of-carries - ``(n-1)n(n+1)/6`` SEQUENTIAL gate evaluations whose
worst-case noise degree grows exponentially with width
(models/noise.py::mul_ref_noise_degree - u32: 4.4e8).

This module plans the TPU-native alternative: a Dadda-style carry-save
tree.  Each level applies independent 3:2 compressors (full adders) and,
where needed to break single-column drip, 2:2 compressors (half adders):

    FA:  sum = x ^ y ^ z             (affine - no degree growth)
         carry = x*y ^ (x^y)*z       (majority; degree <= two largest)
    HA:  sum = x ^ y,  carry = x*y

All compressors in a level are independent, so a level executes as ONE
batched carry-less multiply on TPU; ``O(log n)`` levels reduce the matrix
to two rows, finished by one ripple-carry add.  Both the noise degree and
the total clmul work collapse relative to the reference circuit (with the
round-5 majority-form ripple - u8: 64 vs 152 noise; u32: 2,384 vs 4.4e8
noise - and far less limb-pair work).

The plan is STATIC - a pure function of the width ``n`` - so it is
computed once on the host and shared verbatim by the circuit executor
(models/circuits.py) and the exact noise replay (models/noise.py),
guaranteeing the published requirement bounds describe the shipped
circuit.  Within a column, compressor inputs are chosen smallest-degree
first (measurably tighter worst-case degrees than largest-first).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

__all__ = ["CsaPlan", "csa_plan", "TREE_MIN_WIDTH"]

#: Width at which the carry-save tree overtakes the reference column
#: accumulation on worst-case noise degree.  With the round-5
#: majority-form final ripple (circuits.add) the tree is never worse:
#: exact replays at delta=1 tie at n=2-3 (4 vs 4, 8 vs 8) and the tree
#: strictly wins from n=4 (12 vs 16; n=8: 64 vs 152), so the reference
#: accumulation is kept only below width 4 (round 4's m-form ripple put
#: the crossover at 8).  Both the circuit (models/circuits.py) and the
#: noise bounds (models/noise.py) dispatch on this same constant, so the
#: published requirement always describes the executed circuit.
TREE_MIN_WIDTH = 4

# Normalized fresh-noise degree of one partial product: two fresh factors
# of degree 1 unit each.  All planned degrees are exact multiples of the
# true fresh degree, so the plan topology is scale-invariant.
_PP_DEG = 2


class CsaOp(NamedTuple):
    """One compressor.  ``z`` is ``None`` for a half adder.  ``carry`` is
    ``None`` when the carry falls out of column ``n-1`` (wrapping drop)."""

    x: int
    y: int
    z: int | None
    sum: int
    carry: int | None
    col: int


class CsaPlan(NamedTuple):
    n: int
    #: partial-product bit ids: pp[i][j] has id ``i*n + j`` (only i+j < n used)
    levels: tuple[tuple[CsaOp, ...], ...]
    #: per column, the <=2 bit ids left for the final ripple add
    final_cols: tuple[tuple[int, ...], ...]
    #: planned normalized degree of every bit id (documentation/replay aid)
    degrees: dict[int, int]


@functools.lru_cache(maxsize=None)
def csa_plan(n: int) -> CsaPlan:
    """Plan the reduction of the ``n``-column partial-product matrix."""
    if n < 1:
        raise ValueError("width must be positive")
    degrees: dict[int, int] = {}
    cols: list[list[int]] = [[] for _ in range(n)]
    for i in range(n):
        for j in range(n - i):  # i + j < n only; higher columns wrap away
            bit = i * n + j
            degrees[bit] = _PP_DEG
            cols[i + j].append(bit)
    return _reduce(n, cols, degrees, next_id=n * n)


@functools.lru_cache(maxsize=None)
def sum_plan(n: int, k: int) -> CsaPlan:
    """Plan the wrapping sum of ``k`` operands of width ``n``.

    Initial bits: operand ``o``'s lane ``j`` has id ``o*n + j`` in column
    ``j``, fresh degree 1 unit each.  The same carry-save machinery
    reduces the k-row matrix to two rows in ``O(log k)`` batched levels -
    for the N-ary sum op this replaces ``k-1`` chained ripple adders
    (``(k-1)*n`` sequential multiplies and multiplicative noise stacking)
    with one tree + one final add.
    """
    if n < 1 or k < 1:
        raise ValueError("width and operand count must be positive")
    degrees = {o * n + j: 1 for o in range(k) for j in range(n)}
    cols = [[o * n + j for o in range(k)] for j in range(n)]
    return _reduce(n, cols, degrees, next_id=n * k)


@functools.lru_cache(maxsize=None)
def popcount_plan(n: int) -> CsaPlan:
    """Plan ``popcount``: sum the ``n`` BIT lanes of one value as 0/1
    integers.  Initial bits: lane ``j`` has id ``j``, ALL in column 0
    (each bit contributes weight 1); carries climb into the ``log2 n``
    result columns.  Output width stays ``n`` (upper lanes are trivial
    zeros after the final add)."""
    if n < 1:
        raise ValueError("width must be positive")
    degrees = {j: 1 for j in range(n)}
    cols: list[list[int]] = [list(range(n))] + [[] for _ in range(n - 1)]
    return _reduce(n, cols, degrees, next_id=n)


def _reduce(
    n: int,
    cols: list[list[int]],
    degrees: dict[int, int],
    next_id: int,
) -> CsaPlan:
    levels: list[tuple[CsaOp, ...]] = []
    while any(len(c) > 2 for c in cols):
        ops: list[CsaOp] = []
        newcols: list[list[int]] = [[] for _ in range(n)]
        for k in range(n):
            # Smallest degrees combine together: the FA carry degree is the
            # sum of its two largest inputs, so pairing small with small
            # keeps the worst-case envelope tight (simulated: ~40% tighter
            # than largest-first at n=32).  Tie-break on id for determinism.
            c = sorted(cols[k], key=lambda b: (degrees[b], b))
            i = 0
            while len(c) - i >= 3:
                x, y, z = c[i], c[i + 1], c[i + 2]
                i += 3
                s, cy = next_id, next_id + 1
                next_id += 2
                dx, dy, dz = degrees[x], degrees[y], degrees[z]
                degrees[s] = max(dx, dy, dz)
                degrees[cy] = sum(sorted((dx, dy, dz))[-2:])
                if k + 1 < n:
                    ops.append(CsaOp(x, y, z, s, cy, k))
                    newcols[k + 1].append(cy)
                else:
                    ops.append(CsaOp(x, y, z, s, None, k))
                newcols[k].append(s)
            rem = c[i:]
            # Half adder: only when the column would still exceed height 2
            # (counting carries already arriving from column k-1 this
            # level) - this breaks the height-3 drip that would otherwise
            # ripple one column per level (Dadda's role for HAs).
            if len(newcols[k]) + len(rem) > 2 and len(rem) == 2:
                x, y = rem
                s, cy = next_id, next_id + 1
                next_id += 2
                degrees[s] = max(degrees[x], degrees[y])
                degrees[cy] = degrees[x] + degrees[y]
                if k + 1 < n:
                    ops.append(CsaOp(x, y, None, s, cy, k))
                    newcols[k + 1].append(cy)
                else:
                    ops.append(CsaOp(x, y, None, s, None, k))
                newcols[k].append(s)
            else:
                newcols[k].extend(rem)
        cols = newcols
        levels.append(tuple(ops))

    return CsaPlan(
        n=n,
        levels=tuple(levels),
        final_cols=tuple(tuple(c) for c in cols),
        degrees=degrees,
    )
