"""Homomorphic boolean circuits over ciphered bit-lanes.

Counterpart of the gates and the ripple-carry adder of
:mod:`homomorph_tpu.models.circuits` (reference:
src/impls/numbers/common.rs).  Gate for gate the same circuits as the JAX
package, so the ``d/delta`` requirements, the degree classes and the
tracked noise carry over unchanged:

* Whole-tensor gates: XOR/AND/OR/NOT act on ALL bit lanes of a ``Ciphered``
  in one batched op (the reference zips lane by lane, common.rs:5-35).
* The ripple-carry adder (common.rs:37-56) computes ``x = a ^ b`` and
  ``g = a & b`` once over all lanes, then runs the carry recurrence
  ``c' = g ^ x*c``: one batched carry-less multiply per bit position.

Degree classes: a fresh ciphered bit has bound ``B0 = d + dp``; AND adds
bounds; the carry bound grows by ``B0`` per position, so lane ``i`` of a sum
has bound ``<= (i+1)*B0``.

Not ported yet: the opt-in carry scan (``circuits.py:245-375``),
subtraction, negation, comparators, shifts, select and the multipliers.
"""

from __future__ import annotations

from typing import Sequence

from ..cipher import Ciphered, CipheredBit
from ..gf2 import kernels as gf2k
from ..gf2 import poly as gf2

__all__ = [
    "gate_and",
    "gate_or",
    "gate_xor",
    "gate_not",
    "add",
    "add_lanes",
]


# --------------------------------------------------------------------------
# Whole-tensor gates (common.rs:5-35)
# --------------------------------------------------------------------------


def gate_xor(a: Ciphered, b: Ciphered) -> Ciphered:
    a, b = a.densify(), b.densify()
    return Ciphered(
        gf2.xor(a.limbs, b.limbs), max(a.bound, b.bound), a.desc,
        noise=max(a.noise, b.noise),
    )


def gate_and(a: Ciphered, b: Ciphered) -> Ciphered:
    a, b = a.densify(), b.densify()
    prod = gf2k.clmul(a.limbs, b.limbs)
    bound = a.bound + b.bound
    return Ciphered(
        gf2.fit_limbs(prod, gf2.bucket(gf2.limbs_for(bound))), bound, a.desc,
        noise=a.noise + b.noise,
    )


def gate_or(a: Ciphered, b: Ciphered) -> Ciphered:
    a, b = a.densify(), b.densify()
    x = gf2.xor(a.limbs, b.limbs)
    m = gf2k.clmul(a.limbs, b.limbs)
    bound = a.bound + b.bound
    return Ciphered(
        gf2.fit_limbs(gf2.xor(x, m), gf2.bucket(gf2.limbs_for(bound))),
        bound,
        a.desc,
        noise=a.noise + b.noise,
    )


def gate_not(a: Ciphered) -> Ciphered:
    a = a.densify()
    return Ciphered(gf2.xor_const_bit(a.limbs, 1), a.bound, a.desc,
                    noise=a.noise)


# --------------------------------------------------------------------------
# Ripple-carry adder (common.rs:37-64)
# --------------------------------------------------------------------------


def add_lanes(
    a: Sequence[CipheredBit],
    b: Sequence[CipheredBit],
    carry_in: CipheredBit | None = None,
) -> list[CipheredBit]:
    """Wrap-around ripple-carry sum of equal-length lane lists.

    Boolean-equal to the reference's per-bit recurrence (common.rs:43-53)
    via the majority form ``c' = g ^ x*c`` with ``x = a ^ b``,
    ``g = a & b`` (see :func:`add`).  The final carry is dropped (wrapping
    semantics, common.rs:47-49).  ``carry_in`` seeds the chain (default:
    trivial zero).
    """
    n = min(len(a), len(b))
    xs = [a[i].xor(b[i]) for i in range(n)]
    gs = [a[i].and_(b[i]) for i in range(n)]
    carry: CipheredBit | None = carry_in
    out: list[CipheredBit] = []
    for i in range(n):
        out.append(xs[i] if carry is None else xs[i].xor(carry))
        if i + 1 >= n:
            break
        # c' = g ^ x*c; with no carry yet, c' = g exactly (x * zero = 0)
        carry = gs[i] if carry is None else gs[i].xor(xs[i].and_(carry))
    return out


def add(a: Ciphered, b: Ciphered, carry_in: CipheredBit | None = None) -> Ciphered:
    """Homomorphic addition; output length = ``len(a)`` (common.rs:58-64).

    Computes the reference's per-bit carry function (common.rs:43-53) via
    the majority identity ``c' = a*b ^ (a ^ b)*c = g ^ x*c``, whose chain
    coefficient is the already-computed sum lane ``x``.  It is the JAX
    package's shipped recurrence, so ``models/noise.py`` bounds it exactly.

    Chain shape: step ``i`` multiplies the small fixed-degree ``x_i`` (kept
    at its exact width) by the growing carry (kept degree-class bucketed),
    so a u32 add runs 30 sequential carry-less multiplies after one
    whole-tensor AND.
    """
    a, b = a.densify(), b.densify()
    x_all = gate_xor(a, b)
    g_all = gate_and(a, b)
    x_limbs = gf2.fit_limbs(x_all.limbs, gf2.limbs_for(x_all.bound))
    x_bound = x_all.bound
    x_noise = x_all.noise

    n = len(a)
    carry: CipheredBit | None = carry_in
    xs = [x_all[i] for i in range(n)]
    gs = [g_all[i] for i in range(n)]
    out: list[CipheredBit] = []
    for i in range(n):
        out.append(xs[i] if carry is None else xs[i].xor(carry))
        if i + 1 >= n:
            break
        if carry is None:
            # first step: c' = g exactly (x * zero = 0)
            carry = gs[i]
            continue
        prod = gf2k.clmul(x_limbs[..., i, :], carry.limbs)
        nb = max(g_all.bound, x_bound + carry.bound)
        nn = max(g_all.noise, x_noise + carry.noise)
        Lc = gf2.bucket(gf2.limbs_for(nb))
        carry = CipheredBit(
            gf2.xor(gf2.fit_limbs(prod, Lc), gs[i].limbs), nb, noise=nn
        )
    return Ciphered.new_from_raw(out, a.desc)
