"""Shipped homomorphic operations over integer types.

Counterpart of :mod:`homomorph_tpu.models.numbers` (reference:
src/impls/numbers.rs:7-50):

=========================  ================  =============================
Operation                  MIN_D_OVER_DELTA  Circuit
=========================  ================  =============================
HomomorphicAndGate         2 (UNSOUND*)      lane-wise AND (common.rs:5-11)
HomomorphicOrGate          2 (UNSOUND*)      lane-wise OR  (common.rs:13-19)
HomomorphicXorGate         1                 lane-wise XOR (common.rs:21-27)
HomomorphicNotGate         1                 lane-wise NOT (common.rs:29-35)
HomomorphicAddition        21                ripple-carry  (common.rs:37-64)
HomomorphicMultiplication  64 (conservative) carry-save tree (csaplan.py;
                                             reference column circuit
                                             below width 4)
=========================  ================  =============================

(*) The class constants are kept for reference parity only; the checked
API always validates the exact seeded bound via ``requirement_for``, which
returns the same numbers as the JAX package (the noise model is a copy).

Extensions beyond the reference, as in the JAX package:
``HomomorphicSubtraction`` and ``HomomorphicNegation`` (21),
``HomomorphicLessThan`` / ``HomomorphicGreaterThan`` (21, tree
comparator; signed descriptors flip the sign bits first),
``HomomorphicMinimum`` / ``HomomorphicMaximum`` (23) and
``HomomorphicEquality`` (257, all widths), the N-ary
``HomomorphicSum`` (21; width- and count-aware through
``requirement_for``) and ``HomomorphicPopCount`` (733, all widths; u8 17,
u32 65).  Signed multiplication is selected by the descriptor
(Baugh-Wooley for two's-complement types).
"""

from __future__ import annotations

from .. import codec as _codec
from ..cipher import FRESH_NOISE as _FRESH, Ciphered
from ..operations import HomomorphicOperation1, HomomorphicOperation2, HomomorphicOperationN
from . import circuits, noise as _noise

__all__ = [
    "HomomorphicAndGate",
    "HomomorphicOrGate",
    "HomomorphicXorGate",
    "HomomorphicNotGate",
    "HomomorphicAddition",
    "HomomorphicMultiplication",
    "HomomorphicSubtraction",
    "HomomorphicNegation",
    "HomomorphicEquality",
    "HomomorphicSum",
    "HomomorphicPopCount",
    "HomomorphicLessThan",
    "HomomorphicGreaterThan",
    "HomomorphicMinimum",
    "HomomorphicMaximum",
]


def _noises(operands) -> "list[int]":
    """Tracked noise seeds of the operands (normalized delta=1 units)."""
    return [c.noise for c in operands]


def _all_fresh(operands) -> bool:
    return all(c.noise <= _FRESH for c in operands)


def _and_or_requirement(operands) -> int:
    """Exact seeded bound for one multiplicative gate: output noise is
    ``na + nb``.  Applied to FRESH operands too - the reference's published
    constant 2 (src/impls/numbers.rs:29-31) is unsound (NOISE.md §4)."""
    return _noise.required_ratio(sum(_noises(operands)))


class HomomorphicAndGate(HomomorphicOperation2):
    """Lane-wise AND; the checked API validates the exact seeded bound
    (fresh operands need ``d/delta >= 5``)."""

    MIN_D_OVER_DELTA = 2

    @classmethod
    def requirement_for(cls, *operands: Ciphered) -> int:
        return _and_or_requirement(operands)

    @staticmethod
    def unsafe_apply(a: Ciphered, b: Ciphered) -> Ciphered:
        return circuits.gate_and(a, b)


class HomomorphicOrGate(HomomorphicOperation2):
    """Lane-wise OR (a+b+ab): same exact bound as :class:`HomomorphicAndGate`."""

    MIN_D_OVER_DELTA = 2

    @classmethod
    def requirement_for(cls, *operands: Ciphered) -> int:
        return _and_or_requirement(operands)

    @staticmethod
    def unsafe_apply(a: Ciphered, b: Ciphered) -> Ciphered:
        return circuits.gate_or(a, b)


class HomomorphicXorGate(HomomorphicOperation2):
    """Lane-wise XOR - degree-free: the published 1 holds for fresh
    operands; composed operands validate the tracked envelope."""

    MIN_D_OVER_DELTA = 1

    @classmethod
    def requirement_for(cls, *operands: Ciphered) -> int:
        if _all_fresh(operands):
            return cls.MIN_D_OVER_DELTA
        return _noise.required_ratio(max(_noises(operands)))

    @staticmethod
    def unsafe_apply(a: Ciphered, b: Ciphered) -> Ciphered:
        return circuits.gate_xor(a, b)


class HomomorphicNotGate(HomomorphicOperation1):
    """Lane-wise NOT (xor with the trivial one) - degree-free like XOR."""

    MIN_D_OVER_DELTA = 1

    @classmethod
    def requirement_for(cls, *operands: Ciphered) -> int:
        if _all_fresh(operands):
            return cls.MIN_D_OVER_DELTA
        return _noise.required_ratio(max(_noises(operands)))

    @staticmethod
    def unsafe_apply(a: Ciphered) -> Ciphered:
        return circuits.gate_not(a)


class HomomorphicAddition(HomomorphicOperation2):
    """Ripple-carry addition.  The class constant mirrors the reference's
    published 21 (src/impls/numbers.rs:34-36); the checked API uses the
    exact width-aware noise bound via :meth:`requirement_for` (u32: 65)."""

    MIN_D_OVER_DELTA = 21

    @classmethod
    def requirement_for(cls, *operands: Ciphered) -> int:
        n = max(len(c) for c in operands)
        na, nb = (_noises(operands) + [_FRESH])[:2]
        return _noise.required_ratio(_noise.add_noise_seeded(n, na, nb))

    @staticmethod
    def unsafe_apply(a: Ciphered, b: Ciphered) -> Ciphered:
        return circuits.add(a, b)


class HomomorphicMultiplication(HomomorphicOperation2):
    """Wrapping multiplication by the carry-save tree (the reference
    column circuit below width 4).  The class constant mirrors the
    reference's "conservative default" 64 (src/impls/numbers.rs:47-50),
    which is not sound even for the reference's own circuit; the checked
    API validates the exact width-aware bound of the circuit that runs
    (u8 65, u16 417, u32 2,385, u64 13,373 at delta=1)."""

    MIN_D_OVER_DELTA = 64

    @classmethod
    def requirement_for(cls, *operands: Ciphered) -> int:
        n = max(len(c) for c in operands)
        na, nb = (_noises(operands) + [_FRESH])[:2]
        return _noise.required_ratio(_noise.mul_noise_seeded(n, na, nb))

    @staticmethod
    def unsafe_apply(a: Ciphered, b: Ciphered) -> Ciphered:
        desc = a.desc
        signed = isinstance(desc, _codec.IntDescriptor) and desc.signed
        if signed:
            return circuits.mul_signed(a, b)
        return circuits.mul_unsigned(a, b)


class HomomorphicSubtraction(HomomorphicOperation2):
    """Wrapping two's-complement ``a - b`` (not in the reference): the
    adder with ``~b`` and a carry-in of one, so the addition's bound with
    the carry seeded at the operands' noise."""

    MIN_D_OVER_DELTA = 21

    @classmethod
    def requirement_for(cls, *operands: Ciphered) -> int:
        n = max(len(c) for c in operands)
        na, nb = (_noises(operands) + [_FRESH])[:2]
        return _noise.required_ratio(
            _noise.add_noise_seeded(n, na, nb, c0=max(na, nb))
        )

    @staticmethod
    def unsafe_apply(a: Ciphered, b: Ciphered) -> Ciphered:
        return circuits.sub(a, b)


class HomomorphicNegation(HomomorphicOperation1):
    """Wrapping two's-complement ``-a`` (not in the reference): the
    constant-operand adder, bounded by the addition's requirement."""

    MIN_D_OVER_DELTA = 21

    @classmethod
    def requirement_for(cls, *operands: Ciphered) -> int:
        n = max(len(c) for c in operands)
        na = operands[0].noise if operands else _FRESH
        return _noise.required_ratio(
            _noise.add_noise_seeded(n, na, na, c0=na)
        )

    @staticmethod
    def unsafe_apply(a: Ciphered) -> Ciphered:
        return circuits.neg(a)


class HomomorphicLessThan(HomomorphicOperation2):
    """``a < b`` as ``Ciphered[Bool]`` (not in the reference): the tree
    comparator, exact noise degree ``(n+1)*(delta+1)`` for power-of-two
    widths; signed descriptors dispatch to the sign-flipped circuit."""

    MIN_D_OVER_DELTA = 21

    @classmethod
    def requirement_for(cls, *operands: Ciphered) -> int:
        n = max(len(c) for c in operands)
        na, nb = (_noises(operands) + [_FRESH])[:2]
        return _noise.required_ratio(_noise.compare_noise_seeded(n, na, nb))

    @staticmethod
    def unsafe_apply(a: Ciphered, b: Ciphered) -> Ciphered:
        return circuits.lt(a, b)


class HomomorphicGreaterThan(HomomorphicOperation2):
    """``a > b`` as ``Ciphered[Bool]`` (not in the reference);
    signedness-dispatched like :class:`HomomorphicLessThan`."""

    MIN_D_OVER_DELTA = 21

    @classmethod
    def requirement_for(cls, *operands: Ciphered) -> int:
        n = max(len(c) for c in operands)
        na, nb = (_noises(operands) + [_FRESH])[:2]
        return _noise.required_ratio(_noise.compare_noise_seeded(n, na, nb))

    @staticmethod
    def unsafe_apply(a: Ciphered, b: Ciphered) -> Ciphered:
        return circuits.gt(a, b)


class HomomorphicMinimum(HomomorphicOperation2):
    """``min(a, b)`` (not in the reference): comparison + mux, one AND
    deeper than the comparison."""

    MIN_D_OVER_DELTA = 23

    @classmethod
    def requirement_for(cls, *operands: Ciphered) -> int:
        n = max(len(c) for c in operands)
        na, nb = (_noises(operands) + [_FRESH])[:2]
        return _noise.required_ratio(_noise.min_max_noise_seeded(n, na, nb))

    @staticmethod
    def unsafe_apply(a: Ciphered, b: Ciphered) -> Ciphered:
        return circuits.min_(a, b)


class HomomorphicMaximum(HomomorphicOperation2):
    """``max(a, b)`` (not in the reference); see :class:`HomomorphicMinimum`."""

    MIN_D_OVER_DELTA = 23

    @classmethod
    def requirement_for(cls, *operands: Ciphered) -> int:
        n = max(len(c) for c in operands)
        na, nb = (_noises(operands) + [_FRESH])[:2]
        return _noise.required_ratio(_noise.min_max_noise_seeded(n, na, nb))

    @staticmethod
    def unsafe_apply(a: Ciphered, b: Ciphered) -> Ciphered:
        return circuits.max_(a, b)


class HomomorphicEquality(HomomorphicOperation2):
    """``a == b`` as ``Ciphered[Bool]`` (not in the reference): XNOR lanes
    and an AND-reduction tree, correct iff ``n * (delta + 1) < d``; the
    checked API uses the width-aware bound, the class constant is the
    all-widths fallback."""

    MIN_D_OVER_DELTA = 2 * 128 + 1  # sound for every shipped width

    @classmethod
    def requirement_for(cls, *operands: Ciphered) -> int:
        n = max(len(c) for c in operands)
        na, nb = (_noises(operands) + [_FRESH])[:2]
        return _noise.required_ratio(_noise.eq_noise_seeded(n, na, nb))

    @staticmethod
    def unsafe_apply(a: Ciphered, b: Ciphered) -> Ciphered:
        return circuits.eq(a, b)


class HomomorphicSum(HomomorphicOperationN):
    """N-ary wrapping sum (not in the reference, which defines the N-ary
    trait at src/operations.rs:143-213 but ships no N-ary operation): the
    carry-save tree of :func:`circuits.sum_many`.  The class constant is
    the adder's published 21; the checked API validates the exact (width,
    count)-aware bound."""

    MIN_D_OVER_DELTA = 21

    @classmethod
    def requirement_for(cls, *operands: Ciphered) -> int:
        n = max(len(c) for c in operands)
        return _noise.required_ratio(_noise.sum_noise_seeded(n, _noises(operands)))

    @staticmethod
    def unsafe_apply(args) -> Ciphered:
        return circuits.sum_many(args)


class HomomorphicPopCount(HomomorphicOperation1):
    """Population count as the operand's own width (not in the reference):
    :func:`circuits.popcount`.  Width-aware bound through
    :meth:`requirement_for` (u8 17, u32 65 from fresh operands); the class
    constant is sound
    for every shipped width (u128 733)."""

    MIN_D_OVER_DELTA = 733

    @classmethod
    def requirement_for(cls, *operands: Ciphered) -> int:
        n = max(len(c) for c in operands)
        na = operands[0].noise if operands else _FRESH
        return _noise.required_ratio(_noise.popcount_noise_seeded(n, na))

    @staticmethod
    def unsafe_apply(a: Ciphered) -> Ciphered:
        return circuits.popcount(a)
