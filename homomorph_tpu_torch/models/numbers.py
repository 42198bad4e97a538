"""Shipped homomorphic operations over integer types.

Counterpart of the gate markers and :class:`HomomorphicAddition` of
:mod:`homomorph_tpu.models.numbers` (reference: src/impls/numbers.rs:7-50):

=========================  ================  =============================
Operation                  MIN_D_OVER_DELTA  Circuit
=========================  ================  =============================
HomomorphicAndGate         2 (UNSOUND*)      lane-wise AND (common.rs:5-11)
HomomorphicOrGate          2 (UNSOUND*)      lane-wise OR  (common.rs:13-19)
HomomorphicXorGate         1                 lane-wise XOR (common.rs:21-27)
HomomorphicNotGate         1                 lane-wise NOT (common.rs:29-35)
HomomorphicAddition        21                ripple-carry  (common.rs:37-64)
=========================  ================  =============================

(*) The class constants are kept for reference parity only; the checked
API always validates the exact seeded bound via ``requirement_for``, which
returns the same numbers as the JAX package (the noise model is a copy).
The multiplication, subtraction, comparison and N-ary markers are not
ported yet.
"""

from __future__ import annotations

from ..cipher import FRESH_NOISE as _FRESH, Ciphered
from ..operations import HomomorphicOperation1, HomomorphicOperation2
from . import circuits, noise as _noise

__all__ = [
    "HomomorphicAndGate",
    "HomomorphicOrGate",
    "HomomorphicXorGate",
    "HomomorphicNotGate",
    "HomomorphicAddition",
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
