"""Operation framework: traits for user-defined homomorphic operations.

Mirrors the reference's operation layer (reference: src/operations.rs):

* :class:`HomomorphicOperation1` / :class:`HomomorphicOperation2` /
  :class:`HomomorphicOperationN` - the raw ``apply`` surface
  (src/operations.rs:73-82, 132-141, 204-213).  In the reference these are
  ``unsafe``; here the same contract is expressed by the ``unsafe_apply``
  naming: callers of ``unsafe_apply`` vouch that the ciphering parameters
  satisfy the operation's ``MIN_D_OVER_DELTA`` requirement.  The safe
  checked entry points live on :class:`~homomorph_tpu_torch.context.Context`
  (``apply1/apply2/apply_n``), which validate first
  (src/context.rs:310-323, 496-546).
* :class:`OperationRequirement` - the ``MIN_D_OVER_DELTA`` metadata
  consumed by the checked API (src/operations.rs:24-27).

Defining a custom operation - the executable analogue of the reference's
trait doc examples (src/operations.rs:51-203; run by ``tests/test_torch_slice.py``):

>>> import homomorph_tpu_torch as hm
>>> from homomorph_tpu_torch.models import circuits
>>> class AddThenDouble(hm.HomomorphicOperation2):
...     MIN_D_OVER_DELTA = 23     # one adder (21) + headroom for the shift
...     @staticmethod
...     def unsafe_apply(a, b):
...         s = circuits.add(a, b)
...         return circuits.add(s, s)
>>> ctx = hm.Context(hm.Parameters(128, 16, 1, 16), source=hm.ThreefrySource(3),
...                  device="cpu")
>>> ctx.generate_secret_key(); ctx.generate_public_key()
>>> a, b = ctx.encrypt(10, hm.U8), ctx.encrypt(11, hm.U8)
>>> int(ctx.decrypt(ctx.apply2(AddThenDouble, a, b)))
42
"""

from __future__ import annotations

from typing import Any, ClassVar, Sequence

from .cipher import Ciphered
from .utils.errors import InvalidParametersError, OperationError  # noqa: F401

__all__ = [
    "OperationRequirement",
    "HomomorphicOperation1",
    "HomomorphicOperation2",
    "HomomorphicOperationN",
    "OperationError",
    "InvalidParametersError",
]


class OperationRequirement:
    """Metadata: minimum required ``d / delta`` ratio.

    An operation of boolean degree ``D`` is correct iff ``d/delta >= D``
    (reference README.md:157-162); implementors declare that bound here
    (src/operations.rs:24-27).

    ``MIN_D_OVER_DELTA`` is the reference-style class constant (a blanket
    bound covering every operand type the operation supports).  Operations
    whose exact boolean degree depends on the operands - e.g. equality,
    whose degree is the plaintext bit width - may additionally override
    :meth:`requirement_for`, which the checked API
    (``Context.apply1/2/n``) consults with the actual operands so e.g.
    u128 equality is usable at ``d/delta >= 128`` without inflating the
    blanket constant for narrow types.
    """

    MIN_D_OVER_DELTA: ClassVar[int] = 1

    @classmethod
    def requirement_for(cls, *operands: "Ciphered") -> int:
        """Required ``d/delta`` for these specific operands (defaults to the
        class constant; override for width-dependent operations)."""
        return cls.MIN_D_OVER_DELTA


class HomomorphicOperation1(OperationRequirement):
    """Unary operation on one ciphered value (src/operations.rs:73-82)."""

    @staticmethod
    def unsafe_apply(a: Ciphered) -> Ciphered:
        """Caller vouches the cipher-time ``d/delta`` meets
        ``MIN_D_OVER_DELTA``; prefer ``Context.apply1``."""
        raise NotImplementedError


class HomomorphicOperation2(OperationRequirement):
    """Binary operation on two ciphered values (src/operations.rs:132-141)."""

    @staticmethod
    def unsafe_apply(a: Ciphered, b: Ciphered) -> Ciphered:
        """Caller vouches the cipher-time ``d/delta`` meets
        ``MIN_D_OVER_DELTA``; prefer ``Context.apply2``."""
        raise NotImplementedError


class HomomorphicOperationN(OperationRequirement):
    """N-ary operation on ciphered values (src/operations.rs:204-213)."""

    @staticmethod
    def unsafe_apply(args: Sequence[Ciphered]) -> Ciphered:
        """Caller vouches the cipher-time ``d/delta`` meets
        ``MIN_D_OVER_DELTA``; prefer ``Context.apply_n``."""
        raise NotImplementedError
