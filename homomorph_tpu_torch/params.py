"""Scheme parameters.

TPU-native re-design of the reference's ``Parameters`` value object
(reference: src/context.rs:33-119). Same four strictly-positive ``u16``
fields and the same invariant ``delta < d`` (asserts at src/context.rs:87-94).
"""

from __future__ import annotations

import dataclasses

_U16_MAX = 0xFFFF


@dataclasses.dataclass(frozen=True)
class Parameters:
    """Parameters for the homomorphic scheme.

    * ``d``     - degree of the secret key.
    * ``dp``    - ``d + dp`` is the degree of the public key polynomials.
    * ``delta`` - noise parameter (strictly less than ``d``).
    * ``tau``   - number of polynomials in the public key.
    """

    d: int
    dp: int
    delta: int
    tau: int

    def __post_init__(self) -> None:
        for name in ("d", "dp", "delta", "tau"):
            v = getattr(self, name)
            if not isinstance(v, int):
                raise TypeError(f"Parameter {name} must be an int, got {type(v)!r}")
            if not 0 < v <= _U16_MAX:
                raise ValueError(
                    "Parameters must be strictly positive"
                    if v <= 0
                    else f"Parameter {name}={v} exceeds u16 range"
                )
        if not self.delta < self.d:
            raise ValueError("Delta must be less than d (delta < d)")

    @property
    def pk_degree(self) -> int:
        """Exact degree of every public key polynomial.

        ``T_i = S*Q_i + X*R_i`` with ``deg S = d`` and ``deg Q_i = dp`` both
        forced exact (monic), so ``deg(S*Q_i) = d + dp``; ``deg(X*R_i) =
        delta + 1 <= d`` cannot cancel the leading term.
        """
        return self.d + self.dp
