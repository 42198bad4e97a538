"""Homomorphic boolean circuits over ciphered bit-lanes.

Counterpart of :mod:`homomorph_tpu.models.circuits` (reference:
src/impls/numbers/common.rs).  Gate for gate the same circuits as the JAX
package, so the ``d/delta`` requirements, the degree classes and the
tracked noise carry over unchanged:

* Whole-tensor gates: XOR/AND/OR/NOT act on ALL bit lanes of a ``Ciphered``
  in one batched op (the reference zips lane by lane, common.rs:5-35).
* The ripple-carry adder (common.rs:37-56) computes ``x = a ^ b`` and
  ``g = a & b`` once over all lanes, then runs the carry recurrence
  ``c' = g ^ x*c``: one batched carry-less multiply per bit position.
  Subtraction and negation are the adder with a complemented operand.
* Comparators: the log-depth tree ``_lt_tree`` (two wide clmuls per
  level) for ``lt``/``gt``/``le``/``ge``, the mux ``select``, ``min_`` and
  ``max_``, and the AND-reduction tree of ``eq``.  The tree and the mux
  are device regions (``circuit.lt_tree``, ``circuit.select``:
  :func:`~homomorph_tpu_torch.utils.profiling.device_region`), timed on
  the card inside a compiled graph too.
* Multipliers: all ``n*n`` partial products in one broadcast clmul, then
  the Dadda carry-save tree of :mod:`.csaplan` (each level's products
  grouped by operand widths, one clmul launch per group) and a two-row
  ripple; the reference's column accumulation (common.rs:66-163) is kept
  as the ``_ref`` oracle and as the circuit below width 4.  ``sum_many``
  and ``popcount`` run the same tree on their own plans.
* The glue of the tree and of the ripples (sums, operand stacks, carries'
  fits, each chain step's XORs and output lane) runs from plans as the
  kernels C1, C2 and C3 (:mod:`.circuit_kernels`, ``csrc/circuit.cu``); the
  per-op torch glue they replaced stays at the end of this module as the
  tests' reference.
* Degree-free lane remaps: ``shl``, ``shr``, ``rotl``, ``rotr`` by a
  plaintext amount; ``abs_`` and ``clamp`` are muxes over the comparator.

Degree classes: a fresh ciphered bit has bound ``B0 = d + dp``; AND adds
bounds; the carry bound grows by ``B0`` per position, so lane ``i`` of a sum
has bound ``<= (i+1)*B0``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import codec as _codec
from ..cipher import Ciphered, CipheredBit
from ..gf2 import kernels as gf2k
from ..gf2 import poly as gf2
from ..utils.profiling import device_region
from . import circuit_kernels as _ck
from . import csaplan as _csaplan

__all__ = [
    "gate_and",
    "gate_or",
    "gate_xor",
    "gate_not",
    "add",
    "add_lanes",
    "sub",
    "neg",
    "eq",
    "lt",
    "gt",
    "le",
    "ge",
    "select",
    "min_",
    "max_",
    "abs_",
    "clamp",
    "shl",
    "shr",
    "rotl",
    "rotr",
    "mul_unsigned",
    "mul_unsigned_lanes",
    "mul_unsigned_ref",
    "mul_signed",
    "mul_signed_lanes",
    "mul_signed_ref",
    "sum_many",
    "popcount",
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
    trivial zero).  Runs as the two-row ripple (:func:`_ripple_add_rows`):
    one C1 launch, the ``g`` products grouped by widths, one C3 launch a
    step; each lane comes back at its own width, bound and noise.
    """
    n = min(len(a), len(b))
    if n == 0:
        return []
    return _ck.run_ripple(list(a[:n]), list(b[:n]), a[0].batch_shape, carry_in).bits()


def add(a: Ciphered, b: Ciphered, carry_in: CipheredBit | None = None) -> Ciphered:
    """Homomorphic addition; output length = ``len(a)`` (common.rs:58-64).

    Computes the reference's per-bit carry function (common.rs:43-53) via
    the majority identity ``c' = a*b ^ (a ^ b)*c = g ^ x*c``, whose chain
    coefficient is the already-computed sum lane ``x``.  It is the JAX
    package's shipped recurrence, so ``models/noise.py`` bounds it exactly.

    Chain shape: step ``i`` multiplies the small fixed-degree ``x_i`` (kept
    at its exact width) by the growing carry (kept degree-class bucketed),
    so a u32 add runs 30 sequential carry-less multiplies after one
    whole-tensor AND.  The glue runs from a plan
    (:func:`~.circuit_kernels.run_add`): one C1 launch (the ``x`` lanes and
    output lane 0), then one C3 launch a step, which writes its carry and
    the next output lane straight into the stacked output.
    """
    a, b = a.densify(), b.densify()
    return _ck.run_add(
        a.limbs, b.limbs, _ck.Bit(a.num_limbs, a.bound, a.noise),
        _ck.Bit(b.num_limbs, b.bound, b.noise), carry_in,
    ).ciphered(a.desc)


def add_per_op(a: Ciphered, b: Ciphered, carry_in: CipheredBit | None = None) -> Ciphered:
    """:func:`add`'s ripple one torch op a bit, as the port ran it before
    C1 and C3 (the "before" that ``chip_smoke.py`` times, and the CPU
    tests' reference for :func:`~.circuit_kernels.run_add`)."""
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


# --------------------------------------------------------------------------
# Subtraction, negation, comparators (extensions beyond the reference)
# --------------------------------------------------------------------------


def sub(a: Ciphered, b: Ciphered) -> Ciphered:
    """Wrapping two's-complement ``a - b``: ``a + ~b + 1`` through the
    ripple-carry adder with a trivial-one carry-in (NOT is degree-free)."""
    return add(a, gate_not(b), carry_in=CipheredBit.one(a.batch_shape, device=a.limbs.device))


def _adder_carry_out(a: Ciphered, b: Ciphered, carry: CipheredBit) -> CipheredBit:
    """Final carry out of the full ``len(a)``-bit ripple chain: the
    :func:`add` recurrence run through ALL n positions.  The independent
    semantic oracle of the tree comparator (``a < b = NOT carry_out(a + ~b
    + 1)``)."""
    x_all = gate_xor(a, b)
    g_all = gate_and(a, b)
    x_limbs = gf2.fit_limbs(x_all.limbs, gf2.limbs_for(x_all.bound))
    x_bound = x_all.bound
    x_noise = x_all.noise
    for i in range(len(a)):
        prod = gf2k.clmul(x_limbs[..., i, :], carry.limbs)
        nb = max(g_all.bound, x_bound + carry.bound)
        nn = max(g_all.noise, x_noise + carry.noise)
        Lc = gf2.bucket(gf2.limbs_for(nb))
        carry = CipheredBit(
            gf2.xor(gf2.fit_limbs(prod, Lc), g_all[i].limbs), nb, noise=nn
        )
    return carry


def _bool_out(bit: CipheredBit) -> Ciphered:
    """A single ciphered bit as ``Ciphered[Bool]``: lanes 1..7 of the
    bincode bool byte are trivial zeros, kept implicit (``zero_lanes=7``)."""
    return Ciphered(bit.limbs[..., None, :], bit.bound, _codec.Bool,
                    zero_lanes=7, noise=bit.noise)


def _is_signed(c: Ciphered) -> bool:
    return isinstance(c.desc, _codec.IntDescriptor) and c.desc.signed


def _map_to_unsigned_order(a: Ciphered, b: Ciphered) -> tuple[Ciphered, Ciphered]:
    """Two's-complement order -> unsigned order by flipping both sign bits
    (degree-free), when either descriptor is a signed integer."""
    if not (_is_signed(a) or _is_signed(b)):
        return a, b
    return _flip_top_bit(a), _flip_top_bit(b)


def _flip_top_bit(c: Ciphered) -> Ciphered:
    top = gf2.xor_const_bit(c.limbs[..., -1:, :], 1)
    return Ciphered(
        torch.cat([c.limbs[..., :-1, :], top], dim=-2), c.bound, c.desc,
        noise=c.noise,
    )


def _lt_tree(a: Ciphered, b: Ciphered) -> CipheredBit:
    """Unsigned ``a < b`` by pairwise tree reduction (log-depth).

    Lane seeds ``lt_i = ~a_i * b_i`` (one batched clmul) and
    ``eq_i = a_i XNOR b_i``; a high/low pair merges as
    ``lt' = lt_hi ^ eq_hi * lt_lo`` and ``eq' = eq_hi * eq_lo`` (disjoint
    events, so OR == XOR).  An odd leftover lane passes through."""
    with device_region("circuit.lt_tree", a.limbs.device):
        na = gf2.xor_const_bit(a.limbs, 1)
        lt_l = gf2k.clmul(na, b.limbs)  # [..., n, 2L]
        lt_b = a.bound + b.bound
        lt_n = a.noise + b.noise
        lt_l = gf2.fit_limbs(lt_l, gf2.bucket(gf2.limbs_for(lt_b)))
        eq_l = gf2.xor_const_bit(gf2.xor(a.limbs, b.limbs), 1)
        eq_b = max(a.bound, b.bound)
        eq_n = max(a.noise, b.noise)

        n = lt_l.shape[-2]
        while n > 1:
            half = n // 2
            # lanes are LSB-first: pair (lo=2j, hi=2j+1) keeps significance order
            lt_lo, lt_hi = lt_l[..., 0::2, :][..., :half, :], lt_l[..., 1::2, :]
            eq_lo, eq_hi = eq_l[..., 0::2, :][..., :half, :], eq_l[..., 1::2, :]
            prod = gf2k.clmul(eq_hi, lt_lo)
            new_lt_b = max(lt_b, eq_b + lt_b)
            new_lt_n = max(lt_n, eq_n + lt_n)
            Ll = gf2.bucket(gf2.limbs_for(new_lt_b))
            lt_new = gf2.fit_limbs(
                gf2.xor(gf2.pad_limbs(lt_hi, prod.shape[-1]), prod), Ll
            )
            eq_new = gf2k.clmul(eq_hi, eq_lo)
            new_eq_b = 2 * eq_b
            new_eq_n = 2 * eq_n
            eq_new = gf2.fit_limbs(eq_new, gf2.bucket(gf2.limbs_for(new_eq_b)))
            if n % 2:  # leftover (most-significant) lane passes through
                odd_lt = gf2.pad_limbs(lt_l[..., -1:, :], lt_new.shape[-1])
                odd_eq = gf2.pad_limbs(eq_l[..., -1:, :], eq_new.shape[-1])
                lt_new = torch.cat([lt_new, odd_lt], dim=-2)
                eq_new = torch.cat([eq_new, odd_eq], dim=-2)
            lt_l, eq_l = lt_new, eq_new
            lt_b, eq_b = new_lt_b, new_eq_b
            lt_n, eq_n = new_lt_n, new_eq_n
            n = lt_l.shape[-2]
        return CipheredBit(lt_l[..., 0, :], lt_b, noise=lt_n)


def lt(a: Ciphered, b: Ciphered) -> Ciphered:
    """``a < b`` as ``Ciphered[Bool]`` by the tree comparator; signed
    operands first have both sign bits flipped."""
    a, b = _map_to_unsigned_order(a.densify(), b.densify())
    return _bool_out(_lt_tree(a, b))


def gt(a: Ciphered, b: Ciphered) -> Ciphered:
    """``a > b`` as ``Ciphered[Bool]``; signedness-dispatched."""
    return lt(b, a)


def le(a: Ciphered, b: Ciphered) -> Ciphered:
    """``a <= b``: NOT (b < a); signedness-dispatched."""
    a, b = _map_to_unsigned_order(a.densify(), b.densify())
    return _bool_out(_lt_tree(b, a).not_())


def ge(a: Ciphered, b: Ciphered) -> Ciphered:
    """``a >= b``: NOT (a < b); signedness-dispatched."""
    a, b = _map_to_unsigned_order(a.densify(), b.densify())
    return _bool_out(_lt_tree(a, b).not_())


def select(cond: CipheredBit, a: Ciphered, b: Ciphered) -> Ciphered:
    """Homomorphic mux ``cond ? a : b``: ``out_i = b_i ^ cond * (a_i ^
    b_i)``, one batched clmul over all lanes (the condition's one row
    copied to every lane)."""
    a, b = a.densify(), b.densify()
    with device_region("circuit.select", a.limbs.device):
        x = gf2.xor(a.limbs, b.limbs)
        prod = gf2k.clmul(cond.limbs[..., None, :], x)
        bound = max(b.bound, cond.bound + max(a.bound, b.bound))
        noise = max(b.noise, cond.noise + max(a.noise, b.noise))
        out = gf2.xor(gf2.pad_limbs(b.limbs, prod.shape[-1]), prod)
        return Ciphered(
            gf2.fit_limbs(out, gf2.bucket(gf2.limbs_for(bound))), bound, a.desc,
            noise=noise,
        )


def min_(a: Ciphered, b: Ciphered) -> Ciphered:
    """Homomorphic minimum ``a < b ? a : b``: one comparison and one mux."""
    a, b = a.densify(), b.densify()
    return select(lt(a, b)[0], a, b)


def max_(a: Ciphered, b: Ciphered) -> Ciphered:
    """Homomorphic maximum ``a < b ? b : a``."""
    a, b = a.densify(), b.densify()
    return select(lt(a, b)[0], b, a)


def abs_(a: Ciphered) -> Ciphered:
    """Absolute value of a signed integer: ``sign ? -a : a``, the sign lane
    muxing the negation.  Wraps at the type minimum (``abs(i8 -128) =
    -128``), as Rust's ``wrapping_abs``."""
    a = a.densify()
    return select(a[len(a) - 1], neg(a), a)


def clamp(a: Ciphered, lo: Ciphered, hi: Ciphered) -> Ciphered:
    """``min(max(a, lo), hi)``; signedness follows the descriptors through
    the tree comparator."""
    return min_(max_(a, lo), hi)


def _zero_lanes_like(a: Ciphered, k: int) -> torch.Tensor:
    return a.limbs.new_zeros(a.limbs.shape[:-2] + (k, a.limbs.shape[-1]))


def shl(a: Ciphered, k: int) -> Ciphered:
    """Shift left by a plaintext ``k``: lane ``i`` of the result is lane
    ``i - k``, the bottom ``k`` lanes are trivial zeros and the top ``k``
    drop (wrapping ``<<``).  No gate runs, so the degree does not grow."""
    a = a.densify()
    n = len(a)
    if not 0 <= k:
        raise ValueError("shift amount must be non-negative")
    if k == 0:
        return a
    if k >= n:
        return Ciphered(_zero_lanes_like(a, n), 0, a.desc, noise=0)
    out = torch.cat([_zero_lanes_like(a, k), a.limbs[..., : n - k, :]], dim=-2)
    return Ciphered(out, a.bound, a.desc, noise=a.noise)


def shr(a: Ciphered, k: int, *, arithmetic: bool | None = None) -> Ciphered:
    """Shift right by a plaintext ``k``: logical for unsigned descriptors,
    arithmetic (the sign lane replicated) for signed ones, as Rust's
    ``>>``, unless ``arithmetic=`` says otherwise.  Degree-free."""
    a = a.densify()
    n = len(a)
    if not 0 <= k:
        raise ValueError("shift amount must be non-negative")
    if arithmetic is None:
        arithmetic = _is_signed(a)
    if k == 0:
        return a
    kk = min(k, n)
    if arithmetic:
        sign = a.limbs[..., n - 1 : n, :]
        fill = sign.expand(sign.shape[:-2] + (kk,) + sign.shape[-1:])
        bound = a.bound
    else:
        fill = _zero_lanes_like(a, kk)
        bound = a.bound if kk < n else 0
    out = torch.cat([a.limbs[..., kk:, :], fill], dim=-2)
    return Ciphered(out, bound, a.desc, noise=a.noise if bound or arithmetic else 0)


def rotl(a: Ciphered, k: int) -> Ciphered:
    """Rotate left by a plaintext ``k``; degree-free."""
    a = a.densify()
    n = len(a)
    k %= n
    if k == 0:
        return a
    out = torch.cat([a.limbs[..., n - k :, :], a.limbs[..., : n - k, :]], dim=-2)
    return Ciphered(out, a.bound, a.desc, noise=a.noise)


def rotr(a: Ciphered, k: int) -> Ciphered:
    """Rotate right by a plaintext ``k``; degree-free."""
    return rotl(a, -k)


def neg(a: Ciphered) -> Ciphered:
    """Wrapping two's-complement ``-a = ~a + 1``: the adder specialised to
    the constant operand, ``out_i = x_i ^ c_i`` and ``c_{i+1} = x_i * c_i``
    with ``x_i = ~a_i`` and ``c_0 = 1``."""
    a = a.densify()
    x_limbs = gf2.xor_const_bit(a.limbs, 1)
    n = len(a)
    xs = [CipheredBit(x_limbs[..., i, :], a.bound, noise=a.noise)
          for i in range(n)]
    carry = CipheredBit.one(a.batch_shape, device=a.limbs.device)
    out: list[CipheredBit] = []
    for i in range(n):
        out.append(xs[i].xor(carry))
        if i + 1 >= n:
            break
        carry = xs[i].and_(carry)
    return Ciphered.new_from_raw(out, a.desc)


def eq(a: Ciphered, b: Ciphered) -> Ciphered:
    """``a == b`` as ``Ciphered[Bool]``: lane-wise XNOR, then a balanced
    AND-reduction tree over the lane axis (output bound ``n * max(bound_a,
    bound_b)``)."""
    a, b = a.densify(), b.densify()
    xn = gf2.xor_const_bit(gf2.xor(a.limbs, b.limbs), 1)
    bound = max(a.bound, b.bound)
    noise = max(a.noise, b.noise)
    cur = xn
    n = cur.shape[-2]
    while n > 1:
        half = n // 2
        lo, hi = cur[..., :half, :], cur[..., half : 2 * half, :]
        prod = gf2k.clmul(lo, hi)
        bound = bound * 2
        noise = noise * 2
        prod = gf2.fit_limbs(prod, gf2.bucket(gf2.limbs_for(bound)))
        if n % 2:
            odd = gf2.pad_limbs(cur[..., -1:, :], prod.shape[-1])
            prod = torch.cat([prod, odd], dim=-2)
        cur = prod
        n = cur.shape[-2]
    return _bool_out(CipheredBit(cur[..., 0, :], bound, noise=noise))


# --------------------------------------------------------------------------
# Multipliers
#
# Default: the carry-save (Dadda) tree of models/csaplan.py.  The
# reference's sequential column accumulation (common.rs:66-163) is kept as
# ``mul_unsigned_ref``/``mul_signed_ref``: the oracle the tree is tested
# against, and the circuit below the tree's crossover width.
# --------------------------------------------------------------------------


def _batched_clmul_pairs(
    pairs: "list[tuple[CipheredBit, CipheredBit, object]]",
) -> "dict[object, CipheredBit]":
    """Many independent carry-less multiplies, one clmul launch per group
    of equal (exact) operand limb widths, the groups' operands stacked by
    one C1 launch (:func:`~.circuit_kernels.clmul_pairs`).  Products keep
    their own exact bounds and are not degree-class fitted: callers fit
    after assembly."""
    if not pairs:
        return {}
    return _ck.clmul_pairs(pairs, pairs[0][0].batch_shape)


def _fit_bit(bit: CipheredBit, *, bucketed: bool = True) -> CipheredBit:
    """Trim/pad a product bit to its bound's limb count (bucketed by
    default, the degree-class discipline of ``CipheredBit.and_``)."""
    L = gf2.limbs_for(bit.bound)
    if bucketed:
        L = gf2.bucket(L)
    return CipheredBit(gf2.fit_limbs(bit.limbs, L), bit.bound, noise=bit.noise)


def _csa_accumulate(
    bits: "dict[int, CipheredBit]",
    plan: "_csaplan.CsaPlan",
    batch: tuple[int, ...],
) -> "_ck.Lanes":
    """Run a static carry-save plan (models/csaplan.py) on live bits.

    Each level is one C1 launch (every sum; every row of the level's
    grouped clmul operands), the grouped clmuls (one launch per group of
    equal operand widths, keyed as :func:`_batched_clmul_pairs` keys them)
    and one C2 launch (every carry at its degree class); compressors whose
    carry falls off column ``n-1`` skip their products.  Finishes with the
    two-row ripple add (:func:`_ripple_add_rows`).  The launches come from
    :func:`~.circuit_kernels.tree_plan`, made once per shape.  A level's
    outputs share one buffer for each level at which they die, so the
    caching allocator reuses their memory as each bit dies, as the
    liveness set of the per-op glue did.
    """
    return _ck.run_tree(bits, plan, batch)


def _ripple_add_rows(
    A: "list[CipheredBit | None]",
    B: "list[CipheredBit | None]",
    batch: tuple[int, ...],
) -> "_ck.Lanes":
    """Wrapping ripple-carry sum of two per-lane-bounded rows.

    The :func:`add` recurrence ``c' = g ^ x*c``, with the ``g`` products
    grouped by widths because lanes carry different exact bounds.  ``None``
    lanes are trivial zeros and pruned exactly: a single-row column has
    ``g = 0`` and steps ``c' = x*c``; an empty column zeroes the carry
    (models/noise.py::_replay_csa mirrors these rules).  One C1 launch
    (each column's ``x``, the ``g`` operands, the lanes no carry reaches),
    then one C3 launch a step into the stacked output
    (:func:`~.circuit_kernels.run_ripple`)."""
    return _ck.run_ripple(A, B, batch)


def _mul_accumulate(
    pp: list[list[CipheredBit]], length: int, batch: tuple[int, ...]
) -> list[CipheredBit]:
    """The reference's column accumulation with AND-carry bookkeeping
    (common.rs:76-102); overflow columns are dropped (wrapping)."""
    dev = pp[0][0].limbs.device
    result = [CipheredBit.zero(batch, device=dev) for _ in range(length)]
    carries: list[CipheredBit] = []
    offset = 0
    for i in range(length):
        current_length = i * (i + 1) // 2
        for j in range(i + 1):
            p = pp[j][i - j]
            if i + 1 < length:
                carries.append(p.and_(result[i]))
            result[i] = result[i].xor(p)
        for j in range(current_length):
            if i + 1 < length:
                carries.append(result[i].and_(carries[offset + j]))
            result[i] = result[i].xor(carries[offset + j])
        offset += current_length
    return result


def _pp_bits(
    pp: "list[list[CipheredBit]]", n: int
) -> "dict[int, CipheredBit]":
    """The wrapping-relevant partial products (i + j < n) by the static
    plan's bit ids (models/csaplan.py: pp[i][j] -> i*n + j)."""
    return {i * n + j: pp[i][j] for i in range(n) for j in range(n - i)}


def _pp_lanes(
    a: Sequence[CipheredBit], b: Sequence[CipheredBit], length: int
) -> "list[list[CipheredBit | None]]":
    """The wrapping-relevant partial products (i + j < length) of two lane
    lists, one grouped clmul per distinct limb-width pair; entries with
    i + j >= length are never computed (None)."""
    pairs = [
        (a[i], b[j], (i, j))
        for i in range(length)
        for j in range(length - i)
    ]
    prods = _batched_clmul_pairs(pairs)
    pp: list[list[CipheredBit | None]] = [
        [None] * length for _ in range(length)
    ]
    for key, p in prods.items():
        i, j = key
        pp[i][j] = _fit_bit(p)
    return pp


def mul_unsigned_lanes(
    a: Sequence[CipheredBit], b: Sequence[CipheredBit]
) -> list[CipheredBit]:
    """Wrapping unsigned product of equal-length lane lists: the tree at
    ``TREE_MIN_WIDTH`` and above, the reference accumulation below."""
    length = len(a)
    pp = _pp_lanes(a, b, length)
    batch = a[0].batch_shape if length else ()
    if length >= _csaplan.TREE_MIN_WIDTH:
        return _csa_accumulate(_pp_bits(pp, length), _csaplan.csa_plan(length), batch).bits()
    return _mul_accumulate(pp, length, batch)


def _pp_tensor(a: Ciphered, b: Ciphered) -> list[list[CipheredBit]]:
    """All n*n partial products in ONE broadcast clmul over the two lane
    axes, at exact (not bucketed) width, sliced into lanes."""
    a, b = a.densify(), b.densify()
    prod = gf2k.clmul(a.limbs[..., :, None, :], b.limbs[..., None, :, :])
    bound = a.bound + b.bound
    noise = a.noise + b.noise
    prod = gf2.fit_limbs(prod, gf2.limbs_for(bound))
    # unbind: one call a lane axis, where an index per view costs a call each
    return [[CipheredBit(v, bound, noise=noise) for v in row.unbind(-2)]
            for row in prod.unbind(-3)]


def mul_unsigned(a: Ciphered, b: Ciphered) -> Ciphered:
    """Wrapping unsigned product: the carry-save tree from
    ``TREE_MIN_WIDTH`` (4), the reference circuit below it."""
    n = len(a)
    if n < _csaplan.TREE_MIN_WIDTH:
        return mul_unsigned_ref(a, b)
    pp = _pp_tensor(a, b)
    return _csa_accumulate(_pp_bits(pp, n), _csaplan.csa_plan(n), a.batch_shape).ciphered(a.desc)


def mul_unsigned_ref(a: Ciphered, b: Ciphered) -> Ciphered:
    """The reference's column-accumulation product (common.rs:66-105),
    batched: the oracle for :func:`mul_unsigned`."""
    pp = _pp_tensor(a, b)
    return Ciphered.new_from_raw(
        _mul_accumulate(pp, len(a), a.batch_shape), a.desc
    )


def mul_signed_lanes(
    a: Sequence[CipheredBit], b: Sequence[CipheredBit]
) -> list[CipheredBit]:
    """Wrapping signed product on lane lists: the Baugh-Wooley corrections
    (NOT of ``pp[0][n-1]`` and ``pp[n-1][0]``, common.rs:115-155) before
    the width-dispatched accumulation."""
    length = len(a)
    pp = _pp_lanes(a, b, length)
    pp[0][length - 1] = pp[0][length - 1].not_()
    pp[length - 1][0] = pp[length - 1][0].not_()
    batch = a[0].batch_shape if length else ()
    if length >= _csaplan.TREE_MIN_WIDTH:
        return _csa_accumulate(_pp_bits(pp, length), _csaplan.csa_plan(length), batch).bits()
    return _mul_accumulate(pp, length, batch)


def mul_signed(a: Ciphered, b: Ciphered) -> Ciphered:
    """Wrapping signed product: the carry-save tree with the Baugh-Wooley
    corrections (degree-free XORs with the trivial one)."""
    n = len(a)
    if n < _csaplan.TREE_MIN_WIDTH:
        return mul_signed_ref(a, b)
    pp = _pp_tensor(a, b)
    pp[0][n - 1] = pp[0][n - 1].not_()
    pp[n - 1][0] = pp[n - 1][0].not_()
    return _csa_accumulate(_pp_bits(pp, n), _csaplan.csa_plan(n), a.batch_shape).ciphered(a.desc)


def mul_signed_ref(a: Ciphered, b: Ciphered) -> Ciphered:
    """The reference's signed column-accumulation product
    (common.rs:115-163): the oracle for :func:`mul_signed`."""
    pp = _pp_tensor(a, b)
    n = len(a)
    pp[0][n - 1] = pp[0][n - 1].not_()
    pp[n - 1][0] = pp[n - 1][0].not_()
    return Ciphered.new_from_raw(
        _mul_accumulate(pp, n, a.batch_shape), a.desc
    )


# --------------------------------------------------------------------------
# N-ary sum and popcount (extensions; the carry-save tree reused)
# --------------------------------------------------------------------------


def sum_many(operands: "Sequence[Ciphered]") -> Ciphered:
    """Wrapping sum of ``k`` same-width operands: one carry-save tree over
    the k-row bit matrix (:func:`.csaplan.sum_plan`) and one ripple add, so
    ``O(log k)`` compressor levels and near-linear noise growth in ``k``
    (``models/noise.py::sum_noise_seeded``).  Two operands take the
    adder."""
    ops = [o.densify() for o in operands]
    if not ops:
        raise ValueError("sum_many needs at least one operand")
    n = len(ops[0])
    if any(len(o) != n for o in ops):
        raise ValueError("sum_many operands must share one bit width")
    if len(ops) == 1:
        return ops[0]
    if len(ops) == 2:  # the uniform-width two-operand adder is tighter
        return add(ops[0], ops[1])
    k = len(ops)
    bits = {o * n + j: ops[o][j] for o in range(k) for j in range(n)}
    return _csa_accumulate(bits, _csaplan.sum_plan(n, k), ops[0].batch_shape).ciphered(ops[0].desc)


def popcount(a: Ciphered) -> Ciphered:
    """Population count as the operand's own width: every lane starts in
    column 0 (:func:`.csaplan.popcount_plan`), the tree compresses them
    into the ``log2(n)+1`` result columns and the ripple settles the
    carries.  The upper lanes are ciphertext zeros made by the tree."""
    a = a.densify()
    n = len(a)
    if n == 1:
        return a
    bits = {j: a[j] for j in range(n)}
    return _csa_accumulate(bits, _csaplan.popcount_plan(n), a.batch_shape).ciphered(a.desc)


# --------------------------------------------------------------------------
# The per-op glue that C1-C3 replaced: the "before" that chip_smoke.py
# times (patched in for a stage), and the CPU tests' reference for the plan
# --------------------------------------------------------------------------


def _batched_clmul_pairs_per_op(
    pairs: "list[tuple[CipheredBit, CipheredBit, object]]",
) -> "dict[object, CipheredBit]":
    """:func:`_batched_clmul_pairs` with the operands stacked by
    ``torch.stack`` (the per-op glue)."""
    out: dict[object, CipheredBit] = {}
    groups: dict[tuple[int, int], list[tuple[CipheredBit, CipheredBit, object]]] = {}
    for u, v, key in pairs:
        groups.setdefault((u.num_limbs, v.num_limbs), []).append((u, v, key))
    for items in groups.values():
        if len(items) == 1:
            u, v, key = items[0]
            out[key] = CipheredBit(gf2k.clmul(u.limbs, v.limbs),
                                   u.bound + v.bound, noise=u.noise + v.noise)
            continue
        U = torch.stack([u.limbs for u, _, _ in items], dim=-2)
        V = torch.stack([v.limbs for _, v, _ in items], dim=-2)
        P = gf2k.clmul(U, V)
        for idx, (u, v, key) in enumerate(items):
            out[key] = CipheredBit(P[..., idx, :], u.bound + v.bound,
                                   noise=u.noise + v.noise)
    return out


def _csa_accumulate_per_op(
    bits: "dict[int, CipheredBit]",
    plan: "_csaplan.CsaPlan",
    batch: tuple[int, ...],
) -> list[CipheredBit]:
    """:func:`_csa_accumulate` one torch op a bit, as the port ran it
    before C1-C3: each level's sums as XORs, its products grouped
    (:func:`_batched_clmul_pairs_per_op`), each carry fitted
    (:func:`_fit_bit`), then :func:`_ripple_add_rows_per_op` and the
    lanes padded and stacked.  The "before" that ``chip_smoke.py`` times,
    and the CPU tests' reference for the plan."""
    final_ids = {c[i] for c in plan.final_cols for i in range(min(2, len(c)))}
    live_after: list[set] = [set(final_ids)]
    for level in reversed(plan.levels):
        needed = set(live_after[0])
        for op in level:
            needed.add(op.x)
            needed.add(op.y)
            if op.z is not None:
                needed.add(op.z)
        live_after.insert(0, needed)

    for li, level in enumerate(plan.levels):
        pairs: list[tuple[CipheredBit, CipheredBit, object]] = []
        for op in level:
            x, y = bits[op.x], bits[op.y]
            if op.z is None:  # half adder
                bits[op.sum] = x.xor(y)
                if op.carry is not None:
                    pairs.append((x, y, op.carry))
            else:  # full adder: sum = x^y^z, carry = x*y ^ (x^y)*z
                xy = x.xor(y)
                bits[op.sum] = xy.xor(bits[op.z])
                if op.carry is not None:
                    pairs.append((x, y, ("p1", op.carry)))
                    pairs.append((xy, bits[op.z], ("p2", op.carry)))
        prods = _batched_clmul_pairs_per_op(pairs)
        for op in level:
            if op.carry is None:
                continue
            if op.z is None:
                bits[op.carry] = _fit_bit(prods[op.carry])
            else:
                p1, p2 = prods[("p1", op.carry)], prods[("p2", op.carry)]
                carry = CipheredBit(
                    gf2.xor(p1.limbs, p2.limbs), max(p1.bound, p2.bound),
                    noise=max(p1.noise, p2.noise),
                )
                bits[op.carry] = _fit_bit(carry)
        del prods, pairs
        keep = live_after[li + 1]
        for bid in [k for k in bits if k not in keep]:
            del bits[bid]
    A = [bits[c[0]] if len(c) > 0 else None for c in plan.final_cols]
    B = [bits[c[1]] if len(c) > 1 else None for c in plan.final_cols]
    return _ck.Lanes.stack(_ripple_add_rows_per_op(A, B, batch))


def _ripple_add_rows_per_op(
    A: "list[CipheredBit | None]",
    B: "list[CipheredBit | None]",
    batch: tuple[int, ...],
) -> list[CipheredBit]:
    """:func:`_ripple_add_rows` one torch op a bit (the per-op glue)."""
    n = len(A)
    dev = next(bit.limbs.device for bit in A + B if bit is not None)
    zero = CipheredBit.zero(batch, device=dev)
    xs: list[CipheredBit | None] = []
    gpairs: list[tuple[CipheredBit, CipheredBit, object]] = []
    for i in range(n):
        a_i, b_i = A[i], B[i]
        if a_i is None and b_i is not None:
            a_i, b_i = b_i, a_i
        if a_i is None:
            xs.append(None)
        elif b_i is None:
            xs.append(a_i)
        else:
            xs.append(a_i.xor(b_i))
            if i + 1 < n:
                gpairs.append((a_i, b_i, i))
    gp = _batched_clmul_pairs_per_op(gpairs)
    gs = {i: _fit_bit(p) for i, p in gp.items()}  # two-row columns only
    out: list[CipheredBit] = []
    carry: CipheredBit | None = None
    for i in range(n):
        x_i = xs[i]
        if x_i is None:
            out.append(carry if carry is not None else zero)
        else:
            out.append(x_i if carry is None else x_i.xor(carry))
        if i + 1 >= n:
            break
        if x_i is None:
            carry = None  # empty column: c' = g ^ x*c = 0
        elif carry is None:
            carry = gs.get(i)  # c' = g (None for single-row columns)
        else:
            prod = gf2k.clmul(x_i.limbs, carry.limbs)
            g_i = gs.get(i)
            if g_i is None:
                nb = x_i.bound + carry.bound
                nn = x_i.noise + carry.noise
                Lc = gf2.bucket(gf2.limbs_for(nb))
                carry = CipheredBit(gf2.fit_limbs(prod, Lc), nb, noise=nn)
            else:
                nb = max(g_i.bound, x_i.bound + carry.bound)
                nn = max(g_i.noise, x_i.noise + carry.noise)
                Lc = gf2.bucket(gf2.limbs_for(nb))
                carry = CipheredBit(
                    gf2.xor(gf2.fit_limbs(prod, Lc), g_i.limbs), nb, noise=nn
                )
    return out
