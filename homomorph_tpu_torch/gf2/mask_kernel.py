"""The decrypt mask as a power-series inverse, and its kernels M1, M2, M3.

Counterpart of the JAX package's device scan of the decrypt mask
(``homomorph_tpu/gf2/poly.py:352-380``), which runs the monic recurrence
``r' = (r << 1) ^ (bit_d(r << 1) ? S : 0)`` for ``32 * n_limbs`` dependent
steps.  Here the mask is a power series computed in about ``log2`` of that
many steps, each of them wide.

The bits ``a_i = (X^i mod S)(0)`` satisfy the linear recurrence whose
characteristic polynomial is ``S`` (monic of degree ``d``: keygen forces the
leading bit, src/polynomial.rs:89-90), and their first ``d`` terms are
``1, 0, ..., 0``.  Their generating function is therefore

    sum_i a_i X^i = 1 + S(0) * X^d * (1 / S*)    (mod X^n),

with ``S* = X^d S(1/X)`` the bit reversal of ``S``'s ``d + 1`` coefficients
(:func:`reversed_key`); ``S*(0) = 1``, so ``1 / S*`` is a power series, and
``S(0)`` is bit ``d`` of ``S*``.  :func:`series_inverse` computes it by
Newton's iteration, which over GF(2) reads ``I' = S* * I^2 mod X^k'`` for
any ``k' <= 2k`` when ``I`` holds ``k`` bits.  The precisions run ``1, ...,
ceil(m/4), ceil(m/2), m`` for the ``m = n - d`` bits the mask needs
(:func:`precisions`), so the last step lands on ``m`` and none is wasted.
:func:`series_mask` assembles the mask
(:func:`homomorph_tpu_torch.gf2.poly.decrypt_mask` calls it).

Each step reaches the card one of three ways, chosen by :func:`mask_plan`
from the shapes alone (``csrc/mask.cu`` holds the three kernels):

* ``"M3"``: every step whose output has at most :data:`SMALL_CAP` limbs
  runs in ONE launch of one block (:func:`series_small`); where the whole
  series fits (the 9- and 65-limb classes), that launch also assembles the
  mask, so such a class costs one launch once the key holds ``S*``;
* ``"M2"``: one launch a step (:func:`newton_step`), the square, the
  product by ``S*`` and the truncation fused, nothing of them in device
  memory;
* ``"route"``: M1 (:func:`square`) and a product by ``S*`` through
  :func:`homomorph_tpu_torch.gf2.kernels.clmul` and its Karatsuba route (K1,
  with the route's glue R1 and R2 where ``S*`` takes a level), a few
  launches a step; taken past M3's cap only
  where ``S*`` is wider than :data:`TABLE_MAX_LIMBS`, which M2's and M3's
  tables cannot hold.  Only these products pass the clmul dispatcher and
  its limb-mesh hook: M2 and M3 steps do not (the JAX scan never reached
  it either).

M2 and M3 walk K1's 4-bit comb with the 16 multiples of ``S*`` in shared
memory (see the note in ``csrc/mask.cu``).  M1 maps [B, L] limbs to [B, Lo]
limbs, ``Lo <= 2L``: bit ``j`` of the input moves to bit ``2j`` (a square
in GF(2)[X] has no cross terms), and the output stops at ``n_bits`` bits.

Every wrapper computes its plain version on a CPU tensor (:func:`square_plain`,
:func:`newton_step_plain`, :func:`series_small_plain`) and, on a CUDA
tensor, launches its kernel or raises; nothing falls back.  Between steps
the series is not truncated to its ``k`` bits after a route step: the bits
of its last limb above ``k`` move to positions ``>= 2k >= k'`` when
squared, which the next step's truncation drops (M1's, or M2's and M3's
mask on the square's last limb); M2 and M3 mask their own output.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import kernels as gf2k
from . import poly as gf2
from ..utils.profiling import counters, span

__all__ = [
    "square", "square_plain", "newton_step", "newton_step_plain", "series_small",
    "series_small_plain", "reversed_key", "series_inverse", "precisions", "mask_plan",
    "newton_plan", "assemble_mask", "series_mask", "launch_counts",
]

#: M3's cap P: the Newton steps whose output has at most this many limbs run
#: in one block.  experiments/exp_mask_steps.py's cap sweep (PERF.md section
#: 6): each class's whole mask takes the same device time within 4% from
#: 64 to 256 limbs and more from 512 on, where M3 alone grows from 0.035 ms
#: at 128 limbs to 0.158 ms at 1,024 under the u64 key (NVIDIA H100 80GB
#: HBM3, 700 W)
SMALL_CAP = 128
#: the widest ``S*`` whose 16 multiples M2's and M3's tables hold in shared
#: memory (131 KB of the block's 227 KB)
TABLE_MAX_LIMBS = 2048
#: M3's widest step: one thread of its block per output limb at least
SMALL_MAX_LIMBS = 1024

_fns: dict = {}


def _kernel(name: str, argtypes):
    fn = _fns.get(name)
    if fn is None:
        from .cuda_build import library

        fn = getattr(library("mask"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


_SQUARE_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_uint, ctypes.c_void_p]
_STEP_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
              ctypes.c_longlong, ctypes.c_uint, ctypes.c_void_p]
_SMALL_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
               ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _tail(n_bits: int) -> int:
    """The mask of the bits kept in the last limb of ``n_bits`` bits."""
    rem = n_bits % gf2.LIMB_BITS
    return (1 << rem) - 1 if rem else 0xFFFFFFFF


def _truncate(x: torch.Tensor, n_bits: int) -> torch.Tensor:
    """``x`` ([ceil(n_bits/32)] limbs) with its bits from ``n_bits`` up
    cleared, in place."""
    if n_bits % gf2.LIMB_BITS:
        x[-1] &= (1 << n_bits % gf2.LIMB_BITS) - 1
    return x


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _out_shape(x: torch.Tensor, n_bits: "int | None") -> "tuple[int, int]":
    """(output limbs, bits kept in the last one, 0 for all 32) of squaring
    ``x`` to ``n_bits``."""
    if x.dtype != gf2.LIMB_DTYPE:
        raise TypeError(f"square takes int32 limbs, got {x.dtype}")
    if x.ndim != 2 or x.shape[1] == 0:
        raise ValueError(f"square takes [B, L] limbs with L >= 1, got {tuple(x.shape)}")
    top = 2 * gf2.bit_capacity(x.shape[1])
    n_bits = top if n_bits is None else int(n_bits)
    if not 1 <= n_bits <= top:
        raise ValueError(f"square of {x.shape[1]} limbs keeps 1 to {top} bits, not {n_bits}")
    return -(-n_bits // gf2.LIMB_BITS), n_bits % gf2.LIMB_BITS


def square_plain(x: torch.Tensor, n_bits: "int | None" = None) -> torch.Tensor:
    """Plain torch version of M1: [B, L] -> [B, ceil(n_bits/32)] limbs of
    ``x^2 mod X^n_bits`` (default ``n_bits = 64 L``, the whole square).
    Each 16-bit half of a limb spreads to the even bits of one output limb
    by four shift-or-and steps."""
    Lo, rem = _out_shape(x, n_bits)
    halves = torch.stack([x & 0xFFFF, gf2.srl(x, 16)], dim=-1).reshape(x.shape[0], -1)[:, :Lo]
    for shift, keep in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        halves = (halves | (halves << shift)) & keep
    if rem:
        halves[:, -1] &= (1 << rem) - 1
    return halves.contiguous()


def square(x: torch.Tensor, n_bits: "int | None" = None) -> torch.Tensor:
    """M1's wrapper: [B, L] int32 -> [B, ceil(n_bits/32)] limbs of ``x^2 mod
    X^n_bits`` in GF(2)[X] (default ``n_bits = 64 L``).

    A CPU tensor gets :func:`square_plain`; a CUDA tensor launches
    ``csrc/mask.cu`` on the current stream (and counts the launch) or
    raises."""
    Lo, _ = _out_shape(x, n_bits)
    if not x.is_contiguous():
        raise ValueError("square takes a contiguous operand")
    if x.device.type == "cpu":
        return square_plain(x, n_bits)
    if x.device.type != "cuda":
        raise ValueError(f"square runs on cpu or cuda, not {x.device}")
    B, L = x.shape
    out = torch.empty((B, Lo), dtype=gf2.LIMB_DTYPE, device=x.device)
    if B == 0:
        return out
    with torch.cuda.device(x.device):
        tail = _tail(2 * gf2.bit_capacity(L) if n_bits is None else n_bits)
        err = _kernel("hm_square", _SQUARE_ARGS)(x.data_ptr(), out.data_ptr(), B, L, Lo, tail,
                                                 _stream(x))
    if err:
        raise RuntimeError(f"square kernel launch failed: cudaError {err}")
    counters.add("M1")
    return out



def _check_series(sstar: torch.Tensor, n_bits: int, what: str) -> None:
    if sstar.dtype != gf2.LIMB_DTYPE:
        raise TypeError(f"{what} takes int32 limbs, got {sstar.dtype}")
    if sstar.ndim != 1 or sstar.shape[0] == 0 or not sstar.is_contiguous():
        raise ValueError(f"{what} takes S* as one contiguous row of limbs, got {tuple(sstar.shape)}")
    if n_bits < 1:
        raise ValueError(f"{what} needs at least one bit, not {n_bits}")


def _check_step(inv: torch.Tensor, sstar: torch.Tensor, k: int) -> int:
    """Checks a Newton step's operands; returns its output limbs."""
    _check_series(sstar, k, "newton_step")
    if inv.dtype != gf2.LIMB_DTYPE or inv.ndim != 1 or inv.shape[0] == 0 or not inv.is_contiguous():
        raise ValueError(f"newton_step takes I as one contiguous row of int32 limbs, got "
                         f"{tuple(inv.shape)} {inv.dtype}")
    if inv.device != sstar.device:
        raise ValueError(f"newton_step operands on {inv.device} and {sstar.device}")
    Lo = -(-k // gf2.LIMB_BITS)
    if Lo > 2 * inv.shape[0]:
        raise ValueError(f"a step from {inv.shape[0]} limbs reaches at most {64 * inv.shape[0]} "
                         f"bits, not {k}")
    return Lo


def newton_step_plain(inv: torch.Tensor, sstar: torch.Tensor, k: int) -> torch.Tensor:
    """Plain torch version of M2: ``S* * I^2 mod X^k`` as [ceil(k/32)] limbs,
    by :func:`square_plain`, then :func:`~homomorph_tpu_torch.gf2.kernels.
    clmul_plain` by the limbs of ``S*`` the precision can see, truncated."""
    Lo = _check_step(inv, sstar, k)
    sq = square_plain(inv.view(1, -1), k)
    p = gf2k.clmul_plain(sstar[: min(sstar.shape[0], Lo)].view(1, -1), sq)[0, :Lo].clone()
    return _truncate(p, k)


def newton_step(inv: torch.Tensor, sstar: torch.Tensor, k: int) -> torch.Tensor:
    """M2's wrapper: one Newton step ``I' = S* * I^2 mod X^k``, [Li] and
    [Ls] int32 limbs -> [ceil(k/32)] limbs with the bits from ``k`` up
    zero (``k <= 64 Li``).  Bits of ``I`` from ``k/2`` up may be set: they
    square past ``k``.

    A CPU tensor gets :func:`newton_step_plain`; a CUDA tensor launches
    ``hm_newton_step`` (``csrc/mask.cu``) on the current stream (and counts
    the launch) or raises."""
    Lo = _check_step(inv, sstar, k)
    if inv.device.type == "cpu":
        return newton_step_plain(inv, sstar, k)
    if inv.device.type != "cuda":
        raise ValueError(f"newton_step runs on cpu or cuda, not {inv.device}")
    if sstar.shape[0] > TABLE_MAX_LIMBS:
        raise ValueError(f"newton_step's table holds S* of at most {TABLE_MAX_LIMBS} limbs, "
                         f"not {sstar.shape[0]}")
    out = torch.empty(Lo, dtype=gf2.LIMB_DTYPE, device=inv.device)
    with torch.cuda.device(inv.device):
        err = _kernel("hm_newton_step", _STEP_ARGS)(
            inv.data_ptr(), sstar.data_ptr(), sstar.shape[0], out.data_ptr(), Lo, _tail(k),
            _stream(inv))
    if err:
        raise RuntimeError(f"newton_step kernel launch failed: cudaError {err}")
    counters.add("M2")
    return out



def assemble_mask(inv: torch.Tensor, sstar: torch.Tensor, s_degree: int, n_limbs: int) -> torch.Tensor:
    """The mask ``1 + S(0) * X^d * inv mod X^(32 n_limbs)``, [n_limbs] limbs,
    from the series ``inv`` ([ceil((32 n_limbs - d)/32)] limbs, zero from
    bit ``32 n_limbs - d`` up).  ``S(0)``, bit ``d`` of ``S*``, is applied
    as a bit mask on the device, with no branch on it."""
    q, r = divmod(s_degree, gf2.LIMB_BITS)
    s0 = gf2.srl(sstar[q : q + 1], r) & 1
    w = gf2.shift_left_static(inv, s_degree, n_limbs) & -s0
    w[0] ^= 1  # bit d and up hold the series; bit 0 is X^0 mod S = 1
    return w


def _check_small(sstar: torch.Tensor, n_bits: int, assemble) -> int:
    """Checks M3's operands; returns its output limbs."""
    _check_series(sstar, n_bits, "series_small")
    if assemble is None:
        return -(-n_bits // gf2.LIMB_BITS)
    d, n_limbs = assemble
    if gf2.bit_capacity(n_limbs) - d != n_bits or not 0 <= d < gf2.bit_capacity(sstar.shape[0]):
        raise ValueError(f"series_small assembles the mask of {n_limbs} limbs at degree {d} "
                         f"from {n_bits} series bits and S* of {sstar.shape[0]} limbs: they "
                         "do not agree")
    return n_limbs


def series_small_plain(sstar: torch.Tensor, n_bits: int,
                       assemble: "tuple[int, int] | None" = None) -> torch.Tensor:
    """Plain torch version of M3: ``1 / S* mod X^n_bits`` from ``I = 1`` by
    :func:`newton_step_plain` at each of :func:`precisions`, [ceil(n_bits/32)]
    limbs; with ``assemble = (d, n_limbs)`` (``n_bits = 32 n_limbs - d``)
    the mask of :func:`assemble_mask` instead."""
    _check_small(sstar, n_bits, assemble)
    inv = torch.ones(1, dtype=gf2.LIMB_DTYPE, device=sstar.device)
    for k in precisions(n_bits):
        inv = newton_step_plain(inv, sstar, k)
    return inv if assemble is None else assemble_mask(inv, sstar, *assemble)


def series_small(sstar: torch.Tensor, n_bits: int,
                 assemble: "tuple[int, int] | None" = None) -> torch.Tensor:
    """M3's wrapper: every Newton step from ``I = 1`` up to ``n_bits`` bits
    (at most :data:`SMALL_MAX_LIMBS` limbs on the card) in one launch of one
    block: [ceil(n_bits/32)] limbs of ``1 / S* mod X^n_bits``, the bits from
    ``n_bits`` up zero; with ``assemble = (d, n_limbs)`` the decrypt mask
    ``1 + S(0) X^d (1 / S*) mod X^(32 n_limbs)``, [n_limbs] limbs.

    A CPU tensor gets :func:`series_small_plain`; a CUDA tensor launches
    ``hm_series_small`` (``csrc/mask.cu``) on the current stream (and
    counts the launch) or raises."""
    n_out = _check_small(sstar, n_bits, assemble)
    if sstar.device.type == "cpu":
        return series_small_plain(sstar, n_bits, assemble)
    if sstar.device.type != "cuda":
        raise ValueError(f"series_small runs on cpu or cuda, not {sstar.device}")
    if -(-n_bits // gf2.LIMB_BITS) > SMALL_MAX_LIMBS or sstar.shape[0] > TABLE_MAX_LIMBS:
        raise ValueError(f"series_small runs up to {SMALL_MAX_LIMBS} limbs with S* of at most "
                         f"{TABLE_MAX_LIMBS}, not {n_bits} bits with {sstar.shape[0]} limbs")
    d, n_limbs = assemble if assemble is not None else (0, 0)
    out = torch.empty(n_out, dtype=gf2.LIMB_DTYPE, device=sstar.device)
    with torch.cuda.device(sstar.device):
        err = _kernel("hm_series_small", _SMALL_ARGS)(
            sstar.data_ptr(), sstar.shape[0], n_bits, out.data_ptr(), d, n_limbs,
            int(assemble is not None), _stream(sstar))
    if err:
        raise RuntimeError(f"series_small kernel launch failed: cudaError {err}")
    counters.add("M3")
    return out



def reversed_key(s: torch.Tensor, s_degree: int) -> torch.Tensor:
    """``S* = X^d S(1/X)``: the ``d + 1`` coefficients of ``S`` in reverse
    order, [limbs_for(d)] limbs on ``s``'s device.  ``s`` is fitted to the
    degree's limbs first (a key read from the reference's 64-bit-word bytes
    may carry a trailing zero limb; trimming is sound because deg S = d).
    The limbs are taken in reverse order and each limb's bits reversed by
    five swaps of halves, which reverses all ``32 Ls`` bits; ``S*`` is that
    shifted down by the ``31 - d % 32`` zeros above bit ``d``: about 35
    elementwise ops, once per key."""
    Ls = gf2.limbs_for(s_degree)
    x = gf2.fit_limbs(s, Ls).flip(-1)
    for shift, keep in ((16, 0xFFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333),
                        (1, 0x55555555)):
        x = (gf2.srl(x, shift) & keep) | ((x & keep) << shift)
    k = gf2.LIMB_BITS - 1 - s_degree % gf2.LIMB_BITS
    if k == 0:
        return x
    return gf2.srl(x, k) | (F.pad(x[..., 1:], (0, 1)) << (gf2.LIMB_BITS - k))


def precisions(n_bits: int) -> "list[int]":
    """The Newton steps' precisions up to ``n_bits``: ``n_bits`` halved
    (rounding up) down to 1, in increasing order, without the 1."""
    steps = [n_bits]
    while steps[-1] > 1:
        steps.append(-(-steps[-1] // 2))
    return steps[-2::-1]


def newton_plan(n_bits: int, Ls: int, cap: int = SMALL_CAP) -> "list[tuple[str, int]]":
    """``(kind, k)`` for each precision ``k`` of :func:`precisions`
    (``n_bits``), ``kind`` one of ``"M3"``, ``"M2"`` and ``"route"`` (see
    the module's note), for ``S*`` of ``Ls`` limbs: M3 while a step's
    output has at most ``cap`` limbs (and :data:`SMALL_MAX_LIMBS`), then
    M2; all route where ``S*`` passes :data:`TABLE_MAX_LIMBS`.  Output limbs
    grow with ``k``, so the M3 steps come first."""
    plan = []
    for k in precisions(n_bits):
        Lo = -(-k // gf2.LIMB_BITS)
        if Ls > TABLE_MAX_LIMBS:
            kind = "route"
        elif Lo <= min(cap, SMALL_MAX_LIMBS):
            kind = "M3"
        else:
            kind = "M2"
        plan.append((kind, k))
    return plan


def mask_plan(s_degree: int, n_limbs: int, cap: int = SMALL_CAP) -> "list[tuple[str, int]]":
    """The steps of the decrypt mask of ``n_limbs`` limbs under a key of
    degree ``d``: :func:`newton_plan` of its ``32 n_limbs - d`` series bits
    and ``S*``'s ``limbs_for(d)`` limbs (no step where ``32 n_limbs <=
    d``).  ``cap`` defaults to the measured :data:`SMALL_CAP`; the tests
    pass others to force every step onto M3 or M2."""
    n_bits = gf2.bit_capacity(n_limbs) - s_degree
    if n_bits < 1:
        return []
    return newton_plan(n_bits, gf2.limbs_for(s_degree), cap)


def _check_plan(plan, n_bits: int) -> int:
    """Checks that ``plan`` runs :func:`precisions` (``n_bits``) with its M3
    steps first; returns how many M3 steps lead it."""
    if [k for _, k in plan] != precisions(n_bits):
        raise ValueError(f"a plan for {n_bits} bits runs the precisions {precisions(n_bits)}, "
                         f"not {[k for _, k in plan]}")
    kinds = [kind for kind, _ in plan]
    n_small = next((i for i, kind in enumerate(kinds) if kind != "M3"), len(kinds))
    if any(kind not in ("M2", "route") for kind in kinds[n_small:]):
        raise ValueError(f"a plan runs its M3 steps first, then M2 and route steps: {kinds}")
    return n_small


def series_inverse(sstar: torch.Tensor, n_bits: int,
                   plan: "list[tuple[str, int]] | None" = None) -> torch.Tensor:
    """``1 / S* mod X^n_bits``, [ceil(n_bits/32)] limbs on ``sstar``'s
    device with the bits from ``n_bits`` up zero.  ``sstar`` holds ``S*``
    ([Ls] limbs, bit 0 set).  Runs ``plan`` (default :func:`newton_plan`
    at the measured cap): its leading M3 steps as one
    :func:`series_small`, then one :func:`newton_step` an M2 step, and for
    a route step M1 and a product by ``S*``, cut to the limbs the precision
    can see, through the clmul dispatcher.  The K1 launches of the route
    steps are counted as ``mask.K1`` too."""
    if n_bits < 1:
        raise ValueError(f"a series inverse needs at least one bit, not {n_bits}")
    sstar = sstar.reshape(-1)
    Ls = sstar.shape[0]
    plan = newton_plan(n_bits, Ls) if plan is None else list(plan)
    n_small = _check_plan(plan, n_bits)
    if n_small:
        inv = series_small(sstar, plan[n_small - 1][1])
    else:
        inv = torch.ones(1, dtype=gf2.LIMB_DTYPE, device=sstar.device)
    before = counters["K1"]
    for kind, k in plan[n_small:]:
        if kind == "M2":
            inv = newton_step(inv, sstar, k)
            continue
        Lo = -(-k // gf2.LIMB_BITS)
        sq = square(inv.view(1, -1), k)
        # S* first: the plain sweep's planes are [rows of its first
        # operand, both widths], so the narrow operand leads
        inv = gf2k.clmul(sstar[: min(Ls, Lo)].view(1, -1), sq)[0, :Lo]
    counters.add("mask.K1", counters["K1"] - before)
    if plan and plan[-1][0] == "route":  # a route step leaves bits above k set
        inv = _truncate(inv.clone(), n_bits)
    return inv



def series_mask(sstar: torch.Tensor, s_degree: int, n_limbs: int,
                plan: "list[tuple[str, int]] | None" = None) -> torch.Tensor:
    """The decrypt mask ``1 + S(0) X^d (1 / S*) mod X^(32 n_limbs)``,
    [n_limbs] limbs, for ``32 n_limbs > d``, by the steps of ``plan``
    (default :func:`mask_plan`): a plan of M3 steps only is one
    :func:`series_small` launch that assembles the mask too; any other runs
    :func:`series_inverse` and :func:`assemble_mask`."""
    n_bits = gf2.bit_capacity(n_limbs) - s_degree
    plan = mask_plan(s_degree, n_limbs) if plan is None else list(plan)
    with span("mask.series"):
        if _check_plan(plan, n_bits) == len(plan):
            return series_small(sstar, n_bits, assemble=(s_degree, n_limbs))
        return assemble_mask(series_inverse(sstar, n_bits, plan), sstar, s_degree, n_limbs)


def launch_counts() -> "dict[str, int]":
    """The mask kernels' launches from the program's counters: M1, the
    route steps' K1 share (``mask.K1``), M2 and M3 (a CPU call counts
    nothing)."""
    return {"M1": counters["M1"], "K1": counters["mask.K1"], "M2": counters["M2"],
            "M3": counters["M3"]}
