"""The decrypt mask as a power-series inverse, and its squaring kernel (M1).

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
(:func:`reversed_key`); ``S*(0) = 1``, so ``1 / S*`` is a power series.
:func:`series_inverse` computes it by Newton's iteration, which over GF(2)
reads ``I' = S* * I^2 mod X^k'`` for any ``k' <= 2k`` when ``I`` holds ``k``
bits: each step is one squaring (M1, :func:`square`) and one product by
``S*`` (K1, through :func:`homomorph_tpu_torch.gf2.kernels.clmul` and its
Karatsuba route, so the limb-mesh hook sees it too).  The precisions run
``1, ..., ceil(m/4), ceil(m/2), m`` for the ``m = n - d`` bits the mask
needs, so the last step lands on ``m`` and none is wasted.
:func:`homomorph_tpu_torch.gf2.poly.decrypt_mask` assembles the mask.

M1 (``csrc/mask.cu``) maps [B, L] limbs to [B, Lo] limbs, ``Lo <= 2L``:
bit ``j`` of the input moves to bit ``2j`` (a square in GF(2)[X] has no
cross terms), and the output stops at ``n_bits`` bits.  :func:`square` is
its wrapper: on a CUDA tensor it launches the kernel or raises, on a CPU
tensor it computes :func:`square_plain`.  Between steps the series is not
truncated to its ``k`` bits: the bits of its last limb above ``k`` move to
positions ``>= 2k >= k'`` when squared, which M1's truncation drops.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import kernels as gf2k
from . import poly as gf2

__all__ = ["square", "square_plain", "reversed_key", "series_inverse", "precisions"]

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from .cuda_build import library

        fn = library("mask").hm_square
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_uint, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


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
    Lo, rem = _out_shape(x, n_bits)
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
        stream = torch.cuda.current_stream().cuda_stream
        tail = (1 << rem) - 1 if rem else 0xFFFFFFFF
        err = _kernel()(x.data_ptr(), out.data_ptr(), B, L, Lo, tail, stream)
    if err:
        raise RuntimeError(f"square kernel launch failed: cudaError {err}")
    square.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (a plain integer)
square.launches = 0


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


def series_inverse(sstar: torch.Tensor, n_bits: int) -> torch.Tensor:
    """``1 / S* mod X^n_bits``, [ceil(n_bits/32)] limbs on ``sstar``'s
    device with the bits from ``n_bits`` up zero.  ``sstar`` holds ``S*``
    ([Ls] limbs, bit 0 set).  Starts at ``I = 1`` and runs one M1 and one K1
    product a precision of :func:`precisions`; the product's operand ``S*``
    is cut to the limbs the precision can see.  The K1 launches it makes
    are counted on :attr:`series_inverse.k1_launches` too."""
    if n_bits < 1:
        raise ValueError(f"a series inverse needs at least one bit, not {n_bits}")
    sstar = sstar.reshape(1, -1)
    inv = torch.ones((1, 1), dtype=gf2.LIMB_DTYPE, device=sstar.device)
    before = gf2k.clmul_flat.launches
    for k in precisions(n_bits):
        Lo = -(-k // gf2.LIMB_BITS)
        sq = square(inv, k)
        # S* first: the plain sweep's planes are [rows of its first
        # operand, both widths], so the narrow operand leads
        inv = gf2k.clmul(sstar[:, : min(sstar.shape[1], Lo)], sq)[:, :Lo]
    series_inverse.k1_launches += gf2k.clmul_flat.launches - before
    out = inv.reshape(-1).clone()
    if n_bits % gf2.LIMB_BITS:
        out[-1] &= (1 << (n_bits % gf2.LIMB_BITS)) - 1
    return out


#: K1 launches made by :func:`series_inverse` since the last reset, a share
#: of ``kernels.clmul_flat.launches`` (a plain integer)
series_inverse.k1_launches = 0
