"""The clmul dispatcher, its Karatsuba route and its CUDA kernel (K1).

Counterpart of :mod:`homomorph_tpu.gf2.kernels`.  :func:`clmul` broadcasts
the leading dimensions as the JAX dispatcher does (``kernels.py:179-185``),
flattens both operands to [B, L] rows and hands them to the route
(:func:`clmul_rows`), which ends in one call of :func:`clmul_flat`, the
kernel's wrapper:

* on a CUDA tensor it launches ``csrc/clmul.cu`` or raises: a 4-bit
  windowed comb (Lopez-Dahab) that stages the 16 multiples ``u*g`` of the
  wider operand in shared memory and adds one funnel-shifted multiple per
  nibble of the smaller one, one thread per output limb (see the note in
  that file); its bound is the comb's shared-memory loads;
* on a CPU tensor it computes :func:`clmul_plain`, the 32-plane sweep of
  :func:`homomorph_tpu_torch.gf2.poly.clmul`, chunked over the batch.

:func:`clmul_comb_plain` follows the kernel's decomposition step by step in
torch (the multiples, then the nibble walk with funnel shifts), so the CPU
tests check its indexing against the JAX package; no path calls it.

**The Karatsuba route** (counterpart of ``_karatsuba_flat`` and of the
chunk branch of ``_clmul_flat``, ``kernels.py:212-225, 356-387``).  When
the smaller operand has at least :func:`karatsuba_min` limbs, the product
is cut as the JAX package cuts it: a wider operand of more than
``3*Ls//2`` limbs into ``Ls``-limb pieces, and a balanced product at
``h = (L+1)//2`` of the wider operand's ``L`` limbs (the smaller one padded
to ``L``) into ``a0*b0``, ``a1*b1`` and ``(a0^a1)*(b0^b1)``, with
``mid = pm ^ p0 ^ p2`` and the output truncated to ``Ls + Lg``.  The JAX
package recurses product by product; here each level is one step on all
rows at once (:func:`route_plan`): the pieces, and the three half-products
(``a1``, ``b1`` padded to ``h``), are stacked on the row axis, so every row
of a level has one width and the split needs no clmul.  Below the
threshold, ONE K1 launch takes all ``3^k * B`` rows (times the pieces),
and the levels unwind with XORs at static offsets: a routed product costs
one launch and ``O(k)`` torch ops, where recursing call by call would cost
``3^k`` launches.  Padding (odd ``L``, a last piece narrower than ``Ls``)
only adds zero limbs, so every route gives the same bits.

The route runs on CUDA tensors from the threshold up.  On a CPU tensor the
plain version runs unrouted, as the JAX package gates Karatsuba to TPU
backends, unless ``HOMOMORPH_TPU_TORCH_FORCE_KARATSUBA=1``; then the same
decomposition runs over :func:`clmul_plain`, which is how the CPU tests
cover its indexing.  ``HOMOMORPH_TPU_TORCH_KARATSUBA_MIN`` overrides the
threshold.  Both are read at each call.

**Not ported as routes: the strips and the blocked scan**
(``kernels.py:244-254, 257-353``).  The strips exist because the Pallas
body unrolls over at most 48 limbs of the smaller operand; the scan exists
to bound the XLA trace, Mosaic compile time and VMEM at u32 widths.  K1
takes any widths (it tiles its output at 512 limbs and its windows at 64,
``csrc/clmul.cu``) and eager PyTorch has no trace to bound.  The scan's
other idea, laying blocks of a wide operand onto rows so that small
batches fill the machine, is what the stacked pieces and levels do here.
"""

from __future__ import annotations

import ctypes
import math
import os

import torch
import torch.nn.functional as F

from . import poly as gf2

__all__ = [
    "clmul", "clmul_rows", "clmul_flat", "clmul_plain", "clmul_comb_plain",
    "karatsuba_min", "route_plan",
]

# cap on the [batch, La, Lb] planes the plain sweep materializes at once
_PLAIN_ELEM_CAP = 1 << 22

KARATSUBA_MIN_ENV = "HOMOMORPH_TPU_TORCH_KARATSUBA_MIN"
FORCE_KARATSUBA_ENV = "HOMOMORPH_TPU_TORCH_FORCE_KARATSUBA"
# Smallest width (limbs) of the smaller operand from which the route takes a
# level: the crossover of chip_smoke.py's route sweep (phase 3c) on an NVIDIA
# H100 80GB HBM3 at 700 W, where one level first beats a direct K1 launch at
# 64 limbs and keeps winning above (PERF.md section 6, the route sweep).
_KARATSUBA_MIN = 64

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from .cuda_build import library

        fn = library("clmul").hm_clmul
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def clmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched carry-less multiply: [..., La] x [..., Lb] -> [..., La+Lb].

    Same contract as :func:`homomorph_tpu_torch.gf2.poly.clmul`, with the
    leading dims broadcast (keygen multiplies a [tau, Lq] operand by an
    [Ls] one)."""
    La, Lb = a.shape[-1], b.shape[-1]
    lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    batch = math.prod(lead)
    af = a.expand(*lead, La).reshape(batch, La).contiguous()
    bf = b.expand(*lead, Lb).reshape(batch, Lb).contiguous()
    return clmul_rows(af, bf).reshape(*lead, La + Lb)


def karatsuba_min() -> int:
    """The route's threshold: ``HOMOMORPH_TPU_TORCH_KARATSUBA_MIN`` if set,
    else :data:`_KARATSUBA_MIN`; at least 2, where a split still narrows."""
    return max(2, int(os.environ.get(KARATSUBA_MIN_ENV, _KARATSUBA_MIN)))


def route_plan(Ls: int, Lg: int, kmin: int) -> "list[tuple[str, int, int, int]]":
    """The levels of an ``Ls x Lg`` product (``Ls <= Lg``) down to the
    threshold ``kmin``: ``("chunk", Ls, Lg, n)`` cuts the wider operand
    into ``n`` pieces of ``Ls`` limbs (rows times ``n``), and ``("split",
    Ls, Lg, h)`` halves a balanced product at ``h`` (rows times 3).  The
    launch then takes operands of the last level's width."""
    steps = []
    while Ls >= kmin:
        if Lg > (3 * Ls) // 2:
            n = -(-Lg // Ls)
            steps.append(("chunk", Ls, Lg, n))
            Lg = Ls
        else:
            h = (Lg + 1) // 2
            steps.append(("split", Ls, Lg, h))
            Ls = Lg = h
    return steps


def _routed(device: torch.device) -> bool:
    return device.type == "cuda" or os.environ.get(FORCE_KARATSUBA_ENV, "0") == "1"


def clmul_rows(af: torch.Tensor, bf: torch.Tensor) -> torch.Tensor:
    """The dispatcher on flat rows: [B, La] x [B, Lb] -> [B, La+Lb] through
    the Karatsuba route (:func:`route_plan`) and ONE :func:`clmul_flat`."""
    small, big = (af, bf) if af.shape[1] <= bf.shape[1] else (bf, af)
    steps = route_plan(small.shape[1], big.shape[1], karatsuba_min())
    if not steps or af.shape[0] == 0 or not _routed(af.device):
        return clmul_flat(af, bf)
    rows = []
    for kind, Ls, Lg, n in steps:
        rows.append(small.shape[0])
        if kind == "chunk":
            big = F.pad(big, (0, n * Ls - Lg)).reshape(-1, Ls)
            small = small.repeat_interleave(n, dim=0)
        else:
            small, big = _halves(small, n), _halves(big, n)
    p = clmul_flat(small, big)
    for (kind, Ls, Lg, n), B in zip(reversed(steps), reversed(rows)):
        p = _join_pieces(p, B, Ls, Lg, n) if kind == "chunk" else _join_halves(p, B, Ls, Lg, n)
    return p


def _halves(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B, L'] with L' <= 2h -> [3B, h]: the rows of ``x0``, of ``x1``
    (padded to ``h``) and of ``x0 ^ x1``, stacked in that order."""
    xp = F.pad(x, (0, 2 * h - x.shape[1])).reshape(x.shape[0], 2, h)
    x0, x1 = xp[:, 0], xp[:, 1]
    return torch.cat([x0, x1, x0 ^ x1])


def _join_halves(p: torch.Tensor, B: int, Ls: int, Lg: int, h: int) -> torch.Tensor:
    """[3B, 2h] products of :func:`_halves`' rows -> [B, Ls+Lg]:
    ``p0 ^ (pm ^ p0 ^ p2) X^h ^ p2 X^2h``.  Every term's limbs past
    ``Ls + Lg`` are zero, so each is truncated on its own."""
    Lo = Ls + Lg
    p0, p2, pm = p.view(3, B, 2 * h).unbind(0)
    pm ^= p0
    pm ^= p2
    out = p.new_empty((B, Lo))
    out[:, : 2 * h] = p0
    out[:, 2 * h :] = p2[:, : Lo - 2 * h]
    w = min(2 * h, Lo - h)
    out[:, h : h + w] ^= pm[:, :w]
    return out


def _join_pieces(p: torch.Tensor, B: int, Ls: int, Lg: int, n: int) -> torch.Tensor:
    """[B*n, 2Ls] piece products -> [B, Ls+Lg]: piece ``j`` lands at limb
    ``j*Ls``, so the even pieces tile from 0 and the odd ones from ``Ls``."""
    p = p.view(B, n, 2 * Ls)
    even = p[:, 0::2].reshape(B, -1)
    out = F.pad(even, (0, (n + 1) * Ls - even.shape[1]))
    if n > 1:
        odd = p[:, 1::2].reshape(B, -1)
        out[:, Ls : Ls + odd.shape[1]] ^= odd
    return out[:, : Ls + Lg].contiguous()


def clmul_plain(af: torch.Tensor, bf: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel: flat [B, La] x [B, Lb] -> [B, La+Lb],
    the 32-plane sweep chunked over the rows (:func:`~homomorph_tpu_torch.
    gf2.poly.clmul_chunked`)."""
    return gf2.clmul_chunked(af, bf, cap=_PLAIN_ELEM_CAP)


def _funnel_l(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """CUDA's ``__funnelshift_l(lo, hi, n)`` for a static 0 <= n < 32: the
    high word of ``(hi:lo) << n``."""
    return hi if n == 0 else (hi << n) | gf2.srl(lo, gf2.LIMB_BITS - n)


def clmul_comb_plain(af: torch.Tensor, bf: torch.Tensor) -> torch.Tensor:
    """The kernel's comb in torch: flat [B, La] x [B, Lb] -> [B, La+Lb].

    Builds the 16 multiples ``T[u] = u*g`` ([B, 16, Lg+1]) of the wider
    operand ``g`` from ``g, 2g, 4g, 8g``, then for each limb ``i`` and
    nibble ``w`` of the smaller operand XORs ``funnel_l(T[nib][j-1],
    T[nib][j], 4w)`` into output limb ``i + j``, as ``csrc/clmul.cu`` does
    for each of its threads."""
    small, big = (af, bf) if af.shape[1] <= bf.shape[1] else (bf, af)
    B, Ls = small.shape
    Lg = big.shape[1]
    gp = F.pad(big, (1, 1))  # gp[:, j + 1] = g[j] for j = -1 .. Lg
    t1 = gp[:, 1:]
    t2, t4, t8 = (_funnel_l(gp[:, :-1], gp[:, 1:], n) for n in (1, 2, 3))
    T = torch.zeros((B, 16, Lg + 1), dtype=gf2.LIMB_DTYPE, device=af.device)
    for u in range(1, 16):
        for bit, t in ((1, t1), (2, t2), (4, t4), (8, t8)):
            if u & bit:
                T[:, u] ^= t
    Tp = F.pad(T, (1, 1))  # Tp[:, u, j + 1] = T[u][j] for j = -1 .. Lg + 1
    rows = torch.arange(B, device=af.device)
    out = torch.zeros((B, Ls + Lg + 1), dtype=gf2.LIMB_DTYPE, device=af.device)
    for i in range(Ls):
        for w in range(8):
            Tn = Tp[rows, (gf2.srl(small[:, i], 4 * w) & 15).long()]  # [B, Lg + 3]
            out[:, i : i + Lg + 2] ^= _funnel_l(Tn[:, :-1], Tn[:, 1:], 4 * w)
    return out[:, : Ls + Lg].contiguous()  # limb Ls+Lg only ever gets zeros


def _check(af: torch.Tensor, bf: torch.Tensor) -> None:
    if af.dtype != gf2.LIMB_DTYPE or bf.dtype != gf2.LIMB_DTYPE:
        raise TypeError(f"clmul takes int32 limbs, got {af.dtype} and {bf.dtype}")
    if af.ndim != 2 or bf.ndim != 2 or af.shape[0] != bf.shape[0]:
        raise ValueError(f"clmul takes [B, La] and [B, Lb], got {tuple(af.shape)} and {tuple(bf.shape)}")
    if af.shape[1] == 0 or bf.shape[1] == 0:
        raise ValueError("clmul operands need at least one limb")
    if af.device != bf.device:
        raise ValueError(f"clmul operands on {af.device} and {bf.device}")
    if not (af.is_contiguous() and bf.is_contiguous()):
        raise ValueError("clmul takes contiguous operands")


def clmul_flat(af: torch.Tensor, bf: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: flat [B, La] x [B, Lb] -> [B, La+Lb] int32.

    A CPU tensor gets :func:`clmul_plain`; a CUDA tensor launches the
    kernel on the current stream (and counts the launch) or raises.  A
    tensor on PyTorch's ``meta`` device gets an empty output of the
    product's shape and counts nothing: the compiled pipelines read an
    operation's output metadata that way, with no device work."""
    _check(af, bf)
    if af.device.type == "cpu":
        return clmul_plain(af, bf)
    if af.device.type == "meta":
        return torch.empty((af.shape[0], af.shape[1] + bf.shape[1]), dtype=gf2.LIMB_DTYPE,
                           device="meta")
    if af.device.type != "cuda":
        raise ValueError(f"clmul runs on cpu, cuda or meta, not {af.device}")
    B = af.shape[0]
    small, big = (af, bf) if af.shape[1] <= bf.shape[1] else (bf, af)
    out = torch.empty((B, af.shape[1] + bf.shape[1]), dtype=gf2.LIMB_DTYPE, device=af.device)
    if B == 0:
        return out
    with torch.cuda.device(af.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            small.data_ptr(), big.data_ptr(), out.data_ptr(),
            B, small.shape[1], big.shape[1], stream,
        )
    if err:
        raise RuntimeError(f"clmul kernel launch failed: cudaError {err}")
    clmul_flat.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (a plain integer)
clmul_flat.launches = 0
