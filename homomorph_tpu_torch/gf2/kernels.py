"""The clmul dispatcher and its CUDA kernel (K1).

Counterpart of :mod:`homomorph_tpu.gf2.kernels`.  :func:`clmul` broadcasts
the leading dimensions as the JAX dispatcher does (``kernels.py:179-185``),
flattens both operands to [B, L] rows and hands them to
:func:`clmul_flat`, the kernel's wrapper:

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

The kernel takes any operand widths.  The JAX package's strip, Karatsuba
and blocked-scan routes (``kernels.py:107-147, 194-387``) exist because of
VMEM and Mosaic compile limits on the TPU; they and their thresholds wait
for the multiplier slice, where they are measured on the H100.  Every route
gives the same bits.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import poly as gf2

__all__ = ["clmul", "clmul_flat", "clmul_plain", "clmul_comb_plain"]

# cap on the [batch, La, Lb] planes the plain sweep materializes at once
_PLAIN_ELEM_CAP = 1 << 22

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
    return clmul_flat(af, bf).reshape(*lead, La + Lb)


def clmul_plain(af: torch.Tensor, bf: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the kernel: flat [B, La] x [B, Lb] -> [B, La+Lb]."""
    B, La = af.shape
    Lb = bf.shape[1]
    chunk = max(1, _PLAIN_ELEM_CAP // (La * Lb))
    if B <= chunk:
        return gf2.clmul(af, bf)
    return torch.cat(
        [gf2.clmul(af[r : r + chunk], bf[r : r + chunk]) for r in range(0, B, chunk)]
    )


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
    kernel on the current stream (and counts the launch) or raises."""
    _check(af, bf)
    if af.device.type == "cpu":
        return clmul_plain(af, bf)
    if af.device.type != "cuda":
        raise ValueError(f"clmul runs on cpu or cuda, not {af.device}")
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
