"""The clmul dispatcher and its CUDA kernel (K1).

Counterpart of :mod:`homomorph_tpu.gf2.kernels`.  :func:`clmul` broadcasts
the leading dimensions as the JAX dispatcher does (``kernels.py:179-185``),
flattens both operands to [B, L] rows and hands them to
:func:`clmul_flat`, the kernel's wrapper:

* on a CUDA tensor it launches ``csrc/clmul.cu`` (one thread per output
  limb, see the note in that file) or raises;
* on a CPU tensor it computes :func:`clmul_plain`, the 32-plane sweep of
  :func:`homomorph_tpu_torch.gf2.poly.clmul`, chunked over the batch.

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

from . import poly as gf2

__all__ = ["clmul", "clmul_flat", "clmul_plain"]

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
