"""Batched encryption from packed selection words, and its CUDA kernel (K2).

Counterpart of :mod:`homomorph_tpu.gf2.encrypt_kernel`.  Each plaintext bit
``x`` of a flat batch is encrypted as ``C = (XOR_{i in U} T_i) + x``
(src/cipher.rs:92-115), with the subset ``U`` given as packed selection
words ``selw`` [B, ceil(tau/32)].

Over GF(2) the subset XOR-sum needs no matmul: bit ``j`` of ``C`` is the
parity of ``selw[b] & pkcol[j]``, where ``pkcol`` [D, W] packs each bit
column of the public key along tau (:func:`pk_columns`, cached by
:class:`~homomorph_tpu_torch.keys.PublicKey`).  :func:`encrypt_bits_fused`
is the kernel's wrapper: on a CUDA tensor it launches ``csrc/encrypt.cu``
(see the note in that file) or raises; on a CPU tensor it computes
:func:`encrypt_plain`, which takes the counts as a float matmul the way the
JAX package does and so checks the kernel by another route.

The TPU-only devices of the JAX module (the bf16 pk-row permutation, the
MXU pack, the segmented ``lax.map`` and the plaintext fold) have no
counterpart: they were workarounds for the TPU's memory and lane layout.
"""

from __future__ import annotations

import ctypes

import torch

from . import poly as gf2

__all__ = ["pk_columns", "encrypt_bits_fused", "encrypt_plain"]

# cap on the [rows, 32*W + D] float intermediates of the plain version
_PLAIN_ELEM_CAP = 1 << 26

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from .cuda_build import library

        fn = library("encrypt").hm_encrypt
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def pk_columns(pk_limbs: torch.Tensor) -> torch.Tensor:
    """Public-key bit columns packed along tau: [tau, Lpk] -> [32*Lpk, W].

    Word ``w`` of column ``j`` holds bit ``j`` of the rows ``T_{32w}`` ..
    ``T_{32w+31}``; rows beyond tau are zero."""
    bits = gf2.unpack_bits(pk_limbs, gf2.bit_capacity(pk_limbs.shape[-1]))
    return gf2.pack_bits(bits.T.contiguous())


def encrypt_plain(
    selw: torch.Tensor, pkcol: torch.Tensor, plain: torch.Tensor, L: int
) -> torch.Tensor:
    """Plain torch version of the kernel: counts as a float matmul.

    The counts ``sel @ pk_bits`` are exact in float32 (0/1 inputs, sums
    below 2^24); their parities are packed into ``L`` limbs and the
    plaintext bit is XORed into limb 0.  Chunked over rows to bound the
    intermediates."""
    B, W = selw.shape
    D = pkcol.shape[0]
    pk_bits = gf2.unpack_bits(pkcol, gf2.bit_capacity(W), dtype=torch.float32).T
    chunk = max(1, _PLAIN_ELEM_CAP // (gf2.bit_capacity(W) + D))
    parts = []
    for r in range(0, B, chunk):
        sel = gf2.unpack_bits(selw[r : r + chunk], gf2.bit_capacity(W), dtype=torch.float32)
        parts.append(gf2.parity_pack(sel @ pk_bits, L))
    out = torch.cat(parts) if parts else torch.zeros((0, L), dtype=gf2.LIMB_DTYPE, device=selw.device)
    return gf2.xor_const_bit(out, plain)


def _check(selw, pkcol, plain, L) -> None:
    for name, t in (("selw", selw), ("pkcol", pkcol), ("plain", plain)):
        if t.dtype != gf2.LIMB_DTYPE:
            raise TypeError(f"encrypt takes int32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"encrypt takes a contiguous {name}")
        if t.device != selw.device:
            raise ValueError(f"encrypt operands on {selw.device} and {t.device}")
    if selw.ndim != 2 or pkcol.ndim != 2 or plain.ndim != 1:
        raise ValueError(
            f"encrypt takes selw [B, W], pkcol [D, W], plain [B]; got "
            f"{tuple(selw.shape)}, {tuple(pkcol.shape)}, {tuple(plain.shape)}"
        )
    if pkcol.shape[1] != selw.shape[1] or plain.shape[0] != selw.shape[0]:
        raise ValueError(
            f"encrypt shapes disagree: selw {tuple(selw.shape)}, pkcol "
            f"{tuple(pkcol.shape)}, plain {tuple(plain.shape)}"
        )
    if pkcol.shape[0] % gf2.LIMB_BITS or selw.shape[1] == 0 or not 1 <= L <= 65535:
        raise ValueError(
            f"encrypt takes D % 32 == 0, W >= 1 and 1 <= L <= 65535; got "
            f"D={pkcol.shape[0]}, W={selw.shape[1]}, L={L}"
        )


def encrypt_bits_fused(
    selw: torch.Tensor, pkcol: torch.Tensor, plain: torch.Tensor, L: int
) -> torch.Tensor:
    """Encryption of a flat bit batch; the kernel's wrapper.

    ``selw``: [B, W] int32 packed selection words; ``pkcol``: [D, W] from
    :func:`pk_columns`; ``plain``: [B] int32 0/1.  Returns [B, L] int32.
    A CPU tensor gets :func:`encrypt_plain`; a CUDA tensor launches the
    kernel on the current stream (and counts the launch) or raises."""
    _check(selw, pkcol, plain, L)
    if selw.device.type == "cpu":
        return encrypt_plain(selw, pkcol, plain, L)
    if selw.device.type != "cuda":
        raise ValueError(f"encrypt runs on cpu or cuda, not {selw.device}")
    B, W = selw.shape
    out = torch.empty((B, L), dtype=gf2.LIMB_DTYPE, device=selw.device)
    if B == 0:
        return out
    with torch.cuda.device(selw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            selw.data_ptr(), pkcol.data_ptr(), plain.data_ptr(), out.data_ptr(),
            B, W, pkcol.shape[0], L, stream,
        )
    if err:
        raise RuntimeError(f"encrypt kernel launch failed: cudaError {err}")
    encrypt_bits_fused.launches += 1
    return out


#: launches of the CUDA kernel since the last reset (a plain integer)
encrypt_bits_fused.launches = 0
