"""Batched encryption from selection bits, and its CUDA kernels (K2, K3, X1).

Counterpart of :mod:`homomorph_tpu.gf2.encrypt_kernel` and of the encrypt
kernel of ``experiments/exp_enc.py``.  Each plaintext bit ``x`` of a flat
batch is encrypted as ``C = (XOR_{i in U} T_i) + x`` (src/cipher.rs:92-115),
with the subset ``U`` given as packed selection words ``selw``
[B, ceil(tau/32)] or, for X1, as a selection already unpacked to int8
``sel`` [B, tau].  Three kernels compute it, each behind a wrapper that
launches it on a CUDA tensor (and counts the launch) or raises, and
computes a plain torch version on a CPU tensor:

* K2 :func:`encrypt_words_table` (``csrc/encrypt.cu``) does no product at
  all: it XORs key rows by table lookup ("Four Russians").  For each byte
  of the selection words a block holds in shared memory the table of all
  256 XOR combinations of the byte's key rows, built from the key's limbs
  ``pk`` [tau, Lpk], and a ciphertext limb is one lookup per byte.  The
  kernel's launcher picks the key limbs per block and the selection words
  per pass from (tau, limbs) and the card's shared memory;
  :func:`encrypt_tables_plain` follows the same decomposition in torch, for
  the tests.
* K3 :func:`encrypt_words_mma` (``csrc/encrypt_mma.cu``) unpacks the words
  to 0/1 int8 and takes the counts ``sum_k sel[k] * T_k[j]`` as an int8
  tensor-core product (``wgmma``) against the key's bit planes ``planes``
  [D, 32W] (:func:`pk_planes`); bit ``j`` of ``C`` is each count's parity.
* X1 :func:`encrypt_sel_mma` (the same source) takes the same product from
  a pre-unpacked ``sel``.

K3 and X1 run the tile plan of :func:`mma_plan` (column slices of the
planes kept in shared memory, passes over K, 64-row tiles, shared-memory
bytes), which the wrapper passes to the kernel; :func:`encrypt_mma_walk`
walks the same plan in torch, for the tests.

The plain versions (:func:`encrypt_plain`, :func:`encrypt_sel_plain`) take
the counts as a float matmul the way the JAX package does, so they check
the kernels by another route.  :func:`encrypt_bits_fused` is the encrypt
path's entry: it runs K2, or K3 when ``HOMOMORPH_TPU_TORCH_ENC_IMPL`` is
``pallas_v1`` (the counterpart of the JAX package's
``HOMOMORPH_TPU_ENC_IMPL``, read at each eager call; a compiled callable
keeps the value it was captured with).

The TPU-only devices of the JAX module (the bf16 pk-row permutation, the
MXU and byte-plane packs, the segmented ``lax.map`` and the plaintext
fold) have no counterpart: they were workarounds for the TPU's memory and
lane layout.
"""

from __future__ import annotations

import ctypes
import os
from typing import Callable, NamedTuple

import torch

from . import poly as gf2
from ..utils.profiling import counters

__all__ = [
    "ENC_IMPL_ENV",
    "pk_columns",
    "pk_planes",
    "encrypt_impl",
    "encrypt_bits_fused",
    "encrypt_words_table",
    "encrypt_words_mma",
    "encrypt_sel_mma",
    "encrypt_plain",
    "encrypt_sel_plain",
    "encrypt_tables_plain",
    "MmaPlan",
    "mma_plan",
    "encrypt_mma_walk",
]

#: environment variable that selects the encrypt kernel, read at each eager
#: call; a compiled callable keeps the value it was captured with
ENC_IMPL_ENV = "HOMOMORPH_TPU_TORCH_ENC_IMPL"
#: its values: K2 (the default) and K3, named as in the JAX package
ENC_IMPLS = ("pallas", "pallas_v1")

# cap on the [rows, 32*W + D] float intermediates of the plain versions
_PLAIN_ELEM_CAP = 1 << 26
# K2's selection bits per chunk: one byte
_CHUNK_BITS = 8

_fns: dict = {}


_PTRS = [ctypes.c_void_p] * 4
# the mma entries: pointers, B, (W or tau), D, L, the plan (MmaPlan's fields
# as int64), and the stream
_MMA_ARGS = (_PTRS + [ctypes.c_longlong] + [ctypes.c_int] * 3
             + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
_TABLE_ARGS = _PTRS + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _kernel(library_name: str, symbol: str, argtypes=_MMA_ARGS):
    fn = _fns.get(symbol)
    if fn is None:
        from .cuda_build import library

        fn = getattr(library(library_name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def pk_columns(pk_limbs: torch.Tensor) -> torch.Tensor:
    """Public-key bit columns packed along tau: [tau, Lpk] -> [32*Lpk, W].

    Word ``w`` of column ``j`` holds bit ``j`` of the rows ``T_{32w}`` ..
    ``T_{32w+31}``; rows beyond tau are zero."""
    bits = gf2.unpack_bits(pk_limbs, gf2.bit_capacity(pk_limbs.shape[-1]))
    return gf2.pack_bits(bits.T.contiguous())


def pk_planes(pkcol: torch.Tensor) -> torch.Tensor:
    """Public-key bit planes for K3 and X1: [D, W] columns -> [D, 32W] int8
    0/1, k-contiguous, zero beyond tau (the counterpart of the JAX
    package's bf16 ``bit_planes``, transposed)."""
    return gf2.unpack_bits(pkcol, gf2.bit_capacity(pkcol.shape[1]), dtype=torch.int8)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def _parity_counts(sel_rows, pk_bits: torch.Tensor, plain: torch.Tensor, L: int) -> torch.Tensor:
    """Counts ``sel @ pk_bits`` as a float matmul per row chunk, their
    parities packed into ``L`` limbs, the plaintext bit XORed into limb 0.

    The counts are exact in float32 (0/1 inputs, sums below 2^24)."""
    B = plain.shape[0]
    chunk = max(1, _PLAIN_ELEM_CAP // (pk_bits.shape[0] + pk_bits.shape[1]))
    parts = [gf2.parity_pack(sel_rows(r, r + chunk) @ pk_bits, L) for r in range(0, B, chunk)]
    out = torch.cat(parts) if parts else torch.zeros((0, L), dtype=gf2.LIMB_DTYPE, device=plain.device)
    return gf2.xor_const_bit(out, plain)


def encrypt_plain(
    selw: torch.Tensor, planes: torch.Tensor, plain: torch.Tensor, L: int
) -> torch.Tensor:
    """Plain torch version of K2 and K3: the words unpacked to float 0/1,
    counts as a float matmul against ``planes``."""
    K = planes.shape[1]
    pk_bits = planes.to(torch.float32).T
    return _parity_counts(
        lambda r0, r1: gf2.unpack_bits(selw[r0:r1], K, dtype=torch.float32), pk_bits, plain, L
    )


def encrypt_sel_plain(
    sel: torch.Tensor, planes: torch.Tensor, plain: torch.Tensor, L: int
) -> torch.Tensor:
    """Plain torch version of X1: counts of the int8 selection as a float
    matmul against the first tau columns of ``planes``."""
    tau = sel.shape[1]
    pk_bits = planes[:, :tau].to(torch.float32).T
    return _parity_counts(lambda r0, r1: sel[r0:r1].to(torch.float32), pk_bits, plain, L)


def encrypt_tables_plain(
    selw: torch.Tensor, pk: torch.Tensor, plain: torch.Tensor, L: int, plan=None
) -> torch.Tensor:
    """K2's decomposition in torch: ``selw`` [B, W], key limbs ``pk``
    [tau, Lpk], ``plain`` [B] -> [B, L].

    For each tile of ``tw`` key limbs and each pass of ``nw`` selection
    words (``plan`` = (tw, nw), by default one tile and one pass), builds
    the byte tables the way the kernel does, entry ``v`` from ``v`` without
    its top bit ``b`` XOR key row ``8*j + b``, and XORs one entry per byte
    into each row's limbs.  Every plan gives the same bits."""
    tau, Lpk = pk.shape
    B, W = selw.shape
    Lt = min(Lpk, L)
    tw, nw = plan or (Lt, W)
    k = _CHUNK_BITS
    cpw, n_chunks = gf2.LIMB_BITS // k, -(-tau // k)
    rows = torch.zeros((n_chunks * k, Lpk), dtype=gf2.LIMB_DTYPE, device=pk.device)
    rows[:tau] = pk  # key rows beyond tau are zero
    out = torch.zeros((B, L), dtype=gf2.LIMB_DTYPE, device=selw.device)
    for m0 in range(0, Lt, tw):
        t = min(tw, Lt - m0)
        for w0 in range(0, W, nw):
            c0 = w0 * cpw
            nch = min(nw * cpw, n_chunks - c0)
            keys = rows[c0 * k : (c0 + nch) * k, m0 : m0 + t].reshape(nch, k, t)
            table = torch.zeros((nch, 1, t), dtype=gf2.LIMB_DTYPE, device=pk.device)
            for b in range(k):  # entries [2^b, 2^(b+1)) from entries [0, 2^b)
                table = torch.cat([table, table ^ keys[:, b : b + 1]], dim=1)
            acc = out[:, m0 : m0 + t]
            for j in range(c0, c0 + nch):
                idx = gf2.srl(selw[:, j // cpw], (j % cpw) * k) & ((1 << k) - 1)
                acc ^= table[j - c0][idx.long()]
    out[:, 0] ^= plain & 1
    return out


# --------------------------------------------------------------------------
# K3's and X1's tile plan
# --------------------------------------------------------------------------

#: consumer warpgroups in a block of ``csrc/encrypt_mma.cu`` (128 threads each)
MMA_WARPGROUPS = 4
#: rows of a warpgroup's tile (``wgmma``'s m64)
MMA_TILE_ROWS = 64
#: limbs (32 columns each) of the widest ``wgmma`` tile, m64n96k32
MMA_TILE_LIMBS = 3
#: dynamic shared memory a block may use on the H100 (227 KB)
MMA_SMEM_CAP = 232_448
# k-steps (32 bytes of K) of A fragments a thread holds at once
_MMA_KSTEPS = 8


class MmaPlan(NamedTuple):
    """How ``csrc/encrypt_mma.cu`` cuts a [B, 32W] x [32W, D] count product.

    The block of ``slice_limbs`` limbs (``32 * slice_limbs`` plane rows) by
    ``kc`` bytes of K stays in shared memory while the block's warpgroups
    walk their 64-row tiles; ``n_pass`` passes over K XOR their parities
    together; every row tile of a slice goes through :meth:`col_tiles`.
    K is padded with zeros to ``Kq``, so that every run of ``wgmma`` k-steps
    has a length the kernel unrolls (1, 2, 4 or 8)."""

    W: int  # selection words a row
    Kp: int  # 32 * W, the planes' width
    Kq: int  # K padded with zeros to 1, 2 or 4 k-steps or a multiple of 8
    Lc: int  # limbs that have key columns: min(L, D // 32); limbs beyond are 0
    kc: int  # bytes of K a pass: 32, 64, 128 or a multiple of 256
    n_pass: int
    slice_limbs: int  # limbs a column slice computes (the last may have fewer)
    n_slices: int
    stage_stride: int  # words a row of a warpgroup's output stage (odd)
    row_tiles: int
    groups: int  # blocks on each slice; a block's warpgroups stride over the row tiles
    smem_bytes: int

    def col_tiles(self, limbs: int) -> list[tuple[int, int]]:
        """The slice-local limb ranges of one ``wgmma`` tile each, at most
        :data:`MMA_TILE_LIMBS` wide, as even as they go."""
        n = -(-limbs // MMA_TILE_LIMBS)
        return [(i * limbs // n, (i + 1) * limbs // n) for i in range(n)]


def _mma_smem(limbs: int, kc: int) -> tuple[int, int]:
    stride = limbs | 1  # an odd stride spreads a warp's rows over the banks
    return limbs * 32 * kc + MMA_WARPGROUPS * MMA_TILE_ROWS * 4 * stride, stride


def mma_plan(B: int, tau: int, D: int, L: int, sms: int = 132,
             smem_cap: int = MMA_SMEM_CAP) -> MmaPlan:
    """K3's and X1's plan for ``B`` rows of ``tau`` selection bits, ``D``
    plane rows and ``L`` output limbs on ``sms`` SMs.

    All of K in one pass when one tile's limbs fit ``smem_cap`` with it,
    else the most that fits; then the widest column slice that fits, the
    slices evened out; one block per SM in all (at least one a slice)."""
    W = -(-tau // 32)
    Kp = 32 * W
    steps = _MMA_KSTEPS * -(-W // _MMA_KSTEPS) if W > _MMA_KSTEPS else 1 << (W - 1).bit_length()
    Kq = 32 * steps
    Lc = min(L, D // 32)
    first = min(Lc, MMA_TILE_LIMBS)
    stage = _mma_smem(first, 0)[0]
    fits = (smem_cap - stage) // (first * 32)  # bytes of K one tile's limbs may hold
    if fits < 32:
        raise ValueError(f"no tile plan fits {smem_cap} bytes of shared memory")
    run = 32 * _MMA_KSTEPS  # a pass is a whole number of unrolled runs
    if Kq <= fits:
        kc = Kq
    elif fits >= run:
        kc = fits // run * run
    else:
        kc = 1 << (fits.bit_length() - 1)  # 32, 64 or 128
    n_pass = -(-Kq // kc)
    fit = first
    while fit < Lc and _mma_smem(fit + 1, kc)[0] <= smem_cap:
        fit += 1
    n_slices = -(-Lc // fit)
    slice_limbs = -(-Lc // n_slices)
    n_slices = -(-Lc // slice_limbs)
    smem, stride = _mma_smem(slice_limbs, kc)
    row_tiles = -(-B // MMA_TILE_ROWS)
    groups = max(1, min(-(-row_tiles // MMA_WARPGROUPS), sms // n_slices))
    return MmaPlan(W, Kp, Kq, Lc, kc, n_pass, slice_limbs, n_slices, stride, row_tiles,
                   groups, smem)


def encrypt_mma_walk(
    a: torch.Tensor, planes: torch.Tensor, plain: torch.Tensor, L: int,
    plan: MmaPlan | None = None,
) -> torch.Tensor:
    """K3's and X1's decomposition in torch: ``a`` is ``selw`` [B, W] int32
    words or ``sel`` [B, tau] int8, ``planes`` [D, 32W] -> [B, L].

    Walks ``plan`` (by default :func:`mma_plan`'s) in the kernel's order:
    for each pass over K, each column slice, each 64-row tile and each
    ``wgmma`` tile of the slice, the counts of the tile, their parities
    packed per 32 columns into the stage; the stage then goes out, zero
    for limbs beyond ``Lc`` (the last slice writes them), the plain bit
    XORed into limb 0 in the first pass, and every later pass XORed onto
    what the earlier ones wrote.  Every plan gives the same bits."""
    B = a.shape[0]
    D, Kp = planes.shape
    plan = plan or mma_plan(B, a.shape[1] * (32 if a.dtype == gf2.LIMB_DTYPE else 1), D, L)
    if a.dtype == gf2.LIMB_DTYPE:
        sel = gf2.unpack_bits(a, Kp, dtype=torch.float32)
    else:
        sel = a.to(torch.float32)
    sel = torch.nn.functional.pad(sel, (0, plan.Kq - sel.shape[1]))  # zero K padding
    pk = torch.nn.functional.pad(planes.to(torch.float32), (0, plan.Kq - Kp))
    out = torch.zeros((B, L), dtype=gf2.LIMB_DTYPE, device=a.device)
    for p in range(plan.n_pass):
        k0 = p * plan.kc
        k1 = min(plan.Kq, k0 + plan.kc)
        for s in range(plan.n_slices):
            m0 = s * plan.slice_limbs
            limbs = min(plan.slice_limbs, plan.Lc - m0)
            m_end = L if s == plan.n_slices - 1 else m0 + limbs
            for r0 in range(0, plan.row_tiles * MMA_TILE_ROWS, MMA_TILE_ROWS):
                rows = sel[r0 : r0 + MMA_TILE_ROWS, k0:k1]
                stage = torch.zeros((rows.shape[0], m_end - m0), dtype=gf2.LIMB_DTYPE,
                                    device=a.device)
                for lo, hi in plan.col_tiles(limbs):
                    cols = pk[32 * (m0 + lo) : 32 * (m0 + hi), k0:k1]
                    stage[:, lo:hi] = gf2.parity_pack(rows @ cols.T, hi - lo)
                if p == 0 and m0 == 0:
                    stage[:, 0] ^= plain[r0 : r0 + MMA_TILE_ROWS] & 1
                out[r0 : r0 + MMA_TILE_ROWS, m0:m_end] ^= stage
    return out


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _check_operands(name, a, a_dtype, pk, pk_dtype, plain, L) -> None:
    """Checks every kernel shares: ``a`` [B, K], a 2-D ``pk``, ``plain``
    [B], their types, contiguity and device, and ``L``."""
    for arg, t, dtype in (("selection", a, a_dtype), ("key", pk, pk_dtype),
                          ("plain", plain, gf2.LIMB_DTYPE)):
        if t.dtype != dtype:
            raise TypeError(f"{name} takes {dtype} {arg}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes a contiguous {arg}")
        if t.device != a.device:
            raise ValueError(f"{name} operands on {a.device} and {t.device}")
    if a.ndim != 2 or pk.ndim != 2 or plain.ndim != 1:
        raise ValueError(
            f"{name} takes a 2-D selection and key and a 1-D plain; got "
            f"{tuple(a.shape)}, {tuple(pk.shape)}, {tuple(plain.shape)}"
        )
    if plain.shape[0] != a.shape[0] or a.shape[1] == 0 or not 1 <= L <= 65535:
        raise ValueError(
            f"{name} takes a non-empty selection, a plain bit per row and "
            f"1 <= L <= 65535; got selection {tuple(a.shape)}, plain "
            f"{tuple(plain.shape)}, L={L}"
        )
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {a.device}")


def _check(name, a, a_dtype, pk, pk_dtype, pk_width, plain, L) -> None:
    """K3's and X1's checks: ``a`` [B, K], ``pk`` [D, pk_width], ``plain`` [B]."""
    _check_operands(name, a, a_dtype, pk, pk_dtype, plain, L)
    if pk.shape[1] != pk_width:
        raise ValueError(
            f"{name} shapes disagree: selection {tuple(a.shape)}, key "
            f"{tuple(pk.shape)} (needs width {pk_width})"
        )
    if pk.shape[0] == 0 or pk.shape[0] % gf2.LIMB_BITS:
        raise ValueError(f"{name} takes D % 32 == 0 and D >= 32; got D={pk.shape[0]}")
    if a.device.type == "cuda":
        for arg, t in (("selection", a), ("key", pk)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} takes a 16-byte aligned {arg} on the card")


def _launch(symbol, a, pk, plain, L, tau, k_arg) -> torch.Tensor:
    """Launch K3's or X1's entry on :func:`mma_plan`'s plan for ``tau``."""
    B = a.shape[0]
    out = torch.empty((B, L), dtype=gf2.LIMB_DTYPE, device=a.device)
    if B == 0:
        return out
    with torch.cuda.device(a.device):
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        plan = mma_plan(B, tau, pk.shape[0], L, sms)
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel("encrypt_mma", symbol)(
            a.data_ptr(), pk.data_ptr(), plain.data_ptr(), out.data_ptr(),
            B, k_arg, pk.shape[0], L, (ctypes.c_longlong * len(plan))(*plan), stream,
        )
    if err:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")
    return out


def encrypt_words_table(
    selw: torch.Tensor, pk: torch.Tensor, plain: torch.Tensor, L: int
) -> torch.Tensor:
    """K2's wrapper: ``selw`` [B, ceil(tau/32)] int32 words, ``pk`` [tau,
    Lpk] int32 key limbs (``PublicKey.limbs``), ``plain`` [B] int32 0/1 ->
    [B, L] int32.

    A CPU tensor gets :func:`encrypt_plain`; a CUDA tensor launches
    ``csrc/encrypt.cu`` on the current stream (and counts the launch) or
    raises.  Limbs beyond the key's are zero."""
    _check_operands("encrypt_words_table", selw, gf2.LIMB_DTYPE, pk, gf2.LIMB_DTYPE, plain, L)
    tau = pk.shape[0]
    if tau == 0 or pk.shape[1] == 0 or selw.shape[1] != -(-tau // gf2.LIMB_BITS):
        raise ValueError(
            f"encrypt_words_table takes a [tau, Lpk] key and ceil(tau/32) selection "
            f"words per row; got key {tuple(pk.shape)}, selection {tuple(selw.shape)}"
        )
    if selw.device.type == "cpu":
        return encrypt_plain(selw, pk_planes(pk_columns(pk)), plain, L)
    B, W = selw.shape
    Lpk = pk.shape[1]
    Lt = min(Lpk, L)
    out = (torch.empty if Lt == L else torch.zeros)((B, L), dtype=gf2.LIMB_DTYPE, device=selw.device)
    if B == 0:
        return out
    with torch.cuda.device(selw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel("encrypt", "hm_encrypt_table", _TABLE_ARGS)(
            selw.data_ptr(), pk.data_ptr(), plain.data_ptr(), out.data_ptr(),
            B, W, tau, Lpk, L, Lt, stream,
        )
    if err:
        raise RuntimeError(f"hm_encrypt_table launch failed: cudaError {err}")
    counters.add("K2")
    return out


def encrypt_words_mma(
    selw: torch.Tensor, planes: torch.Tensor, plain: torch.Tensor, L: int
) -> torch.Tensor:
    """K3's wrapper: ``selw`` [B, W] int32 words, ``planes`` [D, 32W] int8
    from :func:`pk_planes`, ``plain`` [B] int32 0/1 -> [B, L] int32.

    A CPU tensor gets :func:`encrypt_plain`; a CUDA tensor launches
    ``csrc/encrypt_mma.cu``'s word entry (and counts the launch) or
    raises."""
    _check("encrypt_words_mma", selw, gf2.LIMB_DTYPE, planes, torch.int8,
           gf2.bit_capacity(selw.shape[1]), plain, L)
    if selw.device.type == "cpu":
        return encrypt_plain(selw, planes, plain, L)
    W = selw.shape[1]
    out = _launch("hm_encrypt_mma_words", selw, planes, plain, L, gf2.bit_capacity(W), W)
    counters.add("K3")
    return out


def encrypt_sel_mma(
    sel: torch.Tensor, planes: torch.Tensor, plain: torch.Tensor, L: int
) -> torch.Tensor:
    """X1's wrapper: ``sel`` [B, tau] int8 0/1, ``planes`` [D, 32*ceil(tau/32)]
    int8, ``plain`` [B] int32 0/1 -> [B, L] int32.

    A CPU tensor gets :func:`encrypt_sel_plain`; a CUDA tensor launches
    ``csrc/encrypt_mma.cu``'s selection entry (and counts the launch) or
    raises."""
    _check("encrypt_sel_mma", sel, torch.int8, planes, torch.int8,
           gf2.bit_capacity(-(-sel.shape[1] // gf2.LIMB_BITS)), plain, L)
    if sel.device.type == "cpu":
        return encrypt_sel_plain(sel, planes, plain, L)
    tau = sel.shape[1]
    out = _launch("hm_encrypt_mma_sel", sel, planes, plain, L, tau, tau)
    counters.add("X1")
    return out



# --------------------------------------------------------------------------
# The encrypt path's entry
# --------------------------------------------------------------------------


def encrypt_impl() -> str:
    """The selected encrypt kernel: ``$HOMOMORPH_TPU_TORCH_ENC_IMPL``,
    ``pallas`` (K2, the default) or ``pallas_v1`` (K3); any other value
    raises."""
    impl = os.environ.get(ENC_IMPL_ENV, "pallas")
    if impl not in ENC_IMPLS:
        raise ValueError(f"{ENC_IMPL_ENV}={impl!r}: expected one of {', '.join(ENC_IMPLS)}")
    return impl


def encrypt_bits_fused(
    selw: torch.Tensor,
    pk: torch.Tensor,
    plain: torch.Tensor,
    L: int,
    planes: Callable[[], torch.Tensor] | None = None,
) -> torch.Tensor:
    """Encryption of a flat bit batch from packed selection words.

    ``selw``: [B, W] int32; ``pk``: [tau, Lpk] int32 key limbs; ``plain``:
    [B] int32 0/1.  Returns [B, L] int32.  Runs K2
    (:func:`encrypt_words_table`), or K3 (:func:`encrypt_words_mma`) when
    :func:`encrypt_impl` is ``pallas_v1``, on the bit planes that
    ``planes()`` gives (a key's cached ``PublicKey.planes``; derived from
    ``pk`` when not given).  K2 never builds the planes."""
    if encrypt_impl() == "pallas_v1":
        pk_bits = planes() if planes is not None else pk_planes(pk_columns(pk))
        return encrypt_words_mma(selw, pk_bits, plain, L)
    return encrypt_words_table(selw, pk, plain, L)
