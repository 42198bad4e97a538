"""D1: the batched decrypt as one kernel that reads each ciphertext row once.

:func:`~homomorph_tpu_torch.gf2.poly.decipher_bits` computes
``parity(popcount(c & w))`` over the limb axis of ``c``.  On a CUDA tensor
it comes here: :func:`decipher` launches ``csrc/decrypt.cu`` (the
kernel ``decipher_parity_kernel``), which ANDs, XOR-folds and takes the
parity of each row in one read of it, where the torch expression
(:func:`~homomorph_tpu_torch.gf2.poly.decipher_bits_plain`) runs about 22
kernels over intermediates as large as ``c``.  That expression stays the
path of CPU and ``meta`` tensors and the tests' oracle.

How the threads map onto the rows follows the shape alone
(:func:`decipher_plan`): a group of threads a task, a power of 2 from one
thread to the whole block as the row grows (sub-warp groups at the
ciphertexts' 9 limbs, a warp at a sum's 384, the block past 1,024 loads);
rows too long or too few to fill the card are cut into several tasks,
whose bits the kernel XORs into the output.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import poly as gf2
from ..utils.profiling import counters

__all__ = ["DecipherPlan", "decipher_plan", "load_width", "decipher", "THREADS", "UNROLL"]

#: a block's threads (``THREADS`` in ``csrc/decrypt.cu``)
THREADS = 256
#: loads a thread issues before it uses one (``UNROLL`` in the ``.cu``)
UNROLL = 4
#: at most this many unrolled passes a task: longer rows are cut
MAX_PASSES = 2
#: threads an SM holds; the plan cuts rows until this many a SM have work
SM_THREADS = 2048
#: the H100's SMs (the wrapper passes the card's own count)
H100_SMS = 132


class DecipherPlan(NamedTuple):
    """D1's parameters for one shape (the C entry's arguments, same names)."""

    vec: int  # limbs a load: 4 (16-byte loads) or 1
    group: int  # threads a task: a power of 2 up to THREADS
    split: int  # tasks a row
    chunk: int  # loads a task covers; the row's last task may cover fewer
    blocks: int  # the grid (each block walks tasks THREADS // group at a time)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def load_width(aligned: bool, L: int) -> int:
    """Limbs a thread loads at once: 4 (16 bytes) where every row starts on
    a 16-byte boundary and holds 4 limbs or more, else 1."""
    return 4 if aligned and L >= 4 else 1


def decipher_plan(rows: int, L: int, aligned: bool, sms: int = H100_SMS,
                  blocks_per_sm: int = SM_THREADS // THREADS) -> DecipherPlan:
    """D1's thread mapping for ``rows`` rows of ``L`` limbs.

    ``aligned``: every row starts on a 16-byte boundary, so a thread loads
    4 limbs at once (where ``L >= 4``).  The group is the least power of 2
    that gives each thread at most :data:`UNROLL` loads a row, up to the
    block.  A row is cut into ``split`` tasks where a task would otherwise
    take more than :data:`MAX_PASSES` unrolled passes, or where ``rows``
    tasks leave threads of the card (``sms`` × :data:`SM_THREADS`) idle,
    never below one load a thread.  The grid is the blocks the tasks need,
    at most ``blocks_per_sm`` a SM (what the card holds at once: the kernel
    walks the rest by a grid-stride loop)."""
    if rows < 0 or L < 1:
        raise ValueError(f"decipher_plan takes rows >= 0 and L >= 1, not {rows}, {L}")
    vec = load_width(aligned, L)
    nv = L // vec
    group = min(THREADS, _pow2_at_least(-(-nv // UNROLL)))
    fill = -(-sms * SM_THREADS // max(1, rows * group))
    split = max(-(-nv // (MAX_PASSES * UNROLL * group)), min(-(-nv // group), fill))
    chunk = -(-nv // split)
    split = -(-nv // chunk)  # no task left empty
    tasks = rows * split
    blocks = min(-(-tasks // (THREADS // group)), sms * blocks_per_sm)
    return DecipherPlan(vec, group, split, chunk, blocks)


def _row_stride(c: torch.Tensor) -> "int | None":
    """The one stride, in limbs, between consecutive rows of ``c``'s batch
    dimensions taken as one, or None where they have none (a permuted or
    sliced batch)."""
    dims = [(n, s) for n, s in zip(c.shape[:-1], c.stride()[:-1]) if n != 1]
    if not dims:
        return c.shape[-1]
    stride = expect = dims[-1][1]
    for n, s in reversed(dims):
        if s != expect:
            return None
        expect = s * n
    return stride


def _operands(c: torch.Tensor, w: torch.Tensor) -> "tuple[torch.Tensor, torch.Tensor, int]":
    """``c`` and ``w`` as D1 reads them, and the stride in limbs between
    ``c``'s rows.

    D1 reads int32 limbs whose rows lie one stride apart (a slice of wider
    rows, or every other row, is read in place) and one mask row of the
    same width.  A batch without one row stride (a permuted or sliced
    batch, which no path makes) or limbs that are not contiguous are copied
    to a contiguous tensor; a mask that broadcasts to the row is written
    out at its width.  Another dtype, a mask on another device, or a mask
    that is not one row raises."""
    if c.dtype != gf2.LIMB_DTYPE or w.dtype != gf2.LIMB_DTYPE:
        raise TypeError(f"decipher takes {gf2.LIMB_DTYPE} limbs and mask, not {c.dtype}, {w.dtype}")
    if c.ndim < 1 or w.ndim > 1 or w.device != c.device:
        raise ValueError(f"decipher takes limbs [..., L] and a mask [L] on their device, not "
                         f"{tuple(c.shape)} on {c.device} and {tuple(w.shape)} on {w.device}")
    L = c.shape[-1]
    w = w.expand(L)
    stride = _row_stride(c)
    if stride is None or (c.stride(-1) != 1 and L > 1):
        c, stride = c.contiguous(), L
    return c, w, stride


_fns: dict = {}
_blocks_per_sm: dict = {}


def _kernel(name: str, argtypes):
    fn = _fns.get(name)
    if fn is None:
        from .cuda_build import library

        fn = getattr(library("decrypt"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


_DECIPHER_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                  ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
_OCCUPANCY_ARGS = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]


def _resident(device: torch.device, vec: int) -> "tuple[int, int]":
    """(SMs, blocks of the kernel with ``vec``-limb loads an SM holds at
    once) on ``device``, asked of the runtime once for each."""
    key = (device.index, vec)
    if key not in _blocks_per_sm:
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _kernel("hm_decipher_blocks_per_sm", _OCCUPANCY_ARGS)(vec, ctypes.byref(n))
        if err or n.value < 1:
            raise RuntimeError(f"decipher kernel occupancy query failed: cudaError {err}, "
                               f"{n.value} blocks a SM")
        _blocks_per_sm[key] = (torch.cuda.get_device_properties(device).multi_processor_count,
                               n.value)
    return _blocks_per_sm[key]


def decipher(c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """D1's wrapper: ``parity(popcount(c & w))`` over the last axis of ``c``
    ([..., L] int32 limbs; ``w`` [L]), as int32 0/1 of shape [...].

    A CUDA tensor is one launch on the current stream, counted as ``D1``,
    with no synchronisation (a launch refused raises), on the operands of
    :func:`_operands`: the rows may lie any one stride apart, so a slice of
    wider rows is read in place.  No rows or ``L = 0`` launch nothing (the
    parity of no limbs is 0).  A CPU or ``meta`` tensor gets the torch
    expression :func:`~homomorph_tpu_torch.gf2.poly.decipher_bits_plain`."""
    if c.device.type != "cuda":
        return gf2.decipher_bits_plain(c, w)
    c, w, stride = _operands(c, w)
    L = c.shape[-1]
    rows = c.numel() // L if L else 0
    if rows == 0:
        return torch.zeros(c.shape[:-1], dtype=gf2.LIMB_DTYPE, device=c.device)
    out = torch.empty(c.shape[:-1], dtype=gf2.LIMB_DTYPE, device=c.device)
    aligned = c.data_ptr() % 16 == 0 and (rows == 1 or stride % 4 == 0)
    vec = load_width(aligned, L)
    if not w.is_contiguous() or (vec == 4 and w.data_ptr() % 16):
        w = w.clone(memory_format=torch.contiguous_format)  # a new allocation is aligned
    sms, per_sm = _resident(c.device, vec)
    plan = decipher_plan(rows, L, aligned, sms, per_sm)
    with torch.cuda.device(c.device):
        err = _kernel("hm_decipher", _DECIPHER_ARGS)(
            c.data_ptr(), w.data_ptr(), out.data_ptr(), rows, L, stride, plan.vec, plan.group,
            plan.split, plan.chunk, plan.blocks, torch.cuda.current_stream(c.device).cuda_stream)
    if err:
        raise RuntimeError(f"decipher kernel launch failed: cudaError {err}")
    counters.add("D1")
    return out
