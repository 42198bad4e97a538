"""Limb-sharded carry-less multiplication.

Counterpart of :mod:`homomorph_tpu.parallel.limbmul`: when a ciphertext
polynomial grows large (deep AND circuits at large degrees), the LARGE
operand's limb axis is cut into blocks over the places of a mesh axis.
Each place multiplies its contiguous block by the (replicated) small
operand with the port's dense :func:`~homomorph_tpu_torch.gf2.kernels.
clmul`, so K1 (``csrc/clmul.cu``) runs under the Karatsuba route; the
block overhangs its neighbour's region by ``Lb`` limbs, and that spill is
passed one hop right through :func:`~.mesh.ppermute` and XORed into the
neighbour's head (``limbmul.py:117-127``).

Communication per place is the ``Lb``-limb boundary, independent of the
sharded length: :func:`comm_bytes_per_call` bytes, which is what
``ppermute`` counts for one call over one group.  An arithmetic sum
cannot combine packed partial products (XOR is not +), so the exchange
stays in the packed GF(2) domain.

Integration: :func:`set_default_limb_mesh` registers a mesh and puts
:func:`maybe_sharded_clmul` into the clmul dispatcher's hook slot
(:data:`homomorph_tpu_torch.gf2.kernels.limb_hook`); the dispatcher then
offers it every product, and it routes large, unbalanced ones.  The
registry is a knob like the port's environment knobs: read at each eager
call, while a compiled callable (CUDA graph) keeps the routing it was
captured with, as a JAX function keeps the routing it was traced with
(``limbmul.py:63-71``).
"""

from __future__ import annotations

import math
import os
import threading
from contextlib import contextmanager

import torch

from ..gf2 import kernels as gf2k
from ..gf2 import poly as gf2
from .mesh import Mesh, ppermute

__all__ = [
    "sharded_clmul",
    "maybe_sharded_clmul",
    "set_default_limb_mesh",
    "get_default_limb_mesh",
    "use_limb_mesh",
    "suppress_sharded_clmul",
    "comm_bytes_per_call",
    "limb_window",
    "LIMB_AXIS",
    "SHARD_MIN_BLOCK_ENV",
]

LIMB_AXIS = "limb"

#: the JAX package's ``HOMOMORPH_TPU_SHARD_MIN_BLOCK``, named as the port's
#: other knobs; read when the module is imported, as there
SHARD_MIN_BLOCK_ENV = "HOMOMORPH_TPU_TORCH_SHARD_MIN_BLOCK"
# Minimum per-place block (limbs of the big operand) before sharding pays:
# below this the boundary exchange dominates the local product.
_SHARD_MIN_BLOCK = int(os.environ.get(SHARD_MIN_BLOCK_ENV, "64"))

_tls = threading.local()
_DEFAULT_MESH: Mesh | None = None
_DEFAULT_AXIS: str = LIMB_AXIS


def set_default_limb_mesh(mesh: Mesh | None, axis: str = LIMB_AXIS) -> None:
    """Register (or clear, with ``None``) the mesh the clmul dispatcher uses
    for automatic limb-sharding of large unbalanced products.

    Read at each eager call; a compiled callable keeps the routing it was
    captured with, so register the mesh before the first call of a shape."""
    global _DEFAULT_MESH, _DEFAULT_AXIS
    if mesh is not None and axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}; axes: {tuple(mesh.shape)}")
    _DEFAULT_MESH = mesh
    _DEFAULT_AXIS = axis
    gf2k.limb_hook = None if mesh is None else maybe_sharded_clmul


def get_default_limb_mesh() -> tuple[Mesh | None, str]:
    return _DEFAULT_MESH, _DEFAULT_AXIS


@contextmanager
def use_limb_mesh(mesh: Mesh | None, axis: str = LIMB_AXIS):
    """Scoped :func:`set_default_limb_mesh`."""
    prev = (_DEFAULT_MESH, _DEFAULT_AXIS)
    set_default_limb_mesh(mesh, axis)
    try:
        yield
    finally:
        set_default_limb_mesh(*prev)


@contextmanager
def suppress_sharded_clmul():
    """Keep :func:`maybe_sharded_clmul` inert in this thread for the block:
    code already working on one place's share (the bulk decrypt's blocks,
    this module's own local products) must not shard again."""
    prev = getattr(_tls, "inside", False)
    _tls.inside = True
    try:
        yield
    finally:
        _tls.inside = prev


def comm_bytes_per_call(batch: int, small_limbs: int, n_shards: int) -> int:
    """Bytes moved by one :func:`sharded_clmul` over one group of the axis:
    each of the ``n_shards - 1`` boundary hops carries the ``Lb``-limb spill
    for the whole batch, 4 bytes per limb."""
    return (n_shards - 1) * batch * small_limbs * 4


def _block(La: int, Lb: int, n: int) -> int:
    # the output length padded to a multiple of n, at least Lb per place
    return max(-(-(La + Lb) // n), Lb)


def limb_window(La: int, Lb: int, mesh: Mesh, axis: str = LIMB_AXIS) -> tuple[int, int]:
    """The product limbs ``[lo, hi)`` that :func:`sharded_clmul` returns on
    this process: those of its places' blocks, clipped to ``La + Lb``."""
    K = _block(La, Lb, mesh.shape[axis])
    s0, s1 = mesh.local_range(axis)
    return min(s0 * K, La + Lb), min(s1 * K, La + Lb)


def sharded_clmul(a: torch.Tensor, b: torch.Tensor, mesh: Mesh,
                  axis: str = LIMB_AXIS) -> torch.Tensor:
    """Carry-less multiply with ``a``'s limb axis cut over ``mesh[axis]``.

    ``a``: [B, La] (the large operand), ``b``: [B, Lb] small operand, the
    same on every process.  The block ``K = max(ceil((La+Lb)/n), Lb)``
    (``limbmul.py:160-166``) is at least ``Lb`` limbs, so a spill never
    crosses more than one boundary, and real data cannot spill past the
    padded end (``n*K >= La + Lb``).

    Returns the product limbs of this process's blocks,
    [B, hi - lo] for :func:`limb_window`'s ``(lo, hi)``: on one process
    that holds every place of the axis, the whole [B, La + Lb] product.
    """
    n = mesh.shape[axis]
    La, Lb = a.shape[-1], b.shape[-1]
    K = _block(La, Lb, n)
    dev = mesh.device
    a_pad = gf2.pad_limbs(a.to(dev), K * n)
    b = b.to(dev).contiguous()
    heads, spills = {}, {}
    with suppress_sharded_clmul():  # keep the inner clmul off this path
        for p in mesh.local():
            s = mesh.coords(p)[axis]
            prod = gf2k.clmul(a_pad[:, s * K:(s + 1) * K].contiguous(), b)  # [B, K + Lb]
            heads[p], spills[p] = prod[:, :K], prod[:, K:].contiguous()
    # send each spill one place to the right; the first place receives zeros
    incoming = ppermute(mesh, spills, axis, [(i, i + 1) for i in range(n - 1)])
    first = mesh.first_local(axis)
    s0, s1 = mesh.local_range(axis)
    out = torch.cat([heads[first[s]] ^ gf2.pad_limbs(incoming[first[s]], K)
                     for s in range(s0, s1)], dim=-1)
    lo, hi = limb_window(La, Lb, mesh, axis)
    return out[:, : hi - lo]


def maybe_sharded_clmul(a: torch.Tensor, b: torch.Tensor):
    """Route ``a * b`` through :func:`sharded_clmul` when it qualifies.

    Returns ``None`` (the caller falls back to the dense dispatcher) unless
    a default limb mesh is registered, this thread is not already inside a
    sharded block, the operands hold data (``meta`` tensors, with which a
    compiled callable derives its output's metadata, take the dense
    dispatcher's empty product), this process holds every place of the mesh
    (a circuit goes on with the whole product), and each place gets a
    full-size block: ``Lg // n >= max(Ls, _SHARD_MIN_BLOCK)``
    (``limbmul.py:186-192``).  Leading batch dims are flattened to the
    [B, L] contract and restored.

    Counts what it routes in two plain integers: ``maybe_sharded_clmul.taken``
    (products) and ``maybe_sharded_clmul.planned_bytes`` (their
    :func:`comm_bytes_per_call`, to hold against what :func:`~.mesh.ppermute`
    counts).
    """
    mesh, axis = _DEFAULT_MESH, _DEFAULT_AXIS
    if mesh is None or getattr(_tls, "inside", False) or a.is_meta or b.is_meta:
        return None
    n = mesh.shape[axis]
    if n < 2 or len(mesh.local()) != mesh.size:
        return None
    La, Lb = a.shape[-1], b.shape[-1]
    big, small = (a, b) if La >= Lb else (b, a)
    Lg, Ls = big.shape[-1], small.shape[-1]
    if Lg // n < max(Ls, _SHARD_MIN_BLOCK):
        return None
    lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    batch = math.prod(lead)
    bf = big.expand(*lead, Lg).reshape(batch, Lg)
    sf = small.expand(*lead, Ls).reshape(batch, Ls)
    out = sharded_clmul(bf, sf, mesh, axis)
    maybe_sharded_clmul.taken += 1
    maybe_sharded_clmul.planned_bytes += comm_bytes_per_call(batch, Ls, n)
    return out.reshape(*lead, Lg + Ls).to(a.device)


#: products routed through the mesh since the last reset, and their planned
#: exchange bytes (plain integers)
maybe_sharded_clmul.taken = 0
maybe_sharded_clmul.planned_bytes = 0
