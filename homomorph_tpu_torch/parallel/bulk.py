"""Sharded bulk encryption and decryption over a grid of places.

Counterpart of :mod:`homomorph_tpu.parallel.bulk` (the reference's per-bit
encrypt loop, src/cipher.rs:99-115, spread over a grid):

* the batch (ciphertext-bit) axis is pure data parallelism;
* on the tau axis each place holds a slice of the public key's rows and
  computes the packed parity of its own partial subset-XOR, and the tau
  shards combine the partials by XOR in the packed domain.

Each tau shard's partial is X1 (:func:`~homomorph_tpu_torch.gf2.
encrypt_kernel.encrypt_sel_mma`, ``csrc/encrypt_mma.cu``) on that shard's
``[B_blk*n, tau/n_tau]`` int8 selections, against the planes of that
shard's key rows and a zero plaintext: exactly the JAX per-shard
``matmul`` + ``parity_pack`` (``bulk.py:38-45``), on the hand-written
kernel.

**The combine.** Parity is a mod-2 homomorphism: ``parity(sum_s counts_s)
= XOR_s parity(counts_s)``, so the packed partials XOR to the dense
path's bits whatever the grid.  A power-of-two tau axis combines them by
a butterfly (recursive doubling, pairs ``i ^ step``, ``log2(n)``
exchanges); any other size by a ring of ``n - 1`` one-hop exchanges that
accumulate the XOR.  The JAX package keeps an f32 counts ``psum`` for the
second case; X1 never forms the counts, and NCCL has no ``ReduceOp.BXOR``,
so both cases here are exchanges of the :func:`~.mesh.ppermute`
primitive, one code path for gloo and NCCL.  The plaintext bit is XORed
in once, after the reduction (``bulk.py:61``).

Inputs are global and the same on every process (the counterpart of a
``device_put`` of a global array); the outputs hold the rows of this
process's data blocks, in global order (:meth:`~.mesh.ShardingConfig.
local_rows`), on its device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..gf2 import encrypt_kernel as _enc
from ..gf2 import poly as gf2
from .mesh import DATA_AXIS, TAU_AXIS, ShardingConfig, ppermute

__all__ = ["sharded_encrypt_bits", "sharded_decrypt_bits", "sharded_gate_xor"]


def _tensor(x, device, dtype) -> torch.Tensor:
    t = torch.from_numpy(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    return t.to(device=device, dtype=dtype)


def _xor_combine(cfg: ShardingConfig, parts: dict[int, torch.Tensor]) -> dict[int, torch.Tensor]:
    """XOR-all-reduce of each local place's ``parts`` over the tau axis:
    every place ends with the XOR of its group's partials.  A butterfly
    for a power-of-two axis, else a ring of ``n - 1`` one-hop exchanges."""
    n = cfg.mesh.shape[TAU_AXIS]
    acc = dict(parts)
    if n & (n - 1) == 0:
        step = 1
        while step < n:
            got = ppermute(cfg.mesh, acc, TAU_AXIS, [(i, i ^ step) for i in range(n)])
            acc = {p: acc[p] ^ got[p] for p in acc}
            step *= 2
    else:
        msg = dict(parts)
        for _ in range(n - 1):
            msg = ppermute(cfg.mesh, msg, TAU_AXIS, [(i, (i + 1) % n) for i in range(n)])
            acc = {p: acc[p] ^ msg[p] for p in acc}
    return acc


def sharded_encrypt_bits(
    cfg: ShardingConfig,
    sel,
    pk: torch.Tensor,
    plain_bits,
    out_limbs: int,
) -> torch.Tensor:
    """Encrypt a batch of plaintext bits on the grid.

    ``sel``: [B, n, tau] 0/1 subset indicators; ``pk``: [tau, Lpk] int32
    key limbs (``PublicKey.limbs``; the JAX function takes the bf16 bit
    planes, here each shard builds the planes of its own rows);
    ``plain_bits``: [B, n].  numpy arrays or tensors.  Returns this
    process's rows, [B_local, n, out_limbs] int32.
    """
    mesh = cfg.mesh
    dev = cfg.device
    n_data, n_tau = mesh.shape[DATA_AXIS], mesh.shape[TAU_AXIS]
    B, n, tau = (int(s) for s in sel.shape)
    if B % n_data:
        raise ValueError(f"batch of {B} values not divisible by the mesh data axis ({n_data})")
    if tau % n_tau or pk.shape[0] != tau:
        raise ValueError(f"tau={tau} (key rows {pk.shape[0]}) not divisible by the mesh "
                         f"tau axis ({n_tau})")
    blk, ts = B // n_data, tau // n_tau
    sel = _tensor(sel, dev, torch.int8)
    plain = _tensor(plain_bits, dev, gf2.LIMB_DTYPE)
    pk = pk.to(dev)
    planes, parts, zero = {}, {}, None
    for p in mesh.local():
        c = mesh.coords(p)
        i, j = c[DATA_AXIS], c[TAU_AXIS]
        if j not in planes:
            planes[j] = _enc.pk_planes(_enc.pk_columns(pk[j * ts:(j + 1) * ts].contiguous()))
        rows = sel[i * blk:(i + 1) * blk, :, j * ts:(j + 1) * ts].reshape(blk * n, ts).contiguous()
        if rows.data_ptr() % 16:  # X1 reads 16-byte aligned rows on the card
            rows = rows.clone()
        if zero is None:
            zero = torch.zeros(blk * n, dtype=gf2.LIMB_DTYPE, device=dev)
        parts[p] = _enc.encrypt_sel_mma(rows, planes[j], zero, out_limbs)
    limbs = _xor_combine(cfg, parts)
    lo, hi = mesh.local_range(DATA_AXIS)
    # every place of a data block holds the same XOR: take one of each
    first = mesh.first_local(DATA_AXIS)
    out = torch.cat([limbs[first[i]].view(blk, n, out_limbs) for i in range(lo, hi)])
    return gf2.xor_const_bit(out, plain[lo * blk:hi * blk])


def sharded_decrypt_bits(cfg: ShardingConfig, limbs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Decrypt this process's rows [B_local, n, L] to bits [B_local, n]
    (pure data parallelism: each local data block on its own, with the
    limb-mesh clmul hook kept off, as the JAX package's shard_map body)."""
    from .limbmul import suppress_sharded_clmul

    lo, hi = cfg.mesh.local_range(DATA_AXIS)
    blocks = limbs.to(cfg.device).chunk(hi - lo)
    w = w.to(cfg.device)
    with suppress_sharded_clmul():
        return torch.cat([gf2.decipher_bits(b, w) for b in blocks])


def sharded_gate_xor(cfg: ShardingConfig, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lane-wise homomorphic XOR of this process's rows (no communication)."""
    return a.to(cfg.device) ^ b.to(cfg.device)
