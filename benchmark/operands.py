"""Operands of a request pool, made from the seed on the run's device.

A pool holds ``pool`` distinct batches of ``pairs`` operand pairs; request
``i`` takes batch ``i % pool``, so consecutive results differ and a stale or
misplaced result shows in the check.  A mix gives ``pool`` itself, or
``table_gib``: the GiB of operand ciphertexts (both sides) the card holds,
from which ``pool`` follows.

The plaintexts are drawn on the device by the run's generator.  Where an
entry needs the ciphertexts made beforehand, the reference encrypts a basis
of ``basis`` values a side, every bit a fresh encryption, and each value of
the pool is the XOR of two distinct basis values: its ciphertext, the XOR of
theirs, is the fresh encryption of that XOR under the symmetric difference
of the two random subsets.  So the card holds a table of any size of fresh
ciphertexts while the reference encrypts only the basis.
"""

from __future__ import annotations

import torch

from . import reference
from .harness import load_module

#: values a chunk when the table is filled, and bits a chunk of the basis's
#: encrypt: transients of a few hundred MB, under the window's peak
FILL_CHUNK = 1 << 15
ENCRYPT_CHUNK = 1 << 13


def pool_batches(traffic: dict, params: dict, n_bits: int) -> int:
    """The traffic's ``pool``, or the batches ``table_gib`` holds."""
    if "pool" in traffic:
        return int(traffic["pool"])
    pair_bytes = 2 * n_bits * reference.limbs_for(params["d"] + params["dp"]) * 4
    return max(1, int(traffic["table_gib"] * 2**30) // (traffic["pairs"] * pair_bytes))


class Pool:
    def __init__(self, run, n_bits: int):
        tr = run.traffic
        self.n_bits, self.pairs = n_bits, tr["pairs"]
        self.pool = pool_batches(tr, run.config["parameters"], n_bits)
        shape = (self.pool, self.pairs)
        hi = 1 << n_bits
        self.basis = tr.get("basis")
        if self.basis is None:
            self.a = torch.randint(0, hi, shape, generator=run.gen, device=run.dev,
                                   dtype=torch.int64)
            self.b = torch.randint(0, hi, shape, generator=run.gen, device=run.dev,
                                   dtype=torch.int64)
        else:
            self._basis = {}
            for side in ("a", "b"):
                values = torch.randint(0, hi, (self.basis,), generator=run.gen, device=run.dev,
                                       dtype=torch.int64)
                i1 = torch.randint(0, self.basis, shape, generator=run.gen, device=run.dev)
                i2 = (i1 + torch.randint(1, self.basis, shape, generator=run.gen,
                                         device=run.dev)) % self.basis
                setattr(self, side, values[i1] ^ values[i2])
                self._basis[side] = (values, i1.reshape(-1), i2.reshape(-1))
        op = load_module("ops", tr["op"], run.bench)
        self.want = reference.value_bits(op.expected(self.a, self.b, n_bits), n_bits)

    def expected(self, i: int) -> torch.Tensor:
        """[pairs, n_bits] plaintext bits of request ``i``'s result."""
        return self.want[i % self.pool]

    def bits(self, which: str) -> torch.Tensor:
        """[pool, pairs, n_bits] uint8 plaintext bits of operand ``a`` or ``b``."""
        return reference.value_bits(getattr(self, which), self.n_bits)

    def ciphertexts(self, run, which: str) -> torch.Tensor:
        """[pool, pairs, n_bits, L] limbs of operand ``a`` or ``b``: the
        basis encrypted by the reference, each value the XOR of two."""
        if self.basis is None:
            raise ValueError("a mix whose entry takes ciphertexts gives a basis")
        values, i1, i2 = self._basis[which]
        bits = reference.value_bits(values, self.n_bits)
        ct = reference.encrypt(run.keys, bits.reshape(-1), run.gen, chunk=ENCRYPT_CHUNK)
        ct = ct.reshape(self.basis, self.n_bits, ct.shape[-1])
        table = torch.empty((i1.shape[0],) + tuple(ct.shape[1:]), dtype=ct.dtype, device=ct.device)
        for lo in range(0, i1.shape[0], FILL_CHUNK):
            hi = lo + FILL_CHUNK
            torch.bitwise_xor(ct[i1[lo:hi]], ct[i2[lo:hi]], out=table[lo:hi])
        return table.reshape((self.pool, self.pairs) + tuple(ct.shape[1:]))
