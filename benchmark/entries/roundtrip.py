"""Plaintext to plaintext through one compiled graph:
``models.compiled.compile_roundtrip(ctx, op, type)``.  A request hands the
program two host NumPy arrays of plaintext bits (span ``bits_in``, until the
compiled call returns), waits for the card (``wait``) and copies the
decrypted bits back into a NumPy array (``bits_out``).  Each request draws
its encrypt's threefry key from the seed."""

from __future__ import annotations

import numpy as np

from benchmark.harness import record_products
from benchmark.operands import Pool


class Entry:
    output = "bits"

    def __init__(self, run):
        from homomorph_tpu_torch import models
        from homomorph_tpu_torch.models.compiled import compile_roundtrip

        self.run = run
        self.desc = getattr(run.ht, run.config["type"])
        self.bound = run.ctx.parameters.pk_degree
        self.op = getattr(models, run.traffic["op"])
        self.pool = Pool(run, self.desc.num_bits)
        # what a client holds: int32 0/1 arrays in host memory
        self.host = [(a.cpu().numpy().astype(np.int32), b.cpu().numpy().astype(np.int32))
                     for a, b in zip(self.pool.bits("a"), self.pool.bits("b"))]
        self.keys = np.random.default_rng(run.seed).integers(0, 1 << 32, size=(4096, 2),
                                                             dtype=np.uint64)
        self.encrypt_bits = 2 * self.pool.pairs * self.desc.num_bits
        self.shape = (self.pool.pairs, self.desc.num_bits, run.keys.pk_degree // 32 + 1)
        self.step = compile_roundtrip(run.ctx, self.op, self.desc)

    def request(self, i: int):
        a, b = self.host[i % len(self.host)]
        key = tuple(int(k) for k in self.keys[i % len(self.keys)])
        with self.run.span("bits_in"):
            out = self.step(key, a, b)
        with self.run.span("wait"):
            self.run.sync()
        with self.run.span("bits_out"):
            bits = out.cpu().numpy()
        return bits

    def expected(self, i: int):
        return self.pool.expected(i)

    def products(self):
        return record_products(self.run.ht, self.op, self.shape, self.bound, self.desc)

    def free(self) -> None:
        self.step = None
