"""A compiled operation replayed on card-resident operands:
``models.compiled.compile_op2(op, type, pk_degree)``, one CUDA graph replay
a request.  The card holds the pool's operand table; a request wraps its
batch's rows as the program's ``Ciphered`` and hands them to the compiled
call.  A request ends when the result is on the card."""

from __future__ import annotations

from benchmark.harness import record_products
from benchmark.operands import Pool


class Entry:
    output = "ciphertext"
    encrypt_bits = 0

    def __init__(self, run):
        from homomorph_tpu_torch import models
        from homomorph_tpu_torch.models.compiled import compile_op2

        self.run = run
        self.desc = getattr(run.ht, run.config["type"])
        self.bound = run.ctx.parameters.pk_degree
        self.op = getattr(models, run.traffic["op"])
        self.pool = Pool(run, self.desc.num_bits)
        self.table = (self.pool.ciphertexts(run, "a"), self.pool.ciphertexts(run, "b"))
        self.shape = tuple(self.table[0].shape[1:])
        self.step = compile_op2(self.op, self.desc, self.bound)

    def request(self, i: int):
        p = i % self.pool.pool
        a, b = (self.run.ht.Ciphered(t[p], self.bound, self.desc) for t in self.table)
        out = self.step(a, b).limbs
        self.run.sync()
        return out

    def expected(self, i: int):
        return self.pool.expected(i)

    def products(self):
        return record_products(self.run.ht, self.op, self.shape, self.bound, self.desc)

    def free(self) -> None:
        self.step = self.table = None
