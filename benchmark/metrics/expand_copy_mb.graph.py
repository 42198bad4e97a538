"""MB a request that the replay writes to copy a broadcast clmul operand to
every row (the ``expand_limbs`` count of the program's ``compiled.call``
records, 4 bytes a limb), a mean over the recorded requests."""
from benchmark.program import per_request


def read(run):
    def mb(r):
        limbs = r.counts.get("expand_limbs")
        return None if limbs is None else limbs * 4 / 1e6

    return per_request("compiled.call", mb)
