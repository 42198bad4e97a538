"""What a request's replay launches on the card: the nodes of the compiled
call's graph that run work (kernels, copies and sets, torch's as well as
the port's; the ``launches`` count of the program's ``compiled.call``
spans), a mean over the recorded requests."""
from benchmark.program import per_request


def read(run):
    return per_request("compiled.call", lambda r: r.counts.get("launches"))
