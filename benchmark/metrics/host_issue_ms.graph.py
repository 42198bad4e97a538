"""Host time a request inside the program's compiled call (span
``compiled.call``: the inputs' copy into the graph, the replay's launch,
the output's clone), a mean over the recorded requests."""
from benchmark.program import per_request, span_ms


def read(run):
    return per_request("compiled.call", span_ms)
