"""Card time a request of the comparator's tree (the program's
``circuit.lt_tree`` records: two timing events its graph records around
``_lt_tree``), a mean over the recorded requests."""
from benchmark.program import per_request


def read(run):
    return per_request("circuit.lt_tree", lambda r: r.counts.get("device_ms"))
