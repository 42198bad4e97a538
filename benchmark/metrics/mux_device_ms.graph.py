"""Card time a request of the mux (the program's ``circuit.select``
records: two timing events its graph records around ``select``), a mean
over the recorded requests."""
from benchmark.program import per_request


def read(run):
    return per_request("circuit.select", lambda r: r.counts.get("device_ms"))
