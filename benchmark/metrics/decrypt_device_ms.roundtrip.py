"""Card time a request of the round trip's decrypt stage, between the two
timing events its graph records (the program's ``roundtrip.decrypt``
records), a mean over the recorded requests."""
from benchmark.program import per_request


def read(run):
    return per_request("roundtrip.decrypt", lambda r: r.counts.get("device_ms"))
