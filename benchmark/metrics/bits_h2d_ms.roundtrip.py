"""Host time a request of the round trip's plaintext bits going to the card
(the program's span ``roundtrip.bits_in``: both host arrays' pageable
copies), a mean over the recorded requests."""
from benchmark.program import per_request, span_ms


def read(run):
    return per_request("roundtrip.bits_in", span_ms)
