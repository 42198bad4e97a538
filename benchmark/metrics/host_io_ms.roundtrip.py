"""Mean a request of the host time of the bits going in (until the compiled
call returns) and the decrypted bits coming out to NumPy."""
from benchmark.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "bits_in", "bits_out")
