"""Share of the clmul family's device time (K1, R1, R2) that the least time
of the request's products takes."""
from benchmark.readers import clmul_roofline_pct as read  # noqa: F401
