"""Share of the encrypt family's device time (T1, K2 or K3) that the
request's encrypt bytes take at HBM's rate."""
from benchmark.readers import encrypt_roofline_pct as read  # noqa: F401
