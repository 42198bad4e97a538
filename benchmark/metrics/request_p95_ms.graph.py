"""95th percentile of every request's latency in the window."""
from benchmark.readers import p95_ms as read  # noqa: F401
