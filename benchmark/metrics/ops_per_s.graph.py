"""Pairs whose result was ready, over every request of the window, divided
by the whole window."""
from benchmark.readers import ops_per_s as read  # noqa: F401
