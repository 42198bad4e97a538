"""Share of the traced window with no kernel or copy running on the card."""
from benchmark.readers import idle_pct as read  # noqa: F401
