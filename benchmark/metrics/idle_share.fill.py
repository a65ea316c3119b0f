"""Share of the traced fill window with no device operation running, in %."""

from benchmark.yardstick.readers import idle_pct as read  # noqa: F401
