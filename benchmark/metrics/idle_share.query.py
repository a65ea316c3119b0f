"""Share of the traced query window with no device operation running, in %."""

from benchmark.yardstick.readers import idle_pct as read  # noqa: F401
