"""The least time a query batch's needed work takes on the card over its device-busy time, in %."""

from benchmark.yardstick.readers import roofline_pct as read  # noqa: F401
