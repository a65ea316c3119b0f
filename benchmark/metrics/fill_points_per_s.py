"""Masked cells returned in the window over the window's seconds."""

from benchmark.yardstick.readers import points_per_s as read  # noqa: F401
