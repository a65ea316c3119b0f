"""The least time of a fit-then-fill request's variogram work (B9 and B10) over their device time in the traced window, in %."""

from benchmark.yardstick.fit import fit_roofline_pct as read  # noqa: F401
