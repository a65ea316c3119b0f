"""Mean host ms of a fill request inside the variogram fit: the fit_variogram spans over the count of roots."""

from benchmark.yardstick.fit import fit_host_ms as read  # noqa: F401
