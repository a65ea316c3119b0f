"""Mean host ms of a fill request in the kernels' wrappers: the outermost kernels spans over the count of roots."""

from benchmark.yardstick.spans import kernels_host_ms as read  # noqa: F401
