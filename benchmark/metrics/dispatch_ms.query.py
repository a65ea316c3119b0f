"""Mean host ms inside a query batch's call, no synchronise in it."""

from benchmark.yardstick.readers import dispatch_ms as read  # noqa: F401
