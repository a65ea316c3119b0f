"""Set-up seconds: process start to the first timed request (import, context, kernels loaded or built, inputs made, warm-up)."""

from benchmark.yardstick.readers import setup_s as read  # noqa: F401
