"""Mean host ms of a fill request inside the program: its root spans' durations over their count (traced window)."""

from benchmark.yardstick.spans import program_host_ms as read  # noqa: F401
