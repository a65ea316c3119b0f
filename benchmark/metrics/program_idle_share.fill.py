"""Share of the traced fill window with the device idle while the host is inside the program, in %."""

from benchmark.yardstick.spans import program_idle_pct as read  # noqa: F401
