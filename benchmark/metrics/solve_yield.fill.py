"""Cells returned over cells solved by the program's kriging fills, the process's totals of its fill counters, in %."""

from benchmark.yardstick.spans import solve_yield_pct as read  # noqa: F401
