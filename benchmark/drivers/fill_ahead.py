"""Requests dispatched ahead: the caller hands the program the next request
as soon as fewer than ``in_flight`` are unfinished, never waiting for one
result before asking the next (a survey batch filling tile after tile, a
simulator streaming query batches off a resident grid).  The window closes
with a synchronise after the last request, so every request counted has
finished inside it."""

from __future__ import annotations

import time


def run(wl, stop, keeper=None) -> dict:
    """Dispatch requests 0, 1, ... until ``stop(i, elapsed_s)``; returns the
    count, the window's seconds and the host seconds spent inside calls."""
    k = wl.traffic["in_flight"]
    ring = [wl.dev.event() for _ in range(k)]
    dispatch = 0.0
    i = 0
    t0 = time.perf_counter()
    while not stop(i, time.perf_counter() - t0):
        if i >= k:
            ring[i % k].synchronize()
        ta = time.perf_counter()
        out = wl.call(i)
        dispatch += time.perf_counter() - ta
        ring[i % k].record()
        if keeper is not None:
            keeper.offer(i, out)
        i += 1
    wl.dev.synchronize()
    return {"requests": i, "window_s": time.perf_counter() - t0, "dispatch_s": dispatch}
