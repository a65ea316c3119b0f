"""One caller in a closed loop: the caller hands the program a batch, waits
for its answer on the card (a synchronise), then hands it the next (a
planner or a simulator that needs each answer before it asks again).  The
window closes with the last batch's synchronise, so every batch counted has
finished inside it."""

from __future__ import annotations

import time


def run(wl, stop, keeper=None) -> dict:
    """Run batches 0, 1, ... until ``stop(i, elapsed_s)``; returns the
    count, the window's seconds and the host seconds spent inside calls
    (the synchronise not among them)."""
    dispatch = 0.0
    i = 0
    t0 = time.perf_counter()
    while not stop(i, time.perf_counter() - t0):
        ta = time.perf_counter()
        out = wl.call(i)
        dispatch += time.perf_counter() - ta
        wl.dev.synchronize()
        if keeper is not None:
            keeper.offer(i, out)
        i += 1
    return {"requests": i, "window_s": time.perf_counter() - t0, "dispatch_s": dispatch}
