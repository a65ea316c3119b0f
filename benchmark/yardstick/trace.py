"""Reduction of a ``torch.profiler`` Chrome trace to the device's busy time,
its idle gaps and the operations that took the most time, inside one span
that the harness marks ("benchmark.window").

Times in the trace are microseconds on one clock for host and device
events.  Device operations are the events of category ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; the busy time is the length of their
union inside the window.  An idle gap is named by what the host's main
thread was doing at its midpoint: the innermost host event there.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

WINDOW = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


def load(path) -> list[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _span(e: dict) -> tuple[float, float]:
    ts = float(e["ts"])
    return ts, ts + float(e.get("dur", 0.0))


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, sorted and merged."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(host, starts, t: float, look: int = 512) -> str:
    """The name of the latest-starting host event that covers ``t``: on one
    thread events nest, so that is the innermost."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host idle"


def reduce(events: list[dict], top: int = 10) -> dict | None:
    """The window's ``window_us``, ``busy_us`` (union of device operations
    clipped to it), ``span_us`` (first device start to last device end),
    ``n_device_ops``, ``device_ops`` ([name, seconds] summed by name, the
    ``top`` largest) and ``idle_gaps`` ([what the host was doing, seconds]
    summed by name, the ``top`` largest); None where the trace holds no
    window or no device operation in it."""
    wins = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not wins:
        return None
    w0, w1 = _span(wins[0])
    tid = wins[0].get("tid")
    dev = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            s, t = _span(e)
            if t > w0 and s < w1:
                dev.append((max(s, w0), min(t, w1), e.get("name", "?")))
    if not dev:
        return None
    merged = union((s, t) for s, t, _ in dev)
    busy = sum(t - s for s, t in merged)
    by_name: dict[str, float] = defaultdict(float)
    for s, t, name in dev:
        by_name[name] += (t - s) * 1e-6
    host = sorted((_span(e) + (e.get("name", "?"),) for e in events
                   if e.get("ph") == "X" and e.get("cat") in HOST_CATS and e.get("tid") == tid
                   and e.get("name") != WINDOW), key=lambda h: h[0])
    starts = [h[0] for h in host]
    gaps: dict[str, float] = defaultdict(float)
    edges = [w0] + [x for s, t in merged for x in (s, t)] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[_innermost(host, starts, 0.5 * (a + b))] += (b - a) * 1e-6
    ordered = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {
        "window_us": w1 - w0,
        "busy_us": busy,
        "span_us": merged[-1][1] - merged[0][0],
        "n_device_ops": len(dev),
        "device_ops": ordered(by_name),
        "idle_gaps": ordered(gaps),
    }
