"""The program's own spans in the traced window: the profiler events
``auvtpu_torch.<module>.<function>[:<part>]`` that ``auvtpu_torch`` opens
(``auvtpu_torch.utils.profiling.span``), read from the Chrome trace the
harness writes to ``harness.TRACE_FILE`` after its profiled window.

A span with no enclosing span of the program on the window's thread is a
root, one a request; the readers take the roots that start inside the
window, and give nothing where their count is not the traced requests'
(a program without spans has none).  The window, the device categories
and the union of intervals are :mod:`.trace`'s."""

from __future__ import annotations

import re

from .trace import DEVICE_CATS, WINDOW, load, union

SPAN = re.compile(r"^auvtpu_torch\.[A-Za-z_][\w.]*(:[\w-]+)?$")
KERNELS = "auvtpu_torch.kernels."
SPAN_CATS = ("cpu_op", "user_annotation")


def _interval(e: dict) -> tuple[float, float]:
    ts = float(e["ts"])
    return ts, ts + float(e.get("dur", 0.0))


def _outermost(spans: list[tuple[float, float, str]]) -> list[tuple[float, float, str]]:
    """The spans no other of the list encloses (on one thread spans nest)."""
    out: list[tuple[float, float, str]] = []
    for s, t, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        if not out or s >= out[-1][1]:
            out.append((s, t, name))
    return out


def reduce(events: list[dict]) -> dict | None:
    """The window's (start, end) ``window``, its ``roots`` and its
    outermost ``kernels`` spans (the program's ``auvtpu_torch.kernels.``
    spans that no other of them encloses), each (start, end, name) and
    starting inside the window, and ``busy``, the union of device
    operations clipped to it; None where the trace has no window."""
    wins = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not wins:
        return None
    w0, w1 = _interval(wins[0])
    tid = wins[0].get("tid")
    spans, dev = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        s, t = _interval(e)
        if e.get("cat") in DEVICE_CATS:
            if t > w0 and s < w1:
                dev.append((max(s, w0), min(t, w1)))
        elif (e.get("cat") in SPAN_CATS and e.get("tid") == tid and w0 <= s < w1
              and SPAN.match(e.get("name", ""))):
            spans.append((s, t, e["name"]))
    return {"window": (w0, w1), "roots": _outermost(spans),
            "kernels": _outermost([x for x in spans if x[2].startswith(KERNELS)]), "busy": union(dev)}


def overlap(a: list[tuple[float, float]], b: list[tuple[float, float]]) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(red: dict) -> list[tuple[float, float]]:
    """The window's intervals in which no device operation ran."""
    w0, w1 = red["window"]
    edges = [w0] + [x for s, t in red["busy"] for x in (s, t)] + [w1]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


_CACHE: dict = {}


def traced(run: dict) -> dict | None:
    """:func:`reduce` of the run's traced window, or None where the run was
    not traced, the trace holds no window, or its roots are not one a
    traced request (each said on standard error)."""
    from .. import harness

    t = run.get("trace")
    if not t:
        return None
    path = harness.TRACE_FILE
    try:
        st = path.stat()
    except OSError:
        harness.log(f"spans: no trace at {path}")
        return None
    key = (str(path), st.st_mtime_ns, st.st_size)
    if key not in _CACHE:
        _CACHE.clear()
        _CACHE[key] = reduce(load(path))
    red = _CACHE[key]
    if red is None:
        harness.log(f"spans: the trace at {path} holds no {WINDOW!r} span")
        return None
    if len(red["roots"]) != t["requests"]:
        harness.log(f"spans: {len(red['roots'])} root spans of the program in the traced window for "
                    f"{t['requests']} requests: no span metric")
        return None
    return red


def program_host_ms(run: dict) -> float | None:
    """Mean host ms of a request inside the program: the root spans'
    durations over their count."""
    red = traced(run)
    return None if red is None else sum(t - s for s, t, _ in red["roots"]) / len(red["roots"]) * 1e-3


def kernels_host_ms(run: dict) -> float | None:
    """Mean host ms a request spends in the kernels' wrappers: the
    outermost ``auvtpu_torch.kernels.`` spans' durations over the count of
    roots."""
    red = traced(run)
    return None if red is None else sum(t - s for s, t, _ in red["kernels"]) / len(red["roots"]) * 1e-3


def program_idle_pct(run: dict) -> float | None:
    """The share of the traced window in which the device was idle while
    the host was inside the program (the whole overlap of idle time with
    the union of the root spans), in %."""
    red = traced(run)
    if red is None:
        return None
    w0, w1 = red["window"]
    roots = union((max(s, w0), min(t, w1)) for s, t, _ in red["roots"])
    return 100.0 * overlap(idle(red), roots) / (w1 - w0)


def solve_yield_pct(run: dict) -> float | None:
    """The cells kriging fills returned over the cells they solved, the
    process's totals of the program's ``fill`` counters, in %; None where
    the program keeps no such counter or solved nothing."""
    try:
        from auvtpu_torch.utils.profiling import COUNTERS
    except ImportError:
        return None
    fill = COUNTERS.get("fill", {})
    if not fill.get("cells_solved"):
        return None
    return 100.0 * fill["cells_returned"] / fill["cells_solved"]
