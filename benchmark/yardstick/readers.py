"""The arithmetic that turns a run's record into a metric, shared by the
per-metric readers under ``benchmark/metrics/``.  Each returns None where
the run holds nothing to read (a reader that finds nothing reports
nothing)."""

from __future__ import annotations


def points_per_s(run: dict) -> float | None:
    """Points answered in the window over the window: all the work, all the
    time."""
    w = run.get("window")
    if not w or not w["requests"] or w["window_s"] <= 0:
        return None
    return w["requests"] * run["points_per_request"] / w["window_s"]


def dispatch_ms(run: dict) -> float | None:
    """Mean host ms inside a request's call (no synchronise in it): the
    host seconds summed over the window's calls, over their count."""
    w = run.get("window")
    if not w or not w["requests"]:
        return None
    return w["dispatch_s"] / w["requests"] * 1e3


def roofline_pct(run: dict) -> float | None:
    """The least time the traced requests' work needs on the card, over the
    device's busy time in the traced window, in %."""
    t = run.get("trace")
    if not t or t["busy_us"] <= 0:
        return None
    return 100.0 * t["requests"] * run["needed_s"] / (t["busy_us"] * 1e-6)


def idle_pct(run: dict) -> float | None:
    """The share of the traced window in which no device operation ran, in
    %."""
    t = run.get("trace")
    if not t or t["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_us"] / t["window_us"])


def setup_s(run: dict) -> float | None:
    """Seconds from process start to the first timed request."""
    return run.get("setup_s")
