"""The variogram layer of a fit-then-fill request (B9's pair sums and B10's
fit, under the program's ``variogram.fit_variogram``): the least time its
work needs, and its device and host time in the traced window.

The device time is that of the device operations whose names hold
``pair_sums`` or ``fit_model`` (B9's two kernels, B10's one), clipped to
the window; the host time is that of the program's span of
``variogram.fit_variogram`` on the window's thread, those that start
inside it.  Both are read again from the Chrome trace the harness
writes to ``harness.TRACE_FILE``, as :func:`.spans.traced` reads it.  The
harness hands a reader no configuration, so the least time is counted from
the cell named by ``--workload`` on the command line of the run.
"""

from __future__ import annotations

import sys

import numpy as np

from .roofline import least_seconds
from .spans import KERNELS, SPAN_CATS, traced
from .tables import lag_table
from .trace import DEVICE_CATS, WINDOW, load

# the span of the program's variogram.fit_variogram (its kernels' spans
# share the package's prefix)
FIT_SPAN = KERNELS.removesuffix("kernels.") + "variogram.fit_variogram"
FIT_KERNELS = ("pair_sums", "fit_model")


def observed_pairs(cfg: dict, traffic: dict) -> float:
    """The expected pairs of observed cells at a half-plane lag offset
    within ``fit.max_lag`` of an (H, W) tile with a fraction ``removal``
    of its cells masked at random: each offset (dy, dx) pairs (H - dy)(W -
    |dx|) cells inside the tile, both ends observed with probability
    (1 - removal)^2."""
    h, w = cfg["shape"]
    dys, dxs, _, _ = lag_table(cfg["fit"]["max_lag"], cfg["fit"]["n_bins"])
    return float(np.sum((h - dys) * (w - np.abs(dxs)))) * (1.0 - traffic["removal"]) ** 2


def fit_pairs(cfg: dict, traffic: dict) -> tuple[float, float, float]:
    """(bytes, f32_ops, f64_ops) of the variogram fit of one request, by
    the rules of :mod:`.roofline`: the elevation and validity planes read
    once (H*W float32 each); a difference and its square in float32 and two
    float64 adds (the bin's sum and its count) for each observed pair
    (:func:`observed_pairs`).  The fit of a few bins is left out: under a
    microsecond."""
    h, w = cfg["shape"]
    pairs = observed_pairs(cfg, traffic)
    return 2 * h * w * 4, 2.0 * pairs, 2.0 * pairs


def command_line_cell() -> str | None:
    """The cell the run was started for: ``--workload`` of the command
    line (``benchmark/run.py``), or None."""
    argv = sys.argv
    for i, arg in enumerate(argv):
        if arg == "--workload" and i + 1 < len(argv):
            return argv[i + 1]
        if arg.startswith("--workload="):
            return arg.split("=", 1)[1]
    return None


def reduce(events: list[dict]) -> dict | None:
    """The window's variogram layer: ``host_us``, the summed durations of
    the ``fit_variogram`` spans on the window's thread that start inside
    it, their count ``spans``, and ``device_us``, the summed durations of
    the variogram kernels clipped to the window; None where the trace has no
    window."""
    wins = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not wins:
        return None
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0].get("dur", 0.0))
    tid = wins[0].get("tid")
    host = device = 0.0
    n = 0
    for e in events:
        if e.get("ph") != "X":
            continue
        s = float(e["ts"])
        t = s + float(e.get("dur", 0.0))
        name = e.get("name", "")
        if e.get("cat") in DEVICE_CATS:
            if t > w0 and s < w1 and any(k in name for k in FIT_KERNELS):
                device += min(t, w1) - max(s, w0)
        elif e.get("cat") in SPAN_CATS and name == FIT_SPAN and e.get("tid") == tid and w0 <= s < w1:
            host += t - s
            n += 1
    return {"host_us": host, "spans": n, "device_us": device}


_CACHE: dict = {}


def _reduced(run: dict) -> dict | None:
    from .. import harness

    if not run.get("trace"):
        return None
    path = harness.TRACE_FILE
    try:
        st = path.stat()
    except OSError:
        return None
    key = (str(path), st.st_mtime_ns, st.st_size)
    if key not in _CACHE:
        _CACHE.clear()
        _CACHE[key] = reduce(load(path))
    return _CACHE[key]


def fit_roofline_pct(run: dict, cell: str | None = None) -> float | None:
    """The least time of the traced requests' variogram work
    (:func:`fit_pairs` of ``cell``, by default the command line's) over
    the variogram kernels' device time in the traced window, in %; None
    where the run was not traced, no variogram kernel ran, or the cell
    fits no variogram."""
    from .. import harness

    red = _reduced(run)
    cell = cell if cell is not None else command_line_cell()
    if red is None or red["device_us"] <= 0 or cell is None:
        return None
    try:
        _, cfg, traffic = harness.cell_files(cell)
    except SystemExit:
        return None
    if "fit" not in cfg or "removal" not in traffic:
        return None
    least = least_seconds(*fit_pairs(cfg, traffic))
    return 100.0 * run["trace"]["requests"] * least / (red["device_us"] * 1e-6)


def fit_host_ms(run: dict) -> float | None:
    """Mean host ms of a request inside ``fit_variogram``: its spans'
    durations over the count of roots; None where the roots are not one a
    traced request (:func:`.spans.traced`) or the program opens no such
    span."""
    roots = traced(run)
    red = _reduced(run)
    if roots is None or red is None or red["spans"] == 0:
        return None
    return red["host_us"] / len(roots["roots"]) * 1e-3
