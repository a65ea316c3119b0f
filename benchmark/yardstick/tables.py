"""Neighbour tables of the configurations' semantics, in numpy.

Frozen copies, written for the benchmark, of the reference study's
candidate order (GridH.cpp:24-118) and of the tables the configurations
name: the radius-R window sorted by (squared distance to the cell centre,
collection order), the radius-2 scattered window in collection order and
its {-2..1}^2 subset, and the variogram's half-plane lag offsets with their
bins.  The program keeps its own copies; nothing here reads them.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=8)
def ring_offsets(radius: int) -> np.ndarray:
    """(M, 2) int64 (dx, dy) in collection order: the centre, then for each
    ring r the top and bottom edges for dx = -r..r (top first), then the
    left and right edges for dy = -r+1..r-1 (left first)."""
    offs = [(0, 0)]
    for r in range(1, radius + 1):
        for dx in range(-r, r + 1):
            offs += [(dx, -r), (dx, r)]
        for dy in range(-r + 1, r):
            offs += [(-r, dy), (r, dy)]
    return np.asarray(offs, dtype=np.int64)


@lru_cache(maxsize=8)
def sorted_window(radius: int) -> tuple[np.ndarray, np.ndarray]:
    """(dx, dy) int64 of the (2R+1)^2 window stably sorted by squared
    distance to the centre of the cell, (dx + 0.5)^2 + (dy + 0.5)^2 (the
    reference's one-sided metric, GridH.cpp:42-44): ties keep collection
    order.  A cell-aligned fill takes the first four valid cells of it."""
    offs = ring_offsets(radius)
    d2 = (offs[:, 0] + 0.5) ** 2 + (offs[:, 1] + 0.5) ** 2
    order = np.lexsort((np.arange(len(offs)), d2))
    return offs[order, 0], offs[order, 1]


def window_dydx(radius: int) -> list[tuple[int, int]]:
    """The radius-R window as (dy, dx) in collection order: a scattered
    query's candidates, ties broken by this order."""
    return [(int(dy), int(dx)) for dx, dy in ring_offsets(radius)]


def valid16_dydx() -> list[tuple[int, int]]:
    """The {-2..1}^2 subset of the radius-2 window, in its collection order:
    on a fully valid grid a query's four nearest cells lie in it."""
    return [(dy, dx) for dy, dx in window_dydx(2) if -2 <= dy <= 1 and -2 <= dx <= 1]


@lru_cache(maxsize=8)
def lag_table(max_lag: int, n_bins: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(dy, dx, bin, centres): the half-plane offsets (dy > 0, or dy == 0
    and dx > 0) with 0 < |(dx, dy)| <= max_lag, each pair counted once, in
    row-major order; ``bin`` of each offset over ``n_bins`` equal bins of
    [0, max_lag] (np.digitize, clipped); the bins' centres."""
    dys, dxs, hs = [], [], []
    for dy in range(0, max_lag + 1):
        for dx in range(-max_lag, max_lag + 1):
            if dy == 0 and dx <= 0:
                continue
            h = np.hypot(dx, dy)
            if 0 < h <= max_lag:
                dys.append(dy)
                dxs.append(dx)
                hs.append(np.float32(h))
    edges = np.linspace(0.0, float(max_lag), n_bins + 1)
    bins = np.clip(np.digitize(np.asarray(hs, np.float64), edges) - 1, 0, n_bins - 1)
    centres = 0.5 * (edges[:-1] + edges[1:])
    return np.asarray(dys), np.asarray(dxs), bins, centres
