"""The least time the work of one request needs on one NVIDIA H100 SXM,
counted from what the request's inputs need, not from what a kernel does.

Peaks are NVIDIA's published figures for the H100 SXM at its 700 W limit:
3.35 TB/s of HBM3, 67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside
the tensor cores (none of this work is a matrix product).  A card set to a
lower ``power.limit`` reaches less; the harness prints the limit beside
every share.

Rules of every count below:

- bytes: each input the request needs read once, each output written once,
  at 4 bytes a float32 value; nothing a program derives (packs, padded or
  tiled copies, index lists it could recompute) is counted;
- operations: one for each add, subtract, multiply, divide, square root,
  exponential, floor or comparison that the configuration's arithmetic
  states, only where the request needs its result;
- the least time is the larger of bytes at the bandwidth and the
  operations at their rates (float32 and float64 time added).

Every count function takes the configuration and the traffic mix (their
JSON files) and returns ``(bytes, f32_ops, f64_ops)`` for one request; a
traffic mix names its count by dotted path (``counts``).
"""

from __future__ import annotations

import numpy as np

from .tables import lag_table

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12

# The ordinary-kriging solve of one point with four neighbours, in the
# reference's arithmetic (GridH.cpp:371-419):
#   coordinates: 4 neighbours x 2 axes x (col + d, + half, * step, + min) = 32,
#                and the query's 2 x (* step, + min) = 4                 -> 36
#   distances:   6 pairs + 4 to the query, each 2 sub, 2 mul, add, sqrt -> 60
#   variogram:   10 x (h / range, exp, 1 - e, * sill, + nugget)         -> 50
#   Gauss-Jordan, unpivoted on the 5x6 system: pivot p divides its row's
#   6 - p entries (20 in all) and each of the 4 other rows takes 6 - p
#   multiply-subtracts (4 x 20 x 2 = 160)                               -> 180
#   prediction:  4 mul + 3 add                                          -> 7
KRIGE_SOLVE_OPS = 36 + 60 + 50 + 180 + 7

# A scattered query's prologue: (lon - min) * inv_step on both axes (4),
# the centre cell's round on both (2 add, 2 floor) and its clamps (4).
QUERY_PROLOGUE_OPS = 12


def least_seconds(nbytes: float, f32_ops: float, f64_ops: float = 0.0) -> float:
    """The larger of the bytes at the bandwidth and the operations at the
    float32 and float64 rates."""
    return max(nbytes / HBM_BYTES_PER_S, f32_ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S)


def _masked(cfg, traffic):
    h, w = cfg["shape"]
    return (h, w), int(h * w * traffic["removal"]), traffic["removal"]


def krige_cells(cfg, traffic):
    """Ordinary kriging at the masked cells of an (H, W) tile, a fraction
    ``removal`` of its cells.

    Bytes: the elevation and validity planes, H*W float32 each, and one
    float32 value a masked cell.  Operations: a masked cell scans the
    distance-sorted window until it holds four valid cells, one test a
    candidate: with a fraction ``removal`` of cells masked at random that
    is 4 / (1 - removal) tests on average; then the solve
    (:data:`KRIGE_SOLVE_OPS`).  Observed cells need no work."""
    (h, w), n_cells, removal = _masked(cfg, traffic)
    nbytes = 2 * h * w * 4 + n_cells * 4
    ops = n_cells * (4.0 / (1.0 - removal) + KRIGE_SOLVE_OPS)
    return nbytes, ops, 0.0


def krige_queries(cfg, traffic):
    """Ordinary kriging at a batch of ``n`` scattered queries of a fully
    valid (H, W) grid.

    Bytes: the grid's elevation plane (a fully valid grid needs no validity
    plane), the float32 (lon, lat) of each query and one float32 value.
    Operations: the prologue and the solve.  On a fully valid lattice the
    four nearest cell centres follow from the query's position by the
    prologue's rounding, so no candidate scan is counted."""
    h, w = cfg["shape"]
    n = traffic["batch"]
    nbytes = h * w * 4 + n * 3 * 4
    return nbytes, n * (QUERY_PROLOGUE_OPS + KRIGE_SOLVE_OPS), 0.0


def idw_queries(cfg, traffic):
    """Inverse-distance weighting of the ``k`` nearest cells at a batch of
    ``n`` scattered queries of a fully valid (H, W) grid, power 2.

    Bytes as :func:`krige_queries`.  Operations: the prologue; each of the
    k cells' squared distance ((c + d) + half - x on both axes, 2 mul, add:
    7); a comparison each to rank it (k); its weight 1 / (d2 + eps) (2);
    the weighted sum and the weights' sum (3 a cell), and the quotient."""
    h, w = cfg["shape"]
    n, k = traffic["batch"], cfg["idw"]["k"]
    nbytes = h * w * 4 + n * 3 * 4
    ops = n * (QUERY_PROLOGUE_OPS + k * (7 + 1 + 2 + 3) + 1)
    return nbytes, ops, 0.0


def fit_fill_cells(cfg, traffic):
    """Fit an exponential variogram to the observed cells of an (H, W)
    tile, then krige its masked cells.

    Bytes as :func:`krige_cells`.  Operations: every pair of observed cells
    at a half-plane lag offset within ``max_lag`` takes a difference and its
    square in float32 and two float64 adds (the bin's sum and its count);
    with a fraction ``removal`` masked at random an in-grid pair is
    observed at both ends with probability (1 - removal)^2.  Then
    :func:`krige_cells`' operations.  The fit itself (tens of bins, a few
    steps) is left out: under a microsecond."""
    (h, w), _, removal = _masked(cfg, traffic)
    dys, dxs, _, _ = lag_table(cfg["fit"]["max_lag"], cfg["fit"]["n_bins"])
    in_grid = float(np.sum((h - dys) * (w - np.abs(dxs))))
    pairs = in_grid * (1.0 - removal) ** 2
    nbytes, krige_ops, _ = krige_cells(cfg, traffic)
    return nbytes, 2.0 * pairs + krige_ops, 2.0 * pairs

