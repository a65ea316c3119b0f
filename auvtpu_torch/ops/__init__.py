"""Torch interpolation ops: the ordinary-kriging solve and the dense
(cell-aligned) fills: bilinear, window mean, IDW and kriging."""

from .dense import (
    fill_bilinear,
    fill_idw,
    fill_kriging,
    fill_window_mean,
    krige_planes,
    kriging_at_cells,
    resolve_backend,
    window_topk_idx,
    window_topk_planes,
)
from .scattered import gj56, krige_solve, krige_solve_cols, lu56, variogram

__all__ = [
    "fill_bilinear",
    "fill_idw",
    "fill_kriging",
    "fill_window_mean",
    "krige_planes",
    "kriging_at_cells",
    "resolve_backend",
    "window_topk_idx",
    "window_topk_planes",
    "gj56",
    "krige_solve",
    "krige_solve_cols",
    "lu56",
    "variogram",
]
