"""The port's main entry point: fit the variogram from the observed cells,
krige-fill the masked grid, keep the observed values (counterpart of
``__graft_entry__.entry``)."""

from __future__ import annotations

import torch

from .config import Extent
from .grid import RegularGrid
from .masking import mask_grid
from .ops.dense import fill_kriging
from .synthetic import shelf_seamount
from .variogram import fit_variogram


def tiny_masked_grid(h: int = 96, w: int = 64, removal: float = 0.2, *, device="cuda") -> RegularGrid:
    """The small masked shelf-and-seamount grid of ``__graft_entry__``: unit
    steps, 20% of cells removed with seed 3."""
    elev = shelf_seamount(h, w)
    elev, _, _ = mask_grid(elev, removal, seed=3)
    return RegularGrid.from_nan_array(
        elev, Extent(0.0, float(w - 1), 0.0, float(h - 1)), device=device
    )


def fit_fill(grid: RegularGrid, *, backend: str = "fused"):
    """Fit an exponential variogram to ``grid``, krige-fill every cell with
    it, and keep the observed values.  Returns (filled plane, (nugget, sill,
    range)), the parameters as 0-d tensors on the grid's device."""
    vparams = fit_variogram(grid)
    plane = fill_kriging(grid, vparams=vparams, backend=backend)
    return torch.where(grid.valid > 0.5, grid.elev, plane), vparams
