#!/usr/bin/env python3
"""The JAX package's variogram fit of the whole Kerguelen stand-in, on
XLA:CPU with x64 off: the figures ROADMAP section C1 quotes.
``tests/test_torch_variogram.py`` runs the same fit live and holds the
port's to it.

The workload is the bench's: the 2053x2441 stand-in with 10 % of cells
masked (seed 42) on the Kerguelen extent, and ``auvtpu.variogram.
fit_variogram`` with its defaults (10 bins, 25 iterations).  It prints the
fitted (nugget, sill, range), the fitted gamma at the bin lags (in degrees,
the lags the fit saw), and the empirical gamma and pair counts.

Run from the root of a checkout (~20 s, ~2 GB):
    JAX_PLATFORMS=cpu python3 tools/jax_fit_pins.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REMOVAL = 0.10


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from auvtpu.config import GEBCO_TILES
    from auvtpu.grid import RegularGrid
    from auvtpu.masking import mask_grid
    from auvtpu.synthetic import kerguelen_standin
    from auvtpu.variogram import empirical_variogram, fit_exponential, variogram_model

    tile = GEBCO_TILES["kerguelen"]
    reduced, _, _ = mask_grid(kerguelen_standin(tile["shape"]), REMOVAL)
    grid = RegularGrid.from_nan_array(reduced, tile["extent"])
    lags, gamma, counts = empirical_variogram(grid)
    step = 0.5 * (abs(grid.lat_step) + abs(grid.lon_step))
    params = fit_exponential(lags * step, gamma, counts, iters=25)  # = fit_variogram(grid)
    h = np.asarray(lags, np.float64) * step
    fitted = np.asarray(variogram_model(h, tuple(float(p) for p in params)), np.float64)
    print(json.dumps(dict(
        params=[float(p) for p in params],
        lags_deg=h.tolist(),
        gamma_fitted=fitted.tolist(),
        gamma_empirical=np.asarray(gamma, np.float64).tolist(),
        counts=np.asarray(counts, np.float64).tolist(),
    ), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
