#!/usr/bin/env python3
"""The JAX package's figures that ``chip_smoke.py`` holds exact mode and the
learned baseline to (its ``EXACT_PINS`` and ``LEARNED_PINS``), on XLA:CPU.

The machine with the card has no JAX, so these are computed here and pasted
into the smoke.  The workload is the smoke's: the 2053x2441 Kerguelen
stand-in with 10 % of cells masked (mask seed 42, 501,137 cells).

- exact mode (x64 on, an f64 grid): ``exact_kriging_at_cells_fast`` (table
  solve) with its escalated count from ``exact_select_at_cells_fast``,
  ``exact_cubic_at_cells`` and ``exact_bilinear_at_cells``: the reference
  metrics over the masked cells, the f64 sum of the predictions and the
  count of finite ones;
- the learned fill of ``results/learned_mid_atlantic_w16d2.npz`` on the f32
  grid: ``fill_learned`` (bf16 compute) and the same fill with an f32
  module (``MaskedConvInpainter(compute_dtype=jnp.float32)``): the
  reference metrics over the masked cells and the f64 nansum of the plane.

Run from the root of a checkout (~3 min, ~4 GB):
    JAX_PLATFORMS=cpu python3 tools/jax_reference_pins.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _scores(truth, pred):
    from auvtpu.metrics import all_reference_metrics

    m = all_reference_metrics(truth, pred)
    return dict(MAE=float(m["MAE"]), RMSE=float(m["RMSE"]), MaxError=float(m["MaxError"]),
                sum=float(np.nansum(pred)), finite=int(np.isfinite(pred).sum()))


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from auvtpu import learned
    from auvtpu.config import KERGUELEN_EXTENT
    from auvtpu.grid import RegularGrid
    from auvtpu.masking import mask_grid
    from auvtpu.ops import exact, exact_fast, fill_window_mean
    from auvtpu.synthetic import kerguelen_standin

    reduced, rc, truth = mask_grid(kerguelen_standin((2053, 2441)), 0.10)
    rows, cols = rc[:, 0], rc[:, 1]

    g64 = RegularGrid.from_nan_array(reduced, KERGUELEN_EXTENT, dtype=jnp.float64)
    esc = exact_fast.exact_select_at_cells_fast(g64, rows, cols)[5]
    pins = {"exact": {
        "kriging_two": dict(_scores(truth, exact_fast.exact_kriging_at_cells_fast(g64, rows, cols)),
                            escalated=int(esc.sum())),
        "cubic": _scores(truth, exact.exact_cubic_at_cells(g64, rows, cols)),
        "bilinear": _scores(truth, exact.exact_bilinear_at_cells(g64, rows, cols)),
    }, "n": int(len(truth))}
    del g64

    g32 = RegularGrid.from_nan_array(reduced, KERGUELEN_EXTENT)
    params, width, depth = learned.load_params(os.path.join(REPO, "results", "learned_mid_atlantic_w16d2.npz"))
    mf = fill_window_mean(g32)
    model = learned.MaskedConvInpainter(width=width, depth=depth, compute_dtype=jnp.float32)
    x, _, std = learned._features(g32.elev[None], g32.valid[None], mf[None])
    pred = jnp.where(jnp.isnan(mf), jnp.nan, mf + std[0] * model.apply({"params": params}, x)[0])
    planes = {
        "f32": np.asarray(jnp.where(g32.valid > 0.5, g32.elev, pred)),
        "bf16": np.asarray(learned.fill_learned(g32, params, width=width, depth=depth)),
    }
    pins["learned"] = {}
    for name, plane in planes.items():
        s = _scores(truth, plane[rows, cols].astype(np.float64))
        pins["learned"][name] = dict(s, nansum=float(np.nansum(plane.astype(np.float64))))
    print(json.dumps(pins))
    return 0


if __name__ == "__main__":
    sys.exit(main())
