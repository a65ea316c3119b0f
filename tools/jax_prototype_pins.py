#!/usr/bin/env python3
"""The JAX package's figures that ``chip_smoke.py`` holds the prototype
pipeline to (its ``PROTO_PINS``), on XLA:CPU with x64 off.

The machine with the card has no JAX, so these are computed here and pasted
into the smoke.  The workload is the prototype CLI's on the 2053x2441
Kerguelen stand-in cropped to its top-left 120x160 cells, 1 % sampled (seed
42, 192 samples): ``auvtpu.scattered.sample_and_reconstruct`` for each
method at k=16 (and kriging with the anisotropic fit), scored as
``auvtpu.cli.prototype`` scores it, on the cells not sampled.

Run from the root of a checkout (~30 s):
    JAX_PLATFORMS=cpu python3 tools/jax_prototype_pins.py
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CROP = (120, 160)
RUNS = {"linear": {}, "idw": {}, "aidw": {}, "kriging": {}, "kriging aniso": {"aniso": True}}


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from auvtpu.config import GEBCO_TILES, Extent
    from auvtpu.scattered import sample_and_reconstruct
    from auvtpu.synthetic import kerguelen_standin

    tile = GEBCO_TILES["kerguelen"]
    elev = kerguelen_standin(tile["shape"])
    ext = tile["extent"]
    dlat = (ext.max_lat - ext.min_lat) / (elev.shape[0] - 1)
    dlon = (ext.max_lon - ext.min_lon) / (elev.shape[1] - 1)
    ch, cw = CROP
    elev = elev[:ch, :cw]
    ext = Extent(ext.min_lon, ext.min_lon + dlon * (cw - 1), ext.min_lat, ext.min_lat + dlat * (ch - 1))
    pins = {}
    for name, kw in RUNS.items():
        pred, mask = sample_and_reconstruct(elev, ext, subset_fraction=0.01, method=name.split()[0], k=16, seed=42,
                                            **kw)
        err = np.asarray(pred)[~mask] - elev[~mask]
        pins[name] = dict(RMSE=float(np.sqrt(np.nanmean(err ** 2))), MAE=float(np.nanmean(np.abs(err))))
    print(json.dumps(pins, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
