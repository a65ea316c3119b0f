"""Masking pipeline CLI (counterpart of :mod:`auvtpu.cli.subset`, the
rebuild of subset_bathymetry.py).

Reads a GEBCO netCDF tile (or named region), flips rows, removes a seeded
random fraction of cells, and writes the four reference CSVs:
original_data.csv, reduced_data.csv (NaN holes), reference_missing.csv
(row,col,elev), reference_missing_coords.csv (lon,lat,elev).  ``--region
kerguelen`` has no tile and writes the synthetic stand-in, its lat/lon the
extent's evenly spaced coordinates.  Host-side numpy only.

Run: ``python3 -m auvtpu_torch.cli.subset --region kerguelen --out-dir test_data``
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import GEBCO_TILES
from ..io import load_gebco, write_grid_csv, write_reference_missing
from ..masking import select_random_points
from ..synthetic import kerguelen_standin


def load_tile(nc: str | None, region: str | None, gebco_root: str):
    """(lat, lon, data): the tile's coordinate vectors as stored and its
    elevations with rows flipped (subset_bathymetry.py:17)."""
    if nc is None and GEBCO_TILES[region]["path"] is None:
        tile = GEBCO_TILES[region]
        ext = tile["extent"]
        data = kerguelen_standin(tile["shape"])
        return (np.linspace(ext.min_lat, ext.max_lat, data.shape[0]),
                np.linspace(ext.min_lon, ext.max_lon, data.shape[1]), data)
    lat, lon, elev = load_gebco(nc or os.path.join(gebco_root, GEBCO_TILES[region]["path"]))
    return lat, lon, elev[::-1].copy()


def main(argv=None):
    from .bench_grid_b import GEBCO_ROOT_DEFAULT

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nc", default=None, help="netCDF path (or use --region)")
    p.add_argument("--region", default=None, choices=list(GEBCO_TILES))
    p.add_argument("--gebco-root", default=GEBCO_ROOT_DEFAULT)
    p.add_argument("--removal", type=float, default=0.10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out-dir", default="test_data")
    args = p.parse_args(argv)
    if args.nc is None and args.region is None:
        p.error("give --nc or --region")

    lat, lon, data = load_tile(args.nc, args.region, args.gebco_root)

    os.makedirs(args.out_dir, exist_ok=True)
    write_grid_csv(os.path.join(args.out_dir, "original_data.csv"), data)

    flat = select_random_points(data.shape, args.removal, args.seed)
    rows, cols = np.divmod(flat, data.shape[1])
    vals = data[rows, cols].copy()
    print(f"Selected {len(flat)} points for removal.")

    write_reference_missing(
        os.path.join(args.out_dir, "reference_missing.csv"),
        np.stack([rows, cols], axis=1), vals,
    )
    # the lon/lat variant indexes the *unflipped* lat by the flipped row
    # index, as the reference does (subset_bathymetry.py:62-69)
    with open(os.path.join(args.out_dir, "reference_missing_coords.csv"), "w") as f:
        for r, c, v in zip(rows, cols, vals):
            f.write(f"{lon[c]:.10g},{lat[r]:.10g},{v:.10g}\n")

    reduced = data.copy()
    reduced[rows, cols] = np.nan
    write_grid_csv(os.path.join(args.out_dir, "reduced_data.csv"), reduced)
    print(f"Wrote original/reduced/reference CSVs to {args.out_dir}")


if __name__ == "__main__":
    main()
