"""Generate synthetic test grids (counterpart of :mod:`auvtpu.cli.gen_grid`,
the rebuild of generate_csv_grids.cpp).

Default matches the reference: one 4000x3200 shelf+seamount grid written to
grid_large.csv (generate_csv_grids.cpp:99-104).  `.npy` output is supported
for fast reloads (the 12.8M-cell CSV takes a while on one host core).
Host-side numpy only: nothing runs on a device.

Run: ``python3 -m auvtpu_torch.cli.gen_grid --out grid_large.npy``
"""

from __future__ import annotations

import argparse

import numpy as np

from ..io import write_grid_csv
from ..synthetic import shelf_seamount, sinusoid


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--num-lon", type=int, default=4000)
    p.add_argument("--num-lat", type=int, default=3200)
    p.add_argument("--surface", choices=["shelf_seamount", "sinusoid"], default="shelf_seamount")
    p.add_argument("--out", default="grid_large.csv", help=".csv or .npy")
    args = p.parse_args(argv)

    gen = shelf_seamount if args.surface == "shelf_seamount" else sinusoid
    grid = gen(args.num_lat, args.num_lon)
    if args.out.endswith(".npy"):
        np.save(args.out, grid)
    else:
        write_grid_csv(args.out, grid)
    print(f"Generated {args.out} (Dimensions: {args.num_lon} x {args.num_lat})")


if __name__ == "__main__":
    main()
