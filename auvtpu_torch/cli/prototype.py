"""Scattered-data prototype pipeline CLI (counterpart of
:mod:`auvtpu.cli.prototype`, the rebuild of the reference's ``main.py`` +
``test_interpolation.py``): sample a fraction of a GEBCO tile, predict the
whole grid from the samples (:func:`auvtpu_torch.scattered.sample_and_reconstruct`),
and report the RMSE per method over the cells that were not sampled.

``--region kerguelen`` has no tile and runs on the synthetic stand-in;
``--crop H W`` keeps the top-left corner (the extent follows, so the cell
spacing stays the tile's).  ``--device cpu`` runs on the CPU.

Run: ``python3 -m auvtpu_torch.cli.prototype --region kerguelen --crop 746 1086``
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..config import GEBCO_TILES, Extent
from ..scattered import sample_and_reconstruct


def main(argv=None):
    """Run the methods; returns {method: {rmse, mae, max, wall_s, n}}."""
    from .bench_grid_b import GEBCO_ROOT_DEFAULT, load_region

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--region", default="us_east_coast", choices=list(GEBCO_TILES))
    p.add_argument("--gebco-root", default=GEBCO_ROOT_DEFAULT)
    p.add_argument("--subset", type=float, default=0.01, help="sample fraction (main.py used 0.01)")
    p.add_argument("--k", type=int, default=16,
                   help="moving-window neighbours (the prototype used PyKrige's n_closest_points=50)")
    p.add_argument("--methods", nargs="*", default=["linear", "idw", "kriging"],
                   choices=["linear", "idw", "aidw", "kriging"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out-prefix", default=None, help="write reconstructed grids as .npy")
    p.add_argument("--model", default="exponential", choices=["exponential", "linear", "spherical", "gaussian", "best"],
                   help="kriging variogram model ('linear' = the prototype's PyKrige choice; 'best' fits the zoo "
                   "and keeps the lowest weighted SSE)")
    p.add_argument("--trend", default="plane", choices=["plane", "none"],
                   help="kriging local trend removal ('none' = plain ordinary kriging like the prototype)")
    p.add_argument("--aniso", action="store_true",
                   help="kriging only: fit a directional ellipse from the samples and krige in correlation distance")
    p.add_argument("--density", default="uniform", choices=["uniform", "strip"],
                   help="sample layout: 'strip' gives a central row corridor 10x the sampling odds")
    p.add_argument("--results", default=None,
                   help="append reference-schema rows (GridType=P, Machine suffixed with the density) to this CSV")
    p.add_argument("--crop", type=int, nargs=2, metavar=("H", "W"), default=None,
                   help="use only the top-left HxW corner of the tile")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = p.parse_args(argv)

    elev, ext = load_region(args.region, args.gebco_root)
    if args.crop is not None:
        ch, cw = min(args.crop[0], elev.shape[0]), min(args.crop[1], elev.shape[1])
        # rescale the extent so the cell spacing is kept on the crop
        dlat = (ext.max_lat - ext.min_lat) / (elev.shape[0] - 1)
        dlon = (ext.max_lon - ext.min_lon) / (elev.shape[1] - 1)
        elev = elev[:ch, :cw]
        ext = Extent(ext.min_lon, ext.min_lon + dlon * (cw - 1), ext.min_lat, ext.min_lat + dlat * (ch - 1))
    print(f"{args.region}: {elev.shape[1]} x {elev.shape[0]} cells, sampling {args.subset:.1%} ({args.density}) "
          f"on {args.device}", flush=True)
    span = np.nanmax(elev) - np.nanmin(elev)

    writer = None
    if args.results:
        from ..io import ResultsWriter

        writer = ResultsWriter(args.results, with_region=True, with_cold=True)

    summary = {}
    for method in args.methods:
        t0 = time.perf_counter()
        pred, sample_mask = sample_and_reconstruct(
            elev, ext, subset_fraction=args.subset, method=method, k=args.k, seed=args.seed, model=args.model,
            trend=args.trend, aniso=args.aniso and method == "kriging", density=args.density, device=args.device,
        )
        dt = time.perf_counter() - t0  # the prediction is on the host: the card has finished
        hold = ~sample_mask  # scored on the cells not sampled (test_interpolation.py:111-146)
        err = pred[hold] - elev[hold]
        rmse = float(np.sqrt(np.nanmean(err**2)))
        mae = float(np.nanmean(np.abs(err)))
        mx = float(np.nanmax(np.abs(err)))
        print(f"  {method:8s}: RMSE {rmse:9.3f} m  ({100 * rmse / span:5.2f}% of range)  MAE {mae:8.3f} m  "
              f"wall {dt:6.1f}s for {hold.sum()} predictions", flush=True)
        summary[method] = dict(rmse=rmse, mae=mae, max=mx, wall_s=dt, n=int(hold.sum()))
        if writer is not None:
            writer.append(f"GPU-proto-{args.density}", method, "P", int(hold.sum()), dt * 1e3, 1.0 - args.subset,
                          mae, rmse, mx, region=args.region, cold_ms=dt * 1e3)
        if args.out_prefix:
            np.save(f"{args.out_prefix}_{method}.npy", pred)
    return summary


if __name__ == "__main__":
    main()
