"""Visualization CLI (counterpart of :mod:`auvtpu.cli.plots`, the rebuild
of graph_results.ipynb).

Writes PNG heatmaps instead of notebook cells:
- original / masked / reconstructed grids (cells 3-30, 32-70);
- the reconstruction merge is ``fill_reduced_grid`` (cell 38): observed cells
  keep their values, holes take the interpolated prediction;
- error map |reconstruction - truth| over the masked cells.

The fills run on ``--device`` (the card by default): Kriging through
``ops.kriging_at_cells`` (the fused kernel B1 on the card), Cubic and IDW
through ``fill_window_mean(k=4)`` / ``fill_idw(k=8)`` (B3), Bilinear through
``fill_bilinear`` (plain torch: it has no kernel).  ``--region kerguelen``
runs on the synthetic stand-in (that tile is missing upstream); any other
region needs its GEBCO tile.  Drawing needs matplotlib, imported only when
a heatmap is written.

Run: ``python3 -m auvtpu_torch.cli.plots --region kerguelen --method Kriging``
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import GEBCO_TILES
from ..grid import RegularGrid
from ..masking import mask_grid
from ..ops import fill_bilinear, fill_idw, fill_window_mean, kriging_at_cells

METHODS = ("Bilinear", "Cubic", "Kriging", "IDW")


def reconstruct(elev, ext, removal: float, method: str, *, device="cuda"):
    """Mask ``elev`` with the reference pipeline (seed 42), fill it on
    ``device`` by ``method``, and return host arrays (filled grid, the
    predictions at the masked cells, their (row, col), their true values)."""
    if method not in METHODS:
        raise ValueError(method)
    reduced, rc, truth = mask_grid(elev, removal)
    grid = RegularGrid.from_nan_array(reduced, ext, device=device)
    if method == "Kriging":
        rows = torch.as_tensor(rc[:, 0], device=grid.device)
        cols = torch.as_tensor(rc[:, 1], device=grid.device)
        pred = kriging_at_cells(grid, rows, cols).cpu().numpy().astype(np.float64)
        filled = reduced.copy()
        filled[rc[:, 0], rc[:, 1]] = pred
        return filled, pred, rc, truth
    plane = {
        "Bilinear": fill_bilinear,
        "Cubic": lambda g: fill_window_mean(g, k=4),
        "IDW": lambda g: fill_idw(g, k=8),
    }[method](grid).cpu().numpy().astype(np.float64)
    filled = np.where(np.isnan(reduced), plane, reduced)
    return filled, plane[rc[:, 0], rc[:, 1]], rc, truth


def _save_heatmap(path, data, title, vmin=None, vmax=None, cmap="viridis"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6), dpi=120)
    im = ax.imshow(data, origin="lower", cmap=cmap, vmin=vmin, vmax=vmax, aspect="auto")
    ax.set_title(title)
    ax.set_xlabel("lon index")
    ax.set_ylabel("lat index")
    fig.colorbar(im, ax=ax, label="elevation (m)")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def main(argv=None):
    from .bench_grid_b import GEBCO_ROOT_DEFAULT, load_region

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--region", default="mid_atlantic", choices=list(GEBCO_TILES))
    p.add_argument("--gebco-root", default=GEBCO_ROOT_DEFAULT)
    p.add_argument("--removal", type=float, default=0.10)
    p.add_argument("--method", default="Kriging", choices=list(METHODS))
    p.add_argument("--out-dir", default="results_local/plots")
    p.add_argument("--device", default="cuda", help="torch device of the fill (default: the card)")
    args = p.parse_args(argv)

    elev, ext = load_region(args.region, args.gebco_root)
    filled, pred, rc, truth = reconstruct(elev, ext, args.removal, args.method, device=args.device)
    reduced = filled.copy()
    reduced[rc[:, 0], rc[:, 1]] = np.nan

    os.makedirs(args.out_dir, exist_ok=True)
    vmin, vmax = np.nanmin(elev), np.nanmax(elev)
    pre = os.path.join(args.out_dir, f"{args.region}_r{args.removal}")
    _save_heatmap(f"{pre}_original.png", elev, f"{args.region} original", vmin, vmax)
    _save_heatmap(f"{pre}_masked.png", reduced, f"{args.region} masked ({args.removal:.0%})", vmin, vmax)
    _save_heatmap(
        f"{pre}_filled_{args.method.lower()}.png", filled,
        f"{args.region} reconstructed ({args.method})", vmin, vmax,
    )
    err = np.full_like(elev, np.nan)
    err[rc[:, 0], rc[:, 1]] = np.abs(pred - truth)
    _save_heatmap(
        f"{pre}_error_{args.method.lower()}.png", err,
        f"{args.region} |error| at masked cells ({args.method})", cmap="magma",
    )
    print(f"wrote 4 heatmaps to {args.out_dir}")


if __name__ == "__main__":
    main()
