"""Grid B benchmark (rebuild of test_gebco.cpp): masked-cell recovery.

Workflow (test_gebco.cpp:100-308):
1. load a GEBCO tile (named region or CSV), flip rows, apply the seeded
   masking pipeline (or read pre-made reduced/reference CSVs);
2. predict the masked cells with bilinear / window-mean ('Cubic': at masked
   centres the reference's bicubic always takes its fallback path) / kriging /
   IDW using the dense cell-aligned fills;
3. score MAE/RMSE/max with the reference-biased metrics; append
   reference-schema rows (GridType=B) and write per-point CSVs.

On a CUDA grid ``--backend auto`` runs Cubic and IDW through the B3 fill
kernel and Kriging through the fused B1 kernel; Bilinear has no kernel and
is plain torch.  The exact-selection mode (``--selection exact``,
``--exact-tier``) and the ``--debug`` modes of the JAX CLI are not in the
port yet.

Run: ``python3 -m auvtpu_torch.cli.bench_grid_b --region kerguelen``
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import GEBCO_TILES, Extent
from ..grid import RegularGrid
from ..io import (
    ResultsWriter,
    load_gebco_flipped,
    read_grid_csv,
    read_reference_missing,
    write_points_csv,
)
from ..masking import mask_grid
from ..metrics import all_reference_metrics, coverage
from ..ops import fill_bilinear, fill_idw, fill_window_mean, kriging_at_cells, resolve_backend
from ..synthetic import kerguelen_standin
from ..utils import steady_state_ms, time_once_ms, warm_e2e_ms

# GEBCO tiles are looked up under the checkout's data_local/ (gitignored)
GEBCO_ROOT_DEFAULT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data_local", "GEBCO-Data",
)


def log(*a):
    print(*a, flush=True)


def load_region(region: str, gebco_root: str):
    tile = GEBCO_TILES[region]
    if tile["path"] is None:
        log(f"{region}: tile missing upstream; generating synthetic stand-in {tile['shape']}")
        return kerguelen_standin(tile["shape"]), tile["extent"]
    _, _, elev = load_gebco_flipped(os.path.join(gebco_root, tile["path"]))
    return elev, tile["extent"]


def main(argv=None):
    """Run the benchmark; returns {method: MAE, RMSE, MaxError, coverage,
    steady_ms, e2e_ms, n (held-out points)} besides appending the results
    CSV."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--region", default="mariana", choices=list(GEBCO_TILES))
    p.add_argument("--gebco-root", default=GEBCO_ROOT_DEFAULT)
    p.add_argument("--reduced-csv", default=None, help="pre-masked grid CSV (matrix)")
    p.add_argument("--reference-csv", default=None, help="row,col,elev held-out CSV")
    p.add_argument("--min-lon", type=float), p.add_argument("--max-lon", type=float)
    p.add_argument("--min-lat", type=float), p.add_argument("--max-lat", type=float)
    p.add_argument("--removal", type=float, default=0.10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--results", default="results_local/TestingResults1.csv")
    p.add_argument("--machine", default="GPU")
    p.add_argument("--out-prefix", default=None, help="write per-point CSVs with this prefix")
    p.add_argument("--methods", nargs="*", default=["Bilinear", "Cubic", "Kriging", "IDW"])
    p.add_argument("--idw-k", type=int, default=8)
    p.add_argument(
        "--backend", choices=["auto", "torch", "select", "fused"], default="auto",
        help="auto: the CUDA kernels on a CUDA float32 grid (Cubic/IDW: B3, "
        "Kriging: B1), plain torch otherwise; torch: plain versions; fused: "
        "the kernels; select: Kriging by the B2 selection kernel and the "
        "torch solve (Cubic/IDW as fused)",
    )
    p.add_argument(
        "--convention", choices=["reference", "centered"], default="reference",
        help="neighbour-distance convention: 'reference' reproduces the "
        "study's asymmetric +0.5 metric; 'centered' is the corrected "
        "symmetric metric (docs/SEMANTICS.md)",
    )
    p.add_argument(
        "--variogram-model", default="exponential",
        choices=["exponential", "linear", "spherical", "gaussian", "best"],
        help="kriging variogram model; non-exponential models FIT their "
        "params from the masked grid's empirical variogram (the reference "
        "constants nugget=1/sill=100/range=10 are exponential-only, "
        "GridH.cpp:371-376); 'best' fits the whole zoo and keeps the "
        "lowest weighted-SSE model",
    )
    p.add_argument("--device", default="cuda", help="torch device of the grid (default: the card)")
    args = p.parse_args(argv)

    if args.reduced_csv:
        reduced = read_grid_csv(args.reduced_csv)
        rc, truth = read_reference_missing(args.reference_csv)
        ext = Extent(args.min_lon, args.max_lon, args.min_lat, args.max_lat)
        region_name = os.path.basename(args.reduced_csv)
    else:
        elev, ext = load_region(args.region, args.gebco_root)
        reduced, rc, truth = mask_grid(elev, args.removal, args.seed)
        region_name = args.region
    n_pts = len(truth)
    log(f"masked grid {reduced.shape[1]} x {reduced.shape[0]}, {n_pts} held-out points")

    grid = RegularGrid.from_nan_array(reduced, ext, device=args.device)
    rows = torch.as_tensor(rc[:, 0], dtype=torch.int64).to(grid.device)
    cols = torch.as_tensor(rc[:, 1], dtype=torch.int64).to(grid.device)
    flat = rows * grid.num_lon + cols
    results = ResultsWriter(args.results, with_region=True, with_cold=True)
    backend = resolve_backend(args.backend, grid.elev)
    log(f"grid on {grid.device}, backend {args.backend} -> {backend}")

    def at_cells(plane):
        return plane.reshape(-1)[flat]

    conv = args.convention
    machine = args.machine if conv == "reference" else f"{args.machine}-centered"
    vmodel = args.variogram_model
    vparams = None
    if vmodel != "exponential":
        # the reference constants are exponential-only: fit this model to
        # the masked grid's own empirical variogram
        from ..variogram import empirical_variogram, fit_best_model, fit_model

        lags_e, gamma_e, counts_e = empirical_variogram(grid)
        step = 0.5 * (abs(grid.lat_step) + abs(grid.lon_step))
        if vmodel == "best":
            vmodel, vparams, sse = fit_best_model(lags_e * step, gamma_e, counts_e)
            log(f"best-fit model: {vmodel} (weighted SSE {sse:.4g})")
        else:
            vparams = fit_model(lags_e * step, gamma_e, counts_e, model=vmodel)
        machine = f"{machine}-{vmodel}"
        log(f"fitted {vmodel} variogram: " + " ".join(f"{float(v):.4g}" for v in vparams))

    ops = {
        "Bilinear": lambda: at_cells(fill_bilinear(grid)),
        "Cubic": lambda: at_cells(fill_window_mean(grid, k=4, convention=conv, backend=backend)),
        "Kriging": lambda: kriging_at_cells(
            grid, rows, cols, convention=conv, backend=backend,
            vparams=vparams, model=vmodel,
        ),
        "IDW": lambda: at_cells(fill_idw(grid, k=args.idw_k, convention=conv, backend=backend)),
    }

    # steady-state iteration count scales inversely with batch size, so
    # small batches still report device time rather than host overhead
    iters = int(np.clip(2_000_000 // max(n_pts, 1), 5, 100))

    summary = {}
    for method in args.methods:
        fn = ops[method]
        first_ms, _ = time_once_ms(fn)  # kernel build + warm-up; log-only, never CSV
        e2e_ms, out = warm_e2e_ms(fn)
        warm_ms = steady_state_ms(fn, iters=iters)
        pred = out.detach().cpu().numpy().astype(np.float64)
        m = all_reference_metrics(truth, pred)
        cov = float(coverage(pred))
        log(
            f"[B {region_name} r={args.removal}] {method:8s} end-to-end {e2e_ms:7.2f} ms  "
            f"steady {warm_ms:7.3f} ms  (first call {first_ms/1e3:6.2f} s)  "
            f"MAE={m['MAE']:.6f} RMSE={m['RMSE']:.6f} "
            f"MAX={m['MaxError']:.3f} coverage={cov:.8f}"
        )
        results.append(
            machine, method, "B", n_pts, warm_ms, args.removal,
            m["MAE"], m["RMSE"], m["MaxError"], region=region_name,
            cold_ms=e2e_ms,
        )
        summary[method] = dict(m, coverage=cov, steady_ms=warm_ms, e2e_ms=e2e_ms, n=n_pts)
        if args.out_prefix:
            qlon, qlat = grid.index_to_lonlat(rc[:, 0], rc[:, 1])
            write_points_csv(
                f"{args.out_prefix}_{machine.lower()}_{method.lower()}.csv",
                qlon, qlat, pred,
            )
    return summary


if __name__ == "__main__":
    main()
