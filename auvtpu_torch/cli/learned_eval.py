"""Learned-baseline Grid B evaluation (counterpart of
``auvtpu.cli.learned_eval``; motivation arXiv:2011.09707, PAPERS.md).

Protocol:
1. the tile is masked by the same seeded pipeline as bench_grid_b, so the
   held-out cells are identical;
2. the inpainter trains self-supervised on the reduced tile only: random
   crops with a further fraction of the *observed* cells hidden as targets
   (the held-out cells are invalid in every training input);
3. the trained model (or a checkpoint, ``--load-params``) fills the full
   plane once; the held-out cells are scored with the reference-biased
   metrics and appended as a reference-schema row (InterpolationType
   Learned, GridType B).

The grid, the parameters and training live on ``--device`` (the card by
default); the window-mean baseline is one B3 launch a tile there.
``--synthetic H W`` runs on a shelf + seamount tile with no GEBCO tile.

Run: ``python3 -m auvtpu_torch.cli.learned_eval --synthetic 512 512 --steps 20``
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..config import GEBCO_TILES, Extent
from ..grid import RegularGrid
from ..io import ResultsWriter
from ..masking import mask_grid
from ..metrics import all_reference_metrics
from ..utils import steady_state_ms, warm_e2e_ms
from .bench_grid_b import GEBCO_ROOT_DEFAULT, load_region, log


def main(argv=None):
    """Run the evaluation; returns {MAE, RMSE, MaxError, steady_ms, e2e_ms,
    n, losses (the training losses, empty for a checkpoint), train_s}
    besides appending the results CSV."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--region", default="mid_atlantic", choices=list(GEBCO_TILES))
    p.add_argument("--gebco-root", default=GEBCO_ROOT_DEFAULT)
    p.add_argument("--synthetic", nargs=2, type=int, metavar=("H", "W"),
                   help="use a synthetic shelf+seamount tile instead of a region")
    p.add_argument("--removal", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=42)
    # the JAX package's defaults, from its Mid-Atlantic sweep
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--width", type=int, default=16)
    p.add_argument("--depth", type=int, default=2)
    p.add_argument("--tile", type=int, default=48)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--results", default="results_local/TestingResults_gridB.csv")
    p.add_argument("--region-suffix", default="",
                   help="appended to the Region column (e.g. '_seed7' for rows on another mask seed)")
    p.add_argument("--machine", default=None, help="default: GPU or CPU by --device")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="torch device of the grid, the parameters and training (default: the card)")
    p.add_argument("--save-params", default=None, metavar="NPZ",
                   help="checkpoint the trained parameters (learned.save_params, the JAX package's format)")
    p.add_argument("--load-params", default=None, metavar="NPZ",
                   help="skip training and evaluate a checkpoint of either package instead")
    args = p.parse_args(argv)

    from ..learned import fill_learned, load_params, make_crop_batch, save_params, train

    if args.synthetic:
        from ..synthetic import shelf_seamount

        H, W = args.synthetic
        elev, ext = shelf_seamount(H, W), Extent(0.0, float(W - 1), 0.0, float(H - 1))
        args.region = f"synthetic{H}x{W}"
    else:
        elev, ext = load_region(args.region, args.gebco_root)
    reduced, rc, truth = mask_grid(elev, args.removal, seed=args.seed)
    grid = RegularGrid.from_nan_array(np.asarray(reduced, np.float32), ext, device=args.device)
    elev_plane = grid.elev.cpu().numpy()
    valid_plane = grid.valid.cpu().numpy()
    log(f"{args.region}: {elev.shape} grid on {grid.device}, {len(truth)} held-out cells; "
        f"training {args.steps} steps (width {args.width}, depth {args.depth})")

    hist, train_s = [], 0.0
    if args.load_params:
        params, args.width, args.depth = load_params(args.load_params, device=args.device)
        log(f"loaded checkpoint {args.load_params} (width {args.width}, depth {args.depth})")
    else:
        t0 = time.time()
        params, hist = train(
            steps=args.steps, width=args.width, depth=args.depth, tile=args.tile,
            batch=args.batch, lr=args.lr, seed=args.seed,
            log_every=max(1, args.steps // 10), log=log, device=args.device,
            batch_fn=lambda rng: make_crop_batch(rng, elev_plane, valid_plane, n=args.batch, tile=args.tile),
        )
        train_s = time.time() - t0
        log(f"trained in {train_s:.1f}s ({train_s / args.steps * 1e3:.2f} ms a step, host clock); "
            f"masked-crop MSE {hist[0]:.2f} -> {hist[-1]:.2f}")
    if args.save_params:
        save_params(args.save_params, params, width=args.width, depth=args.depth)
        log(f"checkpointed parameters to {args.save_params}")

    fill = lambda: fill_learned(grid, params, width=args.width, depth=args.depth)
    plane = fill().cpu().numpy()
    pred = plane[rc[:, 0], rc[:, 1]].astype(np.float64)
    m = all_reference_metrics(truth, pred)
    log(f"held-out metrics: {m}")

    ms = steady_state_ms(fill, iters=5, warmup=1)
    cold, _ = warm_e2e_ms(fill)
    machine = args.machine or ("GPU" if grid.elev.is_cuda else "CPU")
    w = ResultsWriter(args.results, with_region=True, with_cold=True)
    w.append(
        machine, "Learned", "B", len(truth), ms, args.removal,
        m["MAE"], m["RMSE"], m["MaxError"],
        region=args.region + args.region_suffix, cold_ms=cold,
    )
    log(f"appended Learned row to {args.results} ({ms:.2f} ms steady, {cold:.2f} ms warm e2e)")
    return dict(m, steady_ms=ms, e2e_ms=cold, n=len(truth), losses=hist, train_s=train_s)


if __name__ == "__main__":
    main()
