"""Mission serving CLI: trajectory-band/atlas kriging for AUV survey tracks
(counterpart of :mod:`auvtpu.cli.mission`, one device).

Load a (masked) grid, take an ordered mission trajectory, let the cost
router pick between the packed two-tier path and the dense band/atlas fill
plus the chunked bilinear resample (:mod:`auvtpu_torch.ops.band`, kernel
B8), serve the batch, and report route, geometry, resolved fraction and
timings.

Trajectories come from a CSV (``--trajectory-csv``, columns lon,lat) or the
built-in synthetic missions (``--synthetic band|diagonal``).
``--export-dir`` also writes the serving pair
(:func:`~auvtpu_torch.serve.export_mission_fill`,
:func:`~auvtpu_torch.serve.export_mission_resample`) so that production
serving traces no Python: ``mission_fill.pt2`` and ``mission_resample.pt2``,
``torch.export`` programs (the JAX CLI's ``.bin`` files are StableHLO, a
format of their own).

Run: ``python3 -m auvtpu_torch.cli.mission --synthetic diagonal``
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..config import GEBCO_TILES
from ..grid import RegularGrid
from ..io import write_points_csv
from ..masking import mask_grid


def log(*a):
    print(*a, flush=True)


def synthetic_trajectory(kind: str, grid: RegularGrid, n: int, seed: int = 0):
    """The probe workloads: 'band' = monotone lon sweep + cross-track weave
    inside a ~120-row band; 'diagonal' = corner-to-corner weaving corridor.
    The weave period is fixed in PINGS (~12.5k pings a cycle, so a 512-ping
    chunk spans ~14 rows), not in track fraction: otherwise small --pings
    counts would compress the weave until every chunk spans the full
    amplitude and nothing fits the resample window."""
    H, W = grid.shape
    t = np.linspace(0.0, 1.0, n)
    rng = np.random.default_rng(seed)
    x = 1.0 + t * (W - 3)
    weave = np.sin(np.arange(n) * (2.0 * np.pi / 12_500.0))
    if kind == "band":
        y = H * 0.45 + min(55.0, H * 0.1) * weave
    elif kind == "diagonal":
        y = 1.0 + t * (H - 3) + min(55.0, H * 0.05) * weave
    else:
        raise ValueError(kind)
    x = np.clip(x + rng.normal(0, 0.05, n), 0.5, W - 1.5)
    y = np.clip(y + rng.normal(0, 0.05, n), 0.5, H - 1.5)
    lon = (grid.min_lon + x * grid.lon_step).astype(np.float32)
    lat = (grid.min_lat + y * grid.lat_step).astype(np.float32)
    return lon, lat


def main(argv=None):
    """Run the mission; returns {route, pages, cells, masked, unresolved
    (None on the packed route), n, depth_sum (f64 sum of the served depths),
    wall_ms}."""
    from .bench_grid_b import GEBCO_ROOT_DEFAULT

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--region", default=None, choices=list(GEBCO_TILES))
    p.add_argument("--gebco-root", default=GEBCO_ROOT_DEFAULT)
    p.add_argument("--grid-shape", type=int, nargs=2, default=[512, 640],
                   help="synthetic grid shape when no --region is given")
    p.add_argument("--removal", type=float, default=0.10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--trajectory-csv", default=None,
                   help="CSV with lon,lat columns (ordered mission track)")
    p.add_argument("--synthetic", default="band", choices=["band", "diagonal"])
    p.add_argument("--pings", type=int, default=200_000)
    p.add_argument("--chunk", type=int, default=2048)
    p.add_argument("--win-rows", type=int, default=112)
    p.add_argument("--win-cols", type=int, default=128)
    p.add_argument("--max-bands", type=int, default=8)
    p.add_argument("--fill-backend", default="auto", choices=["auto", "torch", "fused"],
                   help="band fills: the B1/B3 kernels (fused; auto on a CUDA float32 grid) or plain torch")
    p.add_argument("--convention", default="reference", choices=["reference", "centered"])
    p.add_argument("--force", default=None, choices=["band", "packed"],
                   help="skip the cost router and force a path")
    p.add_argument("--out", default=None, help="predictions CSV (lon,lat,depth)")
    p.add_argument("--device", default="cuda", help="torch device of the grid (default: the card)")
    p.add_argument("--export-dir", default=None,
                   help="write mission_fill.pt2/mission_resample.pt2 here (requires the band path: the router's "
                   "choice or --force band)")
    args = p.parse_args(argv)

    from ..ops.band import BandRouter
    from ..synthetic import shelf_seamount

    if args.region:
        from .bench_grid_b import load_region

        elev, ext = load_region(args.region, args.gebco_root)
    else:
        from ..config import Extent

        H, W = args.grid_shape
        elev = shelf_seamount(H, W)
        ext = Extent(0.0, float(W - 1), 0.0, float(H - 1))
        log(f"synthetic shelf+seamount grid {H}x{W}")
    reduced, _, _ = mask_grid(elev, args.removal, args.seed)
    grid = RegularGrid.from_nan_array(np.asarray(reduced, np.float32), ext, device=args.device)
    log(f"grid {grid.shape[0]}x{grid.shape[1]}, removal {args.removal}, on {grid.device}")

    if args.trajectory_csv:
        track = np.genfromtxt(args.trajectory_csv, delimiter=",", names=True)
        lon = np.atleast_1d(np.asarray(track["lon"], np.float32))
        lat = np.atleast_1d(np.asarray(track["lat"], np.float32))
    else:
        lon, lat = synthetic_trajectory(args.synthetic, grid, args.pings, args.seed)
    log(f"trajectory: {len(lon)} pings ({'csv' if args.trajectory_csv else args.synthetic})")

    router = BandRouter(
        grid, convention=args.convention, chunk=args.chunk, win_rows=args.win_rows,
        win_cols=args.win_cols, fill_backend=args.fill_backend, max_bands=args.max_bands,
    )
    choice = args.force or router.route(lon, lat)
    log(f"route: {choice}" + (" (forced)" if args.force else f" (coherence {router.last_coherence:.4f})"))
    if args.export_dir and choice != "band":
        p.error("--export-dir requires the band path (use --force band)")

    on_card = grid.device.type == "cuda"
    t0 = time.perf_counter()
    summary = dict(route=choice, pages=0, cells=0, masked=None)
    if choice == "band":
        out = router.prepare(lon, lat)
        summary.update(cells=out.cells, masked=out.masked)
        if hasattr(out, "origins"):
            k, pr, pc = out.shape
            summary["pages"] = k
            log(f"atlas: {k} pages of {pr}x{pc} ({out.cells / 1e6:.2f}M cells, masked={out.masked})")
        else:
            summary["pages"] = 1
            log(f"band: rows {out.row0}+{out.shape[0]}, cols {out.col0}+{out.shape[1]} "
                f"({out.cells / 1e6:.2f}M cells, masked={out.masked})")
    z = router.kriging(lon, lat, force=choice)
    if on_card:
        torch.cuda.synchronize(grid.device)
    wall = time.perf_counter() - t0
    z = z.cpu().numpy()
    if not np.isfinite(z).all():
        raise RuntimeError("mission serving produced non-finite depths")
    unresolved = router.last_unresolved if choice == "band" else None
    if choice == "band":
        log(f"resolved in-band: {1.0 - unresolved / len(z):.4f} (rest escalated to exact two-tier kriging)")
    log(f"served {len(z)} pings in {wall * 1e3:.0f} ms cold ({len(z) / wall / 1e6:.1f} M pts/s incl. fill)")
    if args.out:
        write_points_csv(args.out, lon, lat, z)
        log(f"wrote {args.out}")
    summary.update(unresolved=unresolved, n=len(z), depth_sum=float(z.astype(np.float64).sum()), wall_ms=wall * 1e3)
    if args.export_dir:
        summary["export"] = export_pair(args.export_dir, router, grid, len(lon), args)
    return summary


def export_pair(export_dir: str, router, grid: RegularGrid, n_queries: int, args) -> dict:
    """Write the prepared router's serving pair; returns {fill, resample}:
    (path, bytes) of each."""
    from ..serve import export_mission_fill, export_mission_resample

    os.makedirs(export_dir, exist_ok=True)
    a = router._atlas
    if a is not None:
        placed, (_, pr, pc) = a.placed, a.shape
    else:
        b = router._band
        placed, (pr, pc) = ((b.row0, b.col0),), b.shape
    extent = (grid.min_lon, grid.max_lon, grid.min_lat, grid.max_lat)
    fp = os.path.join(export_dir, "mission_fill.pt2")
    rp = os.path.join(export_dir, "mission_resample.pt2")
    # router.fill_backend is the resolved backend: the artifact reproduces
    # the live router's fill
    nf = export_mission_fill(fp, grid.shape, placed, pr, pc, extent=extent, convention=args.convention,
                             fill_backend=router.fill_backend, device=grid.device)
    rs = router._resampler  # auto_window may have shrunk wr/wc
    # masked=True is frozen into the artifact and always correct: a later
    # refresh may leave page cells undefined even where this build did not
    nr = export_mission_resample(rp, grid.shape, placed, pr, pc, n_queries, extent=extent, chunk=args.chunk,
                                 win_rows=rs.wr, win_cols=rs.wc, masked=True, lerp_mode=rs.lerp_mode,
                                 device=grid.device)
    log(f"exported serving pair: {fp} ({nf} B), {rp} ({nr} B)")
    return {"fill": (fp, nf), "resample": (rp, nr)}


if __name__ == "__main__":
    main()
