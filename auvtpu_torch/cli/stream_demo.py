"""Real-time AUV swath streaming demo (counterpart of
:mod:`auvtpu.cli.stream_demo`, one device).

A vehicle flies a lawnmower survey while sonar swaths arrive and the local
map must stay filled.  This demo drives
:class:`auvtpu_torch.streaming.StreamingInterpolator` through that loop and
reports the real-time budget:

1. synthesize a truth seabed (shelf+seamount) over the survey extent;
2. fly a lawnmower track; each step emits one across-track swath of noisy
   depth soundings (beam count, spacing and noise are flags);
3. ``ingest`` each swath (host-staged; one device copy per flush), and every
   ``fill_every`` steps pull the interpolated local map around the vehicle
   (``window_fill``);
4. at the end, score the mosaic against the truth at the observed cells and
   print ingest/fill throughput.

The sharded mosaics of the JAX demo (``--shard``, ``--shard2d``) are not in
the port yet.

Run: ``python3 -m auvtpu_torch.cli.stream_demo --steps 400``
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..config import Extent
from ..streaming import StreamingInterpolator
from ..synthetic import shelf_seamount


def log(*a):
    print(*a, flush=True)


def lawnmower_track(H, W, n_steps, line_spacing):
    """(n_steps, 2) row/col vehicle positions covering a lawnmower survey."""
    rows, cols = [], []
    n_lines = max(1, (H - 40) // line_spacing)
    steps_per_line = max(1, n_steps // max(n_lines, 1))
    r = 20
    for line in range(n_lines):
        cs = np.linspace(20, W - 20, steps_per_line)
        if line % 2:
            cs = cs[::-1]
        rows.extend([r] * steps_per_line)
        cols.extend(cs)
        r += line_spacing
        if len(rows) >= n_steps:
            break
    rows = np.asarray(rows[:n_steps], np.float64)
    cols = np.asarray(cols[:n_steps], np.float64)
    if len(rows) < n_steps:  # rounding shortfall: hold station at the end
        pad = n_steps - len(rows)
        rows = np.concatenate([rows, np.full(pad, rows[-1])])
        cols = np.concatenate([cols, np.full(pad, cols[-1])])
    return rows, cols


def survey(si, truth, *, steps, beams=256, swath_width=60.0, line_spacing=40, noise=0.5, fill_every=10, seed=42):
    """Fly the lawnmower survey over ``si``: per step, ingest one swath of
    noisy soundings of ``truth``; every ``fill_every`` steps pull the window
    around the vehicle to the host.  Returns host-clock totals and the last
    vehicle position: {t_ingest, t_fill, n_obs, n_fills, last}.  On a CUDA
    mosaic an ingest that flushed waits for the device, so ``t_ingest``
    includes the scatters of the flushes."""
    H, W = si.shape
    on_card = si.device.type == "cuda"
    rng = np.random.default_rng(seed)
    vr, vc = lawnmower_track(H, W, steps, line_spacing)
    # across-track beam offsets (perpendicular to the along-row track)
    beam_off = np.linspace(-swath_width / 2, swath_width / 2, beams)
    t_ingest = 0.0
    t_fill = 0.0
    n_fills = 0
    for s in range(steps):
        rows = np.clip(vr[s] + beam_off + rng.normal(0, 0.3, beams), 0, H - 1)
        cols = np.clip(np.full(beams, vc[s]) + rng.normal(0, 0.3, beams), 0, W - 1)
        ri = rows.astype(np.int64)
        ci = cols.astype(np.int64)
        depths = truth[ri, ci] + rng.normal(0, noise, beams)
        staged = si._staged
        t0 = time.perf_counter()
        si.ingest(ri, ci, depths.astype(np.float32))
        if on_card and si._staged != staged + beams:
            # this ingest flushed: its scatter counts to the ingest time
            torch.cuda.synchronize(si.device)
        t_ingest += time.perf_counter() - t0
        if (s + 1) % fill_every == 0:
            t0 = time.perf_counter()
            tile, _ = si.window_fill(int(vr[s]), int(vc[s]))
            tile.cpu()  # realize (the vehicle console would render it)
            t_fill += time.perf_counter() - t0
            n_fills += 1
    return dict(t_ingest=t_ingest, t_fill=t_fill, n_obs=steps * beams, n_fills=n_fills,
                last=(int(vr[-1]), int(vc[-1])))


def main(argv=None):
    """Run the demo; returns (mosaic RMSE at observed cells, truth span)."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mosaic", type=int, nargs=2, default=[1024, 1024],
                   metavar=("H", "W"), help="mosaic shape (cells)")
    p.add_argument("--steps", type=int, default=400, help="track steps (pings)")
    p.add_argument("--beams", type=int, default=256, help="soundings per swath")
    p.add_argument("--swath-width", type=float, default=60.0,
                   help="across-track swath width (cells)")
    p.add_argument("--line-spacing", type=int, default=40,
                   help="lawnmower line spacing (cells)")
    p.add_argument("--noise", type=float, default=0.5, help="sounding noise (m)")
    p.add_argument("--fill-every", type=int, default=10,
                   help="window_fill cadence (steps)")
    p.add_argument("--window", type=int, default=256, help="local map size")
    p.add_argument("--method", default="idw", choices=["idw", "mean", "kriging"])
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out-npy", default=None, help="write final mosaic (npy)")
    p.add_argument(
        "--uncertainty", action="store_true",
        help="at the end: fit the variogram from the mosaic and report the "
        "kriging prediction-variance map around the vehicle (the 'survey "
        "here next' surface)",
    )
    p.add_argument("--device", default="cuda", help="torch device of the mosaic (default: the card)")
    args = p.parse_args(argv)

    H, W = args.mosaic
    truth = shelf_seamount(H, W)
    ext = Extent(0.0, float(W - 1), 0.0, float(H - 1))
    si = StreamingInterpolator(
        (H, W), ext, window=(args.window, args.window), method=args.method,
        max_radius=5, device=args.device,
    )
    log(f"mosaic {H}x{W} on {si.device}, window backend {si.backend}")

    st = survey(
        si, truth, steps=args.steps, beams=args.beams, swath_width=args.swath_width,
        line_spacing=args.line_spacing, noise=args.noise, fill_every=args.fill_every,
        seed=args.seed,
    )
    t_ingest, t_fill, n_obs, n_fills = st["t_ingest"], st["t_fill"], st["n_obs"], st["n_fills"]

    snap = si.snapshot()
    observed = ~np.isnan(snap)
    err = snap[observed] - truth[observed]
    rmse = float(np.sqrt(np.mean(err * err)))
    span = float(truth.max() - truth.min())

    log(f"track steps          : {args.steps} ({n_obs} soundings)")
    log(f"observed cells       : {observed.sum()} ({100*observed.mean():.1f}% of mosaic)")
    log(f"ingest               : {1e3*t_ingest/args.steps:.3f} ms/swath "
        f"({n_obs/max(t_ingest,1e-9)/1e6:.2f} M obs/s incl. staged flushes)")
    if n_fills:
        log(f"window_fill ({args.window}x{args.window}) : {1e3*t_fill/n_fills:.2f} ms/refresh "
            f"({n_fills} refreshes)")
    log(f"mosaic RMSE at observed cells: {rmse:.3f} m ({100*rmse/span:.2f}% of range; "
        f"sounding noise {args.noise} m)")
    if args.uncertainty:
        vp = si.fit_variogram()
        vmap_, _ = si.window_uncertainty(*st["last"])
        vmap_ = vmap_.cpu().numpy()
        gaps = np.isfinite(vmap_) & (vmap_ > 0)
        log("fitted variogram (nugget, sill, range): " + " ".join(f"{float(v):.4g}" for v in vp))
        if gaps.any():
            sig = np.sqrt(vmap_[gaps])
            log(
                f"uncertainty around vehicle: mean sigma {sig.mean():.2f} m, "
                f"max sigma {sig.max():.2f} m over {gaps.sum()} unsurveyed cells"
            )
        if args.out_npy:
            np.save(args.out_npy + ".var.npy", vmap_)
    if args.out_npy:
        np.save(args.out_npy, snap)
        log(f"mosaic -> {args.out_npy}")
    return rmse, span


if __name__ == "__main__":
    main()
