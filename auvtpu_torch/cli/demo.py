"""Quickstart demo (counterpart of :mod:`auvtpu.cli.demo`, the rebuild of
main.cpp / edge_app).

- cpuExample (main.cpp:212-262): a 10x8 toy grid, a few named points,
  printed side by side golden vs device.
- runBenchmark (main.cpp:127-207): 1000x800 sinusoid grid, bilinear batches
  {1e3,1e4,1e5,1e6}, golden-vs-device agreement and speedup.

Queries are drawn on the grid's device from a ``torch.Generator`` seeded
with 0 (the JAX demo draws from ``PRNGKey(0)``, so the points differ).  As
in the JAX demo a batch passes when its first 10 points agree with the f64
golden engine within 0.05 m; the whole batch's max |got - golden| is
printed beside it.  Bilinear has no kernel: it is plain torch on the card.

Run: ``python3 -m auvtpu_torch.cli.demo`` (``--device cpu`` on the CPU)
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..config import Extent
from ..golden import GoldenGrid
from ..grid import RegularGrid
from ..ops import scattered_bilinear
from ..synthetic import sinusoid
from ..utils import steady_state_ms

VALIDATION_POINTS = 10
VALIDATION_ATOL = 0.05  # m, the JAX demo's


def toy_example(device="cuda"):
    """The 10x8 toy grid: three points, device vs golden, printed."""
    elev = np.arange(80, dtype=float).reshape(8, 10) * 3.0 - 1000.0
    ext = Extent(min_lon=-180.0, max_lon=-171.0, min_lat=20.0, max_lat=27.0)
    grid = RegularGrid.from_nan_array(elev, ext, device=device)
    golden = GoldenGrid(elev, ext.min_lon, ext.max_lon, ext.min_lat, ext.max_lat)
    lons = np.array([-175.5, -172.25, -179.9])
    lats = np.array([23.5, 21.75, 26.2])
    got = scattered_bilinear(grid, lons, lats).cpu().numpy()
    gold = golden.bilinear(lons, lats)
    print(f"toy 10x8 grid, bilinear on {grid.device}:")
    for lo, la, t, g in zip(lons, lats, got, gold):
        print(f"  ({lo:8.3f},{la:6.3f}) device={t:10.3f}  golden={g:10.3f}")
    return got, gold


def benchmark(batches=(1_000, 10_000, 100_000, 1_000_000), grid_shape=(800, 1000), device="cuda"):
    """Bilinear batches on the sinusoid grid against the golden engine.
    Returns {n: dict(host_ms, device_ms, max_err, ok)}: golden time on the
    host, steady device time, the batch's max |got - golden|, and whether
    its first 10 points agree within 0.05 m."""
    elev = sinusoid(*grid_shape)
    ext = Extent(min_lon=-180.0, max_lon=-160.0, min_lat=20.0, max_lat=30.0)
    grid = RegularGrid.dense(elev, ext, device=device)
    golden = GoldenGrid(elev, ext.min_lon, ext.max_lon, ext.min_lat, ext.max_lat)
    gen = torch.Generator(device=grid.device).manual_seed(0)
    print(f"\n{grid_shape[1]}x{grid_shape[0]} sinusoid, bilinear, golden (numpy f64, host) vs device "
          f"({grid.device}):")
    out = {}
    for n in batches:
        def draw(lo, hi):
            lo, hi = lo + 1e-6, hi - 1e-6
            return lo + (hi - lo) * torch.rand(n, generator=gen, device=grid.device, dtype=torch.float32)

        lons, lats = draw(ext.min_lon, ext.max_lon), draw(ext.min_lat, ext.max_lat)
        lons_h = lons.cpu().numpy().astype(np.float64)
        lats_h = lats.cpu().numpy().astype(np.float64)
        t0 = time.perf_counter()
        want = golden.bilinear(lons_h, lats_h)
        host_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = steady_state_ms(scattered_bilinear, grid, lons, lats, iters=5)
        got = scattered_bilinear(grid, lons, lats).cpu().numpy().astype(np.float64)
        ok = bool(np.allclose(got[:VALIDATION_POINTS], want[:VALIDATION_POINTS], atol=VALIDATION_ATOL))
        err = float(np.max(np.abs(got - want)))
        out[n] = dict(host_ms=host_ms, device_ms=dev_ms, max_err=err, ok=ok)
        print(f"  n={n:>9}: host {host_ms:9.1f} ms   device {dev_ms:8.2f} ms   speedup {host_ms / dev_ms:7.1f}x   "
              f"validation {'PASSED' if ok else 'FAILED'}   max |got - golden| over the batch {err:.3g} m")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--skip-benchmark", action="store_true")
    p.add_argument("--batches", type=int, nargs="+", default=None,
                   help="benchmark batch sizes (default: 1e3 1e4 1e5 1e6)")
    p.add_argument("--grid-shape", type=int, nargs=2, default=None,
                   metavar=("NLAT", "NLON"), help="benchmark grid shape")
    p.add_argument("--device", default="cuda", help="torch device of the grids (default: the card)")
    args = p.parse_args(argv)
    toy_example(args.device)
    if not args.skip_benchmark:
        kw = {"device": args.device}
        if args.batches:
            kw["batches"] = tuple(args.batches)
        if args.grid_shape:
            kw["grid_shape"] = tuple(args.grid_shape)
        if not all(r["ok"] for r in benchmark(**kw).values()):
            raise SystemExit(1)


if __name__ == "__main__":
    main()
