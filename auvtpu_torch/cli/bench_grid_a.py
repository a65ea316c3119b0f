"""Grid A benchmark (rebuild of test_interpolation.cpp): scattered queries.

Workflow (test_interpolation.cpp:115-322):
1. load or generate the grid (default the 4000x3200 shelf + seamount over
   lon -180..-160, lat 20..30);
2. per batch size, draw uniform random query points (a seeded
   torch.Generator on the grid's device, in the extent +- 1e-6) and time
   bilinear / bicubic / kriging / IDW on the device;
3. cross-validate the first 10 points against the float64 golden engine
   (GoldenGrid for bilinear and bicubic, GoldenV2 for kriging and IDW) at
   5e-5 x scale, the f32 bar of the JAX CLI (exact mode: GoldenGrid for
   all three at 1e-9);
4. append reference-schema rows (GridType=A, error columns 'nan');
5. optionally (--expanded) the 2x-densified grid pass, written as grid CSVs
   (test_interpolation.cpp:283-306).

Stencil packs (one row read per query) are the default.  On a fully valid
float32 CUDA grid with window radius <= 2, ``--backend auto`` runs Kriging
through the valid16 B11 kernel (top-4 and solve) and IDW through B6, where
the JAX CLI runs its Pallas kernels; ``--backend fused`` runs Kriging
through B12 and IDW through B15 (B7's window selection, each with its
epilogue, one launch a call); elsewhere, and with ``--backend torch``, they are the torch packed
paths.  Bilinear and Cubic have no kernel.  ``--selection exact`` reproduces the reference
CPU engine digit for digit at arbitrary coordinates: the f64 ring selection
with swap tie-breaks of ``ops/exact.py`` on an f64 grid for Bilinear, Cubic
and Kriging (IDW is dropped: the reference has no scattered IDW), validated
against GoldenGrid at 1e-9 x scale.  ``--debug`` raises at the op that
makes a NaN and ``--debug-eager`` also synchronises after every op
(:mod:`auvtpu_torch.utils.debug`), for the run alone.

Run: ``python3 -m auvtpu_torch.cli.bench_grid_a --batch-sizes 1000000``
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..config import GRID_A_BATCH_SIZES, GRID_A_EXTENT, GRID_A_SHAPE, VALIDATION_POINTS
from ..golden import GoldenGrid, GoldenV2
from ..grid import RegularGrid
from ..io import ResultsWriter, read_grid_csv, write_grid_csv
from ..ops import (
    apply_chunked,
    scattered_bicubic,
    scattered_bilinear,
    scattered_idw,
    scattered_kriging,
    upsample2x_bicubic,
    upsample2x_bilinear,
)
from ..ops.exact import exact_bilinear_scattered, exact_cubic_scattered, exact_kriging_scattered
from ..ops.packs import (
    StencilPack,
    build_valid16_pack,
    packed_bicubic,
    packed_bilinear,
    packed_idw,
    packed_kriging,
    packed_kriging_valid,
)
from ..synthetic import shelf_seamount
from ..utils import debug_mode, steady_state_ms, time_once_ms, warm_e2e_ms

VALIDATION_TOL = 5e-5  # x max(1, |golden|): the f32 bar of the JAX CLI
EXACT_VALIDATION_TOL = 1e-9  # the f64 exact mode's bar


def log(*a):
    print(*a, flush=True)


def make_ops(grid: RegularGrid, elev: np.ndarray, *, packed: bool, backend: str, window_radius: int):
    """{method: fn(grid, lons, lats)} and the label of the kriging/IDW path."""
    R = window_radius
    if not packed:
        # windowed ops materialize (N, (2R+1)^2) candidates: chunk big batches
        win_chunk = max((1 << 22) // ((2 * R + 1) ** 2), 1 << 16)

        def chunked(fn, **kw):
            return lambda g, lo, la: apply_chunked(fn, g, lo, la, chunk=win_chunk, **kw)

        return {
            "Bilinear": scattered_bilinear,
            "Cubic": lambda g, lo, la: scattered_bicubic(g, lo, la, fallback="never"),
            "Kriging": chunked(scattered_kriging, max_radius=R),
            "IDW": chunked(scattered_idw, max_radius=R),
        }, "windowed torch"
    log("building stencil packs (bilinear 4x, bicubic 16x, window 32x grid bytes)")
    sp = StencilPack(grid, window_radius=min(R, 2))
    wr = sp.window_radius
    # fully observed grid: single weighted sum, no fallback pass
    av = bool(np.isfinite(np.asarray(elev)).all())
    kernels = grid.elev.is_cuda and grid.dtype == torch.float32
    if av and R <= 2 and backend in ("auto", "torch"):
        # the top-4 of a fully valid grid provably fits the 16-tap pack
        p16 = build_valid16_pack(grid)
        if backend == "auto" and kernels:
            from ..kernels.valid_select import kriging_valid_t, packed_idw_t

            krig = lambda g, lo, la: kriging_valid_t(p16, g, lo, la)
            idw = lambda g, lo, la: packed_idw_t(sp.window, g, lo, la, window_radius=wr)
            label = "valid16 B11 (Kriging) and B6 (IDW)"
        else:
            krig = lambda g, lo, la: packed_kriging_valid(p16, g, lo, la)
            idw = lambda g, lo, la: packed_idw(sp.window, g, lo, la, window_radius=wr)
            label = "valid16 torch"
    elif backend == "fused":
        from ..kernels.scattered_select import packed_idw_fused, packed_kriging_fused

        krig = lambda g, lo, la: packed_kriging_fused(sp.window, g, lo, la, window_radius=wr)
        idw = lambda g, lo, la: packed_idw_fused(sp.window, g, lo, la, window_radius=wr)
        label = "B12 (Kriging) and B15 (IDW)"
    else:
        krig = lambda g, lo, la: packed_kriging(sp.window, g, lo, la, window_radius=wr)
        idw = lambda g, lo, la: packed_idw(sp.window, g, lo, la, window_radius=wr)
        label = "packed torch"
    return {
        "Bilinear": lambda g, lo, la: packed_bilinear(sp.bilinear, g, lo, la, assume_valid=av),
        "Cubic": lambda g, lo, la: packed_bicubic(sp.bicubic, g, lo, la, assume_valid=av),
        "Kriging": krig,
        "IDW": idw,
    }, label


def random_queries(gen: torch.Generator, n: int, device, eps: float = 1e-6):
    """n uniform points in the Grid A extent shrunk by ``eps``, as float32
    (lons, lats) on ``device``."""
    ext = GRID_A_EXTENT
    u = torch.rand((2, n), generator=gen, device=device, dtype=torch.float64)
    lons = (ext.min_lon + eps) + ((ext.max_lon - eps) - (ext.min_lon + eps)) * u[0]
    lats = (ext.min_lat + eps) + ((ext.max_lat - eps) - (ext.min_lat + eps)) * u[1]
    return lons.float(), lats.float()


def main(argv=None):
    """Run the benchmark; returns {(method, batch): {steady_ms, e2e_ms,
    validated}} besides appending the results CSV.  Exits 1 if a validation
    failed."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--grid-csv", default=None, help="input grid (csv/npy); default: generate")
    p.add_argument("--num-lon", type=int, default=GRID_A_SHAPE[1])
    p.add_argument("--num-lat", type=int, default=GRID_A_SHAPE[0])
    p.add_argument("--batch-sizes", type=int, nargs="*", default=list(GRID_A_BATCH_SIZES))
    p.add_argument("--results", default="results_local/TestingResults1.csv")
    p.add_argument("--machine", default="GPU")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--expanded", action="store_true", help="run the 2x upsample pass")
    p.add_argument("--expanded-out-prefix", default="results_local/interpolated")
    p.add_argument("--validate", action="store_true", default=True)
    p.add_argument("--no-validate", dest="validate", action="store_false")
    p.add_argument("--methods", nargs="*", default=["Bilinear", "Cubic", "Kriging", "IDW"])
    p.add_argument("--packed", action="store_true", default=True,
                   help="use stencil packs (one row read per query)")
    p.add_argument("--no-packed", dest="packed", action="store_false")
    p.add_argument(
        "--backend", choices=["auto", "torch", "fused"], default="auto",
        help="kriging/IDW selection of the packed path: auto = the B11 (valid16 "
        "kriging) and B6 (IDW) kernels on a fully valid float32 CUDA grid with "
        "window radius <= 2, torch otherwise; torch = the plain packed path; "
        "fused = the B12 (kriging) and B15 (IDW) kernels, B7's window selection with the solve or the "
        "IDW quotient",
    )
    p.add_argument(
        "--window-radius", type=int, default=2,
        help="candidate window radius for kriging/IDW; 2 is exact on fully "
        "valid grids (the k<=8 nearest cells always lie within Chebyshev 2)",
    )
    p.add_argument(
        "--selection", choices=["v2", "exact"], default="v2",
        help="exact = reproduce the reference CPU engine digit for digit at "
        "arbitrary coordinates (f64 ring selection with swap tie-breaks, "
        "ops/exact.py, on an f64 grid; Bilinear, Cubic and Kriging). v2 = "
        "true-k-nearest production semantics.",
    )
    p.add_argument("--device", default="cuda", help="torch device of the grid (default: the card)")
    p.add_argument("--debug", action="store_true",
                   help="sanitizer mode: raise at the op that makes a NaN (utils.debug)")
    p.add_argument("--debug-eager", action="store_true",
                   help="NaN checking + a device synchronisation after every op")
    args = p.parse_args(argv)
    if args.debug or args.debug_eager:
        with debug_mode(nans=True, disable_jit=args.debug_eager):
            return _run(p, args)
    return _run(p, args)


def _run(p, args):
    exact = args.selection == "exact"

    if args.grid_csv:
        elev = np.load(args.grid_csv) if args.grid_csv.endswith(".npy") else read_grid_csv(args.grid_csv)
    else:
        log(f"generating {args.num_lon}x{args.num_lat} shelf+seamount grid ...")
        elev = shelf_seamount(args.num_lat, args.num_lon)
    ext = GRID_A_EXTENT
    log(f"grid dimensions: {elev.shape[1]} x {elev.shape[0]}")

    if exact:
        grid = RegularGrid.from_nan_array(elev, ext, dtype=torch.float64, device=args.device)
    else:
        grid = RegularGrid.dense(elev, ext, device=args.device)
    golden = GoldenGrid(elev, ext.min_lon, ext.max_lon, ext.min_lat, ext.max_lat)
    # kriging/IDW follow the v2 selection (true k nearest): the v2 oracle
    golden_v2 = GoldenV2(elev, ext.min_lon, ext.max_lon, ext.min_lat, ext.max_lat)
    goldens = {
        "Bilinear": golden.bilinear,
        "Cubic": golden.cubic,
        # exact mode targets the reference engine itself, v2 its
        # true-k-nearest semantics (docs/SEMANTICS.md)
        "Kriging": golden.kriging if exact else golden_v2.kriging,
        "IDW": lambda lo, la: golden_v2.idw(lo, la, k=8),
    }
    results = ResultsWriter(args.results, with_region=True, with_cold=True)
    if exact:
        R = args.window_radius if args.window_radius > 2 else 10
        ops = {
            "Bilinear": exact_bilinear_scattered,
            "Cubic": lambda g, lo, la: exact_cubic_scattered(g, lo, la, max_radius=R),
            "Kriging": lambda g, lo, la: exact_kriging_scattered(g, lo, la, max_radius=R),
        }
        dropped = [m for m in args.methods if m not in ops]
        if dropped:
            log(f"exact mode: dropping unsupported methods {dropped} "
                "(the reference engine has no scattered IDW to be exact against)")
        args.methods = [m for m in args.methods if m in ops]
        if args.backend == "fused":
            log("exact mode: ignoring --backend fused (exact selection is the f64 parity path; the kernels are "
                "f32-only)")
        label = "the exact f64 ring selection"
    else:
        ops, label = make_ops(grid, elev, packed=args.packed, backend=args.backend,
                              window_radius=args.window_radius)
    log(f"grid on {grid.device}, backend {args.backend}: kriging/IDW by {label}")
    tol = EXACT_VALIDATION_TOL if exact else VALIDATION_TOL

    gen = torch.Generator(device=grid.device).manual_seed(args.seed)
    overall_ok = True
    summary = {}
    for n in args.batch_sizes:
        lons, lats = random_queries(gen, n, grid.device)
        lons_h = lons.cpu().numpy().astype(np.float64)
        lats_h = lats.cpu().numpy().astype(np.float64)
        # enough queued calls that small batches report device time
        iters = int(np.clip(2_000_000 // max(n, 1), 5, 100))
        qlo, qla = lons, lats
        if exact:
            # the parity path takes f64 coordinates, prepared on the grid's
            # device (B16)
            qlo, qla = lons.double(), lats.double()
            iters = 2
        for method in args.methods:
            fn = ops[method]
            first_ms, _ = time_once_ms(fn, grid, qlo, qla)  # kernel build, caches; log only
            e2e_ms, out = warm_e2e_ms(fn, grid, qlo, qla)
            warm_ms = steady_state_ms(fn, grid, qlo, qla, iters=iters)
            log(
                f"[A n={n:>9}] {method:8s} end-to-end {e2e_ms:8.2f} ms   "
                f"steady {warm_ms:8.3f} ms  ({n / warm_ms * 1e3 / 1e6:8.2f} M pts/s)"
                f"  [first call {first_ms / 1e3:.2f} s]"
            )
            results.append(
                args.machine, method, "A", n, warm_ms, None, None, None, None,
                region="grid_a", cold_ms=e2e_ms,
            )
            validated = None
            if args.validate and n <= 1_000_000:
                m = min(VALIDATION_POINTS, n)
                want = goldens[method](lons_h[:m], lats_h[:m])
                got = np.asarray(out[:m].cpu() if torch.is_tensor(out) else out[:m], np.float64)
                scale = max(1.0, float(np.nanmax(np.abs(want))))
                validated = bool(np.allclose(got, want, atol=tol * scale, equal_nan=True))
                overall_ok &= validated
                log(f"          validation vs golden ({m} pts): {'PASSED' if validated else 'FAILED'}")
            summary[(method, n)] = dict(steady_ms=warm_ms, e2e_ms=e2e_ms, validated=validated)

    if args.expanded:
        for name, up in [("bilin", upsample2x_bilinear), ("cubic", upsample2x_bicubic)]:
            ms, out = time_once_ms(up, grid)
            path = f"{args.expanded_out_prefix}_gpu_{name}.csv"
            log(f"expanded 2x {name}: {tuple(out.shape)} in {ms:.1f} ms -> {path}")
            write_grid_csv(path, out.cpu().numpy())
        # kriging/IDW have no separable form: the scattered op over the
        # expanded lattice (half-integer grid coordinates,
        # test_interpolation.cpp:91-109), in chunks
        Hn, Wn = 2 * grid.num_lat - 1, 2 * grid.num_lon - 1
        lo = ext.min_lon + np.arange(Wn, dtype=np.float64) * (ext.max_lon - ext.min_lon) / (Wn - 1)
        la = ext.min_lat + np.arange(Hn, dtype=np.float64) * (ext.max_lat - ext.min_lat) / (Hn - 1)
        LO, LA = np.meshgrid(lo.astype(np.float32), la.astype(np.float32))
        LO = torch.from_numpy(LO.ravel()).to(grid.device)
        LA = torch.from_numpy(LA.ravel()).to(grid.device)
        for name in ("Kriging", "IDW"):
            t0 = time.perf_counter()
            out = apply_chunked(ops[name], grid, LO, LA, chunk=1 << 21).reshape(Hn, Wn).cpu().numpy()
            ms = (time.perf_counter() - t0) * 1e3
            path = f"{args.expanded_out_prefix}_gpu_{name.lower()}.csv"
            log(f"expanded 2x {name.lower()}: {out.shape} in {ms:.1f} ms -> {path}")
            write_grid_csv(path, out)

    if not overall_ok:
        log("VALIDATION FAILED")
        sys.exit(1)
    return summary


if __name__ == "__main__":
    main()
