"""Where the time of the port's fills goes on one NVIDIA GPU.

Run from the root of a checkout:  python3 scripts/torch_fill_profile.py

At chip_smoke.py's workloads (the Kerguelen stand-in, 10 % masked for the
kriging fill, 20 % for the IDW/mean fills and the slot-index selection; a
4096x4096 streaming mosaic):

- CUDA-event medians of the pieces of each fused path: the NaN-padded plane
  the B4 wrapper builds, each kernel launched alone on ready inputs
  (B1 and B3 also by their device duration in the profiler's kernel
  records, back to back and with the L2 cold), and its whole wrapper; the
  variogram fit
  split into the empirical variogram and the Gauss-Newton loop;
- the streaming window refresh (256x256 idw at R=5 on a 4096x4096 mosaic)
  piece by piece: the whole refresh with its result on the host, the B3
  kernel alone on the mosaic's window views, the readback, and the device
  kernels one refresh launches;
- a torch.profiler table of device time by kernel over a few calls of each
  backend of fill_kriging, of fit_fill, of the Grid B IDW and Kriging
  methods at r0.20 and of a streaming window refresh, with the host-clock time per
  call beside it (their ratio is the device's busy share);
- Grid A scattered kriging at 5M queries through the valid16 B11 kernel
  (``kriging_valid_t``, the CLI's --backend auto path: the query prologue,
  the top-4 and the 5x6 solve in one kernel): B11 alone, the wrapper, the
  torch prologue that B5-B7 still run (``_normalize``, the whole
  prologue), and the path before B11 (the B5 kernel alone, the torch row
  epilogue, both together); the CUDA kernels one ``kriging_valid_t`` call
  launches, against B5 with the torch epilogue and against B11's plain
  version on the card; then the profiler table and the device's idle share
  for it and for B6 IDW;
- band serving at 5M pings of the stand-in (chip_smoke.py's phase 16-17
  workloads: the band weave on one band, the diagonal on the 8-page atlas):
  the B8 kernel alone (device duration, back to back and cold, its
  coordinate prologue included), its wrapper, the resampler on lon/lat (one
  launch), the torch prologue it replaced (``coords()``: ``_xy``, shift,
  pad), the route (coherence), the escalation of the unresolved pings and
  the whole ``BandRouter.kriging`` call, then the profiler table and the
  device's idle share of that call.

Prints the card's name and power limit beside the numbers.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time  # noqa: E402

import chip_smoke as cs  # noqa: E402
from auvtpu_torch import entry  # noqa: E402
from auvtpu_torch.config import Extent  # noqa: E402
from auvtpu_torch.grid import RegularGrid  # noqa: E402
from auvtpu_torch.kernels import window_fill as wf  # noqa: E402
from auvtpu_torch.ops import fill_kriging, kriging_at_cells  # noqa: E402
from auvtpu_torch.streaming import StreamingInterpolator  # noqa: E402
from auvtpu_torch.variogram import empirical_variogram, fit_exponential  # noqa: E402


def streaming_mosaic(dev):
    """A 4096x4096 mosaic with the demo's coverage (~17 % of cells, in
    swaths of 60 rows every 40), filled by one ingest."""
    H = W = 4096
    rng = np.random.default_rng(42)
    rows = rng.integers(0, H, 3_500_000)
    rows = rows[(rows % 40) < 30]
    cols = rng.integers(0, W, rows.shape[0])
    vals = rng.normal(-2000.0, 50.0, rows.shape[0]).astype(np.float32)
    si = StreamingInterpolator((H, W), Extent(0.0, W - 1.0, 0.0, H - 1.0), window=(256, 256),
                               max_radius=5, swath_cap=1 << 16, stage_slots=64, device=dev)
    si.ingest(rows, cols, vals)
    si.flush()
    return si


def profile(label, fn, reps, card):
    """Host clock per call (unprofiled), then device time by kernel under
    torch.profiler; prints both and the device's idle share."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    # kernel rows only: an aten op row repeats its kernels' device time
    dev_total = sum(
        e.self_device_time_total for e in ka if e.device_type == torch.autograd.DeviceType.CUDA
    ) / (reps * 1e3)
    print(f"\n== {label}: device time {dev_total:.4f} ms per call (profiler, {reps} calls), "
          f"host clock {wall:.4f} ms per call (unprofiled), device idle {1 - dev_total / wall:.1%} [{card}]")
    print(ka.table(sort_by="self_device_time_total", row_limit=8, max_name_column_width=60))


def grid_a_breakdown(dev, card, n=5_000_000):
    """Grid A kriging through the valid16 B11 kernel at n queries, piece by
    piece, beside the path before it (B5 and the torch row epilogue)."""
    from auvtpu_torch.cli.bench_grid_a import random_queries
    from auvtpu_torch.config import GRID_A_EXTENT, GRID_A_SHAPE
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.kernels import scattered_select as ss
    from auvtpu_torch.kernels import valid_select as vs
    from auvtpu_torch.ops import packs as tp
    from auvtpu_torch.ops.scattered import _normalize
    from auvtpu_torch.synthetic import shelf_seamount

    g = RegularGrid.dense(shelf_seamount(*GRID_A_SHAPE), GRID_A_EXTENT, device=dev)
    p16 = tp.build_valid16_pack(g)
    win, _ = tp.build_pack(g, tp.window_offsets(2), clamp=False)
    lons, lats = random_queries(torch.Generator(device=dev).manual_seed(42), n, dev)
    x, y, oob, ci, cj, cell, fx, fy = ss.prologue(g, lons, lats)
    tab = ss.table(tp.VALID16_OFFSETS, 16, 2, "dy", dev)
    rows = ss.select(p16, 16, cell, fx, fy, tab, mode="rows_t", k=4)

    def b5_path():
        out, _, _, oob_, ci_, cj_ = vs._select_rows(p16, 16, tp.VALID16_OFFSETS, 2, g, lons, lats, emit_d2=False)
        return ss._kriging_rows_epilogue(g, lons, lats, out, oob_, ci_, cj_, 2, vparams=None, model="exponential")

    twin = lambda: ss.select_krige_ref(p16, 16, tp.VALID16_OFFSETS, 2, g, lons, lats)
    pieces = {
        "_normalize": lambda: _normalize(g, lons, lats),
        "prologue (normalize, centre, fx, fy)": lambda: ss.prologue(g, lons, lats),
        "kriging_valid_t (B11, prologue inside)": lambda: vs.kriging_valid_t(p16, g, lons, lats),
        "before B11: B5 kernel alone": lambda: ss.select(p16, 16, cell, fx, fy, tab, mode="rows_t", k=4),
        "before B11: row epilogue (torch solve)": lambda: ss._kriging_rows_epilogue(
            g, lons, lats, rows, oob, ci, cj, 2, vparams=None, model="exponential"),
        "before B11: B5 + epilogue (whole)": b5_path,
        "packed_idw_t k=8 (whole)": lambda: vs.packed_idw_t(win, g, lons, lats),
    }
    print(f"\nGrid A {GRID_A_SHAPE[1]}x{GRID_A_SHAPE[0]}, {n} queries")
    t = cs.device_ms(lambda: vs.kriging_valid_t(p16, g, lons, lats), "select_krige_kernel")
    print(f"{'B11 alone (device duration)':38s} {t:9.4f} ms  [{card}]")
    for label, fn in pieces.items():
        t = cs.time_ms(fn, reps=10)
        print(f"{label:38s} {t:9.4f} ms  ({n / t / 1e3:.1f} M pts/s)  [{card}]")
    for label, fn in (("B11", lambda: vs.kriging_valid_t(p16, g, lons, lats)), ("B5 + the torch epilogue", b5_path),
                      ("B11's plain version on the card", twin)):
        launched = sum(cs.device_kernels(fn, reps=5).values()) / 5
        print(f"one kriging_valid_t call through {label}: {launched:.1f} CUDA kernels  [{card}]")
    profile(f"Grid A kriging {n} queries (B11 valid16)", lambda: vs.kriging_valid_t(p16, g, lons, lats), 5, card)
    profile(f"Grid A IDW {n} queries (B6)", lambda: vs.packed_idw_t(win, g, lons, lats), 5, card)


def band_breakdown(grid, card, n=cs.N_BAND):
    """BandRouter.kriging at n pings of the band weave and the diagonal
    atlas, piece by piece."""
    from auvtpu_torch.kernels import band_resample as kb
    from auvtpu_torch.ops import band as tband

    tracks = cs.band_tracks(grid, n)
    print(f"\nband serving, {n} pings on the stand-in r0.10")
    for kind, (lon, lat) in tracks.items():
        r = tband.BandRouter(grid, max_bands=cs.MAX_BANDS[kind])
        r.prepare(lon, lat)
        rs = r._resampler
        args, kw = cs.b8_call(rs, lon, lat)
        z, ok = rs.resample(lon, lat)
        bad = torch.nonzero(~ok).reshape(-1)
        print(f"{kind}: window {rs.wr}x{rs.wc}, chunk {kw['chunk']}, {bad.numel()} pings escalate")
        for cold in (False, True):
            t = cs.device_ms(cs.b8_launcher(args, kw), "band_resample_", cold=cold)
            label = f"B8 kernel alone ({'cold' if cold else 'back to back'}, device)"
            print(f"{kind:8s} {label:40s} {t:9.4f} ms  [{card}]")
        pieces = {
            "B8 wrapper (one launch)": lambda: kb.band_resample(*args, **kw),
            "resample (lon/lat, one B8 launch)": lambda: rs.resample(lon, lat),
            "coords() (the torch prologue B8 took in)": lambda: rs.coords(lon, lat),
            "route (coherence, 1 readback)": lambda: r.route(lon, lat, band_ready=True),
            "kriging (whole call)": lambda: r.kriging(lon, lat),
        }
        if bad.numel():
            pieces["escalation (two-tier on the unresolved)"] = lambda: r.two_tier.kriging(lon[bad], lat[bad])
        for label, fn in pieces.items():
            t = cs.time_ms(fn, reps=10)
            print(f"{kind:8s} {label:40s} {t:9.4f} ms  [{card}]")
        profile(f"BandRouter.kriging {kind} {n} pings", lambda: r.kriging(lon, lat), 5, card)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    grid, rows, cols, truth = cs.bench_workload(dev)
    R = 10
    H, W = grid.shape
    tab = wf._device_table(R, "reference", dev)
    lib = wf._lib()
    stream = wf._stream(dev)
    b1_kernel = cs.b1_launcher(grid, R)
    b2_kernel = cs.b2_launcher(grid, 4, R)

    grid2, rows2, cols2, _ = cs.bench_workload(dev, 0.20)
    nanp2 = wf._nan_padded(grid2, R)
    idx_out = torch.empty((5, H, W), device=dev)

    def b4_kernel():
        lib.auvtpu_topk_idx(nanp2.data_ptr(), tab.data_ptr(), tab.shape[0], H, W, R, 4,
                            idx_out.data_ptr(), stream)

    for label, kind, k in (("B3 idw k=8", 0, 8), ("B3 mean k=4", 1, 4)):
        for cold in (False, True):
            t = cs.device_ms(cs.b3_launcher(grid2, kind, k), "fill_tile_kernel", cold=cold)
            print(f"{label + ' kernel alone (' + ('cold' if cold else 'back to back') + ', device)':44s} "
                  f"{t:9.4f} ms  [{card}]")
    lags, gamma, counts = empirical_variogram(grid)
    step = 0.5 * (abs(grid.lat_step) + abs(grid.lon_step))
    for cold in (False, True):
        t = cs.device_ms(b1_kernel, "kriging_fill_kernel", cold=cold)
        print(f"{'B1 kernel alone (' + ('cold' if cold else 'back to back') + ', device)':44s} {t:9.4f} ms  [{card}]")
    pieces = {
        "NaN-padded plane (B4 wrapper)": lambda: wf._nan_padded(grid, R),
        "B1 kernel alone": b1_kernel,
        "B1 wrapper (fused fill)": lambda: wf.fill_kriging_fused(grid),
        "B2 kernel alone": b2_kernel,
        "B2 wrapper": lambda: wf.topk_full(grid),
        "B3 idw k=8 wrapper": lambda: wf.fill_idw_fused(grid2, k=8),
        "B3 mean k=4 wrapper": lambda: wf.fill_mean_fused(grid2, k=4),
        "B4 k=4 kernel alone": b4_kernel,
        "B4 k=4 wrapper": lambda: wf.topk_idx(grid2, k=4),
        "empirical variogram": lambda: empirical_variogram(grid),
        "Gauss-Newton fit (25 it)": lambda: fit_exponential(lags * step, gamma, counts, iters=25),
    }
    for label, fn in pieces.items():
        print(f"{label:36s} {cs.time_ms(fn):9.4f} ms  [{card}]")

    si = streaming_mosaic(dev)
    flat2 = rows2 * W + cols2

    def refresh():
        tile, _ = si.window_fill(2048, 2048)
        return tile.cpu()

    # the window refresh, piece by piece: one B3 launch on the mosaic's views
    tile, (r0, c0) = si.window_fill(2048, 2048)
    view = RegularGrid(si.elev[r0:r0 + 256, c0:c0 + 256], si.valid[r0:r0 + 256, c0:c0 + 256], 0.0, 255.0, 0.0, 255.0)
    print(f"\nwindow refresh 256x256 idw k={si.k} R={si.max_radius}; device kernels of 20 refreshes "
          f"(kernel records kept): {cs.device_kernels(refresh)}")
    for label, t in (
        ("whole refresh, result on the host (host clock)", cs.time_ms(refresh)),
        ("B3 alone on the window views (device)", cs.device_ms(cs.b3_launcher(view, 0, si.k, si.max_radius),
                                                              "fill_tile_kernel")),
        ("window_fill without the readback (events)", cs.time_ms(lambda: si.window_fill(2048, 2048))),
        ("readback of the 256x256 tile (events)", cs.time_ms(lambda: tile.cpu())),
    ):
        print(f"{label:48s} {t:9.4f} ms  [{card}]")

    for label, fn, reps in (
        ("fused", lambda: fill_kriging(grid, backend="fused"), 3),
        ("select", lambda: fill_kriging(grid, backend="select"), 3),
        ("torch", lambda: fill_kriging(grid, backend="torch"), 3),
        ("fit_fill", lambda: entry.fit_fill(grid), 3),
        ("Grid B IDW r0.20 (B3 + gather)", lambda: wf.fill_idw_fused(grid2, k=8).reshape(-1)[flat2], 3),
        ("Grid B Kriging r0.20 (B1 + gather)", lambda: kriging_at_cells(grid2, rows2, cols2), 3),
        ("window refresh 256x256 idw, result on the host", refresh, 20),
    ):
        profile(label, fn, reps, card)
    grid_a_breakdown(dev, card)
    band_breakdown(grid, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
