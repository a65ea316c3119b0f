"""Host cost of the kernel wrappers of a checkout of auvtpu_torch, on one
NVIDIA GPU: the time a call takes to return on the host (the checks, the
allocation, the dispatch and the launch, not the kernel's run), for B1-B8
and B11 (whether a kernel is a ``torch.library`` custom op or a ctypes
launch in that checkout); and the two small calls they decide end to end: the streaming window refresh
and the mission tick; and the flagship fit-then-fill, ``entry.fit_fill``.

Run from the root of a checkout:

    python3 scripts/op_overhead.py [--repo DIR] [--label NAME] [--only PARTS]

``--repo`` imports ``auvtpu_torch`` from DIR instead (another version
unpacked with ``git archive``, into a directory .gitignore lists), so two
versions are timed with one script on one card: run them in turns (other,
this, this, other) in one call.  The inputs are chip_smoke.py's: B1
(``fill_kriging_fused``) on the Kerguelen stand-in r0.10, B3
(``fill_idw_fused``, k=8) on r0.20, B7 (``window_select_fused``, k=4) at 1M
stand-in queries, B8 (``BandResampler.resample``) at 5M pings of the band
weave, B2 (``topk_full``, k=4) on r0.10, B4 (``topk_idx``, k=4) on r0.20;
B5 (``valid_select_t``), B6 (``packed_idw_t``), B11
(``kriging_valid_t``, ``packed_kriging_t`` with the resolved row) and B12
(``packed_kriging_fused``; B7 and the torch solve in a checkout before
B12) at 1M uniform queries on the Grid A grid, B5's ``select`` call alone
on the prologue's cells and offsets, and B6's kernel call alone (on the
queries, ``idw_select``, where B6 computes the prologue; else ``select``
on the prologue's cells and offsets).  Each call is timed alone on the host clock, with a device sync
every 8 calls so the queue never fills.  The window refresh is
``StreamingInterpolator.window_fill`` (256x256 IDW, R=5, one B3 launch) on a
mosaic of the r0.20 stand-in's observed cells, its plane copied to the host
each call; the tick is chip_smoke.py's ``tick_latency`` loop (this
checkout's loop driving the timed checkout's package: 512-ping ticks of
``BandRouter.kriging``, a refresh every 32).  ``fit_fill`` runs on the
r0.10 stand-in: CUDA events around back-to-back calls, its device-busy time
(this checkout's ``chip_smoke.device_busy_ms``) and its host time a call.
``kriging`` is Grid A kriging through B11 (``kriging_valid_t``, valid16)
on chip_smoke.py's Grid A grid at 1e3 and its 1M and 5M uniform queries: events,
device-busy time, host time a call and the CUDA kernels a call; the Grid A
CLI's steady kriging at 5M (``bench_grid_a``, no validation); and two-tier
kriging (``TwoTierInterpolator.kriging``, its auto backend) at 1M stand-in
queries on r0.10, by events.  ``scattered`` is the same for Grid A IDW
through B6 (``packed_idw_t``) and fused kriging (``packed_kriging_fused``)
at 1e3, 1M and 5M queries, the CLI's steady IDW (``--backend auto``) at
1e3 and 5M and fused kriging (``--backend fused``) at 1M, and two-tier IDW
at 1M stand-in queries.  ``--only`` takes a comma list of
``wrappers``, ``refresh``, ``tick``, ``fit_fill``, ``kriging`` and
``scattered`` (all but the last two by default), ``hostprof``: with
``wrappers``, a ``cProfile`` of B5's, B6's and B11's calls to stderr, and
``dispatch``: the op layer's own cost, each of B2, B4, B5, B6 and B11 (and
B12 where the checkout has it) through its op against its ctypes launch
called directly, in one process (:func:`dispatch_us`; a checkout whose
five kernels are ops).  Prints the quartiles (wrapper calls,
refreshes, fit_fill's host time) or p50/p99 (ticks) as one JSON line, with
the card's name and power limit.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_us(fn, reps: int = 400, sync_every: int = 8):
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
        if i % sync_every == sync_every - 1:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return [float(np.percentile(times, q)) for q in (25, 50, 75)]


def refresh_us(si, reps: int = 200):
    """Host microseconds of one window refresh with its plane on the host."""
    for _ in range(10):
        si.window_fill(1000, 1200)[0].cpu()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        si.window_fill(1000, 1200)[0].cpu()
        times.append((time.perf_counter() - t0) * 1e6)
    return [float(np.percentile(times, q)) for q in (25, 50, 75)]


def smoke_module():
    """This checkout's chip_smoke.py as a module (its functions import
    ``auvtpu_torch`` when called, so they drive the timed checkout)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kriging_ms(dev, grid) -> dict:
    """Grid A kriging through B11 at 1e3, 1M and 5M queries, the CLI's steady
    kriging at 5M and two-tier kriging at 1M stand-in queries."""
    import torch

    from auvtpu_torch.cli import bench_grid_a
    from auvtpu_torch.config import GRID_A_EXTENT, GRID_A_SHAPE, KERGUELEN_EXTENT
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.kernels import valid_select as vs
    from auvtpu_torch.ops import TwoTierInterpolator
    from auvtpu_torch.ops import packs as tp
    from auvtpu_torch.synthetic import shelf_seamount

    cs = smoke_module()
    gA = RegularGrid.dense(shelf_seamount(*GRID_A_SHAPE), GRID_A_EXTENT, device=dev)
    p16 = tp.build_valid16_pack(gA)
    out = {}
    for n, seed in ((1_000, 5), (1_000_000, 7), (5_000_000, 9)):
        q = cs.scattered_queries(GRID_A_EXTENT, *GRID_A_SHAPE, n, seed, dev)
        call = lambda: vs.kriging_valid_t(p16, gA, *q)  # noqa: E731
        out[f"kriging_valid_t {n}"] = {
            "events_ms": cs.time_ms(call, reps=50), "device_busy_ms": cs.device_busy_ms(call, reps=5),
            "host_us_q25_q50_q75": host_us(call, reps=200),
            "kernels_a_call": sum(cs.device_kernels(call, reps=10).values()) / 10}
    results = os.path.join(ROOT, "results_local", "op_overhead_grid_a.csv")
    os.makedirs(os.path.dirname(results), exist_ok=True)
    cli = bench_grid_a.main(["--results", results, "--machine", "H100", "--methods", "Kriging", "--batch-sizes",
                             "5000000", "--no-validate"])
    out["cli kriging 5000000 steady_ms"] = next(v["steady_ms"] for v in cli.values())
    tt = TwoTierInterpolator(grid)
    qK = cs.scattered_queries(KERGUELEN_EXTENT, *grid.shape, 1_000_000, 8, dev)
    out["two-tier kriging 1000000 events_ms"] = cs.time_ms(lambda: tt.kriging(*qK), reps=10)
    del gA, p16
    torch.cuda.empty_cache()
    return out


def scattered_ms(dev, grid) -> dict:
    """Grid A IDW through B6 and fused kriging at 1e3, 1M and 5M queries
    (events, device-busy time, host time a call, CUDA kernels a call), the
    CLI's steady IDW at 1e3 and 5M and fused kriging at 1M, and two-tier
    IDW at 1M stand-in queries on r0.10 (events)."""
    import torch

    from auvtpu_torch.cli import bench_grid_a
    from auvtpu_torch.config import GRID_A_EXTENT, GRID_A_SHAPE, KERGUELEN_EXTENT
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.kernels import scattered_select as ss
    from auvtpu_torch.kernels import valid_select as vs
    from auvtpu_torch.ops import TwoTierInterpolator
    from auvtpu_torch.ops import packs as tp
    from auvtpu_torch.synthetic import shelf_seamount

    cs = smoke_module()
    gA = RegularGrid.dense(shelf_seamount(*GRID_A_SHAPE), GRID_A_EXTENT, device=dev)
    win = tp.StencilPack(gA).window
    out = {}
    for n, seed in ((1_000, 5), (1_000_000, 7), (5_000_000, 9)):
        q = cs.scattered_queries(GRID_A_EXTENT, *GRID_A_SHAPE, n, seed, dev)
        for name, call in (("packed_idw_t", lambda: vs.packed_idw_t(win, gA, *q)),
                           ("packed_kriging_fused", lambda: ss.packed_kriging_fused(win, gA, *q))):
            out[f"{name} {n}"] = {
                "events_ms": cs.time_ms(call, reps=50), "device_busy_ms": cs.device_busy_ms(call, reps=5),
                "host_us_q25_q50_q75": host_us(call, reps=200),
                "kernels_a_call": sum(cs.device_kernels(call, reps=10).values()) / 10}
    results = os.path.join(ROOT, "results_local", "op_overhead_grid_a.csv")
    os.makedirs(os.path.dirname(results), exist_ok=True)
    base = ["--results", results, "--machine", "H100", "--no-validate"]
    cli = bench_grid_a.main(base + ["--methods", "IDW", "--batch-sizes", "1000", "5000000"])
    for (_, n), v in cli.items():
        out[f"cli idw {n} steady_ms"] = v["steady_ms"]
    cli = bench_grid_a.main(base + ["--methods", "Kriging", "--backend", "fused", "--batch-sizes", "1000000"])
    out["cli fused kriging 1000000 steady_ms"] = next(v["steady_ms"] for v in cli.values())
    tt = TwoTierInterpolator(grid)
    qK = cs.scattered_queries(KERGUELEN_EXTENT, *grid.shape, 1_000_000, 8, dev)
    out["two-tier idw 1000000 events_ms"] = cs.time_ms(lambda: tt.idw(*qK), reps=10)
    del gA, win
    torch.cuda.empty_cache()
    return out


def select_wrappers_us(dev, profile: bool = False) -> dict:
    """Host microseconds a call of B5, B6 and B11 on chip_smoke.py's Grid A
    grid at its 1M uniform queries: the public wrappers (B5's and B6's
    with their torch prologue) and B5's and B6's ``select`` call alone, on
    the prologue's cells and offsets."""
    import torch

    from auvtpu_torch.config import GRID_A_EXTENT, GRID_A_SHAPE
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.kernels import scattered_select as ss
    from auvtpu_torch.kernels import valid_select as vs
    from auvtpu_torch.ops import packs as tp
    from auvtpu_torch.synthetic import shelf_seamount

    cs = smoke_module()
    gA = RegularGrid.dense(shelf_seamount(*GRID_A_SHAPE), GRID_A_EXTENT, device=dev)
    p16, win = tp.build_valid16_pack(gA), tp.StencilPack(gA).window
    q = cs.scattered_queries(GRID_A_EXTENT, *GRID_A_SHAPE, 1_000_000, 7, dev)
    _, _, _, _, _, cell, fx, fy = ss.prologue(gA, *q)
    offs = tp.window_offsets(2)
    t16 = ss.table(tp.VALID16_OFFSETS, 16, 2, "dy", dev)
    t32 = ss.table(offs, 32, 2, "dy", dev)
    eps = 1e-12
    calls = {
        "B11 kriging_valid_t 1M": lambda: vs.kriging_valid_t(p16, gA, *q),
        "B11 packed_kriging_t resolve 1M": lambda: vs.packed_kriging_t(win, gA, *q, resolve_thresh=4.0),
        "B6 packed_idw_t 1M": lambda: vs.packed_idw_t(win, gA, *q),
        "B12 packed_kriging_fused 1M": lambda: ss.packed_kriging_fused(win, gA, *q),
        "B5 valid_select_t 1M": lambda: vs.valid_select_t(p16, gA, *q),
        "B5 select rows_t 1M": lambda: ss.select(p16, 16, cell, fx, fy, t16, mode="rows_t", k=4, emit_d2=True),
    }
    if hasattr(ss, "idw_select"):  # B6 on the queries, the prologue in the kernel
        calls["B6 idw_select 1M"] = lambda: ss.idw_select(win, 32, offs, 2, gA, *q, k=8)
    else:
        calls["B6 select idw 1M"] = lambda: ss.select(win, 32, cell, fx, fy, t32, mode="idw", k=8, eps=eps)
    out = {name: host_us(fn) for name, fn in calls.items()}
    if profile:
        for name, fn in calls.items():
            host_profile(name, fn)
    del gA, p16, win, q, cell, fx, fy
    torch.cuda.empty_cache()
    return out


def dispatch_us(dev, blocks: int = 40, per_block: int = 100) -> dict:
    """The custom-op layer's own host cost, in one process: each of B2, B4,
    B5, B6 and B11 called through its op and through its op's CUDA
    implementation directly (the ctypes launch the op wraps), on the same
    arguments, in alternating blocks of ``per_block`` calls (which goes
    first alternates too).  Per op: the median over the blocks of each
    route's median host microseconds a call, and the quartiles of the per-block
    difference (op minus direct).  Needs a checkout whose five kernels are
    ops.  A call is timed alone, as in :func:`host_us`."""
    import torch

    from auvtpu_torch.config import GRID_A_EXTENT, GRID_A_SHAPE, KERGUELEN_EXTENT
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.kernels import library
    from auvtpu_torch.kernels import scattered_select as ss
    from auvtpu_torch.kernels import window_fill as wf
    from auvtpu_torch.masking import mask_grid
    from auvtpu_torch.ops import packs as tp
    from auvtpu_torch.synthetic import kerguelen_standin, shelf_seamount

    cs = smoke_module()
    g = RegularGrid.from_nan_array(mask_grid(kerguelen_standin((2053, 2441)), 0.10)[0], KERGUELEN_EXTENT, device=dev)
    gA = RegularGrid.dense(shelf_seamount(*GRID_A_SHAPE), GRID_A_EXTENT, device=dev)
    p16, win = tp.build_valid16_pack(gA), tp.StencilPack(gA).window
    q = cs.scattered_queries(GRID_A_EXTENT, *GRID_A_SHAPE, 1_000_000, 7, dev)
    _, _, _, _, _, cell, fx, fy = ss.prologue(gA, *q)
    offs = tuple(tp.window_offsets(2))
    t16, t32 = ss.table(tp.VALID16_OFFSETS, 16, 2, "dy", dev), ss.table(offs, 32, 2, "dy", dev)
    idw_taps = ss._taps(t32, 32, 0.5, "dy")
    queries_in = hasattr(ss, "idw_select")  # B6 (and B12) on the queries, the prologue in the kernel
    geo = ss._krige_geo(gA, "reference")
    krige = (p16, t16, q[0], q[1], library.variogram_tensors(None, q[0]),
             ss._krige_taps(tuple(map(tuple, tp.VALID16_OFFSETS)), 16, 2)[1], ss._krige_geo(gA, "reference"))
    routes = {
        "B2 topk_full": (lambda: library.topk_full(g.elev, g.valid, 4, 10, "reference"),
                         lambda: wf.topk_full_launch(g.elev, g.valid, 4, 10, "reference")),
        "B4 topk_idx": (lambda: library.topk_idx(g.elev, g.valid, 4, 10, "reference"),
                        lambda: wf.topk_idx_launch(g.elev, g.valid, 4, 10, "reference")),
        "B5 valid_select": (lambda: library.valid_select(p16, cell, fx, fy, t16, 16, 4, True, 0.5, None),
                            lambda: ss.rows_launch(p16, 16, cell, fx, fy, t16, 4, True, 0.5, None)),
        "B6 idw_select": ((lambda: library.idw_select(win, t32, *q, idw_taps, geo, 32, gA.num_lon, gA.num_lat, 8,
                                                      None, 1e-12),
                           lambda: ss.idw_launch(win, 32, *q, idw_taps, geo, gA.num_lon, gA.num_lat, 8, None, 1e-12))
                          if queries_in else
                          (lambda: library.idw_select(win, cell, fx, fy, t32, idw_taps, 32, 8, 0.5, None, 1e-12),
                           lambda: ss.idw_launch(win, 32, cell, fx, fy, idw_taps, 8, None, 1e-12))),
        "B11 select_krige": (lambda: library.select_krige(*krige, 16, 2, gA.num_lon, gA.num_lat, "exponential",
                                                          None),
                             lambda: ss.krige_launch(krige[0], 16, *krige[2:], gA.num_lon, gA.num_lat,
                                                     "exponential", None)),
    }
    if queries_in:  # B12, in a checkout that has it
        wk = (win, ss.table(offs, 32, 2, "dx", dev), q[0], q[1], library.variogram_tensors(None, q[0]),
              ss._window_krige_taps(offs, 32, 2), geo)
        routes["B12 window_krige"] = (
            lambda: library.window_krige(*wk, 32, 2, gA.num_lon, gA.num_lat, "exponential"),
            lambda: ss.window_krige_launch(wk[0], 32, *wk[2:], gA.num_lon, gA.num_lat, "exponential"))

    def block(fn) -> float:
        # each call alone on the host clock, the syncs outside it: the
        # median host time of a call, not the card's
        times = []
        for i in range(per_block):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
            if i % 8 == 7:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        return float(np.median(times)) * 1e6

    out = {}
    for name, (op, direct) in routes.items():
        for fn in (op, direct):
            block(fn)
        ops, directs = [], []
        for b in range(blocks):
            pair = [(ops, op), (directs, direct)]
            for acc, fn in (pair if b % 2 == 0 else pair[::-1]):
                acc.append(block(fn))
        diff = np.subtract(ops, directs)
        out[name] = {"op_us": float(np.median(ops)), "direct_us": float(np.median(directs)),
                     "op_minus_direct_q25_q50_q75": [float(np.percentile(diff, v)) for v in (25, 50, 75)]}
    del g, gA, p16, win, q, cell, fx, fy
    torch.cuda.empty_cache()
    return out


def host_profile(name: str, fn, reps: int = 400) -> None:
    """Where a call's host time goes: ``cProfile`` over ``reps`` calls (a
    sync every 8, outside the profile's view only in that it is cheap),
    the 14 functions of most own time, printed to stderr."""
    import cProfile
    import io
    import pstats

    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    for i in range(reps):
        prof.enable()
        fn()
        prof.disable()
        if i % 8 == 7:
            torch.cuda.synchronize()
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(14)
    print(f"--- host profile, {name}, {reps} calls\n{buf.getvalue()}", file=sys.stderr, flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--repo", default=ROOT, help="the checkout whose auvtpu_torch is timed")
    p.add_argument("--label", default=None)
    p.add_argument("--only", default="wrappers,refresh,tick,fit_fill", help="the parts to time (also kriging, scattered, dispatch, hostprof)")
    args = p.parse_args()
    only = set(args.only.split(","))
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch

    if not torch.cuda.is_available():
        print("op_overhead: torch sees no CUDA device", file=sys.stderr)
        return 1
    from auvtpu_torch import entry
    from auvtpu_torch.cli.mission import synthetic_trajectory
    from auvtpu_torch.config import KERGUELEN_EXTENT as EXT
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.kernels import scattered_select as ss
    from auvtpu_torch.kernels import window_fill as wf
    from auvtpu_torch.masking import mask_grid
    from auvtpu_torch.ops import band as tband
    from auvtpu_torch.ops import packs as tp
    from auvtpu_torch.streaming import StreamingInterpolator
    from auvtpu_torch.synthetic import kerguelen_standin

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    elev = kerguelen_standin((2053, 2441))
    grid, grid2 = (RegularGrid.from_nan_array(mask_grid(elev, r)[0], EXT, device=dev) for r in (0.10, 0.20))
    out, res = {}, {"label": args.label or os.path.abspath(args.repo), "card": card}
    if "wrappers" in only:
        rng = np.random.default_rng(8)
        lons = torch.from_numpy(rng.uniform(EXT.min_lon, EXT.max_lon, 1_000_000).astype(np.float32)).to(dev)
        lats = torch.from_numpy(rng.uniform(EXT.min_lat, EXT.max_lat, 1_000_000).astype(np.float32)).to(dev)
        win = tp.build_pack(grid, tp.window_offsets(2), clamp=False)[0]
        tlon, tlat = (torch.from_numpy(t).to(dev) for t in synthetic_trajectory("band", grid, 5_000_000, 0))
        router = tband.BandRouter(grid)
        router.prepare(tlon, tlat)
        rs = router._resampler
        calls = {
            "B1 fill_kriging_fused r0.10": lambda: wf.fill_kriging_fused(grid),
            "B3 fill_idw_fused r0.20": lambda: wf.fill_idw_fused(grid2),
            "B7 window_select_fused 1M": lambda: ss.window_select_fused(win, grid, lons, lats, k=4),
            "B8 BandResampler.resample 5M": lambda: rs.resample(tlon, tlat),
            "B2 topk_full r0.10": lambda: wf.topk_full(grid, k=4),
            "B4 topk_idx r0.20": lambda: wf.topk_idx(grid2, k=4),
        }
        out.update({name: host_us(fn) for name, fn in calls.items()})
        del win
        out.update(select_wrappers_us(dev, profile="hostprof" in only))
    if "refresh" in only:
        si = StreamingInterpolator(grid2.shape, EXT, window=(256, 256), method="idw", max_radius=5, device=dev)
        prior = grid2.to_nan_array()
        rr, cc = np.nonzero(~np.isnan(prior))
        si.ingest(rr, cc, prior[rr, cc])
        si.flush()
        out["window refresh 256x256 idw"] = refresh_us(si)
    if "fit_fill" in only:
        cs = smoke_module()
        out["fit_fill r0.10"] = host_us(lambda: entry.fit_fill(grid), reps=100)
        res["fit_fill_ms"] = {"events": cs.time_ms(lambda: entry.fit_fill(grid)),
                              "device_busy": cs.device_busy_ms(lambda: entry.fit_fill(grid))}
    res["host_us_q25_q50_q75"] = out
    if "kriging" in only:
        res["kriging"] = kriging_ms(dev, grid)
    if "scattered" in only:
        res["scattered"] = scattered_ms(dev, grid)
    if "dispatch" in only:
        res["dispatch"] = dispatch_us(dev)
    if "tick" in only:
        tick = smoke_module().tick_latency(grid, dev)
        res["tick_ms"] = {k: tick[k] for k in ("p50", "p99", "post_p50", "refresh_p50", "n")}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
