#!/usr/bin/env python3
"""Chip smoke test of auvtpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of a checkout:  python3 chip_smoke.py

Drives the port's main paths on the 2053x2441 Kerguelen stand-in (10 % or
20 % of cells masked with seed 42: 501,137 or 1,002,274 cells), a 4096x4096
streaming mosaic and scattered queries on the 3200x4000 Grid A, in phases:

1. device   torch sees a CUDA card; its name and power limit; TF32 off
2. build    nvcc builds the kernels from csrc/, one nvcc a source, all
            started together (seconds, ptxas registers)
3. B2       selection kernel vs its plain torch version: exactly equal at
            the bench workload and on a 1024x2048 window view of the
            stand-in read in place (k=4 R=10, k=16 R=5); a call is one
            kernel launch and no memory copy (the profiler's device records
            of 20 calls)
4. B1       fused kriging kernel vs its plain version, bit for bit, at the
            bench workload (gj and lu), on a 256x320 grid (every model,
            both solvers, centered, variance and a sub-plane origin) and on
            a 1024x2048 window view of the stand-in read in place; lu vs gj
            within 1.5e-3 relative; a call is one kernel launch and no
            memory copy (the profiler's device records of 20 calls).  B19
            (B1 at a list of cells) bit for bit B1's plane and the plain
            version at the stand-in's masked cells (gj, lu) and at 50 and
            100 % of the cells in draw order; kriging_at_cells is one B19
            launch and no copy.  Phase 7 times B19 alone (back to back and
            cold), its wrapper and plain version, beside its byte bound and
            B1 and the gather
5. main     fill_kriging(backend="fused") and (backend="select") scored on
            the masked cells: RMSE within 5.7149 +- 2e-3 m
6. entry    entry.fit_fill: fitted parameters finite and positive, > 99 %
            of masked cells finite, RMSE within 5.7156 +- 2e-3 m.  The launch
            counts, zeroed before phase 5, must show B1 and B2 ran; zeroed
            just before fit_fill and read just after it, one B9 (pair sums),
            one B10 (the fit) and one B1 launch and nothing else.  B1
            vs plain again under the fitted parameters (bit for bit; read on
            the device: one launch, no copy).  ROADMAP C1: the package's
            fit (fit_variogram, a float64 loop with a stop) lands on the
            card within 1e-6 relative of the host's landing, its gamma at
            the bins with pairs within 3e-4 of the JAX package's landing;
            the float64 plane's RMSE under it printed, not gated.  B9 vs
            its plain twin on the stand-in read in place, as the whole grid,
            a 1024-row band with its 10 rows below and a 1024x1024 block
            inside its halo-extended block, with the 10 lag and the 40
            (sector, lag) bins: counts equal, sums within 1e-12 relative and
            equal once rounded to f32, a second call bit-equal.  B10 vs the
            plain float64 loop under the stand-in's gamma, every model, 25
            steps: landing within 1e-9 relative, per-step (kept, frozen)
            flags equal
7. timing   CUDA events, 3 warm-up calls then the median of 20, kernels and
            plain versions side by side; B1 and B2 alone by their device
            duration, back to back and cold, and B2's call by the device
            duration of all its records; B9 and B10 alone (device duration),
            their wrappers and plain twins beside the pair sums, the fit and
            fit_fill (events and device-busy)
8. B3, B4   the IDW/mean fill kernel vs its plain version at the stand-in
            r0.20 (IDW k=8, mean k=4), on the 256x320 grid (both
            conventions, R 5 and 10) and on window views of the stand-in
            (row stride 2441, 256x256 at R=5 and 1024x2048 at R=10) with
            observed cells kept: NaN placement equal, rtol=1e-5,
            atol=1e-3, observed cells exactly kept.  B4's own path, its entry point topk_idx and the
            slot gather at the r0.20 masked cells (launch counts zeroed
            around it), giving B2's values and offsets at every live slot;
            the slot-index kernel exactly equal to its plain version, and
            its indices decoded through the table equal to B2's offsets
9. grid B   auvtpu_torch.cli.bench_grid_b at r0.10 and r0.20 (Bilinear,
            Cubic, Kriging, IDW; --backend auto): RMSE within 1e-3 m (2e-3
            for Kriging) of the JAX package's, bilinear coverage within
            1e-6; launch counts zeroed before the phase show B19 (Kriging at
            the masked cells) and B3 (both kinds) ran
10. stream  the streaming demo's survey (4096x4096 mosaic, 40,000 swaths of
            256 beams, R=5, 256x256 windows) through StreamingInterpolator
            with backend "auto": snapshot count and f64 nansum exactly the
            JAX package's, window RMSEs within 1e-3 m, fused windows vs
            backend "torch" at the B3/B1 bars, the fitted variogram and the
            uncertainty window; launch counts zeroed before the phase show
            B1, B3, B9 and B10 (the streaming fit) ran
11. timing  the idw and mean window refresh is one B3 launch (launch counts,
            and the profiler's device kernels of one refresh); B3 alone
            by its device duration (profiler kernel records) back to back
            and cold (a 128 MB write before each launch), its wrapper and
            plain version, B4 vs plain at r0.20, the Grid B
            methods, streaming ingest and window refresh (fused and torch)
12. B5-B15 the scattered select kernels vs their plain version on Grid A
            (3200x4000 shelf + seamount, fully valid: valid16 and radius-2
            packs, B7 also at radius 1 and 3, k=4 and k=8) and on the
            stand-in r0.10, 1M numpy-seeded queries plus
            the tie queries, NaN, +-inf, +-1e30 and out-of-grid ones and
            the nodes and half-nodes of a 200x200-node corner, each:
            rows, codes, d2 and the resolved row exactly equal (NaN where
            plain has NaN); B6 (query prologue, IDW sums and quotient), B11
            and B12 (query prologue, top-4 and kriging solve) bit for bit
            on the same queries: B6 with and without the resolved row, B11
            valid16 and radius 2 with the resolved row, B11 and B12 for the
            four models with fitted parameters on the card; B15 (query
            prologue, B7's top-k, IDW weights and quotient) bit for bit on
            the same queries, on the stand-in at radius 1-3, an aligned pack
            and one 4 bytes off, k 1, 4, 8 and P, powers 2, 1 and 3 (Grid
            A: radius 2, k 8); the kernel paths' predictions vs the torch
            packed paths at rtol=1e-5, atol=1e-4
13. grid A  auvtpu_torch.cli.bench_grid_a on the default grid at 1e3, 1e5,
            1e6 and 5e6 queries (all four methods, --backend auto), then 1e6
            with --backend fused: every validation PASSED (5e-5 x scale);
            launch counts show B11 and B6 (and no B5) under auto, B12 and
            B15 (and no B7) under fused; valid_select_t (B5's entry point)
            and window_select_fused (B7's) at the 1M Grid A queries, launch
            counts zeroed around each;
            _normalize, lonlat_to_xy and ops.band._xy on the card equal to
            the CPU's bit for bit at the 1M phase-12 queries and the
            corner's nodes and half-nodes; 4096
            queries per method vs GoldenGrid/GoldenV2 at the same bar
14. twotier TwoTierInterpolator (auto = the B11/B6 kernels) on the stand-in
            r0.10 with 1M queries vs backend "torch" (tests/test_packs.py
            bars), the escalated fraction, B11/B6 launched and no B5; 4096
            queries plus escalating hole queries vs GoldenV2 on the stand-in
            with unit steps
15. timing  the select kernels alone (B6 and B7 also cold) and plain,
            their wrappers, B7's and B5's library call (torch.topk of the
            d2 matrix) and the torch paths at 1M Grid A queries; B6, B11
            and B12 bit for bit at 5M Grid A queries (B6 with and without
            the resolved row, B11 valid16 and radius 2 with it, B12, B15
            at radius 2, k 8, both packs and powers 2, 1 and 3; odd, node
            and half-node queries included); B15 at 5M stand-in queries
            (radius 1-3, the pack 4 bytes off, k 1, 4, 8 and P, powers 2, 1
            and 3); each packed_idw_t, packed_kriging_fused and
            packed_idw_fused call one CUDA kernel and no synchronising
            call, their events and the torch prologue, epilogue and solve
            they no longer run; packed_idw_fused's events against the old
            composition (window_select_fused, idw_from_select: old, new,
            new, old); B6, B12 and B15 alone at 1M and 5M, their wrappers
            and plain versions, B15 at k 8 and 4 beside B12's bound and
            rows-in-registers probe, B15's builds' resources (no spill at
            radius 2, whose staged build holds 2 stages and 6 blocks an SM
            or more); B11 alone at 1M and 5M (valid16 and radius 2), its
            bound, the rows-in-registers probe
            (scripts/row_gather_probe.py: the same rows loaded straight
            into registers, not a floor) and the issue estimate from its
            SASS instruction count, the resources of its
            builds on the main paths (registers, spills, resident blocks),
            its wrapper and plain version; B12's builds (radius 1-3, the
            four models: registers, spills, shared memory, resident
            blocks; no spill at radius 2) and, at 1M and 5M, its bound, its
            rows-in-registers probe (128-byte rows) and its issue estimate;
            kriging_valid_t's events and
            CUDA kernels a call at 1M and 5M beside the torch prologue it
            no longer runs (B5 and B7 still do); B1's and B11's SASS against
            their pinned fingerprints; two-tier calls, the Grid A steady
            state per method and batch
16. B8      the band/atlas resample kernel vs its plain version on the
            stand-in r0.10, on lon/lat through the kernel's coordinate
            prologue, with a ragged last chunk: 5M pings of the band weave
            on the B1-filled band and of the diagonal on the 8-page atlas
            (chunk 2048, hat_t, auto windows), a 512-ping tick, a masked
            band (a hole in vmask), the "aligned" geometry with one-hot
            weights, one-hot and hat weights at 64x160
            (tests/test_band.py:86-119), and both tracks with a NaN
            latitude, a NaN longitude or a +inf longitude ping in the
            middle and last: ok exactly equal and z bit-equal;
            the band weave also equal to the kernel on the torch prologue's
            coordinates (_xy, shift, pad); the band's resolved share > 0.9
            and its values within 5e-3 m of an f64 bilinear of the band
            plane at the same coordinates (the JAX package's on-chip bar)
17. mission auvtpu_torch.cli.mission at its defaults (512x640, 200k pings,
            --max-bands 8) for the band and diagonal missions, routed and
            forced onto the band path; BandRouter.kriging and .idw on the
            stand-in r0.10 at 5M pings (band weave, diagonal atlas), forced
            band and routed: every depth finite; the route under the JAX
            package's COST_NS, the page count and the unresolved count
            equal to the JAX package's and the f64 depth sum within 1e-3 m
            a ping of it (scripts/band_reference_pins.py); launch counts
            zeroed before the phase show B1, B3, B8 and, where queries
            escalated, B11/B6; then the real-time loop of
            tests/test_band.py:451-497 (streaming ingest, refresh, serve)
18. timing  B8 alone (launched through its library; device duration back
            to back and cold after a 128 MB write), its wrapper, its plain
            version and grid_sample (the same two ways) at 5M; one B8 launch and
            no other device kernel per BandResampler/AtlasResampler call
            (launch counts, profiler); the band and
            atlas prepare (fills); BandRouter.kriging at 5M; 512-ping tick
            latency with a refresh every 32 ticks and 8,192 observations a
            tick (scripts/mission_replay.py's loop); the calibration of the
            router's COST_NS, and the calibrated router's decisions on a
            4096-query random batch (packed) and the prepared 5M band (band)

19. exact  exact mode, f64, through B16 (the query preparation), B13
            (the two-tier dense pass with its table solve), B14 (the
            strict ring selection), B17 (the coordinate-form kriging solve)
            and B18 (the bilinear and Catmull-Rom patch), its queries on
            the card (the held-out
            cells as device tensors, as bench_grid_b passes them) and the
            host views prepare_exact_queries and _prepare_scattered made to
            raise for the phase's main path and both CLIs: on the
            stand-in r0.10 two-tier kriging (table solve), cubic and
            bilinear at the JAX package's pins (tools/jax_reference_pins.py:
            metrics within 1e-9 m, the prediction sum within 1e-9 m a cell,
            the finite count and two-tier's escalated count equal), strict
            kriging within 1e-8 m of two-tier with NaN in the same places;
            launch counts zeroed before these calls show B16, B13 and B14
            ran (one B16 launch a call, one epilogue launch a call), and
            one B13 launch a dense call (the bit plane's build and B13,
            nothing else, on the aligned path); every build's registers,
            local bytes, spills and resident blocks (B16's, B17's and
            B18's too); B17 and B18 bit-equal to their plain versions (the
            torch ops on the card) at the stand-in's cells, f64 and f32
            (B17 also on rows made singular, with found 0-3 and at NaN and
            ±inf coordinates, int32 and int64 cells, and its fallback mean
            into an output; B18's four builds, scattered at 1e5 stand-in
            queries with NaN, ±inf and out-of-grid ones) and at the 1e5
            Grid A queries with theirs; B16
            bit-equal to its plain version at the stand-in's cells (both
            anchors, every field, and keys EPS_SCALE 2**41 + 1 makes
            inexact) and at the 1e5 Grid A queries with NaN and ±inf
            added; B13 (both builds, on
            the aligned path and on the residue planes with duplicated
            cells and non-aligned queries reading another's residue) and
            B14 (cell-aligned at both anchors with anchors past the grid to
            the ends of int64, keys that overflow to inf or NaN on some
            lanes, scattered with NaN and inf coordinates, and with the
            solve) bit-equal to their plain versions on the 501,137
            stand-in cells, a 256x320 grid with 0.5 % of cells observed (no
            cell stops before ring 10), 1e5 scattered Grid A queries and
            tests/test_torch_cuda.py's edge grids (20 and 45 columns wide,
            reordered ties, a 45-entry list);
            on 256x320 shelf + seamount grids with awkward decimals at
            removal 0.1/0.5/0.9 the same, the strict selection equal to
            GoldenGrid._ring_select (found, values, ordered gi/gj) and every
            exact prediction within 1e-9 m of the golden engine; the
            caller's radius: B13 and B14 (the builds that take it at run
            time) bit-equal to plain on the stand-in's cells at radius 3 and
            16 and on the sparse grid at 3, 16 and 40, the stand-in's
            entry points at radius 16 bit for bit radius 10's (so at its
            pins) and radius 3's cells that differ counted, every entry
            point that selects at radius 3 and 16 on a 256x320 grid masked
            50 % within 1e-9 m of the CPU's; bench_grid_b --selection exact
            (tiers two and strict) at the pinned RMSEs and bench_grid_a
            --selection exact (and --window-radius 3) at 1e3 and 1e5
            queries, every golden validation passed at 1e-9; each of the seven entry
            points (four on the stand-in's cells, three at the 1e5 Grid A
            queries, all on the card) before (scripts/exact_torch_epilogue.py:
            the epilogues as torch ops) and after, in turns, on the host
            clock, by its device records (idle share), by its synchronising
            calls (sync debug mode; after: pinned to EXACT_SYNCS) and by
            the CUDA kernels a call (after: pinned to EXACT_KERNELS), the
            answers equal; strict kriging's, cubic's and scattered
            kriging's host split (the prologue, the epilogue, readbacks,
            the rest; cProfile); B17 and B18 (every build) alone, through
            their wrappers and as plain, beside bounds recounted from what
            each design must read in this run (B18's cubic at cells: the
            validity up to the first invalid cell in its order, the values
            of whole patches) and B17's FP64 issue estimate from its SASS;
            B16 (also cold), B13 and B14 alone (the bit plane's
            build included, and apart), through their wrappers (B13 also on
            the residue planes) and as plain, beside their byte bounds
20. learned the committed w16 d2 checkpoint
            (results/learned_mid_atlantic_w16d2.npz) fills the stand-in
            r0.10 at f32 and bf16 compute: held-out metrics and nansum at the
            JAX package's pins within the CPU tests' per-cell bounds; the
            window-mean baseline is one B3 (fill_tile_kernel, kMean) launch a
            fill (launch counts, profiler); learned_eval --synthetic 512 512
            --steps 20 trains on the card and its loss falls; the fills and
            one training step alone timed
21. serve   the serving artifacts (auvtpu_torch.serve, torch.export with
            the kernels as auvtpu_torch:: custom ops), each exported on the
            card and loaded fresh: the kriging fill at r0.10 (B1), IDW k=8
            at r0.20 (B3), the packed engine at 1M stand-in queries, kriging
            (B12) and IDW (B15), the learned fill with the committed w16 d2
            checkpoint (B3 mean), and the mission pair at 5M pings of the
            band weave and of the 8-page diagonal atlas (B1 a page, B8):
            each loaded call bit-equal to the live call, its kernel
            launched from the loaded program (launch counts zeroed before
            it, and the profiler's device records), the loaded and live
            calls' host and device ms; then auvtpu_torch.cli.mission
            --export-dir (the diagonal mission forced onto the band path)
            writes a pair that reloads and serves the CLI's pings as it
            served them
22. proto   the prototype (auvtpu_torch.scattered, plain torch: no TPU
            kernel) through auvtpu_torch.cli.prototype on the stand-in
            cropped to 746x1086 (810,156 cells, the US-East-Coast tile the
            reference sampled) at 1 % (8,101 samples): linear, idw, aidw and
            kriging at --k 16 and --k 50, and kriging with --aniso, each
            method's RMSE and wall time, every prediction finite; the knn of
            one 65,536-target chunk on the card held to the same function
            on the CPU (d2 within rtol 1e-5 plus 4 f32 ulps of |a|^2+|b|^2,
            indices equal wherever the 16th and 17th distances differ by
            more than 1e-5 relative plus both sides' rounding); and at the
            120x160 crop every method's
            RMSE within 0.5 % of the JAX package's
            (tools/jax_prototype_pins.py)
23. parallel the parallel layer (auvtpu_torch.parallel over torch.distributed):
            entry.dryrun_multichip(4) on the card, then four ranks spawned on
            this machine, every rank on the card over gloo (NCCL refuses two
            ranks on one card; the exchanged strips cross the host): the
            stand-in fills, kriging (B1) at r0.10 and IDW k=8 (B3) at r0.20,
            over 4 row bands and a (2, 2) mesh, bit-equal to the one-device
            fill and at the JAX package's RMSEs; sharded_fit_fill at r0.10
            within 5.7156 +- 2e-3 m, its gamma at the bin lags within 3e-4
            of one-device entry.fit_fill's, its fill bit-equal to the
            one-device fill with its parameters; the streaming demo's
            survey on the 4096x4096 mosaic over 4 bands and (2, 2) blocks,
            every 256x256 IDW window and the snapshot bit-equal to one
            device's; the 8-page diagonal atlas at r0.10 with pages dealt
            over the ranks, bit-equal to build_atlas, and AtlasResampler
            over it at 5M pings (B8) equal to over build_atlas.  Launch
            counts zeroed just before each sharded call and read just after
            it must show B1, B3, B8, B9 and B10 on every rank, and every rank's
            profiler B1, B3 and B8 records of its block fills and resample;
            per rank the block fills' device ms, the halo exchange and
            gather ms, and each path's wall against one device.  A sharded
            fill keeps each rank's band or block (to_local(): torch's chunk
            sizes); its wall is printed without the gather and with
            full_tensor(), which every comparison reads
24. quick   the quickstart, the figure CLIs' fills, the tiled ops and the
            checking modes: cli.demo's benchmark (800x1000 sinusoid,
            bilinear at 1e3-1e6 queries) against GoldenGrid, the first 10
            points and the whole batch within 0.05 m; cli.plots.reconstruct
            on the stand-in r0.10 for all four methods at phase 9's RMSEs,
            launch counts zeroed before it showing B19 and both B3 kinds;
            cli.figures.coverage_table at the seven JAX removals on the
            stand-in, launch counts showing B3 mean at each, its bilinear
            hole counts equal to the host's fill; tiled_bilinear, _bicubic,
            _kriging and _idw (plain torch: the JAX path has no Pallas
            kernel) on Grid A at 1e5 and 1e6 queries against the scattered
            ops (tests/test_tiled.py's bars) and 4096 of them against
            GoldenGrid/GoldenV2 (5e-5 x max(1, |golden|)), both timed;
            utils.debug_mode passing B1 and B3 on a covered grid (with a
            synchronisation after every op) and raising at B3's custom op on
            the NaN it makes from +inf beside -inf (a missing raise fails
            the run); B11, B6, B5, B2 and B4 through their entry points on
            the covered Grid A grid under debug_mode(disable_jit=True),
            finite, a logging dispatch mode seeing each op once; the NaN
            B11 writes at an out-of-grid query raising at
            auvtpu_torch.select_krige and the one B6 makes (w*v = +inf
            beside a -inf tap) at auvtpu_torch.idw_select; the five
            wrappers' host microseconds a call; debug_mode's cost on the
            stand-in on the host clock (kept out of every other timing);
            utils.profiling.trace writing one
            Chrome trace that holds all 20 records of 20 B1 calls

then one JSON line of the kernels and, last, the device JSON line.  Any
failure raises and the script exits non-zero; without a CUDA device it exits
non-zero before printing anything.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

SHAPE = (2053, 2441)
REMOVAL = 0.10
RMSE_FIXED = 5.7149  # f32 fill with (1, 100, 10): JAX XLA:CPU and torch agree
# Fit-then-fill: the fit ends at a nugget ~0.1 against a sill ~1e6, where the
# kriging systems are so ill-conditioned that f32 arithmetic alone moves the
# RMSE: measured 5.7144 (JAX and torch, one CPU), 5.7158 (torch, another
# CPU), 5.7163-5.7167 (fit or fill on an H100).  The gate is the middle of
# that spread with the same +-2e-3 width; a real fault (nugget 0.01) gives
# 5.894.  The weighted SSE has no finite minimum on the stand-in (a ridge
# along sill/range), so the fit runs in float64 and stops where the data
# stop pinning the walk (variogram.STOP_DGAMMA): one landing on every
# device, range ~34, 5.715821 on an H100 (5.715333 on a host's CPU).  The
# spread that remains is the f32 fill's (sill * (1 - exp(-h / range)) at
# h / range ~ 1e-4), which a float64 plane does not show (5.714745 there).
RMSE_FITTED = 5.7156
RMSE_TOL = 2e-3
# auvtpu.variogram.fit_variogram of the stand-in r0.10 on XLA:CPU, (nugget,
# sill, range): tools/jax_fit_pins.py (JAX_PLATFORMS=cpu)
JAX_FIT_PARAMS = (0.07932939380407333, 2028677.875, 55.53535079956055)
RTOL, ATOL = 1e-4, 0.05  # kernel vs plain (tests/test_pallas.py:110)
LU_RTOL = 1.5e-3  # lu vs gj (auvtpu/pallas/window_fill.py:852-854)
REPO = os.path.dirname(os.path.abspath(__file__))
B3_RTOL, B3_ATOL = 1e-5, 1e-3  # B3 vs plain (tests/test_pallas.py:44)

# Grid B on the stand-in, mask seed 42, reference convention: the JAX
# package's all_reference_metrics on XLA:CPU (Kriging r0.10 is RMSE_FIXED)
GRID_B_RMSE = {
    0.10: {"Bilinear": 6.762240688, "Cubic": 4.955056601, "IDW": 5.660344353, "Kriging": RMSE_FIXED},
    0.20: {"Bilinear": 6.897029474, "Cubic": 4.650243606, "IDW": 5.921949899, "Kriging": 5.499908106},
}
GRID_B_COVERAGE = {0.10: 0.99887855, 0.20: 0.99171684}  # Bilinear
GRID_B_TOL = {"Bilinear": 1e-3, "Cubic": 1e-3, "IDW": 1e-3, "Kriging": 2e-3}

# The streaming demo's workload, and what the JAX package gives for it
# (auvtpu.streaming on XLA:CPU): observed cells and the f64 nansum of the
# snapshot pin the mosaic bit for bit; window RMSEs are against the
# noiseless truth at centre (2048, 2048) (kriging with (1, 100, 10))
STREAM = dict(shape=(4096, 4096), steps=40_000, beams=256, swath_width=60.0,
              line_spacing=40, noise=0.5, fill_every=10, seed=42)
STREAM_OBSERVED = 2_796_131
STREAM_NANSUM = -269342243.3535929
STREAM_RMSE = {"idw": 0.276323, "mean": 0.263797, "kriging": 0.341797}
STREAM_WINDOW_FINITE = 256 * 256  # every cell of those windows
STREAM_LAST = ((3840, 3840), 52_190, 0.298887)  # window at the last position, IDW
STREAM_VAR_FINITE = 65_335
STREAM_TOL = 1e-3

# H100 SXM peaks for bounds (NVIDIA data sheet): HBM bytes/s, f32 and f64
# FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12  # outside the tensor cores
# f32 operations of B1's solve per cell: 10 gammas (~11 each), slot
# coordinates (~32), the 5x6 Gauss-Jordan (180), prediction and variance
# (~20); sqrt, exp and divide counted as one each
B1_SOLVE_OPS = 340
# B1's SASS by nvcc release, from a build on the H100: (kriging_fill_kernel
# builds, their static instructions, sass_digest of their fingerprints).
# krige_solve.cuh is B1's and B11's, and a change there must leave B1's
# instructions as they are
# (scripts/kernel_ab.py --only B1 holds its bits and SASS against another
# version of the sources).  Since B1 solves through krige_at, shared with
# B19, its 52,704 instructions come in another order (digest 3086def90a658781
# before; B1 alone 0.1902 ms against 0.1903, scripts/b19_probe.py)
B1_SASS_PIN = {"Build cuda_12.9.r12.9/compiler.36037853_0": (32, 52704, "c5c0c12d8466884e")}
# B11's (kernels, instructions, digest) under that nvcc, as the commit
# before B12 (700e4e5) built it
B11_SASS_PIN = {"Build cuda_12.9.r12.9/compiler.36037853_0": (16, 30056, "4a3b70f0c40baa0a")}
# f64 operations of B10 (exponential): ~53 a bin a step (the curve, its
# Jacobian row, the normal-equation sums, the candidate's curve, SSE and
# gamma move) and ~100 a step (six exps, the damped 3x3 LU solve, the clip,
# the warp sums); exp and divide counted as one each
B10_BIN_OPS, B10_STEP_OPS = 53, 100

# fitted-scale parameters per model for the small-grid sweep (unit steps)
MODEL_VPARAMS = {
    "exponential": (1.0, 100.0, 10.0),
    "linear": (1.0, 5.0, 10.0),
    "spherical": (0.5, 80.0, 12.0),
    "gaussian": (2.0, 150.0, 6.0),
}


# Scattered serving (phases 12-14)
SOURCES = ("window_fill", "scattered_select", "band_resample", "variogram", "exact_select",
           "exact_prologue", "exact_epilogue")  # csrc/<name>.cu, built together
N_SCATTER = 1_000_000
SCATTER_RTOL, SCATTER_ATOL = 1e-5, 1e-4  # kernel paths vs torch (tests/test_pallas.py:300)
TT_BARS = {"kriging": (1e-4, 0.1), "idw": (1e-4, 0.05)}  # two-tier vs torch (tests/test_packs.py:116-120)
# B15 (window_idw) is bit-equal to its plain version at these powers (PERF.md)
B15_POWERS = (2.0, 1.0, 3.0)
GRID_A_BATCHES = (1_000, 100_000, 1_000_000, 5_000_000)
GOLDEN_TOL = 5e-5  # x max(1, |golden|): the Grid A CLI's f32 bar
N_GOLDEN = 4096


# Band serving (phases 16-18)
N_BAND = 5_000_000
BAND_F64_TOL = 5e-3  # resample vs f64 bilinear (scripts/chip_smoke.py:172-198)
DEPTH_SUM_TOL = 1e-3  # m a ping: |sum of served depths - the JAX package's| / n
# the JAX package's routing constants (auvtpu/ops/band.py:762-777): routes
# are compared under these, the port's own COST_NS are the H100's
JAX_COST_NS = {"packed_per_query": 8.3, "dispatch": 7.3e6, "fill_per_cell": 1.0, "resample_per_query": 3.0}
# auvtpu.ops.band.BandRouter on XLA:CPU, scripts/band_reference_pins.py:
# cli/<mission> is the mission CLI's workload (512x640, 200,000 pings, seed
# 42, --max-bands 8), standin/<mission>/<method> the stand-in r0.10 with
# 5,000,000 pings (seed 0; band weave: one band, diagonal: up to 8 pages)
BAND_PINS = {
    "cli/band": dict(route="packed", pages=4, wr=56, wc=16, masked=False, unresolved=1752,
                     depth_sum=-15836418.445456505, packed_depth_sum=-15821279.09181118),
    "cli/diagonal": dict(route="packed", pages=6, wr=40, wc=16, masked=False, unresolved=0,
                         depth_sum=-19316779.50036335, packed_depth_sum=-19286330.287711143),
    "standin/band/kriging": dict(route="band", pages=1, wr=64, wc=8, masked=False, unresolved=0,
                                 depth_sum=-8549135931.344101),
    "standin/band/idw": dict(route="band", pages=1, wr=64, wc=8, masked=False, unresolved=0,
                             depth_sum=-8549157678.563873),
    "standin/diagonal/kriging": dict(route="band", pages=8, wr=64, wc=8, masked=False, unresolved=60988,
                                     depth_sum=-11021481917.877838),
    "standin/diagonal/idw": dict(route="band", pages=8, wr=64, wc=8, masked=False, unresolved=60988,
                                 depth_sum=-11021496468.685257),
}
MAX_BANDS = {"band": 1, "diagonal": 8}
# scripts/mission_replay.py's loop at one of its ingest rates
TICK, N_TICKS, WARMUP_TICKS, REFRESH_EVERY, TICK_OBS, SWATH_HALF_ROWS = 512, 256, 4, 32, 8192, 24
# band shapes of the fill-cost line (0.16M-5M cells, the JAX probe's span)
FILL_SHAPES = ((64, 2441), (256, 2441), (1024, 2441), (2053, 2441))


# Exact mode and the learned baseline (phases 19-20) on the stand-in r0.10:
# the JAX package's figures on XLA:CPU (tools/jax_reference_pins.py, x64 on):
# the reference metrics over the 501,137 masked cells, the f64 sum and count
# of the finite predictions, and two-tier kriging's escalated count
EXACT_PINS = {
    "kriging_two": {"MAE": 4.095604296279312, "RMSE": 5.2336484537525445, "MaxError": 30.02827475803133,
        "sum": -1241793802.2739522, "finite": 501137, "escalated": 19403},
    "cubic": {"MAE": 5.31303865010965, "RMSE": 7.2755194190706085, "MaxError": 50.75, "sum": -1241780924.25,
        "finite": 501137},
    "bilinear": {"MAE": 5.308272322072939, "RMSE": 6.768888992329159, "MaxError": 41.0,
        "sum": -1240518870.6666667, "finite": 500579},
}
EXACT_TOL = 1e-9  # m: a metric, and the sum's difference a cell (f64 on both sides)
EXACT_STRICT_TOL = 1e-8  # m a cell: strict vs two-tier kriging (lattice-gamma tables)
# synchronising calls one call of each exact entry point makes on queries
# already on the card (torch.cuda.set_sync_debug_mode: B16's counts, an
# escalated or fallback count, the result), measured on an H100
EXACT_SYNCS = {"kriging_two": 3, "kriging_strict": 2, "cubic": 2, "bilinear": 2, "kriging scattered": 1,
               "cubic scattered": 2, "bilinear scattered": 1}
# CUDA kernels one call of each launches there (torch.profiler's kernel
# records; copies and sets aside), measured on an H100
EXACT_KERNELS = {"kriging_two": 26, "kriging_strict": 7, "cubic": 7, "bilinear": 5, "kriging scattered": 6,
                 "cubic scattered": 7, "bilinear scattered": 5}
# results/learned_mid_atlantic_w16d2.npz filling the stand-in r0.10, f32 and
# bf16 compute: the reference metrics over the masked cells, the plane's nansum
LEARNED_PINS = {
    "f32": {"MAE": 18.47689959879379, "RMSE": 22.885500988445738, "MaxError": 127.44131469726562,
        "nansum": -12415156500.020905},
    "bf16": {"MAE": 18.701150502184547, "RMSE": 23.22829263895688, "MaxError": 127.37408447265625,
        "nansum": -12415116372.744522},
}
# per-cell bounds of tests/test_torch_learned.py: f32 1e-5 x max |elev|, bf16
# 0.01 x the observed cells' std (a few bf16 ulps of the normalised residual)
LEARNED_F32_REL = 1e-5
LEARNED_BF16_STD = 0.01

# The prototype (phase 22): auvtpu.scattered.sample_and_reconstruct on the
# stand-in's top-left 120x160 cells at 1 %, k=16, XLA:CPU
# (tools/jax_prototype_pins.py); the port's RMSE is held within PROTO_RTOL
# (grid-aligned samples tie, and the frameworks break ties by the last ulp)
PROTO_PINS = {
    "linear": {"RMSE": 34.498778202301814, "MAE": 25.358173884125268},
    "idw": {"RMSE": 28.871620047382248, "MAE": 20.722320261226358},
    "aidw": {"RMSE": 25.286222696246224, "MAE": 18.486532603048715},
    "kriging": {"RMSE": 25.744661026059198, "MAE": 17.467218020146944},
    "kriging aniso": {"RMSE": 21.76223355230942, "MAE": 14.990175805910669},
}
PROTO_RTOL = 5e-3
PROTO_CROP = ("746", "1086")  # 810,156 cells: the US-East-Coast tile's size


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def close_planes(got, want, what: str, rtol: float = RTOL, atol: float = ATOL) -> float:
    """Assert equal NaN placement and |got-want| <= atol + rtol |want|;
    return the largest difference."""
    import torch

    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    if not torch.equal(nan_g, nan_w):
        raise AssertionError(f"{what}: NaN placement differs at {int((nan_g != nan_w).sum())} cells")
    ok = ~nan_w
    d = (got[ok] - want[ok]).abs()
    bad = int((d > atol + rtol * want[ok].abs()).sum())
    worst = float(d.max()) if d.numel() else 0.0
    if bad:
        raise AssertionError(f"{what}: {bad} cells outside rtol={rtol}, atol={atol} (max |diff| {worst})")
    return worst


def within_rel(got, want, rtol: float, what: str) -> float:
    import torch

    ok = ~torch.isnan(want)
    if not torch.equal(torch.isnan(got), ~ok):
        raise AssertionError(f"{what}: NaN placement differs")
    rel = ((got[ok] - want[ok]).abs() / want[ok].abs().clamp(min=1e-30)).max()
    if float(rel) > rtol:
        raise AssertionError(f"{what}: largest relative difference {float(rel)} > {rtol}")
    return float(rel)


def same_planes(got, want, what: str) -> float:
    """Assert bit-equal values and equal NaN placement (NaN payloads aside);
    return the largest difference, 0."""
    import torch

    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError(f"{what}: NaN placement differs at {int((torch.isnan(got) != nan).sum())} entries")
    a, b = got[~nan].contiguous(), want[~nan].contiguous()
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError(f"{what}: {int((a != b).sum())} entries differ from plain (max |diff| "
                             f"{float((a - b).abs().max())})")
    return 0.0


def selection_equal(got, want, what: str) -> None:
    import torch

    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"{what}: counts differ at {int((got[0] != want[0]).sum())} cells")
    for part, name in ((1, "values"), (2, "dx"), (3, "dy")):
        for s, (a, b) in enumerate(zip(got[part], want[part])):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: slot {s} {name} differ at {int((a != b).sum())} cells")


def rmse(plane, rows, cols, truth) -> tuple[float, int]:
    """RMSE over the masked cells as bench.py scores it: cells the fill left
    NaN count as zero error, the sum is divided by every masked cell."""
    import torch

    pred = plane[rows, cols].double()
    ok = torch.isfinite(pred)
    d = torch.where(ok, truth - pred, torch.zeros_like(pred))
    return float(torch.sqrt((d * d).sum() / truth.numel())), int(ok.sum())


def time_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    """Median device time of one call, by CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, match: str | tuple | None, reps: int = 30, cold: bool = False, attempts: int = 3) -> float:
    """Device duration (ms) of one call of ``fn`` from torch.profiler's
    kernel records (CUPTI), with no host time in it, back to back (the
    inputs warm in the L2) or ``cold`` (a 128 MB write before each call):
    the median duration of the kernels whose name holds ``match``, one a
    call (a tuple of names: the sum of each one's), or, with no ``match``, the sum over the call's kernels (cold,
    torch's fills aside) of each one's median times its launches a call.
    The tracer may drop records: those its clock skew puts before the
    session opened, the first of a session and now and then all of them
    (``utils.profiling.WINDOW_MARGIN_S``); a median of the ones it keeps is
    not biased by that, and a session that keeps fewer than 5 is profiled
    again, up to ``attempts`` times."""
    import torch

    scratch = torch.empty(128 << 18, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                if cold:
                    scratch.fill_(1.0)
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.lower().startswith(("memcpy", "memset"))]
        # cold, the scratch writes are torch's fill: a call's own fills are
        # not told apart from them and are left out
        matches = (match,) if isinstance(match, str) else match
        names = {e.name for e in kernels if not (cold and "FillFunctor" in e.name)} if match is None else {
            e.name for e in kernels if any(m in e.name for m in matches)}
        durs = {name: [e.time_range.elapsed_us() for e in kernels if e.name == name] for name in names}
        if match is not None and any(len(d) > reps for d in durs.values()):
            raise RuntimeError(f"{match!r}: more kernel records than calls: { {k: len(d) for k, d in durs.items()} }")
        if names and all(len(d) >= 5 for d in durs.values()):
            # a kernel a call launches j times leaves more than (j - 1) * reps
            # records where the tracer keeps most
            return sum(float(np.median(d)) * -(-len(d) // reps) for d in durs.values()) / 1e3
    seen = sorted({e.name[:80] for e in kernels})
    raise RuntimeError(f"{match!r}: kernel records { {k: len(d) for k, d in durs.items()} } of {reps} calls in "
                       f"each of {attempts} sessions; the last kept {seen}")


def exact_pin(key: str, pred: np.ndarray, truth: np.ndarray, escalated: int | None = None) -> None:
    """Hold an exact-mode prediction at the stand-in's masked cells to the
    JAX package's pins: metrics within EXACT_TOL, the f64 sum within
    EXACT_TOL a cell, the finite count and the escalated count equal."""
    from auvtpu_torch.metrics import all_reference_metrics

    want = EXACT_PINS[key]
    m = all_reference_metrics(truth, pred)
    bad = [k for k in ("MAE", "RMSE", "MaxError") if not abs(float(m[k]) - want[k]) <= EXACT_TOL]
    if not abs(float(np.nansum(pred)) - want["sum"]) <= EXACT_TOL * len(pred):
        bad.append("sum")
    if int(np.isfinite(pred).sum()) != want["finite"]:
        bad.append("finite")
    if escalated is not None and escalated != want["escalated"]:
        bad.append("escalated")
    if bad:
        raise AssertionError(f"exact {key}: {bad} differ from the JAX package's pins: got {dict(m)}, sum "
                             f"{float(np.nansum(pred))}, finite {int(np.isfinite(pred).sum())}, escalated "
                             f"{escalated}; want {want}")


def exact_equal(got, want, what: str) -> float:
    """B13's or B14's outputs against their plain version's: integer and
    boolean outputs equal, float ones bit-equal with NaN in the same places;
    returns the largest difference, 0."""
    import torch

    got, want = (t if isinstance(t, tuple) else (t,) for t in (got, want))
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what}: output {i} is {a.dtype} {tuple(a.shape)}, plain {b.dtype} {tuple(b.shape)}")
        if a.is_floating_point():
            same_planes(a, b, f"{what} output {i}")
        elif not torch.equal(a, b):
            raise AssertionError(f"{what}: output {i} differs from plain at {int((a != b).sum())} entries")
    return 0.0


def exact_walk(grid, ci, cj, sel_gi=None, sel_gj=None, found=None, chunk: int = 16384) -> dict:
    """What the exact ring walk of anchors (ci, cj) reads, from the plain
    version's candidate tables (no kernel launch): lanes walked (to the
    first segment end holding 4, else all 441), the distinct cells whose
    validity those lanes read, and, given a selection, the distinct cells
    its filled slots read."""
    import torch

    from auvtpu_torch.ops import exact as texact
    from auvtpu_torch.ops import exact_fast as tfast

    H, W = grid.shape
    tb = texact._device_tables(10, grid.device)
    m = len(texact.exact_tables(10)["dx"])
    seg_end = torch.as_tensor(tfast._collection_tables(10)["seg_end"][:m] > 0.5, device=grid.device)
    lane = torch.arange(m, device=grid.device)
    touched = torch.zeros(H * W, dtype=torch.bool, device=grid.device)
    lanes = 0
    for s0 in range(0, ci.shape[0], chunk):
        gi, gj, _, _, cum = texact._candidates(grid, tb, ci[s0:s0 + chunk], cj[s0:s0 + chunk])
        stop = seg_end[None, :] & (cum >= 4)
        n_walk = torch.where(stop.any(dim=1), stop.int().argmax(dim=1) + 1, m)
        lanes += int(n_walk.sum())
        read = (lane[None, :] < n_walk[:, None]) & (gi >= 0) & (gi < W) & (gj >= 0) & (gj < H)
        touched[(gj * W + gi)[read]] = True
    out = {"queries": int(ci.shape[0]), "lanes": lanes, "valid_cells": int(touched.sum())}
    if sel_gi is not None:
        filled = torch.arange(4, device=grid.device)[None, :] < found.clamp(max=4)[:, None]
        sel = torch.zeros(H * W, dtype=torch.bool, device=grid.device)
        sel[(sel_gj.long() * W + sel_gi.long())[filled]] = True
        out["value_cells"], out["solved"] = int(sel.sum()), int((found >= 4).sum())
    return out


class host_views_refused:
    """While the block runs, exact mode's host views of its query
    preparation (ops.exact.prepare_exact_queries, _prepare_scattered)
    raise: no entry point may call them when its grid is on the card."""

    def __init__(self, texact):
        self.texact = texact

    def __enter__(self):
        def refuse(*args, **kwargs):
            raise AssertionError("an exact entry point called a host view of the query preparation")

        self.saved = self.texact.prepare_exact_queries, self.texact._prepare_scattered
        self.texact.prepare_exact_queries = self.texact._prepare_scattered = refuse
        return self

    def __exit__(self, *exc):
        self.texact.prepare_exact_queries, self.texact._prepare_scattered = self.saved
        return False


def sync_calls(fn) -> int:
    """The synchronising CUDA calls one call of ``fn`` makes, as
    torch.cuda.set_sync_debug_mode("warn") reports them (a readback, a
    blocking upload from pageable memory, torch.nonzero; the mode's own
    once-a-process notice is not a call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("called a synchronizing CUDA operation" in str(m.message) for m in seen)


# the epilogues' top-level functions: the package's (B17, B18) and those of
# scripts/exact_torch_epilogue.py (the torch ops they replace)
EPILOGUE_FNS = ("krige", "patch", "krige_mean_into", "_krige_epilogue", "_cubic_cells_epilogue",
                "_bilinear_cells_epilogue", "_cubic_scattered_epilogue", "_mean_epilogue",
                "_bilinear_scattered_epilogue")


def host_split_ms(fn, reps: int = 3) -> dict:
    """Host time of one exact-mode call split by cProfile: in the query
    preparation (ops.exact.query_tensors and scattered_tensors, B16's
    wrapper and the queries' upload), in the epilogue (``EPILOGUE_FNS``),
    in the readbacks (Tensor.cpu, .tolist, .item, which wait for the
    device), and the rest (the selections' dispatch, host glue); the
    medians of ``reps`` calls, each ending in a sync."""
    import cProfile
    import pstats

    import torch

    fn()
    torch.cuda.synchronize()
    parts = {"total": [], "prepare": [], "epilogue": [], "readbacks": []}
    for _ in range(reps):
        prof = cProfile.Profile()
        t0_ = time.perf_counter()
        prof.enable()
        fn()
        torch.cuda.synchronize()
        prof.disable()
        parts["total"].append((time.perf_counter() - t0_) * 1e3)
        stats = pstats.Stats(prof).stats
        cum = lambda pred: sum(v[3] for k, v in stats.items() if pred(k)) * 1e3
        parts["prepare"].append(cum(lambda k: k[2] in ("query_tensors", "scattered_tensors", "prepare_exact_queries",
                                                       "_prepare_scattered")))
        parts["epilogue"].append(cum(lambda k: k[2] in EPILOGUE_FNS))
        parts["readbacks"].append(cum(lambda k: k[2].startswith(("<method 'cpu' of", "<method 'tolist' of",
                                                                 "<method 'item' of"))))
    out = {k: float(np.median(v)) for k, v in parts.items()}
    out["dispatch"] = out["total"] - out["prepare"] - out["epilogue"] - out["readbacks"]
    return out


def device_busy_ms(fn, reps: int = 2, attempts: int = 3) -> float:
    """Device time (ms) of one call of ``fn`` that launches many kernels:
    the sum of the durations of all its device records (kernels, memory
    copies and sets) in torch.profiler's trace of ``reps`` calls, divided by
    ``reps``.  The window opens as ``utils.profiling.trace``'s does, so the
    tracer's loss of a session's first records falls on
    ``WARMUP_KERNELS`` spin kernels (left out of the sum) and not on the
    calls': then a synchronisation and ``WINDOW_MARGIN_S`` of idle card
    before the calls, and as much after them.  The tracer now and then
    keeps no record of a session: such a session is profiled again, up to
    ``attempts`` times."""
    import torch

    from auvtpu_torch.utils.profiling import WARMUP_KERNELS, WINDOW_MARGIN_S

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(WARMUP_KERNELS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(WINDOW_MARGIN_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(WINDOW_MARGIN_S)
        durs = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name]
        if durs:
            return sum(durs) / reps / 1e3
    raise RuntimeError(f"the profiler kept no device record of {reps} calls in {attempts} sessions")


def host_ms(fn, warmup: int = 1, reps: int = 5) -> float:
    """Median host clock of one call ending in a device sync."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0_ = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0_) * 1e3)
    return float(np.median(times))


def device_kernels(fn, reps: int = 20, attempts: int = 3, copies: bool = False) -> dict:
    """{name: records} of the device kernels that ``reps`` calls of ``fn``
    launch, from torch.profiler's kernel records (memory copies and sets are
    not kernels; ``copies`` counts their records too).  The tracer may drop
    the first records of a session, and now and then all of them
    (``utils.profiling.WINDOW_MARGIN_S``): the calls are many, and a session
    that keeps no kernel record is profiled again, up to ``attempts`` times;
    raises where none keeps one."""
    import collections

    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = collections.Counter(e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                                    and (copies or not e.name.lower().startswith(("memcpy", "memset"))))
        if any(not n.lower().startswith(("memcpy", "memset")) for n in names):
            return dict(names)
    raise RuntimeError(f"the profiler kept no kernel record of {reps} calls in {attempts} sessions")


def kernels_a_call(fn, reps: int = 20) -> int:
    """The device kernels one call of ``fn`` launches: over the kernels'
    names, the records of ``reps`` calls a name, rounded up to whole calls
    (the tracer may drop a session's first records), summed."""
    return sum(-(-n // reps) for n in device_kernels(fn, reps).values())


def only_kernel(fn, match: str, what: str, reps: int = 20, copies: bool = False) -> dict:
    """Check that ``fn`` runs one device kernel, the one whose name holds
    ``match``, at most once a call: every kernel record of ``reps`` calls
    is that kernel's (with ``copies``, and no memory copy or set runs on the
    device either).  Returns {name: records kept}."""
    names = device_kernels(fn, reps, copies=copies)
    if any(match not in name for name in names) or sum(names.values()) > reps:
        raise AssertionError(f"{what}: device kernels of {reps} calls {names}, want {match} alone, once a call")
    return names


def b8_launcher(args, kw, lib=None):
    """A closure launching B8 on these inputs straight through its library
    (``lib``, or the checkout's), outputs allocated once: the kernel alone,
    without the wrapper's checks and allocations, for timing it back to back
    or cold."""
    import torch

    from auvtpu_torch.kernels import band_resample as kb

    planes, vm, org, u, v = args
    K, R, C = planes.shape
    n = u.numel()
    geo = kb.geometry(R, C, kw["wr"], kw["wc"], kw["aligned"])
    z = torch.empty(n, dtype=torch.float32, device=u.device)
    ok = torch.empty(n, dtype=torch.bool, device=u.device)
    lib, stream = lib or kb._lib(), kb._stream(u.device)

    def launch():
        err = lib.auvtpu_band_resample(
            planes.data_ptr(), vm.data_ptr() if vm is not None else None,
            org.data_ptr() if org is not None else None, K, R, C, u.data_ptr(), v.data_ptr(), n, kw["chunk"],
            *geo, int(vm is not None), int(kw["pick"]), int(kw["hat"]), kb.WSUM_THRESH, *kw["affine"],
            z.data_ptr(), ok.data_ptr(), stream)
        if err:
            raise RuntimeError(f"B8 launch failed ({err})")

    return launch


def b3_launcher(grid, kind: int, k: int, R: int = 10, lib=None):
    """A closure launching B3 on ``grid`` straight through its library
    (``lib``, or the checkout's), output allocated once (the kernel
    alone)."""
    import torch

    from auvtpu_torch.kernels import window_fill as wf

    H, W = grid.shape
    dev = grid.device
    tab, wtab = wf._device_table(R, "reference", dev), wf._device_weights(R, 2.0, "reference", dev)
    out = torch.empty((H, W), dtype=torch.float32, device=dev)
    lib, stream = lib or wf._lib(), wf._stream(dev)

    def launch():
        err = lib.auvtpu_fill(grid.elev.data_ptr(), grid.elev.stride(0), grid.valid.data_ptr(), grid.valid.stride(0),
                              tab.data_ptr(), wtab.data_ptr(), tab.shape[0], H, W, R, kind, k, 1e-12, 0,
                              out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"B3 launch failed ({err})")

    return launch


def b1_launcher(grid, R: int = 10, lib=None, vparams=None):
    """A closure launching B1 (exponential, gj, no variance) on ``grid``
    straight through its library (``lib``, or the checkout's), output
    allocated once (the kernel alone)."""
    import torch

    from auvtpu_torch.kernels import window_fill as wf

    H, W = grid.shape
    dev = grid.device
    tab = wf._device_table(R, "reference", dev)
    geo, vario, ptrs, keep = wf._kriging_params(grid, vparams, "reference", 0, 0, None, dev)
    out = torch.empty((H, W), dtype=torch.float32, device=dev)
    lib, stream = lib or wf._lib(), wf._stream(dev)

    def launch():
        err = lib.auvtpu_kriging_fill(grid.elev.data_ptr(), grid.elev.stride(0), grid.valid.data_ptr(),
                                      grid.valid.stride(0), tab.data_ptr(), tab.shape[0], H, W, R, geo, vario,
                                      *ptrs, 0, 0, 0, out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"B1 launch failed ({err})")

    launch.keep = keep
    return launch


def b19_launcher(grid, rows, cols, R: int = 10, lib=None):
    """A closure launching B19 (exponential, gj) at ``rows``, ``cols`` of
    ``grid`` straight through its library (``lib``, or the checkout's),
    output allocated once (the kernel alone)."""
    import torch

    from auvtpu_torch.kernels import window_fill as wf

    H, W = grid.shape
    dev = grid.device
    tab = wf._device_table(R, "reference", dev)
    geo, vario, ptrs, keep = wf._kriging_params(grid, None, "reference", 0, 0, None, dev)
    out = torch.empty(rows.shape, dtype=torch.float32, device=dev)
    lib, stream = lib or wf._lib(), wf._stream(dev)

    def launch():
        err = lib.auvtpu_kriging_cells(grid.elev.data_ptr(), grid.elev.stride(0), grid.valid.data_ptr(),
                                       grid.valid.stride(0), tab.data_ptr(), tab.shape[0], H, W, R, geo, vario,
                                       *ptrs, 0, 0, rows.data_ptr(), cols.data_ptr(), rows.numel(),
                                       out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"B19 launch failed ({err})")

    launch.keep, launch.out = keep, out
    return launch


def b2_launcher(grid, k: int = 4, R: int = 10, lib=None):
    """A closure launching B2 on ``grid`` straight through its library
    (``lib``, or the checkout's), output allocated once (the kernel
    alone)."""
    import torch

    from auvtpu_torch.kernels import window_fill as wf

    H, W = grid.shape
    dev = grid.device
    tab = wf._device_table(R, "reference", dev)
    out = torch.empty((1 + 3 * k, H, W), dtype=torch.float32, device=dev)
    lib, stream = lib or wf._lib(), wf._stream(dev)

    def launch():
        err = lib.auvtpu_topk_full(grid.elev.data_ptr(), grid.elev.stride(0), grid.valid.data_ptr(),
                                   grid.valid.stride(0), tab.data_ptr(), tab.shape[0], H, W, R, k, out.data_ptr(),
                                   stream)
        if err:
            raise RuntimeError(f"B2 launch failed ({err})")

    return launch


def b9_launcher(elev, valid, n_rows: int, n_cols: int, col0: int, dys, dxs, bins, n_out: int, R: int = 10,
                lib=None):
    """(A closure launching B9 on the base block ``elev[:n_rows, col0:col0 +
    n_cols]`` (``pair_sums_ref``'s layout) with the offset table (dys, dxs,
    bins) straight through its library (``lib``, or the checkout's), its
    (2, n_out) float64 output): table, scratch and output made once (the
    kernel alone: its tile and finish kernels)."""
    import torch

    from auvtpu_torch.kernels import variogram as kv

    dev = elev.device
    table = torch.from_numpy(kv.grouped_table(dys, dxs, bins, n_out)).to(dev)
    partials = torch.empty((-(-n_rows // kv.TILE) * -(-n_cols // kv.TILE), n_out, 2), dtype=torch.float64,
                           device=dev)
    out = torch.full((2, n_out), float("nan"), dtype=torch.float64, device=dev)
    lib, stream = lib or kv._lib(), kv._stream(dev)

    def launch():
        err = lib.auvtpu_pair_sums(elev.data_ptr(), elev.stride(0), valid.data_ptr(), valid.stride(0),
                                   int(elev.dtype == torch.float64), *elev.shape, n_rows, n_cols, col0, R,
                                   table.data_ptr(), len(dys), n_out, partials.data_ptr(), out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"B9 launch failed ({err})")

    return launch, out


def b10_launcher(lags, gamma, counts, model: int = 0, iters: int = 25, lib=None):
    """(A closure launching B10 (``model`` 0..3: exponential, linear,
    spherical, gaussian; the data-driven start, the package's stop) on
    (lags, gamma, counts) of one dtype straight through its library
    (``lib``, or the checkout's), its (3,) parameters in gamma's dtype, its
    (iters, 2) flags): outputs made once (the kernel alone)."""
    import torch

    from auvtpu_torch.kernels import variogram as kv
    from auvtpu_torch.variogram import STOP_DGAMMA

    dev = gamma.device
    f64 = int(gamma.dtype == torch.float64)
    out = torch.full((3,), float("nan"), dtype=gamma.dtype, device=dev)
    flags = torch.full((iters, 2), -1, dtype=torch.int8, device=dev)
    lib, stream = lib or kv._lib(), kv._stream(dev)

    def launch():
        err = lib.auvtpu_fit_model(lags.data_ptr(), f64, gamma.data_ptr(), f64, counts.data_ptr(), f64,
                                   gamma.numel(), None, model, iters, STOP_DGAMMA, out.data_ptr(), f64,
                                   flags.data_ptr(), stream)
        if err:
            raise RuntimeError(f"B10 launch failed ({err})")

    return launch, out, flags


def b7_launcher(pack, P: int, cell, fx, fy, tab, k: int, half: float = 0.5, lib=None):
    """A closure launching B7 straight through its library (``lib``, or the
    checkout's) on these inputs, output allocated once (the kernel alone)."""
    import ctypes

    import torch

    from auvtpu_torch.kernels import scattered_select as ss

    n = cell.numel()
    cell32 = cell.to(torch.int32).contiguous()
    fxy = torch.stack([fx, fy]).contiguous()
    M, taps = ss._window_taps(tab, P, half)
    out = torch.empty((n, 1 + 3 * k), dtype=torch.float32, device=pack.device)
    lib, stream = lib or ss._lib(), ss._stream(pack.device)
    tp_ = taps.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def launch():
        err = lib.auvtpu_window_select(pack.data_ptr(), P, M, cell32.data_ptr(), fxy.data_ptr(), tp_, n, k,
                                       out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"B7 launch failed ({err})")

    launch.keep = (taps, cell32, fxy)
    return launch


def b6_launcher(pack, P: int, tab, grid, lons, lats, k: int, half: float = 0.5, lib=None):
    """A closure launching B6 straight through its library (``lib``, or the
    checkout's) on these queries, output allocated once (the kernel alone,
    the query prologue and the epilogue inside)."""
    import ctypes

    import torch

    from auvtpu_torch.config import IDWConfig
    from auvtpu_torch.kernels import scattered_select as ss

    n = lons.numel()
    M, taps = ss._idw_taps(tab, P, half)
    geo = ss._krige_geo(grid, "reference" if half else "centered").f32
    out = torch.empty((1, n), dtype=torch.float32, device=pack.device)
    lib, stream = lib or ss._lib(), ss._stream(pack.device)
    tp_ = taps.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def launch():
        err = lib.auvtpu_idw_select(pack.data_ptr(), P, M, lons.data_ptr(), lats.data_ptr(), tp_, n, grid.num_lon,
                                    grid.num_lat, geo.data_ptr(), k, 0, 0.0, IDWConfig(k=k).eps, out.data_ptr(),
                                    stream)
        if err:
            raise RuntimeError(f"B6 launch failed ({err})")

    launch.keep = (taps, geo)
    return launch


def odd_queries(ext, H: int, W: int, device):
    """Queries at NaN, +-inf and +-1e30 coordinates on either axis, and just
    outside the grid, on this extent: float32 tensors."""
    import torch

    nan, inf = float("nan"), float("inf")
    lon_in = ext.min_lon + 0.4 * (ext.max_lon - ext.min_lon)
    lat_in = ext.min_lat + 0.6 * (ext.max_lat - ext.min_lat)
    lo_out, la_out = ext.min_lon - 3 * (ext.max_lon - ext.min_lon) / (W - 1), ext.max_lat + 2 * (
        ext.max_lat - ext.min_lat) / (H - 1)
    lons = [nan, lon_in, nan, inf, -inf, lon_in, lon_in, 1e30, -1e30, lon_in, lo_out, lon_in]
    lats = [lat_in, nan, nan, lat_in, lat_in, inf, -inf, lat_in, lat_in, -1e30, lat_in, la_out]
    return (torch.tensor(lons, dtype=torch.float32, device=device),
            torch.tensor(lats, dtype=torch.float32, device=device))


def bound(nbytes: float, ops: float, ops64: float = 0.0) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of the bytes over
    the HBM rate and the operations over their peak (f32 operations over
    the f32 peak, f64 ones over the f64 peak, the two pipes side by
    side)."""
    t_b, t_o = nbytes / HBM_BPS * 1e3, max(ops / F32_FLOPS, ops64 / F64_FLOPS) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def scan_counts(grid, k: int, R: int = 10) -> tuple[float, float]:
    """(table rows scanned, cells taken) summed over the grid for a
    first-k-valid scan: a cell full at slot k stops after the row of its
    last slot, any other cell reads the whole table.  Taken from the plain
    slot-index selection, so it launches no kernel."""
    import torch

    from auvtpu_torch.kernels import window_fill as wf
    from auvtpu_torch.tables import sorted_offsets

    cnt, idx = wf.topk_idx_ref(grid, k=k, max_radius=R)
    m = len(sorted_offsets(R)[0])
    scanned = torch.where(cnt >= k, idx[k - 1] + 1.0, float(m))
    return float(scanned.double().sum()), float(cnt.double().sum())


def bench_workload(device, removal: float = REMOVAL):
    from auvtpu_torch.config import KERGUELEN_EXTENT
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.masking import mask_grid
    from auvtpu_torch.synthetic import kerguelen_standin

    import torch

    reduced, rc, truth = mask_grid(kerguelen_standin(SHAPE), removal)
    grid = RegularGrid.from_nan_array(reduced, KERGUELEN_EXTENT, device=device)
    rows = torch.as_tensor(rc[:, 0], device=device)
    cols = torch.as_tensor(rc[:, 1], device=device)
    return grid, rows, cols, torch.as_tensor(truth, dtype=torch.float64, device=device)


def small_grid(device):
    from auvtpu_torch.config import Extent
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.masking import mask_grid
    from auvtpu_torch.synthetic import shelf_seamount

    elev, _, _ = mask_grid(shelf_seamount(256, 320), 0.2, seed=5)
    return RegularGrid.from_nan_array(elev, Extent(0.0, 319.0, 0.0, 255.0), device=device)


def scattered_queries(ext, H: int, W: int, n: int, seed: int, device):
    """n numpy-seeded uniform points in the extent, then the adversarial
    queries of tests/test_pallas.py:295-301 placed on this grid: exact cell
    centres, half-integer tie lines, corners and edges.  float32 tensors."""
    import torch

    rng = np.random.default_rng(seed)
    xs = np.array([3.0, 4.5, 10.0, W - 2.5, 0.0, 0.5, W - 1.0])
    ys = np.array([5.0, 6.5, H - 5.5, 2.0, 0.0, 1.5, H - 1.0])
    lons = np.concatenate([rng.uniform(ext.min_lon, ext.max_lon, n),
                           ext.min_lon + xs * (ext.max_lon - ext.min_lon) / (W - 1)])
    lats = np.concatenate([rng.uniform(ext.min_lat, ext.max_lat, n),
                           ext.min_lat + ys * (ext.max_lat - ext.min_lat) / (H - 1)])
    return (torch.from_numpy(lons.astype(np.float32)).to(device),
            torch.from_numpy(lats.astype(np.float32)).to(device))


def line_queries(ext, H: int, W: int, device, half_lines: int = 400):
    """The nodes and half-nodes of the grid's first ``half_lines`` half-node
    rows and columns (a corner of half_lines/2 x half_lines/2 nodes), on
    this extent: min + (i / 2) * step in float64, as float32 tensors.  Where
    the steps are not 1 these are the queries on which a division by the
    step and a multiply by its reciprocal part (ROADMAP C3)."""
    import torch

    lon_step, lat_step = (ext.max_lon - ext.min_lon) / (W - 1), (ext.max_lat - ext.min_lat) / (H - 1)
    cols = np.arange(min(2 * W - 1, half_lines)) / 2.0
    rows = np.arange(min(2 * H - 1, half_lines)) / 2.0
    lons = (ext.min_lon + cols[None, :] * lon_step + 0 * rows[:, None]).ravel()
    lats = (ext.min_lat + rows[:, None] * lat_step + 0 * cols[None, :]).ravel()
    return (torch.from_numpy(lons.astype(np.float32)).to(device),
            torch.from_numpy(lats.astype(np.float32)).to(device))


def load_script(name: str, folder: str = "scripts"):
    """<folder>/<name>.py of this checkout as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def select_cases(g, p16=None):
    """(kernel, pack, P, offsets, radius, mode, table layout, options) of the
    (cell, fx, fy) select kernels at the main paths' settings: B5 as valid16
    kriging (d2 rows too) and as the two-tier window kriging (resolved
    row), B7 at k=4 and k=8 at window radius 1, 2 and 3.  Returns the
    radius-2 pack too."""
    from auvtpu_torch.ops import packs as tp

    packs = {r: (tp.window_offsets(r), *tp.build_pack(g, tp.window_offsets(r), clamp=False)) for r in (1, 2, 3)}
    offs, win, P = packs[2]
    cases = [
        ("select_rows", win, P, offs, 2, "rows_t", "dy", dict(k=4, resolve_thresh=4.0)),
    ] + [("window_select_fused", packs[r][1], packs[r][2], packs[r][0], r, "rows_n", "dx", dict(k=k))
         for r in (2, 1, 3) for k in (4, 8)]
    if p16 is not None:
        cases.insert(0, ("select_rows", p16, 16, tp.VALID16_OFFSETS, 2, "rows_t", "dy", dict(k=4, emit_d2=True)))
    return win, cases


def b15_cases(full: bool) -> list:
    """(radius, aligned, k, power) of B15's checks: with ``full`` every
    radius (1-3), an aligned pack and one 4 bytes off, k 1, 4, 8 and P
    ("P"), every power of B15_POWERS; else radius 2, both packs, k 8."""
    if not full:
        return [(2, aligned, 8, power) for aligned in (True, False) for power in B15_POWERS]
    return [(r, aligned, k, power) for r in (1, 2, 3) for aligned in (True, False) for k in (1, 4, 8, "P")
            for power in B15_POWERS]


def b15_equal(g, packs_r: dict, lons, lats, cases: list, label: str) -> float:
    """B15 held bit for bit to window_idw_ref on these queries for each
    (radius, aligned, k, power) case; ``packs_r`` maps a radius to its
    (pack, P, offsets), the pack 4 bytes off is a copy.  Returns 0."""
    import torch

    from auvtpu_torch.kernels import scattered_select as ss

    err, shifted = 0.0, {}
    for r, aligned, k, power in cases:
        pk, P, offs = packs_r[r]
        if not aligned:
            shifted.setdefault(r, torch.cat([pk.new_zeros(1), pk])[1:])
            pk = shifted[r]
        kk = P if k == "P" else k
        a = ss.window_idw(pk, P, offs, r, g, lons, lats, k=kk, power=power)
        b = ss.window_idw_ref(pk, P, offs, r, g, lons, lats, k=kk, power=power)
        torch.cuda.synchronize()
        what = f"window_idw radius {r} {'aligned' if aligned else '4 bytes off'} k={kk} power {power:g} at {label}"
        err = max(err, same_planes(a, b, what))
        del a, b
    return err


def golden_check(got, want, what: str) -> float:
    """Assert the Grid A CLI's validation bar (atol GOLDEN_TOL x max(1,
    |golden|), NaN placement equal); return the largest difference."""
    got = got.detach().cpu().numpy().astype(np.float64)
    scale = max(1.0, float(np.nanmax(np.abs(want))))
    if not np.allclose(got, want, atol=GOLDEN_TOL * scale, equal_nan=True):
        raise AssertionError(f"{what}: differs from the golden engine beyond {GOLDEN_TOL} x {scale:.6g} "
                             f"(max |diff| {np.nanmax(np.abs(got - want))})")
    return float(np.nanmax(np.abs(got - want)))


def band_tracks(grid, n: int, seed: int = 0):
    """The band weave and the diagonal mission (mission.synthetic_trajectory)
    as float32 tensors on the grid's device."""
    import torch

    from auvtpu_torch.cli.mission import synthetic_trajectory

    out = {}
    for kind in ("band", "diagonal"):
        lon, lat = synthetic_trajectory(kind, grid, n, seed)
        out[kind] = (torch.from_numpy(lon).to(grid.device), torch.from_numpy(lat).to(grid.device))
    return out


def b8_call(rs, lons, lats, *, aligned: bool = False):
    """(args, kwargs) of the B8 wrapper for resampler ``rs`` on these
    queries: what its resample() passes, lon/lat with the coordinate
    prologue (``aligned``: the Pallas geometry with one-hot weights, as
    backend "aligned" takes it)."""
    from auvtpu_torch.ops import band as tband
    from auvtpu_torch.ops.scattered import queries

    lons, lats = queries(rs.grid, lons, lats)
    if isinstance(rs, tband.BandResampler):
        b = rs.band
        planes, vm, org, pick, masked = b.plane[None], b.vmask[None], None, False, b.masked
        affine = tband._affine(rs.grid, b.col0, b.row0)
    else:
        a = rs.atlas
        planes, vm, org, pick, masked = a.planes, a.vmasks, a.origins, a.planes.shape[0] > 1, a.masked
        affine = tband._affine(rs.grid)
    aligned = aligned and not masked
    kw = dict(chunk=tband._effective_chunk(lons.shape[0], rs.chunk), wr=rs.wr, wc=rs.wc, pick=pick,
              aligned=aligned, hat=not aligned and rs.lerp_mode != "onehot", affine=affine)
    return (planes, vm if masked else None, org, lons, lats), kw


def b8_equal(args, kw, what: str):
    """B8 vs its plain version on the same inputs: ok exactly equal, z
    bit-equal at resolved queries and NaN elsewhere.  Returns (z, ok, max
    |kernel - plain|)."""
    import torch

    from auvtpu_torch.kernels import band_resample as kb

    z, ok = kb.band_resample(*args, **kw)
    zp, okp = kb.band_resample_ref(*args, **kw)
    if z.is_cuda:
        torch.cuda.synchronize()
    if not torch.equal(ok, okp):
        raise AssertionError(f"B8 {what}: ok differs from plain at {int((ok != okp).sum())} queries")
    if not torch.equal(torch.isnan(z), ~ok):
        raise AssertionError(f"B8 {what}: NaN placement differs from ~ok")
    err = float((z[ok] - zp[ok]).abs().max()) if bool(ok.any()) else 0.0
    if not torch.equal(z[ok], zp[ok]):
        raise AssertionError(f"B8 {what}: z differs from plain (max |diff| {err})")
    return z, ok, err


def f64_bilinear_err(plane, x, y, z, ok) -> float:
    """Largest |z - f64 bilinear of ``plane``| over the resolved queries, the
    f64 bilinear taken at the same (float32) band-frame coordinates."""
    import torch

    x64, y64 = x[ok].double(), y[ok].double()
    p = plane.double()
    x0, y0 = torch.floor(x64), torch.floor(y64)
    wx, wy = x64 - x0, y64 - y0
    xi, yi = x0.long(), y0.long()
    want = ((1 - wy) * ((1 - wx) * p[yi, xi] + wx * p[yi, xi + 1])
            + wy * ((1 - wx) * p[yi + 1, xi] + wx * p[yi + 1, xi + 1]))
    return float((z[ok].double() - want).abs().max())


def check_pin(key: str, got: dict, n: int) -> None:
    """Hold a band-path result {pages, wr, wc, masked, unresolved, depth_sum}
    (those present) to the JAX package's pin."""
    pin = BAND_PINS[key]
    for k in ("pages", "wr", "wc", "masked", "unresolved"):
        if k in got and got[k] != pin[k]:
            raise AssertionError(f"{key}: {k} {got[k]} differs from the JAX package's {pin[k]}")
    want = pin["packed_depth_sum"] if got.get("route") == "packed" else pin["depth_sum"]
    if not abs(got["depth_sum"] - want) <= DEPTH_SUM_TOL * n:
        raise AssertionError(f"{key}: depth sum {got['depth_sum']!r} outside {want!r} +- {DEPTH_SUM_TOL} x {n}")


def mission_cli_runs(dev, say_=say):
    """Phase 17a: the mission CLI at its defaults, routed and forced onto
    the band path, for both missions.  Returns {(mission, force): summary}."""
    from auvtpu_torch.cli import mission
    from auvtpu_torch.config import Extent
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.masking import mask_grid
    from auvtpu_torch.ops.band import BandRouter
    from auvtpu_torch.synthetic import shelf_seamount

    H, W = 512, 640
    g = RegularGrid.from_nan_array(np.asarray(mask_grid(shelf_seamount(H, W), 0.10, 42)[0], np.float32),
                                   Extent(0.0, W - 1.0, 0.0, H - 1.0), device=dev)
    out = {}
    for kind in ("band", "diagonal"):
        key = f"cli/{kind}"
        lon, lat = mission.synthetic_trajectory(kind, g, 200_000, 42)
        j_route = BandRouter(g, max_bands=8, cost_ns=JAX_COST_NS).route(lon, lat)
        if j_route != BAND_PINS[key]["route"]:
            raise AssertionError(f"{key}: route under the JAX costs {j_route}, the JAX package's {BAND_PINS[key]['route']}")
        for force in (None, "band"):
            argv = ["--synthetic", kind, "--device", str(dev)] + (["--force", force] if force else [])
            summ = mission.main(argv)
            check_pin(key, summ, summ["n"])
            out[(kind, force)] = summ
            say_("mission", f"CLI {kind} {'forced band' if force else 'routed'}: route {summ['route']} (JAX costs: "
                 f"{j_route}), {summ['pages']} pages, unresolved {summ['unresolved']}, depth sum "
                 f"{summ['depth_sum']!r} (JAX {BAND_PINS[key]['packed_depth_sum' if summ['route'] == 'packed' else 'depth_sum']!r}), "
                 f"{summ['wall_ms']:.1f} ms cold")
    return out


def standin_serving_runs(grid, tracks, say_=say):
    """Phase 17b: BandRouter.kriging and .idw at 5M pings on the stand-in,
    forced band and routed (each from a fresh router, which prepares its
    band or atlas itself).  Returns {(key, force): summary}."""
    import torch

    from auvtpu_torch.ops.band import BandRouter

    out = {}
    for kind, (lon, lat) in tracks.items():
        mb = MAX_BANDS[kind]
        for method in ("kriging", "idw"):
            key = f"standin/{kind}/{method}"
            j_route = BandRouter(grid, max_bands=mb, cost_ns=JAX_COST_NS).route(lon, lat)
            for force in ("band", None):
                r = BandRouter(grid, max_bands=mb)
                route = force or r.route(lon, lat)
                if route != BAND_PINS[key]["route"] or j_route != route:
                    raise AssertionError(f"{key}: route {route} (JAX costs {j_route}), the JAX package's "
                                         f"{BAND_PINS[key]['route']}")
                z = getattr(r, method)(lon, lat, force=force)
                if not bool(torch.isfinite(z).all()):
                    raise AssertionError(f"{key}: non-finite depths")
                held = r._atlas if r._atlas is not None else r._band
                summ = dict(route=route, pages=held.shape[0] if r._atlas is not None else 1, wr=r._resampler.wr,
                            wc=r._resampler.wc, masked=held.masked, unresolved=r.last_unresolved,
                            depth_sum=float(z.double().sum()))
                check_pin(key, summ, z.numel())
                out[(key, force)] = summ
                say_("mission", f"{key} {'forced band' if force else 'routed'}: route {route}, {summ['pages']} pages, "
                     f"window {summ['wr']}x{summ['wc']}, unresolved {summ['unresolved']}, depth sum "
                     f"{summ['depth_sum']!r} (JAX {BAND_PINS[key]['depth_sum']!r})")
    return out


def tick_latency(grid, dev) -> dict:
    """scripts/mission_replay.py's real-time loop at TICK_OBS observations a
    tick: a streaming mosaic seeded with the grid's observed cells; per
    TICK-ping tick, ingest and flush a swath around the vehicle, refresh the
    router from the mosaic every REFRESH_EVERY ticks, and serve the tick's
    pings through BandRouter.kriging until their sum is on the host.
    Host-clock ms per tick."""
    import torch

    from auvtpu_torch.cli.mission import synthetic_trajectory
    from auvtpu_torch.config import KERGUELEN_EXTENT
    from auvtpu_torch.ops.band import BandRouter
    from auvtpu_torch.streaming import StreamingInterpolator

    H, W = grid.shape
    prior = grid.to_nan_array()
    si = StreamingInterpolator((H, W), KERGUELEN_EXTENT, swath_cap=65536, stage_slots=16, method="kriging",
                               device=dev)
    rs_, cs_ = np.nonzero(~np.isnan(prior))
    si.ingest(rs_, cs_, prior[rs_, cs_])
    si.flush()
    n = N_TICKS * TICK
    lon, lat = synthetic_trajectory("band", si.grid(), n, 0)
    x = (lon.astype(np.float64) - KERGUELEN_EXTENT.min_lon) / grid.lon_step
    y = (lat.astype(np.float64) - KERGUELEN_EXTENT.min_lat) / grid.lat_step
    router = BandRouter(si.grid())
    router.prepare(lon, lat)
    rng = np.random.default_rng(1)
    serve, post, refresh = [], [], []
    for tick in range(-WARMUP_TICKS, N_TICKS):
        i = max(tick, 0)
        s, e = i * TICK, (i + 1) * TICK
        vy = int(np.clip(y[s], SWATH_HALF_ROWS, H - 1 - SWATH_HALF_ROWS))
        orow = rng.integers(vy - SWATH_HALF_ROWS, vy + SWATH_HALF_ROWS, TICK_OBS)
        ocol = rng.integers(max(int(x[s]) - 64, 0), min(int(x[e - 1]) + 64, W - 1), TICK_OBS)
        si.ingest(orow, ocol, -3000.0 + 0.1 * orow.astype(np.float64))
        si.flush()
        refreshed = tick > 0 and tick % REFRESH_EVERY == 0
        if refreshed:
            t0 = time.perf_counter()
            router.refresh(grid=si.grid())
            refresh.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        chk = float(router.kriging(lon[s:e], lat[s:e]).sum())  # the tick ends with its depths on the host
        dt = (time.perf_counter() - t0) * 1e3
        if not np.isfinite(chk):
            raise AssertionError(f"tick {tick}: non-finite depths")
        if tick >= 0:
            (post if refreshed else serve).append(dt)
    torch.cuda.synchronize()
    return dict(p50=float(np.percentile(serve, 50)), p99=float(np.percentile(serve, 99)), max=float(np.max(serve)),
                n=len(serve), post_p50=float(np.median(post)), post_max=float(np.max(post)),
                refresh_p50=float(np.median(refresh)))


P23_RANKS = 4
P23_STEPS = 10_000  # a quarter of the streaming demo's survey (STREAM), on each layout


def phase23_rank(card: str) -> dict:
    """One rank of phase 23 (every rank on the card over gloo): the sharded
    fills, fit+fill, streaming mosaics and atlas, each against the port's
    one-device call on the same card (on the mesh's first rank), launch
    counts zeroed just before each sharded call and read just after it,
    the block fills' device records, and the exchange, gather and wall
    times.  Returns host data; raises on any failed check."""
    import torch

    from auvtpu_torch import entry
    from auvtpu_torch.config import Extent
    from auvtpu_torch.kernels import band_resample as kb
    from auvtpu_torch.kernels import variogram as kv
    from auvtpu_torch.kernels import window_fill as wf
    from auvtpu_torch.metrics import all_reference_metrics
    from auvtpu_torch.ops import band as tband
    from auvtpu_torch.ops import fill_idw, fill_kriging
    from auvtpu_torch.parallel import (ShardedStreamingInterpolator, ShardedStreamingInterpolator2D,
                                       build_atlas_sharded, make_mesh, make_mesh2d, sharded_fill, sharded_fill2d,
                                       sharded_fit_fill, spatial)
    from auvtpu_torch.parallel.mesh import rank_device
    from auvtpu_torch.streaming import StreamingInterpolator
    from auvtpu_torch.synthetic import shelf_seamount
    from auvtpu_torch.variogram import _bin_table, variogram_model

    dev = rank_device("cuda")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wf.build()
    kb.build()
    kv.build()
    mesh, mesh2 = make_mesh(device=dev), make_mesh2d((2, 2), device=dev)
    first = mesh.index == 0
    counters = {"fill_kriging_fused": wf.LAUNCHES, "fill_idw_fused": wf.LAUNCHES, "band_resample": kb.LAUNCHES,
                "pair_sums": kv.LAUNCHES, "fit_model": kv.LAUNCHES}
    launches = dict.fromkeys(counters, 0)

    def counted(fn):
        """``fn()`` with the launch counts zeroed just before it and read
        just after it, added to this rank's main-path counts."""
        for mod in (wf, kb, kv):
            mod.reset_launches()
        got = fn()
        torch.cuda.synchronize()
        for k, counts in counters.items():
            launches[k] += counts[k]
        return got

    out = {"rank": mesh.index, "device": f"{dev} ({torch.cuda.get_device_name(dev)})", "transport": mesh.transport,
           "lines": [], "ms": {}, "kernels": {}}
    ms = out["ms"]

    # ---- the stand-in fills: kriging (B1) at r0.10, IDW k=8 (B3) at r0.20
    grids = {0.10: bench_workload(dev), 0.20: bench_workload(dev, 0.20)}
    kernel_name = {"kriging": "kriging_fill_kernel", "idw": "fill_tile_kernel"}
    for removal, method in ((0.10, "kriging"), (0.20, "idw")):
        g, rows, cols, truth = grids[removal]
        one_fn = (lambda g=g: fill_kriging(g)) if method == "kriging" else (lambda g=g: fill_idw(g, k=8))
        one = one_fn() if first else None
        for layout, m, fn in (("4 ranks", mesh, sharded_fill), ("(2, 2)", mesh2, sharded_fill2d)):
            label = f"{method} r{removal:.2f} {layout}"
            call = (lambda m=m, fn=fn, g=g, method=method: fn(m, g, method, k=8))
            sharded = counted(call)
            blk_r, blk_c = -(-g.shape[0] // m.shape[0]), -(-g.shape[1] // (m.shape[1] if len(m.shape) == 2 else 1))
            if sharded.shape != g.shape or sharded.to_local().shape[0] > blk_r or sharded.to_local().shape[1] > blk_c:
                raise AssertionError(f"sharded {label}: rank {m.index} holds {tuple(sharded.to_local().shape)} of "
                                     f"{tuple(sharded.shape)}, more than its {blk_r}x{blk_c} part")
            plane = sharded.full_tensor()
            ms[f"{label} wall"] = host_ms(call, reps=5)
            ms[f"{label} wall with full_tensor"] = host_ms(lambda: call().full_tensor(), reps=5)
            if first:
                same_planes(plane, one, f"sharded {label} vs one device")
                pred = plane[rows, cols].double().cpu().numpy()
                got = all_reference_metrics(truth.cpu().numpy(), pred)["RMSE"]
                want = GRID_B_RMSE[removal]["Kriging" if method == "kriging" else "IDW"]
                tol = GRID_B_TOL["Kriging" if method == "kriging" else "IDW"]
                if not abs(got - want) <= tol:
                    raise AssertionError(f"sharded {label}: RMSE {got} outside {want} +- {tol}")
                ms[f"{label} one device wall"] = host_ms(one_fn, reps=3)
                out["lines"].append(f"{label}: rank 0 holds {tuple(sharded.to_local().shape)} of "
                                    f"{tuple(sharded.shape)}; full_tensor() bit-equal to the one-device fill, RMSE "
                                    f"{got:.6f} m (JAX {want:.6f} +- {tol}); wall {ms[label + ' wall']:.3f} ms "
                                    f"without the gather, {ms[label + ' wall with full_tensor']:.3f} ms with "
                                    f"full_tensor(), against one device {ms[label + ' one device wall']:.3f} ms")
            del plane, sharded
        # the pieces of one sharded call, on this rank: its halo exchange,
        # its block fill (device records), its gather
        R, H, W = 10, *g.shape
        n, i = mesh.size, mesh.index
        blk = -(-H // n)
        e = spatial._block(g.elev, i * blk, blk, 0, W, dev)
        v = spatial._block(g.valid, i * blk, blk, 0, W, dev)
        ms[f"{method} halo exchange"] = host_ms(lambda: spatial._halo_extend(e, v, R, mesh, "dp"), reps=5)
        be, bv = spatial._halo_extend(e, v, R, mesh, "dp")
        gb = spatial._like(g, be, bv)
        block = (lambda: spatial._fill_block(gb, method, k=8, power=2.0, R=R, row0=i * blk - R,
                                              steps=(g.lat_step, g.lon_step), backend="fused"))
        seen = device_kernels(block)
        if not any(kernel_name[method] in k for k in seen):
            raise AssertionError(f"rank {i}: the {method} block fill launched {seen}, not {kernel_name[method]}")
        out["kernels"][method] = sum(v for k, v in seen.items() if kernel_name[method] in k)
        ms[f"{method} block fill device"] = device_ms(block, kernel_name[method], reps=20)
        band = block()[R:R + blk]
        ms[f"{method} gather"] = host_ms(lambda: spatial._gather_blocks(mesh, band, H, W), reps=5)
        del e, v, be, bv, gb, band, one

    # ---- the distributed fit+fill at r0.10
    g, rows, cols, truth = grids[0.10]
    sharded, vp = counted(lambda: sharded_fit_fill(mesh, g))
    plane = sharded.full_tensor()
    ms["fit_fill wall"] = host_ms(lambda: sharded_fit_fill(mesh, g), reps=3)
    ms["fit_fill wall with full_tensor"] = host_ms(lambda: sharded_fit_fill(mesh, g)[0].full_tensor(), reps=3)
    del sharded
    if first:
        r_fit, _ = rmse(plane, rows, cols, truth)
        plane1, vp1 = entry.fit_fill(g)
        r_one, _ = rmse(plane1, rows, cols, truth)
        if not abs(r_fit - RMSE_FITTED) <= RMSE_TOL:
            raise AssertionError(f"sharded fit+fill RMSE {r_fit} outside {RMSE_FITTED} +- {RMSE_TOL}: parameters "
                                 f"{[float(p) for p in vp]}, one device's {[float(p) for p in vp1]} (RMSE {r_one})")
        same_planes(plane, fill_kriging(g, vparams=vp), "sharded fit+fill vs the one-device fill with its parameters")
        del plane1
        ms["fit_fill one device wall"] = host_ms(lambda: entry.fit_fill(g), reps=3)
        centers = _bin_table(10, 10)[3]
        lags = torch.as_tensor(centers * 0.5 * (abs(g.lat_step) + abs(g.lon_step)), dtype=torch.float64)
        ga = variogram_model(lags, tuple(float(p) for p in vp))
        gb_ = variogram_model(lags, tuple(float(p) for p in vp1))
        rel = float(((ga - gb_).abs() / gb_.abs()).max())
        if rel > 3e-4:
            raise AssertionError(f"sharded fit: gamma at the bin lags {rel:.3g} relative from one-device fit_fill's")
        same = [float(p) for p in vp] == [float(p) for p in vp1]
        out["lines"].append(
            f"fit+fill r0.10 4 ranks: RMSE {r_fit:.6f} m ({RMSE_FITTED} +- {RMSE_TOL}; one-device fit_fill "
            f"{r_one:.6f}); (nugget, sill, range) {[float(p) for p in vp]}, {'equal to' if same else 'against'} "
            f"one device's {[float(p) for p in vp1]}, gamma at the bin lags within {rel:.3g} relative; the fill "
            f"bit-equal to the one-device fill with these parameters; wall {ms['fit_fill wall']:.3f} ms without "
            f"the gather, {ms['fit_fill wall with full_tensor']:.3f} ms with full_tensor(), against one-device "
            f"fit_fill {ms['fit_fill one device wall']:.3f} ms")
    del plane

    # ---- the streaming demo's survey on row bands and on (2, 2) blocks,
    # every window and the snapshot against the one-device mosaic
    from auvtpu_torch.cli.stream_demo import lawnmower_track

    H, W = STREAM["shape"]
    truth_s = shelf_seamount(H, W)
    ext = Extent(0.0, W - 1.0, 0.0, H - 1.0)
    for layout, m, cls in (("4 ranks", mesh, ShardedStreamingInterpolator),
                           ("(2, 2)", mesh2, ShardedStreamingInterpolator2D)):
        kw = dict(window=(256, 256), method="idw", max_radius=5)
        si = cls((H, W), ext, m, **kw)
        one = StreamingInterpolator((H, W), ext, device=dev, **kw) if first else None
        rng = np.random.default_rng(STREAM["seed"])
        vr, vc = lawnmower_track(H, W, P23_STEPS, STREAM["line_spacing"])
        off = np.linspace(-STREAM["swath_width"] / 2, STREAM["swath_width"] / 2, STREAM["beams"])
        t_sh = t_one = 0.0
        n_win = 0
        for s in range(P23_STEPS):
            beams = STREAM["beams"]
            ri = np.clip(vr[s] + off + rng.normal(0, 0.3, beams), 0, H - 1).astype(np.int64)
            ci = np.clip(np.full(beams, vc[s]) + rng.normal(0, 0.3, beams), 0, W - 1).astype(np.int64)
            depths = (truth_s[ri, ci] + rng.normal(0, STREAM["noise"], beams)).astype(np.float32)
            t0 = time.perf_counter()
            si.ingest(ri, ci, depths)
            t_sh += time.perf_counter() - t0
            if first:
                t0 = time.perf_counter()
                one.ingest(ri, ci, depths)
                t_one += time.perf_counter() - t0
            if (s + 1) % STREAM["fill_every"] == 0:
                t0 = time.perf_counter()
                tile, origin = counted(lambda: si.window_fill(int(vr[s]), int(vc[s])))
                tile = tile.cpu()
                t_sh += time.perf_counter() - t0
                n_win += 1
                if first:
                    t0 = time.perf_counter()
                    tile1, origin1 = one.window_fill(int(vr[s]), int(vc[s]))
                    tile1 = tile1.cpu()
                    t_one += time.perf_counter() - t0
                    if origin != origin1:
                        raise AssertionError(f"sharded stream {layout}: window {n_win} at {origin}, one device {origin1}")
                    same_planes(tile, tile1, f"sharded stream {layout} window {n_win}")
        snap = si.snapshot()
        ms[f"stream {layout} wall"] = t_sh * 1e3
        if first:
            ms[f"stream {layout} one device wall"] = t_one * 1e3
            snap1 = one.snapshot()
            if not np.array_equal(snap, snap1, equal_nan=True):
                raise AssertionError(f"sharded stream {layout}: snapshot differs from the one-device mosaic")
            n_cells, nsum = int(np.isfinite(snap).sum()), float(np.nansum(snap))
            out["lines"].append(
                f"stream 4096x4096 {layout}: {P23_STEPS} swaths, {n_win} 256x256 IDW windows each bit-equal to the "
                f"one-device mosaic's, the snapshot too ({n_cells} cells, f64 nansum {nsum!r}); wall (ingest + "
                f"windows to the host) {t_sh:.3f} s against one device {t_one:.3f} s (interleaved on this rank)")
            del one, snap1
        del si, snap

    # ---- the 8-page diagonal atlas, pages dealt over the ranks, served
    # through the resampler (B8) on every rank
    g = grids[0.10][0]
    diag = band_tracks(g, N_BAND)["diagonal"]
    ra = tband.BandRouter(g, max_bands=8)
    _, segs = ra._plan(*diag, 8)
    atlas1 = ra.prepare(*diag)
    rs1 = ra._resampler
    build = (lambda: build_atlas_sharded(g, segs, mesh, margin=ra.margin, fill_backend=ra.fill_backend,
                                         convention=ra.convention))
    atlas = counted(build)
    ms["atlas wall"] = host_ms(build, reps=3)
    if not (torch.equal(atlas.planes, atlas1.planes) and torch.equal(atlas.vmasks, atlas1.vmasks)
            and atlas.placed == atlas1.placed and atlas.masked == atlas1.masked):
        raise AssertionError("sharded atlas differs from build_atlas")
    rs = tband.AtlasResampler(g, atlas, chunk=rs1.chunk, win_rows=rs1.wr, win_cols=rs1.wc, lerp_mode=rs1.lerp_mode)
    z, ok = counted(lambda: rs.resample(*diag))
    z1, ok1 = rs1.resample(*diag)
    if not (torch.equal(ok, ok1) and torch.equal(z[ok], z1[ok1])):
        raise AssertionError("the resampler over the sharded atlas serves other depths than over build_atlas")
    seen = device_kernels(lambda: rs.resample(*diag))
    if not any("band_resample_" in k for k in seen):
        raise AssertionError(f"rank {mesh.index}: the resample launched {seen}, not B8")
    out["kernels"]["resample"] = sum(v for k, v in seen.items() if "band_resample_" in k)
    if first:
        ms["atlas one device wall"] = host_ms(lambda: tband.build_atlas(
            g, segs, margin=ra.margin, fill_backend=ra.fill_backend, convention=ra.convention), reps=3)
        out["lines"].append(
            f"atlas r0.10 diagonal, {len(atlas.placed)} pages over 4 ranks: planes and vmasks bit-equal to "
            f"build_atlas; {N_BAND} pings through AtlasResampler (B8): ok and z equal to those over build_atlas "
            f"({int(ok.sum())} resolved); wall {ms['atlas wall']:.3f} ms against one device "
            f"{ms['atlas one device wall']:.3f} ms")
    out["launches"] = launches
    for k in launches:
        if launches[k] < 1:
            raise AssertionError(f"rank {mesh.index}: {k} was never launched on the sharded paths: {launches}")
    return out


def call_us(fn, reps: int = 200, sync_every: int = 8) -> list:
    """Host microseconds of one call (the checks, the dispatch and the
    launch, not the kernel's run): quartiles over ``reps`` calls, a device
    sync every ``sync_every`` so the queue never fills."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        t0_ = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0_) * 1e6)
        if i % sync_every == sync_every - 1:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return [float(np.percentile(times, q)) for q in (25, 50, 75)]


def debug_mode_ops(dev, card: str) -> dict:
    """Phase 24's check of B2, B4, B5, B6 and B11 as custom ops: on the
    covered Grid A grid at 1M queries, each public entry under
    ``debug_mode(disable_jit=True)`` gives finite values and a logging
    dispatch mode sees each op once; under ``debug_mode()`` the NaN B11
    writes at an out-of-grid query raises at ``auvtpu_torch.select_krige``
    and the one B6 makes (w*v = +inf beside a -inf tap) at
    ``auvtpu_torch.idw_select``; then each wrapper's host microseconds a
    call.  Returns the two messages."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from auvtpu_torch.config import GRID_A_EXTENT, GRID_A_SHAPE, Extent
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.kernels import valid_select as vs
    from auvtpu_torch.kernels import window_fill as wf
    from auvtpu_torch.ops import fill_kriging
    from auvtpu_torch.ops import packs as tp
    from auvtpu_torch.synthetic import shelf_seamount
    from auvtpu_torch.utils import debug_mode

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "auvtpu_torch":
                self.ops.append(func.__name__.split(".")[0])
            return func(*args, **(kwargs or {}))

    gA = RegularGrid.dense(shelf_seamount(*GRID_A_SHAPE), GRID_A_EXTENT, device=dev)
    p16, win = tp.build_valid16_pack(gA), tp.StencilPack(gA).window
    lo, la = scattered_queries(GRID_A_EXTENT, *GRID_A_SHAPE, 1_000_000, 31, dev)
    calls = {
        "kriging_valid_t (B11)": lambda: vs.kriging_valid_t(p16, gA, lo, la),
        "packed_idw_t (B6)": lambda: vs.packed_idw_t(win, gA, lo, la),
        "valid_select_t (B5)": lambda: vs.valid_select_t(p16, gA, lo, la)["val"],
        "fill_kriging select (B2)": lambda: fill_kriging(gA, backend="select"),
        "topk_idx (B4)": lambda: wf.topk_idx(gA, k=4, max_radius=10)[1][3],
    }
    with debug_mode(disable_jit=True), Log() as log:
        outs = {k: fn() for k, fn in calls.items()}
    bad = [k for k, o in outs.items() if not bool(torch.isfinite(o).all())]
    if bad or sorted(log.ops) != ["idw_select", "select_krige", "topk_full", "topk_idx", "valid_select"]:
        raise AssertionError(f"debug_mode on the covered Grid A grid: not finite {bad}, ops seen {log.ops}")
    del outs
    say("quick", f"debug_mode(disable_jit=True) on the covered Grid A grid, 1M queries: B11, B6, B5, B2 and B4 "
        f"finite, each op seen once: {sorted(log.ops)}")
    caught = {}
    span = GRID_A_EXTENT.max_lon - GRID_A_EXTENT.min_lon
    oob = (torch.tensor([GRID_A_EXTENT.min_lon + 0.3 * span, GRID_A_EXTENT.max_lon + 1.0], device=dev),
           torch.tensor([25.0, 25.0], device=dev))
    # a unit-step grid, so the query at (6.5, 5.5) is the centre of tap
    # (-1, -1) of cell (6, 7): w = 1/(0 + eps) = 1e12, and 1e27 * 1e12 is
    # +inf beside the -inf tap at (5, 7)
    e_u = shelf_seamount(64, 80)
    e_u[5, 6], e_u[5, 7] = 1e27, -np.inf
    g_u = RegularGrid.dense(e_u, Extent(0.0, 79.0, 0.0, 63.0), device=dev)
    nan_calls = {
        "select_krige": lambda: vs.kriging_valid_t(p16, gA, *oob),
        "idw_select": lambda: vs.packed_idw_t(tp.StencilPack(g_u).window, g_u, torch.tensor([6.5], device=dev),
                                              torch.tensor([5.5], device=dev)),
    }
    for op, fn in nan_calls.items():
        try:
            with debug_mode():
                fn()
        except FloatingPointError as exc:
            caught[op] = str(exc)
        else:
            raise AssertionError(f"debug_mode did not raise on the NaN that {op} made")
        if f"auvtpu_torch.{op}" not in caught[op]:
            raise AssertionError(f"debug_mode raised at another op than {op}: {caught[op]}")
    us = {k: call_us(fn) for k, fn in calls.items()}
    say("quick", "host us a call (q25/q50/q75), the custom-op wrappers: " + "; ".join(
        f"{k} {v[0]:.1f}/{v[1]:.1f}/{v[2]:.1f}" for k, v in us.items()) + f"  [{card}]")
    del gA, p16, win, lo, la
    torch.cuda.empty_cache()
    return caught


def main() -> int:
    import torch

    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from auvtpu_torch import entry
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.kernels import build as kbuild
    from auvtpu_torch.kernels import window_fill as wf
    from auvtpu_torch.ops import fill_kriging, krige_planes, kriging_at_cells
    from auvtpu_torch.variogram import empirical_variogram, fit_variogram, variogram_model

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    device_kind = torch.cuda.get_device_name(0)
    say("device", f"{device_kind}, {torch.cuda.device_count()} visible; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; TF32 off")

    # ---- 2. build
    from concurrent.futures import ThreadPoolExecutor

    from auvtpu_torch.kernels import band_resample as kb
    from auvtpu_torch.kernels import exact_epilogue as ee
    from auvtpu_torch.kernels import exact_prologue as ep
    from auvtpu_torch.kernels import exact_select as es
    from auvtpu_torch.kernels import scattered_select as ss
    from auvtpu_torch.kernels import variogram as kv

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as ex:  # one nvcc per source, all started together
        list(ex.map(kbuild.build, SOURCES))
    wf.build()
    ss.build()
    kb.build()
    kv.build()
    es.build()
    ep.build()
    ee.build()
    say("build", f"{', '.join(s + '.cu' for s in SOURCES)} built and loaded in {time.perf_counter() - t0:.1f} s")
    for src in SOURCES:
        log = kbuild.library_path(src).with_suffix(".log")
        if log.exists():
            regs = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln]
            say("build", f"{src} ptxas: {len(regs)} kernels; " + " | ".join(regs[:3]))

    grid, rows, cols, truth = bench_workload(dev)
    n_pts = truth.numel()
    say("data", f"{SHAPE[0]}x{SHAPE[1]} grid, {n_pts} masked cells on {dev}")

    # ---- 3. B2 vs plain, on the bench plane and on a window view read in
    # place, and one launch a call
    sel_k = wf.topk_full(grid, k=4, max_radius=10)
    sel_p = wf.topk_full_ref(grid, k=4, max_radius=10)
    torch.cuda.synchronize()
    selection_equal(sel_k, sel_p, "B2 topk_full vs plain")
    b2_err = max(float((a - b).abs().max()) for a, b in zip(sel_k[1], sel_p[1]))
    say("B2", f"selection exactly equal to plain at {SHAPE} (cnt, values, dx, dy); "
        f"cells with 4 found: {float((sel_k[0] == 4).float().mean()):.6f}")
    del sel_k, sel_p
    gw = RegularGrid(grid.elev[600:1624, 200:2248], grid.valid[600:1624, 200:2248], grid.min_lon, grid.max_lon,
                     grid.min_lat, grid.max_lat)
    for k, R in ((4, 10), (16, 5)):
        selection_equal(wf.topk_full(gw, k=k, max_radius=R), wf.topk_full_ref(gw, k=k, max_radius=R),
                        f"B2 topk_full vs plain, window view k={k} R={R}")
    say("B2", f"1024x2048 window view (row stride {gw.elev.stride(0)}) at (600, 200), k=4 R=10 and k=16 R=5: "
        f"exactly equal to plain")
    del gw
    seen = only_kernel(lambda: wf.topk_full(grid, k=4, max_radius=10), "topk_tile_kernel", "B2 call", copies=True)
    say("B2", f"one kernel launch a call and no memory copy; the device records of 20 calls the profiler "
        f"kept: {seen}")

    # ---- 4. B1 vs plain (bit for bit), and one launch a call
    plane_k = wf.fill_kriging_fused(grid)
    plane_p = wf.fill_kriging_fused_ref(grid)
    b1_err = same_planes(plane_k, plane_p, "B1 vs plain, bench")
    lu_k = wf.fill_kriging_fused(grid, solver="lu")
    b1_err = max(b1_err, same_planes(lu_k, wf.fill_kriging_fused_ref(grid, solver="lu"), "B1 lu vs plain, bench"))
    lu_rel = within_rel(lu_k, plane_k, LU_RTOL, "B1 lu vs gj, bench")
    say("B1", f"bench: gj and lu bit-equal to plain; lu vs gj max rel {lu_rel:.3g}")
    del plane_p, lu_k
    seen = only_kernel(lambda: wf.fill_kriging_fused(grid), "kriging_fill_kernel", "B1 call", copies=True)
    say("B1", f"one kernel launch a call and no memory copy; the device records of 20 calls the profiler "
        f"kept: {seen}")
    sg = small_grid(dev)
    for model, vp in MODEL_VPARAMS.items():
        for solver in ("gj", "lu"):
            kw = dict(model=model, vparams=vp, convention="centered", with_variance=True,
                      row0=17, col0=29, steps=(0.8, 0.6), solver=solver)
            pk, vk = wf.fill_kriging_fused(sg, **kw)
            pp, vpl = wf.fill_kriging_fused_ref(sg, **kw)
            same_planes(pk, pp, f"B1 vs plain, {model} {solver}")
            same_planes(vk, vpl, f"B1 variance vs plain, {model} {solver}")
            if solver == "lu":
                rel = within_rel(pk, gj, LU_RTOL, f"B1 lu vs gj, {model}")
            gj = pk
        say("B1", f"256x320 {model:11s} centered, variance, row0/col0/steps: gj and lu, plane and variance "
            f"bit-equal to plain; lu vs gj rel {rel:.3g}")
    # a 1024x2048 window view of the stand-in (row stride 2441), read in place
    gw = RegularGrid(grid.elev[600:1624, 200:2248], grid.valid[600:1624, 200:2248], grid.min_lon, grid.max_lon,
                     grid.min_lat, grid.max_lat)
    same_planes(wf.fill_kriging_fused(gw, row0=600, col0=200, steps=(grid.lat_step, grid.lon_step)),
                wf.fill_kriging_fused_ref(gw, row0=600, col0=200, steps=(grid.lat_step, grid.lon_step)),
                "B1 vs plain, window view")
    say("B1", f"1024x2048 window view (row stride {gw.elev.stride(0)}) at (600, 200): bit-equal to plain")
    del gw
    # B19: B1 at the stand-in's masked cells (draw order) alone, bit for bit
    # B1's plane there and its plain version; one kernel a kriging_at_cells
    b19_err = same_planes(wf.kriging_at_cells_fused(grid, rows, cols), plane_k[rows, cols], "B19 vs B1 at the cells")
    b19_err = max(b19_err, same_planes(wf.kriging_at_cells_fused(grid, rows, cols),
                                       wf.kriging_at_cells_fused_ref(grid, rows, cols), "B19 vs plain"))
    lu_c = wf.kriging_at_cells_fused(grid, rows, cols, solver="lu")
    b19_err = max(b19_err, same_planes(lu_c, wf.fill_kriging_fused(grid, solver="lu")[rows, cols],
                                       "B19 lu vs B1 lu at the cells"))
    perm_ = torch.randperm(SHAPE[0] * SHAPE[1], generator=torch.Generator().manual_seed(7)).to(dev)
    for share_ in (0.5, 1.0):
        fl_ = perm_[: int(share_ * perm_.numel())]
        b19_err = max(b19_err, same_planes(wf.kriging_at_cells_fused(grid, fl_ // SHAPE[1], fl_ % SHAPE[1]),
                                           plane_k.reshape(-1)[fl_], f"B19 vs B1, {share_:.0%} of the cells"))
    seen = only_kernel(lambda: kriging_at_cells(grid, rows, cols), "kriging_cells_kernel", "kriging_at_cells call",
                       copies=True)
    say("B19", f"the stand-in's {rows.numel()} masked cells, gj and lu, and 50 % and 100 % of the cells in draw "
        f"order: bit-equal to B1's plane there and to plain; kriging_at_cells is one kernel launch and no memory "
        f"copy; the device records of 20 calls the profiler kept: {seen}")
    del plane_k, lu_c, perm_

    # ---- 5. main path (launch counts from here to the end of phase 6)
    wf.reset_launches()
    plane = fill_kriging(grid, backend="fused")
    r_fused, n_fin = rmse(plane, rows, cols, truth)
    plane_sel = fill_kriging(grid, backend="select")
    r_sel, _ = rmse(plane_sel, rows, cols, truth)
    say("main", f"fill_kriging fused RMSE={r_fused:.6f} m, select RMSE={r_sel:.6f} m "
        f"over {n_pts} masked cells ({n_fin} finite)")
    for label, r in (("fused", r_fused), ("select", r_sel)):
        if not abs(r - RMSE_FIXED) <= RMSE_TOL:
            raise AssertionError(f"{label} RMSE {r} outside {RMSE_FIXED} +- {RMSE_TOL}")
    del plane_sel

    # ---- 6. entry (the launch counts zeroed just before fit_fill and read
    # just after it, then added to phase 5's)
    launches = dict(wf.LAUNCHES)
    wf.reset_launches()
    kv.reset_launches()
    filled, vparams = entry.fit_fill(grid)
    torch.cuda.synchronize()
    launches_fit = {**wf.LAUNCHES, **kv.LAUNCHES}
    launches = {k: launches.get(k, 0) + v for k, v in launches_fit.items()}
    pv = [float(p) for p in vparams]
    r_fit, n_fin = rmse(filled, rows, cols, truth)
    say("entry", f"fit_fill: nugget={pv[0]:.6g} sill={pv[1]:.6g} range={pv[2]:.6g}; "
        f"RMSE={r_fit:.6f} m; {n_fin}/{n_pts} masked cells finite; launches in fit_fill {launches_fit}")
    if {k: v for k, v in launches_fit.items() if v} != {"pair_sums": 1, "fit_model": 1, "fill_kriging_fused": 1}:
        raise AssertionError(f"fit_fill launched {launches_fit}, want B9, B10 and B1 once each")
    if not all(np.isfinite(p) and p > 0 for p in pv):
        raise AssertionError(f"fitted parameters not finite and positive: {pv}")
    if n_fin <= 0.99 * n_pts:
        raise AssertionError(f"only {n_fin}/{n_pts} masked cells finite")
    if not abs(r_fit - RMSE_FITTED) <= RMSE_TOL:
        raise AssertionError(f"fit_fill RMSE {r_fit} outside {RMSE_FITTED} +- {RMSE_TOL}")
    for k in ("fill_kriging_fused", "topk_full"):
        if launches[k] < 1:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    e_fit = same_planes(wf.fill_kriging_fused(grid, vparams=vparams),
                        wf.fill_kriging_fused_ref(grid, vparams=vparams), "B1 vs plain, fitted")
    b1_err = max(b1_err, e_fit)
    seen = only_kernel(lambda: wf.fill_kriging_fused(grid, vparams=vparams), "kriging_fill_kernel",
                       "B1 call, fitted parameters", copies=True)
    say("entry", f"B1 vs plain under the fitted parameters (read on the device): bit-equal; one kernel launch "
        f"a call and no memory copy, device records of 20 calls kept: {seen}")
    # ROADMAP section C1: the package's fit, a float64 loop that stops after
    # the first kept step moving gamma by less than 1e-4, lands in one place
    # on the card and the host (within 1e-6), its gamma at the bins with
    # pairs within 3e-4 of the JAX package's landing (JAX_FIT_PARAMS), and
    # the fill under it is gated above.  Printed, not gated: the float64
    # plane's RMSE under the same parameters, where the float32 fill's
    # spread comes from (the cancellation in sill * (1 - exp(-h / range))).
    host = [float(p) for p in fit_variogram(bench_workload("cpu")[0])]
    rel = max(abs(a - b) / abs(b) for a, b in zip(pv, host))
    lags, _, counts = empirical_variogram(grid)
    h = lags.double().cpu() * (0.5 * (abs(grid.lat_step) + abs(grid.lon_step)))
    pairs = counts.cpu() > 0
    g_ours = variogram_model(h, tuple(pv))[pairs]
    g_jax = variogram_model(h, JAX_FIT_PARAMS)[pairs]
    rel_g = float(((g_ours - g_jax).abs() / g_jax.abs()).max())
    g64 = RegularGrid(grid.elev.double(), grid.valid.double(), grid.min_lon, grid.max_lon, grid.min_lat,
                      grid.max_lat)
    r_64, _ = rmse(fill_kriging(g64, vparams=tuple(torch.tensor(p, dtype=torch.float64, device=dev) for p in pv),
                                backend="torch"), rows, cols, truth)
    del g64
    say("entry", f"C1: fit_variogram lands at {pv} on the card and {host} on the host, max rel {rel:.3g} (bar "
        f"1e-6); gamma at the {int(pairs.sum())} bins with pairs {rel_g:.3g} relative from the JAX package's "
        f"landing {JAX_FIT_PARAMS} (bar 3e-4); fit_fill RMSE {r_fit:.6f} m (gate {RMSE_FITTED} +- {RMSE_TOL}), "
        f"B1 bit-equal to its plain twin; the float64 plane under the same parameters {r_64:.6f} m (not gated)  "
        f"[{card}]")
    if not rel <= 1e-6:
        raise AssertionError(f"the fit lands {rel} apart on card and host: {pv} against {host}")
    if not rel_g <= 3e-4:
        raise AssertionError(f"the fitted gamma is {rel_g} from the JAX package's landing")
    # the fit part of fit_fill (B9 with its cached table, the lag centres
    # cached on the card, B10) makes the host wait for nothing: under the
    # "error" sync debug mode a synchronising copy or readback raises.  The
    # whole of fit_fill runs under "warn", and any synchronising call of its
    # fill part is named.
    torch.cuda.set_sync_debug_mode("error")
    try:
        vp_ns = fit_variogram(grid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            entry.fit_fill(grid)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
    if [float(p) for p in vp_ns] != pv:
        raise AssertionError(f"fit_variogram under the sync debug mode landed at {vp_ns}, not at {pv}")
    say("entry", f"fit_variogram ran under torch.cuda.set_sync_debug_mode('error'): no synchronising call; "
        f"fit_fill under 'warn': {len(syncs)} synchronising calls {syncs}")

    # B9 against its plain twin on the stand-in in its three layouts (the
    # whole grid, a row band with max_lag rows below it, a 2-D block inside
    # its halo-extended block), isotropic and (sector, lag) bins, read in
    # place: counts equal, sums within 1e-12 relative and equal once rounded
    # to f32, a second call bit-equal
    from auvtpu_torch.variogram import STOP_DGAMMA, _bin_table, _sector_bin_table

    H, W = grid.shape
    b9_err = 0.0
    layouts = {"whole grid": (grid.elev, grid.valid, H, W, 0),
               "row band": (grid.elev[600:1624 + 10], grid.valid[600:1624 + 10], 1024, W, 0),
               "2-D block": (grid.elev[600:1624 + 10, 500:1524 + 20], grid.valid[600:1624 + 10, 500:1524 + 20],
                             1024, 1024, 10)}
    # the mixed-path grid: the stand-in with a validity of 0.5 in one 32x32
    # tile block and an inf under an invalid cell in another send those
    # blocks down B9's general path, the rest down its fast one.  The inf sits
    # in row 1633, which the band and the 2-D block reach only as partners at
    # dy = 10, so only the bins holding such offsets are NaN (inf * 0), as in
    # the twin; the whole grid, where it is a base cell, is held without it
    e_mix, v_mix = grid.elev.clone(), grid.valid.clone()
    v_mix[700, 700] = 0.5
    v_mix[1633, 1000] = 0.0
    e_inf = e_mix.clone()
    e_inf[1633, 1000] = float("inf")
    layouts.update({
        "mixed-path whole grid": (e_mix, v_mix, H, W, 0),
        "mixed-path row band": (e_inf[600:1634], v_mix[600:1634], 1024, W, 0),
        "mixed-path 2-D block": (e_inf[600:1634, 500:1544], v_mix[600:1634, 500:1544], 1024, 1024, 10)})
    tables = (("lag", _bin_table(10, 10)[:3] + (10,)), ("sector x lag", _sector_bin_table(10, 10, 4)[:3] + (40,)))
    for bins_name, tab in tables:
        for lay, args in layouts.items():
            got = kv.pair_sums(*args, *tab, 10)
            want = kv.pair_sums_ref(*args, *tab, 10)
            again = kv.pair_sums(*args, *tab, 10)
            if not torch.equal(got[1], want[1]):
                raise AssertionError(f"B9 {lay}, {bins_name} bins: counts differ from the twin's: {got[1]} {want[1]}")
            nan = torch.isnan(want[0])
            inf_layout = lay in ("mixed-path row band", "mixed-path 2-D block")
            if not torch.equal(torch.isnan(got[0]), nan) or bool(nan.any()) != inf_layout or bool(nan.all()):
                raise AssertionError(f"B9 {lay}, {bins_name} bins: NaN sums {torch.isnan(got[0]).tolist()} against "
                                     f"the twin's {nan.tolist()}")
            g9, w9 = got[0][~nan], want[0][~nan]
            rel9 = float(((g9 - w9).abs() / w9.abs().clamp(min=1e-300)).max())
            if not (rel9 <= 1e-12 and torch.equal(g9.float(), w9.float())):
                raise AssertionError(f"B9 {lay}, {bins_name} bins: sums {rel9} relative from the twin's, or not "
                                     f"equal once rounded to f32")
            if not (torch.equal(got[0].view(torch.int64), again[0].view(torch.int64))
                    and torch.equal(got[1], again[1])):
                raise AssertionError(f"B9 {lay}, {bins_name} bins: two calls differ")
            b9_err = max(b9_err, float((g9 - w9).abs().max()))
            say("B9", f"{lay} ({args[2]}x{args[3]} base cells at column {args[4]}, row stride {args[0].stride(0)}), "
                f"{tab[3]} {bins_name} bins: counts equal, sums {rel9:.3g} relative from the twin's, equal in f32"
                + (f", {int(nan.sum())} NaN bins as the twin's" if bool(nan.any()) else "")
                + "; a second call bit-equal")
    del e_mix, v_mix, e_inf
    # B10 against the plain loop under the stand-in's gamma (float64 in, as
    # the loop computes): every model, 25 steps; landing within 1e-9
    # relative, the per-step (kept, frozen) flags equal
    lags_s, gam_s, cnt_s = empirical_variogram(grid)
    h_s = lags_s * (0.5 * (abs(grid.lat_step) + abs(grid.lon_step)))
    fit_in = (h_s.double(), gam_s.double(), cnt_s.double())
    b10_err, b10_steps = 0.0, {}
    for model in ("exponential", "linear", "spherical", "gaussian"):
        p_k, flags_k = kv.fit_walk(*fit_in, model=model, iters=25, stop=STOP_DGAMMA)
        rec = []
        p_p = torch.stack(kv.fit_model_ref(*fit_in, model=model, iters=25, stop=STOP_DGAMMA, record=rec))
        flags_p = [[int(a), int(b)] for a, b in rec]
        rel10 = float(((p_k - p_p).abs() / p_p.abs()).max())
        if not (rel10 <= 1e-9 and flags_k.cpu().tolist() == flags_p):
            raise AssertionError(f"B10 {model}: landing {p_k.tolist()} against the plain loop's {p_p.tolist()} "
                                 f"({rel10} relative), flags {flags_k.cpu().tolist()} against {flags_p}")
        b10_err = max(b10_err, float((p_k - p_p).abs().max()))
        kept = [i + 1 for i, (k, _) in enumerate(flags_p) if k]
        stop_at = next((i + 1 for i, (_, f) in enumerate(flags_p) if f), None)
        # the kernel ends its walk at the first step not kept or frozen
        b10_steps[model] = next((i + 1 for i, (k, f) in enumerate(flags_p) if not k or f), 25)
        say("B10", f"{model:11s} 25 steps: landing {p_k.tolist()}, {rel10:.3g} relative from the plain loop's; "
            f"per-step flags equal (kept steps {kept}, frozen after step {stop_at}); the kernel ran "
            f"{b10_steps[model]} of the 25 steps")

    # ---- 7. timing
    sel = wf.topk_full(grid, k=4, max_radius=10)
    iso = tables[0][1]
    ms = {
        "fused (B1)": time_ms(lambda: fill_kriging(grid, backend="fused")),
        "B1 kernel alone": device_ms(b1_launcher(grid), "kriging_fill_kernel"),
        "B1 kernel alone cold": device_ms(b1_launcher(grid), "kriging_fill_kernel", cold=True),
        "B1 wrapper": time_ms(lambda: wf.fill_kriging_fused(grid)),
        "B1 plain": time_ms(lambda: wf.fill_kriging_fused_ref(grid)),
        "B19 kernel alone": device_ms(b19_launcher(grid, rows, cols), "kriging_cells_kernel"),
        "B19 kernel alone cold": device_ms(b19_launcher(grid, rows, cols), "kriging_cells_kernel", cold=True),
        "B19 wrapper": time_ms(lambda: wf.kriging_at_cells_fused(grid, rows, cols)),
        "B19 plain": time_ms(lambda: wf.kriging_at_cells_fused_ref(grid, rows, cols)),
        "B1 + gather device-busy": device_busy_ms(
            lambda: wf.fill_kriging_fused(grid).reshape(-1)[rows * SHAPE[1] + cols]),
        "kriging_at_cells device-busy": device_busy_ms(lambda: kriging_at_cells(grid, rows, cols)),
        "select (B2 + torch solve)": time_ms(lambda: fill_kriging(grid, backend="select")),
        "torch (plain)": time_ms(lambda: fill_kriging(grid, backend="torch")),
        "B2 kernel alone": device_ms(b2_launcher(grid), "topk_tile_kernel"),
        "B2 kernel alone cold": device_ms(b2_launcher(grid), "topk_tile_kernel", cold=True),
        "B2 call": device_ms(lambda: wf.topk_full(grid, k=4, max_radius=10), None),
        "B2 wrapper": time_ms(lambda: wf.topk_full(grid, k=4, max_radius=10)),
        "B2 plain": time_ms(lambda: wf.topk_full_ref(grid, k=4, max_radius=10)),
        "torch solve": time_ms(lambda: krige_planes(grid, sel)),
        "pair sums": time_ms(lambda: empirical_variogram(grid)),
        "pair sums device-busy": device_busy_ms(lambda: empirical_variogram(grid)),
        "B9 kernel alone": device_ms(b9_launcher(grid.elev, grid.valid, H, W, 0, *iso)[0], "pair_sums_"),
        "B9 wrapper": time_ms(lambda: kv.pair_sums(grid.elev, grid.valid, H, W, 0, *iso, 10)),
        "pair sums plain": time_ms(lambda: kv.pair_sums_ref(grid.elev, grid.valid, H, W, 0, *iso, 10)),
        "variogram fit": time_ms(lambda: fit_variogram(grid)),
        "B10 kernel alone": device_ms(b10_launcher(h_s, gam_s, cnt_s)[0], "fit_model_kernel"),
        "B10 wrapper": time_ms(lambda: kv.fit_model(h_s, gam_s, cnt_s, iters=25, stop=STOP_DGAMMA)),
        "variogram fit plain": time_ms(lambda: kv.fit_model_ref(h_s, gam_s, cnt_s, iters=25, stop=STOP_DGAMMA)),
        "fit_fill": time_ms(lambda: entry.fit_fill(grid)),
        "fit_fill device-busy": device_busy_ms(lambda: entry.fit_fill(grid)),
    }
    for label, t in ms.items():
        rate = f", {n_pts / (t / 1e3) / 1e6:.3f} M masked pts/s" if label in (
            "fused (B1)", "select (B2 + torch solve)", "torch (plain)", "fit_fill") else ""
        say("timing", f"{label:26s} {t:.4f} ms{rate}  [{card}]")
    say("timing", f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB")
    b19_bound = bound(4.0 * (2 * SHAPE[0] * SHAPE[1] + n_pts), n_pts * (4.0 / (1.0 - REMOVAL) + B1_SOLVE_OPS))
    say("timing", f"B19 at the {n_pts} masked cells: alone {ms['B19 kernel alone']:.4f} ms (cold "
        f"{ms['B19 kernel alone cold']:.4f}) against its bound {b19_bound[0]:.4f} ms ({b19_bound[1]}, "
        f"{b19_bound[0] / ms['B19 kernel alone']:.0%}); B1 alone {ms['B1 kernel alone']:.4f} ms, B1 and the gather "
        f"{ms['B1 + gather device-busy']:.4f} ms of card, kriging_at_cells {ms['kriging_at_cells device-busy']:.4f} "
        f"ms of card  [{card}]")
    # B9's bound (as in the kernels line) and the floor of its design: one
    # f32 -> f64 conversion a pair, 16 a clock an SM, at the card's largest
    # SM clock
    n_pairs9 = float(grid.shape[0] * grid.shape[1] * len(iso[0]))
    bound9 = bound(4.0 * n_pairs9 / len(iso[0]) * 2 + 16.0 * 10, 4 * n_pairs9, 2 * n_pairs9)
    counted9 = float(kv.pair_sums(grid.elev, grid.valid, H, W, 0, *iso, 10)[1].sum())
    sm_mhz = float(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
                                   "--format=csv,noheader,nounits"],
                                  capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    floor9 = n_pairs9 / (16.0 * n_sm * sm_mhz * 1e6) * 1e3
    say("timing", f"B9 kernel alone {ms['B9 kernel alone']:.4f} ms against its bound {bound9[0]:.4f} ms ({bound9[1]}) "
        f"and its conversion floor {floor9:.4f} ms ({n_pairs9:.0f} pairs, {counted9:.0f} of them counted, one "
        f"f32 -> f64 conversion each, 16 a clock on each of {n_sm} SMs at {sm_mhz:.0f} MHz)  [{card}]")

    # ---- 8. B3 and B4 vs their plain versions
    from auvtpu_torch.grid import RegularGrid

    del sel
    grid2, rows2, cols2, _ = bench_workload(dev, 0.20)
    b3_err = {"idw": 0.0, "mean": 0.0}
    checks = [("stand-in r0.20 R=10 reference", grid2, 10, "reference")] + [
        (f"256x320 R={R} {conv}", sg, R, conv) for R in (5, 10) for conv in ("reference", "centered")
    ]
    for label, g, R, conv in checks:
        e_i = close_planes(wf.fill_idw_fused(g, k=8, max_radius=R, convention=conv),
                           wf.fill_idw_fused_ref(g, k=8, max_radius=R, convention=conv),
                           f"B3 idw vs plain, {label}", B3_RTOL, B3_ATOL)
        e_m = close_planes(wf.fill_mean_fused(g, k=4, max_radius=R, convention=conv),
                           wf.fill_mean_fused_ref(g, k=4, max_radius=R, convention=conv),
                           f"B3 mean vs plain, {label}", B3_RTOL, B3_ATOL)
        b3_err["idw"] = max(b3_err["idw"], e_i)
        b3_err["mean"] = max(b3_err["mean"], e_m)
        say("B3", f"{label}: max |kernel - plain| idw k=8 {e_i:.6g} m, mean k=4 {e_m:.6g} m")
    # a window view of the stand-in (row stride 2441) with observed cells kept,
    # as the streaming refresh reads the mosaic, at both tile shapes
    for (wh, ww), R in (((256, 256), 5), ((1024, 2048), 10)):
        gw = RegularGrid(grid2.elev[700:700 + wh, 300:300 + ww], grid2.valid[700:700 + wh, 300:300 + ww],
                         0.0, ww - 1.0, 0.0, wh - 1.0)
        for fused, ref, k, kind in ((wf.fill_idw_fused, wf.fill_idw_fused_ref, 8, "idw"),
                                    (wf.fill_mean_fused, wf.fill_mean_fused_ref, 4, "mean")):
            got = fused(gw, k=k, max_radius=R, keep_observed=True)
            e = close_planes(got, ref(gw, k=k, max_radius=R, keep_observed=True),
                             f"B3 {kind} vs plain, {wh}x{ww} window view, keep_observed", B3_RTOL, B3_ATOL)
            obs = gw.valid > 0.5
            if not torch.equal(got[obs], gw.elev[obs]):
                raise AssertionError(f"B3 {kind} keep_observed: an observed cell lost its value")
            b3_err[kind] = max(b3_err[kind], e)
            say("B3", f"{wh}x{ww} window view (row stride {gw.elev.stride(0)}) R={R} keep_observed: "
                f"{kind} max |kernel - plain| {e:.6g} m; observed cells kept")
    from auvtpu_torch.ops.dense import _slots_at
    from auvtpu_torch.tables import sorted_offsets

    # B4's own path (launch counts from here to the slot gather): the
    # slot-index selection over the plane, its slots read at the masked cells
    wf.reset_launches()
    cnt4, idx4 = wf.topk_idx(grid2, k=4, max_radius=10)
    flat2 = rows2.long() * grid2.num_lon + cols2.long()
    vals4, dxs4, dys4 = _slots_at(grid2, idx4, flat2, 10)
    torch.cuda.synchronize()
    launches_b4 = dict(wf.LAUNCHES)
    if launches_b4["topk_idx"] < 1:
        raise AssertionError("kernel topk_idx was not launched on its path")
    full = wf.topk_full(grid2, k=4, max_radius=10)
    live_at = cnt4.reshape(-1)[flat2][:, None] > torch.arange(4, device=dev)
    want_v = torch.stack([v.reshape(-1)[flat2] for v in full[1]], dim=1)
    want_dx = torch.stack([d.reshape(-1)[flat2] for d in full[2]], dim=1)
    want_dy = torch.stack([d.reshape(-1)[flat2] for d in full[3]], dim=1)
    if not (torch.equal(vals4, want_v) and torch.equal(dxs4[live_at], want_dx[live_at])
            and torch.equal(dys4[live_at], want_dy[live_at])):
        raise AssertionError("B4 path: slots at the masked cells differ from B2's")
    say("B4", f"path: topk_idx + slot gather at {flat2.numel()} masked cells (r0.20) equal to B2's "
        f"values and offsets at every live slot; launches {launches_b4}")
    b4_err = 0.0
    for label, g, R, conv, k in (("stand-in r0.20", grid2, 10, "reference", 4),
                                 ("256x320 R=5 centered", sg, 5, "centered", 7)):
        if g is grid2:
            cnt_k, idx_k = cnt4, idx4  # the path's own output
        else:
            cnt_k, idx_k = wf.topk_idx(g, k=k, max_radius=R, convention=conv)
        cnt_p, idx_p = wf.topk_idx_ref(g, k=k, max_radius=R, convention=conv)
        full = wf.topk_full(g, k=k, max_radius=R, convention=conv)
        torch.cuda.synchronize()
        b4_err = max(b4_err, float((cnt_k - cnt_p).abs().max()),
                     *(float((a - b).abs().max()) for a, b in zip(idx_k, idx_p)))
        if not (torch.equal(cnt_k, cnt_p) and torch.equal(cnt_k, full[0])):
            raise AssertionError(f"B4 {label}: counts differ from plain or from B2")
        dxs, dys, _ = sorted_offsets(R, conv)
        tdx = torch.as_tensor(dxs, dtype=torch.float32, device=dev)
        tdy = torch.as_tensor(dys, dtype=torch.float32, device=dev)
        for s_ in range(k):
            if not torch.equal(idx_k[s_], idx_p[s_]):
                raise AssertionError(f"B4 {label}: slot {s_} indices differ at {int((idx_k[s_] != idx_p[s_]).sum())} cells")
            live = cnt_k > s_
            ii = idx_k[s_][live].long()
            if not (torch.equal(tdx[ii], full[2][s_][live]) and torch.equal(tdy[ii], full[3][s_][live])):
                raise AssertionError(f"B4 {label}: slot {s_} decodes to other offsets than B2's")
            if not bool((idx_k[s_][~live] == -1).all()):
                raise AssertionError(f"B4 {label}: slot {s_} empty slots are not -1")
        say("B4", f"{label} k={k} {conv}: cnt and index planes exactly equal to plain; "
            f"decoded offsets equal to B2's at every live slot")
    del full, cnt_k, idx_k, cnt_p, idx_p, cnt4, idx4, vals4, dxs4, dys4

    # ---- 9. Grid B through the CLI (launch counts from here to the end of
    # the phase)
    from auvtpu_torch.cli import bench_grid_b

    res_csv = os.path.join(REPO, "results_local", "chip_smoke_grid_b.csv")
    if os.path.exists(res_csv):
        os.remove(res_csv)
    base = ["--region", "kerguelen", "--results", res_csv, "--machine", "H100"]
    wf.reset_launches()
    grid_b = {
        r: bench_grid_b.main(base + ["--removal", str(r), "--backend", "auto",
                                     "--methods", "Bilinear", "Cubic", "Kriging", "IDW"])
        for r in (0.10, 0.20)
    }
    launches_b = dict(wf.LAUNCHES)
    for r, summary in grid_b.items():
        for method, m in summary.items():
            want, tol = GRID_B_RMSE[r][method], GRID_B_TOL[method]
            if not abs(m["RMSE"] - want) <= tol:
                raise AssertionError(f"Grid B r{r} {method}: RMSE {m['RMSE']} outside {want} +- {tol}")
        cov = summary["Bilinear"]["coverage"]
        if not abs(cov - GRID_B_COVERAGE[r]) <= 1e-6:
            raise AssertionError(f"Grid B r{r}: bilinear coverage {cov} outside {GRID_B_COVERAGE[r]} +- 1e-6")
        say("gridB", f"r{r}: " + ", ".join(f"{k} RMSE {v['RMSE']:.6f}" for k, v in summary.items())
            + f"; bilinear coverage {cov:.8f}")
    say("gridB", f"launches {launches_b}")
    # Kriging at the masked cells (10 and 20 %) is B19's
    for k in ("fill_idw_fused", "fill_mean_fused", "kriging_at_cells_fused"):
        if launches_b[k] < 1:
            raise AssertionError(f"kernel {k} was not launched on the Grid B path")

    # ---- 10. streaming (launch counts from here to the uncertainty window)
    from auvtpu_torch.cli.stream_demo import survey
    from auvtpu_torch.config import Extent
    from auvtpu_torch.streaming import StreamingInterpolator
    from auvtpu_torch.synthetic import shelf_seamount

    H, W = STREAM["shape"]
    s_truth = shelf_seamount(H, W)

    def window_rmse(tile, origin):
        t = tile.double().cpu().numpy()
        r0, c0 = origin
        want = s_truth[r0:r0 + t.shape[0], c0:c0 + t.shape[1]]
        fin = np.isfinite(t)
        d = t[fin] - want[fin]
        return float(np.sqrt(np.mean(d * d))), int(fin.sum())

    t_stream = time.perf_counter()
    wf.reset_launches()
    kv.reset_launches()
    si = StreamingInterpolator((H, W), Extent(0.0, W - 1.0, 0.0, H - 1.0), window=(256, 256),
                               method="idw", max_radius=5)
    if si.backend != "fused":
        raise AssertionError(f"streaming backend auto resolved to {si.backend} on {si.device}")
    st = survey(si, s_truth, **{k: v for k, v in STREAM.items() if k != "shape"})
    snap = si.snapshot()
    n_cells, nsum = int(np.isfinite(snap).sum()), float(np.nansum(snap))
    say("stream", f"{st['n_obs']} soundings in {STREAM['steps']} swaths: {n_cells} observed cells, "
        f"f64 nansum {nsum!r}")
    if n_cells != STREAM_OBSERVED or nsum != STREAM_NANSUM:
        raise AssertionError(f"mosaic differs from the JAX package's: {n_cells} cells, nansum {nsum!r} "
                             f"(want {STREAM_OBSERVED}, {STREAM_NANSUM!r})")
    del snap
    windows = {}
    for method in ("idw", "mean", "kriging"):
        si.method = method
        windows[method], origin = si.window_fill(2048, 2048)
        r, n_fin = window_rmse(windows[method], origin)
        say("stream", f"window {method:7s} at (2048, 2048), origin {origin}: {n_fin} finite, RMSE {r:.6f} m")
        if n_fin != STREAM_WINDOW_FINITE or not abs(r - STREAM_RMSE[method]) <= STREAM_TOL:
            raise AssertionError(f"window {method}: {n_fin} finite, RMSE {r} (want {STREAM_WINDOW_FINITE}, "
                                 f"{STREAM_RMSE[method]} +- {STREAM_TOL})")
        # the plain versions on the same mosaic (they launch no kernel)
        si.backend = "torch"
        plain, _ = si.window_fill(2048, 2048)
        si.backend = "fused"
        bar = (RTOL, ATOL) if method == "kriging" else (B3_RTOL, B3_ATOL)
        e = close_planes(windows[method], plain, f"stream window {method} fused vs torch", *bar)
        if method != "kriging":
            b3_err[method] = max(b3_err[method], e)
        say("stream", f"window {method:7s} fused vs torch: max |diff| {e:.6g} m")
    si.method = "idw"
    tile, origin = si.window_fill(*st["last"])
    r, n_fin = window_rmse(tile, origin)
    say("stream", f"window idw at the last position {st['last']}, origin {origin}: {n_fin} finite, RMSE {r:.6f} m")
    if (origin, n_fin) != STREAM_LAST[:2] or not abs(r - STREAM_LAST[2]) <= STREAM_TOL:
        raise AssertionError(f"last window: origin {origin}, {n_fin} finite, RMSE {r} (want {STREAM_LAST})")
    vp = [float(v) for v in si.fit_variogram()]
    var, _ = si.window_uncertainty(2048, 2048)
    launches_s = {**wf.LAUNCHES, **kv.LAUNCHES}
    fin = torch.isfinite(var)
    n_var = int(fin.sum())
    say("stream", f"fitted variogram {vp}; uncertainty window: {n_var} finite, min {float(var[fin].min()):.6g}; "
        f"launches {launches_s}")
    if not all(np.isfinite(p) and p > 0 for p in vp):
        raise AssertionError(f"streaming fit not finite and positive: {vp}")
    if n_var < 0.99 * STREAM_VAR_FINITE or not bool((var[fin] >= 0).all()):
        raise AssertionError(f"uncertainty window: {n_var} finite cells (want >= 99 % of {STREAM_VAR_FINITE}), all >= 0")
    for k in ("fill_idw_fused", "fill_mean_fused", "fill_kriging_fused", "pair_sums", "fit_model"):
        if launches_s[k] < 1:
            raise AssertionError(f"kernel {k} was not launched on the streaming path")
    si.backend = "torch"
    var_t, _ = si.window_uncertainty(2048, 2048)
    e = close_planes(var, var_t, "stream uncertainty fused vs torch")
    say("stream", f"uncertainty fused vs torch: max |diff| {e:.6g}; phase took "
        f"{time.perf_counter() - t_stream:.1f} s")

    # ---- 11. timing of this slice
    def refresh_ms(backend: str, reps: int = 20) -> float:
        """Host clock per window refresh, result on the host."""
        si.backend, si.method = backend, "idw"
        for _ in range(2):
            si.window_fill(2048, 2048)[0].cpu()
        t0 = time.perf_counter()
        for _ in range(reps):
            si.window_fill(2048, 2048)[0].cpu()
        return (time.perf_counter() - t0) * 1e3 / reps

    # the streaming refresh (idw and mean) is one B3 launch on the window's
    # views: no NaN-padded plane, no torch pass (launch counts, and the
    # profiler's device kernels of one refresh)
    for method in ("idw", "mean"):
        si.backend, si.method = "fused", method
        wf.reset_launches()
        si.window_fill(2048, 2048)
        if sum(wf.LAUNCHES.values()) != 1 or wf.LAUNCHES[f"fill_{method}_fused"] != 1:
            raise AssertionError(f"window refresh {method}: launches {wf.LAUNCHES}, want one B3 launch")
        seen = only_kernel(lambda: si.window_fill(2048, 2048)[0].cpu(), "fill_tile_kernel",
                           f"window refresh {method}")
        say("stream", f"window refresh {method}: one B3 launch; the device kernels of 20 refreshes, with the "
            f"records the profiler kept: {seen}")
    ms.update({
        "B3 idw k=8": device_ms(b3_launcher(grid2, 0, 8), "fill_tile_kernel"),
        "B3 idw k=8 cold": device_ms(b3_launcher(grid2, 0, 8), "fill_tile_kernel", cold=True),
        "B3 idw k=8 wrapper": time_ms(lambda: wf.fill_idw_fused(grid2, k=8)),
        "B3 idw k=8 plain": time_ms(lambda: wf.fill_idw_fused_ref(grid2, k=8)),
        "B3 mean k=4": device_ms(b3_launcher(grid2, 1, 4), "fill_tile_kernel"),
        "B3 mean k=4 cold": device_ms(b3_launcher(grid2, 1, 4), "fill_tile_kernel", cold=True),
        "B3 mean k=4 wrapper": time_ms(lambda: wf.fill_mean_fused(grid2, k=4)),
        "B3 mean k=4 plain": time_ms(lambda: wf.fill_mean_fused_ref(grid2, k=4)),
        "B4 k=4": device_ms(lambda: wf.topk_idx(grid2, k=4), "topk_idx_kernel"),
        "B4 k=4 wrapper": time_ms(lambda: wf.topk_idx(grid2, k=4)),
        "B4 k=4 plain": time_ms(lambda: wf.topk_idx_ref(grid2, k=4)),
        "window refresh fused": refresh_ms("fused"),
        "window refresh torch": refresh_ms("torch"),
    })
    for label in ("B3 idw k=8", "B3 mean k=4"):
        say("timing", f"stand-in r0.20 {label:12s} kernel alone {ms[label]:.4f} ms back to back, "
            f"{ms[label + ' cold']:.4f} ms cold; wrapper {ms[label + ' wrapper']:.4f} ms; plain "
            f"{ms[label + ' plain']:.4f} ms  [{card}]")
    say("timing", f"stand-in r0.20 B4 k=4       kernel alone {ms['B4 k=4']:.4f} ms; wrapper {ms['B4 k=4 wrapper']:.4f} "
        f"ms; plain {ms['B4 k=4 plain']:.4f} ms  [{card}]")
    for r, summary in grid_b.items():
        for method, m in summary.items():
            say("timing", f"Grid B r{r} {method:8s} steady {m['steady_ms']:.4f} ms "
                f"({m['n'] / m['steady_ms'] / 1e3:.3f} M masked pts/s), end-to-end {m['e2e_ms']:.3f} ms  [{card}]")
    say("timing", f"streaming ingest {st['n_obs'] / st['t_ingest'] / 1e6:.3f} M obs/s; survey refresh "
        f"{st['t_fill'] / st['n_fills'] * 1e3:.4f} ms ({st['n_fills']} refreshes); window refresh at "
        f"(2048, 2048) fused {ms['window refresh fused']:.4f} ms, torch {ms['window refresh torch']:.4f} ms  [{card}]")
    say("timing", f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB")

    del si, windows, plain, var, var_t, tile, sg
    torch.cuda.empty_cache()

    # ---- 12. B5/B6/B7 vs their plain versions on Grid A and the stand-in
    from auvtpu_torch.cli import bench_grid_a
    from auvtpu_torch.config import GRID_A_EXTENT, GRID_A_SHAPE, KERGUELEN_EXTENT, IDWConfig
    from auvtpu_torch.golden import GoldenGrid, GoldenV2
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.kernels import valid_select as vs
    from auvtpu_torch.ops import TwoTierInterpolator
    from auvtpu_torch.ops import packs as tp

    t_sc = time.perf_counter()
    a_elev = shelf_seamount(*GRID_A_SHAPE)
    gA = RegularGrid.dense(a_elev, GRID_A_EXTENT, device=dev)
    qA = scattered_queries(GRID_A_EXTENT, *GRID_A_SHAPE, N_SCATTER, 7, dev)
    qK = scattered_queries(KERGUELEN_EXTENT, *SHAPE, N_SCATTER, 8, dev)
    p16 = tp.build_valid16_pack(gA)
    sc_err = {"select_rows": 0.0, "idw_rows": 0.0, "window_select_fused": 0.0, "select_krige": 0.0,
              "window_krige": 0.0, "window_idw": 0.0}
    for label, g, (lo, la), p16_, ext, shape in (("Grid A", gA, qA, p16, GRID_A_EXTENT, GRID_A_SHAPE),
                                                 ("stand-in r0.10", grid, qK, None, KERGUELEN_EXTENT, SHAPE)):
        win, cases = select_cases(g, p16_)
        # the phase's queries and, for the kernels alone, NaN/inf/1e30 and
        # out-of-grid ones (on a NaN query no slot is taken; B7's d2 row is NaN)
        odd = odd_queries(ext, *shape, dev)
        lines = line_queries(ext, *shape, dev)
        odd = (torch.cat([odd[0], lines[0]]), torch.cat([odd[1], lines[1]]))
        _, _, _, _, _, cell, fx, fy = ss.prologue(g, torch.cat([lo, odd[0]]), torch.cat([la, odd[1]]))
        for kname, pack, P, offs, radius, mode, layout, kw in cases:
            tab = ss.table(offs, P, radius, layout, dev)
            a = ss.select(pack, P, cell, fx, fy, tab, mode=mode, **kw)
            b = ss.select_ref(pack, P, cell, fx, fy, tab, mode=mode, **kw)
            torch.cuda.synchronize()
            sc_err[kname] = max(sc_err[kname], same_planes(a, b, f"{kname} {mode} {kw} radius {radius} at {label}"))
            say("B5 B7", f"{label} radius {radius} P={P} {kname} ({mode}, {kw}): {tuple(a.shape)} exactly equal "
                f"to plain, {odd[0].numel()} NaN/inf/1e30/out-of-grid/node/half-node queries included")
            del a, b
        # B11 on the same queries: the valid16 pack (Grid A's auto path), the
        # radius-2 pack with the resolved row (two-tier's), and the four
        # models with fitted parameters on the card
        lo_o, la_o = torch.cat([lo, odd[0]]), torch.cat([la, odd[1]])
        offs2 = tp.window_offsets(2)
        krige_cases = [("radius 2", win, 32, offs2, dict(resolve_thresh=4.0))]
        if p16_ is not None:
            krige_cases.insert(0, ("valid16", p16_, 16, tp.VALID16_OFFSETS, {}))
            krige_cases += [(f"radius 2 {m}", win, 32, offs2, dict(model=m, vparams=tuple(
                torch.tensor(v, device=dev) for v in MODEL_VPARAMS[m]))) for m in MODEL_VPARAMS]
        for what, pack, P, offs, kw in krige_cases:
            a = ss.select_krige(pack, P, offs, 2, g, lo_o, la_o, **kw)
            b = ss.select_krige_ref(pack, P, offs, 2, g, lo_o, la_o, **kw)
            torch.cuda.synchronize()
            sc_err["select_krige"] = max(sc_err["select_krige"], same_planes(a, b, f"select_krige {what} at {label}"))
            say("B11", f"{label} {what} select_krige ({ {k: v for k, v in kw.items() if k != 'vparams'} }): "
                f"{tuple(a.shape)} bit-equal to plain, {odd[0].numel()} NaN/inf/1e30/out-of-grid/node/half-node "
                f"queries included ({int(torch.isnan(a[0]).sum())} NaN)")
            del a, b
        # B6 and B12 on the same queries: the window IDW (Grid A's and
        # two-tier's, k=8, with and without the resolved row; every tap,
        # centered) and the fused window kriging (the four models with
        # fitted parameters on Grid A, the default on the stand-in)
        for what, kw in (("k=8", dict(k=8)), ("k=8 resolved", dict(k=8, resolve_thresh=4.0)),
                         ("k=25 centered", dict(k=25, convention="centered"))):
            a = ss.idw_select(win, 32, offs2, 2, g, lo_o, la_o, **kw)
            b = ss.idw_select_ref(win, 32, offs2, 2, g, lo_o, la_o, **kw)
            torch.cuda.synchronize()
            sc_err["idw_rows"] = max(sc_err["idw_rows"], same_planes(a, b, f"idw_select {what} at {label}"))
            say("B6", f"{label} radius 2 idw_select {what}: {tuple(a.shape)} bit-equal to plain, {odd[0].numel()} "
                f"NaN/inf/1e30/out-of-grid/node/half-node queries included ({int(torch.isnan(a[0]).sum())} NaN)")
            del a, b
        models = [(m, tuple(torch.tensor(v, device=dev) for v in MODEL_VPARAMS[m])) for m in MODEL_VPARAMS]
        for model, vp in ([("exponential", None)] + (models if p16_ is not None else [])):
            a = ss.window_krige(win, 32, offs2, 2, g, lo_o, la_o, model=model, vparams=vp)
            b = ss.window_krige_ref(win, 32, offs2, 2, g, lo_o, la_o, model=model, vparams=vp)
            torch.cuda.synchronize()
            what = model + (" fitted" if vp is not None else "")
            sc_err["window_krige"] = max(sc_err["window_krige"], same_planes(a, b, f"window_krige {what} at {label}"))
            say("B12", f"{label} radius 2 window_krige {what}: {tuple(a.shape)} bit-equal to plain, "
                f"{odd[0].numel()} NaN/inf/1e30/out-of-grid/node/half-node queries included "
                f"({int(torch.isnan(a).sum())} NaN)")
            del a, b
        # B15 on the same queries: B7's top-k with the IDW weights and the
        # quotient (the fused path's IDW); on the stand-in radius 1-3, an
        # aligned pack and one 4 bytes off, k 1, 4, 8 and P, powers 2, 1
        # and 3; on Grid A radius 2, k 8, both packs and those powers
        packs_r = {c[4]: (c[1], c[2], c[3]) for c in cases if c[0] == "window_select_fused"}
        idw_cases = b15_cases(full=p16_ is None)
        sc_err["window_idw"] = max(sc_err["window_idw"], b15_equal(g, packs_r, lo_o, la_o, idw_cases, label))
        say("B15", f"{label} window_idw: {len(idw_cases)} cases (radius, aligned or 4 bytes off, k, power "
            f"{'/'.join(f'{p:g}' for p in B15_POWERS)}) bit-equal to plain, {odd[0].numel()} "
            f"NaN/inf/1e30/out-of-grid/node/half-node queries included")
        del packs_r
        pairs = [
            ("B11 packed_kriging_t", vs.packed_kriging_t(win, g, lo, la), tp.packed_kriging(win, g, lo, la)),
            ("B6 packed_idw_t", vs.packed_idw_t(win, g, lo, la), tp.packed_idw(win, g, lo, la)),
            ("B12 packed_kriging_fused", ss.packed_kriging_fused(win, g, lo, la), tp.packed_kriging(win, g, lo, la)),
            ("B15 packed_idw_fused", ss.packed_idw_fused(win, g, lo, la), tp.packed_idw(win, g, lo, la)),
        ]
        if p16_ is not None:
            pairs.insert(0, ("B11 kriging_valid_t", vs.kriging_valid_t(p16_, g, lo, la),
                             tp.packed_kriging_valid(p16_, g, lo, la)))
        for what, got, want in pairs:
            e = close_planes(got, want, f"{what} vs torch at {label}", SCATTER_RTOL, SCATTER_ATOL)
            say("B5-B11", f"{label} {what} vs the torch packed path: max |diff| {e:.6g} m "
                f"({int(torch.isnan(got).sum())} NaN)")
        del win, cases, pairs
    del p16
    torch.cuda.empty_cache()

    # ---- 13. Grid A through the CLI (launch counts from here to the end of
    # each run)
    res_a = os.path.join(REPO, "results_local", "chip_smoke_grid_a.csv")
    if os.path.exists(res_a):
        os.remove(res_a)
    base_a = ["--results", res_a, "--machine", "H100", "--methods", "Bilinear", "Cubic", "Kriging", "IDW"]
    ss.reset_launches()
    grid_a = bench_grid_a.main(base_a + ["--backend", "auto", "--batch-sizes", *map(str, GRID_A_BATCHES)])
    launches_a = dict(ss.LAUNCHES)
    ss.reset_launches()
    grid_a_fused = bench_grid_a.main(base_a + ["--backend", "fused", "--batch-sizes", str(N_SCATTER)])
    launches_af = dict(ss.LAUNCHES)
    n_valid = sum(v["validated"] is not None for v in grid_a.values()) + sum(
        v["validated"] is not None for v in grid_a_fused.values())
    if not all(v["validated"] in (True, None) for v in (*grid_a.values(), *grid_a_fused.values())):
        raise AssertionError("a Grid A validation failed")
    say("gridA", f"{n_valid} validations against the golden engines PASSED; launches auto {launches_a}, "
        f"fused {launches_af}")
    if launches_a["select_krige"] < 1 or launches_a["idw_rows"] < 1 or launches_a["select_rows"]:
        raise AssertionError(f"B11 and B6 (and no B5) were not launched on the Grid A auto path: {launches_a}")
    if launches_af["window_idw"] < 1 or launches_af["window_krige"] < 1 or launches_af["window_select_fused"]:
        raise AssertionError(f"B15 (IDW) and B12 (kriging) (and no B7) were not launched on the Grid A fused path: "
                             f"{launches_af}")
    # B5's entry point: the valid16 select dict at the 1M Grid A queries
    p16 = tp.build_valid16_pack(gA)
    ss.reset_launches()
    sel_v = vs.valid_select_t(p16, gA, *qA)
    torch.cuda.synchronize()
    launches_v = dict(ss.LAUNCHES)
    if launches_v["select_rows"] != 1 or not bool((sel_v["found"] == 4).all()):
        raise AssertionError(f"valid_select_t: {launches_v}, {int((sel_v['found'] != 4).sum())} queries short of 4")
    say("gridA", f"valid_select_t at {qA[0].numel()} Grid A queries: 4 found at each; launches {launches_v}")
    del p16, sel_v
    # B7's entry point: the radius-2 window select dict at the same queries
    win_v = tp.build_pack(gA, tp.window_offsets(2), clamp=False)[0]
    ss.reset_launches()
    sel_w = ss.window_select_fused(win_v, gA, *qA, k=8)
    torch.cuda.synchronize()
    launches_w7 = dict(ss.LAUNCHES)
    if launches_w7["window_select_fused"] != 1 or not bool((sel_w["found"] == 8).all()):
        raise AssertionError(f"window_select_fused: {launches_w7}, {int((sel_w['found'] != 8).sum())} queries "
                             f"short of 8")
    say("gridA", f"window_select_fused at {qA[0].numel()} Grid A queries: 8 found at each; launches {launches_w7}")
    del win_v, sel_w
    # query coordinates: the scattered ops' multiply by the reciprocal
    # steps (as the jitted JAX ops), the mission path's division by the
    # grid's 0-d step tensors (as its JAX callers, outside any jit): on the
    # card they equal the CPU's bit for bit
    from auvtpu_torch.ops.band import _xy
    from auvtpu_torch.ops.scattered import _normalize

    gA_cpu = RegularGrid.dense(a_elev, GRID_A_EXTENT, device="cpu")
    lines = line_queries(GRID_A_EXTENT, *GRID_A_SHAPE, dev)
    qL = tuple(torch.cat([q, l_]) for q, l_ in zip(qA, lines))
    qL_cpu = tuple(q.cpu() for q in qL)
    for what, fn in (("_normalize", _normalize), ("lonlat_to_xy", RegularGrid.lonlat_to_xy), ("_xy", _xy)):
        if not all(torch.equal(a.cpu(), b) for a, b in zip(fn(gA, *qL), fn(gA_cpu, *qL_cpu))):
            raise AssertionError(f"{what}: the card's Grid A coordinates differ from the CPU's")
    say("gridA", f"_normalize, lonlat_to_xy and _xy at {qL[0].numel()} Grid A queries (nodes and half-nodes "
        f"included): the card's coordinates equal the CPU's bit for bit")
    del gA_cpu, qL, qL_cpu, lines
    golden_a, golden_v2 = (cls(a_elev, GRID_A_EXTENT.min_lon, GRID_A_EXTENT.max_lon, GRID_A_EXTENT.min_lat,
                               GRID_A_EXTENT.max_lat) for cls in (GoldenGrid, GoldenV2))
    lo_h, la_h = (q[:N_GOLDEN].double().cpu().numpy() for q in qA)
    goldens = {"Bilinear": golden_a.bilinear(lo_h, la_h), "Cubic": golden_a.cubic(lo_h, la_h),
               "Kriging": golden_v2.kriging(lo_h, la_h), "IDW": golden_v2.idw(lo_h, la_h, k=8)}
    for backend in ("auto", "fused"):
        ops_a, path = bench_grid_a.make_ops(gA, a_elev, packed=True, backend=backend, window_radius=2)
        errs = {m: golden_check(fn(gA, qA[0][:N_GOLDEN], qA[1][:N_GOLDEN]), goldens[m], f"Grid A {m} {backend}")
                for m, fn in ops_a.items()}
        say("gridA", f"--backend {backend} ({path}): {N_GOLDEN} queries vs GoldenGrid/GoldenV2, max |diff| "
            + ", ".join(f"{m} {e:.3g}" for m, e in errs.items()) + f" m (bar {GOLDEN_TOL} x scale)")
        del ops_a
    torch.cuda.empty_cache()

    # ---- 14. TwoTierInterpolator on the stand-in r0.10 (launch counts around
    # the two calls)
    ss.reset_launches()
    tt = TwoTierInterpolator(grid)
    if tt.backend != "transposed":
        raise AssertionError(f"TwoTierInterpolator auto resolved to {tt.backend} on {grid.device}")
    tt_k = tt.kriging(*qK)
    tt_i = tt.idw(*qK)
    torch.cuda.synchronize()
    launches_t = dict(ss.LAUNCHES)
    if launches_t["select_krige"] < 1 or launches_t["idw_rows"] < 1 or launches_t["select_rows"]:
        raise AssertionError(f"B11 and B6 (and no B5) were not launched on the two-tier path: {launches_t}")
    ref_tt = TwoTierInterpolator(grid, backend="torch")
    e_k = close_planes(tt_k, ref_tt.kriging(*qK), "two-tier kriging vs torch", *TT_BARS["kriging"])
    e_i = close_planes(tt_i, ref_tt.idw(*qK), "two-tier idw vs torch", *TT_BARS["idw"])
    esc = {k: int(tt._resolved_mask(*qK, k)[1]) / qK[0].numel() for k in (4, 8)}
    say("twotier", f"stand-in r0.10, {qK[0].numel()} queries, backend {tt.backend}: vs torch max |diff| "
        f"kriging {e_k:.6g} m, idw {e_i:.6g} m; escalated fraction k=4 {esc[4]:.3g}, k=8 {esc[8]:.3g}; "
        f"launches {launches_t}")
    # the golden check on the stand-in's cells with unit steps, where float32
    # coordinates are exact (on the Kerguelen extent they move a query by up
    # to ~1e-3 cells, which flips near-tied neighbours; printed below), and
    # with an 11x11 hole whose queries escalate
    red = grid.to_nan_array()
    Hs, Ws = SHAPE
    hole = red.copy()
    hole[1000:1011, 1200:1211] = np.nan
    unit = Extent(0.0, Ws - 1.0, 0.0, Hs - 1.0)
    gu = RegularGrid.from_nan_array(hole, unit, device=dev)
    qu = scattered_queries(unit, Hs, Ws, N_GOLDEN, 9, dev)
    qu = tuple(torch.cat([q, torch.tensor(v, device=dev)]) for q, v in zip(qu, ([1205.0, 1205.4], [1005.0, 1004.6])))
    ttu = TwoTierInterpolator(gu)
    gv_u = GoldenV2(hole, 0.0, Ws - 1.0, 0.0, Hs - 1.0)
    qu_h = [q.double().cpu().numpy() for q in qu]
    n_esc = int(ttu._resolved_mask(*qu, 4)[1])
    if n_esc < 2:
        raise AssertionError(f"the hole queries did not escalate ({n_esc})")
    g_k = golden_check(ttu.kriging(*qu), gv_u.kriging(*qu_h), "two-tier kriging vs GoldenV2")
    g_i = golden_check(ttu.idw(*qu), gv_u.idw(*qu_h, k=8), "two-tier idw vs GoldenV2")
    gv_k = GoldenV2(red, KERGUELEN_EXTENT.min_lon, KERGUELEN_EXTENT.max_lon, KERGUELEN_EXTENT.min_lat,
                    KERGUELEN_EXTENT.max_lat)
    qk_h = [q[:N_GOLDEN].double().cpu().numpy() for q in qK]
    ext_i = float(np.nanmax(np.abs(tt_i[:N_GOLDEN].double().cpu().numpy() - gv_k.idw(*qk_h, k=8))))
    ext_k = float(np.nanmax(np.abs(tt_k[:N_GOLDEN].double().cpu().numpy() - gv_k.kriging(*qk_h))))
    say("twotier", f"unit-step stand-in with a hole, {qu[0].numel()} queries ({n_esc} escalated) vs GoldenV2: "
        f"max |diff| kriging {g_k:.6g} m, idw {g_i:.6g} m (bar {GOLDEN_TOL} x scale); on the Kerguelen "
        f"extent (float32 coordinates, not gated): kriging {ext_k:.6g} m, idw {ext_i:.6g} m")
    say("twotier", f"phases 12-14 took {time.perf_counter() - t_sc:.1f} s")

    # ---- 15. timing of the scattered slice: kernel alone and plain on the
    # phase-12 inputs, the wrappers, the Grid A CLI's steady state
    _, _, oobA, _, _, cellA, fxA, fyA = ss.prologue(gA, *qA)
    offs2 = tp.window_offsets(2)
    p16 = tp.build_valid16_pack(gA)
    winA, _ = tp.build_pack(gA, tp.window_offsets(2), clamp=False)
    tab16 = ss.table(tp.VALID16_OFFSETS, 16, 2, "dy", dev)
    # the queries B11 solves: four found (the plain selection) in the grid
    n_solved = float(((ss.select_ref(p16, 16, cellA, fxA, fyA, tab16, mode="rows_t", k=4)[0] == 4) & ~oobA).sum())
    tab32 = ss.table(tp.window_offsets(2), 32, 2, "dy", dev)
    tab32n = ss.table(tp.window_offsets(2), 32, 2, "dx", dev)
    # the queries B12 solves: four found by B7's plain selection, in the grid
    n_solved_w = float(((ss.select_ref(winA, 32, cellA, fxA, fyA, tab32n, mode="rows_n", k=4)[:, 0] == 4)
                        & ~oobA).sum())
    sel_args = {
        "select_rows": (p16, 16, cellA, fxA, fyA, tab16, dict(mode="rows_t", k=4)),
        "window_select_fused": (winA, 32, cellA, fxA, fyA, tab32n, dict(mode="rows_n", k=4)),
    }
    names = {"select_rows": "select_kernel", "window_select_fused": "window_select_kernel"}
    launchers = {"window_select_fused": b7_launcher}
    for kname, (pk, P, c_, x_, y_, t_, kw) in sel_args.items():
        ms[f"{kname} alone"] = device_ms(lambda: ss.select(pk, P, c_, x_, y_, t_, **kw), names[kname])
        if kname in launchers:
            ms[f"{kname} alone cold"] = device_ms(launchers[kname](pk, P, c_, x_, y_, t_, kw["k"]), names[kname],
                                                  cold=True)
        ms[f"{kname} wrapper"] = time_ms(lambda: ss.select(pk, P, c_, x_, y_, t_, **kw))
        ms[f"{kname} plain"] = time_ms(lambda: ss.select_ref(pk, P, c_, x_, y_, t_, **kw), reps=5)
        cold = f" ({ms[kname + ' alone cold']:.4f} cold)" if kname in launchers else ""
        say("timing", f"Grid A {N_SCATTER} queries {kname:20s} kernel alone {ms[kname + ' alone']:.4f} ms{cold}, "
            f"wrapper {ms[kname + ' wrapper']:.4f} ms, plain {ms[kname + ' plain']:.4f} ms  [{card}]")
    # B11 at 5M Grid A queries, the odd, node and half-node ones included:
    # bit for bit (valid16; radius 2 with the resolved row)
    qA5 = scattered_queries(GRID_A_EXTENT, *GRID_A_SHAPE, 5 * N_SCATTER, 9, dev)
    odd5 = [torch.cat(t) for t in zip(odd_queries(GRID_A_EXTENT, *GRID_A_SHAPE, dev),
                                       line_queries(GRID_A_EXTENT, *GRID_A_SHAPE, dev))]
    q5 = tuple(torch.cat([q, o]) for q, o in zip(qA5, odd5))
    for what, pk, P, offs, kw in (("valid16", p16, 16, tp.VALID16_OFFSETS, {}),
                                  ("radius 2", winA, 32, tp.window_offsets(2), dict(resolve_thresh=4.0))):
        a_ = ss.select_krige(pk, P, offs, 2, gA, *q5, **kw)
        b_ = ss.select_krige_ref(pk, P, offs, 2, gA, *q5, **kw)
        torch.cuda.synchronize()
        sc_err["select_krige"] = max(sc_err["select_krige"], same_planes(a_, b_, f"select_krige {what} at 5M"))
        say("B11", f"Grid A {q5[0].numel()} queries {what} select_krige ({kw}): {tuple(a_.shape)} bit-equal to "
            f"plain, {odd5[0].numel()} NaN/inf/1e30/out-of-grid/node/half-node queries included")
        del a_, b_
    # B6 (with and without the resolved row) and B12 on the same queries
    for kname, fn, ref, kw in (("idw_rows", ss.idw_select, ss.idw_select_ref, dict(k=8)),
                               ("idw_rows", ss.idw_select, ss.idw_select_ref, dict(k=8, resolve_thresh=4.0)),
                               ("window_krige", ss.window_krige, ss.window_krige_ref, {})):
        a_ = fn(winA, 32, offs2, 2, gA, *q5, **kw)
        b_ = ref(winA, 32, offs2, 2, gA, *q5, **kw)
        torch.cuda.synchronize()
        sc_err[kname] = max(sc_err[kname], same_planes(a_, b_, f"{fn.__name__} {kw} at 5M"))
        say("B6 B12", f"Grid A {q5[0].numel()} queries radius 2 {fn.__name__} ({kw}): {tuple(a_.shape)} bit-equal "
            f"to plain, {odd5[0].numel()} NaN/inf/1e30/out-of-grid/node/half-node queries included")
        del a_, b_
    # B15 likewise: on Grid A radius 2, k 8, both packs and every power; on
    # the stand-in r0.10 at 5M queries radius 1-3 (k 8, power 2), the pack
    # 4 bytes off, and k 1, 4 and P at every power
    packs2 = {2: (winA, 32, offs2)}
    sc_err["window_idw"] = max(sc_err["window_idw"], b15_equal(gA, packs2, *q5, b15_cases(full=False), "Grid A 5M"))
    oddK5 = [torch.cat(t) for t in zip(odd_queries(KERGUELEN_EXTENT, *SHAPE, dev),
                                        line_queries(KERGUELEN_EXTENT, *SHAPE, dev))]
    qK5 = tuple(torch.cat([q, o]) for q, o in zip(scattered_queries(KERGUELEN_EXTENT, *SHAPE, 5 * N_SCATTER, 10, dev),
                                                  oddK5))
    packsK = {r: (tp.build_pack(grid, tp.window_offsets(r), clamp=False)[0], tp.pack_width(len(tp.window_offsets(r))),
                  tp.window_offsets(r)) for r in (1, 2, 3)}
    casesK5 = ([(r, True, 8, 2.0) for r in (1, 2, 3)] + [(2, False, 8, 2.0)]
               + [(2, True, k, p) for k in (1, 4, "P") for p in B15_POWERS])
    sc_err["window_idw"] = max(sc_err["window_idw"], b15_equal(grid, packsK, *qK5, casesK5, "stand-in 5M"))
    say("B15", f"window_idw at {q5[0].numel()} Grid A queries ({len(b15_cases(full=False))} cases) and "
        f"{qK5[0].numel()} stand-in r0.10 queries ({len(casesK5)} cases: radius 1-3, 4 bytes off, k 1, 4, 8 and P, "
        f"powers {'/'.join(f'{p:g}' for p in B15_POWERS)}) bit-equal to plain, NaN/inf/1e30/out-of-grid/node/"
        f"half-node queries included")
    del q5, odd5, qK5, oddK5, packsK
    # B6 and B12 alone (device duration) at 1M and 5M, B6 also cold, their
    # wrappers (the whole call: the kernel computes the query prologue) and
    # plain versions at 1M
    for kname, fn, ref, kern, kw in (("idw_rows", ss.idw_select, ss.idw_select_ref, "idw_select_kernel", dict(k=8)),
                                     ("window_krige", ss.window_krige, ss.window_krige_ref, "window_krige_kernel",
                                      {}),
                                     ("window_idw", ss.window_idw, ss.window_idw_ref, "window_idw_kernel",
                                      dict(k=8))):
        for tag, q_ in (("", qA), (" 5M", qA5)):
            ms[f"{kname}{tag} alone"] = device_ms(lambda: fn(winA, 32, offs2, 2, gA, *q_, **kw), kern)
        ms[f"{kname} wrapper"] = time_ms(lambda: fn(winA, 32, offs2, 2, gA, *qA, **kw))
        ms[f"{kname} plain"] = time_ms(lambda: ref(winA, 32, offs2, 2, gA, *qA, **kw), reps=5)
        if kname == "idw_rows":
            ms["idw_rows alone cold"] = device_ms(b6_launcher(winA, 32, tab32, gA, *qA, 8), kern, cold=True)
        cold = f" ({ms['idw_rows alone cold']:.4f} cold)" if kname == "idw_rows" else ""
        say("timing", f"Grid A {N_SCATTER} queries {kname:20s} kernel alone {ms[kname + ' alone']:.4f} ms{cold}, "
            f"at 5M {ms[kname + ' 5M alone']:.4f} ms; wrapper {ms[kname + ' wrapper']:.4f} ms, plain "
            f"{ms[kname + ' plain']:.4f} ms  [{card}]")
    # B15 at k 4 too (its own build)
    ms["window_idw k4 alone"] = device_ms(lambda: ss.window_idw(winA, 32, offs2, 2, gA, *qA, k=4), "window_idw_kernel")
    # each packed_idw_t and packed_kriging_fused call: one CUDA kernel
    # (every record of 20 profiled calls its kernel's) and no synchronising
    # call; its events, beside the torch prologue, B6's torch epilogue and
    # the torch solve after B7 that they no longer run
    nd = ss.select_ref(winA, 32, cellA, fxA, fyA, tab32, mode="idw", k=8)
    eps8 = IDWConfig(k=8).eps
    selA = ss.window_select_fused(winA, gA, *qA, k=4)
    gone = {"the torch prologue": lambda: ss.prologue(gA, *qA),
            "B6's torch epilogue": lambda: torch.where(oobA, float("nan"), torch.where(
                nd[1] > 0, nd[0] / torch.clamp(nd[1], min=eps8), float("nan"))),
            "the torch solve after B7 (kriging_from_select)": lambda: tp.kriging_from_select(gA, *qA, selA)}
    for what, fn in gone.items():
        n_k = sum(device_kernels(fn, reps=10).values()) / 10
        ms[f"no longer run: {what}"] = time_ms(fn, reps=10)
        say("timing", f"{N_SCATTER} Grid A queries, no longer run: {what} {ms[f'no longer run: {what}']:.4f} ms, "
            f"{n_k:.1f} CUDA kernels  [{card}]")
    del nd, selA
    entries = {"packed_idw_t": vs.packed_idw_t, "packed_kriging_fused": ss.packed_kriging_fused,
               "packed_idw_fused": ss.packed_idw_fused}
    for name, kern in (("packed_idw_t", "idw_select_kernel"), ("packed_kriging_fused", "window_krige_kernel"),
                       ("packed_idw_fused", "window_idw_kernel")):
        for tag, q_ in (("1M", qA), ("5M", qA5)):
            call = (lambda: entries[name](winA, gA, *q_))
            kept = only_kernel(call, kern, f"{name} at {tag}")
            torch.cuda.set_sync_debug_mode("error")
            try:
                call()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            ms[f"{name} {tag} events"] = time_ms(call, reps=20)
            say("timing", f"one {name} call at {q_[0].numel()} queries: {ms[f'{name} {tag} events']:.4f} ms events, "
                f"one CUDA kernel ({sum(kept.values())} {kern} records of 20 calls kept), no synchronising call  "
                f"[{card}]")
    # packed_idw_fused's events at 1M against the composition B15 replaced
    # (B7's select dict, then idw_from_select), in the same process: old,
    # new, new, old
    idw_calls = {"B15": lambda: ss.packed_idw_fused(winA, gA, *qA),
                 "old": lambda: tp.idw_from_select(ss.window_select_fused(winA, gA, *qA, k=8), power=2.0, eps=eps8)}
    idw_ev = [(name, time_ms(idw_calls[name], reps=20)) for name in ("old", "B15", "B15", "old")]
    n_old = sum(device_kernels(idw_calls["old"], reps=10).values()) / 10
    say("timing", f"packed_idw_fused at {N_SCATTER} queries, events (old, B15, B15, old): "
        + ", ".join(f"{t:.4f}" for _, t in idw_ev) + f" ms; the old composition (window_select_fused, "
        f"idw_from_select) ran {n_old:.1f} CUDA kernels a call  [{card}]")
    # B11 alone (device duration), its wrapper (the whole call: the kernel
    # computes the query prologue) and its plain version: valid16, Grid A's
    # auto path, and radius 2 with the resolved row, two-tier's; at 1M and 5M
    krige_args = {"select_krige": (p16, 16, tp.VALID16_OFFSETS, qA, {}),
                  "select_krige r2": (winA, 32, tp.window_offsets(2), qA, dict(resolve_thresh=4.0)),
                  "select_krige 5M": (p16, 16, tp.VALID16_OFFSETS, qA5, {})}
    for kname, (pk, P, offs, q_, kw) in krige_args.items():
        ms[f"{kname} alone"] = device_ms(lambda: ss.select_krige(pk, P, offs, 2, gA, *q_, **kw),
                                         "select_krige_kernel")
        ms[f"{kname} wrapper"] = time_ms(lambda: ss.select_krige(pk, P, offs, 2, gA, *q_, **kw))
        ms[f"{kname} plain"] = time_ms(lambda: ss.select_krige_ref(pk, P, offs, 2, gA, *q_, **kw), reps=5)
        say("timing", f"Grid A {q_[0].numel()} queries {kname:20s} kernel alone {ms[kname + ' alone']:.4f} ms, "
            f"wrapper {ms[kname + ' wrapper']:.4f} ms, plain {ms[kname + ' plain']:.4f} ms  [{card}]")
    # the resources of B11's builds on the main paths: valid16 (Grid A),
    # radius 2 (two-tier, the mission's escalation) for the four models
    for M, models in ((16, ("exponential",)), (25, tuple(MODEL_VPARAMS))):
        for model in models:
            at = ss.krige_attributes(M, model)
            say("B11", f"build M={M} {model}: {at['registers']} registers, {at['spill_bytes']} spill bytes, "
                f"{at['blocks_per_sm']} resident blocks of 128 threads an SM "
                f"({at['blocks_per_sm'] * 128 / 2048:.0%} of the SM's threads)  [{card}]")
    # and of every B12 build (radius 1-3, the four models), with the rows'
    # stages in shared memory of the radius-2 builds (the fused path's),
    # which spill nothing
    for M in (9, 25, 49):
        for model in MODEL_VPARAMS:
            at = ss.window_krige_attributes(M, model)
            say("B12", f"build M={M} {model}: {at['registers']} registers, {at['spill_bytes']} spill bytes, "
                f"{at['shared_bytes']} B of shared memory, {at['blocks_per_sm']} resident blocks of 128 threads an "
                f"SM ({at['blocks_per_sm'] * 128 / 2048:.0%} of the SM's threads)  [{card}]")
            if M == 25 and at["spill_bytes"]:
                raise AssertionError(f"B12's radius-2 {model} build spills {at['spill_bytes']} bytes")
    # and of every B15 build (radius 1-3; k 4, 8 and the general build)
    for M in (9, 25, 49):
        for k in (4, 8, 3):
            at = ss.window_idw_attributes(M, k)
            say("B15", f"build M={M} k={k if k in (4, 8) else 'any'}: {at['registers']} registers, "
                f"{at['spill_bytes']} spill bytes, {at['shared_bytes']} B of shared memory in {at['stages']} stages "
                f"(0: rows in registers), {at['blocks_per_sm']} resident blocks of 128 threads an SM  [{card}]")
            if M == 25 and at["spill_bytes"]:
                raise AssertionError(f"B15's radius-2 k={k} build spills {at['spill_bytes']} bytes")
            if M == 25 and not (at["stages"] >= 2 and at["blocks_per_sm"] >= 6):
                raise AssertionError(f"B15's staged radius-2 k={k} build: {at}, want 2 stages or more and 6 "
                                     f"resident blocks or more")
    # B11 at 1M and 5M valid16 queries against its byte bound (8 bytes of
    # query, the 64-byte row, 4 written, at 3.35 TB/s), the row-gather probe
    # (the same reads and write, nothing else, each row loaded straight into
    # registers: not a floor, since rows staged by cp.async read faster at
    # radius 2, PERF.md), and an issue estimate from
    # the build's static SASS count (one warp instruction a query a thread,
    # 4 an SM a clock): code a query may not run is counted, so it is not a
    # floor
    gather = load_script("row_gather_probe")
    sass = load_script("sass_tools")
    sass_n = sass.sass_instructions(kbuild.library_path("scattered_select"), "select_krige_kernel<16, 16, 0>")
    clock_hz = float(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
                                     "--format=csv,noheader,nounits"], capture_output=True, text=True,
                                    timeout=60, check=True).stdout.split()[0]) * 1e6
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for tag, q_, key in (("1M", qA, "select_krige"), ("5M", qA5, "select_krige 5M")):
        nq_ = float(q_[0].numel())
        cell_ = ss.prologue(gA, *q_)[5].to(torch.int32).contiguous()
        ms[f"B11 row probe {tag}"] = gather.floor_ms(sys.modules[__name__], p16, 16, 1, cell_, *q_, gA)
        ms[f"B11 byte bound {tag}"] = nq_ * (8 + 64 + 4) / HBM_BPS * 1e3
        ms[f"B11 static issue estimate {tag}"] = nq_ * sass_n / 32 / (n_sm * 4 * clock_hz) * 1e3
        t_ = ms[f"{key} alone"]
        est = ms[f"B11 static issue estimate {tag}"]
        say("timing", f"B11 valid16 at {int(nq_)} queries: alone {t_:.4f} ms; byte bound "
            f"{ms[f'B11 byte bound {tag}']:.4f} ms ({ms[f'B11 byte bound {tag}'] / t_:.0%}); rows-in-registers probe "
            f"{ms[f'B11 row probe {tag}']:.4f} ms ({ms[f'B11 row probe {tag}'] / t_:.0%}); static-count issue "
            f"estimate {est:.4f} ms ({est / t_:.0%}; {sass_n} SASS instructions in the build, run or not, at "
            f"{clock_hz / 1e6:.0f} MHz)  [{card}]")
        del cell_
    # B12 likewise at radius 2: 8 bytes of query, the 128-byte row, 4
    # written; its rows-in-registers probe reads the same rows (P = 32)
    sass_w = sass.sass_instructions(kbuild.library_path("scattered_select"), "window_krige_kernel<25, 32, 0>")
    for tag, q_, key in (("1M", qA, "window_krige alone"), ("5M", qA5, "window_krige 5M alone")):
        nq_ = float(q_[0].numel())
        cell_ = ss.prologue(gA, *q_)[5].to(torch.int32).contiguous()
        ms[f"B12 row probe {tag}"] = gather.floor_ms(sys.modules[__name__], winA, 32, 1, cell_, *q_, gA)
        ms[f"B12 byte bound {tag}"] = nq_ * (8 + 128 + 4) / HBM_BPS * 1e3
        ms[f"B12 static issue estimate {tag}"] = nq_ * sass_w / 32 / (n_sm * 4 * clock_hz) * 1e3
        t_ = ms[key]
        est = ms[f"B12 static issue estimate {tag}"]
        say("timing", f"B12 radius 2 at {int(nq_)} queries: alone {t_:.4f} ms; byte bound "
            f"{ms[f'B12 byte bound {tag}']:.4f} ms ({ms[f'B12 byte bound {tag}'] / t_:.0%}); rows-in-registers probe "
            f"{ms[f'B12 row probe {tag}']:.4f} ms ({ms[f'B12 row probe {tag}'] / t_:.0%}); static-count issue "
            f"estimate {est:.4f} ms ({est / t_:.0%}; {sass_w} SASS instructions in window_krige_kernel<25, 32, 0>, "
            f"run or not, at {clock_hz / 1e6:.0f} MHz)  [{card}]")
        # B15 reads the same bytes and rows (k 8 and, at 1M, k 4; power 2):
        # its staged build (registers, blocks, shared memory, stages above)
        at15 = ss.window_idw_attributes(25, 8)
        for k_ in (8, 4) if tag == "1M" else (8,):
            t_ = ms[{("1M", 8): "window_idw alone", ("5M", 8): "window_idw 5M alone",
                     ("1M", 4): "window_idw k4 alone"}[tag, k_]]
            say("timing", f"B15 radius 2 k={k_} at {int(nq_)} queries (staged, {at15['stages']} stages, "
                f"{at15['registers']} registers, {at15['blocks_per_sm']} blocks an SM, {at15['shared_bytes']} B "
                f"shared): alone {t_:.4f} ms; byte bound {ms[f'B12 byte bound {tag}']:.4f} ms "
                f"({ms[f'B12 byte bound {tag}'] / t_:.0%}); rows-in-registers probe "
                f"{ms[f'B12 row probe {tag}']:.4f} ms ({ms[f'B12 row probe {tag}'] / t_:.0%})  [{card}]")
        del cell_
    # the CUDA kernels and the events of one kriging_valid_t call, beside
    # the torch prologue it no longer runs (B5-B7's wrappers still do) and
    # B5 with the torch row epilogue (the path before B11)
    def b5_path():
        out, _, _, oob, ci, cj = vs._select_rows(p16, 16, tp.VALID16_OFFSETS, 2, gA, *qA, emit_d2=False)
        return ss._kriging_rows_epilogue(gA, *qA, out, oob, ci, cj, 2, vparams=None, model="exponential")

    for tag, q_ in (("1M", qA), ("5M", qA5)):
        calls = {"kriging_valid_t": lambda: vs.kriging_valid_t(p16, gA, *q_),
                 "torch prologue": lambda: ss.prologue(gA, *q_)}
        # B11 alone, once a call (the tracer may drop a record or two)
        kept = only_kernel(calls["kriging_valid_t"], "select_krige_kernel", f"kriging_valid_t at {tag}")
        n_pro = sum(device_kernels(calls["torch prologue"], reps=10).values()) / 10
        ev = {what: time_ms(fn, reps=20) for what, fn in calls.items()}
        ms[f"kriging_valid_t {tag} events"] = ev["kriging_valid_t"]
        say("timing", f"one kriging_valid_t call at {q_[0].numel()} queries: {ev['kriging_valid_t']:.4f} ms events, "
            f"one CUDA kernel, B11 ({sum(kept.values())} records of 20 calls kept); the torch prologue it no "
            f"longer runs: {ev['torch prologue']:.4f} ms, {n_pro:.1f} kernels  [{card}]")
    n_b5 = sum(device_kernels(b5_path, reps=10).values()) / 10
    ms["B5 + epilogue"] = time_ms(b5_path, reps=10)
    say("timing", f"B5 with the torch row epilogue (the path before B11): {n_b5:.1f} CUDA kernels, "
        f"{ms['B5 + epilogue']:.4f} ms at {N_SCATTER} queries  [{card}]")
    # B1 shares krige_solve.cuh: its SASS must not move
    b1_sass = sass.sass_fingerprint(kbuild.library_path("window_fill"), "kriging_fill_kernel")
    b1_digest = sass.sass_digest(b1_sass)
    nvcc_v = subprocess.run([kbuild.nvcc_path(), "--version"], capture_output=True, text=True).stdout.strip()
    nvcc_v = nvcc_v.splitlines()[-1] if nvcc_v else "unknown"
    pin = B1_SASS_PIN.get(nvcc_v)
    if pin is not None and b1_digest != pin:
        raise AssertionError(f"B1's SASS moved under {nvcc_v}: {b1_digest}, pinned {pin}; {b1_sass}")
    say("B1", f"SASS of {b1_digest[0]} kriging_fill_kernel builds, {b1_digest[1]} instructions, digest "
        f"{b1_digest[2]}: " + ("equal to the pin" if pin is not None else f"no pin for {nvcc_v}, not compared")
        + "; bench builds: " + "; ".join(f"{k} {n_} instructions" for k, (n_, _) in sorted(b1_sass.items())
                                         if k.startswith("kriging_fill_kernel<0, 0, false")))
    # B11 shares krige_solve.cuh and its query function with B12: its SASS
    # must not move either
    b11_sass = sass.sass_fingerprint(kbuild.library_path("scattered_select"), "select_krige_kernel")
    b11_digest = sass.sass_digest(b11_sass)
    pin = B11_SASS_PIN.get(nvcc_v)
    if pin is not None and b11_digest != pin:
        raise AssertionError(f"B11's SASS moved under {nvcc_v}: {b11_digest}, pinned {pin}; {b11_sass}")
    say("B11", f"SASS of {b11_digest[0]} select_krige_kernel builds, {b11_digest[1]} instructions, digest "
        f"{b11_digest[2]}: " + ("equal to the pin" if pin is not None else f"no pin for {nvcc_v}, not compared")
        + "; B12's exponential builds: " + "; ".join(
            f"{k} {n_} instructions" for k, (n_, _) in sorted(sass.sass_fingerprint(
                kbuild.library_path("scattered_select"), "window_krige_kernel").items()) if k.endswith(", 0>")))
    # B7's library call: torch.topk of the (n, P) d2 matrix, made
    # beforehand as select_ref makes it (the selection alone, with no tie
    # order, no values and no codes)
    st_ = winA.view(-1, 32)[cellA.long()]
    di_, dj_ = (tab32n[0] + 0.5)[None, :] - fxA[:, None], (tab32n[1] + 0.5)[None, :] - fyA[:, None]
    d2A = torch.where(st_ < 0.5 * tp.SENTINEL, di_ * di_ + dj_ * dj_, torch.full_like(st_, ss.INF))
    del st_, di_, dj_
    ms["B7 library topk"] = device_ms(lambda: torch.topk(d2A, 4, dim=1, largest=False), None)
    say("timing", f"Grid A {N_SCATTER} queries torch.topk(d2, 4, largest=False) on the (n, 32) d2 matrix "
        f"(B7's library call: the selection alone) {ms['B7 library topk']:.4f} ms  [{card}]")
    del d2A
    # B5's library call likewise: torch.topk over the taps of its (P, n) d2
    # stencil (valid16, P=16, the lanes-major layout of its rows), made
    # beforehand
    st_ = p16.view(-1, 16)[cellA.long()]
    di_, dj_ = (tab16[0] + 0.5)[None, :] - fxA[:, None], (tab16[1] + 0.5)[None, :] - fyA[:, None]
    d2B = torch.where(st_ < 0.5 * tp.SENTINEL, di_ * di_ + dj_ * dj_, torch.full_like(st_, ss.INF)).T.contiguous()
    del st_, di_, dj_
    ms["B5 library topk"] = device_ms(lambda: torch.topk(d2B, 4, dim=0, largest=False), None)
    say("timing", f"Grid A {N_SCATTER} queries torch.topk(d2, 4, dim=0, largest=False) on the (16, n) d2 stencil "
        f"(B5's library call: the selection alone) {ms['B5 library topk']:.4f} ms  [{card}]")
    del d2B
    wrappers = {
        "kriging_valid_t (B11)": lambda: vs.kriging_valid_t(p16, gA, *qA),
        "packed_kriging_valid (torch)": lambda: tp.packed_kriging_valid(p16, gA, *qA),
        "packed_idw_t (B6)": lambda: vs.packed_idw_t(winA, gA, *qA),
        "packed_idw (torch)": lambda: tp.packed_idw(winA, gA, *qA),
        "packed_kriging_fused (B12)": lambda: ss.packed_kriging_fused(winA, gA, *qA),
        "packed_idw_fused (B15)": lambda: ss.packed_idw_fused(winA, gA, *qA),
        "packed_kriging (torch)": lambda: tp.packed_kriging(winA, gA, *qA),
        "prologue (_normalize, centre, fx, fy)": lambda: ss.prologue(gA, *qA),
        "two-tier kriging r0.10 (B11)": lambda: tt.kriging(*qK),
        "two-tier idw r0.10 (B6)": lambda: tt.idw(*qK),
        "two-tier kriging r0.10 (torch)": lambda: ref_tt.kriging(*qK),
    }
    for label, fn in wrappers.items():
        ms[label] = time_ms(fn, reps=10)
        say("timing", f"{N_SCATTER} queries {label:38s} {ms[label]:.4f} ms "
            f"({N_SCATTER / ms[label] / 1e3:.2f} M pts/s)  [{card}]")
    for (method, n), v in sorted(grid_a.items(), key=lambda kv: (kv[0][1], kv[0][0])):
        say("timing", f"Grid A auto n={n:>9} {method:8s} steady {v['steady_ms']:.4f} ms "
            f"({n / v['steady_ms'] / 1e3:.2f} M pts/s), end-to-end {v['e2e_ms']:.3f} ms  [{card}]")
    for (method, n), v in grid_a_fused.items():
        say("timing", f"Grid A fused n={n:>9} {method:8s} steady {v['steady_ms']:.4f} ms "
            f"({n / v['steady_ms'] / 1e3:.2f} M pts/s)  [{card}]")
    say("timing", f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB")
    del p16, winA, fxA, fyA, oobA, qA, qA5, gA, sel_args, wrappers
    torch.cuda.empty_cache()

    # ---- 16. B8 vs its plain version: the band weave on the B1-filled band
    # and the diagonal on the 8-page atlas at 5M pings, a masked band, the
    # aligned geometry, and both weight families at the 64-row test size
    import torch.nn.functional as F

    from auvtpu_torch.ops import band as tband

    t_band = time.perf_counter()
    tracks = band_tracks(grid, N_BAND)
    rb = tband.BandRouter(grid)
    band = rb.prepare(*tracks["band"])
    rs_b = rb._resampler
    ra = tband.BandRouter(grid, max_bands=8)
    atlas = ra.prepare(*tracks["diagonal"])
    rs_a = ra._resampler
    say("B8", f"stand-in r0.10 band {band.shape} at ({band.row0}, {band.col0}), masked={band.masked}, window "
        f"{rs_b.wr}x{rs_b.wc}; atlas {atlas.shape}, masked={atlas.masked}, window {rs_a.wr}x{rs_a.wc}; "
        f"{N_BAND} pings each, chunk {rs_b.chunk}, lerp {rs_b.lerp_mode}, backend {rs_b.backend}")
    if rs_b.backend != "fused" or rs_a.backend != "fused":
        raise AssertionError(f"the resamplers' auto backend resolved to {rs_b.backend}/{rs_a.backend}")
    band_args, band_kw = b8_call(rs_b, *tracks["band"])
    z_b, ok_b, b8_err = b8_equal(band_args, band_kw, "band weave")
    # the band-frame coordinates the kernel's prologue computes, as the torch
    # prologue (_xy, the shift, the pad) gives them: the kernel on those, with
    # the identity prologue, must return the same pings bit for bit
    _, xb_, yb_, _ = rs_b.coords(*tracks["band"])
    z_c, ok_c = kb.band_resample(*band_args[:3], xb_, yb_, **dict(band_kw, affine=kb.IDENTITY))
    if not (torch.equal(ok_c[:N_BAND], ok_b) and torch.equal(z_c[:N_BAND][ok_b], z_b[ok_b])):
        raise AssertionError("band weave: the fused prologue differs from _xy + shift + pad")
    xb_, yb_ = xb_[:N_BAND], yb_[:N_BAND]
    share = float(ok_b.float().mean())
    e64 = f64_bilinear_err(band.plane, xb_, yb_, z_b, ok_b)
    say("B8", f"band weave ({N_BAND} pings, {N_BAND % band_kw['chunk']} in the ragged last chunk): ok and z equal "
        f"to plain, and to the kernel on the torch prologue's coordinates; resolved {share:.6f}; max |z - f64 "
        f"bilinear| {e64:.3g} m")
    if share <= 0.9 or not e64 < BAND_F64_TOL:
        raise AssertionError(f"band weave: resolved {share} (want > 0.9), f64 error {e64} (want < {BAND_F64_TOL})")
    # a 512-ping navigation tick: the effective chunk is the tick
    tick_args, tick_kw = b8_call(rs_b, *(t[:TICK] for t in tracks["band"]))
    _, _, e = b8_equal(tick_args, tick_kw, f"{TICK}-ping tick")
    b8_err = max(b8_err, e)
    say("B8", f"{TICK}-ping tick (chunk {tick_kw['chunk']}): ok and z equal to plain")
    atlas_args, atlas_kw = b8_call(rs_a, *tracks["diagonal"])
    _, ok_a, e = b8_equal(atlas_args, atlas_kw, "diagonal atlas")
    b8_err = max(b8_err, e)
    say("B8", f"diagonal atlas: ok and z equal to plain; resolved {float(ok_a.float().mean()):.6f}")
    # a masked band: a hole across the weave's centre rows
    R_, C_ = band.shape
    hole = band.vmask.clone()
    hole[R_ // 2 - 2:R_ // 2 + 2, 1000:1100] = 0.0
    mband = tband.Band(plane=band.plane * hole, vmask=hole, masked=True, row0=band.row0, col0=band.col0)
    rs_m = tband.BandResampler(grid, mband, chunk=rs_b.chunk, win_rows=rs_b.wr, win_cols=rs_b.wc,
                               lerp_mode=rs_b.lerp_mode)
    m_args, m_kw = b8_call(rs_m, *tracks["band"])
    z_m, ok_m, e = b8_equal(m_args, m_kw, "masked band")
    b8_err = max(b8_err, e)
    lost = int((ok_b & ~ok_m).sum())
    e64m = f64_bilinear_err(mband.plane, xb_, yb_, z_m, ok_m)
    say("B8", f"masked band: ok and z equal to plain; {lost} pings unresolved by the hole; max |z - f64| {e64m:.3g} m")
    if lost == 0 or not e64m < BAND_F64_TOL:
        raise AssertionError(f"masked band: {lost} pings lost to the hole, f64 error {e64m}")
    for label, rs_, tr in (("band", rs_b, tracks["band"]), ("atlas", rs_a, tracks["diagonal"])):
        args, kw = b8_call(rs_, *tr, aligned=True)
        _, ok_al, e = b8_equal(args, kw, f"{label} aligned")
        b8_err = max(b8_err, e)
        say("B8", f"{label} aligned geometry (one-hot weights): ok and z equal to plain; resolved "
            f"{float(ok_al.float().mean()):.6f}")
    # non-finite pings (ROADMAP C6): a NaN latitude, a NaN longitude or a
    # +inf longitude in the track's middle and as its last ping: the window
    # base takes the ping's saturating int32 cast (NaN as cell 0) and the
    # atlas's page pick its NaN, as the reference's jnp.min/jnp.max do; ok
    # equal and z bit-equal with its NaN pattern (a NaN ping that the
    # window holds resolves to NaN, as in the reference)
    for label, rs_, tr in (("band", rs_b, tracks["band"]), ("atlas", rs_a, tracks["diagonal"])):
        for which, v in (("lat", float("nan")), ("lon", float("nan")), ("lon", float("inf"))):
            lo_, la_ = (t.clone() for t in tr)
            for at_ in (N_BAND // 2, N_BAND - 1):
                (la_ if which == "lat" else lo_)[at_] = v
            args, kw = b8_call(rs_, lo_, la_)
            z_o, ok_o = kb.band_resample(*args, **kw)
            zp_o, okp_o = kb.band_resample_ref(*args, **kw)
            torch.cuda.synchronize()
            nan_o = torch.isnan(zp_o)
            if not (torch.equal(ok_o, okp_o) and torch.equal(torch.isnan(z_o), nan_o)
                    and torch.equal(z_o[~nan_o], zp_o[~nan_o])):
                raise AssertionError(f"B8 {label} with a {v} {which} ping: differs from plain")
            say("B8", f"{label} with a {v} {which} ping at {N_BAND // 2} and {N_BAND - 1}: ok and z equal to "
                f"plain; {int((~ok_o).sum())} unresolved, {int((ok_o & nan_o).sum())} resolved to NaN")
    # tests/test_band.py:86-119 on the card: a 48x160 IDW band (B3) of a
    # 96x160 dense grid, 1000 pings, chunk 64, 32x128 windows
    EXT_T = Extent(-74.0, -70.0, 35.0, 38.0)
    g_t = RegularGrid.dense(shelf_seamount(96, 160), EXT_T, device=dev)
    b_t = tband.fill_band(g_t, 16, 48, 0, 160, method="idw")
    hole_t = b_t.vmask.clone()
    hole_t[20:22, 60:64] = 0.0
    bm_t = tband.Band(plane=b_t.plane * hole_t, vmask=hole_t, masked=True, row0=16, col0=0)
    tt_ = np.linspace(0.0, 1.0, 1000)
    rng_t = np.random.default_rng(0)
    xt = np.clip(1.0 + tt_ * 157 + rng_t.normal(0, 0.05, 1000), 0.5, 158.5)
    yt = np.clip(96 * 0.4 + 96 * 0.05 * np.sin(tt_ * 40 * np.pi) + rng_t.normal(0, 0.05, 1000), 0.5, 94.5)
    q_t = (torch.from_numpy((-74.0 + xt * g_t.lon_step).astype(np.float32)).to(dev),
           torch.from_numpy((35.0 + yt * g_t.lat_step).astype(np.float32)).to(dev))
    for b_ in (b_t, bm_t):
        for lerp in ("onehot", "hat"):
            rs_t = tband.BandResampler(g_t, b_, chunk=64, win_rows=32, win_cols=128, lerp_mode=lerp)
            args, kw = b8_call(rs_t, *q_t)
            _, ok_t, e = b8_equal(args, kw, f"48x160 {lerp} masked={b_.masked}")
            b8_err = max(b8_err, e)
            say("B8", f"48x160 band, {lerp} weights, masked={b_.masked}: ok and z equal to plain; resolved "
                f"{float(ok_t.float().mean()):.4f}")
    say("B8", f"phase took {time.perf_counter() - t_band:.1f} s")

    # ---- 17. mission (launch counts from here to the end of the real-time
    # loop)
    t_m = time.perf_counter()
    wf.reset_launches()
    ss.reset_launches()
    kb.reset_launches()
    cli_runs = mission_cli_runs(dev)
    serving = standin_serving_runs(grid, tracks)
    # the real-time loop of tests/test_band.py:451-497: ingest, refresh,
    # serve; new observations reach the band fill and the escalation engine
    si_m = StreamingInterpolator((96, 256), EXT_T, swath_cap=512, method="kriging", device=dev)

    def swath(c0, c1):
        rr, cc = np.mgrid[0:96:2, c0:c1]
        rr, cc = rr.ravel(), cc.ravel()
        si_m.ingest(rr, cc, (100.0 + rr * 0.5 + cc * 0.25).astype(np.float64))

    swath(0, 128)
    r_m = tband.BandRouter(si_m.grid(), chunk=64, win_rows=32, win_cols=128)
    t_ = np.linspace(0, 1, 512)
    x_m = 2.0 + t_ * 120.0
    y_m = 48.0 + 3 * np.sin(t_ * 20 * np.pi)
    lon_m = (-74.0 + x_m * r_m.grid.lon_step).astype(np.float32)
    lat_m = (35.0 + y_m * r_m.grid.lat_step).astype(np.float32)
    r_m.prepare(lon_m, lat_m)
    z1 = r_m.kriging(lon_m, lat_m, force="band").double().cpu().numpy()
    swath(128, 256)
    r_m.refresh(grid=si_m.grid())
    x2_m = 130.0 + t_ * 110.0
    lon2_m = (-74.0 + x2_m * r_m.grid.lon_step).astype(np.float32)
    z2 = r_m.kriging(lon2_m, lat_m, force="band").double().cpu().numpy()
    e1 = float(np.abs(z1 - (100.0 + y_m * 0.5 + x_m * 0.25)).max())
    e2 = float(np.abs(z2 - (100.0 + y_m * 0.5 + x2_m * 0.25)).max())
    if not (np.isfinite(z1).all() and np.isfinite(z2).all() and e1 < 1.0 and e2 < 1.0
            and r_m.two_tier.grid is r_m.grid and r_m.last_unresolved > 0):
        raise AssertionError(f"real-time loop: max |err| {e1}, {e2} (want < 1 m, finite), "
                             f"{r_m.last_unresolved} escalated after the refresh")
    launches_m = {**wf.LAUNCHES, **ss.LAUNCHES, **kb.LAUNCHES}
    say("mission", f"real-time loop (96x256 streaming, refresh, serve): max |err| {e1:.4f} / {e2:.4f} m on the "
        f"linear field, {r_m.last_unresolved} escalated after the refresh; launches {launches_m}; phase took "
        f"{time.perf_counter() - t_m:.1f} s")
    need = ["fill_kriging_fused", "fill_idw_fused", "band_resample"]
    if any(v["unresolved"] for (k, _), v in serving.items() if k.endswith("kriging")):
        need.append("select_krige")
    if any(v["unresolved"] for (k, _), v in serving.items() if k.endswith("idw")):
        need.append("idw_rows")
    for k in need:
        if launches_m[k] < 1:
            raise AssertionError(f"kernel {k} was not launched on the mission path")

    # ---- 18. timing of the band slice and the router's COST_NS
    ms["B8 band"] = device_ms(b8_launcher(band_args, band_kw), "band_resample_")
    ms["B8 band cold"] = device_ms(b8_launcher(band_args, band_kw), "band_resample_", cold=True)
    ms["B8 band wrapper"] = time_ms(lambda: kb.band_resample(*band_args, **band_kw))
    ms["B8 band plain"] = time_ms(lambda: kb.band_resample_ref(*band_args, **band_kw), reps=5)
    ms["B8 atlas"] = device_ms(b8_launcher(atlas_args, atlas_kw), "band_resample_")
    ms["B8 atlas cold"] = device_ms(b8_launcher(atlas_args, atlas_kw), "band_resample_", cold=True)
    ms["B8 atlas wrapper"] = time_ms(lambda: kb.band_resample(*atlas_args, **atlas_kw))
    ms["B8 atlas plain"] = time_ms(lambda: kb.band_resample_ref(*atlas_args, **atlas_kw), reps=5)
    # the library yardstick: grid_sample (bilinear, align_corners=True) on the
    # same plane and coordinates computes the values alone (no window, no
    # resolved mask); it is timed here and used nowhere in the port
    R_, C_ = band.shape
    gs_grid = torch.stack([xb_ * (2.0 / (C_ - 1)) - 1.0, yb_ * (2.0 / (R_ - 1)) - 1.0], dim=-1)[None, None]
    gs_plane = band.plane[None, None]
    z_gs = F.grid_sample(gs_plane, gs_grid, mode="bilinear", align_corners=True)[0, 0, 0]
    gs_diff = float((z_gs[ok_b] - z_b[ok_b]).abs().max())

    def grid_sample():
        F.grid_sample(gs_plane, gs_grid, mode="bilinear", align_corners=True)

    ms["grid_sample"] = device_ms(grid_sample, None)
    ms["grid_sample cold"] = device_ms(grid_sample, None, cold=True)
    say("timing", f"grid_sample's device kernels, 20 calls: {device_kernels(grid_sample)}")
    ms["band resample"] = time_ms(lambda: rs_b.resample(*tracks["band"]))
    ms["atlas resample"] = time_ms(lambda: rs_a.resample(*tracks["diagonal"]))
    ms["band coords"] = time_ms(lambda: rs_b.coords(*tracks["band"]))
    for label in ("B8 band", "B8 atlas"):
        say("timing", f"{N_BAND} pings {label:9s} kernel alone {ms[label]:.4f} ms back to back, {ms[label + ' cold']:.4f} "
            f"ms cold; wrapper {ms[label + ' wrapper']:.4f} ms, plain {ms[label + ' plain']:.4f} ms  [{card}]")
    say("timing", f"{N_BAND} pings grid_sample on the band {ms['grid_sample']:.4f} ms back to back, "
        f"{ms['grid_sample cold']:.4f} ms cold (values only, on band-frame coordinates made beforehand; max |diff| "
        f"from B8 at resolved pings {gs_diff:.3g} m); BandResampler.resample {ms['band resample']:.4f} ms, "
        f"AtlasResampler.resample {ms['atlas resample']:.4f} ms; "
        f"the torch prologue it no longer runs (coords()) {ms['band coords']:.4f} ms  [{card}]")
    for label, rs_, tr in (("BandResampler", rs_b, tracks["band"]), ("AtlasResampler", rs_a, tracks["diagonal"])):
        kb.reset_launches()
        rs_.resample(*tr)
        launches_r = kb.LAUNCHES["band_resample"]
        if launches_r != 1:
            raise AssertionError(f"{label}.resample: {launches_r} B8 launches, want one")
        seen = only_kernel(lambda: rs_.resample(*tr), "band_resample_", f"{label}.resample")
        say("timing", f"{label}.resample: one B8 launch; the device kernels of 20 calls, with the records the "
            f"profiler kept: {seen}")
    ms["band prepare"] = host_ms(lambda: rb.prepare(*tracks["band"]))
    ms["atlas prepare"] = host_ms(lambda: ra.prepare(*tracks["diagonal"]))
    ms["band kriging"] = host_ms(lambda: rb.kriging(*tracks["band"]))
    ms["atlas kriging"] = host_ms(lambda: ra.kriging(*tracks["diagonal"]))
    say("timing", f"prepare (plan + fills, host clock): band {ms['band prepare']:.4f} ms ({band.cells} cells), atlas "
        f"{ms['atlas prepare']:.4f} ms ({atlas.cells} cells); BandRouter.kriging at {N_BAND} (route, resample, "
        f"escalation): band {ms['band kriging']:.4f} ms ({N_BAND / ms['band kriging'] / 1e3:.1f} M pts/s), atlas "
        f"{ms['atlas kriging']:.4f} ms ({N_BAND / ms['atlas kriging'] / 1e3:.1f} M pts/s)  [{card}]")
    tick = tick_latency(grid, dev)
    say("timing", f"tick latency, {TICK}-ping ticks, {TICK_OBS} observations a tick, refresh every {REFRESH_EVERY}: "
        f"p50 {tick['p50']:.4f} ms, p99 {tick['p99']:.4f} ms, max {tick['max']:.4f} ms over {tick['n']} ticks; "
        f"after a refresh p50 {tick['post_p50']:.4f} ms, max {tick['post_max']:.4f} ms; refresh() "
        f"p50 {tick['refresh_p50']:.4f} ms  [{card}]")
    # the router's cost model on this card
    tt5 = TwoTierInterpolator(grid)
    q5 = scattered_queries(KERGUELEN_EXTENT, *SHAPE, N_BAND, 10, dev)
    ms["packed 5M"] = time_ms(lambda: tt5.kriging(*q5), reps=5)
    # the fill line: fill_per_cell is the slope of the fills' device time
    # (CUDA events) over the cells, dispatch what the host clock adds on top
    # (the median over the shapes); a least-squares line through the host
    # clock alone is flat here, the calls being host-bound at every shape
    H_, W_ = grid.shape
    fills = []
    for nr, nc in FILL_SHAPES:
        fill_ = (lambda r0_=(H_ - nr) // 2, nr=nr, nc=nc: rb._fill_one(r0_, nr, 0, nc, True))
        fills.append((nr * nc, host_ms(fill_), time_ms(fill_, reps=10)))
    per_cell = max(float(np.polyfit([c for c, _, _ in fills], [d * 1e6 for _, _, d in fills], 1)[0]), 0.0)
    cal = {
        "packed_per_query": ms["packed 5M"] * 1e6 / q5[0].numel(),
        "dispatch": float(np.median([h * 1e6 - per_cell * c for c, h, _ in fills])),
        "fill_per_cell": per_cell,
        "resample_per_query": ms["band resample"] * 1e6 / N_BAND,
    }
    say("timing", "fills, host clock / events: " + ", ".join(f"{c} cells {h:.4f} / {d:.4f} ms" for c, h, d in fills)
        + f"; two-tier kriging at {q5[0].numel()} random queries {ms['packed 5M']:.4f} ms  [{card}]")
    say("timing", f"calibrated COST_NS {json.dumps(cal)}; committed {json.dumps(tband.COST_NS)}  [{card}]")
    rng_q = np.random.default_rng(11)
    rq = (rng_q.uniform(KERGUELEN_EXTENT.min_lon, KERGUELEN_EXTENT.max_lon, 4096).astype(np.float32),
          rng_q.uniform(KERGUELEN_EXTENT.min_lat, KERGUELEN_EXTENT.max_lat, 4096).astype(np.float32))
    for label, costs in (("calibrated", cal), ("committed", tband.COST_NS)):
        r_c = tband.BandRouter(grid, cost_ns=costs)
        random_route = r_c.route(*rq)
        r_c.prepare(*tracks["band"])
        band_route = r_c.route(*tracks["band"], band_ready=True)
        say("timing", f"{label} costs: 4096 random queries route {random_route}, the prepared {N_BAND}-ping band "
            f"routes {band_route}")
        if (random_route, band_route) != ("packed", "band"):
            raise AssertionError(f"{label} router: random batch {random_route}, prepared band {band_route}")
    del tt5, q5, r_c, tick
    torch.cuda.empty_cache()
    say("timing", f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MiB")

    # ---- 19. exact mode (f64): the bench workload against the JAX
    # package's pins, strict against two-tier, synthetic grids against the
    # golden engine, and both CLIs' exact modes
    from auvtpu_torch.cli import learned_eval
    from auvtpu_torch.config import KERGUELEN_EXTENT as KEXT
    from auvtpu_torch.golden import GoldenGrid
    from auvtpu_torch.masking import mask_grid
    from auvtpu_torch.metrics import all_reference_metrics
    from auvtpu_torch.ops import exact as texact
    from auvtpu_torch.ops import fill_window_mean
    from auvtpu_torch.ops import exact_fast as tfast
    from auvtpu_torch.synthetic import kerguelen_standin

    t_ex = time.perf_counter()
    reduced_k, rc_k, truth_k = mask_grid(kerguelen_standin(SHAPE), REMOVAL)
    g64 = RegularGrid.from_nan_array(reduced_k, KEXT, dtype=torch.float64, device=dev)
    rk, ck = rc_k[:, 0], rc_k[:, 1]
    # the held-out cells on the card, as bench_grid_b passes them
    rk_t, ck_t = (torch.as_tensor(a, device=dev) for a in (rk, ck))
    exact_fns = {
        "kriging_two": lambda: tfast.exact_kriging_at_cells_fast(g64, rk_t, ck_t),
        "kriging_strict": lambda: texact.exact_kriging_at_cells(g64, rk_t, ck_t),
        "cubic": lambda: texact.exact_cubic_at_cells(g64, rk_t, ck_t),
        "bilinear": lambda: texact.exact_bilinear_at_cells(g64, rk_t, ck_t),
    }
    es.reset_launches()
    ep.reset_launches()
    ee.reset_launches()
    with host_views_refused(texact):
        preds = {k: fn() for k, fn in exact_fns.items()}
        esc_k = tfast.exact_select_at_cells_fast(g64, rk_t, ck_t)[5]
    launches_ex = {**es.LAUNCHES, **ep.LAUNCHES, **ee.LAUNCHES}
    # each call a B16 launch; two-tier kriging and the selection a B13
    # launch each and a B14 launch each for the escalated cells; strict
    # kriging and cubic a B14 launch each; strict kriging a B17 launch,
    # cubic and bilinear a B18 launch each
    if launches_ex != {"exact_dense": 2, "exact_ring": 4, "exact_prologue": 5, "exact_krige": 1, "exact_patch": 2}:
        raise AssertionError(f"exact mode's launches {launches_ex}, want five of B16, two of B13, four of B14, "
                             f"one of B17 and two of B18")
    for key in ("kriging_two", "cubic", "bilinear"):
        exact_pin(key, preds[key], truth_k, int(esc_k.sum()) if key == "kriging_two" else None)
    two, strict = preds["kriging_two"], preds["kriging_strict"]
    if not np.array_equal(np.isnan(two), np.isnan(strict)):
        raise AssertionError("exact kriging: strict and two-tier NaN in different places")
    d_ts = float(np.nanmax(np.abs(two - strict)))
    if not d_ts <= EXACT_STRICT_TOL:
        raise AssertionError(f"exact kriging: strict vs two-tier max |diff| {d_ts} > {EXACT_STRICT_TOL}")
    say("exact", f"stand-in r0.10 f64, {len(truth_k)} cells: two-tier kriging RMSE "
        f"{all_reference_metrics(truth_k, two)['RMSE']:.9f}, {int(esc_k.sum())} escalated ({esc_k.mean():.6f}); "
        f"cubic, bilinear and two-tier kriging at the JAX package's pins (metrics within {EXACT_TOL} m, "
        f"sums within {EXACT_TOL} m a cell); strict vs two-tier max |diff| {d_ts:.3g} m; the queries prepared on "
        f"the card (one B16 launch a call), the host views refused; one epilogue launch a call (B17: strict "
        f"kriging; B18: cubic, bilinear)")

    # B13 and B14 against their plain versions at full width: the stand-in's
    # cells (two-tier's operands, strict's anchors at both anchors), then a
    # sparse grid no cell of which stops before ring 10, the card tests'
    # edge grids, then scattered Grid A queries; each with B13 on the
    # residue planes (duplicated cells, non-aligned queries), B14's anchors
    # past the grid and keys that overflow on some lanes
    tcuda = load_script("test_torch_cuda", "tests")  # the edge grids and odd keys of the card tests

    def mixed_dense_operands(g, rows_, cols_):
        """B13's operands for every query's cell, then the first 1000 again
        and cells past the edges, only the first len(rows_) aligned: on the
        residue planes, duplicated cells and non-aligned queries reading
        another query's residue (or 0)."""
        H, W = g.shape
        k = min(len(rows_), 1000)
        rows2 = np.concatenate([rows_, rows_[:k], [-1, 0, H, H + 3]])
        cols2 = np.concatenate([cols_, cols_[:k], [2, -1, 5, W + 2]])
        q2 = texact.prepare_exact_queries(g, rows2, cols2)
        al = tfast._aligned(q2, rows2, cols2)
        al[len(rows_):] = False
        flat = rows2 * W + cols2
        return (texact._on(g, flat[al]), texact._on(g, np.stack([q2.ex_key[al], q2.ey_key[al]])),
                texact._on(g, np.clip(flat, 0, H * W - 1)))

    def exact_kernels_equal(g, rows_, cols_, label: str, R: int = 10) -> dict:
        """B13 and B14 bit-equal to their plain versions at radius R."""
        rows_, cols_ = np.asarray(rows_, np.int64), np.asarray(cols_, np.int64)
        H, W = g.shape
        q_ = texact.prepare_exact_queries(g, rows_, cols_)
        dense_in = tfast._round_queries(g, rows_, cols_)[1]
        tabs = tfast._reference_tables(g, R)
        for path, d_in in (("aligned" if dense_in[0] is None else "planes", dense_in),
                           ("planes, mixed", mixed_dense_operands(g, rows_, cols_))):
            exact_equal(es.dense_select(g, *d_in, max_radius=R), es.dense_select_ref(g.elev, g.valid, *d_in, R),
                        f"B13 {label} ({path})")
            exact_equal(es.dense_krige(g, *d_in, *tabs, max_radius=R),
                        es.dense_krige_ref(g.elev, g.valid, *d_in, *tabs, R),
                        f"B13 solve {label} ({path})")
        far_i = torch.tensor([-3, W + 2, -11, 2**62, -2**62, 2**63 - 3, -2**63 + 2, 5], device=g.device)
        far_j = torch.tensor([4, 2, -11, 3, 5, 1, 2, 2**63 - 4], device=g.device)
        z8 = torch.zeros(8, device=g.device)
        for anchor in ("round", "floor"):
            ci_, cj_, var_, ex_, ey_ = texact._cell_keys(g, texact.prepare_exact_queries(g, rows_, cols_,
                                                                                        anchor=anchor), None)
            keys_ = (torch.cat([ci_, far_i]), torch.cat([cj_, far_j]), torch.cat([ex_, z8]), torch.cat([ey_, z8]),
                     torch.cat([var_, z8.int()]))
            exact_equal(es.ring_select(g, *keys_, max_radius=R), es.ring_select_ref(g.elev, g.valid, *keys_, R, 16384),
                        f"B14 {anchor} {label}")
        rng_ = np.random.default_rng(19)
        n_ = min(len(rows_), 100_000)
        odd = [texact._on(g, a) for a in (rng_.integers(-3, W + 3, n_), rng_.integers(-3, H + 3, n_),
                                          *(tcuda._ODD_KEYS[rng_.integers(0, len(tcuda._ODD_KEYS), n_)]
                                            for _ in range(2)), rng_.integers(0, 4, n_).astype(np.int32))]
        exact_equal(es.ring_select(g, *odd, max_radius=R), es.ring_select_ref(g.elev, g.valid, *odd, R, 16384),
                    f"B14 odd keys {label}")
        # 16 queries, fewer than one a BIT_PLANE_CELLS cells: the walks read valid
        few = (slice(0, 16),)
        exact_equal(es.ring_select(g, *(t[few] for t in odd), max_radius=R),
                    es.ring_select_ref(g.elev, g.valid, *(t[few] for t in odd), R, 16384), f"B14 few {label}")
        d_few = (dense_in[2] if dense_in[0] is None else dense_in[0], dense_in[1], dense_in[2][:16])
        exact_equal(es.dense_krige(g, *d_few, *tabs, max_radius=R),
                    es.dense_krige_ref(g.elev, g.valid, *d_few, *tabs, R),
                    f"B13 solve few {label}")
        inside = np.nonzero(~q_.oob)[0]
        keys_ = texact._cell_keys(g, q_, inside)
        qc_ = (texact._on(g, cols_[inside]), texact._on(g, rows_[inside]))
        exact_equal(es.ring_krige(g, *keys_, *qc_, *tabs, max_radius=R),
                    es.ring_krige_ref(g.elev, g.valid, *keys_, *qc_, *tabs, R, 16384), f"B14 solve {label}")
        return {"dense_in": dense_in, "tabs": tabs, "q": q_}

    attrs_x = es.attributes()
    say("exact", "builds (registers, local bytes, spill bytes, resident blocks an SM at 256 threads): " + "; ".join(
        f"{k} {v['registers']}, {v['local_bytes']}, {v.get('spill_bytes')}, {v['blocks_per_sm']}"
        for k, v in attrs_x.items()) + f"  [{card}]")
    # a 45-entry candidate list takes 456 bytes a thread; ptxas may spill a
    # register or two of a build that reads valid, but no list
    if any(v["local_bytes"] > 16 for k, v in attrs_x.items() if k.startswith("ring_kernel")):
        raise AssertionError(f"a B14 build keeps more local memory than a spill: {attrs_x}")
    attrs_p = ep.attributes()
    say("exact", "B16 builds (registers, local bytes, spill bytes, resident blocks an SM at 256 threads): " + "; ".join(
        f"{k} {v['registers']}, {v['local_bytes']}, {v.get('spill_bytes')}, {v['blocks_per_sm']}"
        for k, v in attrs_p.items()) + f"  [{card}]")
    if any(v["local_bytes"] or v.get("spill_bytes") for v in attrs_p.values()):
        raise AssertionError(f"a B16 build keeps local memory: {attrs_p}")
    attrs_e = ee.attributes()
    say("exact", "B17 and B18 builds (registers, local bytes, spill bytes, resident blocks an SM of threads): "
        + "; ".join(f"{k} {v['registers']}, {v['local_bytes']}, {v.get('spill_bytes')}, {v['blocks_per_sm']} of "
                    f"{v['threads']}" for k, v in attrs_e.items()) + f"  [{card}]")
    if any(v["local_bytes"] > 16 for v in attrs_e.values()):
        raise AssertionError(f"a B17 or B18 build keeps more local memory than a spill: {attrs_e}")

    def prologue_equal(g, a, b, label: str, **kw) -> None:
        """B16 at queries (a, b) on the card bit-equal to its plain version
        on the same queries on the host."""
        want = ep.prologue_ref(a.cpu(), b.cpu(), ep.geo_of(g), g.num_lon, g.num_lat, kw["round_anchor"],
                               kw["fields"], kw["eps_scale"])
        exact_equal(tuple(t.cpu() for t in ep.prologue(g, a, b, **kw)), want, f"B16 {label}")

    n_b16 = 0
    for rnd in (True, False):
        for dt in (torch.int64, torch.int32):
            for eps in (texact.EPS_SCALE, 2.0**41 + 1.0):  # the second makes keys inexact: counted alike
                prologue_equal(g64, ck_t.to(dt), rk_t.to(dt), f"stand-in {'round' if rnd else 'floor'} {dt} {eps}",
                               round_anchor=rnd, fields=ep.CELL_FIELDS, eps_scale=eps)
                n_b16 += 1
        for fields in (ep.KEYS | ep.ALIGNED | ep.FLAT, ep.KEYS | ep.GEO, ep.KEYS | ep.GRID, ep.GRID):
            prologue_equal(g64, ck_t, rk_t, f"stand-in fields {fields}", round_anchor=rnd, fields=fields,
                           eps_scale=texact.EPS_SCALE)
            n_b16 += 1
    say("exact", f"B16 bit-equal to its plain version at the stand-in's {len(rk)} cells: round and floor anchors, "
        f"int64 and int32 cells, every field and each entry point's fields, and with EPS_SCALE 2**41 + 1 (inexact "
        f"keys counted alike); {n_b16} cases")
    ex_in = exact_kernels_equal(g64, rk, ck, "stand-in")
    g32_k = RegularGrid.from_nan_array(reduced_k, KEXT, dtype=torch.float32, device=dev)
    exact_kernels_equal(g32_k, rk, ck, "stand-in f32")
    del g32_k
    say("exact", f"B13 (selection, table solve; aligned, and on the residue planes with duplicated cells and "
        f"non-aligned queries) and B14 (cell-aligned at the round and floor anchors with anchors past the grid to "
        f"the ends of int64, odd keys at 1e5 anchors, with the table solve) bit-equal to their plain versions at "
        f"the stand-in's {len(rk)} cells, f64 and f32 grids")
    red_sp, rc_sp, _ = mask_grid(shelf_seamount(256, 320), 0.995, seed=6)
    g_sp = RegularGrid.from_nan_array(red_sp, Extent(74.615, 84.785, -58.2508, -49.6982), dtype=torch.float64,
                                      device=dev)
    exact_kernels_equal(g_sp, rc_sp[:, 0], rc_sp[:, 1], "sparse 256x320")
    found_sp = es.dense_select(g_sp, *tfast._round_queries(g_sp, rc_sp[:, 0], rc_sp[:, 1])[1])[0]
    say("exact", f"sparse 256x320 ({int(g_sp.valid.sum())} observed cells, {len(rc_sp)} queries, "
        f"{int((found_sp < 4).sum())} of them never holding 4): B13 and B14 bit-equal to plain")
    for case in tcuda.EXACT_EDGE_CASES:
        red_e, rc_e, ext_e = tcuda._edge_plane(case)
        for dt in (torch.float32, torch.float64):
            exact_kernels_equal(RegularGrid.from_nan_array(red_e, ext_e, dtype=dt, device=dev), rc_e[:, 0],
                                rc_e[:, 1], f"{case} {dt}")
    say("exact", f"the card tests' edge grids {list(tcuda.EXACT_EDGE_CASES)}, f32 and f64: B13 and B14 bit-equal "
        f"to plain")
    gA64 = RegularGrid.from_nan_array(shelf_seamount(*GRID_A_SHAPE), GRID_A_EXTENT, dtype=torch.float64, device=dev)
    qlo_a, qla_a = (t.cpu().numpy().astype(np.float64) for t in scattered_queries(
        GRID_A_EXTENT, GRID_A_SHAPE[0], GRID_A_SHAPE[1], 100_000, 19, dev))
    lo_odd, la_odd = qlo_a.copy(), qla_a.copy()
    lo_odd[::13], la_odd[::17], lo_odd[::29], la_odd[::31] = np.nan, np.inf, -np.inf, np.nan
    lo_odd[5::41] = GRID_A_EXTENT.max_lon + 1e-3  # past the edge
    for rnd in (True, False):
        prologue_equal(gA64, torch.as_tensor(lo_odd, device=dev), torch.as_tensor(la_odd, device=dev),
                       f"Grid A scattered {'round' if rnd else 'floor'}", round_anchor=rnd, fields=ep.GRID,
                       eps_scale=texact.EPS_SCALE)
    say("exact", f"B16 bit-equal to its plain version at {len(qlo_a)} Grid A exact queries with NaN, ±inf and "
        f"out-of-grid coordinates added, round and floor anchors")
    sc_in = {}
    for anchor in ("round", "floor"):
        _, _, xa, ya, cia, cja, _ = texact._prepare_scattered(gA64, qlo_a, qla_a, anchor)
        sc_in[anchor] = [texact._on(gA64, a, t) for a, t in ((cia, torch.int64), (cja, torch.int64),
                                                              (xa, torch.float64), (ya, torch.float64))]
        exact_equal(es.ring_select(gA64, *sc_in[anchor]),
                    es.ring_select_ref(gA64.elev, gA64.valid, *sc_in[anchor], None, 10, 16384),
                    f"B14 scattered {anchor}")
        odd_sc = [t.clone() for t in sc_in[anchor]]
        odd_sc[2][::13], odd_sc[3][::17], odd_sc[2][::29] = float("nan"), float("inf"), -1e308
        exact_equal(es.ring_select(gA64, *odd_sc), es.ring_select_ref(gA64.elev, gA64.valid, *odd_sc, None, 10, 16384),
                    f"B14 scattered {anchor}, NaN and inf coordinates")
    say("exact", f"B14 scattered (f64 distances) bit-equal to plain at {len(qlo_a)} Grid A queries, round and floor "
        f"anchors, and with NaN and inf coordinates")

    # B17 and B18 against their plain versions (the torch ops on the card)
    # at full size, bit for bit: at the stand-in's cells (f64 and f32; B17
    # on strict kriging's selection with rows made singular, with found 0-3
    # and at NaN and ±inf coordinates added, and its fallback mean into an
    # output; B18's four builds, scattered at 1e5 stand-in queries with
    # NaN, ±inf and out-of-grid ones), then at the 1e5 Grid A queries with
    # theirs (B17 on the scattered selection, B18 scattered)
    lo_k, la_k = (t.cpu().numpy().astype(np.float64) for t in scattered_queries(KEXT, *SHAPE, 100_000, 24, dev))
    lo_k[::13], la_k[::17], lo_k[::29], la_k[::31] = np.nan, np.inf, -np.inf, np.nan
    lo_k[5::41] = KEXT.max_lon + 1e-3
    lo_kt, la_kt = (torch.as_tensor(a, device=dev) for a in (lo_k, la_k))
    ee.reset_launches()
    for g_e in (g64, RegularGrid.from_nan_array(reduced_k, KEXT, dtype=torch.float32, device=dev)):
        tcuda.epilogue_equal(g_e, tcuda.epilogue_krige_operands(g_e, rk, ck),
                             *tcuda.epilogue_patch_operands(g_e, rk, ck, lo_kt, la_kt), chunk=16384)
        del g_e
    lo_ot, la_ot = (torch.as_tensor(a, device=dev) for a in (lo_odd, la_odd))
    q_a = texact.scattered_tensors(gA64, lo_ot, la_ot, "round")
    sel_a = texact._select_scattered(gA64, q_a.ci, q_a.cj, q_a.x, q_a.y, 10, 16384)
    exact_equal(ee.krige(gA64, *sel_a, q_a.qlon, q_a.qlat),
                ee.krige_ref(*sel_a, q_a.qlon, q_a.qlat, ee.scalars_of(gA64)), "B17 Grid A")
    q_f = texact.scattered_tensors(gA64, lo_ot, la_ot, "floor")
    for kind in ee.KINDS:
        oob_ = q_f.oob if kind == "cubic" else None
        exact_equal(ee.patch(gA64, kind, q_f.ci, q_f.cj, q_f.x, q_f.y, at_cells=False, oob=oob_),
                    ee.patch_ref(gA64.elev, gA64.valid, q_f.ci, q_f.cj, q_f.x, q_f.y, None, None, oob_,
                                 ee.KINDS[kind], False, 16384), f"B18 {kind} Grid A")
    if ee.LAUNCHES != {"exact_krige": 7, "exact_patch": 10}:
        raise AssertionError(f"the epilogues' checks launched {ee.LAUNCHES}")
    say("exact", f"B17 (the solve at int32 and int64 cells, singular systems, found 0-3, NaN and ±inf coordinates; "
        f"the fallback mean into an output) and B18 (bilinear and cubic, at cells and scattered) bit-equal to their "
        f"plain versions at the stand-in's {len(rk)} cells (f64 and f32) and {len(lo_k)} stand-in queries with NaN, "
        f"±inf and out-of-grid ones, and B17 and B18 scattered at the {len(qlo_a)} Grid A queries with theirs")
    # one B13 launch a dense call: on the aligned path the bit plane's build
    # and B13, and no other kernel (no residue planes)
    es.reset_launches()
    seen = device_kernels(lambda: es.dense_select(g64, *ex_in["dense_in"]))
    n_dense = sum(v for k, v in seen.items() if "dense_kernel" in k)
    n_bits = sum(v for k, v in seen.items() if "bits_kernel" in k)
    if es.LAUNCHES["exact_dense"] != 21 or not 0 < n_dense <= 20 or not 0 < n_bits <= 20 or \
            any("dense_kernel" not in k and "bits_kernel" not in k for k in seen):
        raise AssertionError(f"dense_select: {es.LAUNCHES} launches over 21 calls, device records {seen}")
    say("exact", f"one B13 launch a dense call (dense_select on the aligned path): 21 launches over 21 calls; the "
        f"device records of 20 profiled calls {seen} (the bit plane's build and B13 alone)")

    # synthetic grids with awkward decimals: the strict selection against
    # the golden engine's ring selection, the predictions against its own
    awkward = Extent(74.615, 84.785, -58.2508, -49.6982)
    for removal, seed in ((0.1, 2), (0.5, 3), (0.9, 4)):
        red_s, rc_s, _ = mask_grid(shelf_seamount(256, 320), removal, seed=seed)
        g_s = RegularGrid.from_nan_array(red_s, awkward, dtype=torch.float64, device=dev)
        exact_kernels_equal(g_s, rc_s[:, 0], rc_s[:, 1], f"awkward r{removal}")
        gold = GoldenGrid(red_s, awkward.min_lon, awkward.max_lon, awkward.min_lat, awkward.max_lat)
        qlon = gold.min_lon + rc_s[:, 1] * gold.lon_step
        qlat = gold.min_lat + rc_s[:, 0] * gold.lat_step
        x_s, y_s = (qlon - gold.min_lon) / gold.lon_step, (qlat - gold.min_lat) / gold.lat_step
        ci = np.clip(np.floor(x_s + 0.5).astype(np.int64), 0, gold.num_lon - 1)
        cj = np.clip(np.floor(y_s + 0.5).astype(np.int64), 0, gold.num_lat - 1)
        sv, si, sj, f_g = gold._ring_select(x_s, y_s, ci, cj)
        f_t, v_t, gi_t, gj_t, _ = texact.exact_select_at_cells(g_s, rc_s[:, 0], rc_s[:, 1])
        full = f_g >= 4
        if not (np.array_equal(f_t, f_g) and np.array_equal(gi_t[full], si[full, :4])
                and np.array_equal(gj_t[full], sj[full, :4]) and np.array_equal(v_t[full], sv[full, :4])):
            raise AssertionError(f"exact selection r{removal}: differs from GoldenGrid._ring_select")
        worst = 0.0
        for label, got, want in (
            ("strict kriging", texact.exact_kriging_at_cells(g_s, rc_s[:, 0], rc_s[:, 1]), gold.kriging(qlon, qlat)),
            ("two-tier kriging", tfast.exact_kriging_at_cells_fast(g_s, rc_s[:, 0], rc_s[:, 1]),
             gold.kriging(qlon, qlat)),
            ("cubic", texact.exact_cubic_at_cells(g_s, rc_s[:, 0], rc_s[:, 1]), gold.cubic(qlon, qlat)),
            ("bilinear", texact.exact_bilinear_at_cells(g_s, rc_s[:, 0], rc_s[:, 1]), gold.bilinear(qlon, qlat)),
        ):
            if not np.array_equal(np.isnan(got), np.isnan(want)):
                raise AssertionError(f"exact {label} r{removal}: NaN placement differs from the golden engine")
            ok_ = ~np.isnan(want)
            d_ = float(np.abs(got[ok_] - want[ok_]).max())
            if not d_ <= EXACT_TOL:
                raise AssertionError(f"exact {label} r{removal}: max |diff| from the golden engine {d_} > {EXACT_TOL}")
            worst = max(worst, d_)
        say("exact", f"256x320 shelf+seamount r{removal} (awkward extent), {len(rc_s)} cells ({int(full.sum())} "
            f"with 4 found): B13 and B14 bit-equal to plain; found, values and ordered gi/gj equal to "
            f"GoldenGrid._ring_select; strict and two-tier kriging, cubic and bilinear within {worst:.3g} m of the "
            f"golden engine")

    # C7: the caller's radius.  B13 and B14 (the builds that take the radius
    # at run time) bit-equal to plain at the stand-in's cells at radius 3
    # and 16, and on the sparse grid, whose walks reach the far rings, at 3,
    # 16 and 40.  Every exact entry point that selects, on the card, at 3
    # and 16: at the stand-in's cells radius 16 answers as radius 10 bit for
    # bit (no walk there passes ring 10), so the pins hold, and radius 3's
    # cells that differ are counted; on a 256x320 grid masked 50 % (at its
    # cells and at 1e4 scattered queries) each against the CPU's within
    # EXACT_TOL
    t_r = time.perf_counter()
    for R_ in (3, 16):
        exact_kernels_equal(g64, rk, ck, f"stand-in R={R_}", R_)
    for R_ in (3, 16, 40):
        exact_kernels_equal(g_sp, rc_sp[:, 0], rc_sp[:, 1], f"sparse 256x320 R={R_}", R_)
    at_r = {}
    with host_views_refused(texact):
        for R_ in (3, 16):
            at_r[R_] = {"kriging_two": tfast.exact_kriging_at_cells_fast(g64, rk_t, ck_t, max_radius=R_),
                        "kriging_strict": texact.exact_kriging_at_cells(g64, rk_t, ck_t, max_radius=R_),
                        "cubic": texact.exact_cubic_at_cells(g64, rk_t, ck_t, max_radius=R_)}
    for key, v in at_r[16].items():
        if not np.array_equal(v, preds[key], equal_nan=True):
            raise AssertionError(f"exact {key} at radius 16 differs from radius 10 at the stand-in's cells")
    for key in ("kriging_two", "cubic"):
        exact_pin(key, at_r[16][key], truth_k)
    n_r3 = {k: int((v != preds[k]).sum() - (np.isnan(v) & np.isnan(preds[k])).sum()) for k, v in at_r[3].items()}
    red_c, rc_c, _ = mask_grid(shelf_seamount(256, 320), 0.5, seed=3)
    g_c, g_h = (RegularGrid.from_nan_array(red_c, awkward, dtype=torch.float64, device=d) for d in (dev, "cpu"))
    rng_c = np.random.default_rng(27)
    lo_c = rng_c.uniform(awkward.min_lon, awkward.max_lon, 10_000)
    la_c = rng_c.uniform(awkward.min_lat, awkward.max_lat, 10_000)
    worst_r = 0.0
    for R_ in (3, 16):
        for label, call in (
            ("strict kriging", lambda g: texact.exact_kriging_at_cells(g, rc_c[:, 0], rc_c[:, 1], max_radius=R_)),
            ("two-tier kriging", lambda g: tfast.exact_kriging_at_cells_fast(g, rc_c[:, 0], rc_c[:, 1],
                                                                            max_radius=R_)),
            ("two-tier kriging (coords)", lambda g: tfast.exact_kriging_at_cells_fast(
                g, rc_c[:, 0], rc_c[:, 1], solve="coords", max_radius=R_)),
            ("cubic", lambda g: texact.exact_cubic_at_cells(g, rc_c[:, 0], rc_c[:, 1], max_radius=R_)),
            ("scattered kriging", lambda g: texact.exact_kriging_scattered(g, lo_c, la_c, max_radius=R_)),
            ("scattered cubic", lambda g: texact.exact_cubic_scattered(g, lo_c, la_c, max_radius=R_)),
        ):
            got, want = call(g_c), call(g_h)
            if not np.array_equal(np.isnan(got), np.isnan(want)):
                raise AssertionError(f"exact {label} at radius {R_}: NaN placement differs from the CPU's")
            d_ = float(np.nanmax(np.abs(got - want))) if np.isfinite(want).any() else 0.0
            if not d_ <= EXACT_TOL:
                raise AssertionError(f"exact {label} at radius {R_}: max |diff| from the CPU {d_} > {EXACT_TOL}")
            worst_r = max(worst_r, d_)
    say("exact", f"radius 3, 16 (and 40 on the sparse grid): B13 and B14 bit-equal to plain at the stand-in's "
        f"{len(rk)} cells and the sparse 256x320 grid; at the stand-in radius 16 answers as radius 10 bit for bit "
        f"(pins held), radius 3 differs at {n_r3} cells; every entry point that selects on a 256x320 grid masked "
        f"50 % ({len(rc_c)} cells, {len(lo_c)} scattered queries) within {worst_r:.3g} m of the CPU's, NaN alike "
        f"({time.perf_counter() - t_r:.1f} s)")

    # both CLIs' exact modes
    res_x = os.path.join(REPO, "results_local", "chip_smoke_exact.csv")
    if os.path.exists(res_x):
        os.remove(res_x)
    pin_of = {"Kriging": "kriging_two", "Cubic": "cubic", "Bilinear": "bilinear"}
    es.reset_launches()
    ep.reset_launches()
    ee.reset_launches()
    with host_views_refused(texact):
        for tier in ("two", "strict"):
            summary_x = bench_grid_b.main(["--region", "kerguelen", "--removal", str(REMOVAL), "--selection", "exact",
                                           "--exact-tier", tier, "--results", res_x, "--machine", "H100"])
            for method, m in summary_x.items():
                tol = EXACT_STRICT_TOL if (method == "Kriging" and tier == "strict") else EXACT_TOL
                want = EXACT_PINS[pin_of[method]]["RMSE"]
                if not abs(m["RMSE"] - want) <= tol:
                    raise AssertionError(f"bench_grid_b exact ({tier}) {method}: RMSE {m['RMSE']} != {want} +- {tol}")
            say("exact", f"bench_grid_b --selection exact --exact-tier {tier}: " + ", ".join(
                f"{k} RMSE {v['RMSE']:.9f} steady {v['steady_ms']:.2f} ms, end-to-end {v['e2e_ms']:.2f} ms"
                for k, v in summary_x.items()) + f"  [{card}]")
        for wr in ([], ["--window-radius", "3"]):
            summary_ax = bench_grid_a.main(["--selection", "exact", "--batch-sizes", "1000", "100000", *wr,
                                            "--results", res_x, "--machine", "H100"])
            if sorted(summary_ax) != sorted((m, n) for m in ("Bilinear", "Cubic", "Kriging")
                                            for n in (1000, 100000)) or \
                    not all(v["validated"] for v in summary_ax.values()):
                raise AssertionError(f"bench_grid_a --selection exact {' '.join(wr)}: {summary_ax}")
            say("exact", f"bench_grid_a --selection exact {' '.join(wr)}: every golden validation PASSED (1e-9 x "
                "scale); " + ", ".join(f"{m} n={n} steady {v['steady_ms']:.2f} ms"
                                       for (m, n), v in summary_ax.items()) + f"  [{card}]")
    launches_exc = {**es.LAUNCHES, **ep.LAUNCHES, **ee.LAUNCHES}
    if not all(n > 0 for n in launches_exc.values()):
        raise AssertionError(f"the exact CLIs' launches {launches_exc}: B13, B14, B16, B17 and B18 must all run")

    # timing: each entry point before (scripts/exact_torch_epilogue.py: the
    # epilogues as torch ops) and after (B17, B18), in turns (before, after,
    # after, before): on the host clock, by its device records (idle
    # share), by its synchronising calls and by the CUDA kernels a call
    # launches (after: pinned); the answers equal.  Every call takes its
    # queries on the card, as the CLIs pass them: the cell-aligned entries
    # the stand-in's cells, the scattered ones the 1e5 Grid A queries (f64)
    before_ = load_script("exact_torch_epilogue")
    qlo_t, qla_t = (torch.as_tensor(a, device=dev) for a in (qlo_a, qla_a))
    ab = {
        "kriging_two": (lambda: before_.exact_kriging_at_cells_fast(g64, rk_t, ck_t), exact_fns["kriging_two"]),
        "kriging_strict": (lambda: before_.exact_kriging_at_cells(g64, rk_t, ck_t), exact_fns["kriging_strict"]),
        "cubic": (lambda: before_.exact_cubic_at_cells(g64, rk_t, ck_t), exact_fns["cubic"]),
        "bilinear": (lambda: before_.exact_bilinear_at_cells(g64, rk_t, ck_t), exact_fns["bilinear"]),
        "kriging scattered": (lambda: before_.exact_kriging_scattered(gA64, qlo_t, qla_t),
                              lambda: texact.exact_kriging_scattered(gA64, qlo_t, qla_t)),
        "cubic scattered": (lambda: before_.exact_cubic_scattered(gA64, qlo_t, qla_t),
                            lambda: texact.exact_cubic_scattered(gA64, qlo_t, qla_t)),
        "bilinear scattered": (lambda: before_.exact_bilinear_scattered(gA64, qlo_t, qla_t),
                               lambda: texact.exact_bilinear_scattered(gA64, qlo_t, qla_t)),
    }
    syncs_x, kernels_x = {}, {}
    for label, (before, after) in ab.items():
        if not np.array_equal(before(), after(), equal_nan=True):
            raise AssertionError(f"exact {label}: the answers before and after B17 and B18 differ")
        runs = {"before": [], "after": []}
        for which in ("before", "after", "after", "before"):
            fn = before if which == "before" else after
            runs[which].append((host_ms(fn, reps=3), device_busy_ms(fn)))
        syncs_x[label] = {which: sync_calls(before if which == "before" else after) for which in runs}
        kernels_x[label] = {which: kernels_a_call(before if which == "before" else after) for which in runs}
        for which, r in runs.items():
            ms[f"exact {label} host {which}"] = float(np.median([h for h, _ in r]))
            ms[f"exact {label} device {which}"] = float(np.median([d for _, d in r]))
        n_q = len(rk) if "scattered" not in label else len(qlo_a)
        say("timing", f"exact {label:18s} at {n_q} queries, before | after: host " + ", ".join(
            f"{h:.2f}" for h, _ in runs["before"]) + " | " + ", ".join(f"{h:.2f}" for h, _ in runs["after"])
            + " ms; device busy " + ", ".join(f"{d:.3f}" for _, d in runs["before"]) + " | " + ", ".join(
            f"{d:.3f}" for _, d in runs["after"]) + " ms; idle " + " | ".join(
            f"{1 - ms[f'exact {label} device {w}'] / ms[f'exact {label} host {w}']:.1%}" for w in runs)
            + f"; synchronising calls {syncs_x[label]['before']} | {syncs_x[label]['after']}; CUDA kernels a call "
            f"{kernels_x[label]['before']} | {kernels_x[label]['after']}  [{card}]")
    after_syncs = {k: v["after"] for k, v in syncs_x.items()}
    if after_syncs != EXACT_SYNCS:
        raise AssertionError(f"exact mode's synchronising calls a call {after_syncs}, pinned {EXACT_SYNCS}")
    after_kernels = {k: v["after"] for k, v in kernels_x.items()}
    if after_kernels != EXACT_KERNELS:
        raise AssertionError(f"exact mode's CUDA kernels a call {after_kernels}, pinned {EXACT_KERNELS}")
    for label in ("kriging_strict", "cubic", "kriging scattered"):
        for which, fn in zip(("before", "after"), ab[label]):
            sp = host_split_ms(fn)
            say("timing", f"exact {label} {which} host split (cProfile on): {sp['total']:.2f} ms = the prologue "
                f"{sp['prepare']:.2f} + the epilogue {sp['epilogue']:.2f} + readbacks (waiting for the card "
                f"included) {sp['readbacks']:.2f} + the selections' dispatch and glue {sp['dispatch']:.2f}  [{card}]")
    dense_in, tabs = ex_in["dense_in"], ex_in["tabs"]
    dense_plain_args = (g64.valid, dense_in[2], dense_in[1][0], dense_in[1][1])  # aligned: flat_a is flat_q
    for label, fn in (("dense pass", lambda: es.dense_select(g64, *dense_in)),
                      ("dense pass plain", lambda: tfast._dense_select(*dense_plain_args, max_radius=10))):
        ms[f"exact {label}"] = host_ms(fn, reps=3)
        ms[f"exact {label} device"] = device_busy_ms(fn)
        say("timing", f"exact {label:16s} at {len(rk)} cells: {ms[f'exact {label}']:.2f} ms host, "
            f"{ms[f'exact {label} device']:.2f} ms device busy  [{card}]")

    # B16 alone (kernel records), through its wrapper (events) and as
    # plain (torch ops on the card), at the stand-in's cells with two-tier
    # kriging's fields (keys, aligned, the clipped cell)
    b16_kw = dict(round_anchor=True, fields=ep.KEYS | ep.ALIGNED | ep.FLAT, eps_scale=texact.EPS_SCALE)
    b16_geo = ep.geo_of(g64)
    ms["B16 alone"] = device_ms(lambda: ep.prologue(g64, ck_t, rk_t, **b16_kw), "prologue_kernel")
    # back to back its 8 MB of queries stay in the 50 MB L2 and its outputs
    # land there: cold, a 128 MB write before each call evicts them
    ms["B16 cold"] = device_ms(lambda: ep.prologue(g64, ck_t, rk_t, **b16_kw), "prologue_kernel", cold=True)
    ms["B16 wrapper"] = time_ms(lambda: ep.prologue(g64, ck_t, rk_t, **b16_kw))
    ms["B16 plain"] = time_ms(lambda: ep.prologue_ref(ck_t, rk_t, b16_geo, g64.num_lon, g64.num_lat,
                                                      *b16_kw.values()), warmup=1, reps=5)
    # per query: the int64 column and row read, the anchors (16), oob (1),
    # keys (8), variant (4), aligned (1) and cell (8) written; ~30 f64
    # operations (the round-trip, the anchors, two residues, the checks)
    bounds_b16 = bound(len(rk) * (16.0 + 16 + 1 + 8 + 4 + 1 + 8) + 8, 0.0, 30.0 * len(rk))
    say("timing", f"B16 at {len(rk)} stand-in cells (two-tier's fields): alone {ms['B16 alone']:.4f} ms (cold "
        f"{ms['B16 cold']:.4f}), wrapper "
        f"{ms['B16 wrapper']:.4f} ms, plain {ms['B16 plain']:.2f} ms; bound {bounds_b16[0]:.4f} ms ({bounds_b16[1]}; "
        f"{bounds_b16[0] / ms['B16 alone']:.0%} of it; cold {bounds_b16[0] / ms['B16 cold']:.0%})  [{card}]")

    # B17 and B18 alone (kernel records), through their wrappers (events)
    # and as plain (the torch ops on the card): B17 on strict kriging's
    # selection at the stand-in's cells, B18 in every build: cubic and
    # bilinear at the stand-in's cells, scattered at the 1e5 Grid A queries;
    # B17's fallback mean alone into the scattered cubic's output at the 1e5
    # stand-in queries (Grid A's grid is whole: no patch there falls back)
    from auvtpu_torch.kernels.exact_prologue import GEO as EGEO, GRID as EGRID, KEYS as EKEYS

    q_r = texact.query_tensors(g64, rk_t, ck_t, anchor="round", fields=EKEYS | EGEO)
    sel_r = texact._select_cells(g64, q_r, None, 10, 16384)
    q_fl = texact.query_tensors(g64, rk_t, ck_t, anchor="floor", fields=EKEYS | EGRID)
    sel_fl = texact._select_cells(g64, q_fl, None, 10, 16384)
    q_g = texact.scattered_tensors(gA64, qlo_t, qla_t, "floor")
    scal64 = ee.scalars_of(g64)
    epi = {
        "B17": (lambda: ee.krige(g64, *sel_r, q_r.qlon, q_r.qlat),
                lambda: ee.krige_ref(*sel_r, q_r.qlon, q_r.qlat, scal64), "krige_kernel"),
        "B18 cubic cells": (lambda: ee.patch(g64, "cubic", q_fl.ci, q_fl.cj, q_fl.x, q_fl.y, at_cells=True,
                                             found=sel_fl[0], sel_val=sel_fl[1]),
                            lambda: ee.patch_ref(g64.elev, g64.valid, q_fl.ci, q_fl.cj, q_fl.x, q_fl.y, sel_fl[0],
                                                 sel_fl[1], None, 1, True, len(rk)), "patch_kernel"),
        "B18 bilinear cells": (lambda: ee.patch(g64, "bilinear", q_fl.ci, q_fl.cj, q_fl.x, q_fl.y, at_cells=True),
                               lambda: ee.patch_ref(g64.elev, g64.valid, q_fl.ci, q_fl.cj, q_fl.x, q_fl.y, None, None,
                                                    None, 0, True, len(rk)), "patch_kernel"),
        "B18 cubic scattered": (lambda: ee.patch(gA64, "cubic", q_g.ci, q_g.cj, q_g.x, q_g.y, at_cells=False,
                                                 oob=q_g.oob),
                                lambda: ee.patch_ref(gA64.elev, gA64.valid, q_g.ci, q_g.cj, q_g.x, q_g.y, None, None,
                                                     q_g.oob, 1, False, 16384), "patch_kernel"),
        "B18 bilinear scattered": (lambda: ee.patch(gA64, "bilinear", q_g.ci, q_g.cj, q_g.x, q_g.y, at_cells=False),
                                   lambda: ee.patch_ref(gA64.elev, gA64.valid, q_g.ci, q_g.cj, q_g.x, q_g.y, None,
                                                        None, None, 0, False, 16384), "patch_kernel"),
    }
    q_s = texact.scattered_tensors(g64, lo_kt, la_kt, "floor")
    need_g = ee.patch(g64, "cubic", q_s.ci, q_s.cj, q_s.x, q_s.y, at_cells=False, oob=q_s.oob)[1]
    idx_g = torch.nonzero(need_g)[:, 0]
    if not len(idx_g):
        raise AssertionError("no stand-in query's patch falls back: B17's fallback mean has nothing to time")
    sel_g = texact._select_scattered(g64, *(a[idx_g] for a in (q_s.ci, q_s.cj, q_s.x, q_s.y)), 10, 16384)
    out_g = torch.zeros(len(lo_k), dtype=torch.float64, device=dev)
    epi["B17 mean"] = (lambda: ee.krige_mean_into(out_g, idx_g, *sel_g[:2]),
                       lambda: ee.mean_into_ref(*sel_g[:2], idx_g, out_g), "krige_kernel")
    for label, (fn, plain, name) in epi.items():
        ms[f"{label} alone"] = device_ms(fn, name)
        ms[f"{label} wrapper"] = time_ms(fn)
        ms[f"{label} plain"] = time_ms(plain, warmup=1, reps=5)

    def distinct_cells(flat) -> int:
        return int(torch.unique(flat.reshape(-1)).numel())

    # bounds from this run's data, what each design must read: per query
    # the operands it uses and its output once, and each distinct grid cell
    # its gathers must read once (8 bytes a cell of elev or valid on the f64
    # grids); f64 operations: B17 ~650 a solved query (14 distances and
    # variogram values, an exp counted as 20, the centres, the
    # elimination's ~180, the sum) and 5 a fallback; B18 ~25 a Catmull-Rom
    # pass (five a query) or ~15 a bilinear.  B18's cubic at cells reads
    # ci, cj, x and y, the validity of the centre cell nearest the query,
    # then the sixteen up to the first invalid one (row-major), the values
    # of a whole patch, and the selection (found, sel_val) of any other;
    # the bilinear reads its four corners' validity, the values of the
    # valid ones, and x and y where all four are valid
    n_k, n_g = float(len(rk)), float(len(qlo_a))
    n_solved = float((sel_r[0] >= 4).sum())
    H64, W64 = g64.shape
    HA, WA = gA64.shape

    def patch_flat(ci, cj, H, W, offs):
        rel = torch.tensor(offs, device=dev)
        jj = (cj[:, None] + rel).clamp(0, H - 1)
        ii = (ci[:, None] + rel).clamp(0, W - 1)
        return jj[:, :, None] * W + ii[:, None, :]

    def cubic_cells_reads(g, q):
        """(bytes, validity cells, value cells, whole patches) the cubic at
        cells must read at queries q."""
        H, W = g.shape
        flat = patch_flat(q.ci, q.cj, H, W, (-1, 0, 1, 2)).reshape(-1, 16)
        ok = g.valid.reshape(-1)[flat] > 0.5
        near = 4 * (1 + (q.y - q.cj >= 0.5).long()) + 1 + (q.x - q.ci >= 0.5).long()
        first = ok.gather(1, near[:, None])[:, 0]
        before = torch.cumprod(torch.cat([torch.ones_like(ok[:, :1]), ok[:, :-1]], 1).int(), 1).bool()
        read = before & first[:, None]
        read.scatter_(1, near[:, None], True)
        whole = ok.all(1)
        cells_v, cells_z = distinct_cells(flat[read]), distinct_cells(flat[whole])
        n, nw = float(len(flat)), float(whole.sum())
        return n * (16 + 16 + 8) + (n - nw) * (4 + 32) + 8.0 * (cells_v + cells_z), cells_v, cells_z, int(nw)

    def bilinear_reads(g, q):
        """(bytes, validity cells, value cells) the bilinear must read at
        queries q (corners from the clamped anchor: the same cells at every
        in-grid query)."""
        H, W = g.shape
        flat = patch_flat(q.ci.clamp(0, W - 1), q.cj.clamp(0, H - 1), H, W, (0, 1)).reshape(-1, 4)
        ok = g.valid.reshape(-1)[flat] > 0.5
        cells_v, cells_z = distinct_cells(flat), distinct_cells(flat[ok])
        n, n4 = float(len(flat)), float(ok.all(1).sum())
        return n * (16 + 8) + n4 * 16 + 8.0 * (cells_v + cells_z), cells_v, cells_z

    cc, bc, bs = cubic_cells_reads(g64, q_fl), bilinear_reads(g64, q_fl), bilinear_reads(gA64, q_g)
    cells_cs = distinct_cells(patch_flat(q_g.ci, q_g.cj, HA, WA, (-1, 0, 1, 2)))
    bounds_e = {
        "B17": bound(n_k * (4 + 32 + 16 + 16 + 8 + 8 + 8), 0.0, 650.0 * n_solved + 5.0 * n_k),
        "B18 cubic cells": bound(cc[0], 0.0, 130.0 * cc[3] + 5.0 * (n_k - cc[3])),
        "B18 bilinear cells": bound(bc[0], 0.0, 15.0 * n_k),
        "B18 cubic scattered": bound(n_g * (16 + 16 + 1 + 8 + 1) + 16.0 * cells_cs, 0.0, 130.0 * n_g),
        "B18 bilinear scattered": bound(bs[0], 0.0, 15.0 * n_g),
        "B17 mean": bound(float(len(idx_g)) * (4 + 32 + 8 + 8), 0.0, 5.0 * len(idx_g)),
    }
    # B17's FP64 issue: its f64 build's static count of FP64-pipe
    # instructions (scripts/sass_tools.py) at 64 lanes a clock an SM, a
    # solved query each; the count holds both solves (the shared
    # reciprocals' and the IEEE one taken where a quotient leaves their
    # guard) and the divisions' slow paths, so it is an estimate, not a
    # floor
    sass = load_script("sass_tools")
    f64_ins = sass.fp64_instructions(kbuild.library_path("exact_epilogue"), "krige_kernel<double, int, false>")
    clock_hz = float(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
                                     "--format=csv,noheader,nounits"], capture_output=True, text=True,
                                    timeout=60, check=True).stdout.split()[0]) * 1e6
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ms["B17 FP64 issue estimate"] = n_solved * f64_ins / 64 / (n_sm * clock_hz) * 1e3
    for label in epi:
        b_ = bounds_e[label]
        say("timing", f"{label:22s}: alone {ms[f'{label} alone']:.4f} ms, wrapper {ms[f'{label} wrapper']:.4f} ms, "
            f"plain {ms[f'{label} plain']:.3f} ms; bound {b_[0]:.4f} ms ({b_[1]}; {b_[0] / ms[f'{label} alone']:.0%} "
            f"of it)  [{card}]")
    say("timing", f"B17's FP64 issue estimate {ms['B17 FP64 issue estimate']:.4f} ms "
        f"({ms['B17 FP64 issue estimate'] / ms['B17 alone']:.0%} of its time; {f64_ins} FP64-pipe SASS instructions "
        f"in krige_kernel<double, int32, solve>, run or not, both solves, at {clock_hz / 1e6:.0f} MHz on {n_sm} SMs; "
        f"not a floor)  [{card}]")
    say("bounds", f"epilogues: {int(n_solved)} of {len(rk)} stand-in cells solved by B17; distinct cells B18 must "
        f"read (validity, values): cubic at the stand-in's cells {cc[1]}, {cc[2]} ({cc[3]} whole patches), bilinear "
        f"{bc[1]}, {bc[2]}; at Grid A cubic {cells_cs} each, bilinear {bs[1]}, {bs[2]}; B17's fallback mean at "
        f"{len(idx_g)} of {len(lo_k)} stand-in queries")

    # B13 and B14 alone (kernel records), through their wrappers (events)
    # and as plain, at the stand-in's cells: B13 with the solve (two-tier
    # kriging's launch) and without, B14 at the round anchor (strict
    # kriging's selection), with the solve and scattered (1e5 Grid A)
    keys_k = texact._cell_keys(g64, ex_in["q"], None)
    ring_in = (*keys_k[:2], *keys_k[3:], keys_k[2])
    b13 = {"solve": lambda: es.dense_krige(g64, *dense_in, *tabs), "select": lambda: es.dense_select(g64, *dense_in)}
    b13_plain = {"solve": lambda: es.dense_krige_ref(g64.elev, g64.valid, *dense_in, *tabs, 10),
                 "select": lambda: es.dense_select_ref(g64.elev, g64.valid, *dense_in, 10)}
    on_planes = (dense_in[2], *dense_in[1:])  # the same queries through the residue planes
    b13_planes = {"solve": lambda: es.dense_krige(g64, *on_planes, *tabs),
                  "select": lambda: es.dense_select(g64, *on_planes)}
    for b in ("solve", "select"):
        ms[f"B13 {b} alone"] = device_ms(b13[b], ("dense_kernel", "bits_kernel"))
        ms[f"B13 {b} bit plane"] = device_ms(b13[b], "bits_kernel")
        ms[f"B13 {b} wrapper"] = time_ms(b13[b])
        ms[f"B13 {b} wrapper planes"] = time_ms(b13_planes[b])
        ms[f"B13 {b} plain"] = time_ms(b13_plain[b], warmup=1, reps=5)
    b14 = {"round": lambda: es.ring_select(g64, *ring_in),
           "scattered": lambda: es.ring_select(gA64, *sc_in["round"])}
    b14_plain = {"round": lambda: es.ring_select_ref(g64.elev, g64.valid, *ring_in, 10, 16384),
                 "scattered": lambda: es.ring_select_ref(gA64.elev, gA64.valid, *sc_in["round"], None, 10, 16384)}
    for b in ("round", "scattered"):
        ms[f"B14 {b} alone"] = device_ms(b14[b], ("ring_kernel", "bits_kernel"))
        if b == "round":  # 1e5 queries on Grid A's 12.8M cells read valid: no bit plane
            ms["B14 round bit plane"] = device_ms(b14[b], "bits_kernel")
        ms[f"B14 {b} wrapper"] = time_ms(b14[b])
        ms[f"B14 {b} plain"] = time_ms(b14_plain[b], warmup=1, reps=5)
    # bounds from what this run's data reads (exact_walk): per query the
    # index, keys and outputs; each distinct validity cell the walks read
    # and value cell the selections take once, 8 bytes (f64); ~20 f32
    # operations a lane walked, ~200 f64 ones a table solve
    sel_k = es.ring_select_ref(g64.elev, g64.valid, *ring_in, 10, 16384)
    walk = exact_walk(g64, keys_k[0], keys_k[1], sel_k[2], sel_k[3], sel_k[0])
    nq_x = float(walk["queries"])
    cells_b = 8.0 * (walk["valid_cells"] + walk["value_cells"])
    bounds_x = {
        "exact_dense": bound(nq_x * (8 + 8 + 8 + 1) + cells_b, 20.0 * walk["lanes"], 200.0 * walk["solved"]),
        "exact_dense select": bound(nq_x * (8 + 8 + 4 + 1 + 4 * 8 * 3) + cells_b, 20.0 * walk["lanes"]),
        "exact_ring": bound(nq_x * (8 + 8 + 4 + 8 + 4 + 4 * (8 + 4 + 4)) + cells_b, 20.0 * walk["lanes"]),
    }
    for label, key in (("B13 solve", "exact_dense"), ("B13 select", "exact_dense select"),
                       ("B14 round", "exact_ring")):
        planes = f" ({ms[f'{label} wrapper planes']:.4f} on the residue planes)" if label.startswith("B13") else ""
        say("timing", f"{label:10s} at {len(rk)} stand-in cells: alone {ms[f'{label} alone']:.4f} ms (the bit "
            f"plane's build {ms[f'{label} bit plane']:.4f} of it), wrapper {ms[f'{label} wrapper']:.4f} ms{planes}, "
            f"plain {ms[f'{label} plain']:.2f} ms; bound {bounds_x[key][0]:.4f} ms ({bounds_x[key][1]}; "
            f"{bounds_x[key][0] / ms[f'{label} alone']:.0%} of it)  [{card}]")
    say("timing", f"B14 scattered at {len(qlo_a)} Grid A queries: alone {ms['B14 scattered alone']:.4f} ms (the walk "
        f"reads valid, no bit plane), wrapper {ms['B14 scattered wrapper']:.4f} ms, plain "
        f"{ms['B14 scattered plain']:.2f} ms  [{card}]")
    say("bounds", f"exact walk at the stand-in's cells: {walk['lanes'] / nq_x:.3f} lanes a query, "
        f"{walk['valid_cells']} validity and {walk['value_cells']} value cells read, {walk['solved']} solved")
    say("exact", f"escalated share {esc_k.mean():.6f}; launches: main path {launches_ex}, CLIs {launches_exc}; "
        f"phase took {time.perf_counter() - t_ex:.1f} s")
    del g64, preds, exact_fns, dense_in, dense_plain_args, two, strict, gA64, sc_in, ex_in, sel_k, g_sp, ab
    del qlo_t, qla_t, rk_t, ck_t, epi, q_r, sel_r, q_fl, sel_fl, q_g, q_s, need_g, idx_g, sel_g, out_g, q_a, sel_a, q_f
    del lo_kt, la_kt, lo_ot, la_ot
    torch.cuda.empty_cache()

    # ---- 20. the learned baseline at full width: the committed w16 d2
    # checkpoint fills the stand-in r0.10 (launch counts from here to the
    # end of the training run)
    from auvtpu_torch import learned

    t_ln = time.perf_counter()
    lparams, lw, ld = learned.load_params(os.path.join(REPO, "results", "learned_mid_atlantic_w16d2.npz"))
    wf.reset_launches()
    planes_l = {
        "f32": learned.fill_learned(grid, lparams, width=lw, depth=ld, compute_dtype=torch.float32),
        "bf16": learned.fill_learned(grid, lparams, width=lw, depth=ld),
    }
    launches_fill_l = wf.LAUNCHES["fill_mean_fused"]
    if launches_fill_l != 2:
        raise AssertionError(f"learned fills: {launches_fill_l} B3 mean launches for two fills, want one each")
    obs = grid.elev[grid.valid > 0.5].double()
    cell_tol = {"f32": LEARNED_F32_REL * float(obs.abs().max()), "bf16": LEARNED_BF16_STD * float(obs.std())}
    for name, plane_l in planes_l.items():
        pred_l = plane_l[rows, cols].double().cpu().numpy()
        got = dict(all_reference_metrics(truth_k, pred_l), nansum=float(torch.nansum(plane_l.double())))
        want, tol = LEARNED_PINS[name], cell_tol[name]
        for key in ("MAE", "RMSE", "MaxError", "nansum"):
            bar = tol * len(truth_k) if key == "nansum" else tol
            if not abs(got[key] - want[key]) <= bar:
                raise AssertionError(f"learned fill {name}: {key} {got[key]} != the JAX package's {want[key]} +- {bar}")
        if int(torch.isnan(plane_l).sum()) != 0:
            raise AssertionError(f"learned fill {name}: NaN cells on the stand-in")
        say("learned", f"{name} compute: held-out RMSE {got['RMSE']:.6f} (JAX {want['RMSE']:.6f}), MAE "
            f"{got['MAE']:.6f} (JAX {want['MAE']:.6f}), max {got['MaxError']:.4f}, nansum {got['nansum']:.6f} "
            f"(JAX {want['nansum']:.6f}, {abs(got['nansum'] - want['nansum']) / len(truth_k):.3g} m a masked "
            f"cell); bar {tol:.4g} m a cell")
    res_l = os.path.join(REPO, "results_local", "chip_smoke_learned.csv")
    if os.path.exists(res_l):
        os.remove(res_l)
    summary_l = learned_eval.main(["--synthetic", "512", "512", "--steps", "20", "--results", res_l,
                                   "--machine", "H100"])
    launches_l = dict(wf.LAUNCHES)
    losses = summary_l["losses"]
    if not (len(losses) == 20 and np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"learned_eval on the card: losses {losses}")
    say("learned", f"learned_eval --synthetic 512 512 --steps 20: masked-crop MSE {losses[0]:.3f} -> "
        f"{losses[-1]:.3f}, {summary_l['train_s'] / 20 * 1e3:.2f} ms a step (host clock, batches made on the "
        f"host), held-out RMSE {summary_l['RMSE']:.4f}; launches {launches_l}  [{card}]")
    if launches_l["fill_mean_fused"] < 1:
        raise AssertionError("kernel fill_mean_fused was not launched on the learned path")
    seen = only_kernel(lambda: fill_window_mean(grid), "fill_tile_kernel", "the window-mean baseline")
    say("learned", f"the window-mean baseline is one B3 launch a fill; the device kernels of 20 baseline calls "
        f"with the records the profiler kept: {seen}")
    # one training step alone (w16 d2, 4 crops of 48x48 of the stand-in,
    # bf16), and making its batch: crops on the host, the upload, the
    # window-mean baselines (4 B3 launches)
    elev_h, valid_h = grid.elev.cpu().numpy(), grid.valid.cpu().numpy()
    rng_c = np.random.RandomState(0)

    def crop_batch():
        planes = [torch.as_tensor(a).to(dev) for a in learned.make_crop_batch(rng_c, elev_h, valid_h, n=4, tile=48)]
        return planes[0], planes[1], learned.window_mean_batch(planes[0], planes[1]), planes[2], planes[3]

    tparams = learned.init_params(torch.Generator().manual_seed(0), width=16, depth=2)
    for t_ in tparams.values():
        t_.requires_grad_(True)
    topt = torch.optim.Adam(list(tparams.values()), lr=3e-3)
    tbatch = crop_batch()
    step = (lambda: learned.train_step(tparams, topt, tbatch, width=16, depth=2))
    ms["learned step"] = host_ms(step, warmup=3, reps=20)
    ms["learned step device"] = device_busy_ms(step, reps=5)
    ms["learned batch"] = host_ms(crop_batch, warmup=1, reps=20)
    say("timing", f"a training step alone (w16 d2, 4x48x48, bf16): {ms['learned step']:.3f} ms host, "
        f"{ms['learned step device']:.3f} ms device busy; making its batch (crops, upload, 4 B3 baselines) "
        f"{ms['learned batch']:.3f} ms host  [{card}]")
    del tparams, topt, tbatch
    for name in planes_l:
        cd = torch.float32 if name == "f32" else torch.bfloat16
        fn = (lambda cd=cd: learned.fill_learned(grid, lparams, width=lw, depth=ld, compute_dtype=cd))
        ms[f"learned {name}"] = time_ms(fn, reps=10)
        ms[f"learned {name} host"] = host_ms(fn)
        ms[f"learned {name} device"] = device_busy_ms(fn)
        say("timing", f"fill_learned w{lw} d{ld} {name} at {SHAPE}: {ms[f'learned {name}']:.3f} ms events, "
            f"{ms[f'learned {name} host']:.3f} ms host, {ms[f'learned {name} device']:.3f} ms device busy  [{card}]")
    ms["learned baseline"] = time_ms(lambda: fill_window_mean(grid), reps=10)
    say("timing", f"its window-mean baseline (B3 mean k=4) {ms['learned baseline']:.4f} ms events; phase took "
        f"{time.perf_counter() - t_ln:.1f} s  [{card}]")
    del planes_l, lparams

    # ---- 21. serving artifacts: each exported on the card and loaded fresh;
    # the launch counts are zeroed just before each loaded call and read just
    # after it
    from auvtpu_torch import serve
    from auvtpu_torch.cli import mission as mission_cli
    from auvtpu_torch.config import KERGUELEN_EXTENT
    from auvtpu_torch.ops import band as tband
    from auvtpu_torch.masking import mask_grid
    from auvtpu_torch.ops import fill_idw
    from auvtpu_torch.ops import packs as tp
    from auvtpu_torch.synthetic import kerguelen_standin

    t_sv = time.perf_counter()
    art = os.path.join(REPO, "results_local", "chip_smoke_serve")
    os.makedirs(art, exist_ok=True)
    ext_k = (grid.min_lon, grid.max_lon, grid.min_lat, grid.max_lat)
    counts_of = {"fill_kriging_fused": wf.LAUNCHES, "fill_idw_fused": wf.LAUNCHES, "fill_mean_fused": wf.LAUNCHES,
                 "window_idw": ss.LAUNCHES, "window_krige": ss.LAUNCHES, "band_resample": kb.LAUNCHES}
    kernel_of = {"fill_kriging_fused": "kriging_fill_kernel", "fill_idw_fused": "fill_tile_kernel",
                 "fill_mean_fused": "fill_tile_kernel", "window_idw": "window_idw_kernel",
                 "window_krige": "window_krige_kernel", "band_resample": "band_resample_"}
    launches_sv = dict.fromkeys(counts_of, 0)

    def served(label, path, export, load, args, live, counter, want_launches):
        """Export, load fresh, hold the loaded call to the live one; returns
        the loaded call's outputs."""
        t0_ = time.perf_counter()
        nbytes = export(path)
        t_exp = time.perf_counter() - t0_
        run = load(path)
        meta = serve.read_meta(path)
        for mod in (wf, ss, kb):
            mod.reset_launches()
        got = run(*args)
        torch.cuda.synchronize()
        n_ = counts_of[counter][counter]
        if n_ != want_launches:
            raise AssertionError(f"{label}: the loaded program launched {counter} {n_} times, want {want_launches}")
        launches_sv[counter] += n_
        want = live()
        got_t, want_t = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for a, b in zip(got_t, want_t):
            if a.dtype == torch.bool:
                if not torch.equal(a, b):
                    raise AssertionError(f"{label}: the loaded call's flags differ from the live call's")
            else:
                same_planes(a, b, f"{label}: loaded vs live")
        seen = device_kernels(lambda: run(*args))
        ours = {k: v for k, v in seen.items() if kernel_of[counter] in k}
        if not ours:
            raise AssertionError(f"{label}: no {kernel_of[counter]} record in the loaded program's device kernels {seen}")
        tms = {"exported host": host_ms(lambda: run(*args)), "live host": host_ms(live),
               # many calls: the tracer may drop a session's first records
               "exported device": device_busy_ms(lambda: run(*args), reps=20),
               "live device": device_busy_ms(live, reps=20)}
        for key, v in tms.items():
            ms[f"serve {label} {key}"] = v
        say("serve", f"{label}: {nbytes} B, exported in {t_exp:.1f} s, ops {meta['ops']}; loaded call bit-equal to "
            f"the live call; {n_} {counter} launch(es) from the loaded program; its records in 20 profiled calls "
            f"{sum(ours.values())} ({kernel_of[counter]}), beside {sum(seen.values()) - sum(ours.values())} of "
            f"{len(seen) - len(ours)} torch kernels; "
            f"host {tms['exported host']:.3f} / {tms['live host']:.3f} ms, device busy {tms['exported device']:.3f} "
            f"/ {tms['live device']:.3f} ms (exported / live)  [{card}]")
        return got

    served("fill kriging r0.10", os.path.join(art, "fill_kriging.pt2"),
           lambda p: serve.export_fill(p, SHAPE, extent=ext_k, method="kriging"), serve.load_exported,
           (grid.elev, grid.valid), lambda: fill_kriging(grid), "fill_kriging_fused", 1)
    served("fill idw r0.20", os.path.join(art, "fill_idw.pt2"),
           lambda p: serve.export_fill(p, SHAPE, extent=ext_k, method="idw"), serve.load_exported,
           (grid2.elev, grid2.valid), lambda: fill_idw(grid2), "fill_idw_fused", 1)
    qK = scattered_queries(KERGUELEN_EXTENT, *SHAPE, N_SCATTER, 8, dev)
    win = tp.build_pack(grid, tp.window_offsets(2), clamp=False)[0]
    for method, live_fn, counter in (("kriging", lambda: ss.packed_kriging_fused(win, grid, *qK), "window_krige"),
                                     ("idw", lambda: ss.packed_idw_fused(win, grid, *qK, k=8), "window_idw")):
        served(f"scattered {method} 1M", os.path.join(art, f"scattered_{method}.pt2"),
               lambda p, m=method: serve.export_scattered(p, SHAPE, qK[0].numel(), extent=ext_k, method=m),
               serve.load_exported_scattered, (win, grid.elev, grid.valid, *qK), live_fn, counter, 1)
    del win
    lparams, lw, ld = learned.load_params(os.path.join(REPO, "results", "learned_mid_atlantic_w16d2.npz"))
    served("learned w16 d2 bf16", os.path.join(art, "learned.pt2"),
           lambda p: serve.export_learned(p, SHAPE, lparams, extent=ext_k, width=lw, depth=ld), serve.load_exported,
           (grid.elev, grid.valid), lambda: learned.fill_learned(grid, lparams, width=lw, depth=ld), "fill_mean_fused", 1)
    del lparams
    tracks = band_tracks(grid, N_BAND)
    for kind, mb in (("band", 1), ("diagonal", 8)):
        r_sv = tband.BandRouter(grid, max_bands=mb)
        out_sv = r_sv.prepare(*tracks[kind])
        rs_sv = r_sv._resampler
        if mb > 1:
            placed, (_, pr_, pc_) = out_sv.placed, out_sv.shape
        else:
            placed, (pr_, pc_) = ((out_sv.row0, out_sv.col0),), out_sv.shape
        live_fill = (lambda placed=placed, pr_=pr_, pc_=pc_, r_sv=r_sv: tband._fill_pages(
            grid, None, placed=placed, pr=pr_, pc=pc_, method="kriging", margin=r_sv.margin,
            fill_backend=r_sv.fill_backend, convention=r_sv.convention, model="exponential"))
        planes_sv, vmasks_sv = served(
            f"mission fill {kind} ({len(placed)} pages)", os.path.join(art, f"mission_fill_{kind}.pt2"),
            lambda p, placed=placed, pr_=pr_, pc_=pc_, r_sv=r_sv: serve.export_mission_fill(
                p, SHAPE, placed, pr_, pc_, extent=ext_k, fill_backend=r_sv.fill_backend),
            lambda p: serve.load_exported_mission(p, p)[0], (grid.elev, grid.valid), live_fill,
            "fill_kriging_fused", len(placed))
        served(f"mission resample {kind} 5M", os.path.join(art, f"mission_resample_{kind}.pt2"),
               lambda p, placed=placed, pr_=pr_, pc_=pc_, rs_sv=rs_sv, out_sv=out_sv: serve.export_mission_resample(
                   p, SHAPE, placed, pr_, pc_, N_BAND, extent=ext_k, chunk=rs_sv.chunk, win_rows=rs_sv.wr,
                   win_cols=rs_sv.wc, masked=out_sv.masked, lerp_mode=rs_sv.lerp_mode),
               lambda p: serve.load_exported_mission(p, p)[1], (planes_sv, vmasks_sv, *tracks[kind]),
               lambda rs_sv=rs_sv, kind=kind: rs_sv.resample(*tracks[kind]), "band_resample", 1)
        del r_sv, out_sv, rs_sv, planes_sv, vmasks_sv
    del tracks
    torch.cuda.empty_cache()
    # the mission CLI's --export-dir: the diagonal mission at its defaults
    # forced onto the band path; the pair reloads and serves its pings
    exp_dir = os.path.join(art, "mission_cli")
    csv_m = os.path.join(art, "mission_cli.csv")
    summary_x = mission_cli.main(["--synthetic", "diagonal", "--force", "band", "--export-dir", exp_dir,
                                  "--out", csv_m])
    (fp_x, nf_x), (rp_x, nr_x) = summary_x["export"]["fill"], summary_x["export"]["resample"]
    fill_x, run_x = serve.load_exported_mission(fp_x, rp_x)
    red_x, _, _ = mask_grid(shelf_seamount(512, 640), 0.10, 42)
    g_x = RegularGrid.from_nan_array(np.asarray(red_x, np.float32), Extent(0.0, 639.0, 0.0, 511.0), device=dev)
    pts_x = np.genfromtxt(csv_m, delimiter=",", names=True)
    lon_x = torch.from_numpy(np.asarray(pts_x["lon"], np.float32)).to(dev)
    lat_x = torch.from_numpy(np.asarray(pts_x["lat"], np.float32)).to(dev)
    for mod in (wf, ss, kb):
        mod.reset_launches()
    z_x, ok_x = run_x(*fill_x(g_x.elev, g_x.valid), lon_x, lat_x)
    torch.cuda.synchronize()
    launches_x = {k: counts_of[k][k] for k in ("fill_kriging_fused", "band_resample")}
    for k, v in launches_x.items():
        launches_sv[k] += v
    served_x = torch.from_numpy(np.asarray(pts_x["interpolated_value"], np.float32)).to(dev)
    if int((~ok_x).sum()) != summary_x["unresolved"] or not torch.equal(z_x[ok_x], served_x[ok_x]):
        raise AssertionError(f"mission --export-dir: the reloaded pair leaves {int((~ok_x).sum())} pings unresolved "
                             f"(the CLI {summary_x['unresolved']}) or serves other depths")
    say("serve", f"cli.mission --export-dir (diagonal, {summary_x['pages']} pages, {summary_x['n']} pings): "
        f"{os.path.basename(fp_x)} {nf_x} B, {os.path.basename(rp_x)} {nr_x} B; reloaded, the pair serves the "
        f"CLI's {summary_x['n'] - summary_x['unresolved']} resolved pings bit for bit; launches {launches_x}; "
        f"phase took {time.perf_counter() - t_sv:.1f} s  [{card}]")

    # ---- 22. the prototype (plain torch: the JAX package's is XLA)
    from auvtpu_torch import scattered as tsc
    from auvtpu_torch.cli import prototype
    from auvtpu_torch.config import GEBCO_TILES

    t_pr = time.perf_counter()
    methods_p = ["linear", "idw", "aidw", "kriging"]
    small = prototype.main(["--region", "kerguelen", "--crop", "120", "160", "--methods", *methods_p])
    small["kriging aniso"] = prototype.main(["--region", "kerguelen", "--crop", "120", "160", "--methods",
                                             "kriging", "--aniso"])["kriging"]
    for name, got in small.items():
        want = PROTO_PINS[name]["RMSE"]
        if not abs(got["rmse"] - want) <= PROTO_RTOL * want:
            raise AssertionError(f"prototype {name} at 120x160: RMSE {got['rmse']} vs the JAX package's {want}")
    say("proto", "120x160 crop, 1 %: RMSE " + ", ".join(
        f"{n} {v['rmse']:.4f} (JAX {PROTO_PINS[n]['RMSE']:.4f})" for n, v in small.items()))
    res_p = os.path.join(REPO, "results_local", "chip_smoke_prototype.csv")
    if os.path.exists(res_p):
        os.remove(res_p)
    base_p = ["--region", "kerguelen", "--crop", *PROTO_CROP, "--subset", "0.01", "--results", res_p]
    proto = {f"k={k}": prototype.main(base_p + ["--k", str(k), "--methods", *methods_p]) for k in (16, 50)}
    proto["aniso k=16"] = prototype.main(base_p + ["--methods", "kriging", "--aniso"])
    for run_name, summary_p in proto.items():
        for name, v in summary_p.items():
            if not (np.isfinite(v["rmse"]) and 0 < v["rmse"] < 200.0 and v["n"] == 810_156 - 8_101):
                raise AssertionError(f"prototype {run_name} {name}: {v}")
            ms[f"proto {run_name} {name} wall"] = v["wall_s"] * 1e3
    say("proto", f"{'x'.join(PROTO_CROP)} crop (810,156 cells), 1 % (8,101 samples): " + "; ".join(
        f"{run_name} " + ", ".join(f"{n} RMSE {v['rmse']:.4f} m in {v['wall_s']:.2f} s" for n, v in s_.items())
        for run_name, s_ in proto.items()) + f"  [{card}]")
    # the knn of one target chunk on the card against the same function on the CPU
    tile = GEBCO_TILES["kerguelen"]
    elev_p = kerguelen_standin(tile["shape"])[:int(PROTO_CROP[0]), :int(PROTO_CROP[1])]
    e_ = tile["extent"]
    dlat_, dlon_ = (e_.max_lat - e_.min_lat) / (SHAPE[0] - 1), (e_.max_lon - e_.min_lon) / (SHAPE[1] - 1)
    ext_p = Extent(e_.min_lon, e_.min_lon + dlon_ * (elev_p.shape[1] - 1), e_.min_lat,
                   e_.min_lat + dlat_ * (elev_p.shape[0] - 1))
    pts_p, _, tgt_p, _ = tsc.sample_cells(elev_p, ext_p, subset_fraction=0.01)
    tgt_p = tgt_p[:1 << 16]
    d_card, i_card = tsc.knn_search(torch.from_numpy(tgt_p).to(dev), torch.from_numpy(pts_p).to(dev), k=17)
    d_card, i_card = d_card.cpu().numpy(), i_card.cpu().numpy()
    d_cpu, i_cpu = (t.numpy() for t in tsc.knn_search(torch.from_numpy(tgt_p), torch.from_numpy(pts_p), k=17))
    c_ = pts_p.mean(axis=0)
    scale_p = float(((tgt_p - c_) ** 2).sum(1).max() + ((pts_p - c_) ** 2).sum(1).max())
    atol_p = 4 * float(np.finfo(np.float32).eps) * scale_p
    bad_d = int((np.abs(d_card - d_cpu) > 1e-5 * np.abs(d_cpu) + atol_p).sum())
    # slots before a row's first near-tie are decided; the 16 chosen are a
    # set wherever the 16th and 17th distances are apart.  Apart is beyond
    # both sides' rounding: the samples sit on grid cells, so many
    # distances tie exactly, and the f32 cancellation leaves each d2 off by
    # up to atol_p, far above 1e-5 relative at one cell's distance
    gap = np.diff(d_cpu, axis=1) > 1e-5 * d_cpu[:, 1:] + 2 * atol_p
    lead = np.where(gap.all(axis=1), 16, np.argmin(gap, axis=1))
    decided = np.arange(16)[None, :] < lead[:, None]
    bad_i = int(((i_card[:, :16] != i_cpu[:, :16]) & decided).sum())
    apart = gap[:, 15]
    same_set = (np.sort(i_card[apart, :16], axis=1) == np.sort(i_cpu[apart, :16], axis=1)).all()
    if bad_d or bad_i or not same_set:
        raise AssertionError(f"prototype knn on the card vs the CPU: {bad_d} distances and {bad_i} decided indices "
                             f"differ, sets equal where apart: {same_set}")
    say("proto", f"knn of {tgt_p.shape[0]} targets x {pts_p.shape[0]} samples, k=16 (+1): card equal to the CPU "
        f"(d2 max |diff| {float(np.abs(d_card - d_cpu).max()):.3g}, bar rtol 1e-5 + {atol_p:.3g}; indices equal at "
        f"{int(decided.sum())} decided slots, sets equal in {int(apart.sum())} rows); phase took "
        f"{time.perf_counter() - t_pr:.1f} s  [{card}]")

    # ---- 23. the parallel layer: four ranks on this card over gloo
    from auvtpu_torch.parallel.launch import spawn
    from auvtpu_torch.parallel.mesh import transport_for

    t_par = time.perf_counter()
    torch.cuda.empty_cache()
    dry = entry.dryrun_multichip(P23_RANKS)
    say("parallel", f"entry.dryrun_multichip({P23_RANKS}) on the card: {dry}; took {time.perf_counter() - t_par:.1f} s")
    t0 = time.perf_counter()
    ranks_p = spawn(phase23_rank, P23_RANKS, card, device="cuda", timeout=900.0)
    launches_p = {k: sum(r["launches"][k] for r in ranks_p) for k in ranks_p[0]["launches"]}
    say("parallel", f"{P23_RANKS} ranks, transport {transport_for('cuda', P23_RANKS)} ({torch.cuda.device_count()} "
        f"card(s): every rank on {ranks_p[0]['device']}; the exchanged strips cross the host), ran in "
        f"{time.perf_counter() - t0:.1f} s  [{card}]")
    for line in ranks_p[0]["lines"]:
        say("parallel", f"{line}  [{card}, gloo]")
    for r in ranks_p:
        t = r["ms"]
        say("parallel", f"rank {r['rank']} ({r['transport']}): main-path launches {r['launches']}; profiler "
            f"records of its block fills and resample {r['kernels']}; block fill device ms kriging r0.10 "
            f"{t['kriging block fill device']:.4f}, idw r0.20 {t['idw block fill device']:.4f}; halo exchange "
            f"{t['kriging halo exchange']:.3f} / {t['idw halo exchange']:.3f} ms, gather "
            f"{t['kriging gather']:.3f} / {t['idw gather']:.3f} ms (host clock)  [{card}, gloo]")
    for k, v in ranks_p[0]["ms"].items():
        ms[f"parallel {k}"] = v
    say("parallel", f"launches over the ranks {launches_p}; phase took {time.perf_counter() - t_par:.1f} s  "
        f"[{card}, gloo]")

    # ---- 24. the quickstart, the figure CLIs' fills, the tiled ops and the
    # checking modes
    import glob
    import tempfile

    from auvtpu_torch.cli import demo, figures, plots
    from auvtpu_torch.metrics import all_reference_metrics
    from auvtpu_torch.ops import (scattered_bicubic, scattered_bilinear, scattered_idw, scattered_kriging,
                                  tiled_bicubic, tiled_bilinear, tiled_idw, tiled_kriging)
    from auvtpu_torch.synthetic import kerguelen_standin, sinusoid
    from auvtpu_torch.utils import debug_mode
    from auvtpu_torch.utils.profiling import trace

    t_q = time.perf_counter()
    res_d = demo.benchmark(batches=(1_000, 10_000, 100_000, 1_000_000), device=dev)
    if not all(r["ok"] and r["max_err"] <= demo.VALIDATION_ATOL for r in res_d.values()):
        raise AssertionError(f"demo.benchmark disagrees with GoldenGrid: {res_d}")
    say("quick", "demo.benchmark (800x1000 sinusoid, bilinear): " + "; ".join(
        f"n={n} device {r['device_ms']:.3f} ms, golden host {r['host_ms']:.1f} ms, max |got - golden| "
        f"{r['max_err']:.3g} m" for n, r in res_d.items()) + f"  [{card}]")
    # plots.reconstruct on the stand-in r0.10 (launch counts around the four
    # methods): the Grid B RMSEs of phase 9
    s_elev = kerguelen_standin(SHAPE)
    wf.reset_launches()
    rec = {m: plots.reconstruct(s_elev, KERGUELEN_EXTENT, REMOVAL, m, device=dev) for m in plots.METHODS}
    launches_pl = dict(wf.LAUNCHES)
    for m, (_, pred_m, _, truth_m) in rec.items():
        r_m = all_reference_metrics(truth_m, pred_m)["RMSE"]
        want, tol = GRID_B_RMSE[REMOVAL][m], GRID_B_TOL[m]
        if not abs(r_m - want) <= tol:
            raise AssertionError(f"plots.reconstruct {m}: RMSE {r_m} outside {want} +- {tol}")
        say("quick", f"plots.reconstruct {m:8s} RMSE {r_m:.6f} m (phase 9's {want} +- {tol})")
    del rec
    if (launches_pl["kriging_at_cells_fused"] < 1 or launches_pl["fill_idw_fused"] < 1
            or launches_pl["fill_mean_fused"] < 1):
        raise AssertionError(f"plots.reconstruct did not launch B19 and both B3 kinds: {launches_pl}")
    # figures.coverage_table at the JAX removals (launch counts around it);
    # the bilinear holes counted again by the host's fill
    wf.reset_launches()
    cov = figures.coverage_table(s_elev, KERGUELEN_EXTENT, figures.REMOVALS, device=dev)
    launches_cv = dict(wf.LAUNCHES)
    if launches_cv["fill_mean_fused"] < len(figures.REMOVALS):
        raise AssertionError(f"coverage_table did not launch B3 mean a removal: {launches_cv}")
    from auvtpu_torch.masking import mask_grid
    from auvtpu_torch.ops import fill_bilinear

    for row in cov:
        red_h, rc_h, _ = mask_grid(s_elev, row["removal"])
        pb = fill_bilinear(RegularGrid.from_nan_array(red_h, KERGUELEN_EXTENT, device="cpu")).numpy()
        holes = int(np.isnan(pb[rc_h[:, 0], rc_h[:, 1]]).sum())
        if holes != row["bilinear_holes"] or row["cubic_fallback_coverage"] != 1.0:
            raise AssertionError(f"coverage_table at {row['removal']}: {row} (host holes {holes})")
    say("quick", "figures.coverage_table on the card: " + ", ".join(
        f"r{r['removal']:g} {r['bilinear_holes']} holes of {r['masked_pts']}" for r in cov)
        + "; the host's bilinear holes equal; window mean covers every cell")
    del s_elev, cov
    # the tile-streaming ops on Grid A (plain torch: the JAX path has no
    # Pallas kernel) against the scattered ops and the golden engines
    a_elev = shelf_seamount(*GRID_A_SHAPE)
    gA = RegularGrid.dense(a_elev, GRID_A_EXTENT, device=dev)
    golden_a, golden_v2 = (cls(a_elev, GRID_A_EXTENT.min_lon, GRID_A_EXTENT.max_lon, GRID_A_EXTENT.min_lat,
                               GRID_A_EXTENT.max_lat) for cls in (GoldenGrid, GoldenV2))
    tiled_ops = {
        "bilinear": (tiled_bilinear, scattered_bilinear, 1e-3, golden_a.bilinear),
        "bicubic": (tiled_bicubic, lambda g, x, y: scattered_bicubic(g, x, y, fallback="never"), 1e-3, golden_a.cubic),
        "kriging": (lambda g, x, y: tiled_kriging(g, x, y, window_radius=2),
                    lambda g, x, y: scattered_kriging(g, x, y, max_radius=2), 0.05, golden_v2.kriging),
        "idw": (lambda g, x, y: tiled_idw(g, x, y, k=8, window_radius=2),
                lambda g, x, y: scattered_idw(g, x, y, k=8, max_radius=2), 0.01,
                lambda x, y: golden_v2.idw(x, y, k=8)),
    }
    for n in (100_000, 1_000_000):
        qT = scattered_queries(GRID_A_EXTENT, *GRID_A_SHAPE, n, 24, dev)
        q_h = [q[:N_GOLDEN].double().cpu().numpy() for q in qT]
        for name, (tfn, sfn, atol, gfn) in tiled_ops.items():
            got = tfn(gA, *qT)
            close_planes(got, sfn(gA, *qT), f"tiled_{name} vs scattered_{name}, {n} Grid A queries", 1e-5, atol)
            e_g = golden_check(got[:N_GOLDEN], gfn(*q_h), f"tiled_{name} vs the golden engine")
            ms[f"tiled_{name} {n}"] = time_ms(lambda: tfn(gA, *qT))
            ms[f"scattered_{name} {n}"] = time_ms(lambda: sfn(gA, *qT))
            say("quick", f"tiled_{name} at {n} Grid A queries: at scattered_{name}'s bar (rtol 1e-5, atol {atol}), "
                f"{N_GOLDEN} vs golden max |diff| {e_g:.3g} m; {ms[f'tiled_{name} {n}']:.4f} ms against "
                f"scattered {ms[f'scattered_{name} {n}']:.4f} ms (events)  [{card}]")
    del gA, qT, golden_a, golden_v2
    torch.cuda.empty_cache()
    # debug_mode on a covered grid (B1 and B3 through their custom ops), then
    # a NaN made inside B3 (+inf beside -inf): the raise is the pass
    cov_g = RegularGrid.dense(sinusoid(800, 1000), Extent(-180.0, -160.0, 20.0, 30.0), device=dev)
    with debug_mode(disable_jit=True):
        planes = [fill_kriging(cov_g), wf.fill_idw_fused(cov_g, k=8), wf.fill_mean_fused(cov_g, k=4)]
    if not all(bool(torch.isfinite(p_).all()) for p_ in planes):
        raise AssertionError("debug_mode: the covered grid's fills are not finite")
    e_inf = sinusoid(800, 1000)
    e_inf[400, 500], e_inf[400, 501] = np.inf, -np.inf
    inf_g = RegularGrid.dense(e_inf, Extent(-180.0, -160.0, 20.0, 30.0), device=dev)
    try:
        with debug_mode():
            wf.fill_idw_fused(inf_g, k=8)
    except FloatingPointError as exc:
        caught = str(exc)
    else:
        raise AssertionError("debug_mode did not raise on the NaN that B3 made")
    if "auvtpu_torch" not in caught:
        raise AssertionError(f"debug_mode raised at another op than B3's: {caught}")
    del planes, cov_g, inf_g
    caught_ops = debug_mode_ops(dev, card)
    # its cost on the 5M-cell stand-in r0.10 (host clock, outside every timed
    # figure above)
    for label, fn in (("fill_kriging (B1)", lambda: fill_kriging(grid)), ("fill_bilinear", lambda: fill_bilinear(grid))):
        plain_ms = host_ms(fn)
        with debug_mode():
            checked_ms = host_ms(fn)
        ms[f"debug_mode {label}"] = checked_ms
        say("quick", f"debug_mode on the stand-in r0.10: {label} {plain_ms:.3f} ms, checked {checked_ms:.3f} ms "
            f"(host clock)  [{card}]")
    say("quick", f"debug_mode: covered fills pass, the NaN B3 made raised: {caught}; B11's and B6's NaNs raised: "
        f"{caught_ops}")
    # one trace of 20 B1 calls, as a user would take it: trace() opens and
    # closes its window WINDOW_MARGIN_S away from the calls, so the tracer's
    # clock skew drops none of their records
    with tempfile.TemporaryDirectory() as tdir:
        with trace(tdir):
            for _ in range(20):
                fill_kriging(grid)
        tfiles = glob.glob(os.path.join(tdir, "trace.*.json"))
        n_b1 = sum("kriging_fill_kernel" in str(e.get("name", ""))
                   for f in tfiles for e in json.load(open(f)).get("traceEvents", []))
    if len(tfiles) != 1 or n_b1 != 20:
        raise AssertionError(f"utils.profiling.trace wrote {len(tfiles)} files holding {n_b1} of 20 B1 records")
    say("quick", f"utils.profiling.trace wrote one Chrome trace holding all 20 B1 kriging_fill_kernel records; "
        f"launches plots {launches_pl}, coverage {launches_cv}; phase took {time.perf_counter() - t_q:.1f} s  "
        f"[{card}]")

    # bounds, from this run's inputs
    # B1/B2 timed on the r0.10 grid, B3/B4 on the r0.20 one (same shape);
    # bytes: each input plane read once, each output plane written once
    n = SHAPE[0] * SHAPE[1]
    s4_bench, _ = scan_counts(grid, 4)
    s4, t4 = scan_counts(grid2, 4)
    s8, t8 = scan_counts(grid2, 8)
    bounds = {
        "fill_kriging_fused": bound(4.0 * n * (2 + 1), s4_bench + B1_SOLVE_OPS * n),
        "topk_full": bound(4.0 * n * (2 + 1 + 3 * 4), s4_bench),
        "fill_idw_fused": bound(4.0 * n * (2 + 1), s8 + 3 * t8 + 2 * n),
        "fill_mean_fused": bound(4.0 * n * (2 + 1), s4 + t4 + 2 * n),
        "topk_idx": bound(4.0 * n * (1 + 1 + 4), s4),  # reads validity only
        # B19 at the stand-in's masked cells: both planes read once (the
        # cells lie all over the tile), a value a cell written; the scan's
        # tests and B1's solve a cell
        "kriging_at_cells_fused": bound(4.0 * (2 * n + n_pts), n_pts * (4.0 / (1.0 - REMOVAL) + B1_SOLVE_OPS)),
    }
    # the select kernel, per query: its P pack floats, the cell index and
    # (fx, fy) read, its rows written; ~8 operations a tap for d2 and 2 per
    # tap and slot for the min-extract (+ 4 a slot for B6's weights)
    nq = float(cellA.numel())
    bounds.update({
        "select_rows": bound(nq * (16 * 4 + 12 + (1 + 2 * 4) * 4), nq * (8 * 16 + 2 * 4 * 16)),
        # B11 (valid16): the query's lon and lat and its row read, the
        # prediction written (the query prologue is in the kernel); B5's
        # selection and, where four were found in the grid (every query of
        # this fully valid grid), B1's solve
        "select_krige": bound(nq * (8 + 16 * 4 + 4),
                              nq * (8 * 16 + 2 * 4 * 16) + n_solved * B1_SOLVE_OPS),
        # B6 reads the query's lon and lat and 25 taps of each 32-float row
        # (112 B, four 32-byte sectors), writes the value (the prologue and
        # the quotient are in the kernel)
        "idw_rows": bound(nq * (8 + 32 * 4 + 4), nq * (8 * 25 + 2 * 8 * 25 + 4 * 8)),
        # B12 likewise reads the lon and lat and the row, writes the
        # prediction; B7's selection at k=4 and, where four were found in
        # the grid, B1's solve
        "window_krige": bound(nq * (8 + 32 * 4 + 4), nq * (8 * 25 + 2 * 4 * 25) + n_solved_w * B1_SOLVE_OPS),
        # B7 likewise reads 25 taps of each row and scans them
        "window_select_fused": bound(nq * (32 * 4 + 12 + (1 + 3 * 4) * 4), nq * (8 * 25 + 2 * 4 * 25)),
        # B15 reads what B12 reads and writes the value; B7's selection at
        # k=8 and B6's weights (every query of this fully valid grid finds 8)
        "window_idw": bound(nq * (8 + 32 * 4 + 4), nq * (8 * 25 + 2 * 8 * 25 + 4 * 8)),
    })
    # B8, per ping of the band weave: lon and lat read, z and ok written; the
    # plane read once: a window a chunk, but no more than the whole band;
    # ~31 f32 operations a ping (the coordinate prologue's 6 included)
    nq_b = float(N_BAND)
    wh_, ww_ = kb.geometry(*band.shape, band_kw["wr"], band_kw["wc"], False)[:2]
    plane_cells = min(-(-N_BAND // band_kw["chunk"]) * wh_ * ww_, band.shape[0] * band.shape[1])
    bounds["band_resample"] = bound(nq_b * 13 + plane_cells * 4, nq_b * 31)
    # B9 over the whole r0.10 plane: the two planes read once, per pair 4
    # f32 operations (two products, a difference, a square) and 2 f64 adds
    # (every cell, every offset, as the function's formula has them); B10:
    # the f64 arithmetic of the steps its walk runs at the stand-in's bins
    # (latency-bound serial work, far from either bound)
    n_pairs = float(n) * len(iso[0])
    bounds["pair_sums"] = bound(4.0 * n * 2 + 16.0 * 10, 4 * n_pairs, 2 * n_pairs)
    bounds["fit_model"] = bound(4.0 * 3 * gam_s.numel() + 4.0 * 3, 0.0,
                                b10_steps["exponential"] * (B10_BIN_OPS * gam_s.numel() + B10_STEP_OPS))
    say("bounds", "; ".join(f"{k} {v[0] * 1e3:.2f} us ({v[1]})" for k, v in bounds.items())
        + f"; rows scanned per cell: k=4 {s4 / n:.3f}, k=8 {s8 / n:.3f} (r0.20), k=4 {s4_bench / n:.3f} (r0.10); "
        f"select kernels at {int(nq)} Grid A queries, {int(n_solved)} of them solved by B11, {int(n_solved_w)} by "
        f"B12")

    rows_ = [
        ("fill_kriging_fused", "auvtpu/pallas/window_fill.py:648",
         launches["fill_kriging_fused"] + launches_b["fill_kriging_fused"] + launches_s["fill_kriging_fused"]
         + launches_sv["fill_kriging_fused"] + launches_p["fill_kriging_fused"] + launches_pl["fill_kriging_fused"],
         b1_err, ms["B1 kernel alone"], ms["B1 wrapper"], ms["B1 plain"]),
        # B19 replaces no Pallas kernel: the JAX package takes B1's plane and
        # gathers the cells (auvtpu/ops/dense.py:482-488); main paths: Grid B
        # kriging through the CLI (phase 9) and plots (phase 24)
        ("kriging_at_cells_fused", "auvtpu/ops/dense.py:482",
         launches_b["kriging_at_cells_fused"] + launches_pl["kriging_at_cells_fused"],
         b19_err, ms["B19 kernel alone"], ms["B19 wrapper"], ms["B19 plain"]),
        ("topk_full", "auvtpu/pallas/window_fill.py:501", launches["topk_full"],
         b2_err, ms["B2 kernel alone"], ms["B2 wrapper"], ms["B2 plain"]),
        ("fill_idw_fused", "auvtpu/pallas/window_fill.py:230",
         launches_b["fill_idw_fused"] + launches_s["fill_idw_fused"] + launches_sv["fill_idw_fused"]
         + launches_p["fill_idw_fused"] + launches_pl["fill_idw_fused"],
         b3_err["idw"], ms["B3 idw k=8"], ms["B3 idw k=8 wrapper"], ms["B3 idw k=8 plain"]),
        ("fill_mean_fused", "auvtpu/pallas/window_fill.py:230",
         launches_b["fill_mean_fused"] + launches_s["fill_mean_fused"] + launches_l["fill_mean_fused"]
         + launches_sv["fill_mean_fused"] + launches_pl["fill_mean_fused"] + launches_cv["fill_mean_fused"],
         b3_err["mean"], ms["B3 mean k=4"], ms["B3 mean k=4 wrapper"], ms["B3 mean k=4 plain"]),
        ("topk_idx", "auvtpu/pallas/window_fill.py:384", launches_b4["topk_idx"],
         b4_err, ms["B4 k=4"], ms["B4 k=4 wrapper"], ms["B4 k=4 plain"]),
    ]
    src = {k: "auvtpu_torch/csrc/window_fill.cu" for k, *_ in rows_}
    rows_ += [
        ("select_rows", "auvtpu/pallas/valid_select.py:79",
         launches_a["select_rows"] + launches_v["select_rows"] + launches_t["select_rows"]
         + launches_m["select_rows"],
         sc_err["select_rows"], ms["select_rows alone"], ms["select_rows wrapper"],
         ms["select_rows plain"]),
        # B11 replaces B5 with the XLA row epilogue after it
        ("select_krige", "auvtpu/pallas/valid_select.py:203",
         launches_a["select_krige"] + launches_t["select_krige"] + launches_m["select_krige"],
         sc_err["select_krige"], ms["select_krige alone"], ms["select_krige wrapper"],
         ms["select_krige plain"]),
        ("idw_rows", "auvtpu/pallas/valid_select.py:113",
         launches_a["idw_rows"] + launches_t["idw_rows"],
         sc_err["idw_rows"], ms["idw_rows alone"], ms["idw_rows wrapper"],
         ms["idw_rows plain"]),
        # B7's entry point (window_select_fused, phase 13): the fused paths
        # take B12 and B15
        ("window_select_fused", "auvtpu/pallas/scattered_select.py:70",
         launches_w7["window_select_fused"],
         sc_err["window_select_fused"], ms["window_select_fused alone"], ms["window_select_fused wrapper"],
         ms["window_select_fused plain"]),
        # B12 replaces B7 with the XLA kriging_from_select after it
        ("window_krige", "auvtpu/pallas/scattered_select.py:212",
         launches_af["window_krige"] + launches_sv["window_krige"],
         sc_err["window_krige"], ms["window_krige alone"], ms["window_krige wrapper"],
         ms["window_krige plain"]),
        # B15 replaces B7 with the XLA idw_from_select after it
        ("window_idw", "auvtpu/pallas/scattered_select.py:237",
         launches_af["window_idw"] + launches_sv["window_idw"],
         sc_err["window_idw"], ms["window_idw alone"], ms["window_idw wrapper"],
         ms["window_idw plain"]),
    ]
    for k in ("select_rows", "idw_rows", "window_select_fused", "select_krige", "window_krige", "window_idw"):
        src[k] = "auvtpu_torch/csrc/scattered_select.cu"
    rows_.append(("band_resample", "auvtpu/pallas/band_resample.py:43",
                  launches_m["band_resample"] + launches_sv["band_resample"] + launches_p["band_resample"],
                  b8_err, ms["B8 band"], ms["B8 band wrapper"], ms["B8 band plain"]))
    src["band_resample"] = "auvtpu_torch/csrc/band_resample.cu"
    # B9 and B10 replace no Pallas kernel: the XLA scans of auvtpu/variogram.py
    # (the offset scan of its _pair_sums_binned, the Gauss-Newton scan of its
    # fit_model); main paths: fit_fill (phase 6), the streaming fit (phase
    # 10), the sharded fit+fill on every rank (phase 23)
    for k, rep_, err, tag in (("pair_sums", "auvtpu/variogram.py:60", b9_err, "B9"),
                              ("fit_model", "auvtpu/variogram.py:337", b10_err, "B10")):
        rows_.append((k, rep_, launches[k] + launches_s[k] + launches_p[k], err, ms[f"{tag} kernel alone"],
                      ms[f"{tag} wrapper"], ms["pair sums plain" if tag == "B9" else "variogram fit plain"]))
        src[k] = "auvtpu_torch/csrc/variogram.cu"
    # B13 and B14 replace no Pallas kernel: the jitted XLA programs of exact
    # mode (the dense pass's lax.while_loop with its extraction and table
    # solve; the strict selection's (N, 441) gathers and swap passes); main
    # paths: phase 19's stand-in calls and both CLIs' --selection exact.
    # Their times: B13 with the solve (two-tier kriging's launch), B14 at
    # the round anchor (strict kriging's selection); bit-equal (phase 19)
    for k, rep_, tag in (("exact_dense", "auvtpu/ops/exact_fast.py:121", "B13 solve"),
                         ("exact_ring", "auvtpu/ops/exact.py:197", "B14 round")):
        rows_.append((k, rep_, launches_ex[k] + launches_exc[k], 0.0, ms[f"{tag} alone"], ms[f"{tag} wrapper"],
                      ms[f"{tag} plain"]))
        src[k] = "auvtpu_torch/csrc/exact_select.cu"
        bounds[k] = bounds_x[k]
    # B16 replaces no Pallas kernel: exact mode's host numpy query
    # preparation (prepare_exact_queries, and _prepare_scattered at
    # auvtpu/ops/exact.py:449); main paths as B13's; its time with two-tier
    # kriging's fields; bit-equal (phase 19)
    rows_.append(("exact_prologue", "auvtpu/ops/exact.py:139",
                  launches_ex["exact_prologue"] + launches_exc["exact_prologue"], 0.0, ms["B16 alone"],
                  ms["B16 wrapper"], ms["B16 plain"]))
    src["exact_prologue"] = "auvtpu_torch/csrc/exact_prologue.cu"
    bounds["exact_prologue"] = bounds_b16
    # B17 and B18 replace no Pallas kernel: exact mode's jitted epilogues
    # (_krige_chunk; _cubic_smooth_chunk and _bilinear_chunk, with the host
    # numpy of the at-cells cubic :344 and bilinear :610); main paths as
    # B13's; B17's time on strict kriging's selection, B18's the cubic at
    # the stand-in's cells (the other builds printed in phase 19);
    # bit-equal (phase 19)
    for k, rep_, tag in (("exact_krige", "auvtpu/ops/exact.py:303", "B17"),
                         ("exact_patch", "auvtpu/ops/exact.py:522", "B18 cubic cells")):
        rows_.append((k, rep_, launches_ex[k] + launches_exc[k], 0.0, ms[f"{tag} alone"], ms[f"{tag} wrapper"],
                      ms[f"{tag} plain"]))
        src[k] = "auvtpu_torch/csrc/exact_epilogue.cu"
        bounds[k] = bounds_e[tag]
    # B8: values only, no resolved mask; B7 and B5: the selection alone, no
    # tie order
    library = {"band_resample": ms["grid_sample"], "window_select_fused": ms["B7 library topk"],
               "select_rows": ms["B5 library topk"]}
    kernels = [
        {"name": k, "route": "cuda", "source": src[k], "replaces": rep, "launches": n,
         "max_abs_err": err, "ms": t, "wrapper_ms": tw, "plain_ms": tp, "bound_ms": bounds[k][0],
         "bound_by": bounds[k][1], "library_ms": library.get(k)}
        for k, rep, n, err, t, tw, tp in rows_
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
