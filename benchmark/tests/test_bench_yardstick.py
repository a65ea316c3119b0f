"""The yardstick on the CPU: draws repeat for a seed and differ across
seeds, the terrain copies follow the surfaces they copy, the work counts on
hand-counted cases, and the trace reduction on a hand-made trace."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from auvtpu_torch import synthetic
from benchmark.yardstick import draws, roofline, terrain, trace
from benchmark.yardstick.pools import masked_tiles, query_batches
from benchmark.yardstick.tables import lag_table, ring_offsets, sorted_window, valid16_dydx, window_dydx

CFG_B = {"shape": [40, 50], "extent": [74.615, 84.785, -58.2508, -49.6982],
         "terrain": {"generator": "benchmark.yardstick.terrain.kerguelen_standin", "seed": 7}}
CFG_A = {"shape": [32, 40], "extent": [-180.0, -160.0, 20.0, 30.0],
         "terrain": {"generator": "benchmark.yardstick.terrain.shelf_seamount", "seed": 0}}


def test_masks_repeat_for_a_seed_and_differ_across_seeds():
    traffic = {"pool": 3, "removal": 0.1}
    a = masked_tiles(CFG_B, traffic, 2**31 + 5, "cpu")
    b = masked_tiles(CFG_B, traffic, 2**31 + 5, "cpu")
    c = masked_tiles(CFG_B, traffic, 2**31 + 6, "cpu")
    for x, y, z in zip(a, b, c):
        assert x["flat"].numel() == int(40 * 50 * 0.1) == x["n"]
        assert torch.equal(x["flat"], y["flat"]) and not torch.equal(x["flat"], z["flat"])
        assert x["flat"].unique().numel() == x["n"]
        assert float(x["valid"].sum()) == 40 * 50 - x["n"]
        assert bool((x["elev"][x["valid"] == 0] == 0).all())
    assert not torch.equal(a[0]["flat"], a[1]["flat"])  # the pool's tiles are distinct


def test_queries_repeat_for_a_seed_and_differ_across_seeds():
    traffic = {"pool": 2, "batch": 1000, "eps": 1e-6}
    a = query_batches(CFG_A, traffic, 11, "cpu")
    b = query_batches(CFG_A, traffic, 11, "cpu")
    c = query_batches(CFG_A, traffic, 12, "cpu")
    assert torch.equal(a[1]["lons"], b[1]["lons"]) and torch.equal(a[1]["lats"], b[1]["lats"])
    assert not torch.equal(a[1]["lons"], c[1]["lons"])
    lo, la = a[0]["lons"], a[0]["lats"]
    assert lo.dtype == torch.float32 and float(lo.min()) >= -180.0 and float(lo.max()) <= -160.0
    assert float(la.min()) >= 20.0 and float(la.max()) <= 30.0


def test_large_seeds_are_taken():
    g = draws.generator(2**40 + 3, "cpu")
    assert draws.mask_cells(g, (10, 10), 0.25).numel() == 25


def test_terrain_copies_follow_the_program_surfaces():
    got = terrain.kerguelen_standin((60, 70), 7, "cpu").numpy()
    want = synthetic.kerguelen_standin((60, 70), seed=7)
    assert np.abs(got - want).max() <= 1.0 and np.mean(got == want) > 0.99
    np.testing.assert_allclose(terrain.shelf_seamount((30, 40), 0, "cpu").numpy(), synthetic.shelf_seamount(30, 40),
                               rtol=0, atol=1e-9)


def test_tables():
    assert ring_offsets(1).tolist() == [[0, 0], [-1, -1], [-1, 1], [0, -1], [0, 1], [1, -1], [1, 1], [-1, 0], [1, 0]]
    dx, dy = sorted_window(1)
    # (dx + 0.5)^2 + (dy + 0.5)^2: the centre and its three cells toward -1 tie at 0.5
    assert list(zip(dx[:4].tolist(), dy[:4].tolist())) == [(0, 0), (-1, -1), (0, -1), (-1, 0)]
    assert len(window_dydx(2)) == 25 and len(valid16_dydx()) == 16
    dys, dxs, bins, centres = lag_table(1, 1)
    assert list(zip(dys.tolist(), dxs.tolist())) == [(0, 1), (1, 0)] and bins.tolist() == [0, 0]


def test_counts_on_hand_counted_cases():
    cfg = {"shape": [10, 10], "idw": {"k": 8}, "fit": {"max_lag": 1, "n_bins": 1}}
    nbytes, f32, f64 = roofline.krige_cells(cfg, {"removal": 0.1})
    assert nbytes == 2 * 100 * 4 + 10 * 4 and f64 == 0
    assert f32 == pytest.approx(10 * (4 / 0.9 + 333))
    assert roofline.krige_queries(cfg, {"batch": 7}) == (400 + 7 * 12, 7 * (12 + 333), 0.0)
    assert roofline.idw_queries(cfg, {"batch": 7}) == (400 + 7 * 12, 7 * (12 + 8 * 13 + 1), 0.0)
    # on a 10 x 10 grid with max_lag 1: offsets (0, 1) and (1, 0), 90 in-grid pairs each
    nbytes, f32, f64 = roofline.fit_fill_cells(cfg, {"removal": 0.0})
    assert f64 == 2 * 180 and f32 == 2 * 180 and nbytes == 800
    assert roofline.least_seconds(3.35e12, 0.0) == 1.0
    assert roofline.least_seconds(0.0, 67e12, 34e12) == 2.0


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "pid": 1}


def test_trace_reduction(tmp_path):
    events = [
        _x(trace.WINDOW, "user_annotation", 100.0, 100.0),
        _x("k_before", "kernel", 50.0, 60.0, tid=7),  # clipped to [100, 110]
        _x("k1", "kernel", 120.0, 20.0, tid=7),
        _x("k2", "kernel", 130.0, 20.0, tid=7),  # overlaps k1: union 120-150
        _x("copy", "gpu_memcpy", 170.0, 10.0, tid=7),
        _x("k_after", "kernel", 250.0, 10.0, tid=7),
        _x("aten::index", "cpu_op", 105.0, 30.0),
        _x("cudaEventSynchronize", "cuda_runtime", 152.0, 16.0),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = trace.reduce(trace.load(path))
    assert r["window_us"] == 100.0 and r["busy_us"] == 10.0 + 30.0 + 10.0
    assert r["span_us"] == 80.0 and r["n_device_ops"] == 4
    assert r["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    gaps = dict(r["idle_gaps"])
    # gaps: 110-120 (aten::index), 150-170 (the sync), 180-200 (nothing)
    assert gaps == {"aten::index": pytest.approx(10e-6), "cudaEventSynchronize": pytest.approx(20e-6),
                    "host idle": pytest.approx(20e-6)}
    assert trace.reduce([_x("other", "user_annotation", 0.0, 1.0)]) is None


def test_a_trace_that_disagrees_with_events_is_refused():
    from benchmark.harness import trace_agrees

    assert trace_agrees(100_000.0, 101_000.0) and trace_agrees(500.0, 1400.0)
    assert not trace_agrees(50_000.0, 100_000.0) and not trace_agrees(100_000.0, 104_000.0)
