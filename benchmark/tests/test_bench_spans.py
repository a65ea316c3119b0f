"""The span and counter readers (``benchmark/yardstick/spans.py``) on the
CPU: exact values from a hand-made Chrome trace with known host and device
intervals, nothing where the roots are not one a traced request, and one
CPU-profiled real call of the program read through them."""

from __future__ import annotations

import json

import pytest
import torch

from auvtpu_torch.entry import tiny_masked_grid
from auvtpu_torch.ops import dense
from auvtpu_torch.utils import profiling
from benchmark import harness
from benchmark.yardstick import spans
from benchmark.yardstick.trace import WINDOW

SPAN_METRICS = {
    "program_host_ms.fill": 0.15, "program_host_ms.query": 0.15,
    "kernels_host_ms.fill": 0.11, "kernels_host_ms.query": 0.11,
    "program_idle_share.fill": 25.0, "program_idle_share.query": 25.0,
}


def _x(name: str, ts: float, end: float, cat: str = "cpu_op", tid=1) -> dict:
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts, "pid": 1, "tid": tid}


def hand_made() -> list[dict]:
    """A window of 1,000 us on thread 1 holding two requests (roots of 200
    and 100 us; outermost kernels spans of 120 us and the second root's
    100, its own kernels span of 40 us inside it) and device work at
    1000-1050 (clipped from 900), 1250-1450 and 1700-1800: idle 1050-1250,
    1450-1700, 1800-2000, of which the roots cover 150 + 100 us."""
    return [
        _x(WINDOW, 1000, 2000, "user_annotation"),
        _x("auvtpu_torch.ops.dense.kriging_at_cells", 900, 990),  # before the window
        _x("auvtpu_torch.ops.dense.kriging_at_cells", 1100, 1300),
        _x("auvtpu_torch.ops.dense.fill_kriging", 1110, 1250),
        _x("auvtpu_torch.kernels.window_fill.fill_kriging_fused", 1120, 1240),
        _x("auvtpu_torch::kriging_fill", 1130, 1235),
        _x("auvtpu_torch.kernels.window_fill.kriging_launch:call", 1200, 1230),
        _x("auvtpu_torch.ops.dense.kriging_at_cells:gather", 1260, 1290),
        _x("aten::index", 1265, 1285),
        _x("auvtpu_torch.kernels.valid_select.kriging_valid_t", 1500, 1600),
        _x("auvtpu_torch.kernels.scattered_select.select_krige", 1510, 1550),
        _x("auvtpu_torch::select_krige", 1520, 1545),
        _x("auvtpu_torch.trace warm-up", 1610, 1620, "user_annotation"),  # no span's name
        _x("auvtpu_torch.ops.dense.kriging_at_cells", 1650, 1690, tid=2),  # another thread
        _x("kriging_fill_kernel", 900, 1050, "kernel", tid=7),
        _x("kriging_fill_kernel", 1250, 1450, "kernel", tid=7),
        _x("Memcpy DtoH", 1700, 1800, "gpu_memcpy", tid=7),
        {"ph": "i", "name": "marker", "ts": 1400, "pid": 1, "tid": 1},
    ]


@pytest.fixture
def trace_file(tmp_path, monkeypatch):
    def write(events):
        path = tmp_path / "trace.json"
        path.write_text(json.dumps({"traceEvents": events}))
        monkeypatch.setattr(harness, "TRACE_FILE", path)
        return path

    return write


@pytest.mark.parametrize("metric", list(SPAN_METRICS))
def test_each_span_reader_on_a_hand_made_trace(metric, trace_file):
    trace_file(hand_made())
    read = harness.metric_reader(metric)
    assert read({"trace": {"requests": 2}}) == pytest.approx(SPAN_METRICS[metric], abs=1e-12)
    assert read({"trace": {"requests": 3}}) is None  # roots are not one a request
    assert read({"trace": None}) is None


def test_the_reduction_of_the_hand_made_trace(trace_file):
    red = spans.reduce(hand_made())
    assert red["window"] == (1000.0, 2000.0)
    assert [r[:2] for r in red["roots"]] == [(1100.0, 1300.0), (1500.0, 1600.0)]
    assert [k[2] for k in red["kernels"]] == ["auvtpu_torch.kernels.window_fill.fill_kriging_fused",
                                              "auvtpu_torch.kernels.valid_select.kriging_valid_t"]
    assert red["busy"] == [(1000.0, 1050.0), (1250.0, 1450.0), (1700.0, 1800.0)]
    assert spans.idle(red) == [(1050.0, 1250.0), (1450.0, 1700.0), (1800.0, 2000.0)]
    assert spans.overlap([(0.0, 2.0), (5.0, 9.0)], [(1.0, 6.0), (8.0, 20.0)]) == 3.0
    assert spans.reduce([e for e in hand_made() if e["name"] != WINDOW]) is None


def test_a_trace_without_the_program_s_spans_reads_nothing(trace_file):
    # the parent program opens no span: every span reader reports nothing
    trace_file([e for e in hand_made() if not spans.SPAN.match(e["name"])])
    for metric in SPAN_METRICS:
        assert harness.metric_reader(metric)({"trace": {"requests": 2}}) is None


def test_solve_yield_reads_the_fill_counters(monkeypatch):
    read = harness.metric_reader("solve_yield.fill")
    monkeypatch.setitem(profiling.COUNTERS, "fill", {"cells_solved": 5_011_373, "cells_returned": 501_137})
    assert read({}) == pytest.approx(10.000_000, abs=1e-5) == 100.0 * 501_137 / 5_011_373
    monkeypatch.setitem(profiling.COUNTERS, "fill", {"cells_solved": 0, "cells_returned": 0})
    assert read({}) is None
    monkeypatch.delitem(profiling.COUNTERS, "fill")
    assert read({}) is None


def test_the_new_metrics_are_in_the_spec():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in [*SPAN_METRICS, "solve_yield.fill"]:
        m = per_layer[name]
        assert m["workloads"] == (["gridb-krige-r0.10"] if name.endswith(".fill")
                                  else ["grida-krige-5m", "grida-idw-5m"])
        assert callable(harness.metric_reader(name))


def test_a_cpu_profiled_call_read_through_the_span_readers(tmp_path, monkeypatch):
    torch.set_num_threads(1)
    g = tiny_masked_grid(48, 64, device="cpu")
    flat = torch.nonzero(g.valid.reshape(-1) < 0.5).reshape(-1)
    rows, cols = flat // 64, flat % 64
    dense.kriging_at_cells(g, rows, cols, backend="fused")
    profiling.reset("fill")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(WINDOW):
            for _ in range(3):
                dense.kriging_at_cells(g, rows, cols, backend="fused")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    monkeypatch.setattr(harness, "TRACE_FILE", path)
    run = {"trace": {"requests": 3}}
    host, kern, share = (harness.metric_reader(m)(run) for m in ("program_host_ms.fill", "kernels_host_ms.fill",
                                                                  "program_idle_share.fill"))
    assert 0 < kern < host and 0 < share <= 100.0  # no device work on the CPU: the roots are all idle
    assert harness.metric_reader("solve_yield.fill")(run) == pytest.approx(100.0 * rows.numel() / (48 * 64))
    assert harness.metric_reader("program_host_ms.fill")({"trace": {"requests": 4}}) is None
