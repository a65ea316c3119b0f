"""The variogram layer's readers (``benchmark/yardstick/fit.py``) on the
CPU: ``fit_roofline`` and ``fit_host_ms.fill`` from a hand-made Chrome
trace with known host and device intervals, nothing where there is nothing
to read; the count of observed pairs against a brute-force count on small
tiles; and fit-then-fill's plain reference against the program at a small
size."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import fitfill
from benchmark.yardstick import fit
from benchmark.yardstick.draws import generator, mask_cells
from benchmark.yardstick.pools import masked_tiles
from benchmark.yardstick.roofline import least_seconds
from benchmark.yardstick.trace import WINDOW

CELL = "gridb-fitfill-r0.10"


def _x(name: str, ts: float, end: float, cat: str = "cpu_op", tid=1) -> dict:
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts, "pid": 1, "tid": tid}


def hand_made() -> list[dict]:
    """A window of 1,000 us on thread 1 holding two fit-then-fill requests
    (roots 1100-1400 and 1500-1750), their fits' spans of 140 and 90 us,
    and device work: B9 from 900 (clipped to 1000) to 1020, 1050-1150
    and 1600-1700, its finish 1150-1160, B10 1160-1170 and 1700-1710 (250
    us of variogram kernels in the window), B1 1170-1300 (not theirs)."""
    p = "auvtpu_torch."
    return [
        _x(WINDOW, 1000, 2000, "user_annotation"),
        _x(p + "variogram.fit_variogram", 800, 990),  # before the window
        _x(p + "entry.fit_fill", 1100, 1400),
        _x(p + "variogram.fit_variogram", 1110, 1250),
        _x(p + "kernels.variogram.pair_sums", 1120, 1180),
        _x("auvtpu_torch::pair_sums", 1125, 1175),
        _x(p + "kernels.variogram.fit_model", 1190, 1240),
        _x(p + "ops.dense.fill_kriging", 1260, 1390),
        _x(p + "entry.fit_fill", 1500, 1750),
        _x(p + "variogram.fit_variogram", 1510, 1600),
        _x(p + "variogram.fit_variogram", 1520, 1530, tid=2),  # another thread
        _x("void (anonymous namespace)::pair_sums_tile_kernel<float>(...)", 900, 1020, "kernel", tid=7),
        _x("void (anonymous namespace)::pair_sums_tile_kernel<float>(...)", 1050, 1150, "kernel", tid=7),
        _x("void (anonymous namespace)::pair_sums_finish_kernel(...)", 1150, 1160, "kernel", tid=7),
        _x("void (anonymous namespace)::fit_model_kernel<1>(...)", 1160, 1170, "kernel", tid=7),
        _x("void (anonymous namespace)::kriging_fill_kernel<0, 0, 0, 4>(...)", 1170, 1300, "kernel", tid=7),
        _x("void (anonymous namespace)::pair_sums_tile_kernel<float>(...)", 1600, 1700, "kernel", tid=7),
        _x("void (anonymous namespace)::fit_model_kernel<1>(...)", 1700, 1710, "kernel", tid=7),
    ]


@pytest.fixture
def trace_file(tmp_path, monkeypatch):
    def write(events):
        path = tmp_path / "trace.json"
        path.write_text(json.dumps({"traceEvents": events}))
        monkeypatch.setattr(harness, "TRACE_FILE", path)
        return path

    return write


def _least_us() -> float:
    _, cfg, traffic = harness.cell_files(CELL)
    return least_seconds(*fit.fit_pairs(cfg, traffic)) * 1e6


def test_the_reduction_of_the_hand_made_trace():
    assert fit.reduce(hand_made()) == {"host_us": 230.0, "spans": 2, "device_us": 250.0}
    assert fit.reduce([e for e in hand_made() if e["name"] != WINDOW]) is None


def test_fit_roofline_on_a_hand_made_trace(trace_file, monkeypatch):
    trace_file(hand_made())
    read = harness.metric_reader("fit_roofline")
    monkeypatch.setattr("sys.argv", ["benchmark/run.py", "--workload", CELL, "--seed", "3"])
    want = 100.0 * 2 * _least_us() / 250.0
    assert read({"trace": {"requests": 2}}) == pytest.approx(want, rel=1e-12)
    assert fit.fit_roofline_pct({"trace": {"requests": 2}}, CELL) == pytest.approx(want, rel=1e-12)
    assert 40.0 < want < 50.0
    assert read({"trace": None}) is None
    monkeypatch.setattr("sys.argv", ["benchmark/run.py", f"--workload={CELL}"])
    assert read({"trace": {"requests": 4}}) == pytest.approx(2 * want, rel=1e-12)
    # a cell that fits no variogram, or no cell on the command line
    monkeypatch.setattr("sys.argv", ["benchmark/run.py", "--workload", "grida-idw-5m"])
    assert read({"trace": {"requests": 2}}) is None
    monkeypatch.setattr("sys.argv", ["pytest"])
    assert read({"trace": {"requests": 2}}) is None


def test_fit_host_ms_on_a_hand_made_trace(trace_file):
    trace_file(hand_made())
    read = harness.metric_reader("fit_host_ms.fill")
    assert read({"trace": {"requests": 2}}) == pytest.approx(0.115, abs=1e-12)
    assert read({"trace": {"requests": 3}}) is None  # roots are not one a request
    assert read({"trace": None}) is None


def test_nothing_to_read_reads_nothing(trace_file, monkeypatch):
    # a program without the fit's span, and a window without its kernels
    monkeypatch.setattr("sys.argv", ["benchmark/run.py", "--workload", CELL])
    trace_file([e for e in hand_made() if "fit_variogram" not in e["name"]])
    assert harness.metric_reader("fit_host_ms.fill")({"trace": {"requests": 2}}) is None
    trace_file([e for e in hand_made() if e["cat"] != "kernel" or "kriging" in e["name"]])
    assert harness.metric_reader("fit_roofline")({"trace": {"requests": 2}}) is None


def _brute_pairs(valid: np.ndarray, max_lag: int) -> int:
    """Pairs of observed cells at a half-plane offset within ``max_lag``,
    counted pair by pair."""
    h, w = valid.shape
    cells = list(zip(*np.nonzero(valid)))
    n = 0
    for i, (r0, c0) in enumerate(cells):
        for r1, c1 in cells[i + 1:]:
            dy, dx = r1 - r0, c1 - c0
            if (dy > 0 or (dy == 0 and dx > 0)) and dx * dx + dy * dy <= max_lag * max_lag:
                n += 1
    return n


@pytest.mark.parametrize("shape,max_lag", [((9, 11), 3), ((14, 12), 4), ((12, 30), 10)])
def test_the_pair_count_against_a_brute_force_count(shape, max_lag):
    cfg = {"shape": list(shape), "fit": {"max_lag": max_lag, "n_bins": max_lag}}
    whole = fit.observed_pairs(cfg, {"removal": 0.0})
    assert whole == _brute_pairs(np.ones(shape, bool), max_lag)
    nbytes, f32, f64 = fit.fit_pairs(cfg, {"removal": 0.0})
    assert nbytes == 8 * shape[0] * shape[1] and f32 == f64 == 2 * whole
    # masked at random: the mean over masks is the expectation, (1 - r)^2 of
    # the pairs, less the small correction of drawing without replacement
    removal = 0.2
    gen = generator(7, "cpu")
    counts = []
    for _ in range(200):
        valid = np.ones(shape[0] * shape[1], bool)
        valid[mask_cells(gen, shape, removal).numpy()] = False
        counts.append(_brute_pairs(valid.reshape(shape), max_lag))
    n = shape[0] * shape[1]
    m = int(n * removal)
    exact = whole * (n - m) * (n - m - 1) / (n * (n - 1))
    assert fit.observed_pairs(cfg, {"removal": removal}) == pytest.approx(whole * 0.64, rel=1e-12)
    assert np.mean(counts) == pytest.approx(exact, rel=0.01)
    assert abs(exact / (whole * 0.64) - 1.0) < 0.02


def test_the_stand_in_cell_counts_as_published():
    _, cfg, traffic = harness.cell_files(CELL)
    assert fit.observed_pairs(cfg, traffic) == pytest.approx(638.89e6, rel=1e-4)
    assert _least_us() == pytest.approx(56.65, rel=1e-3)


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
@pytest.mark.parametrize("shape,removal", [((48, 64), 0.1), ((64, 72), 0.3)])
def test_the_reference_is_the_program_at_a_small_size(seed, shape, removal):
    from auvtpu_torch.entry import fit_fill

    torch.set_num_threads(1)
    _, cfg, traffic = harness.cell_files(CELL)
    cfg = dict(cfg, shape=list(shape))
    traffic = dict(traffic, removal=removal, pool=2)
    pool = masked_tiles(cfg, traffic, seed, "cpu", harness.resolve(cfg["grid_class"]))
    for e in pool:
        got = fit_fill(e["grid"])[0].reshape(-1)[e["flat"]]
        want = fitfill.fit_fill_cells(e["ref"], cfg)
        assert harness.gap(got, want) == (0.0, 0)
