"""The port's CLIs against the JAX package's, on the CPU at a small size:
``bench_grid_b`` on a reduced/reference CSV pair (the same CSV header, and
MAE/RMSE/max within 1e-3 of the JAX CLI's rows) and ``stream_demo`` (the
JAX demo's (rmse, span), exactly: the mosaics are bit-equal)."""

import numpy as np
import pandas as pd
import pytest
import torch

from auvtpu.cli.bench_grid_b import main as j_bench_grid_b
from auvtpu.cli.stream_demo import main as j_stream_demo
from auvtpu.io import write_grid_csv, write_reference_missing
from auvtpu.masking import mask_grid
from auvtpu.synthetic import shelf_seamount

from auvtpu_torch.cli import bench_grid_b, stream_demo
from auvtpu_torch.kernels import window_fill as wf

torch.set_num_threads(1)

METRICS = ["MAE", "RMSE", "Max Error"]


@pytest.fixture(scope="module")
def csv_pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("gridb")
    reduced, rc, vals = mask_grid(shelf_seamount(40, 50), 0.2, seed=4)
    rcsv, mcsv = str(d / "reduced.csv"), str(d / "missing.csv")
    write_grid_csv(rcsv, reduced)
    write_reference_missing(mcsv, rc, vals)
    return [
        "--reduced-csv", rcsv, "--reference-csv", mcsv,
        "--min-lon", "0", "--max-lon", "49", "--min-lat", "0", "--max-lat", "39",
    ], len(vals)


@pytest.fixture(scope="module")
def jax_rows(csv_pair, tmp_path_factory):
    args, _ = csv_pair
    out = str(tmp_path_factory.mktemp("jax") / "res.csv")
    j_bench_grid_b(args + ["--results", out])
    return pd.read_csv(out)


@pytest.mark.parametrize("backend", ["auto", "torch", "select", "fused"])
def test_bench_grid_b_matches_jax_cli(csv_pair, jax_rows, tmp_path, backend):
    args, n = csv_pair
    out = str(tmp_path / "res.csv")
    wf.reset_launches()
    summary = bench_grid_b.main(args + [
        "--results", out, "--device", "cpu", "--backend", backend,
        "--out-prefix", str(tmp_path / "pts"),
    ])
    assert all(c == 0 for c in wf.LAUNCHES.values())  # a CPU grid runs the plain versions
    got = pd.read_csv(out)
    assert list(got.columns) == list(jax_rows.columns)
    assert list(got["InterpolationType"]) == ["Bilinear", "Cubic", "Kriging", "IDW"]
    assert list(got["InterpolationType"]) == list(jax_rows["InterpolationType"])
    assert (got["GridType"] == "B").all() and (got["BatchSize"] == n).all()
    for col in METRICS:
        np.testing.assert_allclose(got[col], jax_rows[col], atol=1e-3, rtol=0)
    for method, m in summary.items():
        assert m["n"] == n and np.isfinite(m["RMSE"]) and 0 < m["coverage"] <= 1
    pts = pd.read_csv(str(tmp_path / "pts_gpu_kriging.csv"))
    assert list(pts.columns) == ["lon", "lat", "interpolated_value"] and len(pts) == n


def test_bench_grid_b_centered_and_variogram_model(csv_pair, tmp_path):
    args, _ = csv_pair
    out = str(tmp_path / "res.csv")
    j_out = str(tmp_path / "jres.csv")
    extra = ["--methods", "Kriging", "IDW", "--convention", "centered"]
    bench_grid_b.main(args + extra + ["--results", out, "--device", "cpu"])
    j_bench_grid_b(args + extra + ["--results", j_out])
    got, want = pd.read_csv(out), pd.read_csv(j_out)
    assert got["Machine"].iloc[0] == "GPU-centered"
    for col in METRICS:
        np.testing.assert_allclose(got[col], want[col], atol=1e-3, rtol=0)
    bench_grid_b.main(args + ["--methods", "Kriging", "--variogram-model", "gaussian",
                              "--results", out, "--device", "cpu"])
    df = pd.read_csv(out)
    assert df["Machine"].iloc[-1] == "GPU-gaussian" and np.isfinite(df["RMSE"].iloc[-1])


def test_bench_grid_b_help_names_what_is_left_out(capsys):
    with pytest.raises(SystemExit):
        bench_grid_b.main(["--help"])
    text = capsys.readouterr().out
    assert "--selection exact" in text and "--backend" in text


def test_stream_demo_matches_jax_demo(tmp_path):
    argv = ["--mosaic", "128", "128", "--steps", "60", "--beams", "96",
            "--fill-every", "20", "--window", "64"]
    out = str(tmp_path / "mosaic.npy")
    rmse, span = stream_demo.main(argv + ["--device", "cpu", "--out-npy", out])
    j_out = str(tmp_path / "j_mosaic.npy")
    j_rmse, j_span = j_stream_demo(argv + ["--out-npy", j_out])
    assert (rmse, span) == (j_rmse, j_span)
    np.testing.assert_array_equal(np.load(out), np.load(j_out))
    assert rmse < 1.0  # observed-cell error is bounded by the sounding noise


def test_stream_demo_uncertainty_and_methods(tmp_path):
    out = str(tmp_path / "mosaic.npy")
    for method in ("mean", "kriging"):
        rmse, _ = stream_demo.main([
            "--mosaic", "96", "96", "--steps", "30", "--beams", "64", "--fill-every", "10",
            "--window", "48", "--method", method, "--uncertainty", "--device", "cpu",
            "--out-npy", out,
        ])
        assert rmse < 1.0
    var = np.load(out + ".var.npy")
    assert var.shape == (48, 48) and (var[np.isfinite(var)] >= 0).all()


def test_lawnmower_track_matches_jax():
    from auvtpu.cli.stream_demo import lawnmower_track as j_track

    for args in ((128, 128, 60, 40), (4096, 4096, 40_000, 40), (100, 300, 7, 25)):
        for a, b in zip(stream_demo.lawnmower_track(*args), j_track(*args)):
            np.testing.assert_array_equal(a, b)
