"""The port's CLIs against the JAX package's, on the CPU at a small size:
``bench_grid_b`` on a reduced/reference CSV pair (the same CSV header, and
MAE/RMSE/max within 1e-3 of the JAX CLI's rows) and ``stream_demo`` (the
JAX demo's (rmse, span), exactly: the mosaics are bit-equal)."""

import numpy as np
import pandas as pd
import pytest
import torch

from auvtpu.cli.bench_grid_b import main as j_bench_grid_b
from auvtpu.cli.mission import main as j_mission
from auvtpu.cli.stream_demo import main as j_stream_demo
from auvtpu.io import write_grid_csv, write_reference_missing
from auvtpu.masking import mask_grid
from auvtpu.synthetic import shelf_seamount

from auvtpu_torch.cli import bench_grid_b, mission, stream_demo
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


@pytest.fixture
def jax_x64_restored():
    """The JAX CLIs switch x64 on for exact mode and leave it on: put the
    flag back after the test."""
    import jax

    old = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("tier", ["two", "strict"])
def test_bench_grid_b_exact_matches_jax_cli(csv_pair, tmp_path, tier, jax_x64_restored):
    args, n = csv_pair
    extra = ["--selection", "exact", "--exact-tier", tier]
    out, j_out = str(tmp_path / "res.csv"), str(tmp_path / "jres.csv")
    summary = bench_grid_b.main(args + extra + ["--results", out, "--device", "cpu"])
    j_bench_grid_b(args + extra + ["--results", j_out])
    got, want = pd.read_csv(out), pd.read_csv(j_out)
    assert list(got["InterpolationType"]) == list(want["InterpolationType"]) == ["Bilinear", "Cubic", "Kriging"]
    assert (got["Machine"] == "GPU-exact").all() and (got["BatchSize"] == n).all()
    for col in METRICS:
        np.testing.assert_allclose(got[col], want[col], rtol=1e-5, atol=0)  # the CSV's 6 digits
    for m in summary.values():
        assert np.isfinite(m["RMSE"]) and m["n"] == n
    with pytest.raises(SystemExit):
        bench_grid_b.main(args + extra + ["--convention", "centered", "--device", "cpu"])


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


@pytest.mark.parametrize("shard", [["--shard", "2"], ["--shard2d", "2", "1"]])
def test_stream_demo_sharded_matches_one_device(tmp_path, shard):
    # the same survey with the mosaic over two gloo ranks on the CPU: the
    # mosaic bit-equal to the one-device demo's, so the score is equal
    argv = ["--mosaic", "128", "128", "--steps", "60", "--beams", "96",
            "--fill-every", "20", "--window", "64", "--device", "cpu"]
    one, sharded = str(tmp_path / "one.npy"), str(tmp_path / "sharded.npy")
    want = stream_demo.main(argv + ["--out-npy", one])
    assert stream_demo.main(argv + shard + ["--out-npy", sharded]) == want
    np.testing.assert_array_equal(np.load(sharded), np.load(one))


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


@pytest.mark.parametrize("backend", ["auto", "torch", "fused"])
def test_bench_grid_a_cpu(tmp_path, backend):
    from auvtpu.io import ResultsWriter as JResultsWriter

    from auvtpu_torch.cli import bench_grid_a
    from auvtpu_torch.kernels import scattered_select as ss

    out = str(tmp_path / "res.csv")
    ss.reset_launches()
    summary = bench_grid_a.main([
        "--num-lon", "80", "--num-lat", "64", "--batch-sizes", "1000", "--device", "cpu",
        "--backend", backend, "--results", out,
    ])
    assert all(c == 0 for c in ss.LAUNCHES.values())  # a CPU grid runs the plain versions
    methods = ["Bilinear", "Cubic", "Kriging", "IDW"]
    assert sorted(summary) == sorted((m, 1000) for m in methods)
    assert all(v["validated"] for v in summary.values())
    got = pd.read_csv(out)
    j_out = str(tmp_path / "j.csv")
    JResultsWriter(j_out, with_region=True, with_cold=True)
    assert list(got.columns) == list(pd.read_csv(j_out).columns)
    assert list(got["InterpolationType"]) == methods
    assert (got["GridType"] == "A").all() and (got["BatchSize"] == 1000).all() and (got["Region"] == "grid_a").all()
    assert got["RMSE"].isna().all() and (got["Time"] > 0).all()


def test_bench_grid_a_windowed_and_expanded(tmp_path):
    from auvtpu_torch.cli import bench_grid_a

    prefix = str(tmp_path / "exp")
    summary = bench_grid_a.main([
        "--num-lon", "40", "--num-lat", "32", "--batch-sizes", "300", "--device", "cpu", "--no-packed",
        "--results", str(tmp_path / "res.csv"), "--expanded", "--expanded-out-prefix", prefix,
    ])
    assert all(v["validated"] for v in summary.values())
    for name in ("bilin", "cubic", "kriging", "idw"):
        grid = np.loadtxt(f"{prefix}_gpu_{name}.csv", delimiter=",")
        assert grid.shape == (63, 79) and np.isfinite(grid).all()


def test_bench_grid_a_exact_cpu(tmp_path, capsys):
    from auvtpu_torch.cli import bench_grid_a

    out = str(tmp_path / "res.csv")
    summary = bench_grid_a.main([
        "--num-lon", "80", "--num-lat", "64", "--batch-sizes", "1000", "--device", "cpu",
        "--selection", "exact", "--results", out,
    ])
    assert sorted(summary) == sorted((m, 1000) for m in ("Bilinear", "Cubic", "Kriging"))
    assert all(v["validated"] for v in summary.values())  # GoldenGrid at 1e-9 x scale
    assert "dropping unsupported methods ['IDW']" in capsys.readouterr().out
    assert list(pd.read_csv(out)["InterpolationType"]) == ["Bilinear", "Cubic", "Kriging"]


def test_learned_eval_cpu(tmp_path):
    from auvtpu.learned import load_params as j_load_params

    from auvtpu_torch.cli import learned_eval

    out, ckpt = str(tmp_path / "res.csv"), str(tmp_path / "p.npz")
    base = ["--device", "cpu", "--synthetic", "48", "48", "--results", out, "--tile", "16", "--width", "8",
            "--depth", "1", "--removal", "0.1"]
    trained = learned_eval.main(base + ["--steps", "2", "--save-params", ckpt])
    assert len(trained["losses"]) == 2 and np.isfinite(trained["losses"]).all()
    assert np.isfinite(trained["RMSE"]) and trained["n"] == round(0.1 * 48 * 48)
    _, w, d = j_load_params(ckpt)  # the JAX package reads the port's checkpoint
    assert (w, d) == (8, 1)
    loaded = learned_eval.main(base + ["--load-params", ckpt])
    assert loaded["losses"] == [] and loaded["RMSE"] == trained["RMSE"]
    rows = pd.read_csv(out)
    assert list(rows["InterpolationType"]) == ["Learned", "Learned"] and (rows["Machine"] == "CPU").all()
    assert (rows["Region"] == "synthetic48x48").all() and (rows["GridType"] == "B").all()


def test_bench_grid_a_help_names_what_is_left_out(capsys):
    from auvtpu_torch.cli import bench_grid_a

    with pytest.raises(SystemExit):
        bench_grid_a.main(["--help"])
    text = capsys.readouterr().out
    assert "--selection" in text and "exact" in text and "--backend" in text and "--device" in text


@pytest.mark.parametrize("force", [None, "band"], ids=["routed", "band"])
@pytest.mark.parametrize("synthetic", ["band", "diagonal"])
def test_mission_matches_jax_cli(tmp_path, monkeypatch, capsys, synthetic, force):
    # routed under the JAX package's cost constants (the port's are the
    # H100's own), then forced onto the band/atlas path: the same route and
    # the served depths at the two-tier bars (tests/test_torch_two_tier.py)
    from auvtpu.ops import band as jb

    from auvtpu_torch.kernels import band_resample as kb
    from auvtpu_torch.ops import band as tb

    monkeypatch.setattr(tb, "COST_NS", dict(jb.COST_NS))
    argv = ["--grid-shape", "64", "160", "--pings", "4000", "--synthetic", synthetic]
    argv += ["--force", force] if force else []
    out, j_out = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    kb.reset_launches()
    summary = mission.main(argv + ["--device", "cpu", "--out", out])
    capsys.readouterr()
    assert j_mission(argv + ["--out", j_out]) == 0
    j_log = capsys.readouterr().out
    assert kb.LAUNCHES["band_resample"] == 0  # a CPU grid runs the plain version
    got, want = pd.read_csv(out), pd.read_csv(j_out)
    assert list(got.columns) == list(want.columns) == ["lon", "lat", "interpolated_value"]
    np.testing.assert_array_equal(got[["lon", "lat"]].to_numpy(), want[["lon", "lat"]].to_numpy())
    np.testing.assert_allclose(got["interpolated_value"], want["interpolated_value"], rtol=1e-4, atol=0.1)
    assert summary["route"] == (force or "packed") and summary["n"] == 4000
    assert np.isclose(summary["depth_sum"], got["interpolated_value"].sum(), rtol=1e-6)
    if force:
        pages = [ln.split()[1] for ln in j_log.splitlines() if ln.startswith("atlas:")]
        assert summary["pages"] == (int(pages[0]) if pages else 1)
        resolved = [ln.split()[2] for ln in j_log.splitlines() if ln.startswith("resolved in-band:")]
        assert f"{1.0 - summary['unresolved'] / 4000:.4f}" == resolved[0]


def test_mission_trajectories_match_jax():
    from auvtpu.cli.mission import synthetic_trajectory as j_traj
    from auvtpu.grid import RegularGrid as JGrid

    from auvtpu_torch.config import Extent
    from auvtpu_torch.grid import RegularGrid

    for shape in ((64, 160), (512, 640), (2053, 2441)):
        H, W = shape
        ext = Extent(0.0, W - 1.0, 0.0, H - 1.0)
        g = RegularGrid.dense(np.zeros(shape), ext, device="cpu")
        jg = JGrid.dense(np.zeros(shape), ext)
        for kind in ("band", "diagonal"):
            for a, b in zip(mission.synthetic_trajectory(kind, g, 5000, 3), j_traj(kind, jg, 5000, 3)):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        mission.synthetic_trajectory("spiral", g, 10)


def test_mission_help_names_what_is_left_out(capsys):
    with pytest.raises(SystemExit):
        mission.main(["--help"])
    text = capsys.readouterr().out
    assert "--export-dir" in text and "--device" in text and "--fill-backend" in text


def test_prototype_cli_matches_jax_cli(tmp_path, capsys):
    # the Kerguelen stand-in cropped to 120x160 at 1 % (192 samples): every
    # method's MAE and RMSE within 0.5 % of the JAX CLI's (rows of the same
    # results schema; grid-aligned samples tie, which the two frameworks
    # break by the last ulp of their distances)
    from auvtpu.cli.prototype import main as j_prototype

    from auvtpu_torch.cli import prototype

    argv = ["--region", "kerguelen", "--crop", "120", "160", "--methods", "linear", "idw", "aidw", "kriging"]
    out, j_out = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    summary = prototype.main(argv + ["--device", "cpu", "--results", out])
    j_prototype(argv + ["--results", j_out])
    assert "160 x 120 cells, sampling 1.0% (uniform) on cpu" in capsys.readouterr().out
    got, want = pd.read_csv(out), pd.read_csv(j_out)
    assert list(got.columns) == list(want.columns)
    assert (got["Machine"] == "GPU-proto-uniform").all() and (want["Machine"] == "TPU-proto-uniform").all()
    assert list(got["InterpolationType"]) == list(want["InterpolationType"]) == list(summary)
    assert (got["BatchSize"] == want["BatchSize"]).all() and (got["BatchSize"] == 120 * 160 - 192).all()
    np.testing.assert_allclose(got[["MAE", "RMSE"]].to_numpy(), want[["MAE", "RMSE"]].to_numpy(), rtol=5e-3)
    assert all(np.isclose(summary[m]["rmse"], r, rtol=1e-5) for m, r in zip(got["InterpolationType"], got["RMSE"]))


def test_mission_export_dir_writes_a_pair_that_reloads(tmp_path):
    # --export-dir on the band path: the pair reloads and serves the pings
    # as the live router did (its fill bit-equal to the band, the resample's
    # resolved pings equal to the served depths)
    from auvtpu_torch.serve import load_exported_mission, read_meta

    argv = ["--device", "cpu", "--grid-shape", "64", "160", "--pings", "4000", "--force", "band",
            "--export-dir", str(tmp_path / "exp"), "--out", str(tmp_path / "port.csv")]
    summary = mission.main(argv)
    (fp, nf), (rp, nr) = summary["export"]["fill"], summary["export"]["resample"]
    assert fp.endswith("mission_fill.pt2") and rp.endswith("mission_resample.pt2") and nf > 0 and nr > 0
    assert read_meta(fp)["ops"] == ["auvtpu_torch::kriging_fill"]
    assert read_meta(rp)["ops"] == ["auvtpu_torch::band_resample"] and read_meta(rp)["masked"] is True
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.config import Extent

    reduced, _, _ = mask_grid(shelf_seamount(64, 160), 0.10, 42)
    g = RegularGrid.from_nan_array(np.asarray(reduced, np.float32), Extent(0.0, 159.0, 0.0, 63.0), device="cpu")
    fill, run = load_exported_mission(fp, rp)
    planes, vmasks = fill(g.elev, g.valid)
    served = pd.read_csv(str(tmp_path / "port.csv"))
    z, ok = run(planes, vmasks, served["lon"].to_numpy(np.float32), served["lat"].to_numpy(np.float32))
    assert summary["unresolved"] == int((~ok).sum())
    np.testing.assert_array_equal(z.numpy()[ok.numpy()], served["interpolated_value"].to_numpy(np.float32)[ok.numpy()])
    with pytest.raises(SystemExit):  # the packed route has no pair to export
        mission.main(["--device", "cpu", "--grid-shape", "64", "160", "--pings", "4000", "--force", "packed",
                      "--export-dir", str(tmp_path / "no")])
