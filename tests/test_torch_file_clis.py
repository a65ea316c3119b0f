"""The port's file and figure CLIs against the JAX package's, on the CPU:

- ``gen_grid``, ``analyze`` and ``subset`` write files equal to the JAX
  CLIs': byte for byte, but for the grid CSVs, whose values are equal
  exactly (the JAX package writes them through its native library with 17
  significant digits, pandas with the fewest that read back the same
  value); ``subset`` reads a
  netCDF3 tile made of the Kerguelen stand-in's top-left 128x160 cells (no
  GEBCO tile is in the repository);
- ``plots.reconstruct`` and ``figures.coverage_table`` on that crop against
  the JAX package's fills (``fill_bilinear``, ``fill_window_mean``,
  ``fill_idw``, ``kriging_at_cells``) at tests/test_torch_dense_fills.py's
  bars (rtol 1e-5 / atol 1e-3; kriging rtol 1e-4 / atol 0.05), NaN in the
  same places and the bilinear hole counts equal exactly;
- the PNG writers run (``plots`` and ``figures`` on the stand-in).
"""

import filecmp
import os

import numpy as np
import pandas as pd
import pytest
import torch

import auvtpu.config as jcfg
from auvtpu.cli.analyze import main as j_analyze
from auvtpu.cli.gen_grid import main as j_gen_grid
from auvtpu.cli.subset import main as j_subset
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.metrics import coverage as j_coverage
from auvtpu.ops import dense as jd

from auvtpu_torch.cli import analyze, figures, gen_grid, plots, subset
from auvtpu_torch.config import Extent
from auvtpu_torch.io import ResultsWriter
from auvtpu_torch.synthetic import kerguelen_standin

torch.set_num_threads(1)

CROP = (128, 160)
RTOL, ATOL = 1e-5, 1e-3


def _crop():
    tile = jcfg.GEBCO_TILES["kerguelen"]
    elev = kerguelen_standin(tile["shape"])
    ext = tile["extent"]
    dlat = (ext.max_lat - ext.min_lat) / (elev.shape[0] - 1)
    dlon = (ext.max_lon - ext.min_lon) / (elev.shape[1] - 1)
    h, w = CROP
    return elev[:h, :w].copy(), Extent(ext.min_lon, ext.min_lon + dlon * (w - 1), ext.min_lat,
                                       ext.min_lat + dlat * (h - 1))


@pytest.fixture(scope="module")
def crop():
    return _crop()


def _same_files(a, b, names):
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False), n


def _same_grids(a, b, names):
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if n.endswith(".npy"):
            ga, gb = np.load(pa), np.load(pb)
        else:
            ga, gb = (pd.read_csv(p, header=None, na_values=["nan"], float_precision="round_trip").to_numpy(np.float64)
                      for p in (pa, pb))
        assert ga.shape == gb.shape and np.array_equal(ga, gb, equal_nan=True), n


@pytest.mark.parametrize("surface, out", [("shelf_seamount", "g.csv"), ("sinusoid", "g.npy")])
def test_gen_grid_equals_jax(tmp_path, surface, out):
    for d, fn in (("jax", j_gen_grid), ("port", gen_grid.main)):
        os.makedirs(tmp_path / d)
        fn(["--num-lon", "23", "--num-lat", "17", "--surface", surface, "--out", str(tmp_path / d / out)])
    _same_grids(tmp_path / "jax", tmp_path / "port", [out])


def test_analyze_equals_jax(tmp_path):
    results = str(tmp_path / "res.csv")
    w = ResultsWriter(results, with_region=True)
    for mach in ("CPU", "GPU"):
        for n, t in ((1000, 1.5), (5000, 2.25)):
            w.append(mach, "Bilinear", "A", n, t, None, None, None, None)
        w.append(mach, "Kriging", "B", 500, 2.5, 0.1, 10.0, 12.0, 99.0, region="mariana")
        w.append(mach, "IDW", "B", 500, 1.5, 0.2, 11.0, 13.0, 98.0, region="kerguelen")
    j_analyze(["--results", results, "--out-dir", str(tmp_path / "jax")])
    analyze.main(["--results", results, "--out-dir", str(tmp_path / "port")])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        "grid_A_runtimes_averaged.csv", "kerguelen_runtimes_errors.csv", "mariana_runtimes_errors.csv"]
    _same_files(tmp_path / "jax", tmp_path / "port", names)


def test_subset_equals_jax(tmp_path, crop):
    from scipy.io import netcdf_file

    elev, ext = crop
    nc = str(tmp_path / "tile.nc")
    f = netcdf_file(nc, "w")
    f.createDimension("lat", elev.shape[0])
    f.createDimension("lon", elev.shape[1])
    for name, vals in (("lat", np.linspace(ext.min_lat, ext.max_lat, elev.shape[0])),
                       ("lon", np.linspace(ext.min_lon, ext.max_lon, elev.shape[1]))):
        v = f.createVariable(name, "d", (name,))
        v[:] = vals
    v = f.createVariable("elevation", "h", ("lat", "lon"))
    v[:] = np.round(elev[::-1]).astype(np.int16)  # the file order: the CLI flips it
    f.close()
    for d, fn in (("jax", j_subset), ("port", subset.main)):
        fn(["--nc", nc, "--removal", "0.07", "--seed", "5", "--out-dir", str(tmp_path / d)])
    _same_grids(tmp_path / "jax", tmp_path / "port", ["original_data.csv", "reduced_data.csv"])
    _same_files(tmp_path / "jax", tmp_path / "port", ["reference_missing.csv", "reference_missing_coords.csv"])
    red = pd.read_csv(str(tmp_path / "port" / "reduced_data.csv"), header=None).to_numpy()
    assert np.isnan(red).sum() == int(elev.size * 0.07)
    # the stand-in region has no tile: its coordinates are the extent's
    lat, lon, data = subset.load_tile(None, "kerguelen", "")
    assert data.shape == jcfg.GEBCO_TILES["kerguelen"]["shape"] == (len(lat), len(lon))
    assert lat[0] == jcfg.KERGUELEN_EXTENT.min_lat and lon[-1] == jcfg.KERGUELEN_EXTENT.max_lon


def _jax_fill(jgrid, method, rc):
    if method == "Kriging":
        return np.asarray(jd.kriging_at_cells(jgrid, rc[:, 0], rc[:, 1]))
    plane = {"Bilinear": jd.fill_bilinear, "Cubic": lambda g: jd.fill_window_mean(g, k=4),
             "IDW": lambda g: jd.fill_idw(g, k=8)}[method](jgrid)
    return np.asarray(plane)[rc[:, 0], rc[:, 1]]


@pytest.mark.parametrize("method", ["Bilinear", "Cubic", "Kriging", "IDW"])
def test_plots_reconstruct_matches_jax(crop, method):
    elev, ext = crop
    filled, pred, rc, truth = plots.reconstruct(elev, ext, 0.2, method, device="cpu")
    reduced, jrc, jtruth = mask_grid(elev, 0.2)
    np.testing.assert_array_equal(rc, jrc)
    np.testing.assert_array_equal(truth, jtruth)
    want = _jax_fill(JGrid.from_nan_array(reduced, ext), method, rc)
    np.testing.assert_array_equal(np.isnan(pred), np.isnan(want))
    ok = ~np.isnan(want)
    rtol, atol = (1e-4, 0.05) if method == "Kriging" else (RTOL, ATOL)
    np.testing.assert_allclose(pred[ok], want[ok], rtol=rtol, atol=atol)
    # observed cells keep their values, holes take the prediction
    obs = ~np.isnan(reduced)
    np.testing.assert_array_equal(filled[obs], reduced[obs])
    np.testing.assert_array_equal(filled[rc[:, 0], rc[:, 1]], pred)
    if method == "Bilinear":
        assert np.isnan(pred).sum() == np.isnan(want).sum() > 0
    with pytest.raises(ValueError):
        plots.reconstruct(elev, ext, 0.2, "Spline", device="cpu")


def test_coverage_table_matches_jax(crop):
    elev, ext = crop
    removals = (0.2, 0.5)
    rows = figures.coverage_table(elev, ext, removals, device="cpu")
    assert [r["removal"] for r in rows] == list(removals)
    for r in rows:
        reduced, rc, truth = mask_grid(elev, r["removal"])
        jg = JGrid.from_nan_array(reduced, ext)
        pb = _jax_fill(jg, "Bilinear", rc)
        pc = _jax_fill(jg, "Cubic", rc)
        assert r["masked_pts"] == len(truth)
        assert r["bilinear_holes"] == int(np.isnan(pb).sum())
        assert r["bilinear_coverage"] == pytest.approx(float(j_coverage(pb)), abs=1e-7)
        assert r["cubic_fallback_coverage"] == pytest.approx(float(j_coverage(pc)), abs=1e-7) == 1.0
        assert r["analytic_hole_fraction"] == r["removal"] ** 3
    assert rows[1]["bilinear_holes"] > 1.5 * rows[0]["bilinear_holes"] > 0


def test_png_writers_run(tmp_path):
    plots.main(["--region", "kerguelen", "--removal", "0.1", "--method", "Bilinear", "--device", "cpu",
                "--out-dir", str(tmp_path / "plots")])
    pngs = sorted(f for f in os.listdir(tmp_path / "plots") if f.endswith(".png"))
    assert pngs == ["kerguelen_r0.1_error_bilinear.png", "kerguelen_r0.1_filled_bilinear.png",
                    "kerguelen_r0.1_masked.png", "kerguelen_r0.1_original.png"]
    b_csv = str(tmp_path / "b.csv")
    w = ResultsWriter(b_csv, with_region=True)
    for mach in ("GPU", "GPU-centered", "GPU-gaussian"):
        w.append(mach, "Kriging", "B", 500, 2.5, 0.1, 10.0, 12.0, 99.0, region="kerguelen")
    a_csv = str(tmp_path / "a.csv")
    w = ResultsWriter(a_csv)
    for n in (1000, 100000):
        w.append("GPU", "Bilinear", "A", n, 0.5, None, None, None, None)
    out = tmp_path / "figs"
    figures.main(["--grid-a", a_csv, "--grid-b", b_csv, "--out-dir", str(out), "--coverage-region", ""])
    assert sorted(os.listdir(out)) == ["grid_a_runtimes.png", "grid_b_accuracy.png", "grid_b_variogram_models.png"]
    df = figures.fig_coverage(str(out / "holes.png"), str(out / "holes.csv"), region="kerguelen",
                              removals=(0.3,), device="cpu")
    assert os.path.exists(out / "holes.png") and len(pd.read_csv(out / "holes.csv")) == len(df) == 1


def test_console_scripts_cover_every_cli(tmp_path, monkeypatch):
    import sys
    import tomllib
    from pathlib import Path

    from auvtpu_torch.cli import scripts

    root = Path(__file__).resolve().parent.parent
    conf = tomllib.loads((root / "pyproject.toml").read_text())["project"]["scripts"]
    ours = {k: v for k, v in conf.items() if k.startswith("auvtpu-torch-")}
    clis = {p.stem for p in (root / "auvtpu_torch" / "cli").glob("*.py") if "def main(" in p.read_text()}
    assert {v.split(":")[1] for v in ours.values()} == clis
    for k, v in ours.items():
        assert v.startswith("auvtpu_torch.cli.scripts:") and k == "auvtpu-torch-" + v.split(":")[1].replace("_", "-")
    out = tmp_path / "g.npy"
    monkeypatch.setattr(sys, "argv", ["auvtpu-torch-gen-grid", "--num-lon", "5", "--num-lat", "4", "--out", str(out)])
    assert scripts.gen_grid() == 0 and np.load(out).shape == (4, 5)
