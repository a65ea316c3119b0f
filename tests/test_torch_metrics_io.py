"""The port's copies of ``auvtpu.metrics``, ``auvtpu.io`` and
``auvtpu.utils.timing`` against the originals: metrics equal on numpy
arrays and on torch tensors (quirks included), files byte-identical."""

import numpy as np
import pytest
import torch

import auvtpu.io as jio
import auvtpu.metrics as jm

import auvtpu_torch.io as tio
import auvtpu_torch.metrics as tm
from auvtpu_torch.utils import steady_state_ms, time_once_ms, warm_e2e_ms

torch.set_num_threads(1)

METRICS = ["mae_reference", "rmse_reference", "max_error_reference", "mae_corrected", "rmse_corrected", "range_normalized_rmse"]


@pytest.fixture
def ref_pred():
    rng = np.random.RandomState(5)
    ref = rng.normal(-1000.0, 50.0, 400)
    pred = ref + rng.normal(0.0, 2.0, 400)
    pred[rng.choice(400, 37, replace=False)] = np.nan
    return ref, pred


@pytest.mark.parametrize("name", METRICS)
def test_metrics_equal_on_numpy_and_torch(ref_pred, name):
    ref, pred = ref_pred
    want = float(getattr(jm, name)(ref, pred))
    assert float(getattr(tm, name)(ref, pred)) == want
    got_t = getattr(tm, name)(ref, torch.from_numpy(pred))
    assert torch.is_tensor(got_t)
    assert float(got_t) == pytest.approx(want, rel=1e-12)


def test_metric_quirks_kept(ref_pred):
    ref, pred = ref_pred
    allnan = np.full_like(pred, np.nan)
    for x in (allnan, torch.from_numpy(allnan)):
        assert float(tm.max_error_reference(ref, x)) == 0.0  # reference starts at 0
        assert float(tm.rmse_reference(ref, x)) == 0.0  # NaNs skipped, sum / N
    assert float(tm.coverage(pred)) == float(jm.coverage(pred))
    assert float(tm.coverage(torch.from_numpy(pred))) == pytest.approx(float(jm.coverage(pred)))
    assert tm.all_reference_metrics(ref, pred) == jm.all_reference_metrics(ref, pred)


def test_grid_and_point_csvs_byte_identical(tmp_path):
    rng = np.random.RandomState(1)
    grid = rng.normal(-100.0, 10.0, (7, 9))
    grid[2, 3] = grid[6, 0] = np.nan
    tio.write_grid_csv(str(tmp_path / "t.csv"), grid)
    # the JAX package's pandas path (its native library may be absent)
    import pandas as pd

    pd.DataFrame(grid).to_csv(str(tmp_path / "j.csv"), header=False, index=False, na_rep="nan")
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()
    got = tio.read_grid_csv(str(tmp_path / "t.csv"))
    # equal to the JAX package's pandas path; its native reader, where built,
    # parses to within an ulp
    want = pd.read_csv(str(tmp_path / "j.csv"), header=None, dtype=np.float64, na_values=["nan"]).to_numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, jio.read_grid_csv(str(tmp_path / "j.csv")), rtol=1e-15, atol=0)

    rc = np.array([[0, 1], [5, 8], [3, 3]])
    vals = np.array([-1.5, -2000.125, 3.0])
    for mod, tag in ((tio, "t"), (jio, "j")):
        mod.write_points_csv(str(tmp_path / f"{tag}_pts.csv"), [1.0, 2.5, 3.25], [0.5, -1.0, 2.0], vals)
        mod.write_reference_missing(str(tmp_path / f"{tag}_miss.csv"), rc, vals)
    for f in ("pts", "miss"):
        assert (tmp_path / f"t_{f}.csv").read_bytes() == (tmp_path / f"j_{f}.csv").read_bytes()
    for a, b in zip(tio.read_reference_missing(str(tmp_path / "t_miss.csv")),
                    jio.read_reference_missing(str(tmp_path / "t_miss.csv"))):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_results_writer_byte_identical(tmp_path):
    for mod, tag in ((tio, "t"), (jio, "j")):
        w = mod.ResultsWriter(str(tmp_path / tag / "res.csv"), with_region=True, with_cold=True)
        w.append("GPU", "IDW", "B", 1000, 0.123456789, 0.1, 4.4, 5.5, 30.25, region="kerguelen", cold_ms=1.5)
        w.append("GPU", "Bilinear", "A", 5, 2.0, None, None, None, None)
        mod.ResultsWriter(str(tmp_path / tag / "plain.csv"))
    for f in ("res.csv", "plain.csv"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()


def test_load_gebco_matches(tmp_path):
    from scipy.io import netcdf_file

    path = str(tmp_path / "tile.nc")
    f = netcdf_file(path, "w")
    f.createDimension("lat", 4)
    f.createDimension("lon", 5)
    f.createVariable("lat", "f8", ("lat",))[:] = np.linspace(9.0, 9.3, 4)
    f.createVariable("lon", "f8", ("lon",))[:] = np.linspace(138.0, 138.4, 5)
    f.createVariable("elevation", "i2", ("lat", "lon"))[:] = np.arange(-20, 0, dtype=np.int16).reshape(4, 5)
    f.close()
    for fn in ("load_gebco", "load_gebco_flipped"):
        for a, b in zip(getattr(tio, fn)(path), getattr(jio, fn)(path)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def test_timing_utils_on_cpu_results():
    calls = []

    def fn(x):
        calls.append(1)
        return (x * 2, [x + 1])

    x = torch.arange(8.0)
    ms, out = time_once_ms(fn, x)
    assert ms >= 0 and torch.equal(out[0], x * 2)
    best, out = warm_e2e_ms(fn, x, reps=2)
    assert best >= 0 and torch.equal(out[1][0], x + 1)
    assert steady_state_ms(fn, x, iters=3, warmup=1) >= 0
    assert len(calls) == 1 + 3 + 4
