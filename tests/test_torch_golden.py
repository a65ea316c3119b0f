"""The port's numpy copies of the golden f64 engines (GoldenGrid, GoldenV2)
give exactly the arrays of ``auvtpu.golden`` on masked and fully valid
grids, at random, tie-line, edge and out-of-bounds queries."""

import numpy as np
import pytest

from auvtpu.golden import GoldenGrid as JGoldenGrid
from auvtpu.golden.v2 import GoldenV2 as JGoldenV2
from auvtpu.masking import mask_grid
from auvtpu.synthetic import shelf_seamount

from auvtpu_torch.golden import GoldenGrid, GoldenV2

H, W = 96, 80
BOUNDS = (0.0, W - 1.0, 0.0, H - 1.0)


def _queries():
    rng = np.random.default_rng(11)
    lons = rng.uniform(-1.0, W, 700)
    lats = rng.uniform(-1.0, H, 700)
    lons = np.concatenate([lons, [3.0, 4.5, 10.0, 77.5, 0.0, 0.5, W - 1.0]])
    lats = np.concatenate([lats, [5.0, 6.5, 90.5, 2.0, 0.0, 1.5, H - 1.0]])
    return lons.astype(np.float32).astype(np.float64), lats.astype(np.float32).astype(np.float64)


@pytest.fixture(scope="module", params=["masked", "valid"])
def elev(request):
    e = shelf_seamount(H, W)
    return mask_grid(e, 0.2, seed=9)[0] if request.param == "masked" else e


@pytest.mark.parametrize("method", ["bilinear", "cubic", "kriging"])
def test_golden_grid_equal(elev, method):
    lons, lats = _queries()
    got = getattr(GoldenGrid(elev, *BOUNDS), method)(lons, lats)
    want = getattr(JGoldenGrid(elev, *BOUNDS), method)(lons, lats)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("convention", ["reference", "centered"])
def test_golden_v2_equal(elev, convention):
    lons, lats = _queries()
    g = GoldenV2(elev, *BOUNDS, convention=convention, chunk=256)  # several chunks
    jg = JGoldenV2(elev, *BOUNDS, convention=convention, chunk=256)
    for method in ("cubic", "kriging"):
        np.testing.assert_array_equal(getattr(g, method)(lons, lats), getattr(jg, method)(lons, lats))
    for k, power in ((8, 2.0), (4, 0.0), (5, 1.5)):
        np.testing.assert_array_equal(g.idw(lons, lats, k=k, power=power), jg.idw(lons, lats, k=k, power=power))
