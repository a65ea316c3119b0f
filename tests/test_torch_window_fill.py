"""The port's window-fill kernels and their plain versions against the JAX
package, on the 96x80 masked grid of tests/test_pallas.py with R=5.

On the CPU the wrappers run their plain versions, which are held to the
Pallas kernels (in interpret mode) and to the XLA path: selection exactly,
kriging planes with equal NaN placement and rtol=1e-4, atol=0.05 (the JAX
package's own bar for Pallas vs XLA, tests/test_pallas.py:110).  The CUDA
kernels themselves run only on a card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from auvtpu.config import Extent as JExtent
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import fill_kriging as j_fill_kriging
from auvtpu.ops.dense import window_topk_planes as j_window_topk_planes
from auvtpu.pallas import pallas_fill_kriging, pallas_topk_full
from auvtpu.synthetic import shelf_seamount
from jax.experimental.pallas import tpu as pltpu

from auvtpu_torch.convert import grid_from_arrays
from auvtpu_torch.grid import RegularGrid
from auvtpu_torch.kernels import window_fill as wf
from auvtpu_torch.ops import fill_kriging

torch.set_num_threads(1)

H, W, R = 96, 80, 5
RTOL, ATOL = 1e-4, 0.05


@pytest.fixture(scope="module")
def jgrid():
    elev = shelf_seamount(H, W)
    elev, _, _ = mask_grid(elev, 0.2, seed=9)
    return JGrid.from_nan_array(elev, JExtent(0.0, float(W - 1), 0.0, float(H - 1)))


@pytest.fixture(scope="module")
def tgrid(jgrid):
    return grid_from_arrays(
        np.asarray(jgrid.elev), np.asarray(jgrid.valid),
        jgrid.min_lon, jgrid.max_lon, jgrid.min_lat, jgrid.max_lat, "cpu",
    )


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_plane_close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=ATOL)


def _assert_selection_equal(got, want, *, empty_slots=True):
    cnt = _np(want[0])
    np.testing.assert_array_equal(_np(got[0]), cnt)
    for part in (1, 2, 3):
        for s, (a, b) in enumerate(zip(got[part], want[part])):
            live = cnt > s if not empty_slots else np.ones_like(cnt, bool)
            np.testing.assert_array_equal(_np(a)[live], _np(b)[live])


def test_topk_full_ref_matches_pallas(jgrid, tgrid):
    with pltpu.force_tpu_interpret_mode():
        want = pallas_topk_full(jgrid, k=4, max_radius=R, tile=(32, 32))
    got = wf.topk_full_ref(tgrid, k=4, max_radius=R)
    # empty slots too: value 0 and offset (-R, -R) on both sides
    _assert_selection_equal(got, want)
    assert (_np(got[0]) == 4).mean() > 0.99


@pytest.mark.parametrize("convention", ["reference", "centered"])
def test_topk_full_ref_matches_window_topk_planes(jgrid, tgrid, convention):
    want = j_window_topk_planes(jgrid, k=4, max_radius=R, convention=convention)
    got = wf.topk_full_ref(tgrid, k=4, max_radius=R, convention=convention)
    # window_topk_planes leaves empty offsets at 0: compare live slots
    _assert_selection_equal(got, want, empty_slots=False)


def test_fill_kriging_fused_ref_matches_pallas(jgrid, tgrid):
    with pltpu.force_tpu_interpret_mode():
        want = pallas_fill_kriging(jgrid, max_radius=R, tile=(32, 32))
    _assert_plane_close(wf.fill_kriging_fused_ref(tgrid, max_radius=R), want)


VARIANTS = {
    "exponential": dict(),
    "linear": dict(model="linear", vparams=(1.0, 5.0, 10.0)),
    "spherical": dict(model="spherical", vparams=(0.5, 80.0, 12.0)),
    "gaussian": dict(model="gaussian", vparams=(2.0, 150.0, 6.0)),
    "centered": dict(convention="centered"),
    "variance": dict(with_variance=True),
    "subplane": dict(row0=40, col0=24, steps=(0.5, 0.75)),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fused_options_match_xla(jgrid, tgrid, variant):
    kw = VARIANTS[variant]
    want = j_fill_kriging(jgrid, max_radius=R, backend="xla", **kw)
    got = wf.fill_kriging_fused(tgrid, max_radius=R, **kw)
    if kw.get("with_variance"):
        _assert_plane_close(got[0], want[0])
        _assert_plane_close(got[1], want[1])
        assert (_np(got[1])[~np.isnan(_np(got[1]))] >= 0).all()
    else:
        _assert_plane_close(got, want)


def test_lu_solver_within_bound_of_gj(tgrid):
    gj, var_gj = wf.fill_kriging_fused(tgrid, max_radius=R, solver="gj", with_variance=True)
    lu, var_lu = wf.fill_kriging_fused(tgrid, max_radius=R, solver="lu", with_variance=True)
    np.testing.assert_array_equal(np.isnan(_np(gj)), np.isnan(_np(lu)))
    ok = ~np.isnan(_np(gj))
    np.testing.assert_allclose(_np(lu)[ok], _np(gj)[ok], rtol=1.5e-3)
    with pytest.raises(ValueError):
        wf.fill_kriging_fused(tgrid, max_radius=R, solver="qr")


def test_cpu_grid_takes_plain_path(tgrid):
    wf.reset_launches()
    sel = wf.topk_full(tgrid, k=4, max_radius=R)
    _assert_selection_equal(sel, wf.topk_full_ref(tgrid, k=4, max_radius=R))
    plane = wf.fill_kriging_fused(tgrid, max_radius=R)
    np.testing.assert_array_equal(_np(plane), _np(wf.fill_kriging_fused_ref(tgrid, max_radius=R)))
    # every backend of fill_kriging runs the same plain path on the CPU
    for backend in ("torch", "select", "fused"):
        np.testing.assert_array_equal(_np(fill_kriging(tgrid, max_radius=R, backend=backend)), _np(plane))
    assert wf.LAUNCHES["topk_full"] == 0 and wf.LAUNCHES["fill_kriging_fused"] == 0
    assert all(n == 0 for n in wf.LAUNCHES.values())
    with pytest.raises(ValueError):
        fill_kriging(tgrid, max_radius=R, backend="pallas")


def test_float64_grid_runs_plain_path(tgrid):
    g64 = RegularGrid(tgrid.elev.double(), tgrid.valid.double(), tgrid.min_lon, tgrid.max_lon, tgrid.min_lat, tgrid.max_lat)
    got = wf.fill_kriging_fused(g64, max_radius=R)
    assert got.dtype == torch.float64
    _assert_plane_close(got.float(), wf.fill_kriging_fused(tgrid, max_radius=R))


def test_wrappers_refuse_a_grid_off_cpu_and_cuda(tgrid):
    meta = RegularGrid(
        torch.empty(tgrid.shape, device="meta"), torch.empty(tgrid.shape, device="meta"),
        tgrid.min_lon, tgrid.max_lon, tgrid.min_lat, tgrid.max_lat,
    )
    with pytest.raises(ValueError, match="CUDA grid"):
        wf.topk_full(meta, k=4, max_radius=R)
    with pytest.raises(ValueError, match="CUDA grid"):
        wf.fill_kriging_fused(meta, max_radius=R)
