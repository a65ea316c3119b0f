"""The port's Grid B fills and slot-index selection against the JAX package,
on the 96x80 masked grid of tests/test_pallas.py with R=5.

Selection and counts must be exactly equal; fill values within rtol=1e-5,
atol=1e-3 with equal NaN placement (the JAX package's own bar for Pallas vs
XLA, tests/test_pallas.py:44).  The plain versions of the B3 and B4 kernels
are also held to the Pallas kernels in interpret mode; the CUDA kernels
themselves run only on a card (tests/test_torch_cuda.py).
"""

import inspect
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auvtpu.config import Extent as JExtent
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import dense as jd
from auvtpu.pallas import pallas_fill_idw, pallas_topk_idx
from auvtpu.synthetic import shelf_seamount
from jax.experimental.pallas import tpu as pltpu

from auvtpu_torch import entry
from auvtpu_torch.config import Extent
from auvtpu_torch.convert import grid_from_arrays
from auvtpu_torch.grid import RegularGrid
from auvtpu_torch.kernels import window_fill as wf
from auvtpu_torch.ops import dense as td

torch.set_num_threads(1)

H, W, R = 96, 80, 5
RTOL, ATOL = 1e-5, 1e-3
CONVENTIONS = ["reference", "centered"]


@pytest.fixture(scope="module")
def jgrid():
    elev, _, _ = mask_grid(shelf_seamount(H, W), 0.2, seed=9)
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


def _assert_idx_equal(got, want):
    np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_fill_bilinear_matches_jax(jgrid, tgrid):
    got = td.fill_bilinear(tgrid)
    _assert_plane_close(got, jd.fill_bilinear(jgrid))
    assert np.isnan(_np(got)).any()  # bilinear leaves holes at this masking


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("k", [4, 8])
def test_fill_window_mean_matches_jax(jgrid, tgrid, k, convention):
    want = jd.fill_window_mean(jgrid, k=k, max_radius=R, convention=convention)
    _assert_plane_close(td.fill_window_mean(tgrid, k=k, max_radius=R, convention=convention), want)


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("k", [4, 8])
def test_fill_idw_matches_jax(jgrid, tgrid, k, convention):
    want = jd.fill_idw(jgrid, k=k, max_radius=R, convention=convention)
    _assert_plane_close(td.fill_idw(tgrid, k=k, max_radius=R, convention=convention), want)


def test_fill_idw_power_matches_jax(jgrid, tgrid):
    want = jd.fill_idw(jgrid, k=6, power=1.0, max_radius=R)
    _assert_plane_close(td.fill_idw(tgrid, k=6, power=1.0, max_radius=R), want)


@pytest.mark.parametrize("convention", CONVENTIONS)
@pytest.mark.parametrize("k", [4, 7])
def test_window_topk_idx_matches_jax(jgrid, tgrid, k, convention):
    want = jd.window_topk_idx(jgrid, k=k, max_radius=R, convention=convention)
    got = td.window_topk_idx(tgrid, k=k, max_radius=R, convention=convention)
    _assert_idx_equal(got, want)
    assert (_np(got[1][k - 1]) == -1).any() == (_np(got[0]) < k).any()


def test_slots_at_matches_jax(jgrid, tgrid):
    j_cnt, j_idx = jd.window_topk_idx(jgrid, k=4, max_radius=R)
    cnt, idx = td.window_topk_idx(tgrid, k=4, max_radius=R)
    cells = np.arange(0, H * W, 3)
    want = jd._slots_at(jgrid, j_idx, jnp.asarray(cells), R)
    got = td._slots_at(tgrid, idx, cells, R)
    for a, b in zip(got, want):
        assert a.shape == (len(cells), 4)
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_slots_at_empty_slots_match_jax():
    # a nearly empty grid: most slots stay empty and must read value 0
    elev = np.full((24, 20), np.nan)
    elev[3, 4], elev[17, 15], elev[10, 10] = -5.0, -7.0, -9.0
    jg = JGrid.from_nan_array(elev, JExtent(0.0, 19.0, 0.0, 23.0))
    tg = RegularGrid.from_nan_array(elev, Extent(0.0, 19.0, 0.0, 23.0), device="cpu")
    j_cnt, j_idx = jd.window_topk_idx(jg, k=4, max_radius=3)
    cnt, idx = td.window_topk_idx(tg, k=4, max_radius=3)
    _assert_idx_equal((cnt, idx), (j_cnt, j_idx))
    cells = np.arange(24 * 20)
    want = jd._slots_at(jg, j_idx, jnp.asarray(cells), 3)
    got = td._slots_at(tg, idx, cells, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert (_np(cnt) < 4).all()


def test_fill_idw_ref_matches_pallas(jgrid, tgrid):
    with pltpu.force_tpu_interpret_mode():
        want = pallas_fill_idw(jgrid, k=8, max_radius=R, tile=(32, 32))
    _assert_plane_close(wf.fill_idw_fused_ref(tgrid, k=8, max_radius=R), want)


def test_topk_idx_ref_matches_pallas(jgrid, tgrid):
    with pltpu.force_tpu_interpret_mode():
        want = pallas_topk_idx(jgrid, k=4, max_radius=R, tile=(32, 32))
    _assert_idx_equal(wf.topk_idx_ref(tgrid, k=4, max_radius=R), want)


def test_cpu_grid_takes_plain_path(tgrid):
    wf.reset_launches()
    np.testing.assert_array_equal(_np(wf.fill_idw_fused(tgrid, max_radius=R)), _np(td.fill_idw(tgrid, max_radius=R)))
    np.testing.assert_array_equal(_np(wf.fill_mean_fused(tgrid, max_radius=R)), _np(td.fill_window_mean(tgrid, max_radius=R)))
    _assert_idx_equal(wf.topk_idx(tgrid, k=4, max_radius=R), td.window_topk_idx(tgrid, k=4, max_radius=R))
    assert all(n == 0 for n in wf.LAUNCHES.values())


def test_b3_b4_wrappers_refuse_a_grid_off_cpu_and_cuda(tgrid):
    meta = RegularGrid(
        torch.empty(tgrid.shape, device="meta"), torch.empty(tgrid.shape, device="meta"),
        tgrid.min_lon, tgrid.max_lon, tgrid.min_lat, tgrid.max_lat,
    )
    for fn in (wf.fill_idw_fused, wf.fill_mean_fused, wf.topk_idx):
        with pytest.raises(ValueError, match="CUDA grid"):
            fn(meta, max_radius=R)


@pytest.mark.parametrize("convention", CONVENTIONS)
def test_kriging_at_cells_select_matches_jax(jgrid, tgrid, convention):
    # 'select' is the B2 selection + the torch solve over the plane, taken
    # at the cells (the selection's plain version on a CPU grid)
    rng = np.random.RandomState(0)
    flat = rng.choice(H * W, 600, replace=False)
    rows, cols = flat // W, flat % W
    want = np.asarray(jd.kriging_at_cells(jgrid, rows, cols, convention=convention))
    got = td.kriging_at_cells(tgrid, rows, cols, convention=convention, backend="select")
    np.testing.assert_array_equal(np.isnan(_np(got)), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(_np(got)[ok], want[ok], rtol=1e-4, atol=0.05)
    plane = td.kriging_at_cells(tgrid, rows, cols, convention=convention, backend="torch")
    np.testing.assert_array_equal(_np(got), _np(plane))


def test_kriging_backend_defaults_to_auto(tgrid):
    # fault repaired: the default used to be the plain 'torch' path even on
    # a CUDA grid; 'auto' is 'fused' for a CUDA float32 grid only
    for fn in (td.fill_kriging, td.kriging_at_cells):
        assert inspect.signature(fn).parameters["backend"].default == "auto"
    cuda32 = types.SimpleNamespace(is_cuda=True, dtype=torch.float32)
    cuda64 = types.SimpleNamespace(is_cuda=True, dtype=torch.float64)
    assert td.resolve_backend("auto", cuda32) == "fused"
    assert td.resolve_backend("auto", cuda64) == "torch"
    assert td.resolve_backend("auto", tgrid.elev) == "torch"
    for name in ("torch", "select", "fused"):
        assert td.resolve_backend(name, cuda32) == name
    wf.reset_launches()
    np.testing.assert_array_equal(_np(td.fill_kriging(tgrid, max_radius=R)), _np(td.fill_kriging(tgrid, max_radius=R, backend="torch")))
    assert wf.LAUNCHES["fill_kriging_fused"] == 0


def test_b3_fills_take_a_backend(tgrid):
    # the IDW and mean fills choose between B3 and the plain scan in one
    # place: 'auto' on a CPU grid, and 'fused'/'select' through the
    # wrapper's plain version, all give the plain plane and launch nothing
    wf.reset_launches()
    for fn in (td.fill_idw, td.fill_window_mean):
        assert inspect.signature(fn).parameters["backend"].default == "auto"
        want = _np(fn(tgrid, max_radius=R, backend="torch"))
        for name in ("auto", "select", "fused"):
            np.testing.assert_array_equal(_np(fn(tgrid, max_radius=R, backend=name)), want)
        with pytest.raises(ValueError):
            fn(tgrid, max_radius=R, backend="xla")
    assert all(n == 0 for n in wf.LAUNCHES.values())


def test_constructors_default_to_the_card():
    # fault repaired: a grid built without naming a device used to land on
    # the CPU, where every wrapper quietly runs its plain version
    elev, _, _ = mask_grid(shelf_seamount(16, 12), 0.2, seed=1)
    ext = Extent(0.0, 11.0, 0.0, 15.0)
    constructors = (
        lambda: RegularGrid.from_nan_array(elev, ext),
        lambda: RegularGrid.dense(shelf_seamount(16, 12), ext),
        lambda: entry.tiny_masked_grid(16, 12),
    )
    for build in constructors:
        if torch.cuda.is_available():
            assert build().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                build()
    assert RegularGrid.from_nan_array(elev, ext, device="cpu").device.type == "cpu"
