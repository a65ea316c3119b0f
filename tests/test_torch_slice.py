"""The port's slice end to end against the JAX package: the fit-then-fill
entry point against ``__graft_entry__.entry()`` and the R=10 kriging fill
against ``auvtpu.ops.fill_kriging``, with the state carried over by
``auvtpu_torch.convert``.  Planes within rtol=1e-4, atol=0.05 with equal
NaN placement; raw fitted parameters are not compared (see
test_torch_variogram.py)."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
import auvtpu.config as jcfg
from auvtpu import variogram as jv
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import fill_kriging as j_fill_kriging
from auvtpu.ops import kriging_at_cells as j_kriging_at_cells
from auvtpu.synthetic import kerguelen_standin

from auvtpu_torch import entry
from auvtpu_torch.convert import grid_from_arrays, vparams_from_arrays
from auvtpu_torch.kernels import window_fill as wf
from auvtpu_torch.ops import fill_kriging, kriging_at_cells

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 0.05


def _assert_plane_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def graft():
    """(JAX grid, JAX forward's filled plane) of __graft_entry__.entry()."""
    fn, (elev, valid) = __graft_entry__.entry()
    jg = __graft_entry__._tiny_masked_grid()
    return jg, np.asarray(jax.jit(fn)(elev, valid))


def _port_grid(jg):
    return grid_from_arrays(
        np.asarray(jg.elev), np.asarray(jg.valid),
        jg.min_lon, jg.max_lon, jg.min_lat, jg.max_lat, "cpu",
    )


def test_tiny_masked_grid_is_the_graft_grid(graft):
    jg, _ = graft
    tg = entry.tiny_masked_grid(device="cpu")
    np.testing.assert_array_equal(tg.elev.numpy(), np.asarray(jg.elev))
    np.testing.assert_array_equal(tg.valid.numpy(), np.asarray(jg.valid))
    assert (tg.min_lon, tg.max_lon, tg.min_lat, tg.max_lat) == (jg.min_lon, jg.max_lon, jg.min_lat, jg.max_lat)


def test_fit_fill_matches_graft_entry(graft):
    jg, want = graft
    wf.reset_launches()
    got, vparams = entry.fit_fill(_port_grid(jg))
    assert wf.LAUNCHES["fill_kriging_fused"] == 0  # CPU grid: plain path
    assert all(torch.isfinite(p) and float(p) > 0 for p in vparams)
    _assert_plane_close(got.numpy(), want)
    gaps = np.asarray(jg.valid) < 0.5
    assert np.isfinite(got.numpy()[gaps]).mean() > 0.99
    # observed cells are kept as they are
    np.testing.assert_array_equal(got.numpy()[~gaps], np.asarray(jg.elev)[~gaps])


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_fill_with_jax_fitted_parameters(graft, backend):
    jg, want = graft
    tg = _port_grid(jg)
    vp = vparams_from_arrays(*jv.fit_variogram(jg), device="cpu")
    plane = fill_kriging(tg, vparams=vp, backend=backend)
    got = torch.where(tg.valid > 0.5, tg.elev, plane)
    _assert_plane_close(got.numpy(), want)


@pytest.fixture(scope="module")
def kerguelen_block():
    elev, rc, _ = mask_grid(kerguelen_standin((128, 160)), 0.1)
    jg = JGrid.from_nan_array(elev, jcfg.KERGUELEN_EXTENT)
    return jg, _port_grid(jg), rc


def test_fill_kriging_r10_matches_jax(kerguelen_block):
    jg, tg, _ = kerguelen_block
    want = np.asarray(j_fill_kriging(jg, max_radius=10))
    _assert_plane_close(fill_kriging(tg, max_radius=10, backend="fused").numpy(), want)


def test_kriging_at_cells_matches_jax(kerguelen_block):
    jg, tg, rc = kerguelen_block
    rows, cols = rc[:500, 0], rc[:500, 1]
    want = np.asarray(j_kriging_at_cells(jg, rows, cols))
    got = kriging_at_cells(tg, rows, cols, backend="fused").numpy()
    _assert_plane_close(got, want)


def test_convert_carries_state(kerguelen_block):
    jg, tg, _ = kerguelen_block
    assert tg.elev.dtype == torch.float32 and tg.valid.dtype == torch.float32
    assert (tg.lon_step, tg.lat_step) == (jg.lon_step, jg.lat_step)
    vp = vparams_from_arrays(np.float32(1.5), 2.0e6, np.asarray(55.5, np.float32), device="cpu")
    assert [float(p) for p in vp] == [1.5, 2.0e6, 55.5]
    assert all(p.dtype == torch.float32 and p.ndim == 0 for p in vp)
    with pytest.raises(ValueError):
        grid_from_arrays(np.zeros((3, 4)), np.zeros((4, 3)), 0, 1, 0, 1, "cpu")
