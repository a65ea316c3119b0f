"""The port's scattered-query ops against the JAX package's, on the CPU:
the f32 normalisation bit for bit (against the jitted ``_normalize``, as
every JAX op that reads it compiles it), the radius-10 window selection exactly
(found, slot_ok, ii, jj; val and d2 at rtol 1e-6), and the scattered
bilinear, bicubic, kriging and IDW at the bars of tests/test_packs.py
(kriging rtol 1e-4 / atol 0.1, IDW 1e-5 / 1e-2, bilinear and bicubic
1e-5 / 1e-3), with equal NaN placement."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auvtpu.config import Extent as JExtent
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import batch as jbatch
from auvtpu.ops import scattered as js
from auvtpu.ops.window import window_select as j_window_select
from auvtpu.synthetic import shelf_seamount

from auvtpu_torch.convert import grid_from_arrays
from auvtpu_torch.ops import apply_chunked, scattered_bicubic, scattered_bilinear, scattered_idw, scattered_kriging
from auvtpu_torch.ops.scattered import _normalize, centre_cells
from auvtpu_torch.ops.window import window_select

torch.set_num_threads(1)

H, W = 96, 80
BARS = {"bilinear": (1e-5, 1e-3), "bicubic": (1e-5, 1e-3), "kriging": (1e-4, 0.1), "idw": (1e-5, 1e-2)}


def _jgrid(masked):
    elev = shelf_seamount(H, W)
    if masked:
        elev = mask_grid(elev, 0.2, seed=9)[0]
    return JGrid.from_nan_array(elev, JExtent(0.0, W - 1.0, 0.0, H - 1.0))


def _tgrid(jg):
    return grid_from_arrays(np.asarray(jg.elev), np.asarray(jg.valid), jg.min_lon, jg.max_lon, jg.min_lat, jg.max_lat, "cpu")


@pytest.fixture(scope="module", params=[True, False], ids=["masked", "valid"])
def grids(request):
    jg = _jgrid(request.param)
    return jg, _tgrid(jg)


@pytest.fixture(scope="module")
def queries():
    """tests/test_pallas.py's scattered queries (some out of bounds) and its
    adversarial tie queries: exact cell centres, half-integer tie lines,
    corners and edges."""
    rng = np.random.default_rng(11)
    lons = rng.uniform(-1.0, W, 700).astype(np.float32)
    lats = rng.uniform(-1.0, H, 700).astype(np.float32)
    extra_lo = np.array([3.0, 4.5, 10.0, 77.5, 0.0, 0.5, W - 1.0], np.float32)
    extra_la = np.array([5.0, 6.5, 90.5, 2.0, 0.0, 1.5, H - 1.0], np.float32)
    return np.concatenate([lons, extra_lo]), np.concatenate([lats, extra_la])


def _close(got, want, rtol, atol):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


def test_normalize_bit_equal(grids, queries):
    jg, g = grids
    lons, lats = queries
    kerg = JExtent(74.615, 84.785, -58.2508, -49.6982)  # steps that do not round to f32
    jk = JGrid.from_nan_array(np.zeros((2053, 2441)), kerg)
    k = grid_from_arrays(np.asarray(jk.elev), np.asarray(jk.valid), kerg.min_lon, kerg.max_lon, kerg.min_lat, kerg.max_lat, "cpu")
    klons = np.linspace(kerg.min_lon - 1e-3, kerg.max_lon + 1e-3, 997).astype(np.float32)
    klats = np.linspace(kerg.max_lat + 1e-3, kerg.min_lat - 1e-3, 997).astype(np.float32)
    for jgrid, grid, lo, la in ((jg, g, lons, lats), (jk, k, klons, klats)):
        for a, b in zip(_normalize(grid, lo, la), jax.jit(js._normalize)(jgrid, lo, la)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("k,radius,convention", [(4, 10, "reference"), (8, 3, "centered"), (4, 1, "reference")])
def test_window_select_matches_jax(grids, queries, k, radius, convention):
    jg, g = grids
    lons, lats = queries
    x, y, _ = _normalize(g, lons, lats)
    ci, cj = centre_cells(g, x, y)
    got = window_select(g, x, y, ci, cj, k=k, max_radius=radius, convention=convention)
    want = j_window_select(
        jg, jnp.asarray(x.numpy()), jnp.asarray(y.numpy()), jnp.asarray(ci.numpy()), jnp.asarray(cj.numpy()),
        k=k, max_radius=radius, convention=convention,
    )
    for key in ("found", "slot_ok", "ii", "jj"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    ok = np.asarray(want["slot_ok"])
    for key in ("val", "d2"):
        np.testing.assert_allclose(got[key].numpy()[ok], np.asarray(want[key])[ok], rtol=1e-6)
    assert np.isinf(got["d2"].numpy()[~ok]).all()


@pytest.mark.parametrize("convention", ["reference", "centered"])
def test_scattered_ops_match_jax(grids, queries, convention):
    jg, g = grids
    lons, lats = queries
    _close(scattered_bilinear(g, lons, lats), js.scattered_bilinear(jg, lons, lats), *BARS["bilinear"])
    for fb in ("auto", "never"):
        _close(
            scattered_bicubic(g, lons, lats, fallback=fb, max_radius=5, convention=convention),
            js.scattered_bicubic(jg, lons, lats, fallback=fb, max_radius=5, convention=convention),
            *BARS["bicubic"],
        )
    _close(
        scattered_kriging(g, lons, lats, convention=convention),
        js.scattered_kriging(jg, lons, lats, convention=convention),
        *BARS["kriging"],
    )
    for k, power in ((8, 2.0), (4, 1.0)):
        _close(
            scattered_idw(g, lons, lats, k=k, power=power, max_radius=6, convention=convention),
            js.scattered_idw(jg, lons, lats, k=k, power=power, max_radius=6, convention=convention),
            *BARS["idw"],
        )


def test_scattered_kriging_variance_matches_jax(grids, queries):
    jg, g = grids
    lons, lats = queries
    pred, var = scattered_kriging(g, lons, lats, max_radius=6, with_variance=True)
    jpred, jvar = js.scattered_kriging(jg, lons, lats, max_radius=6, with_variance=True)
    _close(pred, jpred, *BARS["kriging"])
    _close(var, jvar, 1e-3, 0.05)  # tests/test_packs.py:396
    assert (var.numpy()[~np.isnan(var.numpy())] >= 0).all()


def test_apply_chunked_across_chunk_edges(grids, queries):
    jg, g = grids
    lons, lats = queries  # 707 queries: chunks of 256, 256 and 195
    whole = scattered_idw(g, lons, lats, max_radius=4)
    got = apply_chunked(scattered_idw, g, lons, lats, chunk=256, max_radius=4)
    assert got.shape == whole.shape
    np.testing.assert_array_equal(got.numpy(), whole.numpy())
    want = jbatch.apply_chunked(js.scattered_idw, jg, lons, lats, chunk=256, max_radius=4)
    _close(got, want, *BARS["idw"])
