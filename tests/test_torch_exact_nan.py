"""Exact mode's scattered entries at non-finite and out-of-grid queries
(ROADMAP C5): the port's ``exact_{kriging,cubic,bilinear}_scattered``
against the JAX package's under x64, on the CPU.

The JAX package casts its scattered anchors through int32
(``auvtpu/ops/exact.py:475``), so numpy's floor anchor of a NaN (-2**63)
becomes 0 there and exact cubic's ring fallback walks from cell 0.  The
grids are 40x56 ``shelf_seamount`` planes on an awkward Kerguelen-style
extent, masked 30 % and 90 %, in f32 and f64; the bar is 1e-9 m, with the
NaN pattern equal."""

import numpy as np
import pytest
import torch

import jax

from auvtpu.config import Extent
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import exact as jexact
from auvtpu.synthetic import shelf_seamount

from auvtpu_torch.convert import grid_from_arrays
from auvtpu_torch.ops import exact as texact

torch.set_num_threads(1)

AWKWARD = Extent(74.615, 84.785, -58.2508, -49.6982)
PRED_TOL = 1e-9  # m
METHODS = ["kriging", "cubic", "bilinear"]


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


_PAIRS = {}


def _pair(removal, dtype):
    key = (removal, dtype)
    if key not in _PAIRS:
        reduced, _, _ = mask_grid(shelf_seamount(40, 56), removal, seed=7)
        jg = JGrid.from_nan_array(reduced, AWKWARD, dtype=dtype)
        tg = grid_from_arrays(np.asarray(jg.elev), np.asarray(jg.valid), AWKWARD.min_lon, AWKWARD.max_lon,
                              AWKWARD.min_lat, AWKWARD.max_lat, "cpu")
        _PAIRS[key] = (jg, tg)
    return _PAIRS[key]


def odd_queries(ext=AWKWARD, seed=3):
    """(lons, lats, kinds): NaN in either coordinate or both, ±inf in
    either, points past each edge, and ordinary points between them."""
    rng = np.random.default_rng(seed)
    w, h = ext.max_lon - ext.min_lon, ext.max_lat - ext.min_lat
    lon = lambda: ext.min_lon + rng.uniform(0.1, 0.9) * w
    lat = lambda: ext.min_lat + rng.uniform(0.1, 0.9) * h
    nan, inf = np.nan, np.inf
    rows = [
        ("nan_lon", nan, lat()), ("nan_lon", nan, lat()), ("nan_lat", lon(), nan), ("nan_lat", lon(), nan),
        ("nan_both", nan, nan), ("inf_lon", inf, lat()), ("inf_lon", -inf, lat()), ("inf_lat", lon(), inf),
        ("inf_lat", lon(), -inf), ("inf_both", inf, -inf), ("nan_inf", nan, inf), ("nan_inf", -inf, nan),
        ("out", ext.min_lon - 0.3 * w, lat()), ("out", ext.max_lon + 0.01, lat()),
        ("out", lon(), ext.min_lat - 1e-6), ("out", lon(), ext.max_lat + 5.0),
        ("edge", ext.min_lon, ext.min_lat), ("edge", ext.max_lon, ext.max_lat),
    ]
    rows += [("plain", lon(), lat()) for _ in range(12)]
    kinds, lons, lats = zip(*rows)
    return np.array(lons), np.array(lats), np.array(kinds)


def _close(got, want, tol=PRED_TOL):
    want = np.asarray(want, np.float64)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("removal", [0.3, 0.9])
@pytest.mark.parametrize("method", METHODS)
def test_scattered_entries_at_odd_queries_equal_jax(method, removal, dtype):
    jg, tg = _pair(removal, dtype)
    lons, lats, kinds = odd_queries()
    got = getattr(texact, f"exact_{method}_scattered")(tg, lons, lats)
    want = np.asarray(getattr(jexact, f"exact_{method}_scattered")(jg, lons, lats), np.float64)
    _close(got, want)
    # every infinite or out-of-grid query is NaN in both; kriging answers
    # every ordinary one
    assert np.isnan(got[np.isin(kinds, ["inf_lon", "inf_lat", "inf_both", "nan_inf", "out"])]).all()
    if method == "kriging":
        assert np.isfinite(got[kinds == "plain"]).all()
    if method == "cubic":
        # the ring fallback at a NaN query walks from cell 0, as JAX's does
        assert np.isfinite(got[np.isin(kinds, ["nan_lon", "nan_lat", "nan_both"])]).all()


@pytest.mark.parametrize("anchor", ["round", "floor"])
def test_scattered_anchors_are_the_jax_int32_anchors(anchor):
    jg, tg = _pair(0.3, np.float64)
    lons, lats, _ = odd_queries()
    with np.errstate(invalid="ignore"):
        got = texact._prepare_scattered(tg, lons, lats, anchor)
        want = jexact._prepare_scattered(jg, lons, lats, anchor)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
