"""The port's stencil packs and packed scattered ops against the JAX
package's, on the CPU: every pack bit-equal to ``build_pack``'s, fetches
equal, the packed selection exactly equal (found, slot_ok, val, dx, dy; d2
at rtol 1e-6), the packed ops at tests/test_packs.py's bars, and the 2x
upsampling at rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auvtpu.config import Extent as JExtent
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import dense as jdense
from auvtpu.ops import packs as jp
from auvtpu.synthetic import shelf_seamount

from auvtpu_torch.convert import grid_from_arrays
from auvtpu_torch.ops import packs as tp
from auvtpu_torch.ops import upsample2x_bicubic, upsample2x_bilinear

torch.set_num_threads(1)

H, W = 96, 80


def _grids(masked):
    elev = shelf_seamount(H, W)
    if masked:
        elev = mask_grid(elev, 0.2, seed=9)[0]
    jg = JGrid.from_nan_array(elev, JExtent(0.0, W - 1.0, 0.0, H - 1.0))
    g = grid_from_arrays(np.asarray(jg.elev), np.asarray(jg.valid), jg.min_lon, jg.max_lon, jg.min_lat, jg.max_lat, "cpu")
    return jg, g


@pytest.fixture(scope="module", params=[True, False], ids=["masked", "valid"])
def grids(request):
    return _grids(request.param)


@pytest.fixture(scope="module")
def valid_grids():
    return _grids(False)


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(11)
    lons = rng.uniform(-1.0, W, 700).astype(np.float32)
    lats = rng.uniform(-1.0, H, 700).astype(np.float32)
    extra_lo = np.array([3.0, 4.5, 10.0, 77.5, 0.0, 0.5, W - 1.0, 1e-6, 5.4999], np.float32)
    extra_la = np.array([5.0, 6.5, 90.5, 2.0, 0.0, 1.5, H - 1.0, H - 1.3, 3.4999], np.float32)
    return np.concatenate([lons, extra_lo]), np.concatenate([lats, extra_la])


def _close(got, want, rtol, atol):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


@pytest.mark.parametrize("which", ["bilinear", "bicubic", "window2", "window3", "valid16"])
def test_packs_bit_equal(grids, which):
    jg, g = grids
    offs, clamp = {
        "bilinear": (tp.BILINEAR_OFFSETS, True),
        "bicubic": (tp.BICUBIC_OFFSETS, True),
        "window2": (tp.window_offsets(2), False),
        "window3": (tp.window_offsets(3), False),
        "valid16": (tp.VALID16_OFFSETS, False),
    }[which]
    j_offs = {"window2": jp.window_offsets(2), "window3": jp.window_offsets(3), "valid16": jp.VALID16_OFFSETS}.get(which, offs)
    assert offs == j_offs
    got, P = tp.build_pack(g, offs, clamp=clamp)
    want, jP = jp.build_pack(jg, j_offs, clamp=clamp)
    assert P == jP
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if which == "valid16":
        np.testing.assert_array_equal(tp.build_valid16_pack(g).numpy(), np.asarray(jp.build_valid16_pack(jg)))


def test_stencil_pack_and_fetch(grids):
    jg, g = grids
    sp, jsp = tp.StencilPack(g, window_radius=3), jp.StencilPack(jg, window_radius=3)
    for name in ("bilinear", "bicubic", "window"):
        np.testing.assert_array_equal(getattr(sp, name).numpy(), np.asarray(getattr(jsp, name)))
        assert getattr(sp, f"p_{name}") == getattr(jsp, f"p_{name}")
    idx = np.array([0, 5, W + 3, H * W - 1, 1234], np.int32)
    for nan_invalid in (True, False):
        got = tp.fetch_pack(sp.window, 64, torch.from_numpy(idx), nan_invalid=nan_invalid)
        want = jp.fetch_pack(jsp.window, 64, jnp.asarray(idx), nan_invalid=nan_invalid)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("radius,k,convention", [(2, 4, "reference"), (2, 8, "centered"), (3, 4, "reference")])
def test_packed_window_select_matches_jax(grids, queries, radius, k, convention):
    jg, g = grids
    lons, lats = queries
    got = tp.packed_window_select(tp.StencilPack(g, window_radius=radius).window, g, lons, lats,
                                  k=k, window_radius=radius, convention=convention)
    want = jp.packed_window_select(jp.StencilPack(jg, window_radius=radius).window, jg, lons, lats,
                                   k=k, window_radius=radius, convention=convention)
    for key in ("found", "slot_ok", "ci", "cj", "oob", "x", "y"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    ok = np.asarray(want["slot_ok"])
    for key in ("val", "dx", "dy"):
        np.testing.assert_array_equal(got[key].numpy()[ok], np.asarray(want[key])[ok])
    np.testing.assert_allclose(got["d2"].numpy()[ok], np.asarray(want["d2"])[ok], rtol=1e-6)


def test_packed_ops_match_jax(grids, queries):
    jg, g = grids
    lons, lats = queries
    sp, jsp = tp.StencilPack(g), jp.StencilPack(jg)
    _close(tp.packed_bilinear(sp.bilinear, g, lons, lats), jp.packed_bilinear(jsp.bilinear, jg, lons, lats), 1e-5, 1e-3)
    _close(tp.packed_bicubic(sp.bicubic, g, lons, lats), jp.packed_bicubic(jsp.bicubic, jg, lons, lats), 1e-5, 1e-3)
    vp = (0.5, 80.0, 12.0)
    for conv in ("reference", "centered"):
        _close(tp.packed_kriging(sp.window, g, lons, lats, convention=conv, vparams=vp),
               jp.packed_kriging(jsp.window, jg, lons, lats, convention=conv, vparams=vp), 1e-4, 0.1)
        _close(tp.packed_idw(sp.window, g, lons, lats, k=8, convention=conv),
               jp.packed_idw(jsp.window, jg, lons, lats, k=8, convention=conv), 1e-5, 1e-2)
    _close(tp.packed_idw(sp.window, g, lons, lats, k=5, power=1.0),
           jp.packed_idw(jsp.window, jg, lons, lats, k=5, power=1.0), 1e-5, 1e-2)
    pred, var = tp.packed_kriging(sp.window, g, lons, lats, model="spherical", vparams=vp, with_variance=True)
    jpred, jvar = jp.packed_kriging(jsp.window, jg, lons, lats, model="spherical", vparams=vp, with_variance=True)
    _close(pred, jpred, 1e-4, 0.1)
    _close(var, jvar, 1e-3, 0.05)


def test_assume_valid_and_valid16(valid_grids, queries):
    jg, g = valid_grids
    lons, lats = queries
    sp, jsp = tp.StencilPack(g), jp.StencilPack(jg)
    for name, fn, jfn in (("bilinear", tp.packed_bilinear, jp.packed_bilinear),
                          ("bicubic", tp.packed_bicubic, jp.packed_bicubic)):
        fast = fn(getattr(sp, name), g, lons, lats, assume_valid=True)
        np.testing.assert_array_equal(fast.numpy(), fn(getattr(sp, name), g, lons, lats).numpy())
        _close(fast, jfn(getattr(jsp, name), jg, lons, lats, assume_valid=True), 1e-5, 1e-3)
    p16 = tp.build_valid16_pack(g)
    got = tp.packed_kriging_valid(p16, g, lons, lats)
    _close(got, jp.packed_kriging_valid(jp.build_valid16_pack(jg), jg, lons, lats), 1e-4, 0.1)
    # the containment proof: valid16 selects what the radius-2 window selects
    _close(got, tp.packed_kriging(sp.window, g, lons, lats), 1e-6, 1e-4)
    with pytest.raises(ValueError):
        tp.packed_kriging_valid(p16, g, lons, lats, convention="centered")


def test_upsample2x_matches_jax(valid_grids):
    jg, g = valid_grids
    for fn, jfn in ((upsample2x_bilinear, jdense.upsample2x_bilinear), (upsample2x_bicubic, jdense.upsample2x_bicubic)):
        got = fn(g)
        assert got.shape == (2 * H - 1, 2 * W - 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(jfn(jg)), rtol=1e-6)
    np.testing.assert_array_equal(upsample2x_bilinear(g)[::2, ::2].numpy(), g.elev.numpy())
