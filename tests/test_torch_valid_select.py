"""The CPU wrappers of the scattered select kernel (its plain version)
against the JAX package's Pallas kernels in interpret mode: B5
(``valid_select_t``, ``pallas_kriging_valid``, ``pallas_packed_kriging_t``),
B6 (``pallas_packed_idw_t``) and B7 (``pallas_window_select``), on masked
and fully valid grids, window radius 2 and 3, both conventions, fitted
variogram parameters and the two-tier resolved row.

Selection decisions (counts, values, codes, offsets, the resolved mask)
are exactly equal.  d2 and the IDW sums agree at rtol 1e-6: XLA:CPU may
contract d2's multiply-add, which the port (and its CUDA kernel, built with
-fmad=false) never does.  Predictions hold at tests/test_pallas.py's bars
(rtol 1e-5, atol 1e-4)."""

import numpy as np
import pytest
import torch

from auvtpu.config import Extent as JExtent
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import packs as jp
from auvtpu.pallas import pallas_kriging_valid, pallas_packed_idw_t, pallas_packed_kriging_t, pallas_window_select, valid_select_t as j_valid_select_t
from auvtpu.pallas.valid_select import _select_rows as j_select_rows
from auvtpu.synthetic import shelf_seamount
from jax.experimental.pallas import tpu as pltpu

from auvtpu_torch.convert import grid_from_arrays
from auvtpu_torch.kernels import scattered_select as ss
from auvtpu_torch.kernels import valid_select as vs
from auvtpu_torch.ops import packs as tp

torch.set_num_threads(1)

H, W = 96, 80
TILE = 256
RTOL, ATOL = 1e-5, 1e-4


def _grids(masked):
    elev = shelf_seamount(H, W)
    if masked:
        elev = mask_grid(elev, 0.2, seed=9)[0]
    jg = JGrid.from_nan_array(elev, JExtent(0.0, W - 1.0, 0.0, H - 1.0))
    g = grid_from_arrays(np.asarray(jg.elev), np.asarray(jg.valid), jg.min_lon, jg.max_lon, jg.min_lat, jg.max_lat, "cpu")
    return jg, g


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(11)
    lons = rng.uniform(-1.0, W, 700).astype(np.float32)
    lats = rng.uniform(-1.0, H, 700).astype(np.float32)
    extra_lo = np.array([3.0, 4.5, 10.0, 77.5, 0.0, 0.5, W - 1.0], np.float32)
    extra_la = np.array([5.0, 6.5, 90.5, 2.0, 0.0, 1.5, H - 1.0], np.float32)
    return np.concatenate([lons, extra_lo]), np.concatenate([lats, extra_la])


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


def _interp():
    return pltpu.force_tpu_interpret_mode()


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "valid"])
@pytest.mark.parametrize("radius,convention", [(2, "reference"), (2, "centered"), (3, "reference")])
def test_b5_b6_rows_and_predictions(queries, masked, radius, convention):
    jg, g = _grids(masked)
    lons, lats = queries
    n = len(lons)
    offs = tp.window_offsets(radius)
    P = tp.pack_width(len(offs))
    pack = tp.build_pack(g, offs, clamp=False)[0]
    jpack = jp.build_pack(jg, offs, clamp=False)[0]
    half = 0.5 if convention == "reference" else 0.0
    thresh = 4.0 if convention == "reference" else 6.25
    # B5's raw rows [cnt, 4 vals, 4 d2, 4 codes, resolved]
    got, *_ = vs._select_rows(pack, P, offs, radius, g, lons, lats, emit_d2=True, half=half, resolve_thresh=thresh)
    with _interp():
        want = np.asarray(j_select_rows(jpack, P, offs, radius, jg, lons, lats, TILE, True, half=half, resolve_thresh=thresh)[0])[:, :n]
    got = got.numpy()
    exact = [0, 1, 2, 3, 4, 9, 10, 11, 12, 13]
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_allclose(got[5:9], want[5:9], rtol=1e-6)
    # B5 kriging and B6 IDW with the resolved row, fitted parameters
    vp = (0.5, 80.0, 12.0)
    kw = dict(window_radius=radius, convention=convention, resolve_thresh=thresh)
    k_res, k_mask, k_bad = vs.packed_kriging_t(pack, g, lons, lats, vparams=vp, model="spherical", **kw)
    i_res, i_mask, i_bad = vs.packed_idw_t(pack, g, lons, lats, k=8, **kw)
    with _interp():
        jk = pallas_packed_kriging_t(jpack, jg, lons, lats, vparams=vp, model="spherical", tile_n=TILE, **kw)
        ji = pallas_packed_idw_t(jpack, jg, lons, lats, k=8, tile_n=TILE, **kw)
    np.testing.assert_array_equal(k_mask.numpy(), np.asarray(jk[1]))
    np.testing.assert_array_equal(i_mask.numpy(), np.asarray(ji[1]))
    assert int(k_bad) == int(jk[2]) and int(i_bad) == int(ji[2])
    _close(k_res, jk[0])
    _close(i_res, ji[0])
    # the resolved row changes nothing else
    plain = vs.packed_kriging_t(pack, g, lons, lats, vparams=vp, model="spherical", window_radius=radius, convention=convention)
    assert torch.equal(torch.nan_to_num(plain, nan=-1.0), torch.nan_to_num(k_res, nan=-1.0))


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "valid"])
def test_b6_sums_match_pallas(queries, masked):
    jg, g = _grids(masked)
    lons, lats = queries
    offs = tp.window_offsets(2)
    pack = tp.build_pack(g, offs, clamp=False)[0]
    _, _, _, _, _, cell, fx, fy = ss.prologue(g, lons, lats)
    for k in (1, 8, 32):
        got = ss.select(pack, 32, cell, fx, fy, ss.table(offs, 32, 2, "dy", "cpu"), mode="idw", k=k)
        with _interp():
            want = pallas_packed_idw_t(jp.build_pack(jg, offs, clamp=False)[0], jg, lons, lats, k=k, tile_n=TILE)
        num, den = got
        res = torch.where(den > 0, num / torch.clamp(den, min=1e-12), float("nan"))
        res = torch.where(ss.prologue(g, lons, lats)[2], float("nan"), res)
        _close(res, want)


def test_b5_valid16(queries):
    jg, g = _grids(False)
    lons, lats = queries
    p16, jp16 = tp.build_valid16_pack(g), jp.build_valid16_pack(jg)
    got = vs.valid_select_t(p16, g, lons, lats)
    vp = tuple(torch.tensor(v) for v in (0.8, 120.0, 9.0))  # fitted parameters arrive as 0-d tensors
    with _interp():
        want = j_valid_select_t(jp16, jg, lons, lats, tile_n=TILE)
        jk = pallas_kriging_valid(jp16, jg, lons, lats, tile_n=TILE)
        jk_fit = pallas_kriging_valid(jp16, jg, lons, lats, tile_n=TILE, vparams=(0.8, 120.0, 9.0))
    for key in ("found", "slot_ok", "val", "dx", "dy", "ci", "cj", "oob"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_allclose(got["d2"].numpy(), np.asarray(want["d2"]), rtol=1e-6)
    _close(vs.kriging_valid_t(p16, g, lons, lats), jk)
    _close(vs.kriging_valid_t(p16, g, lons, lats, vparams=vp), jk_fit)
    # the same selection as the torch valid16 path
    _close(vs.kriging_valid_t(p16, g, lons, lats), tp.packed_kriging_valid(p16, g, lons, lats), 1e-6, 1e-4)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "valid"])
@pytest.mark.parametrize("radius,k,convention", [(2, 4, "reference"), (2, 8, "centered"), (3, 4, "reference")])
def test_b7_window_select(queries, masked, radius, k, convention):
    jg, g = _grids(masked)
    lons, lats = queries
    sp, jsp = tp.StencilPack(g, window_radius=radius), jp.StencilPack(jg, window_radius=radius)
    got = ss.window_select_fused(sp.window, g, lons, lats, k=k, window_radius=radius, convention=convention)
    with _interp():
        want = pallas_window_select(jsp.window, jg, lons, lats, k=k, window_radius=radius, convention=convention, tile_n=TILE)
    for key in ("found", "slot_ok", "val", "dx", "dy"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_allclose(got["d2"].numpy(), np.asarray(want["d2"]), rtol=1e-6)
    # the same selection as the torch packed path at every live slot
    tsel = tp.packed_window_select(sp.window, g, lons, lats, k=k, window_radius=radius, convention=convention)
    ok = tsel["slot_ok"]
    assert torch.equal(got["found"], tsel["found"])
    for key in ("val", "dx", "dy"):
        assert torch.equal(got[key][ok], tsel[key][ok])
    if radius == 2:
        _close(ss.packed_kriging_fused(sp.window, g, lons, lats, convention=convention),
               tp.packed_kriging(sp.window, g, lons, lats, convention=convention))
        _close(ss.packed_idw_fused(sp.window, g, lons, lats, k=k, convention=convention),
               tp.packed_idw(sp.window, g, lons, lats, k=k, convention=convention))


def test_float64_grids_are_refused(queries):
    jg, g = _grids(True)
    g64 = grid_from_arrays(g.elev.double().numpy(), g.valid.double().numpy(), 0.0, W - 1.0, 0.0, H - 1.0, "cpu")
    pack = tp.StencilPack(g64).window
    for fn in (vs.packed_kriging_t, vs.packed_idw_t):
        with pytest.raises(TypeError):
            fn(pack, g64, *queries)
    with pytest.raises(TypeError):
        ss.window_select_fused(pack, g64, *queries, k=4)
