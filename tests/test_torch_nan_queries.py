"""Scattered queries at NaN, inf and 1e30 coordinates: the plain version of
the select kernels (``select_ref``, which runs on the CPU) and its wrappers
against the JAX package's Pallas kernels in interpret mode.

A NaN coordinate makes every valid tap's d2 NaN.  The TPU kernels then take
no slot on any pass (no lane equals the NaN minimum: an all-zero one-hot),
so the counts are 0, the values and codes 0, B5's d2 rows 3e30, B7's d2 rows
the NaN minimum itself, IDW NaN (no weight) and kriging the empty mean, 0.
Infinite and 1e30 coordinates are out of bounds: NaN predictions through
the clipped centre cell.  Selections (counts, values, codes, offsets, the
resolved rows) are exactly equal, NaN where JAX has NaN; d2 rows and
predictions at tests/test_torch_valid_select.py's bars."""

import numpy as np
import pytest
import torch

from auvtpu.config import Extent as JExtent
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import packs as jp
from auvtpu.pallas import pallas_kriging_valid, pallas_packed_idw_t, pallas_packed_kriging_t, pallas_window_select
from auvtpu.pallas import valid_select_t as j_valid_select_t
from auvtpu.pallas.valid_select import _select_rows as j_select_rows
from auvtpu.synthetic import shelf_seamount
from jax.experimental.pallas import tpu as pltpu

from auvtpu_torch.convert import grid_from_arrays
from auvtpu_torch.kernels import scattered_select as ss
from auvtpu_torch.kernels import valid_select as vs
from auvtpu_torch.ops import packs as tp

torch.set_num_threads(1)

H, W = 48, 40
TILE = 256
RTOL, ATOL = 1e-5, 1e-4
NAN, INF = float("nan"), float("inf")
# (lon, lat) on the unit-step 40x48 extent: NaN lon, NaN lat, both, +-inf,
# 1e30 and -1e30 on either axis; then in-grid queries (cell centres,
# half-cell tie lines, random) so that the same launch also selects
ODD = [(NAN, 4.0), (4.0, NAN), (NAN, NAN), (INF, 4.0), (-INF, 4.0), (4.0, INF), (4.0, -INF),
       (1e30, 4.0), (-1e30, 4.0), (4.0, 1e30), (7.5, -1e30), (NAN, INF)]


def _grids(masked):
    elev = shelf_seamount(H, W)
    if masked:
        elev = mask_grid(elev, 0.2, seed=9)[0]
    jg = JGrid.from_nan_array(elev, JExtent(0.0, W - 1.0, 0.0, H - 1.0))
    g = grid_from_arrays(np.asarray(jg.elev), np.asarray(jg.valid), jg.min_lon, jg.max_lon, jg.min_lat, jg.max_lat, "cpu")
    return jg, g


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(5)
    lons = [q[0] for q in ODD] + [3.0, 4.5, 10.0, 0.0] + list(rng.uniform(-1.0, W, 40))
    lats = [q[1] for q in ODD] + [5.0, 6.5, 20.5, 0.0] + list(rng.uniform(-1.0, H, 40))
    return np.asarray(lons, np.float32), np.asarray(lats, np.float32)


def _interp():
    return pltpu.force_tpu_interpret_mode()


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))  # NaN equals NaN here


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


def test_select_ref_takes_no_slot_on_a_nan_query():
    # the fault: the lowest index equal to a NaN minimum was P, out of range
    _, g = _grids(True)
    offs = tp.window_offsets(2)
    pack = tp.build_pack(g, offs, clamp=False)[0]
    lons, lats = torch.tensor([NAN, 4.0], dtype=torch.float32), torch.tensor([4.0, NAN], dtype=torch.float32)
    _, _, _, _, _, cell, fx, fy = ss.prologue(g, lons, lats)
    for mode, layout, kw in (("rows_t", "dy", dict(emit_d2=True, resolve_thresh=4.0)), ("idw", "dy", {}),
                             ("rows_n", "dx", {})):
        out = ss.select_ref(pack, 32, cell, fx, fy, ss.table(offs, 32, 2, layout, "cpu"), mode=mode, k=8, **kw)
        if mode == "idw":
            assert torch.equal(out, torch.zeros_like(out))
        elif mode == "rows_t":
            assert torch.equal(out[0], torch.zeros(2)) and bool((out[1 + 8:1 + 16] == 3e30).all())
            assert torch.equal(out[1:1 + 8], torch.zeros(8, 2)) and torch.equal(out[1 + 16:], torch.zeros(9, 2))
        else:
            assert torch.equal(out[:, 0], torch.zeros(2)) and bool(torch.isnan(out[:, 9:17]).all())


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "valid"])
@pytest.mark.parametrize("radius", [2, 3])
def test_b5_rows_and_kriging(queries, masked, radius):
    jg, g = _grids(masked)
    lons, lats = queries
    n = len(lons)
    offs = tp.window_offsets(radius)
    P = tp.pack_width(len(offs))
    pack, jpack = tp.build_pack(g, offs, clamp=False)[0], jp.build_pack(jg, offs, clamp=False)[0]
    for emit_d2 in (True, False):
        got, *_ = vs._select_rows(pack, P, offs, radius, g, lons, lats, emit_d2=emit_d2, resolve_thresh=4.0)
        with _interp():
            want = np.asarray(j_select_rows(jpack, P, offs, radius, jg, lons, lats, TILE, emit_d2,
                                            resolve_thresh=4.0)[0])[:, :n]
        got = got.numpy()
        d2_rows = list(range(5, 9)) if emit_d2 else []
        exact = [r for r in range(got.shape[0]) if r not in d2_rows]
        _equal(got[exact], want[exact])
        if emit_d2:
            _close(got[d2_rows], want[d2_rows], rtol=1e-6, atol=0.0)
    res, mask, bad = vs.packed_kriging_t(pack, g, lons, lats, window_radius=radius, resolve_thresh=4.0)
    with _interp():
        jres, jmask, jbad = pallas_packed_kriging_t(jpack, jg, lons, lats, window_radius=radius, tile_n=TILE,
                                                    resolve_thresh=4.0)
    _equal(mask.numpy(), jmask)
    assert int(bad) == int(jbad)
    _close(res.numpy(), jres)
    assert float(res[0]) == 0.0 and float(res[1]) == 0.0  # a NaN query: the empty mean


@pytest.mark.parametrize("radius", [2, 3])
def test_b6_idw(queries, radius):
    jg, g = _grids(True)
    lons, lats = queries
    offs = tp.window_offsets(radius)
    pack, jpack = tp.build_pack(g, offs, clamp=False)[0], jp.build_pack(jg, offs, clamp=False)[0]
    for k in (1, 8, len(offs)):
        res, mask, bad = vs.packed_idw_t(pack, g, lons, lats, k=k, window_radius=radius, resolve_thresh=4.0)
        with _interp():
            jres, jmask, jbad = pallas_packed_idw_t(jpack, jg, lons, lats, k=k, window_radius=radius, tile_n=TILE,
                                                    resolve_thresh=4.0)
        _equal(mask.numpy(), jmask)
        assert int(bad) == int(jbad)
        _close(res.numpy(), jres)
        assert bool(torch.isnan(res[:len(ODD)]).all())
        assert bool(torch.isfinite(res[len(ODD):len(ODD) + 4]).all())


@pytest.mark.parametrize("radius", [2, 3])
def test_b7_window_select(queries, radius):
    jg, g = _grids(True)
    lons, lats = queries
    sp, jsp = tp.StencilPack(g, window_radius=radius), jp.StencilPack(jg, window_radius=radius)
    for k in (1, 8, len(tp.window_offsets(radius))):
        got = ss.window_select_fused(sp.window, g, lons, lats, k=k, window_radius=radius)
        with _interp():
            want = pallas_window_select(jsp.window, jg, lons, lats, k=k, window_radius=radius, tile_n=TILE)
        for key in ("found", "slot_ok", "val", "dx", "dy"):
            _equal(got[key].numpy(), want[key])
        # an empty slot's d2 is the pass's minimum as jnp.min gives it: NaN on a NaN query
        _close(got["d2"].numpy(), want["d2"], rtol=1e-6, atol=0.0)
        assert bool(torch.isnan(got["d2"][:3]).all())


def test_valid16(queries):
    jg, g = _grids(False)
    lons, lats = queries
    p16, jp16 = tp.build_valid16_pack(g), jp.build_valid16_pack(jg)
    got = vs.valid_select_t(p16, g, lons, lats)
    with _interp():
        want = j_valid_select_t(jp16, jg, lons, lats, tile_n=TILE)
        jk = pallas_kriging_valid(jp16, jg, lons, lats, tile_n=TILE)
    for key in ("found", "slot_ok", "val", "dx", "dy", "oob"):
        _equal(got[key].numpy(), want[key])
    _close(got["d2"].numpy(), want["d2"], rtol=1e-6, atol=0.0)
    _close(vs.kriging_valid_t(p16, g, lons, lats).numpy(), jk)
