"""B11's plain version (``select_krige_ref``: B5's plain rows and the torch
row epilogue, which ``kriging_valid_t`` and ``packed_kriging_t`` run on a
CPU pack) against the JAX package's ``pallas_kriging_valid`` and
``pallas_packed_kriging_t`` in interpret mode.

Fully valid, masked and sparse grids (where many queries find fewer than
four neighbours), window radius 2 and 3 and the valid16 pack, both
conventions, the four variogram models with their parameters as floats and
as 0-d tensors, the two-tier resolved row, and NaN, +-inf, +-1e30 and
out-of-grid queries, on unit-step grids and (their nodes and half-nodes
too) on the Kerguelen extent.  Predictions at tests/test_pallas.py's bars
(rtol 1e-5, atol 1e-4); the resolved mask and the unresolved count exactly
equal.

The kernel takes each slot's (dx, dy) from its tap table where the plain
version decodes the slot's code: the tap tables pin that the two agree,
with the decode's division exact and as the card computes it (a multiply
by the rounded reciprocal of the code base)."""

import numpy as np
import pytest
import torch

from auvtpu.config import KERGUELEN_EXTENT
from auvtpu.config import Extent as JExtent
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import packs as jp
from auvtpu.pallas import pallas_kriging_valid, pallas_packed_kriging_t
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
# unit-step variogram parameters per model, and a spherical range below the
# 1e-6 clamp of variogram_model
MODELS = [
    ("exponential", (1.0, 100.0, 10.0)),
    ("linear", (1.0, 5.0, 10.0)),
    ("spherical", (0.5, 80.0, 12.0)),
    ("gaussian", (2.0, 150.0, 6.0)),
    ("spherical", (0.5, 80.0, 1e-8)),
]
ODD = [(NAN, 4.0), (4.0, NAN), (NAN, NAN), (INF, 4.0), (-INF, 4.0), (4.0, INF), (4.0, -INF),
       (1e30, 4.0), (-1e30, 4.0), (4.0, 1e30), (-3.0, 7.0), (W + 2.0, 9.0)]


def _grids(kind):
    elev = shelf_seamount(H, W)
    if kind != "valid":
        elev = mask_grid(elev, 0.2 if kind == "masked" else 0.9, seed=9)[0]
    jg = JGrid.from_nan_array(elev, JExtent(0.0, W - 1.0, 0.0, H - 1.0))
    g = grid_from_arrays(np.asarray(jg.elev), np.asarray(jg.valid), jg.min_lon, jg.max_lon, jg.min_lat, jg.max_lat, "cpu")
    return jg, g


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(21)
    lons = [q[0] for q in ODD] + [3.0, 4.5, 10.0, 0.0, W - 1.0] + list(rng.uniform(-1.0, W, 300))
    lats = [q[1] for q in ODD] + [5.0, 6.5, 20.5, 0.0, H - 1.0] + list(rng.uniform(-1.0, H, 300))
    return np.asarray(lons, np.float32), np.asarray(lats, np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=RTOL, atol=ATOL)


def _vparams(vp, as_tensors):
    return tuple(torch.tensor(v, dtype=torch.float32) for v in vp) if as_tensors else vp


@pytest.mark.parametrize("convention", ["reference", "centered"])
@pytest.mark.parametrize("radius", [2, 3])
@pytest.mark.parametrize("kind", ["valid", "masked", "sparse"])
def test_plain_version_matches_pallas_packed_kriging_t(queries, kind, radius, convention):
    jg, g = _grids(kind)
    lons, lats = queries
    offs = tp.window_offsets(radius)
    P = tp.pack_width(len(offs))
    pack, jpack = tp.build_pack(g, offs, clamp=False)[0], jp.build_pack(jg, offs, clamp=False)[0]
    thresh = 4.0 if convention == "reference" else 6.25
    found = vs._select_rows(pack, P, offs, radius, g, lons, lats, emit_d2=False)[0][0]
    if kind == "sparse":  # the fallbacks: 1-3 found, and (radius 2) none found beyond the 3 NaN queries
        assert int(((found > 0) & (found < 4)).sum()) > 20
        assert radius == 3 or int((found == 0).sum()) > 3
    for i, (model, vp) in enumerate(MODELS):
        kw = dict(window_radius=radius, model=model, convention=convention)
        rows = ss.select_krige_ref(pack, P, offs, radius, g, lons, lats, convention=convention,
                                   vparams=_vparams(vp, i % 2 == 1), model=model, resolve_thresh=thresh)
        res, mask, bad = vs.packed_kriging_t(pack, g, lons, lats, vparams=_vparams(vp, i % 2 == 0),
                                             resolve_thresh=thresh, **kw)
        with pltpu.force_tpu_interpret_mode():
            jres, jmask, jbad = pallas_packed_kriging_t(jpack, jg, lons, lats, vparams=vp, tile_n=TILE,
                                                        resolve_thresh=thresh, **kw)
        assert rows.shape == (2, len(lons))
        # the wrapper on a CPU pack is the plain version
        assert torch.equal(torch.nan_to_num(rows[0], nan=-1.0), torch.nan_to_num(res, nan=-1.0))
        assert torch.equal(rows[1] > 0.5, mask)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        assert int(bad) == int(jbad)
        _close(res.numpy(), jres)
        # a NaN query is the empty mean, 0; an infinite or 1e30 one is NaN
        assert bool((res[:3] == 0).all()) and bool(torch.isnan(res[3:len(ODD)]).all())
        plain = vs.packed_kriging_t(pack, g, lons, lats, vparams=_vparams(vp, False), **kw)
        assert torch.equal(torch.nan_to_num(plain, nan=-1.0), torch.nan_to_num(res, nan=-1.0))


@pytest.mark.parametrize("model,vp", MODELS[:4])
def test_plain_version_matches_pallas_kriging_valid(queries, model, vp):
    jg, g = _grids("valid")
    lons, lats = queries
    p16, jp16 = tp.build_valid16_pack(g), jp.build_valid16_pack(jg)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_kriging_valid(jp16, jg, lons, lats, vparams=vp, model=model, tile_n=TILE)
    for as_tensors in (False, True):
        got = vs.kriging_valid_t(p16, g, lons, lats, vparams=_vparams(vp, as_tensors), model=model)
        _close(got.numpy(), want)
        rows = ss.select_krige_ref(p16, 16, tp.VALID16_OFFSETS, 2, g, lons, lats, vparams=_vparams(vp, as_tensors),
                                   model=model)
        assert rows.shape == (1, len(lons))
        assert torch.equal(torch.nan_to_num(rows[0], nan=-1.0), torch.nan_to_num(got, nan=-1.0))


def _kerguelen(kind):
    """The planes of :func:`_grids` over the Kerguelen extent (steps of
    0.2608 and 0.1820 degrees, neither a float32)."""
    jg, _ = _grids(kind)
    E = KERGUELEN_EXTENT
    jk = JGrid(jg.elev, jg.valid, E.min_lon, E.max_lon, E.min_lat, E.max_lat)
    g = grid_from_arrays(np.asarray(jk.elev), np.asarray(jk.valid), E.min_lon, E.max_lon, E.min_lat, E.max_lat, "cpu")
    return jk, g


def _line_queries(jg):
    """Every node and half-node of the grid, then ODD and a few random
    points in grid units, all mapped onto its extent (f32)."""
    cols, rows = np.arange(2 * W - 1) / 2.0, np.arange(2 * H - 1) / 2.0
    gx = np.concatenate([(cols[None, :] + 0 * rows[:, None]).ravel(), [q[0] for q in ODD],
                         np.random.default_rng(4).uniform(-1.0, W, 100)])
    gy = np.concatenate([(rows[:, None] + 0 * cols[None, :]).ravel(), [q[1] for q in ODD],
                         np.random.default_rng(5).uniform(-1.0, H, 100)])
    return ((jg.min_lon + gx * jg.lon_step).astype(np.float32), (jg.min_lat + gy * jg.lat_step).astype(np.float32))


@pytest.mark.parametrize("radius", [2, 3])
def test_plain_version_matches_pallas_on_grid_lines(radius):
    # a grid whose steps are not 1: its nodes and half-nodes, NaN, +-inf,
    # +-1e30 and out-of-grid queries; the selection through the resolved
    # row and the count exactly, the predictions at the bars above
    jg, g = _kerguelen("masked")
    lons, lats = _line_queries(jg)
    offs = tp.window_offsets(radius)
    P = tp.pack_width(len(offs))
    pack, jpack = tp.build_pack(g, offs, clamp=False)[0], jp.build_pack(jg, offs, clamp=False)[0]
    kw = dict(window_radius=radius, vparams=(1.0, 100.0, 10.0), resolve_thresh=4.0)
    res, mask, bad = vs.packed_kriging_t(pack, g, lons, lats, **kw)
    with pltpu.force_tpu_interpret_mode():
        jres, jmask, jbad = pallas_packed_kriging_t(jpack, jg, lons, lats, tile_n=TILE, **kw)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert int(bad) == int(jbad)
    _close(res.numpy(), jres)
    odd = slice(len(lons) - 100 - len(ODD), len(lons) - 100)
    assert bool((res[odd][:3] == 0).all()) and bool(torch.isnan(res[odd][3:10]).all())
    if radius == 2:
        jv, v = _kerguelen("valid")
        p16, jp16 = tp.build_valid16_pack(v), jp.build_valid16_pack(jv)
        with pltpu.force_tpu_interpret_mode():
            want = pallas_kriging_valid(jp16, jv, lons, lats, tile_n=TILE)
        _close(vs.kriging_valid_t(p16, v, lons, lats).numpy(), want)


def _query_cell(lons, lats, geo, W, H):
    """csrc/query_prologue.cuh's query_cell in numpy float32, op for op:
    (oob, ci, cj, fx, fy) from the kernel's by-value grid scalars."""
    f = np.float32
    lo_min, lo_max, la_min, la_max, inv_lon, inv_lat = (f(v) for v in geo[:6])
    with np.errstate(invalid="ignore"):
        oob = (lons < lo_min) | (lons > lo_max) | (lats < la_min) | (lats > la_max)
        x = np.where(oob, f(0), (lons - lo_min) * inv_lon).astype(f)
        y = np.where(oob, f(0), (lats - la_min) * inv_lat).astype(f)
        fl = [np.floor(v + f(0.5)) for v in (x, y)]
        ci, cj = (np.clip(np.where(np.isnan(v), 0, v), 0, hi).astype(np.int32) for v, hi in zip(fl, (W - 1, H - 1)))
    return oob, ci, cj, x - ci.astype(f), y - cj.astype(f)


@pytest.mark.parametrize("convention", ["reference", "centered"])
def test_kernel_prologue_scalars_give_the_jitted_jax_cells(convention):
    # the grid scalars B11 takes by value, and its in-kernel query prologue
    # written out in numpy float32: the jitted JAX prologue's oob, centre
    # cells and offsets, at every node and half-node of a grid whose steps
    # are not 1 and at NaN, +-inf and +-1e30 queries
    import jax
    import jax.numpy as jnp
    from auvtpu.ops.scattered import _normalize as j_normalize

    from auvtpu_torch.config import KrigingConfig

    jg, g = _kerguelen("masked")
    geo = ss._krige_geo(g, convention).f32.numpy()
    f = np.float32
    want = [g.min_lon, g.max_lon, g.min_lat, g.max_lat, *g.inv_steps(torch.float32), g.lon_step, g.lat_step,
            0.5 if convention == "reference" else 0.0, KrigingConfig().pivot_tol]
    np.testing.assert_array_equal(geo, np.asarray(want, f))
    assert geo[4] == f(1) / f(g.lon_step) and geo[5] == f(1) / f(g.lat_step)
    lons, lats = _line_queries(jg)

    @jax.jit
    def j_cells(lo, la):
        x, y, oob = j_normalize(jg, lo, la)
        ci = jnp.clip(jnp.floor(x + 0.5).astype(jnp.int32), 0, W - 1)
        cj = jnp.clip(jnp.floor(y + 0.5).astype(jnp.int32), 0, H - 1)
        return oob, ci, cj, x - ci.astype(x.dtype), y - cj.astype(y.dtype)

    for got, ref in zip(_query_cell(lons, lats, geo, W, H), j_cells(lons, lats)):
        np.testing.assert_array_equal(got, np.asarray(ref))
    M, taps = ss._krige_taps(tuple(map(tuple, tp.VALID16_OFFSETS)), 16, 2)
    assert M == 16 and list(taps) == [o[1] for o in tp.VALID16_OFFSETS] + [o[0] for o in tp.VALID16_OFFSETS]


@pytest.mark.parametrize("name,offs,R", [
    ("valid16", tp.VALID16_OFFSETS, 2),
    ("radius 1", tp.window_offsets(1), 1),
    ("radius 2", tp.window_offsets(2), 2),
    ("radius 3", tp.window_offsets(3), 3),
])
def test_tap_offsets_equal_their_decoded_codes(name, offs, R):
    # every tap's table (dx, dy) is what the epilogue decodes from its code,
    # floor(code / B) - R and code - (sdy + R) * B - R, by an f32 division
    # (CPU) and by a multiply with the f32 reciprocal of B (a CUDA tensor
    # divided by a python number); and the kernel's taps are those offsets
    P = tp.pack_width(len(offs))
    B = 2 * R + 2
    tab = ss.table(offs, P, R, "dy", "cpu")
    n = len(offs)
    code = tab[2, :n].numpy()
    assert code.max() < B * B
    for q in (code / np.float32(B), code * np.float32(1.0 / B)):
        assert q.dtype == np.float32
        sdy = np.floor(q) - np.float32(R)
        sdx = code - (sdy + np.float32(R)) * np.float32(B) - np.float32(R)
        np.testing.assert_array_equal(sdy, tab[1, :n].numpy(), err_msg=name)
        np.testing.assert_array_equal(sdx, tab[0, :n].numpy(), err_msg=name)
        dec = torch.floor(torch.from_numpy(code) / B) - R
        np.testing.assert_array_equal(dec.numpy(), sdy)
    M, dx, dy = ss._real_taps(tab, P, "select_krige")
    assert M == n and M in ss.IDW_M
    np.testing.assert_array_equal(dx, [o[1] for o in offs])
    np.testing.assert_array_equal(dy, [o[0] for o in offs])
    assert np.abs(np.concatenate([dx, dy])).max() <= 7  # the kernel's 4-bit tags


def test_plain_version_refuses_float64_grids(queries):
    jg, g = _grids("masked")
    g64 = grid_from_arrays(g.elev.double().numpy(), g.valid.double().numpy(), 0.0, W - 1.0, 0.0, H - 1.0, "cpu")
    with pytest.raises(TypeError):
        vs.packed_kriging_t(tp.StencilPack(g64).window, g64, *queries)
    with pytest.raises(TypeError):
        vs.kriging_valid_t(tp.build_valid16_pack(g64), g64, *queries)
