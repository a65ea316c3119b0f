"""Exact mode of the port (auvtpu_torch.ops.exact, ops.exact_fast) against
the JAX package's (auvtpu.ops.exact, ops.exact_fast under x64) on the CPU,
on small synthetic grids with awkward extents: the tables, the query
preparation, the strict selection (found, values, gi/gj), the dense planes
(count, tie, lane) and the escalated mask equal exactly; every exact
prediction within 1e-9 m with NaNs in the same places.  The scattered
selection is also held to the golden engine's ring selection exactly."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from auvtpu.config import Extent
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import exact as jexact
from auvtpu.ops import exact_fast as jfast
from auvtpu.synthetic import shelf_seamount

from auvtpu_torch.convert import grid_from_arrays
from auvtpu_torch.golden import GoldenGrid
from auvtpu_torch.ops import exact as texact
from auvtpu_torch.ops import exact_fast as tfast

torch.set_num_threads(1)

# Kerguelen-style decimals: the f64 index->geo->index round-trip leaves
# residues that break distance ties (tests/test_exact.py)
AWKWARD = Extent(74.615, 84.785, -58.2508, -49.6982)
# binary-exact steps: no residue, every distance tie exact (maximal escalation)
DEGENERATE = Extent(0.0, 79.0, -32.0, 31.0)
PRED_TOL = 1e-9  # m

GRIDS = {
    "64x80_r0.1": (64, 80, 0.1, 2, AWKWARD),
    "64x80_r0.5": (64, 80, 0.5, 3, AWKWARD),
    "64x80_r0.9": (64, 80, 0.9, 4, AWKWARD),
    "101x97_r0.3": (101, 97, 0.3, 5, AWKWARD),
    "degenerate_48x64": (48, 64, 0.3, 1, DEGENERATE),
    "sparse_40x56": (40, 56, 0.97, 4, AWKWARD),  # many cells never hold 4
}
PRED_GRIDS = ["64x80_r0.5", "101x97_r0.3", "degenerate_48x64", "sparse_40x56"]


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


_PAIRS = {}


def pair(name, dtype=np.float32):
    """(JAX grid, port CPU grid, held-out rows/cols) of one synthetic grid."""
    key = (name, dtype)
    if key not in _PAIRS:
        h, w, removal, seed, ext = GRIDS[name]
        reduced, rc, _ = mask_grid(shelf_seamount(h, w), removal, seed=seed)
        jg = JGrid.from_nan_array(reduced, ext, dtype=dtype)
        tg = grid_from_arrays(np.asarray(jg.elev), np.asarray(jg.valid), ext.min_lon, ext.max_lon,
                              ext.min_lat, ext.max_lat, "cpu")
        _PAIRS[key] = (jg, tg, rc)
    return _PAIRS[key]


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def _close(got, want, tol=PRED_TOL):
    want = np.asarray(want, np.float64)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert ok.any()
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# tables and query preparation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_radius", [2, 10, 3, 5])
def test_tables_equal(max_radius):
    _equal(texact.exact_tables(max_radius).values(), jexact.exact_tables(max_radius).values())
    assert texact.exact_tables(max_radius).keys() == jexact.exact_tables(max_radius).keys()
    got, want = tfast._collection_tables(max_radius), jfast._collection_tables(max_radius)
    assert got.keys() == want.keys()
    _equal(got.values(), want.values())


@pytest.mark.parametrize("anchor", ["round", "floor"])
@pytest.mark.parametrize("name", ["101x97_r0.3", "degenerate_48x64"])
def test_prepare_exact_queries_equal(name, anchor):
    jg, tg, rc = pair(name)
    # out-of-grid rows/cols too: the oob flag and the clamped anchors
    rows = np.concatenate([rc[:, 0], [-1, 0, tg.num_lat, 3]])
    cols = np.concatenate([rc[:, 1], [0, -2, 5, tg.num_lon]])
    got = texact.prepare_exact_queries(tg, rows, cols, anchor=anchor)
    want = jexact.prepare_exact_queries(jg, rows, cols, anchor=anchor)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    if name != "degenerate_48x64":
        assert (got.ex_key != 0).any() and (got.ey_key != 0).any()


def test_prepare_refuses_a_residue_an_f32_key_cannot_hold(monkeypatch):
    jg, tg, rc = pair("64x80_r0.1")
    fat = 2.0**41 + 1.0  # not a power of two: the scaled residue needs > 24 bits
    monkeypatch.setattr(jexact, "EPS_SCALE", fat)
    monkeypatch.setattr(texact, "EPS_SCALE", fat)
    for prepare, g in ((jexact.prepare_exact_queries, jg), (texact.prepare_exact_queries, tg)):
        with pytest.raises(ValueError, match="f32 keys"):
            prepare(g, rc[:, 0], rc[:, 1])


# ---------------------------------------------------------------------------
# selections: exactly equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("anchor", ["round", "floor"])
@pytest.mark.parametrize("name", list(GRIDS))
def test_strict_selection_equal(name, anchor):
    jg, tg, rc = pair(name)
    got = texact.exact_select_at_cells(tg, rc[:, 0], rc[:, 1], anchor=anchor, chunk=500)
    want = jexact.exact_select_at_cells(jg, rc[:, 0], rc[:, 1], anchor=anchor)
    _equal(got[:4], want[:4])
    assert got[1].dtype == np.float32 and got[2].dtype == np.int32
    found = got[0]
    assert (found >= 4).any() and (anchor == "floor" or name != "sparse_40x56" or (found < 4).any())


def _jax_dense(jg, rc, max_radius=10):
    """The JAX package's _dense_select on its own padded query arrays."""
    q = jexact.prepare_exact_queries(jg, rc[:, 0], rc[:, 1], anchor="round")
    H, W = jg.shape
    rows, cols = rc[:, 0].astype(np.int64), rc[:, 1].astype(np.int64)
    aligned = (q.ci == cols) & (q.cj == rows) & (q.variant == 0) & ~q.oob
    flat = jfast._pad_bucket(np.where(aligned, rows * W + cols, H * W).astype(np.int32), H * W)
    exq = jfast._pad_bucket(np.where(aligned, q.ex_key, 0.0).astype(np.float32), 0.0)
    eyq = jfast._pad_bucket(np.where(aligned, q.ey_key, 0.0).astype(np.float32), 0.0)
    return jfast._dense_select(jg.elev, jg.valid, flat, exq, eyq, max_radius=max_radius)


@pytest.mark.parametrize("name", list(GRIDS))
def test_dense_planes_and_escalation_equal(name):
    jg, tg, rc = pair(name)
    rows, cols = rc[:, 0].astype(np.int64), rc[:, 1].astype(np.int64)
    q = texact.prepare_exact_queries(tg, rows, cols)
    aligned = tfast._aligned(q, rows, cols)
    flat = torch.as_tensor(rows * tg.num_lon + cols)[aligned]
    got = tfast._dense_select(tg.valid, flat, torch.as_tensor(q.ex_key[aligned]), torch.as_tensor(q.ey_key[aligned]),
                              max_radius=10)
    _equal([t.numpy() for t in got], _jax_dense(jg, rc))

    got = tfast.exact_select_at_cells_fast(tg, rows, cols)
    want = jfast.exact_select_at_cells_fast(jg, rows, cols)
    _equal(got[:4] + (got[5],), want[:4] + (want[5],))
    esc = got[5].mean()
    if name == "degenerate_48x64":
        assert 0.05 < esc < 0.5  # residue-free: boundary ties fire, inner ties do not
    else:
        assert esc < 0.2


# ---------------------------------------------------------------------------
# predictions: within 1e-9 m, NaN in the same places
# ---------------------------------------------------------------------------

METHODS = {
    "strict": (texact.exact_kriging_at_cells, jexact.exact_kriging_at_cells),
    "two_tier_table": (tfast.exact_kriging_at_cells_fast, jfast.exact_kriging_at_cells_fast),
    "two_tier_coords": (lambda g, r, c: tfast.exact_kriging_at_cells_fast(g, r, c, solve="coords"),
                        lambda g, r, c: jfast.exact_kriging_at_cells_fast(g, r, c, solve="coords")),
    "cubic": (texact.exact_cubic_at_cells, jexact.exact_cubic_at_cells),
    "bilinear": (texact.exact_bilinear_at_cells, jexact.exact_bilinear_at_cells),
}
# the entry points that select, at radii other than the default 10 (the
# kernels take the radius at run time; tests/test_torch_cuda.py holds them
# to these plain versions on a card)
RADII = (3, 5)


def _at_radius(tfn, jfn, radius, **kw):
    return (lambda g, r, c: tfn(g, r, c, max_radius=radius, **kw),
            lambda g, r, c: jfn(g, r, c, max_radius=radius, **kw))


AT_RADIUS = {
    f"{method}_r{radius}": _at_radius(tfn, jfn, radius, **kw)
    for radius in RADII
    for method, tfn, jfn, kw in (
        ("strict", texact.exact_kriging_at_cells, jexact.exact_kriging_at_cells, {}),
        ("two_tier_table", tfast.exact_kriging_at_cells_fast, jfast.exact_kriging_at_cells_fast, {}),
        ("two_tier_coords", tfast.exact_kriging_at_cells_fast, jfast.exact_kriging_at_cells_fast,
         {"solve": "coords"}),
        ("cubic", texact.exact_cubic_at_cells, jexact.exact_cubic_at_cells, {}))
}


@pytest.mark.parametrize("method", list(METHODS) + list(AT_RADIUS))
@pytest.mark.parametrize("name", PRED_GRIDS)
def test_cell_predictions_within_1e9(name, method):
    jg, tg, rc = pair(name, np.float64)
    tfn, jfn = METHODS.get(method) or AT_RADIUS[method]
    _close(tfn(tg, rc[:, 0], rc[:, 1]), jfn(jg, rc[:, 0], rc[:, 1]))


def test_predictions_at_out_of_grid_cells_are_nan():
    jg, tg, rc = pair("64x80_r0.5", np.float64)
    rows = np.concatenate([rc[:50, 0], [-1, tg.num_lat, 2]])
    cols = np.concatenate([rc[:50, 1], [3, 4, tg.num_lon + 1]])
    for tfn, jfn in METHODS.values():
        got = tfn(tg, rows, cols)
        assert np.isnan(got[-3:]).all()
        _close(got, jfn(jg, rows, cols))


def _scattered_queries(ext, n=2000, seed=0):
    """Uniform points over the extent and 5 % past it, cell centres, and
    half-integer lines (exact distance ties)."""
    rng = np.random.default_rng(seed)
    w, h = ext.max_lon - ext.min_lon, ext.max_lat - ext.min_lat
    lons = rng.uniform(ext.min_lon - 0.05 * w, ext.max_lon + 0.05 * w, n)
    lats = rng.uniform(ext.min_lat - 0.05 * h, ext.max_lat + 0.05 * h, n)
    # the grid steps of every GRIDS entry divide the extent into 39..100
    # parts: 0.25-step fractions of 40 cells land on centres and half lines
    u = np.arange(0, 40, 0.25) / 40
    return (np.concatenate([lons, ext.min_lon + u * w, ext.min_lon + u[::-1] * w]),
            np.concatenate([lats, ext.min_lat + u * h, ext.min_lat + u * h]))


@pytest.mark.parametrize("method", ["kriging", "cubic", "bilinear"] +
                         [f"{m}_r{r}" for m in ("kriging", "cubic") for r in RADII])
@pytest.mark.parametrize("name", ["64x80_r0.5", "sparse_40x56"])
def test_scattered_predictions_within_1e9(name, method):
    # kriging_r3 etc.: the entry point at max_radius 3 (cubic: its ring
    # fallback's radius)
    jg, tg, _ = pair(name, np.float64)
    lons, lats = _scattered_queries(GRIDS[name][4])
    entry, _, radius = method.partition("_r")
    kw = {"max_radius": int(radius)} if radius else {}
    got = getattr(texact, f"exact_{entry}_scattered")(tg, lons, lats, **kw)
    _close(got, getattr(jexact, f"exact_{entry}_scattered")(jg, lons, lats, **kw))
    # tensors on the grid's device are taken as they are
    again = getattr(texact, f"exact_{entry}_scattered")(tg, torch.as_tensor(lons), torch.as_tensor(lats), **kw)
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("name", ["64x80_r0.1", "64x80_r0.5", "sparse_40x56"])
def test_scattered_selection_equals_the_golden_ring_select(name):
    _, tg, _ = pair(name, np.float64)
    ext = GRIDS[name][4]
    lons, lats = _scattered_queries(ext, seed=1)
    g = GoldenGrid(tg.to_nan_array(), ext.min_lon, ext.max_lon, ext.min_lat, ext.max_lat)
    x, y, oob = g._normalize(lons, lats)
    keep = ~oob
    x, y = x[keep], y[keep]
    ci = np.clip(np.floor(x + 0.5).astype(np.int64), 0, g.num_lon - 1)
    cj = np.clip(np.floor(y + 0.5).astype(np.int64), 0, g.num_lat - 1)
    sv, si, sj, found = g._ring_select(x, y, ci, cj)
    f, v, gi, gj = (t.numpy() for t in texact._select_scattered(tg, ci, cj, x, y, 10, 700))
    np.testing.assert_array_equal(f, found)
    full = found >= 4
    np.testing.assert_array_equal(gi[full], si[full])
    np.testing.assert_array_equal(gj[full], sj[full])
    np.testing.assert_array_equal(v[full], sv[full])
    assert full.any() and (name != "sparse_40x56" or (~full).any())


def test_empty_inputs():
    jg, tg, _ = pair("64x80_r0.1", np.float64)
    e = np.zeros(0, np.int64)
    for tfn, _ in METHODS.values():
        assert tfn(tg, e, e).shape == (0,)
    for method in ("kriging", "cubic", "bilinear"):
        got = getattr(texact, f"exact_{method}_scattered")(tg, np.zeros(0), np.zeros(0))
        want = getattr(jexact, f"exact_{method}_scattered")(jg, np.zeros(0), np.zeros(0))
        assert got.shape == want.shape == (0,) and got.dtype == np.float64
    found, sel_val, gi, gj, q = texact.exact_select_at_cells(tg, e, e)
    assert found.shape == (0,) and sel_val.shape == gi.shape == gj.shape == (0, 4)
    assert tfast.exact_select_at_cells_fast(tg, e, e)[5].shape == (0,)
