"""Exact mode's epilogues B17 and B18 (auvtpu_torch.kernels.exact_epilogue)
on the CPU: each plain version, through its op's CPU implementation,
against its JAX counterpart (auvtpu.ops.exact under x64) on the same
operands, on 40x56 and 64x80 grids masked 30 % and 90 %, a degenerate one
and a 64x80 grid masked 5 % (whose patches are often all valid), in f32 and
f64, at the masked cells, other cells, cells past the edges and 5,000
uniform scattered queries with NaN, ±inf and out-of-grid ones:

- B17 (``exact_krige``) against ``_krige_chunk`` with the JAX package's
  fallbacks (found < 4: ``_fallback_mean_np``; singular: the 4-mean), also
  on selections made singular, with found 0-3 and empty; its ``mean_into``
  overload against ``_fallback_mean_np``;
- B18 (``exact_patch``) scattered against ``_bilinear_chunk`` and
  ``_cubic_smooth_chunk`` (smooth value and the ``need`` mask), at cells
  against the host numpy of ``exact_bilinear_at_cells`` and
  ``exact_cubic_at_cells``.

The bar is 1e-9 m with NaN in the same places; on f32 grids the scattered
cubic is held to numpy's op-by-op evaluation (XLA:CPU evaluates its f32
sums otherwise, up to 3.3e-5 m: ROADMAP, differences that are not faults).
The ops pass opcheck, their fake implementations give the outputs' shapes
and dtypes, and the launches hand ctypes the C signatures' arguments."""

import contextlib
import ctypes
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import jax

from auvtpu.config import Extent
from auvtpu.golden.engine import _catmull_rom as np_catmull_rom
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import exact as jexact
from auvtpu.synthetic import shelf_seamount

from auvtpu_torch.convert import grid_from_arrays
from auvtpu_torch.kernels import exact_epilogue as ee
from auvtpu_torch.kernels import library
from auvtpu_torch.kernels.exact_prologue import GEO, GRID, KEYS
from auvtpu_torch.ops import exact as texact

torch.set_num_threads(1)

AWKWARD = Extent(74.615, 84.785, -58.2508, -49.6982)
DEGENERATE = Extent(0.0, 79.0, -32.0, 31.0)  # binary-exact steps
GRIDS = {
    "40x56_r0.3": (40, 56, 0.3, 4, AWKWARD),
    "40x56_r0.9": (40, 56, 0.9, 5, AWKWARD),
    "64x80_r0.3": (64, 80, 0.3, 2, AWKWARD),
    "64x80_r0.9": (64, 80, 0.9, 3, AWKWARD),
    "degenerate_48x64": (48, 64, 0.3, 1, DEGENERATE),
    "64x80_r0.05": (64, 80, 0.05, 6, AWKWARD),  # many patches all valid: the smooth paths
}
DTYPES = {"f32": np.float32, "f64": np.float64}
TOL = 1e-9  # m
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "auvtpu_torch", "csrc",
                    "exact_epilogue.cu")


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


_CASES = {}


def case(name, dt="f64"):
    """(JAX grid, port CPU grid, cell rows, cell cols, lons, lats) of one
    grid: the masked cells, every 7th cell and cells past each edge; 5,000
    uniform queries over the extent widened by 2 %, then NaN, ±inf and
    out-of-grid ones."""
    key = (name, dt)
    if key not in _CASES:
        h, w, removal, seed, ext = GRIDS[name]
        reduced, rc, _ = mask_grid(shelf_seamount(h, w), removal, seed=seed)
        jg = JGrid.from_nan_array(reduced, ext, dtype=DTYPES[dt])
        tg = grid_from_arrays(np.asarray(jg.elev), np.asarray(jg.valid), ext.min_lon, ext.max_lon, ext.min_lat,
                              ext.max_lat, "cpu")
        every = np.arange(0, h * w, 7)
        rows = np.concatenate([rc[:, 0], every // w, [-1, 0, h, 3, h - 1]]).astype(np.int64)
        cols = np.concatenate([rc[:, 1], every % w, [2, -1, 5, w, w - 1]]).astype(np.int64)
        rng = np.random.default_rng(seed)
        dw, dh = 0.02 * (ext.max_lon - ext.min_lon), 0.02 * (ext.max_lat - ext.min_lat)
        lon = rng.uniform(ext.min_lon - dw, ext.max_lon + dw, 5000)
        lat = rng.uniform(ext.min_lat - dh, ext.max_lat + dh, 5000)
        nan, inf = np.nan, np.inf
        c_lon, c_lat = lon[:8], lat[:8]
        odd_lon = [nan, nan, c_lon[0], inf, -inf, c_lon[1], nan, ext.min_lon - 1.0, ext.max_lon, ext.min_lon]
        odd_lat = [c_lat[0], nan, nan, c_lat[1], c_lat[2], -inf, inf, c_lat[3], ext.max_lat, ext.min_lat - 1e-9]
        _CASES[key] = (jg, tg, rows, cols, np.concatenate([lon, odd_lon]), np.concatenate([lat, odd_lat]))
    return _CASES[key]


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=tol)


def _t(a, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


# ---------------------------------------------------------------------------
# B17
# ---------------------------------------------------------------------------

def jax_krige(jg, found, sel_val, sel_gi, sel_gj, qlon, qlat):
    """exact_kriging_at_cells' and exact_kriging_scattered's epilogue in the
    JAX package, every query taken (the oob mask is the callers'):
    _fallback_mean_np where found < 4, else _krige_chunk with the 4-mean
    where it is singular."""
    n = len(found)
    out = np.full(n, np.nan)
    few = found < 4
    out[few] = jexact._fallback_mean_np(found[few], sel_val[few])
    okm = ~few
    if okm.any():
        lon_step = (jg.max_lon - jg.min_lon) / (jg.num_lon - 1)
        lat_step = (jg.max_lat - jg.min_lat) / (jg.num_lat - 1)
        cx = jg.min_lon + (sel_gi[okm].astype(np.float64) + 0.5) * lon_step
        cy = jg.min_lat + (sel_gj[okm].astype(np.float64) + 0.5) * lat_step
        vals = sel_val[okm].astype(np.float64)
        pred, singular = jexact._krige_chunk(qlon[okm], qlat[okm], vals, cx, cy)
        out[okm] = np.where(np.asarray(singular), vals.mean(axis=1), np.asarray(pred))
    return out


def cell_selection(tg, rows, cols, anchor):
    """The port's strict selection of cells (rows, cols) at ``anchor``
    (tensors) with the query tensors."""
    q = texact.query_tensors(tg, rows, cols, anchor=anchor, fields=KEYS | GEO | GRID)
    return texact._select_cells(tg, q, None, 10, 16384), q


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(GRIDS))
def test_krige_matches_jax_at_cells(name, dt):
    jg, tg, rows, cols, _, _ = case(name, dt)
    (found, sel_val, sel_gi, sel_gj), q = cell_selection(tg, rows, cols, "round")
    got = ee.krige(tg, found, sel_val, sel_gi, sel_gj, q.qlon, q.qlat)
    assert got.dtype == torch.float64 and got.shape == found.shape
    want = jax_krige(jg, *(t.numpy() for t in (found, sel_val, sel_gi, sel_gj, q.qlon, q.qlat)))
    _close(got.numpy(), want)
    assert bool((found >= 4).any())


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(GRIDS))
def test_krige_matches_jax_at_scattered_queries(name, dt):
    jg, tg, _, _, lons, lats = case(name, dt)
    q = texact.scattered_tensors(tg, lons, lats, "round")
    found, sel_val, sel_gi, sel_gj = texact._select_scattered(tg, q.ci, q.cj, q.x, q.y, 10, 16384)
    got = ee.krige(tg, found, sel_val, sel_gi, sel_gj, q.qlon, q.qlat)
    want = jax_krige(jg, *(t.numpy() for t in (found, sel_val, sel_gi, sel_gj)), lons, lats)
    _close(got.numpy(), want)
    # int64 cells: the same answers
    torch.testing.assert_close(ee.krige(tg, found, sel_val, sel_gi.long(), sel_gj.long(), q.qlon, q.qlat), got,
                               rtol=0, atol=0, equal_nan=True)


def odd_selections(tg, dt):
    """Selections made singular (two slots on one cell: two equal rows),
    with found 0-3 (zero beyond found) and at NaN and ±inf coordinates."""
    H, W = tg.shape
    rng = np.random.default_rng(21)
    n = 96
    gi = rng.integers(0, W, (n, 4)).astype(np.int32)
    gj = rng.integers(0, H, (n, 4)).astype(np.int32)
    vals = rng.uniform(-5000.0, -10.0, (n, 4)).astype(DTYPES[dt])
    found = np.full(n, 4, np.int32)
    sing = np.arange(n) % 3 == 0
    gi[sing, 2], gj[sing, 2] = gi[sing, 0], gj[sing, 0]
    few = np.arange(n) % 3 == 1
    found[few] = np.arange(n)[few] % 4
    vals = np.where(np.arange(4)[None, :] < found[:, None], vals, 0).astype(DTYPES[dt])
    gi = np.where(np.arange(4)[None, :] < found[:, None], gi, 0).astype(np.int32)
    gj = np.where(np.arange(4)[None, :] < found[:, None], gj, 0).astype(np.int32)
    qlon = tg.min_lon + rng.uniform(0, W - 1, n) * tg.lon_step
    qlat = tg.min_lat + rng.uniform(0, H - 1, n) * tg.lat_step
    qlon[2::9], qlat[5::9], qlon[8::9] = np.nan, np.inf, -np.inf
    return found, vals, gi, gj, qlon, qlat, sing


@pytest.mark.parametrize("dt", list(DTYPES))
def test_krige_on_singular_systems_few_found_and_odd_coordinates(dt):
    jg, tg, *_ = case("64x80_r0.3", dt)
    found, vals, gi, gj, qlon, qlat, sing = odd_selections(tg, dt)
    got = ee.krige(tg, *(_t(a) for a in (found, vals, gi, gj, qlon, qlat))).numpy()
    _close(got, jax_krige(jg, found, vals, gi, gj, qlon, qlat))
    # a singular system takes the 4-mean, whatever its query
    v64 = vals.astype(np.float64)
    np.testing.assert_array_equal(got[sing], (((v64[:, 0] + v64[:, 1]) + v64[:, 2]) + v64[:, 3])[sing] / 4.0)
    assert np.isnan(got[found == 0]).all() and np.isfinite(got[(found > 0) & (found < 4)]).all()


@pytest.mark.parametrize("dt", list(DTYPES))
def test_krige_mean_into_matches_the_jax_fallback_mean(dt):
    jg, tg, *_ = case("40x56_r0.9", dt)
    found, vals, *_ = odd_selections(tg, dt)
    n = len(found)
    idx = np.random.default_rng(3).permutation(3 * n)[:n]
    out = torch.full((3 * n,), 7.25, dtype=torch.float64)
    ee.krige_mean_into(out, _t(idx), _t(found), _t(vals))
    want = np.full(3 * n, 7.25)
    want[idx] = jexact._fallback_mean_np(found, vals)
    _close(out.numpy(), want)


def test_empty_inputs():
    _, tg, *_ = case("40x56_r0.3")
    e = lambda dt, *shape: torch.empty((0, *shape), dtype=dt)
    got = ee.krige(tg, e(torch.int32), e(torch.float64, 4), e(torch.int32, 4), e(torch.int32, 4), e(torch.float64),
                   e(torch.float64))
    assert got.shape == (0,) and got.dtype == torch.float64
    out = torch.ones(3, dtype=torch.float64)
    ee.krige_mean_into(out, e(torch.int64), e(torch.int32), e(torch.float64, 4))
    assert out.tolist() == [1.0, 1.0, 1.0]
    for kind in ee.KINDS:
        for at_cells in (True, False):
            extra = dict(found=e(torch.int32), sel_val=e(torch.float64, 4)) if at_cells else dict(oob=e(torch.bool))
            res, need = ee.patch(tg, kind, e(torch.int64), e(torch.int64), e(torch.float64), e(torch.float64),
                                 at_cells=at_cells, **extra)
            assert res.shape == need.shape == (0,) and res.dtype == torch.float64 and need.dtype == torch.bool


# ---------------------------------------------------------------------------
# B18
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(GRIDS))
def test_bilinear_matches_jax_at_scattered_queries(name, dt):
    jg, tg, _, _, lons, lats = case(name, dt)
    q = texact.scattered_tensors(tg, lons, lats, "floor")
    got, need = ee.patch(tg, "bilinear", q.ci, q.cj, q.x, q.y, at_cells=False)
    assert need.shape == (0,)
    with np.errstate(invalid="ignore"):
        _, _, x, y, ci, cj, _ = jexact._prepare_scattered(jg, lons, lats, "floor")
    _close(got.numpy(), jexact._bilinear_chunk(jg.elev, jg.valid, ci, cj, x, y))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(GRIDS))
def test_cubic_matches_jax_at_scattered_queries(name, dt):
    jg, tg, _, _, lons, lats = case(name, dt)
    q = texact.scattered_tensors(tg, lons, lats, "floor")
    got, need = ee.patch(tg, "cubic", q.ci, q.cj, q.x, q.y, at_cells=False, oob=q.oob)
    with np.errstate(invalid="ignore"):
        _, _, x, y, ci, cj, oob = jexact._prepare_scattered(jg, lons, lats, "floor")
    smooth, all_ok = (np.asarray(a) for a in jexact._cubic_smooth_chunk(jg.elev, jg.valid, ci, cj, x, y))
    np.testing.assert_array_equal(need.numpy(), ~all_ok & ~oob)
    if dt == "f64":
        _close(got.numpy(), smooth)
    else:
        # numpy's op-by-op evaluation: the coefficients in f32, each product
        # with the f64 t promoting
        H, W = tg.shape
        rel = np.arange(-1, 3)
        xi, yi = ci.astype(np.int64), cj.astype(np.int64)
        jj, ii = np.clip(yi[:, None] + rel, 0, H - 1), np.clip(xi[:, None] + rel, 0, W - 1)
        patch = np.asarray(jg.elev)[jj[:, :, None], ii[:, None, :]]
        assert patch.dtype == np.float32
        tx, ty = x - xi, y - yi
        col = np_catmull_rom(patch[:, :, 0], patch[:, :, 1], patch[:, :, 2], patch[:, :, 3], tx[:, None])
        _close(got.numpy(), np_catmull_rom(col[:, 0], col[:, 1], col[:, 2], col[:, 3], ty))
        _close(got.numpy(), smooth, 1e-4)  # XLA:CPU's f32 sums
    assert bool(need.any())
    if name == "64x80_r0.05":
        assert int((~need & ~q.oob).sum()) > 1000  # the smooth path


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(GRIDS))
def test_bilinear_matches_jax_at_cells(name, dt):
    jg, tg, rows, cols, _, _ = case(name, dt)
    q = texact.query_tensors(tg, rows, cols, anchor="floor", fields=GRID)
    got, _ = ee.patch(tg, "bilinear", q.ci, q.cj, q.x, q.y, at_cells=True)
    got = torch.where(q.oob, torch.nan, got).numpy()
    _close(got, jexact.exact_bilinear_at_cells(jg, rows, cols))


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("name", list(GRIDS))
def test_cubic_matches_jax_at_cells(name, dt):
    jg, tg, rows, cols, _, _ = case(name, dt)
    (found, sel_val, _, _), q = cell_selection(tg, rows, cols, "floor")
    got, _ = ee.patch(tg, "cubic", q.ci, q.cj, q.x, q.y, at_cells=True, found=found, sel_val=sel_val)
    got = torch.where(q.oob, torch.nan, got).numpy()
    want = jexact.exact_cubic_at_cells(jg, rows, cols)
    _close(got, want)
    if name == "64x80_r0.05":  # the smooth path runs: some observed cells' patches are all valid
        fb = ee.fallback_mean(found, sel_val).numpy()
        assert (np.abs(got - fb)[~np.isnan(got)] > 1e-6).sum() > 100


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

def _op_args(op_name, dt="f64"):
    # opcheck holds NaN unequal to NaN: 5 % masked, every bilinear corner
    # set and selection holds one
    _, tg, rows, cols, lons, lats = case("64x80_r0.05", dt)
    if op_name == "exact_krige":
        (found, sel_val, sel_gi, sel_gj), q = cell_selection(tg, rows, cols, "round")
        return library.exact_krige, (found, sel_val, sel_gi, sel_gj, q.qlon, q.qlat, ee.scalars_of(tg))
    if op_name == "exact_krige.mean_into":
        (found, sel_val, _, _), _ = cell_selection(tg, rows, cols, "floor")
        ok = found > 0  # opcheck holds NaN unequal to NaN
        n = int(ok.sum())
        return library.exact_krige_mean_into, (found[ok], sel_val[ok], torch.arange(n) * 2,
                                               torch.zeros(2 * n, dtype=torch.float64))
    kind, form = op_name.split(":")[1:]
    at_cells = form == "cells"
    if at_cells:
        (found, sel_val, _, _), q = cell_selection(tg, rows, cols, "floor")
        if kind == "bilinear":  # a cell whose four corners are all masked is NaN
            ok = ~torch.isnan(ee.patch(tg, kind, q.ci, q.cj, q.x, q.y, at_cells=True)[0])
            q = dataclasses.replace(q, ci=q.ci[ok], cj=q.cj[ok], x=q.x[ok], y=q.y[ok])
        extra = (found, sel_val, None) if kind == "cubic" else (None, None, None)
    else:
        ok = np.isfinite(lons) & np.isfinite(lats)
        q = texact.scattered_tensors(tg, lons[ok], lats[ok], "floor")
        extra = (None, None, q.oob if kind == "cubic" else None)
    return library.exact_patch, (tg.elev, tg.valid, q.ci, q.cj, q.x, q.y, *extra, ee.KINDS[kind], at_cells, 1000)


OPS = ["exact_krige", "exact_krige.mean_into", "exact_patch:bilinear:cells", "exact_patch:bilinear:scattered",
       "exact_patch:cubic:cells", "exact_patch:cubic:scattered"]


@pytest.mark.parametrize("op_name", OPS)
def test_opcheck(op_name):
    op, args = _op_args(op_name)
    out = op(*args)
    assert all(not torch.isnan(t).any() for t in (out if isinstance(out, tuple) else (out,)) if t is not None)
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("op_name", OPS)
def test_fake_implementations_give_the_outputs_shapes_and_dtypes(op_name, dt):
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, args = _op_args(op_name, dt)
    real = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if torch.is_tensor(a) else a for a in args))
    if real is None:  # mean_into writes its output
        assert fake is None
        return
    real, fake = (t if isinstance(t, tuple) else (t,) for t in (real, fake))
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        assert (r.shape, r.dtype) == (f.shape, f.dtype)


def test_ops_refuse_what_the_kernels_do_not_take():
    _, tg, rows, cols, _, _ = case("40x56_r0.3")
    (found, sel_val, sel_gi, sel_gj), q = cell_selection(tg, rows, cols, "round")
    with pytest.raises(TypeError, match="found must be torch.int32"):
        ee.krige(tg, found.long(), sel_val, sel_gi, sel_gj, q.qlon, q.qlat)
    with pytest.raises(TypeError, match="qlon must be torch.float64"):
        ee.krige(tg, found, sel_val, sel_gi, sel_gj, q.qlon.float(), q.qlat)
    with pytest.raises(ValueError, match="sel_val must have shape"):
        ee.krige(tg, found, sel_val[:, :3], sel_gi, sel_gj, q.qlon, q.qlat)
    with pytest.raises(TypeError, match="ci must be torch.int64"):
        ee.patch(tg, "bilinear", q.ci.int(), q.cj, q.x, q.y, at_cells=True)
    with pytest.raises(ValueError, match="oob is required"):
        ee.patch(tg, "cubic", q.ci, q.cj, q.x, q.y, at_cells=False)
    with pytest.raises(ValueError, match="found is required"):
        ee.patch(tg, "cubic", q.ci, q.cj, q.x, q.y, at_cells=True)


_CTYPES = {"int": ctypes.c_int, "double": ctypes.c_double, "void*": ctypes.c_void_p, "const void*": ctypes.c_void_p}


def _c_params(entry):
    sig = re.search(rf"int {entry}\(([^)]*)\)", open(CSRC).read()).group(1)
    params = [re.sub(r"\s+", " ", p.strip()).rsplit(" ", 1) for p in sig.split(",")]
    types = [_CTYPES[t.replace(" *", "*")] if not name.startswith("*") else _CTYPES[t + "*"] for t, name in params]
    return types, [name.lstrip("*") for _, name in params]


class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, attr):
        return self

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@contextlib.contextmanager
def _recording():
    rec = _Recorder()
    orig = (ee._lib, ee._stream, torch.cuda.device)
    try:
        ee._lib, ee._stream = (lambda: rec), (lambda dev: None)
        torch.cuda.device = lambda dev: contextlib.nullcontext()
        yield rec
    finally:
        ee._lib, ee._stream, torch.cuda.device = orig
        ee.reset_launches()


def test_ctypes_arguments_follow_the_c_signatures():
    import inspect

    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    body = inspect.getsource(ee._lib.__wrapped__)
    krige_types, krige_names = _c_params("auvtpu_exact_krige")
    patch_types, patch_names = _c_params("auvtpu_exact_patch")
    assert krige_types == [I, I, I, I, P, P, P, P, P, P, D, D, D, D, D, D, D, D, P, P, P], krige_names
    assert patch_types == [I, I, I, I, I, I, P, P, P, P, P, P, P, P, P, P, P, P], patch_names
    assert "auvtpu_exact_krige.argtypes = [I, I, I, I, P, P, P, P, P, P, D, D, D, D, D, D, D, D, P, P, P]" in body
    assert "auvtpu_exact_patch.argtypes = [I, I, I, I, I, I, P, P, P, P, P, P, P, P, P, P, P, P]" in body

    _, tg, rows, cols, _, _ = case("40x56_r0.3", "f32")
    (found, sel_val, sel_gi, sel_gj), q = cell_selection(tg, rows, cols, "round")
    gi64 = sel_gi.long()
    scal = ee.scalars_of(tg)
    with _recording() as rec:
        out = ee.krige_launch(found, sel_val, gi64, sel_gj.long(), q.qlon, q.qlat, scal)
        base = torch.zeros(2 * len(found), dtype=torch.float64)
        idx = torch.arange(len(found)) * 2
        ee.krige_launch(found, sel_val, None, None, None, None, [0.0] * 8, idx, base)
    (a, b) = (dict(zip(krige_names, c)) for c in rec.calls)
    assert (a["dtype"], a["idx_type"], a["mean_only"], a["n"]) == (0, 1, 0, len(found))
    assert [a[k] for k in ("min_lon", "min_lat", "lon_step", "lat_step", "nugget", "sill", "range",
                           "pivot_tol")] == scal == [tg.min_lon, tg.min_lat, tg.lon_step, tg.lat_step, 1.0, 100.0,
                                                     10.0, 1e-12]
    assert (a["found"], a["sel_val"], a["sel_gi"], a["qlon"], a["qlat"], a["out"]) == (
        found.data_ptr(), sel_val.data_ptr(), gi64.data_ptr(), q.qlon.data_ptr(), q.qlat.data_ptr(), out.data_ptr())
    assert a["idx"] is None
    assert (b["mean_only"], b["sel_gi"], b["qlon"], b["idx"], b["out"]) == (1, None, None, idx.data_ptr(),
                                                                             base.data_ptr())
    lo = np.array([tg.min_lon + 0.3, np.nan])
    qs = texact.scattered_tensors(tg, lo, np.array([tg.min_lat + 0.2, 0.0]), "floor")
    with _recording() as rec:
        out, need = ee.patch_launch(tg.elev, tg.valid, qs.ci, qs.cj, qs.x, qs.y, None, None, qs.oob, 1, False)
        out2, _ = ee.patch_launch(tg.elev, tg.valid, q.ci, q.cj, q.x, q.y, found, sel_val, None, 1, True)
    (a, b) = (dict(zip(patch_names, c)) for c in rec.calls)
    H, W = tg.shape
    assert (a["dtype"], a["kind"], a["at_cells"], a["H"], a["W"], a["n"]) == (0, 1, 0, H, W, 2)
    assert (a["elev"], a["valid"], a["ci"], a["cj"], a["x"], a["y"], a["oob"], a["out"], a["need"]) == (
        tg.elev.data_ptr(), tg.valid.data_ptr(), qs.ci.data_ptr(), qs.cj.data_ptr(), qs.x.data_ptr(),
        qs.y.data_ptr(), qs.oob.data_ptr(), out.data_ptr(), need.data_ptr())
    assert a["found"] is None and a["sel_val"] is None
    assert (b["at_cells"], b["found"], b["sel_val"], b["oob"], b["need"], b["out"]) == (
        1, found.data_ptr(), sel_val.data_ptr(), None, None, out2.data_ptr())
