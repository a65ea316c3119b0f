"""Query coordinates as the compiled JAX ops compute them, and NaN
coordinates cast as XLA casts them, on the CPU.

Grid lines.  The JAX scattered, packed, tiled and two-tier ops are jitted
with the grid's extent as static metadata, so XLA folds ``(lon - min_lon) /
lon_step`` into a multiply by the reciprocal of the constant step.  On a
grid whose step is not 1 that product and the quotient differ in the last
bit at many node coordinates, and ``floor`` of them now and then by a whole
cell.  A masked stand-in on the Kerguelen extent, queried at every node and
half-node (and a few random points): ``_normalize`` bit-equal to
``jax.jit(auvtpu.ops.scattered._normalize)`` (f32 and, under x64, f64),
selections exactly equal, values at the bars of tests/test_torch_scattered.py
(bilinear and bicubic rtol 1e-5 / atol 1e-3, kriging 1e-4 / 0.1, IDW 1e-5 /
1e-2; two-tier IDW 1e-4 / 0.05 as tests/test_torch_two_tier.py), with NaN
in the same places.  The mission path's coordinates (``lonlat_to_xy``,
``ops.band._xy``) stay a division: its JAX callers run ``lonlat_to_xy``
outside any trace.

NaN.  A NaN coordinate is inside the bounds test (every comparison with NaN
is false) and reaches the float -> int casts, where XLA gives 0: each cast
site answers JAX's value for a NaN lon, a NaN lat and both, and the
streaming ingest writes a NaN column at column 0 as JAX does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auvtpu.config import KERGUELEN_EXTENT
from auvtpu.config import Extent as JExtent
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import band as jband
from auvtpu.ops import packs as jp
from auvtpu.ops import scattered as js
from auvtpu.ops import tiled as jt
from auvtpu.ops.two_tier import TwoTierInterpolator as JTwoTier
from auvtpu.ops.window import window_select as j_window_select
from auvtpu.streaming import StreamingInterpolator as JStream
from auvtpu.synthetic import kerguelen_standin, shelf_seamount

from auvtpu_torch.config import Extent
from auvtpu_torch.convert import grid_from_arrays
from auvtpu_torch.ops import band as tband
from auvtpu_torch.ops import packs as tp
from auvtpu_torch.ops import scattered as ts
from auvtpu_torch.ops import tiled as tt
from auvtpu_torch.ops.two_tier import TwoTierInterpolator
from auvtpu_torch.ops.window import window_select
from auvtpu_torch.streaming import StreamingInterpolator

torch.set_num_threads(1)

H, W = 40, 48
BARS = {"bilinear": (1e-5, 1e-3), "bicubic": (1e-5, 1e-3), "kriging": (1e-4, 0.1), "idw": (1e-5, 1e-2)}
NAN = float("nan")


def _pair(elev, extent, dtype=jnp.float32):
    jg = JGrid.from_nan_array(elev, extent, dtype=dtype)
    g = grid_from_arrays(np.asarray(jg.elev), np.asarray(jg.valid), jg.min_lon, jg.max_lon, jg.min_lat, jg.max_lat,
                         "cpu")
    return jg, g


@pytest.fixture(scope="module", params=["masked", "valid"])
def grids(request):
    """A 40x48 Kerguelen stand-in on the Kerguelen extent (steps 0.2164 and
    0.2193 degrees, neither a float32), 10 % masked with seed 42, or not."""
    elev = kerguelen_standin((H, W))
    if request.param == "masked":
        elev = mask_grid(elev, 0.10, seed=42)[0]
    return _pair(elev, KERGUELEN_EXTENT)


def _line_queries(jg, dtype=np.float32):
    """Every node and half-node of the grid, then 200 random points and a
    few outside it."""
    e = KERGUELEN_EXTENT
    cols = np.arange(2 * W - 1) / 2.0
    rows = np.arange(2 * H - 1) / 2.0
    lon = e.min_lon + cols[None, :] * jg.lon_step + 0 * rows[:, None]
    lat = e.min_lat + rows[:, None] * jg.lat_step + 0 * cols[None, :]
    rng = np.random.default_rng(16)
    lons = np.concatenate([lon.ravel(), rng.uniform(e.min_lon - 0.1, e.max_lon + 0.1, 200)])
    lats = np.concatenate([lat.ravel(), rng.uniform(e.min_lat - 0.1, e.max_lat + 0.1, 200)])
    return lons.astype(dtype), lats.astype(dtype)


@pytest.fixture(scope="module")
def queries(grids):
    return _line_queries(grids[0])


def _close(got, want, rtol, atol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# C3: grid lines
# ---------------------------------------------------------------------------

def test_normalize_is_the_jitted_jax_op_on_grid_lines(grids, queries):
    jg, g = grids
    want = jax.jit(js._normalize)(jg, *queries)
    got = ts._normalize(g, *queries)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the jitted op is not the eager quotient on these lines: the repair
    # is seen here
    eager = js._normalize(jg, *queries)[0]
    assert int((np.asarray(eager) != np.asarray(want[0])).sum()) > 100


@pytest.fixture
def x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def test_normalize_is_the_jitted_jax_op_in_float64(x64):
    jg, g = _pair(kerguelen_standin((H, W)), KERGUELEN_EXTENT, dtype=jnp.float64)
    assert g.dtype == torch.float64
    lons, lats = _line_queries(jg, np.float64)
    want = jax.jit(js._normalize)(jg, lons, lats)
    for a, b in zip(ts._normalize(g, lons, lats), want):
        assert np.asarray(b).dtype == a.numpy().dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_selections_on_grid_lines_equal_jax(grids, queries):
    jg, g = grids
    x, y, oob = ts._normalize(g, *queries)
    ci, cj = ts.centre_cells(g, x, y)
    jx, jy, _ = jax.jit(js._normalize)(jg, *queries)
    jci = jnp.clip(jnp.floor(jx + 0.5).astype(jnp.int32), 0, W - 1)
    jcj = jnp.clip(jnp.floor(jy + 0.5).astype(jnp.int32), 0, H - 1)
    np.testing.assert_array_equal(ci.numpy(), np.asarray(jci))
    np.testing.assert_array_equal(cj.numpy(), np.asarray(jcj))
    got = window_select(g, x, y, ci, cj, k=4, max_radius=10)
    want = jax.jit(j_window_select, static_argnames=("k", "max_radius"))(jg, jx, jy, jci, jcj, k=4, max_radius=10)
    for key in ("found", "slot_ok", "ii", "jj"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    sp, jsp = tp.StencilPack(g), jp.StencilPack(jg)
    for k in (4, 8):
        got = tp.packed_window_select(sp.window, g, *queries, k=k, window_radius=2)
        want = jp.packed_window_select(jsp.window, jg, *queries, k=k, window_radius=2)
        for key in ("found", "slot_ok", "ci", "cj", "oob", "x", "y"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        ok = np.asarray(want["slot_ok"])
        for key in ("val", "dx", "dy"):
            np.testing.assert_array_equal(got[key].numpy()[ok], np.asarray(want[key])[ok])


def test_scattered_ops_on_grid_lines_match_jax(grids, queries):
    jg, g = grids
    _close(ts.scattered_bilinear(g, *queries), js.scattered_bilinear(jg, *queries), *BARS["bilinear"])
    _close(ts.scattered_bicubic(g, *queries, max_radius=5), js.scattered_bicubic(jg, *queries, max_radius=5),
           *BARS["bicubic"])
    _close(ts.scattered_kriging(g, *queries), js.scattered_kriging(jg, *queries), *BARS["kriging"])
    _close(ts.scattered_idw(g, *queries, k=8, max_radius=6), js.scattered_idw(jg, *queries, k=8, max_radius=6),
           *BARS["idw"])


def test_packed_ops_on_grid_lines_match_jax(grids, queries):
    jg, g = grids
    sp, jsp = tp.StencilPack(g), jp.StencilPack(jg)
    _close(tp.packed_bilinear(sp.bilinear, g, *queries), jp.packed_bilinear(jsp.bilinear, jg, *queries),
           *BARS["bilinear"])
    _close(tp.packed_bicubic(sp.bicubic, g, *queries), jp.packed_bicubic(jsp.bicubic, jg, *queries),
           *BARS["bicubic"])
    _close(tp.packed_kriging(sp.window, g, *queries), jp.packed_kriging(jsp.window, jg, *queries), *BARS["kriging"])
    _close(tp.packed_idw(sp.window, g, *queries, k=8), jp.packed_idw(jsp.window, jg, *queries, k=8), *BARS["idw"])
    if bool(g.valid.all()):
        _close(tp.packed_kriging_valid(tp.build_valid16_pack(g), g, *queries),
               jp.packed_kriging_valid(jp.build_valid16_pack(jg), jg, *queries), *BARS["kriging"])


@pytest.mark.parametrize("op", ["bilinear", "bicubic", "kriging", "idw"])
def test_tiled_ops_on_grid_lines_match_jax(grids, queries, op):
    jg, g = grids
    kw = dict(tile=(16, 32), qblk=256)
    if op in ("kriging", "idw"):
        kw.update(window_radius=2, **({"k": 8} if op == "idw" else {}))
    got = getattr(tt, f"tiled_{op}")(g, *queries, **kw)
    want = getattr(jt, f"tiled_{op}")(jg, *queries, **kw)
    _close(got, want, *BARS[op])


def test_two_tier_on_grid_lines_matches_jax(grids, queries):
    jg, g = grids
    tier, jtier = TwoTierInterpolator(g, escalate_cap=512), JTwoTier(jg, escalate_cap=512, backend="xla")
    q = tuple(torch.from_numpy(a) for a in queries)
    mask, bad = tier._resolved_mask(*q, 4)
    jmask, jbad = jtier._resolved_mask(*queries, 4)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert int(bad) == int(jbad)
    _close(tier.kriging(*queries), jtier.kriging(*queries), *BARS["kriging"])
    _close(tier.idw(*queries, k=8), jtier.idw(*queries, k=8), 1e-4, 0.05)


def test_mission_coordinates_divide_as_their_jax_callers(grids, queries, monkeypatch):
    # the JAX mission path calls lonlat_to_xy outside any jit: a division
    # by the step, which lonlat_to_xy and ops.band._xy keep
    jg, g = grids
    traced = []
    inner = JGrid.lonlat_to_xy

    def spy(self, lons, lats):
        traced.append(isinstance(jnp.asarray(lons), jax.core.Tracer))
        return inner(self, lons, lats)

    monkeypatch.setattr(JGrid, "lonlat_to_xy", spy)
    lons, lats = queries
    inside = (lons >= KERGUELEN_EXTENT.min_lon) & (lons <= KERGUELEN_EXTENT.max_lon) & \
             (lats >= KERGUELEN_EXTENT.min_lat) & (lats <= KERGUELEN_EXTENT.max_lat)
    for max_bands in (1, 4):  # a band, and an atlas of pages
        jband.BandRouter(jg, chunk=512, max_bands=max_bands).kriging(lons[inside], lats[inside], force="band")
    assert traced and not any(traced)
    want = [np.asarray(v) for v in inner(jg, jnp.asarray(lons), jnp.asarray(lats))]
    for got in (g.lonlat_to_xy(torch.from_numpy(lons), torch.from_numpy(lats)), tband._xy(g, lons, lats)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)


# ---------------------------------------------------------------------------
# C4: NaN coordinates
# ---------------------------------------------------------------------------

NAN_LO = np.array([NAN, 3.0, NAN, 17.25, NAN], np.float32)
NAN_LA = np.array([3.0, NAN, NAN, NAN, 21.5], np.float32)


@pytest.fixture(scope="module")
def unit_grids():
    """30x40 unit-step grids, 30 % masked and fully valid."""
    elev = shelf_seamount(30, 40)
    ext = JExtent(0.0, 39.0, 0.0, 29.0)
    return {"masked": _pair(mask_grid(elev, 0.3, seed=3)[0], ext), "valid": _pair(elev, ext)}


@pytest.mark.parametrize("kind", ["masked", "valid"])
def test_nan_queries_take_cell_zero_as_in_jax(unit_grids, kind):
    jg, g = unit_grids[kind]
    lo, la = NAN_LO, NAN_LA
    sp, jsp = tp.StencilPack(g), jp.StencilPack(jg)
    pairs = [
        (ts.scattered_bilinear(g, lo, la), js.scattered_bilinear(jg, lo, la), "bilinear"),
        (ts.scattered_bicubic(g, lo, la), js.scattered_bicubic(jg, lo, la), "bicubic"),
        (ts.scattered_bicubic(g, lo, la, fallback="never"), js.scattered_bicubic(jg, lo, la, fallback="never"),
         "bicubic"),
        (tp.packed_bilinear(sp.bilinear, g, lo, la), jp.packed_bilinear(jsp.bilinear, jg, lo, la), "bilinear"),
        (tp.packed_bicubic(sp.bicubic, g, lo, la), jp.packed_bicubic(jsp.bicubic, jg, lo, la), "bicubic"),
        (tt.tiled_bilinear(g, lo, la), jt.tiled_bilinear(jg, lo, la), "bilinear"),
        (tt.tiled_bicubic(g, lo, la), jt.tiled_bicubic(jg, lo, la), "bicubic"),
        (tp.packed_kriging(sp.window, g, lo, la), jp.packed_kriging(jsp.window, jg, lo, la), "kriging"),
        (tp.packed_idw(sp.window, g, lo, la), jp.packed_idw(jsp.window, jg, lo, la), "idw"),
        (ts.scattered_kriging(g, lo, la), js.scattered_kriging(jg, lo, la), "kriging"),
    ]
    if kind == "valid":
        pairs += [
            (tp.packed_bilinear(sp.bilinear, g, lo, la, assume_valid=True),
             jp.packed_bilinear(jsp.bilinear, jg, lo, la, assume_valid=True), "bilinear"),
            (tp.packed_bicubic(sp.bicubic, g, lo, la, assume_valid=True),
             jp.packed_bicubic(jsp.bicubic, jg, lo, la, assume_valid=True), "bicubic"),
        ]
    for got, want, bar in pairs:
        _close(got, want, *BARS[bar])
    # a NaN coordinate gathers at index 0 with NaN weights: a fully valid
    # stencil answers NaN, a stencil with a masked corner its valid mean
    assert np.isnan(np.asarray(js.scattered_bilinear(jg, lo, la))).all() == (kind == "valid")


def test_tiled_partition_puts_nan_queries_in_the_first_tile(unit_grids):
    jg, g = unit_grids["masked"]
    for anchor in ("floor", "round"):
        got = tt.tiled_partition(g, NAN_LO, NAN_LA, anchor=anchor, tile=(16, 16), qblk=8)
        want = jt.tiled_partition(jg, NAN_LO, NAN_LA, anchor=anchor, tile=(16, 16), qblk=8)
        for key in ("block_tile", "src", "oob"):
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_ingest_writes_a_nan_row_or_column_at_zero_as_jax():
    shape, ext = (12, 16), (0.0, 15.0, 0.0, 11.0)
    opts = dict(swath_cap=64, window=(8, 8), method="idw", k=4, max_radius=3)
    j = JStream(shape, JExtent(*ext), **opts)
    t = StreamingInterpolator(shape, Extent(*ext), device="cpu", **opts)
    rows = np.array([4.0, NAN, NAN, 7.0], np.float32)
    cols = np.array([NAN, 5.0, NAN, 9.0], np.float32)
    vals = np.array([-10.0, -20.0, -30.0, -40.0], np.float32)
    for si in (j, t):
        assert si.ingest(rows, cols, vals) == 4
    snap = t.snapshot()
    np.testing.assert_array_equal(snap, j.snapshot())
    assert snap[4, 0] == -10.0 and snap[0, 5] == -20.0 and snap[0, 0] == -30.0 and snap[7, 9] == -40.0
