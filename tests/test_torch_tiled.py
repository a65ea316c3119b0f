"""The port's tile-streaming scattered ops (auvtpu_torch.ops.tiled) against
the JAX package's (auvtpu.ops.tiled, XLA:CPU), mirroring tests/test_tiled.py
on its grids and queries: small tiles and blocks force multi-tile
partitions, pad lanes and the last tile row and column.

- the partition equals JAX's ``_partition`` exactly (block map, lanes,
  source indices) for both anchors;
- each ``tiled_*`` matches the port's ``scattered_*`` at tests/test_tiled.py's
  bars (rtol 1e-5 with atol 1e-3 for bilinear and bicubic, 0.05 kriging,
  0.01 IDW), and each ``tiled_*`` matches JAX's ``tiled_*`` within
  1e-5 x max(1, |v|) with NaN in the same places;
- out-of-bounds queries give NaN, and a partition built once serves a
  changed grid as a fresh one-shot call does;
- the shared stencil epilogues equal JAX's on the same stencils.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auvtpu.config import Extent as JExtent
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import packs as jpacks
from auvtpu.ops import tiled as jt
from auvtpu.synthetic import shelf_seamount

from auvtpu_torch.convert import grid_from_arrays
from auvtpu_torch.ops import packs as tpacks
from auvtpu_torch.ops import scattered_bicubic, scattered_bilinear, scattered_idw, scattered_kriging
from auvtpu_torch.ops import tiled as tt

torch.set_num_threads(1)

H, W = 96, 130
TK = dict(tile=(32, 64), qblk=256)


def _grids(masked):
    elev = shelf_seamount(H, W)
    if masked:
        elev, _, _ = mask_grid(elev, 0.25, seed=8)
    jg = JGrid.from_nan_array(elev, JExtent(0.0, float(W - 1), 0.0, float(H - 1)))
    tg = grid_from_arrays(np.asarray(jg.elev), np.asarray(jg.valid), jg.min_lon, jg.max_lon, jg.min_lat,
                          jg.max_lat, "cpu")
    return jg, tg


def _queries(n=3000, seed=3):
    r = np.random.RandomState(seed)
    lons = r.uniform(1e-5, W - 1 - 1e-5, n).astype(np.float32)
    lats = r.uniform(1e-5, H - 1 - 1e-5, n).astype(np.float32)
    return lons, lats


def _check(a, b, atol=1e-3):
    a, b = np.asarray(a), np.asarray(b)
    assert (np.isnan(a) == np.isnan(b)).all()
    both = ~np.isnan(a)
    np.testing.assert_allclose(a[both], b[both], rtol=1e-5, atol=atol)


def _close_to_jax(got, want):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert (np.abs(got[ok] - want[ok]) <= 1e-5 * np.maximum(1.0, np.abs(want[ok]))).all()


OPS = {
    "bilinear": (lambda g, lo, la, **k: tt.tiled_bilinear(g, lo, la, **k),
                 lambda g, lo, la, **k: jt.tiled_bilinear(g, lo, la, **k)),
    "bicubic": (lambda g, lo, la, **k: tt.tiled_bicubic(g, lo, la, **k),
                lambda g, lo, la, **k: jt.tiled_bicubic(g, lo, la, **k)),
    "kriging": (lambda g, lo, la, **k: tt.tiled_kriging(g, lo, la, window_radius=2, **k),
                lambda g, lo, la, **k: jt.tiled_kriging(g, lo, la, window_radius=2, **k)),
    "idw": (lambda g, lo, la, **k: tt.tiled_idw(g, lo, la, k=8, window_radius=2, **k),
            lambda g, lo, la, **k: jt.tiled_idw(g, lo, la, k=8, window_radius=2, **k)),
}


@pytest.mark.parametrize("anchor", ["floor", "round"])
@pytest.mark.parametrize("tile, qblk", [((32, 64), 64), ((32, 64), 256), ((128, 256), 2048)])
def test_partition_equals_jax(anchor, tile, qblk):
    lons, lats = _queries(n=777, seed=5)
    got = tt._partition(torch.from_numpy(lons), torch.from_numpy(lats), H, W, anchor=anchor, tile=tile, qblk=qblk)
    want = jt._partition(jnp.asarray(lons), jnp.asarray(lats), H, W, anchor=anchor, tile=tile, qblk=qblk)
    for name, a, b in zip(("block_tile", "qx", "qy", "src"), got[:4], want[:4]):
        assert a.numpy().dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert got[4] == want[4]
    src = got[3].numpy().ravel()
    live = src[src >= 0]
    assert len(live) == 777 and len(np.unique(live)) == 777


@pytest.mark.parametrize("masked", [False, True])
def test_tiled_bilinear_matches_scattered(masked):
    _, g = _grids(masked)
    lons, lats = _queries()
    _check(tt.tiled_bilinear(g, lons, lats, **TK), scattered_bilinear(g, lons, lats))


def test_tiled_bicubic_matches_scattered():
    _, g = _grids(False)
    lons, lats = _queries()
    _check(tt.tiled_bicubic(g, lons, lats, **TK), scattered_bicubic(g, lons, lats, fallback="never"))


@pytest.mark.parametrize("masked", [False, True])
def test_tiled_kriging_matches_scattered(masked):
    _, g = _grids(masked)
    lons, lats = _queries()
    _check(tt.tiled_kriging(g, lons, lats, window_radius=2, **TK), scattered_kriging(g, lons, lats, max_radius=2),
           atol=0.05)


@pytest.mark.parametrize("masked", [False, True])
def test_tiled_idw_matches_scattered(masked):
    _, g = _grids(masked)
    lons, lats = _queries()
    _check(tt.tiled_idw(g, lons, lats, k=8, window_radius=2, **TK), scattered_idw(g, lons, lats, k=8, max_radius=2),
           atol=0.01)


@pytest.mark.parametrize("masked", [False, True], ids=["valid", "masked"])
@pytest.mark.parametrize("op", list(OPS))
def test_tiled_matches_jax(op, masked):
    jg, g = _grids(masked)
    lons, lats = _queries()
    ours, theirs = OPS[op]
    _close_to_jax(ours(g, lons, lats, **TK), theirs(jg, lons, lats, **TK))


@pytest.mark.parametrize("op", list(OPS))
def test_tiled_oob_queries_nan(op):
    jg, g = _grids(False)
    lons = np.array([-1.0, 5.0, W + 1.0, 7.25, 64.0], np.float32)
    lats = np.array([5.0, 5.0, 5.0, H + 0.5, H - 1.0], np.float32)
    out = OPS[op][0](g, lons, lats, **TK).numpy()
    assert np.isnan(out[[0, 2, 3]]).all() and np.isfinite(out[[1, 4]]).all()
    _close_to_jax(torch.from_numpy(out), OPS[op][1](jg, lons, lats, **TK))


def test_partition_once_serves_a_changed_grid():
    _, g = _grids(True)
    lons, lats = _queries(n=500, seed=7)
    tb = tt.tiled_partition(g, lons, lats, anchor="round", **TK)
    g2 = type(g)(g.elev + 3.0, g.valid, g.min_lon, g.max_lon, g.min_lat, g.max_lat)
    got = tt.tiled_idw_run(g2, tb, k=8)  # the partition holds its tile and block size
    assert torch.equal(torch.isnan(got), torch.isnan(tt.tiled_idw(g2, lons, lats, k=8, **TK)))
    np.testing.assert_array_equal(got.numpy(), tt.tiled_idw(g2, lons, lats, k=8, **TK).numpy())


def test_stencil_epilogues_equal_jax():
    rng = np.random.default_rng(2)
    n = 400
    x = rng.uniform(0, 50, n).astype(np.float32)
    y = rng.uniform(0, 40, n).astype(np.float32)
    oob = rng.random(n) < 0.05
    for width, ours, theirs in ((4, tpacks.bilinear_from_stencil, jpacks.bilinear_from_stencil),
                                (16, tpacks.bicubic_from_stencil, jpacks.bicubic_from_stencil)):
        st = rng.normal(-1000.0, 50.0, (n, width)).astype(np.float32)
        st[rng.random((n, width)) < 0.1] = np.nan
        got = ours(torch.from_numpy(st), torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(oob))
        _close_to_jax(got, theirs(jnp.asarray(st), jnp.asarray(x), jnp.asarray(y), jnp.asarray(oob)))
    st = rng.normal(-1000.0, 50.0, (n, 25)).astype(np.float32)
    st[rng.random((n, 25)) < 0.3] = np.nan
    ci = np.floor(x + 0.5).astype(np.int32)
    cj = np.floor(y + 0.5).astype(np.int32)
    got = tpacks.window_select_from_stencil(torch.from_numpy(st), torch.from_numpy(x), torch.from_numpy(y),
                                            torch.from_numpy(oob), torch.from_numpy(ci), torch.from_numpy(cj),
                                            k=4, window_radius=2)
    want = jpacks.window_select_from_stencil(jnp.asarray(st), jnp.asarray(x), jnp.asarray(y), jnp.asarray(oob),
                                             jnp.asarray(ci), jnp.asarray(cj), k=4, window_radius=2)
    for key in ("found", "slot_ok", "val", "dx", "dy"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got["d2"].numpy(), np.asarray(want["d2"]), rtol=1e-6)
