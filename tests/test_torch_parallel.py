"""The port's parallel layer (``auvtpu_torch.parallel``) on four gloo ranks
on the CPU, held two ways:

- bit for bit against the port's one-device result: the sharded fills, the
  2-D fills, the query shards and the sharded atlas; a sharded fill keeps
  each rank's band or block (``to_local()``, torch's chunk sizes, the last
  band cropped) and ``full_tensor()`` gathers the plane;
- against the JAX package's sharded functions on the 8-device virtual mesh
  (tests/conftest.py) at the bars of the port's one-device tests of the
  same fills: idw and mean rtol 1e-5 / atol 1e-3
  (tests/test_torch_dense_fills.py), kriging rtol 1e-4 / atol 0.05
  (tests/test_torch_slice.py), scattered IDW rtol 1e-5 / atol 1e-2
  (tests/test_torch_scattered.py), resampled depths rtol 1e-6 / atol 1e-4
  (tests/test_torch_band.py).

``sharded_fit_fill`` adds its bands' float64 pair sums and rounds them
once, as the one-device sums are taken: its fit equals the one-device fit
and its fill the one-device fill.  Against JAX (whose bands' float32 sums
reassociate) the fit is held through the fitted gamma at the bin lags, rtol
1e-3 (tests/test_torch_variogram.py).

The ranks start once for the module (``_scenarios`` runs every case and
returns host arrays); the tests are asserts over those results.  JAX is
imported inside the tests so that the ranks, which import this module, do
not load it.
"""

import numpy as np
import pytest
import torch

from auvtpu_torch.config import Extent
from auvtpu_torch.grid import RegularGrid
from auvtpu_torch.masking import mask_grid
from auvtpu_torch.parallel.launch import spawn
from auvtpu_torch.synthetic import shelf_seamount

torch.set_num_threads(1)

N_RANKS = 4
BARS = {"idw": (1e-5, 1e-3), "window_mean": (1e-5, 1e-3), "kriging": (1e-4, 0.05)}
KW = {"idw": dict(k=8), "window_mean": dict(k=4), "kriging": dict()}
# (H, W, removal, seed): tests/test_parallel.py's grids
GRIDS = {
    "g96": (96, 64, 0.15, 5),        # the masked grid of the 1-D and 2-D fill tests
    "pad91": (91, 64, 0.1, 6),       # rows not divisible by the mesh
    "short16": (16, 64, 0.3, 12),    # bands of 4 rows under a radius-10 halo
    "sweep93": (93, 47, 0.12, 9),    # the mesh-size sweep
    "small15": (15, 13, 0.15, 10),   # 2-D blocks under the radius in both axes
    "tiny9": (9, 13, 0.2, 13),       # four bands of 3 rows: the last one empty
}
CASES_1D = [("g96", m, 4) for m in ("idw", "window_mean", "kriging")] + [
    ("pad91", "idw", 4), ("short16", "idw", 4), ("short16", "kriging", 4),
    ("sweep93", "kriging", 2), ("sweep93", "kriging", 4),
]
CASES_2D = [("g96", m) for m in ("idw", "window_mean", "kriging")] + [("small15", "kriging")]
BAND_ONLY_1D = [("tiny9", "idw", 4)]


def _grid(name, device="cpu"):
    H, W, removal, seed = GRIDS[name]
    elev, _, _ = mask_grid(shelf_seamount(H, W), removal, seed=seed)
    return RegularGrid.from_nan_array(elev, Extent(0.0, float(W - 1), 0.0, float(H - 1)), device=device)


def _atlas_case():
    """tests/test_parallel.py's diagonal mission over a 192x384 grid,
    touching both corners (edge pages included)."""
    H, W = 192, 384
    reduced, _, _ = mask_grid(shelf_seamount(H, W), 0.12, seed=4)
    ext = Extent(0.0, float(W - 1), 0.0, float(H - 1))
    n = 4096
    t = np.linspace(0, 1, n)
    rng = np.random.default_rng(0)
    x = np.clip(1.0 + t * (W - 3) + rng.normal(0, 0.05, n), 0.5, W - 1.5)
    y = np.clip(1.0 + t * (H - 3) + 2 * np.sin(t * 20 * np.pi), 0.5, H - 1.5)
    return reduced, ext, x, y


def _queries():
    r = np.random.RandomState(11)
    H, W = GRIDS["g96"][:2]
    return r.uniform(0, W - 1, 1003).astype(np.float32), r.uniform(0, H - 1, 1003).astype(np.float32)


def _scenarios():
    """Every case on this rank; returns {case: host result}."""
    from auvtpu_torch.ops import scattered_idw
    from auvtpu_torch.ops.band import plan_segments
    from auvtpu_torch.parallel import (build_atlas_sharded, gather_queries, make_mesh, make_mesh2d, replicated,
                                       shard_queries, sharded_fill, sharded_fill2d, sharded_fit_fill)

    out = {}
    meshes = {n: make_mesh(n, device="cpu") for n in (2, N_RANKS)}
    out["replicated"] = replicated(meshes[N_RANKS], np.full(3, float(meshes[N_RANKS].index))).tolist()
    for name, method, n in CASES_1D + BAND_ONLY_1D:
        if meshes[n].member:
            p = sharded_fill(meshes[n], _grid(name), method, max_radius=10, **KW[method])
            out[("1d", name, method, n)] = p.full_tensor().numpy()
            out[("1d local", name, method, n)] = (tuple(p.shape), p.to_local().numpy())
    if not meshes[2].member:
        try:
            sharded_fill(meshes[2], _grid("g96"), "idw")
        except ValueError as e:
            out["non-member"] = str(e)
    mesh2 = make_mesh2d((2, 2), device="cpu")
    out["mesh2 coords"] = mesh2.coords
    for name, method in CASES_2D:
        p = sharded_fill2d(mesh2, _grid(name), method, max_radius=10, **KW[method])
        out[("2d", name, method)] = p.full_tensor().numpy()
        out[("2d local", name, method)] = (tuple(p.shape), p.to_local().numpy())
    plane, vp = sharded_fit_fill(meshes[N_RANKS], _grid("g96"), max_radius=5)
    out["fit_fill"] = (plane.full_tensor().numpy(), [float(v) for v in vp])
    out[("fit_fill local",)] = (tuple(plane.shape), plane.to_local().numpy())
    lons, lats = _queries()
    (slon, slat), n_valid = shard_queries(meshes[N_RANKS], lons, lats)
    out["queries local"] = slon.shape[0]
    out["queries"] = gather_queries(meshes[N_RANKS], scattered_idw(_grid("g96"), slon, slat), n_valid).numpy()
    reduced, ext, x, y = _atlas_case()
    grid = RegularGrid.from_nan_array(reduced, ext, device="cpu")
    segs = plan_segments(x, y, chunk=256, max_bands=6, grid_shape=grid.shape)
    atlas = build_atlas_sharded(grid, segs, make_mesh(N_RANKS, axis="pages", device="cpu"))
    out["atlas"] = (atlas.planes.numpy(), atlas.vmasks.numpy(), atlas.masked, atlas.placed, len(segs))
    return out


@pytest.fixture(scope="module")
def ranks():
    return spawn(_scenarios, N_RANKS, device="cpu", timeout=240.0)


def _same(got, want):
    """Bit-equal planes (NaN where NaN)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(got.view(np.int32)[~np.isnan(want)], want.view(np.int32)[~np.isnan(want)])


def _close(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


def _one_device(method, g):
    from auvtpu_torch.ops import fill_idw, fill_kriging, fill_window_mean

    return {"idw": lambda: fill_idw(g, k=8), "window_mean": lambda: fill_window_mean(g, k=4),
            "kriging": lambda: fill_kriging(g)}[method]().numpy()


def _jax_grid(name):
    from auvtpu.config import Extent as JExtent
    from auvtpu.grid import RegularGrid as JGrid
    from auvtpu.masking import mask_grid as j_mask_grid
    from auvtpu.synthetic import shelf_seamount as j_shelf

    H, W, removal, seed = GRIDS[name]
    elev, _, _ = j_mask_grid(j_shelf(H, W), removal, seed=seed)
    return JGrid.from_nan_array(elev, JExtent(0.0, float(W - 1), 0.0, float(H - 1)))


def test_every_rank_returns_the_same_planes(ranks):
    for r in ranks[1:]:
        for key in [k for k in ranks[0] if isinstance(k, tuple) and k in r and "local" not in k[0]]:
            _same(r[key], ranks[0][key])
        _same(r["fit_fill"][0], ranks[0]["fit_fill"][0])
        assert r["fit_fill"][1] == ranks[0]["fit_fill"][1]
        _same(r["atlas"][0], ranks[0]["atlas"][0])


def test_a_mesh_of_two_leaves_the_other_ranks_out(ranks):
    assert all(("1d", "sweep93", "kriging", 2) in r for r in ranks[:2])
    assert all(("1d", "sweep93", "kriging", 2) not in r for r in ranks[2:])
    assert all("not in the mesh" in r["non-member"] for r in ranks[2:])
    assert [r["mesh2 coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["replicated"] for r in ranks] == [[0.0] * 3] * N_RANKS  # the first rank's value everywhere


@pytest.mark.parametrize("name,method,n", CASES_1D)
def test_sharded_fill_bit_equal_to_one_device(ranks, name, method, n):
    _same(ranks[0][("1d", name, method, n)], _one_device(method, _grid(name)))


@pytest.mark.parametrize("name,method", CASES_2D)
def test_sharded_fill2d_bit_equal_to_one_device(ranks, name, method):
    _same(ranks[0][("2d", name, method)], _one_device(method, _grid(name)))


def _own_part(plane, index, n_rows, n_cols=1):
    """The part of ``plane`` that mesh member ``index`` of an (n_rows,
    n_cols) mesh holds: ceil-sized bands and blocks, cropped at the edge."""
    H, W = plane.shape
    br, bc = -(-H // n_rows), -(-W // n_cols)
    iy, ix = divmod(index, n_cols)
    return plane[iy * br:(iy + 1) * br, ix * bc:(ix + 1) * bc]


@pytest.mark.parametrize("case", [("1d local", *c) for c in CASES_1D + BAND_ONLY_1D] + [
    ("2d local", *c) for c in CASES_2D] + [("fit_fill local",)], ids=lambda c: "-".join(map(str, c)))
def test_each_rank_holds_only_its_band(ranks, case):
    mesh_shape = (2, 2) if case[0] == "2d local" else (case[3] if case[0] == "1d local" else N_RANKS, 1)
    name = case[1] if len(case) > 1 else "g96"
    if case[0] == "fit_fill local":
        from auvtpu_torch.ops import fill_kriging

        whole = fill_kriging(_grid(name), max_radius=5, vparams=tuple(ranks[0]["fit_fill"][1])).numpy()
    else:
        whole = _one_device(case[2], _grid(name))
    held = [r[case] for r in ranks if case in r]
    assert len(held) == mesh_shape[0] * mesh_shape[1]
    for index, (shape, local) in enumerate(held):
        assert shape == whole.shape
        want = _own_part(whole, index, *mesh_shape)
        assert local.shape == want.shape and local.shape[0] <= -(-whole.shape[0] // mesh_shape[0])
        _same(local, want)
    if case[1:2] == ("tiny9",):
        assert [local.shape[0] for _, local in held] == [3, 3, 3, 0]


@pytest.mark.parametrize("name,method,n", [c for c in CASES_1D if c[0] != "sweep93" or c[2] == 4])
def test_sharded_fill_matches_jax_sharded_fill(ranks, name, method, n):
    from auvtpu.parallel import make_mesh as j_make_mesh
    from auvtpu.parallel import sharded_fill as j_sharded_fill

    want = np.asarray(j_sharded_fill(j_make_mesh(), _jax_grid(name), method, max_radius=10, **KW[method]))
    _close(ranks[0][("1d", name, method, n)], want, *BARS[method])


@pytest.mark.parametrize("name,method", [("g96", "kriging"), ("small15", "kriging")])
def test_sharded_fill2d_matches_jax_sharded_fill2d(ranks, name, method):
    from auvtpu.parallel import make_mesh2d as j_make_mesh2d
    from auvtpu.parallel import sharded_fill2d as j_sharded_fill2d

    want = np.asarray(j_sharded_fill2d(j_make_mesh2d((4, 2)), _jax_grid(name), method, max_radius=10))
    _close(ranks[0][("2d", name, method)], want, *BARS[method])


def _gamma(params, max_lag=10, n_bins=10):
    from auvtpu_torch.variogram import _bin_table, variogram_model

    _, _, _, centers = _bin_table(max_lag, n_bins)
    return variogram_model(torch.from_numpy(centers), tuple(float(p) for p in params)).numpy()


def test_sharded_fit_fill_against_one_device(ranks):
    from auvtpu_torch.ops import fill_kriging
    from auvtpu_torch.variogram import empirical_variogram, fit_exponential

    plane, vp = ranks[0]["fit_fill"]
    g = _grid("g96")
    lags, gamma, counts = empirical_variogram(g)
    one = fit_exponential(lags * 0.5 * (abs(g.lat_step) + abs(g.lon_step)), gamma, counts)
    # the bands' float64 pair sums, added and rounded once, are the
    # one-device sums: the fit (30 Gauss-Newton steps, as the JAX package's
    # sharded fit takes) is the one-device fit, and so is the fill
    assert vp == [float(p) for p in one]
    _same(plane, fill_kriging(g, max_radius=5, vparams=one).numpy())
    gaps = g.valid.numpy() < 0.5
    assert np.isfinite(plane[gaps]).mean() > 0.99


def test_sharded_fit_fill_matches_jax_sharded_fit_fill(ranks):
    from auvtpu.ops import fill_kriging as j_fill_kriging
    from auvtpu.parallel import make_mesh as j_make_mesh
    from auvtpu.parallel import sharded_fit_fill as j_sharded_fit_fill

    plane, vp = ranks[0]["fit_fill"]
    jg = _jax_grid("g96")
    jplane, jvp = j_sharded_fit_fill(j_make_mesh(), jg, max_radius=5)
    np.testing.assert_allclose(_gamma(vp), _gamma(jvp), rtol=1e-3)
    # each parameter set's fill (tests/test_torch_variogram.py's bar), and
    # the port's plane at the kriging bar from the fill of its parameters
    a = np.asarray(jplane)
    b = np.asarray(j_fill_kriging(jg, max_radius=5, vparams=tuple(vp)))
    _close(b, a, 0.0, 0.05)
    _close(plane, b, *BARS["kriging"])


def test_shard_queries_bit_equal_and_matches_jax(ranks):
    from auvtpu.ops import scattered_idw as j_scattered_idw
    from auvtpu.parallel import make_mesh as j_make_mesh
    from auvtpu.parallel import shard_queries as j_shard_queries

    from auvtpu_torch.ops import scattered_idw

    lons, lats = _queries()
    assert [r["queries local"] for r in ranks] == [251] * N_RANKS  # 1003 padded to 1004
    got = ranks[0]["queries"]
    _same(got, scattered_idw(_grid("g96"), torch.from_numpy(lons), torch.from_numpy(lats)).numpy())
    (slon, slat), n_valid = j_shard_queries(j_make_mesh(), lons, lats)
    want = np.asarray(j_scattered_idw(_jax_grid("g96"), slon, slat))[:n_valid]
    _close(got, want, 1e-5, 1e-2)


def test_sharded_atlas_bit_equal_and_serves_as_one_device(ranks):
    from auvtpu_torch.ops.band import AtlasResampler, BandAtlas, build_atlas, plan_segments

    planes, vmasks, masked, placed, n_segs = ranks[0]["atlas"]
    reduced, ext, x, y = _atlas_case()
    grid = RegularGrid.from_nan_array(reduced, ext, device="cpu")
    segs = plan_segments(x, y, chunk=256, max_bands=6, grid_shape=grid.shape)
    ref = build_atlas(grid, segs)
    # pages within the margin of the top and left edges, and at the bottom
    # and right edges: their fill windows are shifted inside the grid
    _, pr, pc = planes.shape
    assert n_segs == len(segs) > 1
    assert min(r for r, _ in placed) < 10 and max(r for r, _ in placed) + pr == 192
    assert min(c for _, c in placed) < 10 and max(c for _, c in placed) + pc == 384
    assert masked == ref.masked and placed == ref.placed
    _same(planes, ref.planes.numpy())
    _same(vmasks, ref.vmasks.numpy())
    got = BandAtlas(planes=torch.from_numpy(planes), vmasks=torch.from_numpy(vmasks), origins=ref.origins,
                    masked=masked, placed=placed)
    lon = ext.min_lon + x * grid.lon_step
    lat = ext.min_lat + y * grid.lat_step
    z, ok = AtlasResampler(grid, got, chunk=256).resample(lon, lat)
    zr, okr = AtlasResampler(grid, ref, chunk=256).resample(lon, lat)
    assert torch.equal(ok, okr) and torch.equal(z[ok], zr[okr])


def test_sharded_atlas_matches_jax_sharded_atlas(ranks):
    from auvtpu.config import Extent as JExtent
    from auvtpu.grid import RegularGrid as JGrid
    from auvtpu.ops.band import plan_segments as j_plan_segments
    from auvtpu.parallel import build_atlas_sharded as j_build_atlas_sharded
    from auvtpu.parallel import make_mesh as j_make_mesh

    planes, vmasks, masked, placed, _ = ranks[0]["atlas"]
    reduced, ext, x, y = _atlas_case()
    jg = JGrid.from_nan_array(reduced, JExtent(ext.min_lon, ext.max_lon, ext.min_lat, ext.max_lat))
    segs = j_plan_segments(x, y, chunk=256, max_bands=6, grid_shape=jg.shape)
    want = j_build_atlas_sharded(jg, segs, j_make_mesh(8, axis="pages"), fill_backend="xla")
    assert placed == tuple(want.placed) and masked == want.masked
    np.testing.assert_array_equal(vmasks, np.asarray(want.vmasks))
    _close(planes, np.asarray(want.planes), *BARS["kriging"])


def test_build_atlas_sharded_rejects_what_jax_rejects():
    from auvtpu_torch.parallel import build_atlas_sharded, make_mesh, make_mesh2d

    g = _grid("g96")
    segs = [(0, 0, 16, 64)]
    with pytest.raises(ValueError, match="margin"):
        build_atlas_sharded(g, segs, make_mesh(device="cpu"), margin=5)
    with pytest.raises(ValueError, match="1-D mesh"):
        build_atlas_sharded(g, segs, make_mesh2d((1, 1), device="cpu"))


def test_one_rank_mesh_needs_no_process_group():
    from auvtpu_torch.parallel import make_mesh, make_mesh2d, sharded_fill, sharded_fill2d

    g = _grid("small15")
    want = _one_device("kriging", g)
    mesh, mesh2 = make_mesh(device="cpu"), make_mesh2d(device="cpu")
    assert (mesh.shape, mesh2.shape, mesh.transport) == ((1,), (1, 1), "none")
    _same(sharded_fill(mesh, g, "kriging").full_tensor().numpy(), want)
    _same(sharded_fill2d(mesh2, g, "kriging").to_local().numpy(), want)


def test_pair_sums_2d_matches_jax_and_counts_each_pair_once():
    import jax.numpy as jnp
    from auvtpu.variogram import pair_sums_2d as j_pair_sums_2d

    from auvtpu_torch.variogram import pair_sums, pair_sums_2d

    g = _grid("small15")
    e, v = g.elev, g.valid
    L, H, W = 4, *g.shape
    # the global plane padded so every block's halo is a slice of it
    pe = torch.nn.functional.pad(e, (L, L + 1, 0, L + 1))
    pv = torch.nn.functional.pad(v, (L, L + 1, 0, L + 1))
    s_sum, c_sum = torch.zeros(4, dtype=torch.float64), torch.zeros(4, dtype=torch.float64)
    for r0, nr in ((0, 8), (8, 7)):
        for c0, nc in ((0, 7), (7, 6)):
            be, bv = pe[r0:r0 + nr + L, c0:c0 + nc + 2 * L], pv[r0:r0 + nr + L, c0:c0 + nc + 2 * L]
            s, c = pair_sums_2d(be, bv, nr, nc, max_lag=L, n_bins=4)
            js, jc = j_pair_sums_2d(jnp.asarray(be.numpy()), jnp.asarray(bv.numpy()), nr, nc, max_lag=L, n_bins=4)
            np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
            np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
            s_sum += s
            c_sum += c
    ws, wc = pair_sums(torch.nn.functional.pad(e, (0, 0, 0, L)), torch.nn.functional.pad(v, (0, 0, 0, L)), H,
                       max_lag=L, n_bins=4)
    np.testing.assert_array_equal(c_sum.numpy(), wc.numpy())
    np.testing.assert_allclose(s_sum.numpy(), ws.numpy(), rtol=1e-5)


def test_dryrun_multichip_on_cpu():
    from auvtpu_torch import entry

    summary = entry.dryrun_multichip(N_RANKS, device="cpu")
    assert (summary["ranks"], summary["device"], summary["transport"]) == (N_RANKS, "cpu", "gloo")
    assert all(np.isfinite(summary["vparams"])) and summary["resolved"] > 0.5


def _fails_on_rank_one():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank one gives up")
    dist.barrier()  # never passes: rank 1 does not arrive


def test_a_failing_rank_fails_the_spawn_promptly():
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*rank one gives up"):
        spawn(_fails_on_rank_one, 2, device="cpu", timeout=60.0)
    assert time.monotonic() - t0 < 45.0
