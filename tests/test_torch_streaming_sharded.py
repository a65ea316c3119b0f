"""The port's sharded streaming mosaics (``ShardedStreamingInterpolator``
on four row bands, ``ShardedStreamingInterpolator2D`` on a (2, 2) mesh) on
four gloo ranks on the CPU, held two ways:

- bit for bit against the port's one-device ``StreamingInterpolator`` fed
  the same stream: the snapshot, every window (band interiors and
  boundaries, the mosaic's corners, the padded last band), the uncertainty
  and the window after a fit with the parameters aligned, and the
  checkpoint round trip (either class loads the other's file);
- against the JAX package's sharded classes on the 8-device virtual mesh:
  the mosaic bit for bit, windows at the bars of tests/test_torch_streaming.py
  (idw rtol 1e-5 / atol 1e-3, kriging and its variance rtol 1e-4 / atol
  0.05).

The fit adds the blocks' float64 pair sums and rounds them once, as the
one-device sums are taken: its parameters equal the one-device fit of the
same sums (30 Gauss-Newton steps, as the JAX package's sharded fit); against
the one-device class's own fit (25 steps) and the JAX package's sharded one
(whose blocks' float32 sums reassociate) it is held through the fitted
gamma at the bin lags, rtol 3e-4 and 1e-3 (tests/test_torch_variogram.py).

An observation in a negative row is dropped by both packages' sharded
classes (each block keeps only the rows it owns), where the one-device
class counts a negative flat index from the end of the mosaic.

The ranks start once for the module; the tests are asserts over their
results.  JAX is imported inside the tests, not by the ranks.
"""

import os

import numpy as np
import pytest
import torch

from auvtpu_torch.config import Extent
from auvtpu_torch.parallel.launch import spawn
from auvtpu_torch.streaming import StreamingInterpolator

torch.set_num_threads(1)

N_RANKS = 4
CENTERS = {"1d": [(10, 10), (54, 32), (53, 0), (107, 63), (0, 5)],
           "2d": [(18, 26), (0, 0), (36, 52), (3, 51)]}
# tests/test_streaming_sharded.py's and tests/test_streaming_sharded2d.py's mosaics
SHAPES = {"1d": (108, 64), "2d": (37, 53)}
OPTS = {"1d": dict(swath_cap=128, stage_slots=2, window=(32, 48), max_radius=5, k=4),
        "2d": dict(swath_cap=64, stage_slots=2, window=(16, 16), max_radius=5, k=4)}
METHODS = {"1d": ("idw", "kriging"), "2d": ("kriging",)}
BARS = {"idw": (1e-5, 1e-3), "kriging": (1e-4, 0.05)}
LAG = dict(max_lag=5, n_bins=5)


def _ext(kind):
    H, W = SHAPES[kind]
    return Extent(0.0, float(W - 1), 0.0, float(H - 1))


def _stream(kind):
    """The observation batches, duplicate cells included (several flushes
    of a small mosaic force same-cell collisions)."""
    H, W = SHAPES[kind]
    if kind == "1d":
        rng = np.random.default_rng(0)
        return [(rng.integers(0, H, 300), rng.integers(0, W, 300), rng.normal(-2000.0, 100.0, 300).astype(np.float32))
                for _ in range(5)]
    rng = np.random.RandomState(11)
    return [(rng.randint(0, H, 120), rng.randint(0, W, 120), rng.normal(-3000.0, 80.0, 120).astype(np.float32))
            for _ in range(3)]


def _stray():
    """Observations in rows -1 and H, and in a good row."""
    H, W = SHAPES["1d"]
    return np.array([-1, -1, H, 5]), np.array([3, 60, 7, 9]), np.array([-1.0, -2.0, -3.0, -4.0], np.float32)


def _run(si, kind, method, tmp):
    """Feed ``si`` the stream, read every surface; returns host arrays."""
    out = {}
    for batch in _stream(kind):
        si.ingest(*batch)
    out["snapshot"] = si.snapshot()
    out["windows"] = []
    for c in CENTERS[kind]:
        tile, origin = si.window_fill(*c)
        out["windows"].append((tile.numpy(), origin))
    if method == "kriging":
        out["vparams"] = [float(v) for v in si.fit_variogram(**LAG)]
        out["uncertainty"] = si.window_uncertainty(*CENTERS[kind][0])[0].numpy()
        out["after fit"] = si.window_fill(*CENTERS[kind][0])[0].numpy()
    path = os.path.join(tmp, f"{kind}_{method}.npz")
    si.save(path)
    out["path"] = path
    return out


def _scenarios(tmp):
    from auvtpu_torch.parallel import ShardedStreamingInterpolator, ShardedStreamingInterpolator2D
    from auvtpu_torch.parallel import make_mesh, make_mesh2d

    mesh, mesh2 = make_mesh(device="cpu"), make_mesh2d((2, 2), device="cpu")
    classes = {"1d": (ShardedStreamingInterpolator, mesh), "2d": (ShardedStreamingInterpolator2D, mesh2)}
    out = {}
    for kind, (cls, m) in classes.items():
        for method in METHODS[kind]:
            si = cls(SHAPES[kind], _ext(kind), m, method=method, **OPTS[kind])
            out[(kind, method)] = r = _run(si, kind, method, tmp)
            # resume on the other layout: the same mosaic, the same windows
            other_cls, other = classes["2d" if kind == "1d" else "1d"]
            back = other_cls.load(r["path"], other)
            r["resumed snapshot"] = back.snapshot()
            r["resumed window"] = back.window_fill(*CENTERS[kind][1])[0].numpy()
            r["blocks"] = tuple(si.elev.shape)
    for kind, (cls, m) in classes.items():
        si = cls(SHAPES["1d"], _ext("1d"), m, **OPTS["1d"])
        si.ingest(*_stray())
        out[("stray", kind)] = si.snapshot()
    return out


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharded_stream"))


@pytest.fixture(scope="module")
def ranks(tmp):
    return spawn(_scenarios, N_RANKS, tmp, device="cpu", timeout=240.0)


def _one_device(kind, method):
    si = StreamingInterpolator(SHAPES[kind], _ext(kind), method=method, device="cpu", **OPTS[kind])
    for batch in _stream(kind):
        si.ingest(*batch)
    return si


def _jax_sharded(kind, method):
    from auvtpu.config import Extent as JExtent
    from auvtpu.parallel import ShardedStreamingInterpolator, ShardedStreamingInterpolator2D, make_mesh, make_mesh2d

    e = _ext(kind)
    ext = JExtent(e.min_lon, e.max_lon, e.min_lat, e.max_lat)
    if kind == "1d":
        si = ShardedStreamingInterpolator(SHAPES[kind], ext, make_mesh(8), method=method, **OPTS[kind])
    else:
        si = ShardedStreamingInterpolator2D(SHAPES[kind], ext, make_mesh2d((4, 2)), method=method, **OPTS[kind])
    for batch in _stream(kind):
        si.ingest(*batch)
    return si


def _same(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert np.array_equal(got[ok].view(np.uint8), want[ok].view(np.uint8))


def _close(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


def _gamma(params):
    from auvtpu_torch.variogram import _bin_table, variogram_model

    centers = _bin_table(**LAG)[3]
    return variogram_model(torch.from_numpy(centers), tuple(float(p) for p in params)).numpy()


CASES = [(k, m) for k in ("1d", "2d") for m in METHODS[k]]


def test_blocks_are_sharded(ranks):
    # 108 rows over 4 bands (27 each); 37x53 over (2, 2) blocks of 19x27
    assert [r[("1d", "idw")]["blocks"] for r in ranks] == [(27, 64)] * N_RANKS
    assert [r[("2d", "kriging")]["blocks"] for r in ranks] == [(19, 27)] * N_RANKS


@pytest.mark.parametrize("kind,method", CASES)
def test_every_rank_reads_the_same(ranks, kind, method):
    for r in ranks[1:]:
        _same(r[(kind, method)]["snapshot"], ranks[0][(kind, method)]["snapshot"])
        for (a, oa), (b, ob) in zip(r[(kind, method)]["windows"], ranks[0][(kind, method)]["windows"]):
            assert oa == ob
            _same(a, b)


@pytest.mark.parametrize("kind,method", CASES)
def test_planes_and_windows_bit_equal_to_one_device(ranks, kind, method):
    got = ranks[0][(kind, method)]
    one = _one_device(kind, method)
    _same(got["snapshot"], one.snapshot())
    for (tile, origin), c in zip(got["windows"], CENTERS[kind]):
        want, want_origin = one.window_fill(*c)
        assert origin == want_origin
        _same(tile, want.numpy())


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_fit_and_uncertainty_against_one_device(ranks, kind):
    from auvtpu_torch.variogram import empirical_variogram, fit_exponential

    got = ranks[0][(kind, "kriging")]
    one = _one_device(kind, "kriging")
    # the blocks' float64 pair sums, added and rounded once, are the
    # one-device sums: the fit (30 Gauss-Newton steps, the JAX package's
    # sharded fit) is the one-device fit of the same sums
    g = one.grid()
    lags, gamma, counts = empirical_variogram(g, **LAG)
    step = 0.5 * (abs(g.lat_step) + abs(g.lon_step))
    assert got["vparams"] == [float(v) for v in fit_exponential(lags * step, gamma, counts)]
    one_vp = one.fit_variogram(**LAG)  # 25 steps
    np.testing.assert_allclose(_gamma(got["vparams"]), _gamma(one_vp), rtol=3e-4)
    # with the parameters aligned, the fill path is the one-device one
    one._vparams = tuple(torch.tensor(v) for v in got["vparams"])
    c = CENTERS[kind][0]
    _same(got["uncertainty"], one.window_uncertainty(*c)[0].numpy())
    _same(got["after fit"], one.window_fill(*c)[0].numpy())


@pytest.mark.parametrize("kind,method", CASES)
def test_checkpoint_round_trip(ranks, kind, method):
    got = ranks[0][(kind, method)]
    one = _one_device(kind, method)
    # the sharded checkpoint is the one-device class's format
    back = StreamingInterpolator.load(got["path"], device="cpu")
    _same(back.snapshot(), one.snapshot())
    assert back.window == one.window and back.method == method
    if method == "kriging":
        assert [float(v) for v in back._vparams] == got["vparams"]
        one._vparams = back._vparams
    # resumed on the other mesh layout, the mosaic and its windows stay
    _same(got["resumed snapshot"], one.snapshot())
    _same(got["resumed window"], one.window_fill(*CENTERS[kind][1])[0].numpy())


@pytest.mark.parametrize("kind,method", CASES)
def test_matches_jax_sharded_class(ranks, kind, method):
    got = ranks[0][(kind, method)]
    j = _jax_sharded(kind, method)
    np.testing.assert_array_equal(got["snapshot"], j.snapshot())
    for (tile, origin), c in zip(got["windows"], CENTERS[kind]):
        want, want_origin = j.window_fill(*c)
        assert origin == want_origin
        _close(tile, want, *BARS[method])


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_fit_and_uncertainty_match_jax_sharded_class(ranks, kind):
    import jax.numpy as jnp

    got = ranks[0][(kind, "kriging")]
    j = _jax_sharded(kind, "kriging")
    np.testing.assert_allclose(_gamma(got["vparams"]), _gamma(j.fit_variogram(**LAG)), rtol=1e-3)
    j._vparams = tuple(jnp.asarray(v, jnp.float32) for v in got["vparams"])
    _close(got["uncertainty"], j.window_uncertainty(*CENTERS[kind][0])[0], *BARS["kriging"])


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_rows_outside_the_mosaic_are_dropped_as_jax_drops_them(ranks, kind):
    from auvtpu.config import Extent as JExtent
    from auvtpu.parallel import ShardedStreamingInterpolator, ShardedStreamingInterpolator2D, make_mesh, make_mesh2d

    got = ranks[0][("stray", kind)]
    H, W = SHAPES["1d"]
    e = _ext("1d")
    jext = JExtent(e.min_lon, e.max_lon, e.min_lat, e.max_lat)
    j = (ShardedStreamingInterpolator(SHAPES["1d"], jext, make_mesh(8), **OPTS["1d"]) if kind == "1d" else
         ShardedStreamingInterpolator2D(SHAPES["1d"], jext, make_mesh2d((4, 2)), **OPTS["1d"]))
    j.ingest(*_stray())
    np.testing.assert_array_equal(got, j.snapshot())
    assert np.isfinite(got).sum() == 1 and got[5, 9] == np.float32(-4.0)
    # the one-device class counts row -1 from the end: the last row
    one = StreamingInterpolator(SHAPES["1d"], e, device="cpu", **OPTS["1d"])
    one.ingest(*_stray())
    snap = one.snapshot()
    assert snap[H - 1, 3] == np.float32(-1.0) and snap[H - 1, 60] == np.float32(-2.0)
