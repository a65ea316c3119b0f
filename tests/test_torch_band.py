"""The port's trajectory-band router (auvtpu_torch.ops.band, with the plain
version of the B8 resample kernel) against the JAX package's, on the CPU at
small sizes.

Bars: the resolved mask ``ok`` exactly equal and resampled values within
rtol=1e-6, atol=1e-4 (tests/test_band.py:118: the JAX contractions may pair
a multiply-add into one FMA); the 'aligned' geometry the same against the
Pallas kernel in interpret mode; band fills with vmask and masked equal and
the plane at the fill tests' bars (kriging rtol 1e-4 / atol 0.05, IDW 1e-5 /
1e-3); geometry, planning, window sizes, coherence and routing (under the
JAX package's COST_NS) exactly equal; served depths at the two-tier bars of
tests/test_torch_two_tier.py (kriging 1e-4 / 0.1, IDW 1e-4 / 0.05).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from auvtpu.config import Extent as JExtent
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import band as jb
from auvtpu.pallas.band_resample import pallas_atlas_resample, pallas_band_resample
from auvtpu.synthetic import shelf_seamount

from auvtpu_torch.convert import grid_from_arrays
from auvtpu_torch.kernels import band_resample as kb
from auvtpu_torch.ops import band as tb

torch.set_num_threads(1)

EXT = JExtent(-74.0, -70.0, 35.0, 38.0)
MODES = ["onehot", "hat", "hat2", "hat_t"]
BARS = {"kriging": (1e-4, 0.1), "idw": (1e-4, 0.05)}


def _pair(elev):
    """(JAX grid, port CPU grid) from one NaN-holed array."""
    jg = JGrid.from_nan_array(elev, EXT)
    g = grid_from_arrays(np.asarray(jg.elev), np.asarray(jg.valid), jg.min_lon, jg.max_lon, jg.min_lat, jg.max_lat, "cpu")
    return jg, g


def _masked_pair(H, W, removal, seed):
    return _pair(mask_grid(shelf_seamount(H, W), removal, seed=seed)[0])


def _dense_pair(H, W):
    return _pair(np.asarray(shelf_seamount(H, W), np.float64))


def _trajectory(H, W, n, seed=0, row_frac=0.35, row_width_frac=0.08):
    """The survey track of tests/test_band.py: a sinusoidal sweep inside a
    row band, advancing in lon (f32 lon/lat)."""
    t = np.linspace(0.0, 1.0, n)
    rng = np.random.default_rng(seed)
    x = np.clip(1.0 + t * (W - 3) + rng.normal(0, 0.05, n), 0.5, W - 1.5)
    y = np.clip(H * row_frac + H * row_width_frac * np.sin(t * 40 * np.pi) + rng.normal(0, 0.05, n), 0.5, H - 1.5)
    return _lonlat(H, W, x, y)


def _diagonal(H, W, n, seed=0, width=2.0):
    t = np.linspace(0.0, 1.0, n)
    rng = np.random.default_rng(seed)
    x = np.clip(1.0 + t * (W - 3) + rng.normal(0, 0.05, n), 0.5, W - 1.5)
    y = np.clip(1.0 + t * (H - 3) + width * np.sin(t * 20 * np.pi) + rng.normal(0, 0.05, n), 0.5, H - 1.5)
    return _lonlat(H, W, x, y)


def _lonlat(H, W, x, y):
    lon = EXT.min_lon + x * (EXT.max_lon - EXT.min_lon) / (W - 1)
    lat = EXT.min_lat + y * (EXT.max_lat - EXT.min_lat) / (H - 1)
    return lon.astype(np.float32), lat.astype(np.float32)


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _resampled_close(got, want, rtol=1e-6, atol=1e-4):
    (z, ok), (zj, okj) = [tuple(_np(a) for a in p) for p in (got, want)]
    np.testing.assert_array_equal(ok, okj)
    assert np.isnan(z[~ok]).all() and np.isfinite(z[ok]).all()
    np.testing.assert_allclose(z[ok], zj[ok], rtol=rtol, atol=atol)
    return ok


def _values_close(got, want, rtol, atol):
    got, want = _np(got), _np(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# small pure functions and f32 geometry
# ---------------------------------------------------------------------------

def test_effective_chunk_and_constants_match_jax():
    for n in (1, 100, 255, 256, 257, 512, 513, 2047, 2048, 4096, 5_000_000):
        for chunk in (64, 256, 512, 2048):
            assert tb._effective_chunk(n, chunk) == jb._effective_chunk(n, chunk)
    assert tb.LERP_MODE_DEFAULT == jb.LERP_MODE_DEFAULT == "hat"
    assert tb._LANES == jb._LANES
    assert set(tb.COST_NS) == set(jb.COST_NS)
    with pytest.raises(ValueError):
        tb._hat("cubic")


@pytest.mark.parametrize("shape", [(96, 160), (2053, 2441)], ids=["small", "standin"])
def test_xy_and_band_shift_bit_equal(shape):
    # lonlat -> grid frame -> band frame in f32, bit for bit as JAX computes
    # it, on a unit-ish extent and on the Kerguelen stand-in's extent
    from auvtpu.config import KERGUELEN_EXTENT

    H, W = shape
    ext = EXT if shape == (96, 160) else KERGUELEN_EXTENT
    jg = JGrid.dense(np.zeros((H, W), np.float32), ext)
    g = grid_from_arrays(np.zeros((H, W), np.float32), np.ones((H, W), np.float32), jg.min_lon, jg.max_lon, jg.min_lat, jg.max_lat, "cpu")
    rng = np.random.default_rng(5)
    lon = rng.uniform(ext.min_lon, ext.max_lon, 4000).astype(np.float32)
    lat = rng.uniform(ext.min_lat, ext.max_lat, 4000).astype(np.float32)
    x, y = tb._xy(g, lon, lat)
    jx, jy = jg.lonlat_to_xy(jnp.asarray(lon), jnp.asarray(lat))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal((x - 37).numpy(), np.asarray(jx - 37))
    org = torch.tensor([[3.0, 129.0]])
    np.testing.assert_array_equal((y - org[0, 0]).numpy(), np.asarray(jy - jnp.asarray(3.0, jnp.float32)))


@pytest.mark.parametrize("chunk", [64, 300, 512])
def test_trajectory_boxes_and_plan_match_jax(chunk):
    jg, g = _dense_pair(512, 640)
    lon, lat = _diagonal(512, 640, 8192 + 77)
    x, y = tb._xy(g, lon, lat)
    jx, jy = jg.lonlat_to_xy(jnp.asarray(lon), jnp.asarray(lat))
    boxes = tb._trajectory_boxes(x, y, chunk)
    np.testing.assert_array_equal(boxes, jb._trajectory_boxes(jx, jy, chunk))
    np.testing.assert_array_equal(tb._trajectory_boxes(x.numpy(), y.numpy(), chunk), boxes)
    for mb in (1, 3, 8):
        segs = tb.plan_segments(x, y, chunk=chunk, max_bands=mb, grid_shape=g.shape)
        assert segs == jb.plan_segments(jx, jy, chunk=chunk, max_bands=mb, grid_shape=jg.shape)
        assert tb.place_segments(segs, g.shape) == jb.place_segments(segs, jg.shape)


@pytest.mark.parametrize("lerp_mode", ["hat", "hat_t"])
@pytest.mark.parametrize("track", ["band", "diagonal"])
def test_bbox_windows_and_coherence_match_jax(track, lerp_mode):
    jg, g = _masked_pair(192, 256, 0.1, 4)
    lon, lat = (_trajectory(192, 256, 4096, row_width_frac=0.03) if track == "band"
                else _diagonal(192, 256, 4096))
    kw = dict(chunk=128, win_rows=48, win_cols=128, max_bands=6, lerp_mode=lerp_mode)
    r = tb.BandRouter(g, **kw)
    jr = jb.BandRouter(jg, fill_backend="xla", **kw)
    assert r.band_bbox(lon, lat) == jr.band_bbox(lon, lat)
    assert r.coherence(lon, lat) == jr.coherence(lon, lat)
    r.prepare(lon, lat, method="idw")
    jr.prepare(lon, lat, method="idw")
    assert (r._atlas is None) == (jr._atlas is None) == (track == "band")
    assert (r._resampler.wr, r._resampler.wc) == (jr._resampler.wr, jr._resampler.wc)
    if track == "band":
        assert (r._band.row0, r._band.col0, r._band.shape) == (jr._band.row0, jr._band.col0, tuple(jr._band.shape))
    else:
        assert r._atlas.placed == jr._atlas.placed and r._atlas.shape == tuple(jr._atlas.shape)
    for within in (False, True):
        assert r.coherence(lon, lat, within_footprint=within) == jr.coherence(lon, lat, within_footprint=within)


# ---------------------------------------------------------------------------
# fill_band
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["kriging", "idw"])
def test_fill_band_matches_jax(method):
    elev = mask_grid(shelf_seamount(96, 160), 0.2, seed=3)[0]
    lossy = elev.copy()
    lossy[:, 110:] = np.nan  # wider than the fill window: cells stay undefined
    rtol, atol = (1e-4, 0.05) if method == "kriging" else (1e-5, 1e-3)
    for arr, band in ((elev, (24, 32, 0, 128)), (lossy, (40, 24, 32, 128))):
        jg, g = _pair(arr)
        got = tb.fill_band(g, *band, method=method)
        want = jb.fill_band(jg, *band, method=method)
        assert got.masked == want.masked == (arr is lossy)
        assert (got.row0, got.col0, got.shape) == (want.row0, want.col0, tuple(want.shape))
        np.testing.assert_array_equal(got.vmask.numpy(), np.asarray(want.vmask))
        np.testing.assert_allclose(got.plane.numpy(), np.asarray(want.plane), rtol=rtol, atol=atol)
        pinned = tb.fill_band(g, *band, method=method, assume_masked=True)
        assert pinned.masked is True
    with pytest.raises(ValueError):
        tb.fill_band(g, 90, 16, 0, 128)


# ---------------------------------------------------------------------------
# the resample (plain version of B8) against the JAX XLA and Pallas paths
# ---------------------------------------------------------------------------

def _band_plane(masked):
    plane = np.asarray(shelf_seamount(48, 160), np.float32)
    vmask = np.ones_like(plane)
    if masked:
        vmask[20:22, 60:64] = 0.0
        plane[20:22, 60:64] = 0.0
    return plane, vmask


def _band_coords(n=1024, seed=0):
    """Band-frame f32 coordinates: a weave through the 48x160 plane, with
    queries left of and above the band (negative chunk minima) and x in
    [0, 0.5), where the two weight families differ."""
    t = np.linspace(0.0, 1.0, n)
    rng = np.random.default_rng(seed)
    x = 1.0 + t * 150 + rng.normal(0, 0.05, n)
    y = 24 + 16 * np.sin(t * 20 * np.pi) + rng.normal(0, 0.05, n)
    x[:40] = rng.uniform(-3.0, 0.5, 40)
    y[:40] = rng.uniform(-2.0, 6.0, 40)
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("lerp_mode", MODES)
@pytest.mark.parametrize("wr,wc", [(32, 128), (16, 8)])
def test_band_resample_matches_jax(lerp_mode, masked, wr, wc):
    plane, vmask = _band_plane(masked)
    x, y = _band_coords()
    kw = dict(chunk=64, wr=wr, wc=wc, masked=masked, lerp_mode=lerp_mode)
    got = tb._band_resample(torch.from_numpy(plane), torch.from_numpy(vmask), torch.from_numpy(x), torch.from_numpy(y), **kw)
    want = jb._band_resample(jnp.asarray(plane), jnp.asarray(vmask), jnp.asarray(x), jnp.asarray(y), **kw)
    ok = _resampled_close(got, want)
    assert ok.mean() > (0.5 if wc > 8 else 0.05)
    assert not ok[:40].all()  # the chunk left of the band resolves only in part


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("lerp_mode", MODES)
def test_atlas_resample_matches_jax(lerp_mode, masked):
    K, R, C = 3, 64, 256
    rng = np.random.default_rng(1)
    planes = rng.normal(0, 100, (K, R, C)).astype(np.float32)
    vmasks = np.ones_like(planes)
    if masked:
        vmasks[1, 20:30, 40:80] = 0.0
        planes[1, 20:30, 40:80] = 0.0
    origins = np.array([[0.0, 0.0], [64.0, 200.0], [128.0, 400.0]], np.float32)
    n = 1536
    t = np.linspace(0, 1, n)
    x = (2.0 + t * 600.0).astype(np.float32)
    y = (2.0 + t * 180.0 + 3 * np.sin(t * 25 * np.pi)).astype(np.float32)
    for pick in (True, False):
        kw = dict(chunk=128, wr=32, wc=128, masked=masked, pick=pick, lerp_mode=lerp_mode)
        got = tb._atlas_resample(*map(torch.from_numpy, (planes, vmasks, origins, x, y)), **kw)
        want = jb._atlas_resample(*map(jnp.asarray, (planes, vmasks, origins, x, y)), **kw)
        ok = _resampled_close(got, want)
        assert ok.mean() > (0.8 if pick else 0.1)


def test_weight_families_are_transcribed_literally():
    # on a plane whose columns are 0 and 1 the resample IS the column
    # weight: hat gives 1-(1-f), onehot f; they differ for some f in
    # [0, 0.5), and each equals its JAX build exactly
    plane = np.tile(np.array([0.0, 1.0] * 8, np.float32), (16, 1))
    vmask = np.ones_like(plane)
    rng = np.random.default_rng(2)
    x = rng.uniform(0.0, 0.5, 256).astype(np.float32)
    y = rng.uniform(0.0, 0.5, 256).astype(np.float32)
    out = {}
    for mode in ("onehot", "hat", "hat_t"):
        kw = dict(chunk=64, wr=8, wc=8, masked=False, lerp_mode=mode)
        z, ok = tb._band_resample(torch.from_numpy(plane), torch.from_numpy(vmask), torch.from_numpy(x), torch.from_numpy(y), **kw)
        zj, okj = jb._band_resample(jnp.asarray(plane), jnp.asarray(vmask), jnp.asarray(x), jnp.asarray(y), **kw)
        assert ok.all() and np.asarray(okj).all()
        np.testing.assert_array_equal(z.numpy(), np.asarray(zj))
        out[mode] = z.numpy()
    np.testing.assert_array_equal(out["onehot"], x)
    np.testing.assert_array_equal(out["hat"], out["hat_t"])
    assert (out["hat"] != out["onehot"]).any()


def _pad_last(a, chunk):
    """The JAX package's pad of a ragged last chunk with the last query."""
    pad = (-a.shape[0]) % chunk
    return jnp.concatenate([a, jnp.broadcast_to(a[-1], (pad,))]) if pad else a


@pytest.mark.parametrize("n", [1, 255, 1000, 4097])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("lerp_mode", ["onehot", "hat"])
def test_band_resample_ref_prologue_matches_jax(lerp_mode, masked, n):
    # the plain version on lon/lat through the prologue (x = (lon - min_lon)
    # / lon_step - col0) with a ragged last chunk, against JAX's
    # lonlat_to_xy, band shift, pad with the last query and _band_resample
    plane, vmask = _band_plane(masked)
    jg = JGrid.dense(np.zeros((96, 160), np.float32), EXT)
    g = grid_from_arrays(np.zeros((96, 160), np.float32), np.ones((96, 160), np.float32), jg.min_lon, jg.max_lon,
                         jg.min_lat, jg.max_lat, "cpu")
    x, y = (a[:n] for a in _band_coords(max(n, 1024)))
    lon, lat = _lonlat(96, 160, x.astype(np.float64), y.astype(np.float64) + 30.0)
    chunk = 64
    jx, jy = jg.lonlat_to_xy(jnp.asarray(lon), jnp.asarray(lat))
    kw = dict(chunk=chunk, wr=32, wc=128, masked=masked, lerp_mode=lerp_mode)
    zj, okj = jb._band_resample(jnp.asarray(plane), jnp.asarray(vmask), _pad_last(jx - 0, chunk),
                                _pad_last(jy - 30, chunk), **kw)
    p, vm = torch.from_numpy(plane), torch.from_numpy(vmask)
    got = kb.band_resample_ref(p[None], vm[None] if masked else None, None, torch.from_numpy(lon),
                               torch.from_numpy(lat), chunk=chunk, wr=32, wc=128, pick=False,
                               hat=lerp_mode != "onehot", affine=tb._affine(g, 0, 30))
    assert got[0].shape == got[1].shape == (n,)
    _resampled_close(got, (np.asarray(zj)[:n], np.asarray(okj)[:n]))
    # and bit for bit the torch prologue (_xy, the shift, the pad) followed by
    # the identity prologue
    tx, ty = tb._xy(g, lon, lat)
    tx, ty = tb._pad_to_chunk(tx - 0, ty - 30, chunk)
    z0, ok0 = kb.band_resample_ref(p[None], vm[None] if masked else None, None, tx, ty, chunk=chunk, wr=32, wc=128,
                                   pick=False, hat=lerp_mode != "onehot")
    assert torch.equal(got[1], ok0[:n]) and torch.equal(got[0][got[1]], z0[:n][got[1]])


@pytest.mark.parametrize("n", [1, 255, 1000, 1537])
def test_atlas_resample_ref_prologue_matches_jax(n):
    # grid-frame prologue (no shift), a ragged last chunk, the page pick
    K, R, C = 3, 64, 256
    rng = np.random.default_rng(1)
    planes = rng.normal(0, 100, (K, R, C)).astype(np.float32)
    origins = np.array([[0.0, 0.0], [64.0, 200.0], [128.0, 400.0]], np.float32)
    H, W = 200, 640
    jg = JGrid.dense(np.zeros((H, W), np.float32), EXT)
    g = grid_from_arrays(np.zeros((H, W), np.float32), np.ones((H, W), np.float32), jg.min_lon, jg.max_lon,
                         jg.min_lat, jg.max_lat, "cpu")
    t = np.linspace(0, 1, n)
    lon, lat = _lonlat(H, W, 2.0 + t * 600.0, 2.0 + t * 180.0 + 3 * np.sin(t * 25 * np.pi))
    chunk = 128
    jx, jy = jg.lonlat_to_xy(jnp.asarray(lon), jnp.asarray(lat))
    for lerp_mode in ("onehot", "hat"):
        zj, okj = jb._atlas_resample(jnp.asarray(planes), jnp.asarray(np.ones_like(planes)), jnp.asarray(origins),
                                     _pad_last(jx, chunk), _pad_last(jy, chunk), chunk=chunk, wr=32, wc=128,
                                     masked=False, pick=True, lerp_mode=lerp_mode)
        got = kb.band_resample_ref(torch.from_numpy(planes), None, torch.from_numpy(origins), torch.from_numpy(lon),
                                   torch.from_numpy(lat), chunk=chunk, wr=32, wc=128, pick=True,
                                   hat=lerp_mode != "onehot", affine=tb._affine(g))
        ok = _resampled_close(got, (np.asarray(zj)[:n], np.asarray(okj)[:n]))
        assert ok.shape == (n,)


@pytest.mark.parametrize("n", [1, 255, 513])
def test_resamplers_take_lonlat_at_any_n(n):
    # BandResampler/AtlasResampler at one query, a ragged 256-chunk and
    # chunk + 1, against the JAX package's resamplers
    jg, g = _dense_pair(96, 160)
    lon, lat = _trajectory(96, 160, n, row_frac=0.4, row_width_frac=0.05)
    jband = jb.fill_band(jg, 16, 48, 0, 160, method="idw")
    band = tb.Band(plane=torch.from_numpy(np.array(jband.plane)), vmask=torch.from_numpy(np.array(jband.vmask)),
                   masked=False, row0=16, col0=0)
    rs = tb.BandResampler(g, band, chunk=512, win_rows=32, win_cols=128)
    got = rs.resample(lon, lat)
    assert got[0].shape == (n,)
    _resampled_close(got, jb.BandResampler(jg, jband, chunk=512, win_rows=32, win_cols=128).resample(lon, lat))
    segs = [(16, 0, 48, 96), (16, 64, 48, 96)]
    jatlas = jb.build_atlas(jg, segs, method="idw")
    atlas = tb.BandAtlas(planes=torch.from_numpy(np.array(jatlas.planes)), vmasks=torch.from_numpy(np.array(jatlas.vmasks)),
                         origins=torch.from_numpy(np.array(jatlas.origins)), masked=bool(jatlas.masked))
    ra = tb.AtlasResampler(g, atlas, chunk=512, win_rows=32, win_cols=128)
    got = ra.resample(lon, lat)
    assert got[0].shape == (n,)
    _resampled_close(got, jb.AtlasResampler(jg, jatlas, chunk=512, win_rows=32, win_cols=128).resample(lon, lat))


def _interp():
    return pltpu.force_tpu_interpret_mode()


@pytest.mark.parametrize("wr,wc", [(48, 128), (20, 8)])
def test_aligned_geometry_matches_pallas_band(wr, wc):
    plane = np.asarray(shelf_seamount(120, 384), np.float32)
    R, C = plane.shape
    n, chunk = 2048, 256
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1, n)
    x = np.clip(1.0 + t * (C - 3) + rng.normal(0, 0.05, n), 0.5, C - 1.5).astype(np.float32)
    y = np.clip(R * 0.5 + 10 * np.sin(t * 30 * np.pi) + rng.normal(0, 0.05, n), 0.5, R - 1.5).astype(np.float32)
    x[:chunk] -= 5.0  # a chunk whose minimum lies left of the band
    with _interp():
        want = pallas_band_resample(jnp.asarray(plane), jnp.asarray(x), jnp.asarray(y), chunk=chunk, wr=wr, wc=wc)
    p = torch.from_numpy(plane)
    got = tb._band_resample(p, torch.ones_like(p), torch.from_numpy(x), torch.from_numpy(y), chunk=chunk, wr=wr,
                            wc=wc, masked=False, aligned=True)
    ok = _resampled_close(got, want)
    assert 0 < ok[:chunk].sum() < chunk  # negative minimum: floor-divided base, partly resolved


def test_aligned_geometry_matches_pallas_atlas():
    K, R, C = 3, 64, 256
    rng = np.random.default_rng(1)
    planes = rng.normal(0, 100, (K, R, C)).astype(np.float32)
    origins = np.array([[0.0, 0.0], [64.0, 200.0], [128.0, 400.0]], np.float32)
    n, chunk = 1536, 128
    t = np.linspace(0, 1, n)
    x = (2.0 + t * 600.0).astype(np.float32)
    y = (2.0 + t * 180.0 + 3 * np.sin(t * 25 * np.pi)).astype(np.float32)
    with _interp():
        want = pallas_atlas_resample(*map(jnp.asarray, (planes, origins, x, y)), chunk=chunk, wr=32, wc=128)
    pt = torch.from_numpy(planes)
    got = tb._atlas_resample(pt, torch.ones_like(pt), *map(torch.from_numpy, (origins, x, y)), chunk=chunk, wr=32,
                             wc=128, masked=False, aligned=True)
    assert _resampled_close(got, want).mean() > 0.8


def test_aligned_geometry_is_the_pallas_window():
    # (wrp, wcp) = (ceil8(wr)+8, ceil128(wc)+128), the base clamp to the
    # padded extent (band_resample.py:174-202)
    assert kb.geometry(120, 384, 48, 128, True) == (56, 256, 8, 128, 64, 128)
    assert kb.geometry(64, 256, 20, 8, True) == (32, 256, 8, 128, 32, 0)
    assert kb.geometry(10, 100, 10, 100, True) == (24, 256, 8, 128, 0, 0)
    assert kb.geometry(120, 384, 48, 128, False) == (48, 128, 1, 1, 72, 256)


@pytest.mark.parametrize("backend", ["auto", "torch", "fused", "aligned"])
def test_resamplers_match_jax_per_backend(backend):
    # BandResampler/AtlasResampler through lon/lat: 'auto', 'torch' and
    # 'fused' (plain version on a CPU plane) against the JAX XLA default,
    # 'aligned' against backend='pallas' in interpret mode; a masked band
    # takes the default geometry under 'aligned', as band.py:404 does
    jg, g = _dense_pair(96, 160)
    lon, lat = _trajectory(96, 160, 1000, row_frac=0.4, row_width_frac=0.05)
    kb.reset_launches()
    jband = jb.fill_band(jg, 16, 48, 0, 160, method="idw")
    band = tb.Band(plane=torch.from_numpy(np.array(jband.plane)), vmask=torch.from_numpy(np.array(jband.vmask)),
                   masked=False, row0=16, col0=0)
    hole = band.vmask.clone()
    hole[20:22, 60:64] = 0.0
    masked = tb.Band(plane=band.plane * hole, vmask=hole, masked=True, row0=16, col0=0)
    jmasked = jb.Band(plane=jnp.asarray(masked.plane.numpy()), vmask=jnp.asarray(hole.numpy()), masked=True, row0=16, col0=0)
    jbackend = "pallas" if backend == "aligned" else "auto"
    for b, jbb in ((band, jband), (masked, jmasked)):
        rs = tb.BandResampler(g, b, chunk=64, win_rows=32, win_cols=128, backend=backend)
        assert rs.backend == ("torch" if backend == "auto" else backend)
        jrs = jb.BandResampler(jg, jbb, chunk=64, win_rows=32, win_cols=128, backend=jbackend)
        with _interp():
            want = jrs.resample(lon, lat)
        assert _resampled_close(rs.resample(lon, lat), want).mean() > 0.9
    assert kb.LAUNCHES["band_resample"] == 0  # a CPU plane runs the plain version
    with pytest.raises(ValueError):
        tb.BandResampler(g, band, backend="pallas")


# ---------------------------------------------------------------------------
# routing and serving, end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def masked_grids():
    return _masked_pair(192, 256, 0.1, 4)


def test_route_decisions_match_jax(masked_grids):
    jg, g = masked_grids
    kw = dict(chunk=64, win_rows=32, win_cols=128, cost_ns=jb.COST_NS)
    lon, lat = _trajectory(192, 256, 4096, row_frac=0.25, row_width_frac=0.03)
    lon2, lat2 = _trajectory(192, 256, 4096, row_frac=0.75, row_width_frac=0.03)
    rng = np.random.default_rng(0)
    rlon = rng.uniform(EXT.min_lon + 0.1, EXT.max_lon - 0.1, 4096).astype(np.float32)
    rlat = rng.uniform(EXT.min_lat + 0.1, EXT.max_lat - 0.1, 4096).astype(np.float32)
    dlon, dlat = _diagonal(192, 256, 4096)
    for mb in (1, 6):
        r = tb.BandRouter(g, max_bands=mb, **kw)
        jr = jb.BandRouter(jg, fill_backend="xla", max_bands=mb, **kw)
        batches = [(lon, lat), (rlon, rlat), (dlon, dlat), (lon[:300], lat[:300]), (lon2, lat2)]
        for lo, la in batches:
            assert r.route(lo, la) == jr.route(lo, la)
            assert r.last_coherence == jr.last_coherence
        r.prepare(lon, lat)
        jr.prepare(lon, lat)
        for lo, la in batches:
            assert r.route(lo, la, band_ready=True) == jr.route(lo, la, band_ready=True)
            assert r.last_coherence == jr.last_coherence
    # the serving-mode rule (tests/test_band.py:536-551): a coherent batch
    # outside the band routes packed
    assert r.route(lon, lat, band_ready=True) == "band"
    assert r.coherence(lon2, lat2) > 0.9 and r.coherence(lon2, lat2, within_footprint=True) < 0.1
    assert r.route(lon2, lat2, band_ready=True) == "packed"
    assert r.route(rlon, rlat) == "packed"


@pytest.mark.parametrize("method", ["kriging", "idw"])
@pytest.mark.parametrize("track", ["band", "diagonal"])
def test_router_serving_matches_jax(masked_grids, track, method):
    jg, g = masked_grids
    lon, lat = (_trajectory(192, 256, 2000, seed=2) if track == "band" else _diagonal(192, 256, 2048))
    # a fixed 16-row window: chunks that span more rows escalate
    kw = dict(chunk=128, win_rows=16, win_cols=128, auto_window=False, max_bands=6 if track == "diagonal" else 1)
    r = tb.BandRouter(g, **kw)
    jr = jb.BandRouter(jg, fill_backend="xla", **kw)
    r.prepare(lon, lat, method=method)
    jr.prepare(lon, lat, method=method)
    got = getattr(r, method)(lon, lat, force="band")
    want = getattr(jr, method)(lon, lat, force="band")
    assert r.last_unresolved == jr.last_unresolved > 0  # escalation happens
    _values_close(got, want, *BARS[method])
    assert torch.isfinite(got).all()
    # escalated queries hold the port's own two-tier values
    z, ok = r._resampler.resample(lon, lat)
    bad = ~ok
    esc = getattr(r.two_tier, method)(torch.from_numpy(lon)[bad], torch.from_numpy(lat)[bad])
    np.testing.assert_array_equal(got[bad].numpy(), esc.numpy())
    np.testing.assert_array_equal(got[ok].numpy(), z[ok].numpy())
    if method == "idw":
        with pytest.raises(ValueError, match="re-prepare"):
            r.kriging(lon, lat, force="band")


def test_router_packed_and_unprepared_paths_match_jax(masked_grids):
    # routed serving from cold, against the JAX router: under the JAX
    # package's costs a 4096-ping batch routes packed (its 7.3 ms fill
    # dispatch); with the dispatch cost at 0 it routes band, prepares and
    # serves
    jg, g = masked_grids
    lon, lat = _trajectory(192, 256, 4096, row_width_frac=0.04)
    for cost, route in ((jb.COST_NS, "packed"), (dict(jb.COST_NS, dispatch=0.0), "band")):
        kw = dict(chunk=64, win_rows=32, win_cols=128, cost_ns=cost)
        r, jr = tb.BandRouter(g, **kw), jb.BandRouter(jg, fill_backend="xla", **kw)
        assert r.route(lon, lat) == jr.route(lon, lat) == route
        got, want = r.kriging(lon, lat), jr.kriging(lon, lat)
        assert (r._resampler is None) == (jr._resampler is None) == (route == "packed")
        assert r.last_unresolved == jr.last_unresolved
        _values_close(got, want, *BARS["kriging"])


def test_streaming_mission_loop():
    # tests/test_band.py:451-497 on the port: streaming ingest ->
    # router.refresh(si.grid()) -> serve the upcoming track; new
    # observations reach the band fill AND the escalation engine
    from auvtpu_torch.streaming import StreamingInterpolator

    H, W = 96, 256
    si = StreamingInterpolator((H, W), EXT, swath_cap=512, method="kriging", device="cpu")

    def swath(c0, c1):
        rows, cols = np.mgrid[0:H:2, c0:c1]
        rows, cols = rows.ravel(), cols.ravel()
        si.ingest(rows, cols, (100.0 + rows * 0.5 + cols * 0.25).astype(np.float64))

    swath(0, 128)
    router = tb.BandRouter(si.grid(), chunk=64, win_rows=32, win_cols=128)
    n = 512
    t = np.linspace(0, 1, n)
    x = 2.0 + t * 120.0
    y = H * 0.5 + 3 * np.sin(t * 20 * np.pi)
    g = router.grid
    lon = (EXT.min_lon + x * g.lon_step).astype(np.float32)
    lat = (EXT.min_lat + y * g.lat_step).astype(np.float32)
    router.prepare(lon, lat)
    z1 = router.kriging(lon, lat, force="band").numpy()
    assert np.isfinite(z1).all()
    np.testing.assert_allclose(z1, 100.0 + y * 0.5 + x * 0.25, atol=1.0)  # odd rows are kriged

    swath(128, 256)
    router.refresh(grid=si.grid())
    x2 = 130.0 + t * 110.0
    lon2 = (EXT.min_lon + x2 * g.lon_step).astype(np.float32)
    z2 = router.kriging(lon2, lat, force="band").numpy()
    assert np.isfinite(z2).all() and router.last_unresolved > 0
    np.testing.assert_allclose(z2, 100.0 + y * 0.5 + x2 * 0.25, atol=1.0)
    assert router.two_tier.grid is router.grid  # no stale escalation engine


def test_refresh_lossy_grid_recomputes_masked():
    # tests/test_band.py:500-533: a replacement grid that lost observations
    # must not keep masked=False from the first build
    H, W = 64, 256
    elev = np.asarray(shelf_seamount(H, W), np.float64)
    _, grid = _pair(elev)
    lon, lat = _trajectory(H, W, 1024, row_frac=0.5, row_width_frac=0.05)
    router = tb.BandRouter(grid, chunk=64, win_rows=32, win_cols=128)
    router.prepare(lon, lat)
    assert router._band.masked is False
    lossy = elev.copy()
    lossy[:, W - 100:] = np.nan
    _, g2 = _pair(lossy)
    router.refresh(grid=g2)
    assert router._band.masked is True
    x = np.full(8, W - 40.0)
    y = np.linspace(20.0, 40.0, 8)
    qlon, qlat = _lonlat(H, W, x, y)
    _, ok = router._resampler.resample(qlon, qlat)
    assert not ok.any()
    router2 = tb.BandRouter(grid, chunk=64, win_rows=32, win_cols=128)
    router2.prepare(lon, lat)
    router2.refresh(grid=g2, assume_masked=False)
    assert router2._band.masked is False
    # the atlas path recomputes the same way
    elev3 = np.asarray(shelf_seamount(192, W), np.float64)
    _, g3 = _pair(elev3)
    elev3[:, W - 100:] = np.nan
    _, g4 = _pair(elev3)
    dlon, dlat = _diagonal(192, W, 2048)
    ra = tb.BandRouter(g3, chunk=128, win_rows=48, win_cols=128, max_bands=4)
    atlas = ra.prepare(dlon, dlat)
    assert isinstance(atlas, tb.BandAtlas) and atlas.shape[0] > 1 and atlas.masked is False
    assert ra.refresh(grid=g4).masked is True
    assert ra.refresh().placed == atlas.placed
    with pytest.raises(RuntimeError):
        tb.BandRouter(grid).refresh()


# ---------------------------------------------------------------------------
# non-finite pings (ROADMAP C6): the casts and bounding boxes of XLA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_saturating_index_casts_as_xla(dtype):
    from auvtpu_torch.ops.scattered import as_index, saturating_index

    v = np.array([np.nan, np.inf, -np.inf, 2.0 ** 31, -(2.0 ** 31), 2.0 ** 31 + 2 ** 8, -(2.0 ** 31) - 2 ** 8,
                  3e9, -3e9, 1e30, -1e30, 0.0, -0.0, 0.5, -0.5, 1.0, -1.0, 2.7, -2.7, 255.0, 2.0 ** 24, 2147483520.0],
                 dtype)
    want = np.asarray(jnp.floor(jnp.asarray(v)).astype(jnp.int32))
    got = saturating_index(torch.floor(torch.from_numpy(v)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # in range it is as_index bit for bit (NaN to 0)
    inr = np.isnan(v) | (np.abs(v) < 2.0 ** 31)
    np.testing.assert_array_equal(got.numpy()[inr], as_index(torch.floor(torch.from_numpy(v[inr]))).numpy())


ODD_PINGS = {"nan_lat": ("lat", np.nan), "nan_lon": ("lon", np.nan), "inf_lon": ("lon", np.inf)}


@pytest.mark.parametrize("last", [False, True], ids=["middle", "last"])
@pytest.mark.parametrize("ping", list(ODD_PINGS))
@pytest.mark.parametrize("route", ["band", "atlas"])
def test_router_on_nan_and_inf_pings_matches_jax(masked_grids, route, ping, last):
    # one odd ping in the 2,000-ping track (at 1000, or as the last ping of
    # the ragged last chunk): the resolved masks, the unresolved count and
    # the served NaN pattern equal to JAX's router, the depths at the file's
    # bars.  The band route is the fixed 16-row window of
    # test_router_serving_matches_jax, the atlas the diagonal on 6 pages.
    jg, g = masked_grids
    if route == "band":
        lon, lat = _trajectory(192, 256, 2000, seed=2)
    else:
        lon, lat = _diagonal(192, 256, 2000)
    kw = dict(chunk=128, win_rows=16, win_cols=128, auto_window=False, max_bands=1 if route == "band" else 6)
    r = tb.BandRouter(g, **kw)
    jr = jb.BandRouter(jg, fill_backend="xla", **kw)
    r.prepare(lon, lat, method="kriging")
    jr.prepare(lon, lat, method="kriging")
    assert (r._atlas is not None) == (jr._atlas is not None) == (route == "atlas")
    which, val = ODD_PINGS[ping]
    at = len(lon) - 1 if last else 1000
    lon, lat = lon.copy(), lat.copy()
    (lon if which == "lon" else lat)[at] = val
    _, ok = r._resampler.resample(lon, lat)
    _, okj = jr._resampler.resample(lon, lat)
    np.testing.assert_array_equal(_np(ok), _np(okj))
    got = r.kriging(lon, lat, force="band")
    want = jr.kriging(lon, lat, force="band")
    assert r.last_unresolved == jr.last_unresolved
    _values_close(got, want, *BARS["kriging"])
    assert np.isnan(_np(got)[at])
    assert kb.LAUNCHES["band_resample"] == 0  # a CPU plane runs the plain version
