"""The port's TwoTierInterpolator against the JAX package's (backend
'xla'), on the CPU, on masked grids where queries escalate: every backend
of the port ('torch', 'fused' and 'transposed', which run the plain
versions of B7 and B5/B6 here) at the bars of tests/test_packs.py
(kriging rtol 1e-4 / atol 0.1, IDW 1e-4 / 0.05), the same escalation set,
chunks bounded by ``escalate_cap``, and ``return_variance``."""

import numpy as np
import pytest
import torch

from auvtpu.config import Extent as JExtent
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops.two_tier import TwoTierInterpolator as JTwoTier
from auvtpu.synthetic import shelf_seamount

from auvtpu_torch.convert import grid_from_arrays
from auvtpu_torch.ops import two_tier
from auvtpu_torch.ops.two_tier import TwoTierInterpolator

torch.set_num_threads(1)

H, W = 70, 90


def _grids(removal, seed, hole=False):
    elev = mask_grid(shelf_seamount(H, W), removal, seed=seed)[0]
    if hole:
        elev[30:41, 30:41] = np.nan  # no valid cell within radius 2 of its centre
    jg = JGrid.from_nan_array(elev, JExtent(0.0, W - 1.0, 0.0, H - 1.0))
    g = grid_from_arrays(np.asarray(jg.elev), np.asarray(jg.valid), jg.min_lon, jg.max_lon, jg.min_lat, jg.max_lat, "cpu")
    return jg, g


def _queries(n=500, seed=9):
    r = np.random.RandomState(seed)
    lons = r.uniform(1e-6, W - 1 - 1e-6, n).astype(np.float32)
    lats = r.uniform(1e-6, H - 1 - 1e-6, n).astype(np.float32)
    return np.concatenate([lons, [35.0, 35.4, -0.5]]).astype(np.float32), np.concatenate([lats, [35.0, 34.6, 3.0]]).astype(np.float32)


def _close(got, want, rtol, atol):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def heavy():
    return _grids(0.6, 31)


@pytest.mark.parametrize("backend", ["torch", "fused", "transposed"])
def test_two_tier_matches_jax(heavy, backend, monkeypatch):
    jg, g = heavy
    lons, lats = _queries()
    jt = JTwoTier(jg, escalate_cap=64, backend="xla")
    tt = TwoTierInterpolator(g, escalate_cap=64, backend=backend)
    assert tt._outside_min_d2() == jt._outside_min_d2() == 4.0
    mask, bad = tt._resolved_mask(torch.from_numpy(lons), torch.from_numpy(lats), 4)
    j_mask, j_bad = jt._resolved_mask(lons, lats, 4)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    assert int(bad) == int(j_bad) > 64  # escalation happens, in several chunks

    sizes = []
    slow = two_tier.scattered_kriging

    def spy(grid, lo, la, **kw):
        sizes.append(lo.shape[0])
        return slow(grid, lo, la, **kw)

    monkeypatch.setattr(two_tier, "scattered_kriging", spy)
    _close(tt.kriging(lons, lats), jt.kriging(lons, lats), 1e-4, 0.1)
    assert len(sizes) >= 2 and max(sizes) <= 64 and sum(sizes) == int(bad)
    _close(tt.idw(lons, lats, k=8), jt.idw(lons, lats, k=8), 1e-4, 0.05)
    _close(tt.idw(lons, lats, k=3), jt.idw(lons, lats, k=3), 1e-4, 0.05)


@pytest.mark.parametrize("convention", ["reference", "centered"])
def test_two_tier_hole_and_convention(convention):
    jg, g = _grids(0.08, 12, hole=True)
    lons, lats = _queries(400, 21)
    jt = JTwoTier(jg, backend="xla", convention=convention)
    tt = TwoTierInterpolator(g, backend="transposed", convention=convention)
    assert tt._outside_min_d2() == jt._outside_min_d2()
    _, bad = tt._resolved_mask(torch.from_numpy(lons), torch.from_numpy(lats), 4)
    assert int(bad) > 0
    _close(tt.kriging(lons, lats), jt.kriging(lons, lats), 1e-4, 0.1)
    _close(tt.idw(lons, lats), jt.idw(lons, lats), 1e-4, 0.05)


def test_two_tier_variance_matches_jax(heavy):
    jg, g = heavy
    lons, lats = _queries()
    tt = TwoTierInterpolator(g, escalate_cap=64)
    assert tt.backend == "torch"  # 'auto' on a CPU grid
    got_k, got_v = tt.kriging(lons, lats, return_variance=True)
    want_k, want_v = JTwoTier(jg, escalate_cap=64, backend="xla").kriging(lons, lats, return_variance=True)
    _close(got_k, want_k, 1e-4, 0.1)
    _close(got_v, want_v, 1e-3, 0.05)
    assert (got_v.numpy()[~np.isnan(got_v.numpy())] >= 0).all()
    # the plain call is unchanged by the variance plumbing
    plain = tt.kriging(lons, lats)
    ok = ~torch.isnan(plain)
    torch.testing.assert_close(plain[ok], got_k[ok], rtol=1e-6, atol=1e-5)


def test_two_tier_rejects_unknown_backend(heavy):
    with pytest.raises(ValueError):
        TwoTierInterpolator(heavy[1], backend="xla")
