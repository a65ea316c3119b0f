"""The port's variogram estimation and fit against auvtpu.variogram.

The empirical variogram must agree to f32 round-off (rtol 1e-5).  The fit
lands in a nearly linear regime where only sill/range and the nugget are
pinned down, so the two frameworks' Gauss-Newton runs end at parameters up
to ~20 % apart (the port's float64 loop stops where its steps stop moving
gamma, JAX's float32 loop where its last bits stop it); they are compared
through what they are used for: the fitted gamma at the bin lags (rtol
1e-3; measured <= 4.3e-4) and the fill each parameter set gives (atol
0.05 m; measured <= 0.0046 m).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import auvtpu.config as jcfg
from auvtpu import variogram as jv
from auvtpu.config import Extent as JExtent
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import fill_kriging as j_fill_kriging
from auvtpu.synthetic import kerguelen_standin, shelf_seamount

from auvtpu_torch import variogram as tv
from auvtpu_torch.convert import grid_from_arrays

torch.set_num_threads(1)


def _grids(name):
    if name == "tiny":  # __graft_entry__'s grid
        elev, _, _ = mask_grid(shelf_seamount(96, 64), 0.2, seed=3)
        ext = JExtent(0.0, 63.0, 0.0, 95.0)
    elif name == "shelf":  # tests/test_pallas.py's grid
        elev, _, _ = mask_grid(shelf_seamount(96, 80), 0.2, seed=9)
        ext = JExtent(0.0, 79.0, 0.0, 95.0)
    else:  # a Kerguelen-geometry block
        elev, _, _ = mask_grid(kerguelen_standin((128, 160)), 0.1)
        ext = jcfg.KERGUELEN_EXTENT
    jg = JGrid.from_nan_array(elev, ext)
    tg = grid_from_arrays(
        np.asarray(jg.elev), np.asarray(jg.valid),
        jg.min_lon, jg.max_lon, jg.min_lat, jg.max_lat, "cpu",
    )
    return jg, tg


GRIDS = ["tiny", "shelf", "kerguelen"]


@pytest.fixture(scope="module", params=GRIDS)
def grids(request):
    return _grids(request.param)


def _gamma_at_lags(jg, params, model="exponential"):
    lags, _, _ = jv.empirical_variogram(jg)
    step = 0.5 * (abs(jg.lat_step) + abs(jg.lon_step))
    h = np.asarray(lags, np.float64) * step
    return tv.variogram_model(torch.from_numpy(h), tuple(float(p) for p in params), model).numpy()


def test_empirical_variogram_matches(grids):
    jg, tg = grids
    jl, jgam, jc = jv.empirical_variogram(jg)
    tl, tgam, tc = tv.empirical_variogram(tg)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tgam.numpy(), np.asarray(jgam), rtol=1e-5)
    assert tgam.dtype == torch.float32 and (tc.numpy()[1:] > 0).all()


def test_fit_variogram_gamma_matches(grids):
    jg, tg = grids
    jp = jv.fit_variogram(jg)
    tp = tv.fit_variogram(tg)
    assert all(torch.is_tensor(p) and p.ndim == 0 and p.device == tg.device for p in tp)
    assert all(float(p) > 0 for p in tp)
    np.testing.assert_allclose(_gamma_at_lags(jg, tp), _gamma_at_lags(jg, jp), rtol=1e-3)


@pytest.mark.parametrize("name", ["tiny", "shelf"])
def test_fitted_parameters_give_the_same_fill(name):
    jg, tg = _grids(name)
    jp = tuple(float(p) for p in jv.fit_variogram(jg))
    tp = tuple(float(p) for p in tv.fit_variogram(tg))
    a = np.asarray(j_fill_kriging(jg, vparams=jp))
    b = np.asarray(j_fill_kriging(jg, vparams=tp))
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(a)
    np.testing.assert_allclose(b[ok], a[ok], rtol=0, atol=0.05)


@pytest.mark.parametrize("model", ["exponential", "linear", "spherical", "gaussian"])
def test_fit_model_gamma_matches(model):
    jg, _ = _grids("shelf")
    lags, gam, cnt = (np.array(a) for a in jv.empirical_variogram(jg))
    jp = jv.fit_model(jnp.asarray(lags), jnp.asarray(gam), jnp.asarray(cnt), model=model)
    tp = tv.fit_model(torch.from_numpy(lags), torch.from_numpy(gam), torch.from_numpy(cnt), model=model)
    h = torch.from_numpy(lags.astype(np.float64))
    want = tv.variogram_model(h, tuple(float(p) for p in jp), model).numpy()
    got = tv.variogram_model(h, tuple(float(p) for p in tp), model).numpy()
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3)


def test_fit_best_model_picks_a_fitting_model():
    _, tg = _grids("shelf")
    lags, gam, cnt = tv.empirical_variogram(tg)
    name, params, sse = tv.fit_best_model(lags, gam, cnt)
    assert name in ("exponential", "linear", "spherical", "gaussian")
    assert all(isinstance(p, float) and np.isfinite(p) for p in params)
    for m in ("exponential", "linear", "spherical", "gaussian"):
        w = cnt.double() / cnt.sum().double()
        p = tuple(float(v) for v in tv.fit_model(lags, gam, cnt, model=m))
        r = tv.variogram_model(lags.double(), p, m) - gam.double()
        assert sse <= float((w * r * r).sum()) * (1 + 1e-9)


def test_pair_sums_count_each_pair_once():
    rng = np.random.RandomState(4)
    H, W, L = 12, 9, 3
    elev = rng.normal(size=(H + L, W)).astype(np.float32)
    valid = (rng.rand(H + L, W) > 0.3).astype(np.float32)
    s, c = tv.pair_sums(torch.from_numpy(elev), torch.from_numpy(valid), H, max_lag=L, n_bins=L)
    js, jc = jv.pair_sums(jnp.asarray(elev), jnp.asarray(valid), H, max_lag=L, n_bins=L)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5)
    # brute force over the half-plane pairs with the first cell in the base rows
    want_c = np.zeros(L)
    for r0 in range(H):
        for c0 in range(W):
            for dy in range(0, L + 1):
                for dx in range(-L, L + 1):
                    h = np.hypot(dx, dy)
                    if (dy == 0 and dx <= 0) or h > L or not (0 <= c0 + dx < W):
                        continue
                    b = min(int(np.digitize(h, np.linspace(0, L, L + 1))) - 1, L - 1)
                    want_c[b] += valid[r0, c0] * valid[r0 + dy, c0 + dx]
    np.testing.assert_array_equal(c.numpy(), want_c.astype(np.float32))


# ---------------------------------------------------------------------------
# the directional variogram and the anisotropic fit: the binned table equal,
# gamma at rtol 1e-5 (f32 round-off, as the isotropic one), fits through the
# fitted gamma at every sector's bin lags (rtol 1e-3), the known ellipse
# recovered as tests/test_scattered.py:208 recovers it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("aspect", [1.0, 0.5])
def test_sector_table_and_directional_variogram_match(grids, aspect):
    jg, tg = grids
    for a, b in zip(tv._sector_bin_table(6, 6, 4, aspect), jv._sector_bin_table(6, 6, 4, aspect)):
        np.testing.assert_array_equal(a, b)
    want = jv.empirical_variogram_directional(jg, max_lag=6, n_bins=6, n_sectors=4, aspect=aspect)
    got = tv.empirical_variogram_directional(tg, max_lag=6, n_bins=6, n_sectors=4, aspect=aspect)
    for name, a, b in zip(("lags", "angles", "gamma", "counts"), got, want):
        assert a.dtype == torch.float32 and a.device == tg.device
        if name == "gamma":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    # its n_sectors=1 marginal is the isotropic variogram
    _, _, g1, c1 = tv.empirical_variogram_directional(tg, max_lag=6, n_bins=6, n_sectors=1)
    _, gi, ci = tv.empirical_variogram(tg, max_lag=6, n_bins=6)
    np.testing.assert_array_equal(c1[0].numpy(), ci.numpy())
    np.testing.assert_allclose(g1[0].numpy(), gi.numpy(), rtol=1e-5)


def _aniso_gamma(lags, angles, p):
    hh, aa = np.meshgrid(np.asarray(lags, np.float64), np.asarray(angles, np.float64))
    hp = tv._aniso_h(torch.from_numpy(hh), torch.from_numpy(aa), float(p[2]), float(p[3]), float(p[4]))
    return tv.variogram_model(hp, (float(p[0]), float(p[1]), 1.0), "exponential").numpy()


def test_fit_anisotropic_recovers_a_known_ellipse():
    true = (0.3, 12.0, 6.0, 2.0, 0.6)
    S, B = 6, 10
    lags = torch.linspace(0.5, 10.0, B)
    angles = torch.as_tensor((np.arange(S) + 0.5) * np.pi / S, dtype=torch.float32)
    hp = tv._aniso_h(lags[None, :].expand(S, B), angles[:, None].expand(S, B), true[2], true[3], true[4])
    gamma = tv.variogram_model(hp, (true[0], true[1], 1.0), "exponential")
    fit = tv.fit_anisotropic(lags, angles, gamma, torch.full((S, B), 500.0), iters=60)
    assert all(torch.is_tensor(p) and p.ndim == 0 for p in fit)
    nug, sill, rx, ry, th = tv.normalize_aniso(fit)
    assert sill == pytest.approx(true[1], rel=0.15)
    assert rx == pytest.approx(true[2], rel=0.2)
    assert ry == pytest.approx(true[3], rel=0.2)
    assert th == pytest.approx(true[4], abs=0.15)
    jfit = jv.fit_anisotropic(jnp.asarray(lags.numpy()), jnp.asarray(angles.numpy()), jnp.asarray(gamma.numpy()),
                              jnp.full((S, B), 500.0), iters=60)
    np.testing.assert_allclose(_aniso_gamma(lags, angles, fit), _aniso_gamma(lags, angles, jfit), rtol=1e-3)
    # a start given as init= runs that start alone
    one = tv.fit_anisotropic(lags, angles, gamma, torch.full((S, B), 500.0), iters=60, init=(0.2, 10.0, 5.0, 2.5, 0.5))
    jone = jv.fit_anisotropic(jnp.asarray(lags.numpy()), jnp.asarray(angles.numpy()), jnp.asarray(gamma.numpy()),
                              jnp.full((S, B), 500.0), iters=60, init=(0.2, 10.0, 5.0, 2.5, 0.5))
    np.testing.assert_allclose(_aniso_gamma(lags, angles, one), _aniso_gamma(lags, angles, jone), rtol=1e-3)


def test_fit_variogram_directional_matches_through_gamma():
    jg, tg = _grids("kerguelen")
    jp = jv.fit_variogram_directional(jg, max_lag=6, n_bins=6)
    tp = tv.fit_variogram_directional(tg, max_lag=6, n_bins=6)
    aspect = float(round(abs(tg.lat_step) / abs(tg.lon_step), 6))
    lags, angles, _, _ = tv.empirical_variogram_directional(tg, max_lag=6, n_bins=6, aspect=aspect)
    lags = lags * abs(tg.lon_step)
    np.testing.assert_allclose(_aniso_gamma(lags, angles, tp), _aniso_gamma(lags, angles, jp), rtol=1e-3)


def test_anisotropy_matrix_and_normalize_match():
    for p in ((0.1, 5.0, 2.0, 3.0, 0.4), (0.1, 5.0, 3.0, 2.0, 2.9)):
        assert tv.normalize_aniso(p) == jv.normalize_aniso(p)
        np.testing.assert_array_equal(tv.anisotropy_matrix(*p[2:]), jv.anisotropy_matrix(*p[2:]))


@pytest.mark.parametrize("model", ["exponential", "spherical"])
def test_fit_model_from_an_init_matches(model):
    jg, _ = _grids("shelf")
    lags, gam, cnt = (np.array(a) for a in jv.empirical_variogram(jg))
    init = (2.0, 150.0, 4.0)
    jp = jv.fit_model(jnp.asarray(lags), jnp.asarray(gam), jnp.asarray(cnt), model=model, init=init)
    tp = tv.fit_model(torch.from_numpy(lags), torch.from_numpy(gam), torch.from_numpy(cnt), model=model, init=init)
    h = torch.from_numpy(lags.astype(np.float64))
    want = tv.variogram_model(h, tuple(float(p) for p in jp), model).numpy()
    got = tv.variogram_model(h, tuple(float(p) for p in tp), model).numpy()
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3)
    # zero iterations return the init
    p0 = tv.fit_exponential(torch.from_numpy(lags), torch.from_numpy(gam), torch.from_numpy(cnt), iters=0, init=init)
    np.testing.assert_allclose([float(p) for p in p0], init, rtol=1e-6)


def test_pair_sums_are_exact_and_do_not_depend_on_the_split():
    # 2048x2048 cells, every one valid: 25,154,560 pairs in the one bin,
    # past float32's 2**24, where a float32 count stops being exact; the
    # float64 sums hold it, and four row bands (each with its 2-row halo
    # below) sum to the same values, once rounded to float32, as the whole
    # plane
    from auvtpu_torch.variogram import pair_sums

    n, L = 2048, 2
    rng = np.random.default_rng(0)
    e = torch.from_numpy(rng.normal(0.0, 10.0, (n + L, n)).astype(np.float32))
    v = torch.ones(n + L, n)
    v[n:] = 0.0
    s, c = pair_sums(e, v, n, max_lag=L, n_bins=1)
    assert s.dtype == c.dtype == torch.float64
    pairs = sum((n - dy) * (n - abs(dx)) for dy, dx in ((0, 1), (0, 2), (1, -1), (1, 0), (1, 1), (2, 0)))
    assert float(c[0]) == pairs and pairs > 2**24
    blk = n // 4
    parts = [pair_sums(e[i * blk:(i + 1) * blk + L], v[i * blk:(i + 1) * blk + L], blk, max_lag=L, n_bins=1)
             for i in range(4)]
    assert torch.equal(sum(p[0] for p in parts).float(), s.float())
    assert torch.equal(sum(p[1] for p in parts), c)


# ---------------------------------------------------------------------------
# the whole Kerguelen stand-in r0.10 (the bench's grid) against the JAX
# package's fit of it on XLA:CPU, run here (tools/jax_fit_pins.py prints
# the same figures).  The fit is compared through gamma at the bins it
# weighs (those with pairs; bin 0 has none, its gamma is the fit's
# extrapolation to the nugget): within 3e-4 (ROADMAP, North star).  The
# ridge: the weighted SSE has no finite minimum there, so a loop walks the
# sill/range ridge until something stops it; the port's float64 loop stops
# after the first kept step that moves gamma by less than STOP_DGAMMA
# (step 8 of 25, at range ~34), in one place whichever float32 gamma it is
# given (ROADMAP section C1).
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def standin_variogram():
    """(the port's grid, the port's (lags, gamma, counts), JAX's (lags,
    gamma, counts, params), the mean grid step)."""
    elev, _, _ = mask_grid(kerguelen_standin(jcfg.GEBCO_TILES["kerguelen"]["shape"]), 0.10)
    jg = JGrid.from_nan_array(elev, jcfg.KERGUELEN_EXTENT)
    tg = grid_from_arrays(np.asarray(jg.elev), np.asarray(jg.valid), jg.min_lon, jg.max_lon, jg.min_lat,
                          jg.max_lat, "cpu")
    step = 0.5 * (abs(tg.lat_step) + abs(tg.lon_step))
    jl, jgam, jcnt = jv.empirical_variogram(jg)
    jparams = jv.fit_exponential(jl * step, jgam, jcnt, iters=25)  # = jv.fit_variogram(jg)
    want = (np.asarray(jl, np.float64), np.asarray(jgam), np.asarray(jcnt), tuple(float(p) for p in jparams))
    return tg, tv.empirical_variogram(tg), want, step


def test_standin_empirical_variogram_matches_jax(standin_variogram):
    _, (lags, gam, cnt), (jl, jgam, jcnt, _), step = standin_variogram
    np.testing.assert_allclose((lags * step).numpy(), jl * step, rtol=1e-7)
    np.testing.assert_allclose(gam.numpy(), jgam, rtol=1e-6)
    # JAX's counts are float32 sums (inexact past 2**24), the port's exact
    np.testing.assert_allclose(cnt.numpy(), jcnt, rtol=1e-6)


def test_standin_fit_holds_gamma_to_jax(standin_variogram):
    tg, _, (jl, _, jcnt, jparams), step = standin_variogram
    p = tv.fit_variogram(tg)
    assert all(x.dtype == torch.float32 for x in p)
    h = jl * step
    got = tv.exponential_model(torch.from_numpy(h), tuple(float(x) for x in p)).numpy()
    want = np.asarray(jv.variogram_model(h, jparams), np.float64)
    weighed = jcnt > 0
    np.testing.assert_allclose(got[weighed], want[weighed], rtol=3e-4)


def test_float64_fit_lands_in_one_place(standin_variogram):
    # the port's float32 gamma and JAX's differ in their last bits (rtol
    # 1e-6 above), as the card's and the host's do: the float64 loop with
    # its stop lands in one place from either, and from float64 inputs
    _, (lags, gam, cnt), (_, jgam, jcnt, _), step = standin_variogram
    h = lags * step
    ours = tv.fit_exponential(h, gam, cnt, iters=25)
    jaxs = tv.fit_exponential(h, torch.from_numpy(np.array(jgam)), torch.from_numpy(np.array(jcnt)), iters=25)
    wide = tv.fit_exponential(h.double(), gam.double(), cnt.double(), iters=25)
    assert all(p.dtype == torch.float32 for p in ours + jaxs) and all(p.dtype == torch.float64 for p in wide)
    np.testing.assert_allclose([float(p) for p in ours], [float(p) for p in jaxs], rtol=1e-6)
    np.testing.assert_allclose([float(p) for p in wide], [float(p) for p in ours], rtol=1e-6)
    # the walk stopped on the ridge at step 8, at range ~34 degrees, where
    # more steps leave it
    np.testing.assert_allclose([float(p) for p in wide], (0.109813, 1.24075e6, 33.9611), rtol=1e-5)
    more = tv.fit_exponential(h.double(), gam.double(), cnt.double(), iters=60)
    assert [float(p) for p in more] == [float(p) for p in wide]


# ---------------------------------------------------------------------------
# the stop rule on data made to a known model
# ---------------------------------------------------------------------------


def test_stop_rule_freezes_on_a_linear_variogram(monkeypatch):
    # gamma drawn from the linear variogram 0.1 + 36,530 h (the stand-in's
    # nugget and sill/range slope, its lags in degrees) with a 1e-3 sampling
    # noise: the exponential's SSE falls as its range grows without end.  The
    # loop freezes (the landing is the same after 100 and 400 steps), while
    # without the stop it walks on.  Pure linear data walk slowly: the
    # freeze comes after ~60 steps, 1.3e-2 from the data at the first bin
    # (the nugget, 0.84 against 0.1, is the rest of the ridge).
    rng = np.random.default_rng(0)
    h = torch.linspace(0.002, 0.038, 10)
    gam = ((0.1 + 36530.0 * h.double()) * torch.from_numpy(1 + 1e-3 * rng.standard_normal(10))).float()
    cnt = torch.full((10,), 500.0)
    frozen = [float(p) for p in tv.fit_exponential(h, gam, cnt, iters=100)]
    assert [float(p) for p in tv.fit_exponential(h, gam, cnt, iters=400)] == frozen
    fitted = tv.exponential_model(h.double(), frozen)
    assert float(((fitted - gam.double()).abs() / gam.double()).max()) < 2e-2
    monkeypatch.setattr(tv, "STOP_DGAMMA", 0.0)
    walk = [float(p) for p in tv.fit_exponential(h, gam, cnt, iters=400)]
    assert walk[2] > 1.5 * frozen[2]


@pytest.mark.parametrize("true", [(0.3, 12.0, 4.0), (1.0, 100.0, 2.0)])
def test_stop_rule_recovers_a_known_exponential(true):
    # noise-free exponential gamma at lags 0.5-10: the SSE has its minimum
    # at the true parameters.  Sill and range come back within 1e-3; the
    # nugget, pinned only through the first bins, converges slowly under
    # the damping, and the stop leaves it up to 2.8 % off (1 % of a sill
    # of 100), the fitted gamma within 1e-3 of the true curve
    lags = torch.linspace(0.5, 10.0, 10)
    gam = tv.variogram_model(lags, true, "exponential")
    p = [float(x) for x in tv.fit_exponential(lags, gam, torch.full((10,), 500.0))]
    np.testing.assert_allclose(p[1:], true[1:], rtol=1e-3)
    assert p[0] == pytest.approx(true[0], rel=0.05)
    fitted = tv.exponential_model(lags.double(), p)
    np.testing.assert_allclose(fitted.numpy(), gam.double().numpy(), rtol=1e-3)
