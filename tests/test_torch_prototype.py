"""The port's scattered prototype (auvtpu_torch.scattered) against the JAX
package's (auvtpu.scattered on XLA:CPU, as tests/test_scattered.py runs it),
on the CPU.

Tolerances: knn squared distances within rtol 1e-5 plus the rounding of
their f32 formula |a|^2+|b|^2-2ab (4 f32 ulps of the largest |a|^2+|b|^2
after centring: the terms cancel, and the two frameworks round them in
another order), the indices equal
wherever the k-th and (k+1)-th distances differ by more than 1e-5 relative
(a closer tie is decided by the last ulp of |a|^2+|b|^2-2ab, which the two
frameworks round differently); idw, aidw and linear within 1e-4 of the
field's range; kriging with the same explicit parameters within 1e-3 of the
range for every model, with and without the plane trend, and its variance
within 1e-3 relative to the field's variance scale; fitted variograms
compared through gamma at the bin lags (rtol 1e-2: the fit of sampled
pairs lands in a flat valley, ROADMAP), after the binned counts agree
within 1 % a bin (a pair whose distance lies within an ulp of a bin edge
falls on either side); the pipeline's RMSE within 0.5 % of JAX's on a
96x128 synthetic (grid-aligned samples make many exact ties), 5 % with the
anisotropic fit.  That gap reads 3.43 % on the CPU (RMSE 0.95607 against
0.99004): lattice pairs with dx = +-dy sit exactly on the sector edges, and
the ulp of the centring, summed in another order, moves 31 of the binned
pair counts, which moves the fitted ellipse (ry 26.63 against 25.44).  So
the stages are held apart at the 0.5 % bar as well: the fit of JAX's
semivariance gives JAX's ellipse (gamma at the bin lags within 1e-3), and
kriging with JAX's ellipse gives JAX's RMSE (0.045 % apart on the CPU)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from auvtpu import scattered as js
from auvtpu.config import Extent as JExtent
from auvtpu.synthetic import shelf_seamount

from auvtpu_torch import scattered as ts
from auvtpu_torch import variogram as tv
from auvtpu_torch.config import Extent

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cloud():
    r = np.random.RandomState(0)
    pts = (r.rand(700, 2) * [6.0, 4.0] + [-73.5, 35.2]).astype(np.float32)  # geographic offsets: centring matters
    tgt = (r.rand(400, 2) * [6.0, 4.0] + [-73.5, 35.2]).astype(np.float32)
    vals = (30.0 * np.sin(pts[:, 0] * 2.0) + 12.0 * pts[:, 1] + r.randn(700)).astype(np.float32)
    return pts, vals, tgt, float(vals.max() - vals.min())


def _j(*a):
    return tuple(jnp.asarray(x) for x in a)


@pytest.mark.parametrize("k,chunk", [(5, 128), (16, 8192), (50, 256)])
def test_knn_search_matches_jax(cloud, k, chunk):
    pts, _, tgt, _ = cloud
    jd, ji = js.knn_search(*_j(tgt, pts), k=k, pt_chunk=chunk)
    td, ti = ts.knn_search(torch.from_numpy(tgt), torch.from_numpy(pts), k=k, pt_chunk=chunk)
    jd, ji = np.asarray(jd), np.asarray(ji)
    c = pts.mean(axis=0)
    scale = float(((tgt - c) ** 2).sum(1).max() + ((pts - c) ** 2).sum(1).max())
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=4 * np.finfo(np.float32).eps * scale)
    assert ti.dtype == torch.int32
    full = ((tgt[:, None, :].astype(np.float64) - pts[None].astype(np.float64)) ** 2).sum(-1)
    s = np.sort(full, axis=1)
    apart = (s[:, k] - s[:, k - 1]) > 1e-5 * s[:, k]
    # per row, every slot before the first near-tie is decided
    for row in np.flatnonzero(apart):
        srow = s[row, :k + 1]
        gaps = np.diff(srow) > 1e-5 * srow[1:]
        lead = np.argmin(gaps) if not gaps.all() else k
        np.testing.assert_array_equal(ti.numpy()[row, :lead], ji[row, :lead])
        assert set(ti.numpy()[row]) == set(ji[row])


def test_knn_search_with_fewer_points_than_k():
    pts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 2.0]], np.float32)
    tgt = np.array([[0.1, 0.1], [5.0, 5.0]], np.float32)
    jd, ji = js.knn_search(*_j(tgt, pts), k=5)
    td, ti = ts.knn_search(torch.from_numpy(tgt), torch.from_numpy(pts), k=5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=4 * np.finfo(np.float32).eps * 50.0)
    assert np.isinf(td.numpy()[:, 3:]).all() and (ti.numpy()[:, 3:] == -1).all()


@pytest.mark.parametrize("method", ["idw", "aidw", "linear"])
def test_knn_methods_match_jax(cloud, method):
    pts, vals, tgt, span = cloud
    jfn, tfn, k = {"idw": (js.idw_knn, ts.idw_knn, 12), "aidw": (js.adaptive_idw_knn, ts.adaptive_idw_knn, 16),
                   "linear": (js.linear_knn, ts.linear_knn, 12)}[method]
    want = np.asarray(jfn(*_j(pts, vals, tgt), k=k))
    got = tfn(pts, vals, tgt, k=k, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * span)


@pytest.mark.parametrize("trend", ["plane", "none"])
@pytest.mark.parametrize("model,vp", [
    ("exponential", (0.5, 900.0, 1.5)), ("linear", (0.5, 300.0, 1.0)),
    ("spherical", (0.5, 900.0, 2.0)), ("gaussian", (0.5, 900.0, 1.0)),
])
def test_kriging_knn_matches_jax(cloud, model, vp, trend):
    pts, vals, tgt, span = cloud
    jp, jvar = js.kriging_knn(*_j(pts, vals, tgt), k=16, vparams=vp, model=model, trend=trend,
                              return_variance=True)
    tp, tvar = ts.kriging_knn(pts, vals, tgt, k=16, vparams=vp, model=model, trend=trend, return_variance=True,
                              device="cpu")
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-3 * span)
    np.testing.assert_allclose(tvar.numpy(), np.asarray(jvar), rtol=0, atol=1e-3 * (vp[0] + vp[1]))


def test_kriging_knn_with_fewer_points_than_k():
    r = np.random.RandomState(5)
    pts = r.rand(6, 2).astype(np.float32)
    vals = r.rand(6).astype(np.float32)
    tgt = r.rand(9, 2).astype(np.float32)
    for model in ("exponential", "gaussian"):
        want = np.asarray(js.kriging_knn(*_j(pts, vals, tgt), k=10, vparams=(0.01, 1.0, 0.5), model=model))
        got = ts.kriging_knn(pts, vals, tgt, k=10, vparams=(0.01, 1.0, 0.5), model=model, device="cpu").numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def _counts_agree(got, want):
    assert got.sum() == want.sum()
    np.testing.assert_allclose(got, want, rtol=1e-2)


def _gamma(lags, params, model):
    return tv.variogram_model(torch.as_tensor(np.asarray(lags, np.float64)), tuple(float(p) for p in params),
                              model).numpy()


@pytest.mark.parametrize("model", ["exponential", "spherical"])
def test_fit_variogram_scattered_matches_jax_through_gamma(cloud, model):
    pts, vals, _, _ = cloud
    jl, jg, jc = js._scattered_semivariance(*_j(pts, vals))
    tl_, tg, tc = ts._scattered_semivariance(torch.from_numpy(pts), torch.from_numpy(vals))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), rtol=1e-6)
    _counts_agree(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-2)
    jfit = js.fit_variogram_scattered(*_j(pts, vals), model=model)
    tfit = ts.fit_variogram_scattered(pts, vals, model=model, device="cpu")
    lags = np.asarray(jl)
    np.testing.assert_allclose(_gamma(lags, tfit, model), _gamma(lags, jfit, model), rtol=1e-2)
    name, params = ts.fit_variogram_scattered(pts, vals, model="best", device="cpu")
    assert name in ("exponential", "linear", "spherical", "gaussian") and len(params) == 3


def test_directional_semivariance_and_aniso_fit_match_jax():
    r = np.random.RandomState(12)
    pts = (r.rand(1800, 2) * [100.0, 100.0]).astype(np.float32)
    vals = (10.0 * np.sin(pts[:, 0] / 12.0) * np.sin(pts[:, 1] / 2.0)).astype(np.float32)
    jl, ja, jg, jc = js._scattered_semivariance_directional(*_j(pts, vals))
    tl_, ta, tg, tc = ts._scattered_semivariance_directional(torch.from_numpy(pts), torch.from_numpy(vals))
    np.testing.assert_allclose(tl_.numpy(), np.asarray(jl), rtol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6)
    _counts_agree(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-2)
    jfit = tv.normalize_aniso(js.fit_variogram_scattered_aniso(*_j(pts, vals)))
    tfit = tv.normalize_aniso(ts.fit_variogram_scattered_aniso(pts, vals, device="cpu"))
    assert tfit[2] > 1.5 * tfit[3] and min(tfit[4], np.pi - tfit[4]) < 0.4  # test_scattered.py:280's recovery
    # the fitted directional gamma at the bin lags of every sector
    hh, aa = np.meshgrid(np.asarray(jl), np.asarray(ja))
    g_of = lambda p: _gamma(tv._aniso_h(torch.from_numpy(hh), torch.from_numpy(aa), p[2], p[3], p[4]).numpy(),
                            (p[0], p[1], 1.0), "exponential")
    np.testing.assert_allclose(g_of(tfit), g_of(jfit), rtol=1e-2)


def test_kriging_knn_aniso_matches_jax():
    r = np.random.RandomState(9)
    pts = (r.rand(900, 2) * [63.0, 47.0]).astype(np.float32)
    pv = (5.0 * np.sin(pts[:, 0] / 9.0) + 5.0 * np.sin(pts[:, 1] / 1.5)).astype(np.float32)
    tg = (r.rand(300, 2) * [63.0, 47.0]).astype(np.float32)
    ap = (0.05, 25.0, 9.0, 1.5, 0.3)
    want = np.asarray(js.kriging_knn(*_j(pts, pv, tg), k=16, aniso=ap, trend="none"))
    got = ts.kriging_knn(pts, pv, tg, k=16, aniso=ap, trend="none", device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * float(pv.max() - pv.min()))
    with pytest.raises(ValueError, match="either"):
        ts.kriging_knn(pts, pv, tg, vparams=(1.0, 1.0, 1.0), aniso=ap, device="cpu")
    fit = ts.kriging_knn(pts, pv, tg, k=16, aniso="fit", device="cpu")
    assert np.isfinite(fit.numpy()).all()


@pytest.mark.parametrize("method,kw", [
    ("idw", {}), ("aidw", {}), ("linear", {}), ("kriging", {}),
    ("kriging", dict(trend="none", model="linear")), ("kriging", dict(aniso=True)),
])
def test_sample_and_reconstruct_matches_jax(method, kw):
    elev = shelf_seamount(96, 128)
    a, ma = js.sample_and_reconstruct(elev, JExtent(0.0, 127.0, 0.0, 95.0), method=method, k=16,
                                      subset_fraction=0.05, **kw)
    b, mb = ts.sample_and_reconstruct(elev, Extent(0.0, 127.0, 0.0, 95.0), method=method, k=16,
                                      subset_fraction=0.05, device="cpu", **kw)
    np.testing.assert_array_equal(mb, ma)
    ra = np.sqrt(np.nanmean((np.asarray(a) - elev)[~ma] ** 2))
    rb = np.sqrt(np.nanmean((b - elev)[~mb] ** 2))
    assert b.dtype == np.float32 and np.isfinite(b).all()
    assert abs(rb - ra) <= (5e-2 if kw.get("aniso") else 5e-3) * ra


def test_aniso_pipeline_stages_match_jax():
    # the anisotropic pipeline's two stages on test_sample_and_reconstruct's
    # input, each from the JAX side's intermediate: the ellipse fit of its
    # semivariance, and the kriging with its ellipse
    elev = shelf_seamount(96, 128)
    pxy, pv, txy, mask = ts.sample_cells(elev, Extent(0.0, 127.0, 0.0, 95.0), subset_fraction=0.05)
    jl, ja, jg, jc = js._scattered_semivariance_directional(*_j(pxy, pv))
    jfit = tv.normalize_aniso([float(v) for v in js.fit_variogram_scattered_aniso(*_j(pxy, pv))])
    tfit = tv.normalize_aniso([float(v) for v in tv.fit_anisotropic(
        *(torch.from_numpy(np.array(a)) for a in (jl, ja, jg, jc)))])
    hh, aa = np.meshgrid(np.asarray(jl), np.asarray(ja))
    g_of = lambda p: _gamma(tv._aniso_h(torch.from_numpy(hh), torch.from_numpy(aa), p[2], p[3], p[4]).numpy(),
                            (p[0], p[1], 1.0), "exponential")
    np.testing.assert_allclose(g_of(tfit), g_of(jfit), rtol=1e-3)
    a = np.asarray(js.kriging_knn(*_j(pxy, pv, txy), k=16, aniso=tuple(jfit))).reshape(elev.shape)
    b = ts.kriging_knn(pxy, pv, txy, k=16, aniso=tuple(jfit), device="cpu").numpy().reshape(elev.shape)
    ra = np.sqrt(np.mean((a - elev)[~mask] ** 2))
    rb = np.sqrt(np.mean((b - elev)[~mask] ** 2))
    assert abs(rb - ra) <= 5e-3 * ra


def test_public_functions_run_on_the_card_unless_told():
    # host input goes to ``device`` (the card by default); a tensor keeps its
    # device and the other inputs follow it
    for fn in (ts.knn_search, ts.idw_knn, ts.adaptive_idw_knn, ts.linear_knn, ts.kriging_knn,
               ts.fit_variogram_scattered, ts.fit_variogram_scattered_aniso, ts.sample_and_reconstruct):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
    a, b = ts._on("meta", np.zeros((3, 2), np.float32), [1.0, 2.0])
    assert a.device.type == b.device.type == "meta"
    a, b = ts._on("meta", np.zeros(2, np.float32), torch.zeros(2))
    assert a.device.type == b.device.type == "cpu"


def test_sample_and_reconstruct_chunks_without_padding():
    # a short last chunk is served as it is: equal to one chunk of all targets
    elev = shelf_seamount(40, 50)
    ext = Extent(0.0, 49.0, 0.0, 39.0)
    one, _ = ts.sample_and_reconstruct(elev, ext, method="kriging", k=8, subset_fraction=0.1, device="cpu")
    many, _ = ts.sample_and_reconstruct(elev, ext, method="idw", k=8, subset_fraction=0.1, device="cpu",
                                        target_chunk=700)
    whole, _ = ts.sample_and_reconstruct(elev, ext, method="idw", k=8, subset_fraction=0.1, device="cpu")
    np.testing.assert_array_equal(many, whole)
    assert np.isfinite(one).all()
    with pytest.raises(ValueError):
        ts.sample_and_reconstruct(elev, ext, method="cubic", device="cpu")
