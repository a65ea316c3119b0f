"""The variogram kernels' wrappers: B9 (binned pair sums) and B10 (the
Gauss-Newton fit), ``auvtpu_torch/kernels/variogram.py``.

On the CPU a wrapper runs its plain twin (the loops that
``tests/test_torch_variogram.py`` holds against the JAX package), so here
the wrappers must give the twins' results bit for bit and launch nothing.
B9's bin-grouped offset table must hold the plain tables' offsets once
each; B10's arithmetic (its analytic Jacobian, LU solve and walk), written
out in Python as the kernel computes it, must walk as the plain loop walks;
and the fit must land in one place under the float64 noise a different
summation order gives (B9 sums in another order than torch).  The tests
marked ``cuda`` hold the kernels to their twins on a card and skip here:
B9 counts equal, sums within 1e-12 relative and equal once rounded to
float32, two calls bit-equal; B10 within 1e-9 relative with the same
per-step (kept, frozen) flags.
"""

import math

import numpy as np
import pytest
import torch

from auvtpu_torch import variogram as tv
from auvtpu_torch.config import KERGUELEN_EXTENT, Extent
from auvtpu_torch.grid import RegularGrid
from auvtpu_torch.kernels import variogram as kv
from auvtpu_torch.masking import mask_grid
from auvtpu_torch.synthetic import kerguelen_standin, shelf_seamount

torch.set_num_threads(1)

MODELS = ["exponential", "linear", "spherical", "gaussian"]


def _planes(h, w, seed, hole=0.3, dtype=np.float32):
    rng = np.random.default_rng(seed)
    valid = (rng.random((h, w)) > hole).astype(dtype)
    elev = (rng.normal(0.0, 50.0, (h, w)) * valid).astype(dtype)
    return torch.from_numpy(elev), torch.from_numpy(valid)


# ---------------------------------------------------------------------------
# (a) the bin-grouped offset table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_sectors", [1, 4])
@pytest.mark.parametrize("max_lag", range(1, 11))
def test_grouped_table_holds_every_offset_once(max_lag, n_sectors):
    tables = [tv._sector_bin_table(max_lag, 10, n_sectors)[:3] + (10 * n_sectors,)]
    if n_sectors == 1:
        tables.append(tv._bin_table(max_lag, 10)[:3] + (10,))
    for dys, dxs, bins, n_out in tables:
        table = kv.grouped_table(dys, dxs, bins, n_out)
        assert table.dtype == np.int32 and table.size == 2 * len(dys) + n_out + 1
        gd, gx, gb = kv.split_table(table, n_out)
        want = sorted(zip(dys.tolist(), dxs.tolist(), np.asarray(bins).tolist()))
        assert sorted(zip(gd, gx, gb)) == want and len(set(want)) == len(want)
        assert gb == sorted(gb)  # grouped by bin
        for b in range(n_out):  # within a bin, the table's own order
            mine = [(d, x) for d, x, bb in zip(gd, gx, gb) if bb == b]
            theirs = [(d, x) for d, x, bb in zip(dys.tolist(), dxs.tolist(), np.asarray(bins).tolist()) if bb == b]
            assert mine == theirs
        assert all(0 <= d <= max_lag and abs(x) <= max_lag for d, x in zip(gd, gx))


# ---------------------------------------------------------------------------
# (b) on CPU tensors the wrappers are the plain twins, bit for bit, and
# launch nothing
# ---------------------------------------------------------------------------

def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), float((a - b).abs().max())


def _shifted_1d(elev, valid, R):
    pe = torch.nn.functional.pad(elev, (R, R))
    pv = torch.nn.functional.pad(valid, (R, R))
    H, W = elev.shape[0] - R, elev.shape[1]
    return lambda dy, dx: (pe[dy:dy + H, R + dx:R + dx + W], pv[dy:dy + H, R + dx:R + dx + W])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cpu_wrappers_are_the_plain_twins(dtype):
    kv.reset_launches()
    R, H, W = 4, 23, 37
    e, v = _planes(H + R, W, 5, dtype=dtype)
    # pair_sums: (H + R, W) planes, base rows first
    dys, dxs, bins, _ = tv._bin_table(R, 5)
    s, c = tv.pair_sums(e, v, H, max_lag=R, n_bins=5)
    ws, wc = kv.binned_sums_ref(e[:H], v[:H], _shifted_1d(e, v, R), dys, dxs, bins, 5)
    _same(s, ws)
    _same(c, wc)
    # the directional (sector, lag) bins of a grid
    g = RegularGrid(e[:H].contiguous(), v[:H].contiguous(), 0.0, W - 1.0, 0.0, H - 1.0)
    _, _, gam, cnt = tv.empirical_variogram_directional(g, max_lag=R, n_bins=5, n_sectors=4)
    dys, dxs, flat, _, _ = tv._sector_bin_table(R, 5, 4)
    ep, vp = torch.nn.functional.pad(g.elev, (0, 0, 0, R)), torch.nn.functional.pad(g.valid, (0, 0, 0, R))
    ws, wc = kv.binned_sums_ref(g.elev, g.valid, _shifted_1d(ep, vp, R), dys, dxs, flat, 20)
    _same(cnt, wc.to(g.dtype).reshape(4, 5))
    _same(gam, torch.where(wc > 0, ws.to(g.dtype) / (2.0 * torch.clamp(wc.to(g.dtype), min=1.0)),
                           torch.zeros_like(ws.to(g.dtype))).reshape(4, 5))
    # pair_sums_2d: base block at column R of a halo-extended block
    Hb, Wb = 11, 17
    e2, v2 = e[:Hb + R, :Wb + 2 * R], v[:Hb + R, :Wb + 2 * R]
    dys, dxs, bins, _ = tv._bin_table(R, 5)
    s, c = tv.pair_sums_2d(e2, v2, Hb, Wb, max_lag=R, n_bins=5)
    ws, wc = kv.binned_sums_ref(e2[:Hb, R:R + Wb], v2[:Hb, R:R + Wb],
                                lambda dy, dx: (e2[dy:dy + Hb, R + dx:R + dx + Wb], v2[dy:dy + Hb, R + dx:R + dx + Wb]),
                                dys, dxs, bins, 5)
    _same(s, ws)
    _same(c, wc)
    # the fit, with and without a start, and its walk's record
    lags, gam, cnt = tv.empirical_variogram(g, max_lag=R, n_bins=5)
    for model in MODELS:
        for init in (None, (2.0, 100.0, 3.0)):
            got = tv.fit_model(lags, gam, cnt, model=model, iters=12, init=init)
            rec = []
            want = kv.fit_model_ref(lags, gam, cnt, model=model, iters=12, init=init, stop=tv.STOP_DGAMMA, record=rec)
            for a, b in zip(got, want):
                _same(a, b)
            _, flags = kv.fit_walk(lags, gam, cnt, model=model, iters=12, init=init, stop=tv.STOP_DGAMMA)
            assert flags.dtype == torch.int8 and flags.shape == (12, 2)
            assert flags.tolist() == [[int(k), int(f)] for k, f in rec]
    assert kv.LAUNCHES == {"pair_sums": 0, "fit_model": 0}


def test_ctypes_argtypes_follow_the_c_interface():
    # the argument lists the wrapper declares against csrc/variogram.cu's
    # extern "C" signatures (a pointer or the stream is void*)
    import ctypes
    import re
    from pathlib import Path

    src = (Path(kv.__file__).resolve().parent.parent / "csrc" / "variogram.cu").read_text()
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int", ctypes.c_double: "double"}
    for name, argtypes in kv.ARGTYPES.items():
        params = re.search(rf"int {name}\(([^)]*)\)", src).group(1).split(",")
        want = ["ptr" if "*" in p else p.split()[0] for p in params]
        assert [kinds[a] for a in argtypes] == want, name


def test_the_launches_refuse_cpu_tensors():
    # the CUDA implementations never run the plain twin: CPU tensors raise
    e, v = _planes(12, 9, 1)
    table = torch.from_numpy(kv.grouped_table(*tv._bin_table(2, 2)[:3], 2))
    with pytest.raises(ValueError, match="one card"):
        kv.pair_sums_launch(e, v, table, 10, 9, 0, 2, 2)
    x = torch.ones(4)
    with pytest.raises(ValueError, match="one card"):
        kv.fit_launch(x, x, x, None, "exponential", 3, 1e-4)
    assert kv.LAUNCHES == {"pair_sums": 0, "fit_model": 0}


# ---------------------------------------------------------------------------
# B10's arithmetic, written out as fit_model_kernel computes it (analytic
# Jacobian in the log parameters, LU with partial pivoting, the walk)
# ---------------------------------------------------------------------------

def _curve(model, h, p0, p1, p2r):
    """(value, d value / d log p) as fit_model_kernel's curve<true>."""
    live = p2r >= 1e-6
    p2 = 1e-6 if p2r < 1e-6 else p2r
    if model == "linear":
        return p0 + p1 * h, (p0, p1 * h, 0.0)
    u = h / p2
    if model == "spherical":
        m = 1.0 if u > 1.0 else u
        f = 1.5 * m - 0.5 * (m * m * m)
        return p0 + p1 * f, (p0, p1 * f, -(p1 * ((1.5 - 1.5 * (m * m)) * m)) if live and u <= 1.0 else 0.0)
    E = math.exp(-(u * u)) if model == "gaussian" else math.exp(-u)
    f = 1.0 - E
    d2 = -(p1 * (E * (2.0 * (u * u)))) if model == "gaussian" else -(p1 * (E * u))
    return p0 + p1 * f, (p0, p1 * f, d2 if live else 0.0)


def _solve3(a, b):
    a, b = [r[:] for r in a], b[:]
    for k in range(3):
        p = max(range(k, 3), key=lambda i: (abs(a[i][k]), -i))
        a[k], a[p], b[k], b[p] = a[p], a[k], b[p], b[k]
        for i in range(k + 1, 3):
            m = a[i][k] / a[k][k]
            a[i] = [a[i][j] - m * a[k][j] if j > k else a[i][j] for j in range(3)]
            b[i] = b[i] - m * b[k]
    x2 = b[2] / a[2][2]
    x1 = (b[1] - a[1][2] * x2) / a[1][1]
    return [(b[0] - a[0][1] * x1 - a[0][2] * x2) / a[0][0], x1, x2]


def _kernel_walk(h, g, c, model, iters, init, stop):
    tot = max(sum(c), 1.0)
    sw = [math.sqrt(x / tot) for x in c]
    if init is None:
        sill0, maxlag = max(max(g), 1e-3), max(max(h), 1e-9)
        init = (0.01 * sill0, sill0 / maxlag if model == "linear" else sill0, maxlag / 3.0)
    th, frozen, flags = [math.log(x) for x in init], False, []
    for _ in range(iters):
        p = [math.exp(x) for x in th]
        acc = [0.0] * 10
        for hi, gi, si in zip(h, g, sw):
            val, dc = _curve(model, hi, *p)
            r = (val - gi) * si
            j = [d * si for d in dc]
            for k, t in enumerate((j[0] * j[0], j[0] * j[1], j[0] * j[2], j[1] * j[1], j[1] * j[2], j[2] * j[2],
                                   j[0] * r, j[1] * r, j[2] * r, r * r)):
                acc[k] += t
        damp = 1e-4 * max((acc[0] + acc[3] + acc[5]) / 3.0, 1e-12)
        A = [[acc[0] + damp, acc[1], acc[2]], [acc[1], acc[3] + damp, acc[4]], [acc[2], acc[4], acc[5] + damp]]
        new = [t - min(max(d, -2.0), 2.0) for t, d in zip(th, _solve3(A, acc[6:9]))]
        q = [math.exp(x) for x in new]
        ssn, moved = 0.0, 0.0
        for hi, gi, si, ci in zip(h, g, sw, c):
            now, nxt = _curve(model, hi, *p)[0], _curve(model, hi, *q)[0]
            ssn += ((nxt - gi) * si) ** 2
            if ci > 0:
                moved = max(moved, abs(nxt - now) / abs(now))
        keep = not frozen and ssn <= acc[9]
        th = new if keep else th
        frozen = frozen or (keep and moved < stop)
        flags.append([int(keep), int(frozen)])
    return [math.exp(x) for x in th], flags


@pytest.mark.parametrize("model", MODELS)
def test_b10_jacobian_is_jacfwds(model):
    h = torch.linspace(0.5, 10.0, 10, dtype=torch.float64)
    for th in ([-2.0, 13.0, -3.5], [0.1, 2.0, 1.5], [0.1, 2.0, -16.0], [0.0, 1.0, 1.9]):
        t = torch.tensor(th, dtype=torch.float64)
        want = torch.func.jacfwd(lambda x: tv.variogram_model(h, torch.exp(x), model))(t)
        p = [math.exp(x) for x in th]
        got = torch.tensor([_curve(model, float(x), *p)[1] for x in h], dtype=torch.float64)
        torch.testing.assert_close(got, want, rtol=1e-13, atol=1e-300)


@pytest.fixture(scope="module")
def standin_sums():
    """The stand-in r0.10 (the bench's grid) on the CPU, its float64 pair
    sums and its lags in degrees."""
    elev, _, _ = mask_grid(kerguelen_standin((2053, 2441)), 0.10)
    g = RegularGrid.from_nan_array(elev, KERGUELEN_EXTENT, device="cpu")
    s, c = tv.pair_sums(g.elev, g.valid, g.shape[0])
    step = 0.5 * (abs(g.lat_step) + abs(g.lon_step))
    return g, s, c, step


def _gamma(s, c, dt=torch.float32):
    s, c = s.to(dt), c.to(dt)
    return torch.where(c > 0, s / (2.0 * torch.clamp(c, min=1.0)), torch.zeros_like(s)), c


@pytest.mark.parametrize("model,iters,given", [(m, it, g) for m in MODELS for it, g in ((25, False), (25, True), (1, False))])
def test_b10_arithmetic_walks_as_the_plain_loop(standin_sums, model, iters, given):
    g, s, c, step = standin_sums
    gam, cnt = _gamma(s, c)
    h = (torch.as_tensor(tv._bin_table(10, 10)[3], dtype=torch.float32) * step).double()
    gam, cnt = gam.double(), cnt.double()
    cnt[3] = 0.0  # a bin with no pairs
    init = (0.5, float(gam.max()), 0.01) if given else None
    rec = []
    want = kv.fit_model_ref(h, gam, cnt, model=model, iters=iters, init=init, stop=tv.STOP_DGAMMA, record=rec)
    got, flags = _kernel_walk(h.tolist(), gam.tolist(), cnt.tolist(), model, iters, init, tv.STOP_DGAMMA)
    assert flags == [[int(k), int(f)] for k, f in rec]
    np.testing.assert_allclose(got, [float(p) for p in want], rtol=1e-9)


# ---------------------------------------------------------------------------
# (c) the landing does not move under float64 noise in the pair sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_landing_holds_under_f64_noise_in_the_sums(standin_sums, monkeypatch, seed):
    # the sums of squared differences move with the summation order, by
    # ~1e-16 relative; the counts are sums of 0s and 1s, exact in any order
    g, s, c, _ = standin_sums
    rng = np.random.default_rng(seed)
    noisy = s * torch.from_numpy(1.0 + 1e-15 * rng.choice([-1.0, 1.0], size=s.numel()))
    assert not torch.equal(noisy, s)
    _same(_gamma(noisy, c)[0], _gamma(s, c)[0])
    # fit_variogram of the grid with its sums as they are, then as another
    # summation order could have left them
    monkeypatch.setattr(kv, "pair_sums", lambda *args: (s, c))
    want = [float(p) for p in tv.fit_variogram(g)]
    monkeypatch.setattr(kv, "pair_sums", lambda *args: (noisy, c))
    got = [float(p) for p in tv.fit_variogram(g)]
    np.testing.assert_allclose(got, want, rtol=1e-9)


# ---------------------------------------------------------------------------
# (d) the kernels against their twins, on a card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    kv.build()


def _b9_equal(got, want):
    s, c = got
    ws, wc = want
    assert torch.equal(c, wc), (c, wc)
    torch.testing.assert_close(s, ws, rtol=1e-12, atol=0.0)
    assert torch.equal(s.float(), ws.float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_b9_matches_its_twin_in_every_layout(card, dtype):
    kv.reset_launches()
    R = 10
    for h, w, hole in ((75, 61, 0.3), (130, 203, 0.1), (9, 7, 0.5), (40, 33, 1.0)):
        e, v = (t.to("cuda", dtype) for t in _planes(h, w, h * w, hole))
        for dys, dxs, bins, n_out in (tv._bin_table(R, 10)[:3] + (10,), tv._sector_bin_table(R, 10, 4)[:3] + (40,)):
            # the whole plane, its partners below the base rows zero
            args = (e, v, h, w, 0, dys, dxs, bins, n_out, R)
            got = kv.pair_sums(*args)
            _b9_equal(got, kv.pair_sums_ref(*args))
            again = kv.pair_sums(*args)
            assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
            # a row band with max_lag rows below it
            if h > R + 1:
                args = (e, v, h - R, w, 0, dys, dxs, bins, n_out, R)
                _b9_equal(kv.pair_sums(*args), kv.pair_sums_ref(*args))
            # a 2-D block inside its halo-extended block
            if h > R + 1 and w > 2 * R + 1:
                args = (e, v, h - R, w - 2 * R, R, dys, dxs, bins, n_out, R)
                _b9_equal(kv.pair_sums(*args), kv.pair_sums_ref(*args))
        if hole == 1.0:
            assert float(kv.pair_sums(e, v, h, w, 0, *tv._bin_table(R, 10)[:3], 10, R)[1].sum()) == 0.0
    assert kv.LAUNCHES["pair_sums"] > 0
    # a window view read in place, through the package's functions
    big = RegularGrid.from_nan_array(mask_grid(shelf_seamount(96, 80), 0.2, seed=9)[0],
                                     Extent(0.0, 79.0, 0.0, 95.0), device="cuda")
    view = RegularGrid(big.elev[10:70, 5:64], big.valid[10:70, 5:64], 0.0, 58.0, 0.0, 59.0)
    host = RegularGrid(view.elev.cpu(), view.valid.cpu(), 0.0, 58.0, 0.0, 59.0)
    for a, b in zip(tv.empirical_variogram(view), tv.empirical_variogram(host)):
        assert torch.equal(a.cpu(), b)
    with pytest.raises(ValueError, match="above the kernel"):
        tv.pair_sums(e, v, 20, max_lag=17, n_bins=4)


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_b10_matches_the_plain_loop(card, model):
    kv.reset_launches()
    elev, _, _ = mask_grid(shelf_seamount(96, 80), 0.2, seed=9)
    g = RegularGrid.from_nan_array(elev, Extent(0.0, 79.0, 0.0, 95.0), device="cuda")
    lags, gam, cnt = tv.empirical_variogram(g)
    for counts in (cnt, torch.where(torch.arange(10, device="cuda") % 3 == 1, 0.0, cnt)):
        for iters in (0, 1, 25):
            for init in (None, (2.0, 150.0, 4.0)):
                for dt in (torch.float32, torch.float64):
                    args = (lags.to(dt), gam.to(dt), counts.to(dt))
                    p, flags = kv.fit_walk(*args, model=model, iters=iters, init=init, stop=tv.STOP_DGAMMA)
                    rec = []
                    want = kv.fit_model_ref(*args, model=model, iters=iters, init=init, stop=tv.STOP_DGAMMA,
                                            record=rec)
                    assert p.dtype == dt and p.device == g.device
                    assert flags.cpu().tolist() == [[int(k), int(f)] for k, f in rec]
                    if dt == torch.float64:
                        torch.testing.assert_close(p, torch.stack(want), rtol=1e-9, atol=0.0)
                    else:  # the same landing, rounded once to float32
                        torch.testing.assert_close(p, torch.stack(want), rtol=2 ** -23, atol=0.0)
    assert kv.LAUNCHES["fit_model"] == 2 * 3 * 2 * 2
    with pytest.raises(ValueError, match="bins outside"):
        kv.fit_model(torch.ones(600, device="cuda"), torch.ones(600, device="cuda"), torch.ones(600, device="cuda"))
