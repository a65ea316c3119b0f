"""The variogram kernels' wrappers: B9 (binned pair sums) and B10 (the
Gauss-Newton fit), ``auvtpu_torch/kernels/variogram.py``.

On the CPU a wrapper runs its plain twin (the loops that
``tests/test_torch_variogram.py`` holds against the JAX package), so here
the wrappers must give the twins' results bit for bit and launch nothing.
B9's bin-grouped offset table must hold the plain tables' offsets once
each; B10's arithmetic (its analytic Jacobian, LU solve and walk), written
out in Python as the kernel computes it (each curve evaluated once a bin a
step, the walk ended at the first step not kept or frozen), must walk as
the plain loop walks, and the plain loop's own record must show that
nothing changes after that step; B9's fast path, rendered in torch, must
give the plain sums bit for bit where its identity holds; and the fit must
land in one place under the float64 noise a different summation order
gives (B9 sums in another order than torch).  The tests marked ``cuda``
hold the kernels to their twins on a card and skip here: B9 counts equal,
sums within 1e-12 relative and equal once rounded to float32, two calls
bit-equal; B10 within 1e-9 relative with the same per-step (kept, frozen)
flags; the fit's launches make the host wait for nothing.
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
# B9's fast path, rendered in torch: the NaN-coded plane (the elevation where
# the validity is 1, NaN elsewhere and outside the plane), each pair adding
# fmax(d * d, 0) with d = e0 - p (+0 where either end is NaN, so invalid
# bases add nothing), the counts integers (both ends not NaN: the kernel's
# popcounts of row masks).  Where every cell has a validity of 0 or 1 and
# |elevation| <= 2**126 (2**1022 in f64) it gives pair_sums_ref's float64
# sums and counts bit for bit; a tile block that breaks that takes the
# kernel's general path
# ---------------------------------------------------------------------------

FAST_LIMIT = {torch.float32: 2.0 ** 126, torch.float64: 2.0 ** 1022}


def _fast_path_qualifies(elev, valid):
    """The kernel's vote over a block's halo, for a whole plane."""
    return bool((((valid == 0) | (valid == 1)) & (elev.abs() <= FAST_LIMIT[elev.dtype])).all())


def _fast_path_sums(elev, valid, n_rows, n_cols, col0, dys, dxs, bin_of, n_out, max_lag):
    H, Wb, R = n_rows, n_cols, max_lag
    word = torch.where(valid == 1, elev, torch.full_like(elev, float("nan")))
    wp = torch.nn.functional.pad(word, (R, R, 0, R), value=float("nan"))
    base = word[:H, col0:col0 + Wb]
    s = torch.zeros(n_out, dtype=torch.float64)
    n = torch.zeros(n_out, dtype=torch.int64)
    for dy, dx, b in zip(*(np.asarray(a).tolist() for a in (dys, dxs, bin_of))):
        p = wp[dy:dy + H, R + col0 + dx:R + col0 + dx + Wb]
        d = base - p
        s[b] += torch.sum(torch.fmax(d * d, torch.zeros_like(d)), dtype=torch.float64)
        n[b] += ((base == base) & (p == p)).sum()
    return s, n.to(torch.float64)


def _identity_planes(dtype, seed=3, h=41, w=53):
    """Seeded planes with all-invalid rows, -0.0 elevations at valid cells
    and non-zero elevations under invalid cells."""
    rng = np.random.default_rng(seed)
    valid = (rng.random((h, w)) > 0.3).astype(np.float64)
    valid[[4, 17, 18]] = 0.0
    elev = rng.normal(-500.0, 80.0, (h, w))
    elev[rng.random((h, w)) < 0.05] = -0.0
    return torch.from_numpy(elev).to(dtype), torch.from_numpy(valid).to(dtype)


def _layouts(e, v, R):
    h, w = e.shape
    return {"whole grid": (e, v, h, w, 0), "row band": (e, v, h - R, w, 0),
            "2-D block": (e, v, h - R, w - 2 * R, R)}


@pytest.mark.parametrize("layout", ["whole grid", "row band", "2-D block"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_b9_fast_path_is_bit_equal_to_the_plain_sums(dtype, layout):
    R = 6
    e, v = _identity_planes(dtype)
    assert bool((e[v == 0] != 0).any()) and bool((torch.signbit(e) & (e == 0) & (v == 1)).any())
    assert _fast_path_qualifies(e, v)
    args = _layouts(e, v, R)[layout]
    for dys, dxs, bins, n_out in (tv._bin_table(R, 6)[:3] + (6,), tv._sector_bin_table(R, 6, 4)[:3] + (24,)):
        table = kv.split_table(kv.grouped_table(dys, dxs, bins, n_out), n_out)  # the kernel's order
        s, c = _fast_path_sums(*args, *table, n_out, R)
        ws, wc = kv.pair_sums_ref(*args, dys, dxs, bins, n_out, R)
        _same(s, ws)
        _same(c, wc)
        assert float(c.sum()) > 0


@pytest.mark.parametrize("case", ["validity 0.5", "inf under an invalid cell", "overflowing difference"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_b9_fast_path_identity_fails_off_its_domain(dtype, case):
    # each grid breaks the identity, so the kernel's vote must send its
    # blocks down the general path
    R = 6
    e, v = _identity_planes(dtype)
    if case == "validity 0.5":
        v[20, 20] = 0.5
    elif case == "inf under an invalid cell":
        e[4, 30] = float("inf")
    else:  # a huge elevation under an invalid cell beside a valid one
        big = 3e38 if dtype == torch.float32 else 1.7e308
        e[4, 30], e[5, 30], v[5, 30] = big, -big, 1.0
    assert not _fast_path_qualifies(e, v)
    dys, dxs, bins, _ = tv._bin_table(R, 6)
    args = _layouts(e, v, R)["whole grid"]
    s, c = _fast_path_sums(*args, *kv.split_table(kv.grouped_table(dys, dxs, bins, 6), 6), 6, R)
    ws, wc = kv.pair_sums_ref(*args, dys, dxs, bins, 6, R)
    assert not (torch.equal(s, ws) and torch.equal(c, wc))


# ---------------------------------------------------------------------------
# B10's arithmetic, written out as fit_model_kernel computes it (analytic
# Jacobian in the log parameters, LU with partial pivoting, the walk)
# ---------------------------------------------------------------------------

def _shape(model, h, p2r):
    """(u, E) as fit_model_kernel's shape: u = h / p2, the exp term."""
    if model == "linear":
        return 0.0, 0.0
    u = h / (1e-6 if p2r < 1e-6 else p2r)
    return u, math.exp(-(u * u)) if model == "gaussian" else math.exp(-u) if model == "exponential" else 0.0


def _curve(model, h, u, E, p0, p1, live):
    """(value, d value / d log p) as fit_model_kernel's curve<true>, from the
    bin's shape terms."""
    if model == "linear":
        return p0 + p1 * h, (p0, p1 * h, 0.0)
    if model == "spherical":
        m = 1.0 if u > 1.0 else u
        f = 1.5 * m - 0.5 * (m * m * m)
        return p0 + p1 * f, (p0, p1 * f, -(p1 * ((1.5 - 1.5 * (m * m)) * m)) if live and u <= 1.0 else 0.0)
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
    """fit_model_kernel's walk: each bin's curve evaluated once a step (the
    Jacobian pass reads the shape terms the last kept candidate left), and
    the walk ended at the first step not kept or frozen, the rest recorded
    as (0, frozen)."""
    tot = max(sum(c), 1.0)
    sw = [math.sqrt(x / tot) for x in c]
    if init is None:
        sill0, maxlag = max(max(g), 1e-3), max(max(h), 1e-9)
        init = (0.01 * sill0, sill0 / maxlag if model == "linear" else sill0, maxlag / 3.0)
    th = [math.log(x) for x in init]
    p = [math.exp(x) for x in th]
    shapes = [_shape(model, hi, p[2]) for hi in h]
    frozen, flags = False, []
    while len(flags) < iters:
        acc, now = [0.0] * 10, []
        for hi, gi, si, (u, E) in zip(h, g, sw, shapes):
            val, dc = _curve(model, hi, u, E, p[0], p[1], p[2] >= 1e-6)
            now.append(val)
            r = (val - gi) * si
            j = [d * si for d in dc]
            for k, t in enumerate((j[0] * j[0], j[0] * j[1], j[0] * j[2], j[1] * j[1], j[1] * j[2], j[2] * j[2],
                                   j[0] * r, j[1] * r, j[2] * r, r * r)):
                acc[k] += t
        damp = 1e-4 * max((acc[0] + acc[3] + acc[5]) / 3.0, 1e-12)
        A = [[acc[0] + damp, acc[1], acc[2]], [acc[1], acc[3] + damp, acc[4]], [acc[2], acc[4], acc[5] + damp]]
        new = [t - min(max(d, -2.0), 2.0) for t, d in zip(th, _solve3(A, acc[6:9]))]
        q = [math.exp(x) for x in new]
        q_shapes = [_shape(model, hi, q[2]) for hi in h]
        ssn, moved = 0.0, 0.0
        for hi, gi, si, ci, nv, (u, E) in zip(h, g, sw, c, now, q_shapes):
            nxt = _curve(model, hi, u, E, q[0], q[1], q[2] >= 1e-6)[0]
            ssn += ((nxt - gi) * si) ** 2
            if ci > 0:
                moved = max(moved, abs(nxt - nv) / abs(nv))
        keep = ssn <= acc[9]
        frozen = keep and moved < stop
        flags.append([int(keep), int(frozen)])
        if keep:
            th, p, shapes = new, q, q_shapes
        if not keep or frozen:
            break
    flags += [[0, int(frozen)]] * (iters - len(flags))
    return [math.exp(x) for x in th], flags


@pytest.mark.parametrize("model", MODELS)
def test_b10_jacobian_is_jacfwds(model):
    h = torch.linspace(0.5, 10.0, 10, dtype=torch.float64)
    for th in ([-2.0, 13.0, -3.5], [0.1, 2.0, 1.5], [0.1, 2.0, -16.0], [0.0, 1.0, 1.9]):
        t = torch.tensor(th, dtype=torch.float64)
        want = torch.func.jacfwd(lambda x: tv.variogram_model(h, torch.exp(x), model))(t)
        p = [math.exp(x) for x in th]
        got = torch.tensor([_curve(model, float(x), *_shape(model, float(x), p[2]), p[0], p[1], p[2] >= 1e-6)[1]
                            for x in h], dtype=torch.float64)
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


def _linear_gamma():
    """test_stop_rule_freezes_on_a_linear_variogram's data: 0.1 + 36,530 h
    with a 1e-3 sampling noise, 500 pairs a bin."""
    rng = np.random.default_rng(0)
    h = torch.linspace(0.002, 0.038, 10)
    gam = ((0.1 + 36530.0 * h.double()) * torch.from_numpy(1 + 1e-3 * rng.standard_normal(10))).float()
    return h, gam, torch.full((10,), 500.0)


@pytest.mark.parametrize("stop", ["STOP_DGAMMA", "0"])
@pytest.mark.parametrize("data", ["stand-in", "linear"])
@pytest.mark.parametrize("model", MODELS)
def test_plain_loop_changes_nothing_after_its_first_rejection_or_freeze(standin_sums, model, data, stop):
    # what lets B10 stop early: in fit_model_ref's record every step after
    # the first one that is not kept or that freezes is (False, frozen), and
    # the landing is that of the loop cut at that step; a walk with no such
    # step keeps every step
    iters, stop_ = 120, tv.STOP_DGAMMA if stop == "STOP_DGAMMA" else 0.0
    if data == "stand-in":
        _, s, c, step = standin_sums
        gam, cnt = _gamma(s, c)
        h = torch.as_tensor(tv._bin_table(10, 10)[3], dtype=torch.float32) * step
    else:
        h, gam, cnt = _linear_gamma()
    rec = []
    full = kv.fit_model_ref(h, gam, cnt, model=model, iters=iters, stop=stop_, record=rec)
    flags = [(bool(k), bool(f)) for k, f in rec]
    first = next((i for i, (k, f) in enumerate(flags) if not k or f), None)
    if first is None:
        assert flags == [(True, False)] * iters
        return
    frozen = flags[first][1]
    assert flags[first + 1:] == [(False, frozen)] * (iters - first - 1)
    cut = kv.fit_model_ref(h, gam, cnt, model=model, iters=first + 1, stop=stop_)
    for a, b in zip(full, cut):
        _same(a, b)


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
def test_b9_matches_its_twin_on_a_grid_mixing_both_paths(card):
    # a validity of 0.5 in one 32x32 tile block and an inf under an invalid
    # cell in another send those blocks down the general path, the rest down
    # the fast one; the inf sits in the last row, which the band and the 2-D
    # block reach only as partners at dy = 10, so only the bins holding such
    # offsets are NaN (inf * 0), as in the twin
    R = 10
    e, v = _planes(150, 170, 11)
    e = torch.where(v > 0, e, torch.from_numpy(np.random.default_rng(2).normal(0.0, 9.0, e.shape)).float())
    v[40, 45] = 0.5
    v[149, 120] = 0.0
    e, v = e.cuda(), v.cuda()
    e_inf = e.clone()
    e_inf[149, 120] = float("inf")
    tables = (tv._bin_table(R, 10)[:3] + (10,), tv._sector_bin_table(R, 10, 4)[:3] + (40,))
    for dys, dxs, bins, n_out in tables:
        for args in ((e, v, 150, 170, 0), (e, v, 140, 170, 0), (e, v, 140, 150, R)):
            _b9_equal(kv.pair_sums(*args, dys, dxs, bins, n_out, R), kv.pair_sums_ref(*args, dys, dxs, bins, n_out, R))
        for args in ((e_inf, v, 140, 170, 0), (e_inf, v, 140, 150, R)):
            got = kv.pair_sums(*args, dys, dxs, bins, n_out, R)
            want = kv.pair_sums_ref(*args, dys, dxs, bins, n_out, R)
            nan = torch.isnan(want[0])
            assert bool(nan.any()) and not bool(nan.all())
            assert torch.equal(torch.isnan(got[0]), nan)
            _b9_equal((got[0][~nan], got[1]), (want[0][~nan], want[1]))
            again = kv.pair_sums(*args, dys, dxs, bins, n_out, R)
            assert torch.equal(got[0].view(torch.int64), again[0].view(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("model", MODELS)
def test_b10_without_a_stop_matches_the_plain_loop(card, model):
    # stop = 0 never freezes: the walk ends at its first rejected step, or
    # runs all 60
    elev, _, _ = mask_grid(shelf_seamount(96, 80), 0.2, seed=9)
    g = RegularGrid.from_nan_array(elev, Extent(0.0, 79.0, 0.0, 95.0), device="cuda")
    args = tuple(t.double() for t in tv.empirical_variogram(g))
    p, flags = kv.fit_walk(*args, model=model, iters=60, stop=0.0)
    rec = []
    want = kv.fit_model_ref(*args, model=model, iters=60, stop=0.0, record=rec)
    assert flags.cpu().tolist() == [[int(k), int(f)] for k, f in rec]
    assert not flags[:, 1].any()
    torch.testing.assert_close(p, torch.stack(want), rtol=1e-9, atol=0.0)


@pytest.mark.cuda
def test_the_fit_makes_the_host_wait_for_nothing(card):
    # the lag centres and B9's table are cached on the card after a first
    # call, so the pair sums and the fit launch with no synchronising copy
    elev, _, _ = mask_grid(shelf_seamount(96, 80), 0.2, seed=9)
    g = RegularGrid.from_nan_array(elev, Extent(0.0, 79.0, 0.0, 95.0), device="cuda")
    want = [tv.empirical_variogram(g), tv.fit_variogram(g), tv.empirical_variogram_directional(g)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [tv.empirical_variogram(g), tv.fit_variogram(g), tv.empirical_variogram_directional(g)]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


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
