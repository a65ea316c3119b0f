"""Scattered-query interpolation at arbitrary (lon, lat) batches and the
ordinary-kriging solve core (counterpart of :mod:`auvtpu.ops.scattered`).

- bilinear  <- bilinearInterpolationKernel (kernels.cu:173-234)
- bicubic   <- cubicInterpolationKernel    (kernels.cu:275-372)
- kriging   <- krigingInterpolationKernel  (kernels.cu:403-546)
- idw       <- the distance-weighted generalization of the reference's
               top-4-average fallback.

Bounds masks replace early returns, indexing into a NaN-encoded plane
replaces pointer arithmetic, and the window selection of
:mod:`auvtpu_torch.ops.window` replaces the ring walk.  The 5x6 system of
each query is held as 30 (N,) tensors and eliminated with unpivoted
Gauss-Jordan in the reference's order (GridH.cpp:378-419), so each step is
one elementwise op over all queries.  NaN appears only in outputs
(out-of-bounds, no candidates), never in grid state.
"""

from __future__ import annotations

import torch

from ..config import IDWConfig, KrigingConfig
from ..grid import RegularGrid, as_dtype, divisor
from .window import fetch_masked, masked_mean, nan_plane, window_select


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def queries(grid: RegularGrid, lons, lats):
    """(lons, lats) as tensors of the grid's dtype on its device."""
    lons = torch.as_tensor(lons).to(device=grid.device, dtype=grid.dtype)
    lats = torch.as_tensor(lats).to(device=grid.device, dtype=grid.dtype)
    return lons, lats


def _normalize(grid: RegularGrid, lons, lats):
    """lon/lat -> grid coords + strict out-of-bounds mask (GridH.cpp:162-168),
    in the grid's dtype, as the compiled JAX ops compute them:
    ``(lon - min_lon) * inv_step`` with ``min_lon`` rounded to that dtype and
    ``inv_step`` the reciprocal of the rounded step in it
    (:meth:`RegularGrid.inv_steps`; XLA folds the division by the static
    step into that multiply).  OOB coords are zeroed so downstream indices
    stay in range."""
    lons, lats = queries(grid, lons, lats)
    dt = grid.dtype
    min_lon, max_lon = as_dtype(grid.min_lon, dt), as_dtype(grid.max_lon, dt)
    min_lat, max_lat = as_dtype(grid.min_lat, dt), as_dtype(grid.max_lat, dt)
    oob = (lons < min_lon) | (lons > max_lon) | (lats < min_lat) | (lats > max_lat)
    inv_lon, inv_lat = grid.inv_steps()
    x = (lons - min_lon) * inv_lon
    y = (lats - min_lat) * inv_lat
    zero = torch.zeros_like(x)
    return torch.where(oob, zero, x), torch.where(oob, zero, y), oob


def as_index(v, dtype: torch.dtype = torch.int32):
    """A float coordinate cast to an integer as XLA casts it: NaN to 0.  A
    NaN query is not out of bounds (every comparison with NaN is false), so
    it reaches the casts; torch's CPU cast would give the most negative
    integer (CUDA's ``cvt`` gives 0).  Every float -> int cast of a query
    coordinate goes through here, and the kernels that cast in place (B11)
    follow the same rule."""
    return torch.where(torch.isnan(v), torch.zeros_like(v), v).to(dtype)


def saturating_index(v, dtype: torch.dtype = torch.int32):
    """A float cast to an integer as XLA casts it everywhere: NaN to 0, and
    ±inf and values beyond the integer's range to its limits (torch's CPU
    cast gives the most negative integer for all three).  For coordinates
    that nothing bounds before the cast, such as B8's pings; in range it is
    :func:`as_index` bit for bit."""
    info = torch.iinfo(dtype)
    hi = v >= -float(info.min)  # 2**31 (2**63): exact in f32 and f64
    lo = v < float(info.min)
    idx = as_index(torch.where(hi | lo, torch.zeros_like(v), v), dtype)
    return torch.where(hi, info.max, torch.where(lo, info.min, idx))


def centre_cells(grid: RegularGrid, x, y):
    """Window centre: round half away from zero, clamped (kernels.cu:425-432);
    a NaN coordinate takes cell 0 (:func:`as_index`)."""
    ci = as_index(torch.floor(x + 0.5)).clamp(0, grid.num_lon - 1)
    cj = as_index(torch.floor(y + 0.5)).clamp(0, grid.num_lat - 1)
    return ci, cj


def _nan_like(t):
    return torch.full_like(t, float("nan"))


# ---------------------------------------------------------------------------
# bilinear
# ---------------------------------------------------------------------------

def scattered_bilinear(grid: RegularGrid, lons, lats):
    """Bilinear at scattered points; the mean of the valid corners where any
    corner is invalid, NaN out of bounds (kernels.cu:173-234)."""
    x, y, oob = _normalize(grid, lons, lats)
    x0 = as_index(torch.floor(x))
    y0 = as_index(torch.floor(y))
    x1 = torch.clamp(x0 + 1, max=grid.num_lon - 1)
    y1 = torch.clamp(y0 + 1, max=grid.num_lat - 1)
    wx = x - x0
    wy = y - y0

    nanp = nan_plane(grid)
    z00, m00 = fetch_masked(nanp, y0, x0, grid.num_lon)
    z01, m01 = fetch_masked(nanp, y0, x1, grid.num_lon)
    z10, m10 = fetch_masked(nanp, y1, x0, grid.num_lon)
    z11, m11 = fetch_masked(nanp, y1, x1, grid.num_lon)

    z0 = (1 - wx) * z00 + wx * z01
    z1 = (1 - wx) * z10 + wx * z11
    z = (1 - wy) * z0 + wy * z1

    dt = grid.dtype
    cnt = m00.to(dt) + m01.to(dt) + m10.to(dt) + m11.to(dt)
    s = z00 + z01 + z10 + z11  # invalid corners read 0
    fb = torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), _nan_like(s))
    out = torch.where(cnt < 4, fb, z)
    return torch.where(oob, _nan_like(out), out)


# ---------------------------------------------------------------------------
# bicubic (Catmull-Rom)
# ---------------------------------------------------------------------------

def _catmull_rom(p0, p1, p2, p3, t):
    return 0.5 * (
        2 * p1
        + (-p0 + p2) * t
        + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t * t
        + (-p0 + 3 * p1 - 3 * p2 + p3) * t * t * t
    )


def scattered_bicubic(grid: RegularGrid, lons, lats, *, fallback: str = "auto", max_radius: int = 10, convention: str = "reference"):
    """4x4 Catmull-Rom stencil with clamped edges; the window mean of the 4
    nearest valid cells when any of the 16 cells is invalid
    (kernels.cu:305-371).

    fallback: 'auto' (compute the window path, select per query) or 'never'
    (skip the window entirely: correct for fully valid grids, e.g. Grid A).
    """
    if fallback not in ("auto", "never"):
        raise ValueError(fallback)
    x, y, oob = _normalize(grid, lons, lats)
    xi = as_index(torch.floor(x))
    yi = as_index(torch.floor(y))
    tx = x - xi
    ty = y - yi

    nanp = nan_plane(grid)
    rows = []
    all_valid = None
    for m in range(-1, 3):
        jj = torch.clamp(yi + m, 0, grid.num_lat - 1)
        ps = []
        for n in range(-1, 3):
            ii = torch.clamp(xi + n, 0, grid.num_lon - 1)
            v, ok = fetch_masked(nanp, jj, ii, grid.num_lon)
            ps.append(v)
            all_valid = ok if all_valid is None else (all_valid & ok)
        rows.append(_catmull_rom(ps[0], ps[1], ps[2], ps[3], tx))
    smooth = _catmull_rom(rows[0], rows[1], rows[2], rows[3], ty)

    if fallback == "never":
        out = smooth
    else:
        sel = window_select(grid, x, y, xi, yi, k=4, max_radius=max_radius, convention=convention)
        fb = masked_mean(sel["val"], sel["slot_ok"])
        out = torch.where(all_valid, smooth, fb)
    return torch.where(oob, _nan_like(out), out)


# ---------------------------------------------------------------------------
# ordinary kriging
# ---------------------------------------------------------------------------


def variogram(h, params):
    """gamma(h) = nugget + sill (1 - exp(-h/range)), h in degrees
    (GridH.cpp:371-376).  ``params`` is (nugget, sill, range): floats or
    0-d tensors (fitted variograms).  No clamp on range."""
    nugget, sill, rng = params
    return nugget + sill * (1.0 - torch.exp(-h / divisor(rng, h)))


def krige_solve(qlon, qlat, vals, cx, cy, cfg: KrigingConfig = KrigingConfig(), vparams=None, model: str = "exponential", with_variance: bool = False, solver: str = "gj"):
    """Batched ordinary kriging with neighbours in (N, 4) ``vals``/``cx``/``cy``
    and queries at (N,) ``qlon``/``qlat``.  Returns (pred, singular), plus the
    prediction variance sigma^2 = sum_i w_i gamma(h_i0) + mu when
    ``with_variance``."""
    return krige_solve_cols(
        qlon, qlat,
        [vals[:, a] for a in range(4)],
        [cx[:, a] for a in range(4)],
        [cy[:, a] for a in range(4)],
        cfg, vparams=vparams, model=model, with_variance=with_variance, solver=solver,
    )


def gj56(M, pivot_tol):
    """Unpivoted Gauss-Jordan on a 5x6 system held as 30 (N,) tensors
    (GridH.cpp:378-419 elimination order).  Returns (M, singular); column 5
    holds the solution on non-singular rows.  Once a pivot is singular every
    later pivot divides by 1."""
    singular = torch.zeros(M[0][0].shape, dtype=torch.bool, device=M[0][0].device)
    for i in range(5):
        pivot = M[i][i]
        singular = singular | (torch.abs(pivot) < pivot_tol)
        safe = torch.where(singular, torch.ones_like(pivot), pivot)
        for q in range(i, 6):
            M[i][q] = M[i][q] / safe
        for r in range(5):
            if r == i:
                continue
            f = M[r][i]
            for q in range(i, 6):
                M[r][q] = M[r][q] - f * M[i][q]
    return M, singular


def lu56(M, pivot_tol):
    """Forward elimination + back substitution on the same unpivoted pivots
    as :func:`gj56` (the fused kernel's ``solver='lu'``,
    pallas/window_fill.py:800-822).  Returns (solution as 5 (N,) tensors,
    singular); agrees with gj56 to f32 round-off."""
    singular = torch.zeros(M[0][0].shape, dtype=torch.bool, device=M[0][0].device)
    rp = [None] * 5
    for p in range(5):
        pivot = M[p][p]
        singular = singular | (torch.abs(pivot) < pivot_tol)
        rp[p] = 1.0 / torch.where(singular, torch.ones_like(pivot), pivot)
        for r in range(p + 1, 5):
            f = M[r][p] * rp[p]
            for q in range(p + 1, 6):
                M[r][q] = M[r][q] - f * M[p][q]
    lam = [None] * 5
    for p in reversed(range(5)):
        acc = M[p][5]
        for q in range(p + 1, 5):
            acc = acc - M[p][q] * lam[q]
        lam[p] = acc * rp[p]
    return lam, singular


def krige_solve_cols(qlon, qlat, vals, cx, cy, cfg: KrigingConfig = KrigingConfig(), vparams=None, model: str = "exponential", with_variance: bool = False, solver: str = "gj"):
    """Column form of :func:`krige_solve`: ``vals``/``cx``/``cy`` are length-4
    sequences of (N,) tensors.  ``solver`` is 'gj' (:func:`gj56`, the
    reference's) or 'lu' (:func:`lu56`)."""
    vg = (
        vparams
        if vparams is not None
        else (cfg.variogram.nugget, cfg.variogram.sill, cfg.variogram.range)
    )
    if model == "exponential":
        vf = lambda h: variogram(h, vg)
    else:
        from ..variogram import variogram_model

        vf = lambda h: variogram_model(h, vg, model)
    ones = torch.ones_like(vals[0])

    M = [[None] * 6 for _ in range(5)]
    for a in range(4):
        for b in range(4):
            if b < a:
                M[a][b] = M[b][a]  # symmetric distances
                continue
            dx = cx[a] - cx[b]
            dy = cy[a] - cy[b]
            M[a][b] = vf(torch.sqrt(dx * dx + dy * dy))
        M[a][4] = ones
        ddx = cx[a] - qlon
        ddy = cy[a] - qlat
        M[a][5] = vf(torch.sqrt(ddx * ddx + ddy * ddy))
    gamma0 = [M[a][5] for a in range(4)]  # gamma(h_i0), before elimination
    M[4] = [ones] * 4 + [torch.zeros_like(ones), ones]

    if solver == "gj":
        M, singular = gj56(M, cfg.pivot_tol)
        lam = [M[a][5] for a in range(5)]
    elif solver == "lu":
        lam, singular = lu56(M, cfg.pivot_tol)
    else:
        raise ValueError(solver)

    # the weights w_i (i < 4) and the Lagrange multiplier mu = lam[4]
    pred = lam[0] * vals[0] + lam[1] * vals[1] + lam[2] * vals[2] + lam[3] * vals[3]
    if not with_variance:
        return pred, singular
    var = sum(lam[a] * gamma0[a] for a in range(4)) + lam[4]
    return pred, singular, torch.clamp(var, min=0.0)


def cell_centres(grid: RegularGrid, ci, cj, dx, dy, half: float):
    """Neighbour coordinates in degrees: ``min + (c + d + half) * step`` in
    the grid's dtype, with ``c`` (N,) integer centres and ``d`` (N, k)
    float offsets."""
    dt = grid.dtype
    cx = as_dtype(grid.min_lon, dt) + (ci.to(dt)[:, None] + dx + half) * as_dtype(grid.lon_step, dt)
    cy = as_dtype(grid.min_lat, dt) + (cj.to(dt)[:, None] + dy + half) * as_dtype(grid.lat_step, dt)
    return cx, cy


def scattered_kriging(grid: RegularGrid, lons, lats, *, max_radius: int = 10, convention: str = "reference", with_variance: bool = False):
    """Window top-4 + exponential variogram + batched 5x5 solve
    (krigingInterpolationKernel, kernels.cu:403-546).

    with_variance=True also returns the ordinary-kriging prediction variance
    (NaN at fallback / out-of-bounds queries)."""
    cfg = KrigingConfig()
    x, y, oob = _normalize(grid, lons, lats)
    ci, cj = centre_cells(grid, x, y)
    sel = window_select(grid, x, y, ci, cj, k=4, max_radius=max_radius, convention=convention)
    half = 0.5 if convention == "reference" else 0.0
    dt = grid.dtype
    cx = as_dtype(grid.min_lon, dt) + (sel["ii"].to(dt) + half) * as_dtype(grid.lon_step, dt)
    cy = as_dtype(grid.min_lat, dt) + (sel["jj"].to(dt) + half) * as_dtype(grid.lat_step, dt)

    vals = torch.where(sel["slot_ok"], sel["val"], torch.zeros_like(sel["val"]))
    qlon, qlat = queries(grid, lons, lats)
    solved = krige_solve(qlon, qlat, vals, cx, cy, cfg, with_variance=with_variance)
    pred, singular = solved[0], solved[1]
    fb = masked_mean(sel["val"], sel["slot_ok"])
    bail = singular | (sel["found"] < 4)
    out = torch.where(oob, _nan_like(pred), torch.where(bail, fb, pred))
    if not with_variance:
        return out
    var = torch.where(oob | bail, _nan_like(pred), solved[2])
    return out, var


# ---------------------------------------------------------------------------
# IDW (k-nearest inverse-distance weighting)
# ---------------------------------------------------------------------------

def scattered_idw(grid: RegularGrid, lons, lats, *, k: int = 8, power: float = 2.0, max_radius: int = 10, convention: str = "reference"):
    """k-nearest masked IDW in index space with weights 1/(d^p + eps); the
    distance convention matches the fallback search, so IDW(k=4, p=0) equals
    the reference's fallback average."""
    cfg = IDWConfig(k=k, power=power, max_radius=max_radius)
    x, y, oob = _normalize(grid, lons, lats)
    ci, cj = centre_cells(grid, x, y)
    sel = window_select(grid, x, y, ci, cj, k=cfg.k, max_radius=cfg.max_radius, convention=convention)
    w = torch.where(
        sel["slot_ok"],
        1.0 / (torch.pow(sel["d2"], cfg.power / 2.0) + cfg.eps),
        torch.zeros_like(sel["d2"]),
    )
    ws = w.sum(dim=1)
    out = torch.where(ws > 0, (w * sel["val"]).sum(dim=1) / torch.clamp(ws, min=cfg.eps), _nan_like(ws))
    return torch.where(oob, _nan_like(out), out)
