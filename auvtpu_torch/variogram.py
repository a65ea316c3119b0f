"""Isotropic variogram estimation and fitting (counterpart of the isotropic
part of :mod:`auvtpu.variogram`).

:func:`empirical_variogram` bins the Matheron semivariance of the valid cells
by integer lag from shifted-plane pair sums; :func:`fit_model` fits
(nugget, p1, p2) by damped Gauss-Newton in log-parameter space with a fixed
iteration count.  The parameters stay on the grid's device throughout: no
value is read back to the host inside the loop.

The fit lands in a nearly linear regime on real bathymetry, where only
sill/range and the nugget are pinned down, so two frameworks can return
parameters 15-21 % apart whose fitted gamma curves agree to 3e-4; compare
fits through gamma and through the fill, never through the raw parameters.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .grid import RegularGrid, divisor


@lru_cache(maxsize=8)
def _lag_offsets(max_lag: int):
    """Unique half-plane offsets (dy, dx) with 0 < ||.|| <= max_lag; the half
    plane (dy > 0) | (dy == 0 & dx > 0) counts each pair once."""
    offs = []
    for dy in range(0, max_lag + 1):
        for dx in range(-max_lag, max_lag + 1):
            if dy == 0 and dx <= 0:
                continue
            h = np.hypot(dx, dy)
            if 0 < h <= max_lag:
                offs.append((dy, dx, h))
    arr = np.asarray(offs, dtype=np.float64)
    return (
        arr[:, 0].astype(np.int32),
        arr[:, 1].astype(np.int32),
        arr[:, 2].astype(np.float32),
    )


def _bin_table(max_lag: int, n_bins: int):
    dys, dxs, hs = _lag_offsets(max_lag)
    edges = np.linspace(0.0, float(max_lag), n_bins + 1)
    bin_of = np.clip(np.digitize(np.asarray(hs), edges) - 1, 0, n_bins - 1).astype(np.int32)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return dys, dxs, bin_of, centers


def _pair_sums_binned(elev, valid, n_base_rows: int, dys, dxs, bin_of, n_out: int, max_lag: int):
    """Pair accumulator over an offset -> bin table: base cells are the first
    ``n_base_rows`` rows; offsets add into their bins in table order."""
    H = n_base_rows
    W = elev.shape[1]
    R = max_lag
    pe = F.pad(elev, (R, R))
    pv = F.pad(valid, (R, R))
    base_e = elev[:H]
    base_v = valid[:H]
    s = torch.zeros(n_out, dtype=elev.dtype, device=elev.device)
    c = torch.zeros(n_out, dtype=elev.dtype, device=elev.device)
    for dy, dx, b in zip(dys.tolist(), dxs.tolist(), bin_of.tolist()):
        zv = pe[dy:dy + H, R + dx:R + dx + W]
        mv = pv[dy:dy + H, R + dx:R + dx + W]
        both = base_v * mv
        d = (base_e - zv) * both
        s[b] += torch.sum(d * d)
        c[b] += torch.sum(both)
    return s, c


def pair_sums(elev, valid, n_base_rows: int, *, max_lag: int = 10, n_bins: int = 10):
    """Binned (sum of squared differences, pair counts) with base cells in the
    first ``n_base_rows`` rows of ``elev``/``valid`` ((n_base_rows + max_lag,
    W) planes) and half-plane offsets, so every pair counts once."""
    dys, dxs, bin_of, _ = _bin_table(max_lag, n_bins)
    return _pair_sums_binned(elev, valid, n_base_rows, dys, dxs, bin_of, n_bins, max_lag)


def empirical_variogram(grid: RegularGrid, *, max_lag: int = 10, n_bins: int = 10):
    """Binned Matheron semivariance of the valid cells.

    Returns (lag_centers (n_bins,), gamma (n_bins,), counts (n_bins,)) on the
    grid's device, lags in index space; gamma(h) = sum (z_i - z_j)^2 / (2 N_h).
    """
    H, W = grid.shape
    R = max_lag
    elev = F.pad(grid.elev, (0, 0, 0, R))
    valid = F.pad(grid.valid, (0, 0, 0, R))
    s, c = pair_sums(elev, valid, H, max_lag=max_lag, n_bins=n_bins)
    gamma = torch.where(c > 0, s / (2.0 * torch.clamp(c, min=1.0)), torch.zeros_like(s))
    _, _, _, centers = _bin_table(max_lag, n_bins)
    return torch.as_tensor(centers, dtype=grid.dtype).to(grid.device), gamma, c


def variogram_model(h, params, model: str = "exponential"):
    """Model zoo; ``params`` is always (nugget, p1, p2), p2 clamped >= 1e-6:
      exponential: gamma = nugget + p1 (1 - e^(-h/p2))   (GridH.cpp:371-376)
      linear:      gamma = nugget + p1 h                 (p2 unused)
      spherical:   gamma = nugget + p1 (1.5 m - 0.5 m^3), m = min(h/p2, 1)
      gaussian:    gamma = nugget + p1 (1 - e^(-(h/p2)^2))
    """
    nugget, p1, p2 = params
    p2 = divisor(torch.clamp(p2, min=1e-6) if torch.is_tensor(p2) else max(p2, 1e-6), h)
    if model == "exponential":
        return nugget + p1 * (1.0 - torch.exp(-h / p2))
    if model == "linear":
        return nugget + p1 * h
    if model == "spherical":
        m = torch.clamp(h / p2, max=1.0)
        return nugget + p1 * (1.5 * m - 0.5 * m**3)
    if model == "gaussian":
        return nugget + p1 * (1.0 - torch.exp(-((h / p2) ** 2)))
    raise ValueError(model)


def fit_model(lags, gamma, counts, *, model: str = "exponential", iters: int = 30):
    """Weighted Gauss-Newton fit of a variogram model in log-parameter space
    (positive by construction), Levenberg-damped, for a fixed ``iters``
    steps; a step is kept only if it does not raise the weighted SSE.
    Weights are the pair counts.  Returns (nugget, p1, p2) as 0-d tensors on
    the device of ``gamma``."""
    dt = gamma.dtype
    dev = gamma.device
    w = counts / torch.clamp(counts.sum(), min=1.0)
    # data-driven init: sill ~ max gamma, range ~ a third of max lag, nugget
    # ~ 1% of sill
    sill0 = torch.clamp(torch.max(gamma), min=1e-3)
    maxlag = torch.clamp(torch.max(lags), min=1e-9)
    p1_0 = sill0 / maxlag if model == "linear" else sill0
    theta = torch.log(torch.stack([0.01 * sill0, p1_0, maxlag / 3.0]).to(dt))
    sw = torch.sqrt(w)

    def resid(th):
        return (variogram_model(lags, torch.exp(th), model) - gamma) * sw

    jac = torch.func.jacfwd(resid)
    eye = torch.eye(3, dtype=dt, device=dev)
    for _ in range(iters):
        r = resid(theta)
        J = jac(theta)
        A = J.T @ J
        damp = 1e-4 * torch.clamp(torch.trace(A) / 3.0, min=1e-12)
        g = J.T @ r
        # solve_ex: no error check, so no device-to-host sync in the loop
        delta, _ = torch.linalg.solve_ex(A + damp * eye, g)
        # trust region on the log step keeps early iterations stable
        delta = torch.clamp(delta, -2.0, 2.0)
        new = theta - delta
        better = torch.sum(resid(new) ** 2) <= torch.sum(r**2)
        theta = torch.where(better, new, theta)
    p = torch.exp(theta)
    return p[0], p[1], p[2]


def fit_exponential(lags, gamma, counts, *, iters: int = 30):
    """Exponential-model fit (the reference's model); see :func:`fit_model`."""
    return fit_model(lags, gamma, counts, model="exponential", iters=iters)


def fit_best_model(lags, gamma, counts, *, models=("exponential", "linear", "spherical", "gaussian"), iters: int = 30):
    """Fit every candidate model and keep the lowest weighted SSE.

    Returns (model_name, (nugget, p1, p2), sse) with python floats: the
    choice is data-dependent, so this is a host step with one readback per
    candidate.
    """
    best = None
    w = counts.detach().cpu().double()
    w = w / max(float(w.sum()), 1.0)
    g = gamma.detach().cpu().double()
    h = lags.detach().cpu().double()
    for m in models:
        p = tuple(float(v) for v in fit_model(lags, gamma, counts, model=m, iters=iters))
        r = variogram_model(h, p, m) - g
        sse = float((w * r * r).sum())
        if best is None or sse < best[2]:
            best = (m, p, sse)
    return best


def fit_variogram(grid: RegularGrid, *, max_lag: int = 10, n_bins: int = 10, iters: int = 25):
    """Empirical variogram + exponential fit, lags scaled from index space to
    degrees by the mean grid step.  Returns (nugget, sill, range) as 0-d
    tensors on the grid's device."""
    lags, gamma, counts = empirical_variogram(grid, max_lag=max_lag, n_bins=n_bins)
    step = 0.5 * (abs(grid.lat_step) + abs(grid.lon_step))
    return fit_exponential(lags * step, gamma, counts, iters=iters)
