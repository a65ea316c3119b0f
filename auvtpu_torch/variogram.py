"""Variogram estimation and fitting (counterpart of :mod:`auvtpu.variogram`).

:func:`empirical_variogram` bins the Matheron semivariance of the valid cells
by integer lag from shifted-plane pair sums; :func:`fit_model` fits
(nugget, p1, p2) by damped Gauss-Newton in log-parameter space with a fixed
iteration count.  :func:`empirical_variogram_directional` bins the same pair
sums by (azimuth sector, lag) and :func:`fit_anisotropic` fits an ellipse
(nugget, sill, rx, ry, theta) to them by Levenberg-Marquardt.  The
parameters stay on the grid's device throughout: no value is read back to
the host inside a loop.  On the card the pair sums are one call of B9 and
the Gauss-Newton loop one launch of B10 (:mod:`auvtpu_torch.kernels.variogram`,
``csrc/variogram.cu``); on the CPU they run the kernels' plain twins.
:func:`fit_variogram` hands B9's sums to B10 as they are, with what does
not change between calls (B9's offset table, the lags) made once per grid
geometry (:func:`_fit_plan`); each of its calls adds one to the counter
``fit.fits``.

The fit lands in a nearly linear regime on real bathymetry, where only
sill/range and the nugget are pinned down: the weighted SSE then has no
finite minimum, and a loop walks along the sill/range ridge until its
last-bit noise rejects a step, which depends on the device.  So
:func:`fit_model` runs in float64 and stops where the data stop pinning
the walk (:data:`STOP_DGAMMA`), and two fits land in one place; fits from
another framework are compared through gamma and through the fill, never
through the raw parameters.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .grid import RegularGrid, device_cache, divisor
from .kernels import variogram as kv
from .utils.profiling import counters, spanned

FIT = counters("fit", ("fits",))


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


def pair_sums(elev, valid, n_base_rows: int, *, max_lag: int = 10, n_bins: int = 10):
    """Binned (sum of squared differences, pair counts) with base cells in the
    first ``n_base_rows`` rows of ``elev``/``valid`` ((n_base_rows + max_lag,
    W) planes; partners below the plane or past its columns read as zero)
    and half-plane offsets, so every pair counts once.  The sums are
    float64 (squared differences in the planes' dtype, counts exact): a
    caller rounds them once, after adding any blocks' sums.  On the card:
    B9 (:func:`auvtpu_torch.kernels.variogram.pair_sums`)."""
    dys, dxs, bin_of, _ = _bin_table(max_lag, n_bins)
    return kv.pair_sums(elev, valid, n_base_rows, elev.shape[1], 0, dys, dxs, bin_of, n_bins, max_lag)


def pair_sums_2d(elev, valid, n_base_rows: int, n_base_cols: int, *, max_lag: int = 10, n_bins: int = 10):
    """:func:`pair_sums` for a 2-D block of a larger grid.

    The half-plane offsets have dy >= 0 but dx in [-max_lag, max_lag], so a
    block that does not own whole rows needs column halos on both sides.
    Layout, as ``auvtpu.variogram.pair_sums_2d``::

        elev/valid: (n_base_rows + max_lag, n_base_cols + 2*max_lag)
        base cells: [:n_base_rows, max_lag : max_lag + n_base_cols]

    with the bottom strip (and its corners) from the neighbours' halos; the
    block owning a pair's first point counts it, so every pair counts once
    over the mesh.  The sums are float64, as :func:`pair_sums`'s."""
    dys, dxs, bin_of, _ = _bin_table(max_lag, n_bins)
    return kv.pair_sums(elev, valid, n_base_rows, n_base_cols, max_lag, dys, dxs, bin_of, n_bins, max_lag)


def empirical_variogram(grid: RegularGrid, *, max_lag: int = 10, n_bins: int = 10):
    """Binned Matheron semivariance of the valid cells.

    Returns (lag_centers (n_bins,), gamma (n_bins,), counts (n_bins,)) on the
    grid's device, lags in index space; gamma(h) = sum (z_i - z_j)^2 / (2 N_h).
    """
    s, c = pair_sums(grid.elev, grid.valid, grid.shape[0], max_lag=max_lag, n_bins=n_bins)
    gamma, c = kv.binned_gamma(s, c, grid.dtype)
    return _device_centers(max_lag, n_bins, 1, 1.0, grid.dtype, grid.device)[0], gamma, c


@device_cache(maxsize=16)
def _device_centers(max_lag: int, n_bins: int, n_sectors: int, aspect: float, dtype: torch.dtype,
                    device: torch.device):
    """The lag centres and sector angles of the (sector, lag) bins as tensors
    on ``device``, made once: a copy from host memory would make the host
    wait for the card (a pageable copy synchronises the stream) between the
    pair sums and the fit."""
    _, _, _, centers, angles = _sector_bin_table(max_lag, n_bins, n_sectors, aspect)
    return torch.as_tensor(centers, dtype=dtype).to(device), torch.as_tensor(angles, dtype=dtype).to(device)


# ---------------------------------------------------------------------------
# directional / anisotropic variograms
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def _sector_bin_table(max_lag: int, n_bins: int, n_sectors: int, aspect: float = 1.0):
    """Offset -> (sector, lag-bin) flat table.  Half-plane offsets cover
    azimuths [0, pi); sector s spans [s, s+1) * pi/n_sectors.  ``aspect`` =
    lat_step/lon_step turns index offsets into physical geometry (rows are
    ``aspect`` times as long as columns), so a grid whose steps differ does
    not report its aspect as anisotropy; lags are in lon-step units."""
    dys, dxs, _ = _lag_offsets(max_lag)
    dyp = dys.astype(np.float64) * aspect
    dxp = dxs.astype(np.float64)
    hs = np.hypot(dxp, dyp)
    hmax = float(max_lag) * max(1.0, aspect)
    edges = np.linspace(0.0, hmax, n_bins + 1)
    bin_of = np.clip(np.digitize(hs, edges) - 1, 0, n_bins - 1)
    ang = np.mod(np.arctan2(dyp, dxp), np.pi)
    sector_of = np.clip(np.floor(ang / (np.pi / n_sectors)).astype(np.int64), 0, n_sectors - 1)
    flat = (sector_of * n_bins + bin_of).astype(np.int32)
    centers = 0.5 * (edges[:-1] + edges[1:])
    angles = (np.arange(n_sectors) + 0.5) * np.pi / n_sectors
    return dys, dxs, flat, centers, angles


def empirical_variogram_directional(grid: RegularGrid, *, max_lag: int = 10, n_bins: int = 10, n_sectors: int = 4, aspect: float = 1.0):
    """Directional Matheron semivariance, binned by (azimuth sector, lag).

    Returns (lag_centers (n_bins,), sector_angles (n_sectors,), gamma
    (n_sectors, n_bins), counts (n_sectors, n_bins)) on the grid's device,
    lags in lon-step units under the physical ``aspect`` = lat_step/lon_step
    (1.0 = index space).  :func:`empirical_variogram` is its n_sectors=1
    marginal."""
    dys, dxs, flat, centers, angles = _sector_bin_table(max_lag, n_bins, n_sectors, aspect)
    H, W = grid.shape
    s, c = kv.pair_sums(grid.elev, grid.valid, H, W, 0, dys, dxs, flat, n_sectors * n_bins, max_lag)
    gamma, c = (t.reshape(n_sectors, n_bins) for t in kv.binned_gamma(s, c, grid.dtype))
    centers, angles = _device_centers(max_lag, n_bins, n_sectors, aspect, grid.dtype, grid.device)
    return centers, angles, gamma, c


def _aniso_h(h, ang, rx, ry, theta):
    """Reduced (dimensionless) lag: the ellipse metric ||T h_vec|| with
    principal ranges (rx, ry) and major-axis azimuth theta."""
    ca = torch.cos(ang - theta)
    sa = torch.sin(ang - theta)
    return h * torch.sqrt((ca / rx) ** 2 + (sa / ry) ** 2)


def fit_anisotropic(lags, angles, gamma, counts, *, model: str = "exponential", iters: int = 40, init=None):
    """Weighted Levenberg-Marquardt fit of (nugget, sill, rx, ry, theta) on
    the directional empirical variogram: gamma(h, phi) = model(h', 1) with
    h' the ellipse-reduced lag.  Nugget, sill and the ranges are fit in log
    space, the ranges boxed to [hmax/50, 3 hmax] (outside the observed lags
    a misspecified model's optimum is degenerate); theta is free (period
    pi; :func:`normalize_aniso` gives a canonical form).  Without ``init``
    it starts from four orientations and keeps the fit of least weighted
    SSE (the landscape is multimodal in theta).  Returns five 0-d tensors
    on the device of ``gamma``."""
    dt, dev = gamma.dtype, gamma.device
    S, B = gamma.shape
    hh = lags[None, :].expand(S, B).reshape(-1)
    aa = angles[:, None].expand(S, B).reshape(-1)
    gg = gamma.reshape(-1)
    w = counts.reshape(-1)
    w = w / torch.clamp(w.sum(), min=1.0)
    if init is None:
        sill0 = torch.clamp(torch.max(gg), min=1e-3)
        maxlag = torch.clamp(torch.max(lags), min=1e-9)
        init_log = torch.log(torch.stack([0.01 * sill0, sill0, maxlag / 3.0, maxlag / 6.0]).to(dt))
        theta0s = [0.0, np.pi / 4, np.pi / 2, 3 * np.pi / 4]
    else:
        nug0, sill0, rx0, ry0, th0 = (torch.as_tensor(v, dtype=dt, device=dev) for v in init)
        init_log = torch.log(torch.stack([nug0, sill0, rx0, ry0]))
        theta0s = [th0]
    sw = torch.sqrt(w)
    one = torch.ones((), dtype=dt, device=dev)

    def resid(tv):
        nugget, sill, rx, ry = torch.exp(tv[0]), torch.exp(tv[1]), torch.exp(tv[2]), torch.exp(tv[3])
        hp = _aniso_h(hh, aa, rx, ry, tv[4])
        return (variogram_model(hp, (nugget, sill, one), model) - gg) * sw

    jac = torch.func.jacfwd(resid)
    hmax = torch.clamp(torch.max(lags), min=1e-9)
    lr_lo = torch.log(hmax / 50.0)
    lr_hi = torch.log(3.0 * hmax)

    def fit_from(theta0):
        tv = torch.cat([init_log, torch.as_tensor(theta0, dtype=dt, device=dev).reshape(1)])
        lam = torch.tensor(1e-3, dtype=dt, device=dev)
        for _ in range(iters):
            r = resid(tv)
            J = jac(tv)
            A = J.T @ J
            g = J.T @ r
            dA = torch.diag(torch.clamp(torch.diag(A), min=1e-12))
            # solve_ex: no error check, so no device-to-host sync in the loop
            delta, _ = torch.linalg.solve_ex(A + lam * dA, g)
            delta = torch.clamp(delta, -1.0, 1.0)
            new = tv - delta
            new = torch.cat([new[:2], torch.clamp(new[2:4], lr_lo, lr_hi), new[4:5]])
            better = torch.sum(resid(new) ** 2) <= torch.sum(r**2)
            tv = torch.where(better, new, tv)
            lam = torch.where(better, torch.clamp(lam / 3.0, min=1e-9), torch.clamp(lam * 10.0, max=1e9))
        return tv, torch.sum(resid(tv) ** 2)

    fits = [fit_from(t0) for t0 in theta0s]
    tvs = torch.stack([f[0] for f in fits])
    tv = tvs[torch.argmin(torch.stack([f[1] for f in fits]))]
    return torch.exp(tv[0]), torch.exp(tv[1]), torch.exp(tv[2]), torch.exp(tv[3]), tv[4]


def normalize_aniso(params):
    """Canonical host form of (nugget, sill, rx, ry, theta): rx >= ry (major
    axis first) and theta in [0, pi), as python floats."""
    nugget, sill, rx, ry, theta = (float(v) for v in params)
    if ry > rx:
        rx, ry = ry, rx
        theta += np.pi / 2.0
    return nugget, sill, rx, ry, float(np.mod(theta, np.pi))


def anisotropy_matrix(rx, ry, theta, dtype=np.float64):
    """Host 2x2 T with ||T h_vec|| = reduced lag: rotate azimuth theta onto
    +x, then scale the axes by (1/rx, 1/ry).  Coordinates transformed by T
    turn anisotropic kriging into isotropic kriging with unit range."""
    c, s = np.cos(theta), np.sin(theta)
    return np.asarray([[c / rx, s / rx], [-s / ry, c / ry]], dtype)


def fit_variogram_directional(grid: RegularGrid, *, max_lag: int = 10, n_bins: int = 10, n_sectors: int = 4, model: str = "exponential", iters: int = 40):
    """Directional empirical variogram + anisotropic fit in physical
    geometry (per-axis grid steps, so a non-square cell cannot pass for
    anisotropy).  Returns (nugget, sill, rx, ry, theta) as 0-d tensors,
    ranges in degrees, theta from the lon axis."""
    aspect = float(round(abs(grid.lat_step) / max(abs(grid.lon_step), 1e-300), 6))
    lags, angles, gamma, counts = empirical_variogram_directional(
        grid, max_lag=max_lag, n_bins=n_bins, n_sectors=n_sectors, aspect=aspect)
    return fit_anisotropic(lags * abs(grid.lon_step), angles, gamma, counts, model=model, iters=iters)


def exponential_model(h, params):
    """The exponential model, gamma = nugget + sill (1 - e^(-h / range)),
    ``params`` = (nugget, sill, range); :func:`variogram_model`'s."""
    return variogram_model(h, params, "exponential")


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


# The walk's stop: the first kept step that moves the fitted gamma by less
# than this (largest relative change over the bins with pairs) is the last.
# On the Kerguelen stand-in r0.10 the ridge's steps move gamma by 1.55e-4
# (step 7) and 8.6e-5 (step 8), against float64 noise of ~1e-10 between
# devices, so every device stops after step 8.  A fit with a true minimum
# stops within a few such steps of it (the damping makes the last ones
# short): its gamma within ~1e-3.
STOP_DGAMMA = 1e-4


def fit_model(lags, gamma, counts, *, model: str = "exponential", iters: int = 30, init=None):
    """Weighted Gauss-Newton fit of a variogram model in log-parameter space
    (positive by construction), Levenberg-damped, for at most ``iters``
    steps; a step is kept only if it does not raise the weighted SSE.
    Weights are the pair counts.  ``init``: the (nugget, p1, p2) to start
    from, else a data-driven start.

    The loop runs in float64 whatever the inputs' dtype, and freezes the
    parameters after the first kept step that moves the fitted gamma by
    less than :data:`STOP_DGAMMA` at every bin with pairs: where the SSE
    has no finite minimum (a linear-looking gamma, the exponential's range
    free to grow) the walk stops where the data stop pinning it, in the
    same place on every device.  Nothing is read back to the host: the
    decision stays on the device (B10 ends its walk at the first step that
    is not kept or that freezes, after which the parameters cannot change;
    the plain loop runs all ``iters`` steps with the freeze as a flag).
    Returns (nugget, p1, p2) as 0-d tensors in the dtype and on the device
    of ``gamma``."""
    return kv.fit_model(lags, gamma, counts, model=model, iters=iters, init=init, stop=STOP_DGAMMA)


def fit_exponential(lags, gamma, counts, *, iters: int = 30, init=None):
    """Exponential-model fit (the reference's model); see :func:`fit_model`."""
    return fit_model(lags, gamma, counts, model="exponential", iters=iters, init=init)


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


@device_cache(maxsize=16)
def _fit_plan(max_lag: int, n_bins: int, lon_step: float, lat_step: float, dtype: torch.dtype,
              device: torch.device):
    """What :func:`fit_variogram` hands B9 and B10 that a grid's geometry
    fixes, made once on ``device``: the offsets (dys, dxs, bin_of), their
    grouped table, and the lag centres in degrees by the mean grid step
    (:func:`empirical_variogram`'s centres times the step, the op the fit
    always ran, so the same bits)."""
    dys, dxs, bin_of, _ = _bin_table(max_lag, n_bins)
    table = kv.offset_table(dys, dxs, bin_of, n_bins, max_lag, device)
    step = 0.5 * (abs(lat_step) + abs(lon_step))
    return dys, dxs, bin_of, table, _device_centers(max_lag, n_bins, 1, 1.0, dtype, device)[0] * step


@spanned
def fit_variogram(grid: RegularGrid, *, max_lag: int = 10, n_bins: int = 10, iters: int = 25):
    """Empirical variogram + exponential fit, lags scaled from index space to
    degrees by the mean grid step.  Returns (nugget, sill, range) as 0-d
    views of one (3,) tensor on the grid's device: the bits of
    :func:`empirical_variogram` followed by :func:`fit_exponential` on
    ``lags * step``, from B9's sums handed to B10 as they are."""
    H, W = grid.shape
    dys, dxs, bin_of, table, lags = _fit_plan(max_lag, n_bins, grid.lon_step, grid.lat_step, grid.dtype,
                                              grid.device)
    s, c = kv.pair_sums(grid.elev, grid.valid, H, W, 0, dys, dxs, bin_of, n_bins, max_lag, table)
    FIT["fits"] += 1
    return kv.fit_model(lags, s, c, model="exponential", iters=iters, stop=STOP_DGAMMA, binned=True)
