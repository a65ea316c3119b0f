"""Plain torch reference of fit-then-fill: the binned Matheron variogram of
the observed cells, the damped Gauss-Newton fit of the exponential model to
it, and ordinary kriging of the masked cells with the fitted model.

Written from the configuration's semantics: squared differences of the
float32 elevations summed in float64 over the half-plane lag offsets
(each pair once), semivariance s / 2n in float32 per lag bin, lags in
degrees by the mean grid step, and the fit in float64 in log-parameter
space with a Levenberg damping of 1e-4 of the mean curvature, steps clipped
to [-2, 2], a step kept only where it does not raise the pair-weighted
squared error, and the walk frozen at the first kept step that moves the
fitted curve by less than ``stop`` (relative, at every bin with pairs).
The Jacobian is the model's own derivative, written out.  Imports nothing
of the program.
"""

from __future__ import annotations

import torch

from ..yardstick.tables import lag_table
from .kriging import krige_cells


def pair_sums(elev: torch.Tensor, valid: torch.Tensor, max_lag: int, n_bins: int):
    """(sums, counts) float64 per lag bin over every pair of cells at a
    half-plane offset; a partner outside the grid counts as unobserved."""
    H, W = elev.shape
    dys, dxs, bins, _ = lag_table(max_lag, n_bins)
    s = torch.zeros(n_bins, dtype=torch.float64, device=elev.device)
    c = torch.zeros(n_bins, dtype=torch.float64, device=elev.device)
    for dy, dx, b in zip(dys.tolist(), dxs.tolist(), bins.tolist()):
        c0, c1 = max(0, -dx), W - max(0, dx)
        base_e, base_v = elev[: H - dy, c0:c1], valid[: H - dy, c0:c1]
        part_e, part_v = elev[dy:, c0 + dx:c1 + dx], valid[dy:, c0 + dx:c1 + dx]
        both = base_v * part_v
        d = (base_e - part_e) * both
        s[b] += torch.sum(d * d, dtype=torch.float64)
        c[b] += torch.sum(both, dtype=torch.float64)
    return s, c


def fit_exponential(lags, gamma, counts, *, iters: int, stop: float):
    """The fitted (nugget, sill, range), float64 tensors."""
    lags, gamma, counts = (t.to(torch.float64) for t in (lags, gamma, counts))
    w = counts / torch.clamp(counts.sum(), min=1.0)
    sw = torch.sqrt(w)
    pairs = counts > 0
    sill0 = torch.clamp(gamma.max(), min=1e-3)
    maxlag = torch.clamp(lags.max(), min=1e-9)
    theta = torch.log(torch.stack([0.01 * sill0, sill0, maxlag / 3.0]))

    def curve(th):
        n, s, r = torch.exp(th)
        return n + s * (1.0 - torch.exp(-lags / torch.clamp(r, min=1e-6)))

    def jac(th):
        n, s, r = torch.exp(th)
        e = torch.exp(-lags / r)
        return torch.stack([n * torch.ones_like(lags), s * (1.0 - e), -s * e * lags / r], dim=1) * sw[:, None]

    eye = torch.eye(3, dtype=torch.float64, device=gamma.device)
    frozen = torch.zeros((), dtype=torch.bool, device=gamma.device)
    for _ in range(iters):
        now = curve(theta)
        r = (now - gamma) * sw
        J = jac(theta)
        A = J.T @ J
        damp = 1e-4 * torch.clamp(torch.trace(A) / 3.0, min=1e-12)
        delta = torch.linalg.solve(A + damp * eye, J.T @ r).clamp(-2.0, 2.0)
        new = theta - delta
        nxt = curve(new)
        keep = ~frozen & (torch.sum(((nxt - gamma) * sw) ** 2) <= torch.sum(r ** 2))
        moved = torch.max(torch.where(pairs, (nxt - now).abs() / now.abs(), torch.zeros_like(now)))
        theta = torch.where(keep, new, theta)
        frozen = frozen | (keep & (moved < stop))
    return torch.exp(theta)


def fit_fill_cells(inputs: dict, cfg: dict, dtype=torch.float32) -> torch.Tensor:
    """Fit the variogram to the tile's observed cells, then krige the cells
    ``rows``, ``cols`` with it (:func:`.kriging.krige_cells`).  ``dtype``
    is the precision of the planes, the semivariance and the solve; the
    sums stay float64 and the fit float64, as the configuration states.
    Returns float32 (n,)."""
    fit = cfg["fit"]
    elev, valid = inputs["elev"].to(dtype), inputs["valid"].to(dtype)
    s, c = pair_sums(elev, valid, fit["max_lag"], fit["n_bins"])
    s, c = s.to(dtype), c.to(dtype)
    gamma = torch.where(c > 0, s / (2.0 * torch.clamp(c, min=1.0)), torch.zeros_like(s))
    min_lon, max_lon, min_lat, max_lat = cfg["extent"]
    H, W = elev.shape
    step = 0.5 * (abs((max_lat - min_lat) / (H - 1)) + abs((max_lon - min_lon) / (W - 1)))
    centres = torch.as_tensor(lag_table(fit["max_lag"], fit["n_bins"])[3], dtype=dtype, device=elev.device)
    params = fit_exponential(centres * step, gamma, c, iters=fit["iters"], stop=fit["stop"])
    fitted = dict(cfg, variogram={k: float(v) for k, v in zip(("nugget", "sill", "range"), params.to(dtype))})
    return krige_cells(dict(inputs, elev=inputs["elev"]), fitted, dtype)
