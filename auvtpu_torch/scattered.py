"""Scattered data to a grid: the prototype pipeline (counterpart of
:mod:`auvtpu.scattered`, the rebuild of the reference's Python prototype,
``code/test_interpolation.py`` + ``code/main.py``).

The prototype samples ~1 % of a GEBCO tile and predicts the whole grid
from the samples (scipy ``griddata`` and PyKrige moving-window ordinary
kriging, n_closest_points=50).  Here the neighbours come from a
brute-force k-nearest search: chunked distance matrices (one matrix product
a chunk) merged into a running top-k, then a per-target model over the k
neighbours:

- :func:`idw_knn`            inverse-distance weighting
- :func:`adaptive_idw_knn`   IDW with a per-query power from the local density
- :func:`linear_knn`         weighted local plane fit
- :func:`kriging_knn`        moving-window ordinary kriging (trend removal,
                             anisotropy, variance)
- :func:`fit_variogram_scattered` / :func:`fit_variogram_scattered_aniso`
                             the variogram of the sampled point pairs
- :func:`sample_and_reconstruct`  the pipeline: sample, fit, predict

The JAX package reaches no Pallas kernel here: its distance term is an XLA
dot at full precision, its selection ``jax.lax.top_k`` and its solves
``jnp.linalg``.  So this module is plain torch: ``torch.matmul`` with TF32
off, a stable sort, ``torch.linalg``.  Distances are Euclidean in (lon,
lat) degrees, like the reference.  Every public function runs on the card
unless the caller passes ``device="cpu"``: numpy (or other host) input goes
to ``device``; tensor inputs keep their device, and the other inputs go to
the first tensor's.
"""

from __future__ import annotations

import numpy as np
import torch

from .grid import divisor
from .variogram import anisotropy_matrix, fit_anisotropic, fit_best_model, fit_model, variogram_model


def _full_precision(t: torch.Tensor) -> None:
    """float32 matrix products at full precision on the card: TF32 keeps ~3
    digits, and the A.B term below needs all of f32's (see _pairwise_d2)."""
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False


def _pairwise_d2(a, b):
    """Squared distances |A|^2 + |B|^2 - 2 A.B of a (n, 2) to b (m, 2): (n, m).

    Callers centre the coordinates first: with raw geographic coordinates
    the |A|^2 terms (~5e3 for lon ~ -73) swamp squared distances of ~1e-4
    below f32 resolution.  The A.B product must run at full f32 precision
    (the JAX package's precision=HIGHEST): a reduced-precision product puts
    ~1e-2 of error on it, more than the distances being compared."""
    _full_precision(a)
    aa = torch.sum(a * a, dim=1, keepdim=True)
    bb = torch.sum(b * b, dim=1, keepdim=True)
    ab = a @ b.T
    return torch.clamp(aa + bb.T - 2.0 * ab, min=0.0)


def _on(device, *xs):
    """The inputs as tensors on one device: the first tensor's among them,
    else ``device``."""
    dev = next((x.device for x in xs if torch.is_tensor(x)), torch.device(device))
    return tuple(torch.as_tensor(x, device=dev) for x in xs)


def knn_search(targets_xy, points_xy, *, k: int, pt_chunk: int = 8192, device="cuda"):
    """Streaming k-nearest search: (N, k) squared distances and int32
    indices (-1 and inf where fewer than k points exist).

    The points go in chunks of ``pt_chunk`` (the last padded with inf; one
    chunk of all the points where they are fewer); a running top-k is
    merged per chunk, so memory is O(N (k + chunk)).  The
    merge is a stable sort of the concatenated [best, chunk] row: equal
    distances keep the lower position, which is ``jax.lax.top_k``'s order."""
    targets_xy, points_xy = _on(device, targets_xy, points_xy)
    n, m = targets_xy.shape[0], points_xy.shape[0]
    dt, dev = targets_xy.dtype, targets_xy.device
    # translate to the point cloud's centroid so squared distances survive f32
    center = torch.mean(points_xy, dim=0, keepdim=True)
    targets_xy = targets_xy - center
    points_xy = points_xy - center
    pt_chunk = max(min(pt_chunk, m), 1)
    pad = (-m) % pt_chunk
    pts = torch.cat([points_xy, torch.full((pad, 2), float("inf"), dtype=dt, device=dev)])
    best_d2 = torch.full((n, k), float("inf"), dtype=dt, device=dev)
    best_idx = torch.full((n, k), -1, dtype=torch.int32, device=dev)
    iota = torch.arange(pt_chunk, dtype=torch.int32, device=dev)
    for c in range(pts.shape[0] // pt_chunk):
        d2 = _pairwise_d2(targets_xy, pts[c * pt_chunk:(c + 1) * pt_chunk])  # padded points: inf or NaN
        d2 = torch.where(torch.isfinite(d2), d2, float("inf"))
        cat_d2 = torch.cat([best_d2, d2], dim=1)
        cat_idx = torch.cat([best_idx, (c * pt_chunk + iota).expand(n, pt_chunk)], dim=1)
        order = torch.sort(cat_d2, dim=1, stable=True).indices[:, :k]
        best_d2 = torch.gather(cat_d2, 1, order)
        best_idx = torch.gather(cat_idx, 1, order)
    return best_d2, best_idx


def _neighbours(points, idx):
    """Rows of ``points`` at the kNN indices (-1 read as 0; its lane is
    masked by d2 = inf)."""
    return points[idx.clamp(min=0).long()]


def _idw_from_knn(d2, vals_k, *, power: float = 2.0, eps: float = 1e-12):
    w = 1.0 / (d2 ** (power / 2.0) + eps)
    return torch.sum(w * vals_k, dim=1) / torch.sum(w, dim=1)


def idw_knn(points_xy, points_val, targets_xy, *, k: int = 50, power: float = 2.0, device="cuda"):
    """Inverse-distance weighting over the k nearest samples."""
    targets_xy, points_xy, points_val = _on(device, targets_xy, points_xy, points_val)
    d2, idx = knn_search(targets_xy, points_xy, k=k)
    return _idw_from_knn(d2, _neighbours(points_val, idx), power=power)


def _aidw_from_knn(d2, vals_k, area_per_point, *, k: int, alpha_min: float = 1.0, alpha_max: float = 5.0, eps: float = 1e-12):
    """Adaptive-power IDW weights (Lu & Wong 2008).  The observed mean k-NN
    distance over the one expected at uniform density, (2/3) sqrt(k/pi)
    sqrt(A/n), gives a density ratio R; normalised to mu = clip(R/2, 0, 1)
    it sets the power through a smoothstep between alpha_min (dense) and
    alpha_max (sparse).  Distances are normalised per query before the
    power, so eps cannot swamp d^alpha at degree scales."""
    d = torch.sqrt(torch.clamp(d2, min=0.0))
    r_obs = torch.mean(d, dim=1)
    r_exp = (2.0 / 3.0) * torch.sqrt(k * torch.clamp(area_per_point, min=1e-30) / divisor(np.pi, d))
    R = r_obs / torch.clamp(r_exp, min=1e-30)
    mu = torch.clamp(R / 2.0, 0.0, 1.0)
    s = mu * mu * (3.0 - 2.0 * mu)
    alpha = alpha_min + (alpha_max - alpha_min) * s
    dn = d / torch.clamp(r_obs[:, None], min=1e-30)
    w = 1.0 / (torch.exp(alpha[:, None] * torch.log(torch.clamp(dn, min=1e-30))) + eps)
    return torch.sum(w * vals_k, dim=1) / torch.sum(w, dim=1)


def adaptive_idw_knn(points_xy, points_val, targets_xy, *, k: int = 16, alpha_min: float = 1.0, alpha_max: float = 5.0, device="cuda"):
    """Adaptive IDW (AIDW): a per-query power from the local sampling density."""
    targets_xy, points_xy, points_val = _on(device, targets_xy, points_xy, points_val)
    d2, idx = knn_search(targets_xy, points_xy, k=k)
    vals_k = _neighbours(points_val, idx)
    span = torch.amax(points_xy, dim=0) - torch.amin(points_xy, dim=0)
    area_per_point = (span[0] * span[1]) / points_xy.shape[0]
    return _aidw_from_knn(d2, vals_k, area_per_point, k=k, alpha_min=alpha_min, alpha_max=alpha_max)


def _plane_coefs(d2, xy_k, vals_k, targets_xy):
    """Weighted least-squares plane z = a x + b y + c over the k neighbours
    in target-centred coordinates (Gaussian weights scaled to the k-th
    neighbour; lanes with no neighbour, d2 = inf, weigh 0).  Returns (coef
    (n, 3), rel (n, k, 2))."""
    _full_precision(d2)
    ok = torch.isfinite(d2)
    d2s = torch.where(ok, d2, 0.0)
    scale = torch.clamp(torch.amax(d2s, dim=1, keepdim=True), min=1e-12)
    w = torch.where(ok, torch.exp(-d2s / scale), 0.0)
    rel = xy_k - targets_xy[:, None, :]
    X = torch.cat([rel, torch.ones_like(rel[..., :1])], dim=-1)  # (n, k, 3)
    Xw = X * w[..., None]
    A = torch.einsum("nki,nkj->nij", Xw, X)
    b = torch.einsum("nki,nk->ni", Xw, vals_k)
    A = A + 1e-8 * torch.eye(3, dtype=A.dtype, device=A.device)
    coef = torch.linalg.solve_ex(A, b[..., None])[0][..., 0]
    return coef, rel


def linear_knn(points_xy, points_val, targets_xy, *, k: int = 12, device="cuda"):
    """Weighted local plane fit over the k nearest samples, read at the
    target (the analogue of Delaunay-linear griddata)."""
    targets_xy, points_xy, points_val = _on(device, targets_xy, points_xy, points_val)
    d2, idx = knn_search(targets_xy, points_xy, k=k)
    coef, _ = _plane_coefs(d2, _neighbours(points_xy, idx), _neighbours(points_val, idx), targets_xy)
    return coef[:, 2]


def _ok_from_knn(d2, xy_k, vals_k, vparams, *, model: str = "exponential", with_variance: bool = False):
    """Moving-window ordinary kriging over the k nearest neighbours.

    The Gaussian model solves in covariance form by Cholesky: C(h) =
    (nugget + sill) - gamma(h) is positive definite, with a 1e-3 diagonal
    floor, and the Lagrange constraint reduces to two solves (w = v + lam u,
    u = C^-1 1, v = C^-1 c0); its variogram form is ill-conditioned for so
    smooth a kernel.  The other models keep the (k+1)-square variogram form,
    normalised by gamma at the batch's largest neighbour distance (weights
    are invariant to that scale) with a 1e-4 diagonal jitter.  Lanes with
    no neighbour (d2 = inf) get unit diagonals and zero couplings, so they
    solve to weight 0."""
    _full_precision(d2)
    n, k = d2.shape
    dt, dev = d2.dtype, d2.device
    ok = torch.isfinite(d2)
    okf = ok.to(dt)
    pair_ok = ok[:, :, None] & ok[:, None, :]
    dx = xy_k[:, :, None, 0] - xy_k[:, None, :, 0]
    dy = xy_k[:, :, None, 1] - xy_k[:, None, :, 1]

    def vf(h):
        return variogram_model(h, vparams, model)

    h_kk = torch.sqrt(dx * dx + dy * dy)
    h_t = torch.sqrt(torch.where(ok, d2, 1.0))  # a finite value at empty lanes, masked out
    eye = torch.eye(k, dtype=dt, device=dev)
    if model != "gaussian":
        scale = vf(torch.sqrt(torch.clamp(torch.max(torch.where(ok, d2, 0.0)), min=1e-12)))
        G = torch.where(pair_ok, vf(h_kk) / scale, 0.0)
        A = torch.zeros((n, k + 1, k + 1), dtype=dt, device=dev)
        A[:, :k, :k] = G
        A[:, :k, k] = okf
        A[:, k, :k] = okf
        rhs = torch.cat([okf * vf(h_t) / scale, torch.ones((n, 1), dtype=dt, device=dev)], dim=1)
        diag = torch.where(ok, torch.full_like(d2, 1e-4), torch.ones_like(d2))
        A[:, :k, :k] += diag[:, :, None] * eye
        w = torch.linalg.solve_ex(A, rhs[..., None])[0][..., 0]
        pred = torch.sum(w[:, :k] * vals_k * okf, dim=1)
        pred = torch.where(ok.any(dim=1), pred, float("nan"))
        if not with_variance:
            return pred
        # sigma^2 = sum_i w_i gamma_i0 + mu; the system was scaled, mu' = mu/scale
        var = torch.sum(w[:, :k] * okf * vf(h_t), dim=1) + w[:, k] * scale
        return pred, torch.clamp(var, min=0.0)

    total = vparams[0] + vparams[1]  # gamma(inf) = nugget + sill
    tot = divisor(total, h_kk)
    C = torch.where(pair_ok, (total - vf(h_kk)) / tot, 0.0)
    c0 = okf * (total - vf(h_t)) / tot
    diag = torch.where(ok, torch.full_like(d2, 1e-3), torch.ones_like(d2))
    C = C + diag[:, :, None] * eye
    L = torch.linalg.cholesky_ex(C)[0]

    def cho_solve(b):
        y = torch.linalg.solve_triangular(L, b, upper=False)
        return torch.linalg.solve_triangular(L.mT, y, upper=True)

    u = cho_solve(okf[..., None])
    v = cho_solve(c0[..., None])
    lam = (1.0 - torch.sum(v, dim=(1, 2))) / torch.clamp(torch.sum(u, dim=(1, 2)), min=1e-30)
    w = (v + lam[:, None, None] * u)[..., 0]
    pred = torch.sum(w * vals_k * okf, dim=1)
    pred = torch.where(ok.any(dim=1), pred, float("nan"))
    if not with_variance:
        return pred
    # the variogram form's multiplier is +lam (C w = c0 + lam 1), in C/total units
    var = torch.sum(w * vf(h_t), dim=1) + lam * total
    return pred, torch.clamp(var, min=0.0)


def _ok_trend_from_knn(d2, xy_k, vals_k, targets_xy, vparams, *, model: str = "exponential", with_variance: bool = False):
    """Residual kriging: fit the local weighted plane, krige the residuals,
    add the plane back at the target (the fix for trend-dominated fields,
    where plain OK over-smooths).  The variance is the residual kriging's."""
    coef, rel = _plane_coefs(d2, xy_k, vals_k, targets_xy)
    plane_at_nb = coef[:, None, 0] * rel[..., 0] + coef[:, None, 1] * rel[..., 1] + coef[:, None, 2]
    out = _ok_from_knn(d2, xy_k, vals_k - plane_at_nb, vparams, model=model, with_variance=with_variance)
    if with_variance:
        return coef[:, 2] + out[0], out[1]
    return coef[:, 2] + out


def kriging_knn(points_xy, points_val, targets_xy, *, k: int = 50, vparams=None, model: str = "exponential", trend: str = "plane", aniso=None, return_variance: bool = False, device="cuda"):
    """Moving-window ordinary kriging over the k nearest samples (PyKrige's
    n_closest_points).

    ``model``: 'exponential' | 'linear' | 'spherical' | 'gaussian'.
    ``trend`` 'plane' kriges residuals about a local weighted plane; any
    other value is plain OK (the prototype's).  ``vparams`` (nugget, p1,
    p2), fitted from the samples when None.  ``aniso``: (nugget, sill, rx,
    ry, theta) or 'fit': coordinates go through the ellipse metric
    (:func:`~auvtpu_torch.variogram.anisotropy_matrix`) so the search and
    the system both use correlation distance, with unit range; exclusive
    with ``vparams``.  ``return_variance`` also returns the variance."""
    if aniso is not None and vparams is not None:
        raise ValueError("pass either vparams or aniso, not both (aniso carries its own (nugget, sill) and implies "
                         "unit range)")
    targets_xy, points_xy, points_val = _on(device, targets_xy, points_xy, points_val)
    if isinstance(aniso, str):
        if aniso != "fit":
            raise ValueError(aniso)
        aniso = tuple(float(v) for v in fit_variogram_scattered_aniso(points_xy, points_val, model=model))
    if aniso is not None:
        nugget, sill, rx, ry, theta = aniso
        T = torch.as_tensor(anisotropy_matrix(float(rx), float(ry), float(theta)), dtype=points_xy.dtype,
                            device=points_xy.device)
        _full_precision(T)
        points_xy = points_xy @ T.T
        targets_xy = targets_xy @ T.T
        vparams = (nugget, sill, 1.0)
    elif vparams is None:
        vparams = fit_variogram_scattered(points_xy, points_val, model=model)
    d2, idx = knn_search(targets_xy, points_xy, k=k)
    vals_k = _neighbours(points_val, idx)
    xy_k = _neighbours(points_xy, idx)
    if trend == "plane":
        return _ok_trend_from_knn(d2, xy_k, vals_k, targets_xy, vparams, model=model, with_variance=return_variance)
    return _ok_from_knn(d2, xy_k, vals_k, vparams, model=model, with_variance=return_variance)


def _linspace0(stop, n: int):
    """``jnp.linspace(0, stop, n + 1)`` for a 0-d tensor ``stop``, as JAX
    computes it: stop * (i / n), then stop itself."""
    dt, dev = stop.dtype, stop.device
    step = torch.arange(n, dtype=dt, device=dev) / torch.tensor(float(n), dtype=dt, device=dev)
    return torch.cat([stop * step, stop.reshape(1)])


def _sample_pairs(points_xy, points_val, max_pairs_sqrt: int):
    """The first ``max_pairs_sqrt`` samples, centred: (xy, values, m)."""
    m = min(points_xy.shape[0], max_pairs_sqrt)
    xy = points_xy[:m]
    return xy - torch.mean(xy, dim=0, keepdim=True), points_val[:m], m


def _bin_lags(d, dv, m: int, n_bins: int, short_frac: float):
    """Lag bins of the pair distances ``d`` over [0, short_frac * max d]:
    (bin, short off-diagonal pair mask, bin edges, dv at those pairs else
    0); the edges are ``jnp.linspace``'s and the bin is ``searchsorted``
    on the left, as the JAX package bins them."""
    dmax = torch.max(torch.where(torch.isfinite(d), d, 0.0)) * short_frac
    edges = _linspace0(dmax + 1e-9, n_bins)
    lag_bin = torch.clamp(torch.searchsorted(edges, d.contiguous(), right=False) - 1, 0, n_bins - 1)
    off_diag = ~torch.eye(m, dtype=torch.bool, device=d.device) & (d < dmax)
    return lag_bin, off_diag, edges, torch.where(off_diag, dv, 0.0)


def _binned(flat, vals, mask, n_out: int):
    s = torch.zeros(n_out, dtype=vals.dtype, device=vals.device).index_add_(0, flat.reshape(-1), vals.reshape(-1))
    c = torch.zeros(n_out, dtype=vals.dtype, device=vals.device).index_add_(0, flat.reshape(-1),
                                                                              mask.reshape(-1).to(vals.dtype))
    return s, c


def _scattered_semivariance(points_xy, points_val, *, n_bins: int = 12, max_pairs_sqrt: int = 4096, short_frac: float = 0.1):
    """Empirical semivariance over the pairs of the first ``max_pairs_sqrt``
    samples, restricted to short lags (<= short_frac of the largest pair
    distance): moving-window kriging only reads gamma at neighbour
    distances.  Returns (bin centres, gamma, counts)."""
    xy, v, m = _sample_pairs(points_xy, points_val, max_pairs_sqrt)
    d = torch.sqrt(_pairwise_d2(xy, xy))
    dv = (v[:, None] - v[None, :]) ** 2
    lag_bin, off_diag, edges, dv = _bin_lags(d, dv, m, n_bins, short_frac)
    s, c = _binned(lag_bin, dv, off_diag, n_bins)
    gamma = torch.where(c > 0, s / (2.0 * torch.clamp(c, min=1.0)), 0.0)
    return 0.5 * (edges[:-1] + edges[1:]), gamma, c


def _scattered_semivariance_directional(points_xy, points_val, *, n_bins: int = 10, n_sectors: int = 4, max_pairs_sqrt: int = 2048, short_frac: float = 0.1):
    """(azimuth sector, lag) semivariance over sampled pairs: the scattered
    form of :func:`~auvtpu_torch.variogram.empirical_variogram_directional`.
    Returns (bin centres, sector angles, gamma (S, B), counts (S, B))."""
    xy, v, m = _sample_pairs(points_xy, points_val, max_pairs_sqrt)
    dx = xy[:, None, 0] - xy[None, :, 0]
    dy = xy[:, None, 1] - xy[None, :, 1]
    d = torch.sqrt(dx * dx + dy * dy)
    dv = (v[:, None] - v[None, :]) ** 2
    lag_bin, off_diag, edges, dv = _bin_lags(d, dv, m, n_bins, short_frac)
    ang = torch.remainder(torch.atan2(dy, dx), np.pi)
    sector = torch.clamp(torch.floor(ang / divisor(np.pi / n_sectors, ang)).to(torch.int32), 0, n_sectors - 1)
    s, c = _binned(sector.long() * n_bins + lag_bin, dv, off_diag, n_sectors * n_bins)
    s = s.reshape(n_sectors, n_bins)
    c = c.reshape(n_sectors, n_bins)
    gamma = torch.where(c > 0, s / (2.0 * torch.clamp(c, min=1.0)), 0.0)
    angles = torch.as_tensor((np.arange(n_sectors) + 0.5) * np.pi / n_sectors, dtype=d.dtype, device=d.device)
    return 0.5 * (edges[:-1] + edges[1:]), angles, gamma, c


def fit_variogram_scattered_aniso(points_xy, points_val, *, n_bins: int = 10, n_sectors: int = 4, model: str = "exponential", iters: int = 40, device="cuda"):
    """Directional semivariance of the samples and the anisotropic ellipse
    fit: (nugget, sill, rx, ry, theta) for ``kriging_knn(aniso=...)``."""
    lags, angles, gamma, counts = _scattered_semivariance_directional(
        *_on(device, points_xy, points_val), n_bins=n_bins, n_sectors=n_sectors)
    return fit_anisotropic(lags, angles, gamma, counts, model=model, iters=iters)


def fit_variogram_scattered(points_xy, points_val, *, n_bins: int = 12, model: str = "exponential", device="cuda"):
    """Semivariance of sampled point pairs + a model fit (PyKrige's 'fit a
    variogram to the data' step, test_interpolation.py:61-68).  model='best'
    fits the zoo and returns (name, params) of the least weighted SSE;
    otherwise the named model's (nugget, p1, p2)."""
    lags, gamma, c = _scattered_semivariance(*_on(device, points_xy, points_val), n_bins=n_bins)
    if model == "best":
        name, params, _ = fit_best_model(lags, gamma, c)
        return name, params
    return fit_model(lags, gamma, c, model=model)


# ---------------------------------------------------------------------------
# pipeline: sample -> predict the whole grid (main.py / test_interpolation.py)
# ---------------------------------------------------------------------------

def sample_cells(elev: np.ndarray, extent, *, subset_fraction: float = 0.01, seed: int = 42, density: str = "uniform"):
    """The prototype's sample of the grid (host numpy, the JAX package's
    draws): ``subset_fraction`` of the cells drawn without replacement from
    ``np.random.RandomState(seed)`` (the prototype's
    df.sample(random_state=42)), 'uniform' or 'strip' (the central 20 % of
    rows at 10x the odds).  Returns (sample (lon, lat) (n, 2) f32, sample
    values (n,) f32, every cell's (lon, lat) (H*W, 2) f32 row-major, sample
    mask (H, W) bool)."""
    H, W = elev.shape
    rng = np.random.RandomState(seed)
    n = int(H * W * subset_fraction)
    if density == "uniform":
        flat = rng.choice(H * W, size=n, replace=False)
    elif density == "strip":
        w = np.ones(H * W, np.float64)
        w.reshape(H, W)[int(0.4 * H):int(0.6 * H)] = 10.0
        flat = rng.choice(H * W, size=n, replace=False, p=w / w.sum())
    else:
        raise ValueError(density)
    rr, cc = np.divmod(flat, W)
    lat_step, lon_step = extent.steps(H, W)
    pts_xy = np.stack([extent.min_lon + cc * lon_step, extent.min_lat + rr * lat_step], axis=1).astype(np.float32)
    pts_val = elev[rr, cc].astype(np.float32)
    jj, ii = np.mgrid[0:H, 0:W]
    tgt_xy = np.stack([extent.min_lon + ii.ravel() * lon_step, extent.min_lat + jj.ravel() * lat_step],
                      axis=1).astype(np.float32)
    mask = np.zeros((H, W), bool)
    mask[rr, cc] = True
    return pts_xy, pts_val, tgt_xy, mask


def sample_and_reconstruct(elev: np.ndarray, extent, *, subset_fraction: float = 0.01, method: str = "kriging", k: int = 50, seed: int = 42, target_chunk: int = 1 << 16, model: str = "exponential", trend: str = "plane", aniso: bool = False, density: str = "uniform", device="cuda"):
    """Sample ``subset_fraction`` of the grid's cells (seeded, like the
    prototype's df.sample(random_state=42)) and predict every cell from the
    samples, in chunks of ``target_chunk`` targets (the last one short).
    Returns (pred (H, W) float32, sample_mask (H, W) bool) on the host.

    ``method``: 'idw' (k), 'aidw' and 'linear' (min(k, 16)), 'kriging'
    (variogram fitted from the samples; ``aniso`` fits a directional
    ellipse and kriges in correlation distance).  ``density`` 'strip' gives
    the central 20 % of rows 10x the sampling odds (a survey corridor)."""
    pts_xy, pts_val, tgt_xy, mask = sample_cells(elev, extent, subset_fraction=subset_fraction, seed=seed,
                                                  density=density)
    pxy = torch.from_numpy(pts_xy).to(device)
    pval = torch.from_numpy(pts_val).to(device)

    if method == "idw":
        def fn(t):
            return idw_knn(pxy, pval, t, k=k)
    elif method == "aidw":
        def fn(t):
            return adaptive_idw_knn(pxy, pval, t, k=min(k, 16))
    elif method == "linear":
        def fn(t):
            return linear_knn(pxy, pval, t, k=min(k, 16))
    elif method == "kriging":
        if aniso:
            m = model if model != "best" else "exponential"
            ap = tuple(float(v) for v in fit_variogram_scattered_aniso(pxy, pval, model=m))

            def fn(t):
                return kriging_knn(pxy, pval, t, k=k, model=m, trend=trend, aniso=ap)
        else:
            fitted = fit_variogram_scattered(pxy, pval, model=model)
            model, vparams = fitted if model == "best" else (model, fitted)

            def fn(t):
                return kriging_knn(pxy, pval, t, k=k, vparams=vparams, model=model, trend=trend)
    else:
        raise ValueError(method)

    n = tgt_xy.shape[0]
    out = np.empty(n, np.float32)
    for s in range(0, n, target_chunk):
        e = min(s + target_chunk, n)
        out[s:e] = fn(torch.from_numpy(tgt_xy[s:e]).to(device)).cpu().numpy()
    return out.reshape(elev.shape), mask
