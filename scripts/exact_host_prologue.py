"""Exact mode's entry points as they ran before B16: the query preparation
in host numpy (float64), then uploads, host masks and host indices around
the same kernels (B13, B14) and torch ops.  Kept for the A/B of
``chip_smoke.py`` phase 19 (before and after, in one run, on one card); no
path of the package calls it.

Each function takes what the package's namesake takes and returns the same
(N,) numpy float64 predictions, bit for bit (chip_smoke checks it):

    exact_kriging_at_cells_fast, exact_kriging_at_cells, exact_cubic_at_cells,
    exact_bilinear_at_cells, exact_kriging_scattered, exact_cubic_scattered,
    exact_bilinear_scattered

``prepare_exact_queries`` and ``_prepare_scattered`` are the host numpy
prologues (the JAX package's ``auvtpu/ops/exact.py:139`` and ``:449``).
Import it from a checkout's root (``chip_smoke.load_script``).
"""

import numpy as np
import torch

from auvtpu_torch.kernels.exact_select import dense_krige, ring_krige, ring_select
from auvtpu_torch.ops import exact as texact
from auvtpu_torch.ops import exact_fast as tfast
from auvtpu_torch.ops.scattered import _catmull_rom

_F64 = torch.float64
_on = texact._on


def _anchors(x, y, H, W, anchor):
    if anchor == "round":
        return (np.clip(np.floor(x + 0.5).astype(np.int64), 0, W - 1),
                np.clip(np.floor(y + 0.5).astype(np.int64), 0, H - 1))
    if anchor == "floor":
        return np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    raise ValueError(anchor)


def prepare_exact_queries(grid, rows, cols, *, anchor="round"):
    """The host numpy prologue of cell-aligned queries: an
    ``ops.exact.ExactQueries``."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    H, W = grid.shape
    lon_step = (grid.max_lon - grid.min_lon) / (W - 1)
    lat_step = (grid.max_lat - grid.min_lat) / (H - 1)
    qlon = grid.min_lon + cols * lon_step
    qlat = grid.min_lat + rows * lat_step
    oob = (qlon < grid.min_lon) | (qlon > grid.max_lon) | (qlat < grid.min_lat) | (qlat > grid.max_lat)
    x = np.where(oob, 0.0, (qlon - grid.min_lon) / lon_step)
    y = np.where(oob, 0.0, (qlat - grid.min_lat) / lat_step)
    ci, cj = _anchors(x, y, H, W, anchor)
    exi = np.rint(x - ci).astype(np.int64)
    eyi = np.rint(y - cj).astype(np.int64)
    ex_key = ((x - ci) - exi) * texact.EPS_SCALE
    ey_key = ((y - cj) - eyi) * texact.EPS_SCALE
    if not (np.float64(np.float32(ex_key)) == ex_key).all() or not (np.float64(np.float32(ey_key)) == ey_key).all():
        raise ValueError("coordinate residue not exactly representable in f32 keys")
    return texact.ExactQueries(ci=ci.astype(np.int32), cj=cj.astype(np.int32), variant=(2 * exi + eyi).astype(np.int32),
                               ex_key=ex_key.astype(np.float32), ey_key=ey_key.astype(np.float32), qlon=qlon,
                               qlat=qlat, x=x, y=y, oob=oob)


def _prepare_scattered(grid, lons, lats, anchor):
    """The host numpy prologue of scattered coordinates: (lons, lats, x, y,
    ci int32, cj int32, oob)."""
    lons = np.asarray(lons.detach().cpu() if torch.is_tensor(lons) else lons, np.float64).ravel()
    lats = np.asarray(lats.detach().cpu() if torch.is_tensor(lats) else lats, np.float64).ravel()
    H, W = grid.shape
    lon_step = (grid.max_lon - grid.min_lon) / (W - 1)
    lat_step = (grid.max_lat - grid.min_lat) / (H - 1)
    oob = (lons < grid.min_lon) | (lons > grid.max_lon) | (lats < grid.min_lat) | (lats > grid.max_lat)
    x = np.where(oob, 0.0, (lons - grid.min_lon) / lon_step)
    y = np.where(oob, 0.0, (lats - grid.min_lat) / lat_step)
    with np.errstate(invalid="ignore"):
        ci, cj = _anchors(x, y, H, W, anchor)
    return lons, lats, x, y, ci.astype(np.int32), cj.astype(np.int32), oob


def _host(out, oob):
    return np.where(oob, np.nan, out.cpu().numpy())


def _cell_keys(grid, q, idx):
    cols = [q.ci, q.cj, q.variant, q.ex_key, q.ey_key]
    if idx is not None:
        cols = [a[idx] for a in cols]
    return (_on(grid, cols[0], torch.int64), _on(grid, cols[1], torch.int64), *(_on(grid, a) for a in cols[2:]))


def _select_cells(grid, q, idx, max_radius, chunk):
    ci, cj, variant, ex, ey = _cell_keys(grid, q, idx)
    return ring_select(grid, ci, cj, ex, ey, variant, max_radius=max_radius, chunk=chunk)


def exact_kriging_at_cells_fast(grid, rows, cols, *, max_radius=10, chunk=65536):
    q = prepare_exact_queries(grid, rows, cols, anchor="round")
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    H, W = grid.shape
    aligned = (q.ci == cols) & (q.cj == rows) & (q.variant == 0) & ~q.oob
    flat_np = rows * W + cols
    keys = _on(grid, np.stack([q.ex_key[aligned], q.ey_key[aligned]]))
    flat_a = None if aligned.all() else _on(grid, flat_np[aligned])
    flat_q = _on(grid, np.clip(flat_np, 0, H * W - 1))
    gpair, gq = tfast._reference_tables(grid, max_radius)
    out, tie = dense_krige(grid, flat_a, keys, flat_q, gpair, gq, max_radius=max_radius)
    esc = (tie.cpu().numpy() | ~aligned) & ~q.oob
    if esc.any():
        idx = np.nonzero(esc)[0]
        out[_on(grid, idx)] = ring_krige(grid, *_cell_keys(grid, q, idx), _on(grid, cols[idx]), _on(grid, rows[idx]),
                                         gpair, gq, max_radius=max_radius, chunk=chunk)
    return np.where(q.oob, np.nan, out.cpu().numpy())


def exact_kriging_at_cells(grid, rows, cols, *, max_radius=10, chunk=16384):
    q = prepare_exact_queries(grid, rows, cols, anchor="round")
    found, sel_val, sel_gi, sel_gj = _select_cells(grid, q, None, max_radius, chunk)
    out = texact._krige_at(grid, _on(grid, q.qlon), _on(grid, q.qlat), found, sel_val, sel_gi, sel_gj)
    return _host(out, q.oob)


def exact_cubic_at_cells(grid, rows, cols, *, max_radius=10, chunk=16384):
    q = prepare_exact_queries(grid, rows, cols, anchor="floor")
    found, sel_val, _, _ = _select_cells(grid, q, None, max_radius, chunk)
    out = texact._fallback_mean(found, sel_val)
    H, W = grid.shape
    xi, yi = _on(grid, q.ci, torch.int64), _on(grid, q.cj, torch.int64)
    rel = torch.arange(-1, 3, device=grid.device)
    jj = (yi[:, None] + rel).clamp(0, H - 1)
    ii = (xi[:, None] + rel).clamp(0, W - 1)
    flat = jj[:, :, None] * W + ii[:, None, :]
    patch_ok = (grid.valid.reshape(-1)[flat] > 0.5).flatten(1).all(dim=1)
    patch = grid.elev.reshape(-1)[flat].to(_F64)
    tx = _on(grid, q.x) - xi
    ty = _on(grid, q.y) - yi
    col = _catmull_rom(patch[:, :, 0], patch[:, :, 1], patch[:, :, 2], patch[:, :, 3], tx[:, None])
    smooth = _catmull_rom(col[:, 0], col[:, 1], col[:, 2], col[:, 3], ty)
    return _host(torch.where(patch_ok, smooth, out), q.oob)


def exact_bilinear_at_cells(grid, rows, cols):
    q = prepare_exact_queries(grid, rows, cols, anchor="floor")
    H, W = grid.shape
    x0, y0 = _on(grid, q.ci, torch.int64), _on(grid, q.cj, torch.int64)
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    out = texact._bilinear(grid, x0, y0, x1, y1, _on(grid, q.x) - x0, _on(grid, q.y) - y0, z_dtype=_F64)
    return _host(out, q.oob)


def exact_kriging_scattered(grid, lons, lats, *, max_radius=10, chunk=16384):
    lons, lats, x, y, ci, cj, oob = _prepare_scattered(grid, lons, lats, "round")
    found, sel_val, sel_gi, sel_gj = texact._select_scattered(grid, ci, cj, x, y, max_radius, chunk)
    out = texact._krige_at(grid, _on(grid, lons), _on(grid, lats), found, sel_val, sel_gi, sel_gj)
    return _host(out, oob)


def exact_cubic_scattered(grid, lons, lats, *, max_radius=10, chunk=16384):
    lons, lats, x, y, ci, cj, oob = _prepare_scattered(grid, lons, lats, "floor")
    args = [_on(grid, ci), _on(grid, cj), _on(grid, x), _on(grid, y)]
    smooth, all_ok = texact._chunked(lambda *a: texact._cubic_smooth(grid, *a), len(x), chunk, *args)
    out = smooth.to(_F64)
    need = ~all_ok.cpu().numpy() & ~oob
    if need.any():
        found, sel_val, _, _ = texact._select_scattered(grid, ci[need], cj[need], x[need], y[need], max_radius, chunk)
        out[_on(grid, np.nonzero(need)[0])] = texact._fallback_mean(found, sel_val)
    return _host(out, oob)


def exact_bilinear_scattered(grid, lons, lats, *, chunk=16384):
    lons, lats, x, y, ci, cj, oob = _prepare_scattered(grid, lons, lats, "floor")
    H, W = grid.shape

    def chunk_fn(x0, y0, xs, ys):
        x1, y1 = (x0.clamp(0, W - 1) + 1).clamp(max=W - 1), (y0.clamp(0, H - 1) + 1).clamp(max=H - 1)
        return (texact._bilinear(grid, x0, y0, x1, y1, xs - x0, ys - y0),)

    args = [_on(grid, ci), _on(grid, cj), _on(grid, x), _on(grid, y)]
    (out,) = texact._chunked(chunk_fn, len(x), chunk, *args)
    return _host(out.to(_F64), oob)
