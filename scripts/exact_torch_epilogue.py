"""Exact mode's entry points as they ran before B17 and B18: B16's query
preparation and the selections (B13, B14) on the card as the package runs
them, then the epilogues as strings of torch ops (the coordinate-form
kriging solve, the Catmull-Rom patch and the bilinear, chunked where the
package chunked them).  Kept for the A/B of ``chip_smoke.py`` phase 19
(before and after, in one run, on one card); no path of the package calls
it.

Each function takes what the package's namesake takes and returns the same
(N,) numpy float64 predictions, bit for bit (chip_smoke checks it):

    exact_kriging_at_cells_fast (the table solve: no epilogue kernel, the
    package's function itself), exact_kriging_at_cells, exact_cubic_at_cells,
    exact_bilinear_at_cells, exact_kriging_scattered, exact_cubic_scattered,
    exact_bilinear_scattered

The epilogues are the functions named ``_*_epilogue`` (chip_smoke's host
split reads their time).  Import it from a checkout's root
(``chip_smoke.load_script``).
"""

import torch

from auvtpu_torch.config import KrigingConfig
from auvtpu_torch.kernels.exact_epilogue import fallback_mean as _fallback_mean
from auvtpu_torch.kernels.exact_epilogue import sum4 as _sum4
from auvtpu_torch.kernels.exact_prologue import GEO, GRID, KEYS
from auvtpu_torch.ops import exact as texact
from auvtpu_torch.ops.exact_fast import exact_kriging_at_cells_fast  # noqa: F401  (no epilogue kernel)
from auvtpu_torch.ops.scattered import _catmull_rom, krige_solve

_F64 = torch.float64


def _krige_epilogue(grid, qlon, qlat, found, sel_val, sel_gi, sel_gj):
    cx = grid.min_lon + (sel_gi.to(_F64) + 0.5) * grid.lon_step
    cy = grid.min_lat + (sel_gj.to(_F64) + 0.5) * grid.lat_step
    vals = sel_val.to(_F64)
    pred, singular = krige_solve(qlon, qlat, vals, cx, cy, KrigingConfig())
    solved = torch.where(singular, _sum4(vals) / 4.0, pred)
    return torch.where(found >= 4, solved, _fallback_mean(found, sel_val))


def _cubic_cells_epilogue(grid, q, found, sel_val):
    out = _fallback_mean(found, sel_val)
    H, W = grid.shape
    xi, yi = q.ci, q.cj
    rel = torch.arange(-1, 3, device=grid.device)
    jj = (yi[:, None] + rel).clamp(0, H - 1)
    ii = (xi[:, None] + rel).clamp(0, W - 1)
    flat = jj[:, :, None] * W + ii[:, None, :]
    patch_ok = (grid.valid.reshape(-1)[flat] > 0.5).flatten(1).all(dim=1)
    patch = grid.elev.reshape(-1)[flat].to(_F64)
    tx = q.x - xi
    ty = q.y - yi
    col = _catmull_rom(patch[:, :, 0], patch[:, :, 1], patch[:, :, 2], patch[:, :, 3], tx[:, None])
    smooth = _catmull_rom(col[:, 0], col[:, 1], col[:, 2], col[:, 3], ty)
    return torch.where(patch_ok, smooth, out)


def _bilinear(grid, x0, y0, x1, y1, wx, wy, z_dtype=None):
    H, W = grid.shape
    x0c = x0.clamp(0, W - 1)
    y0c = y0.clamp(0, H - 1)
    ev = grid.elev.reshape(-1)
    vv = grid.valid.reshape(-1)
    idx = [y0c * W + x0c, y0c * W + x1, y1 * W + x0c, y1 * W + x1]
    z = [ev[i] if z_dtype is None else ev[i].to(z_dtype) for i in idx]
    m = [vv[i] > 0.5 for i in idx]
    cnt = ((m[0].int() + m[1].int()) + m[2].int()) + m[3].int()
    s = ((torch.where(m[0], z[0], 0) + torch.where(m[1], z[1], 0)) + torch.where(m[2], z[2], 0)) + torch.where(
        m[3], z[3], 0)
    fb = torch.where(cnt > 0, s / cnt.clamp(min=1), torch.nan)
    z0 = (1 - wx) * z[0] + wx * z[1]
    z1 = (1 - wx) * z[2] + wx * z[3]
    smooth = (1 - wy) * z0 + wy * z1
    return torch.where(cnt >= 4, smooth, fb)


def _bilinear_cells_epilogue(grid, q):
    H, W = grid.shape
    x0, y0 = q.ci, q.cj
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    return _bilinear(grid, x0, y0, x1, y1, q.x - x0, q.y - y0, z_dtype=_F64)


def _cubic_smooth(grid, xi, yi, x, y):
    H, W = grid.shape
    rel = torch.arange(-1, 3, device=grid.device)
    jj = (yi[:, None] + rel).clamp(0, H - 1)
    ii = (xi[:, None] + rel).clamp(0, W - 1)
    flat = jj[:, :, None] * W + ii[:, None, :]
    patch = grid.elev.reshape(-1)[flat]  # (N, 4, 4)
    all_ok = (grid.valid.reshape(-1)[flat] > 0.5).flatten(1).all(dim=1)
    tx = x - xi
    ty = y - yi
    col = _catmull_rom(patch[:, :, 0], patch[:, :, 1], patch[:, :, 2], patch[:, :, 3], tx[:, None])
    return _catmull_rom(col[:, 0], col[:, 1], col[:, 2], col[:, 3], ty), all_ok


def _cubic_scattered_epilogue(grid, q, chunk):
    smooth, all_ok = texact._chunked(lambda *a: _cubic_smooth(grid, *a), q.ci.shape[0], chunk, q.ci, q.cj, q.x, q.y)
    return smooth.to(_F64), ~all_ok & ~q.oob


def _mean_epilogue(out, idx, found, sel_val):
    out[idx] = _fallback_mean(found, sel_val)


def _bilinear_scattered_epilogue(grid, q, chunk):
    H, W = grid.shape

    def chunk_fn(x0, y0, xs, ys):
        x1, y1 = (x0.clamp(0, W - 1) + 1).clamp(max=W - 1), (y0.clamp(0, H - 1) + 1).clamp(max=H - 1)
        return (_bilinear(grid, x0, y0, x1, y1, xs - x0, ys - y0),)

    (out,) = texact._chunked(chunk_fn, q.ci.shape[0], chunk, q.ci, q.cj, q.x, q.y)
    return out


def exact_kriging_at_cells(grid, rows, cols, *, max_radius=10, chunk=16384):
    q = texact.query_tensors(grid, rows, cols, anchor="round", fields=KEYS | GEO)
    texact._checked(q)
    found, sel_val, sel_gi, sel_gj = texact._select_cells(grid, q, None, max_radius, chunk)
    return texact._result(_krige_epilogue(grid, q.qlon, q.qlat, found, sel_val, sel_gi, sel_gj), q.oob)


def exact_cubic_at_cells(grid, rows, cols, *, max_radius=10, chunk=16384):
    q = texact.query_tensors(grid, rows, cols, anchor="floor", fields=KEYS | GRID)
    texact._checked(q)
    found, sel_val, _, _ = texact._select_cells(grid, q, None, max_radius, chunk)
    return texact._result(_cubic_cells_epilogue(grid, q, found, sel_val), q.oob)


def exact_bilinear_at_cells(grid, rows, cols):
    q = texact.query_tensors(grid, rows, cols, anchor="floor", fields=GRID)
    texact._checked(q)
    return texact._result(_bilinear_cells_epilogue(grid, q), q.oob)


def exact_kriging_scattered(grid, lons, lats, *, max_radius=10, chunk=16384):
    q = texact.scattered_tensors(grid, lons, lats, "round")
    found, sel_val, sel_gi, sel_gj = texact._select_scattered(grid, q.ci, q.cj, q.x, q.y, max_radius, chunk)
    return texact._result(_krige_epilogue(grid, q.qlon, q.qlat, found, sel_val, sel_gi, sel_gj), q.oob)


def exact_cubic_scattered(grid, lons, lats, *, max_radius=10, chunk=16384):
    q = texact.scattered_tensors(grid, lons, lats, "floor")
    out, need = _cubic_scattered_epilogue(grid, q, chunk)
    n_need = int(need.sum().cpu())
    if n_need:
        idx = texact._where(need, n_need)
        found, sel_val, _, _ = texact._select_scattered(grid, *(a[idx] for a in (q.ci, q.cj, q.x, q.y)), max_radius,
                                                        chunk)
        _mean_epilogue(out, idx, found, sel_val)
    return texact._result(out, q.oob)


def exact_bilinear_scattered(grid, lons, lats, *, chunk=16384):
    q = texact.scattered_tensors(grid, lons, lats, "floor")
    return texact._result(_bilinear_scattered_epilogue(grid, q, chunk), q.oob)
