"""Plain torch references of the benchmark's cells: ordinary kriging at the
masked cells of a tile, ordinary kriging and inverse-distance weighting at
scattered queries of a fully valid grid.

Written from the configurations' semantics (the reference study's
GridH.cpp and kernels.cu, as ``configs/*.json`` state them), in the
float32 arithmetic those state, op by op, so that a sound program lands
within rounding of them.  They import nothing of the program and take
nothing it made: they work from the raw planes and queries the benchmark
drew.  ``dtype`` runs the same arithmetic in another precision (the
control: bfloat16).  Each works in blocks of rows so that it fits beside
the program's state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..yardstick.tables import sorted_window, valid16_dydx, window_dydx

INF = float("inf")


def _f32(v: float) -> float:
    """A python float rounded to float32: a grid scalar as the configuration's
    float32 arithmetic holds it."""
    return float(np.float32(v))


def gamma(h: torch.Tensor, vario) -> torch.Tensor:
    """Exponential variogram, nugget + sill (1 - exp(-h / range)), h in
    degrees (GridH.cpp:371-376)."""
    nugget, sill, vrange = vario
    # a 0-d divisor: a python scalar divisor may become a multiply by its
    # rounded reciprocal, an ulp away from the division
    return nugget + sill * (1.0 - torch.exp(-h / torch.tensor(vrange, dtype=h.dtype, device=h.device)))


def solve(qx, qy, vals, cx, cy, vario, pivot_tol: float):
    """The 5x6 ordinary-kriging system of four neighbours at (cx[a], cy[a])
    and the query at (qx, qy), each an (n,) tensor, solved by unpivoted
    Gauss-Jordan in the reference's order (GridH.cpp:378-419); once a pivot
    falls below ``pivot_tol`` every later pivot divides by 1.  Returns
    (prediction, singular)."""
    ones = torch.ones_like(qx)
    M = [[None] * 6 for _ in range(5)]
    for a in range(4):
        for b in range(a, 4):
            dx = cx[a] - cx[b]
            dy = cy[a] - cy[b]
            M[a][b] = gamma(torch.sqrt(dx * dx + dy * dy), vario)
            M[b][a] = M[a][b]
        M[a][4] = ones
        dx = cx[a] - qx
        dy = cy[a] - qy
        M[a][5] = gamma(torch.sqrt(dx * dx + dy * dy), vario)
    M[4] = [ones, ones, ones, ones, torch.zeros_like(qx), ones]
    singular = torch.zeros(qx.shape, dtype=torch.bool, device=qx.device)
    for p in range(5):
        singular = singular | (torch.abs(M[p][p]) < pivot_tol)
        pivot = torch.where(singular, ones, M[p][p])
        for q in range(p, 6):
            M[p][q] = M[p][q] / pivot
        for r in range(5):
            if r != p:
                f = M[r][p]
                for q in range(p, 6):
                    M[r][q] = M[r][q] - f * M[p][q]
    lam = [M[a][5] for a in range(4)]
    pred = lam[0] * vals[0] + lam[1] * vals[1] + lam[2] * vals[2] + lam[3] * vals[3]
    return pred, singular


def _vario(cfg) -> tuple[float, float, float]:
    v = cfg["variogram"]
    return v["nugget"], v["sill"], v["range"]


def _steps(cfg, shape) -> tuple[float, float]:
    """(lon_step, lat_step) of the grid, GridH.cpp:156-157."""
    min_lon, max_lon, min_lat, max_lat = cfg["extent"]
    h, w = shape
    return (max_lon - min_lon) / (w - 1), (max_lat - min_lat) / (h - 1)


def krige_cells(inputs: dict, cfg: dict, dtype=torch.float32, block: int = 1 << 15) -> torch.Tensor:
    """Ordinary kriging at the cells ``rows``, ``cols`` of the tile
    (``elev`` zero-filled where ``valid`` is 0): the first four valid cells
    of the distance-sorted (2R+1)^2 window (ties in collection order), the
    solve on their cell-centre coordinates (+ half a cell, in degrees), and
    where fewer than four were found or a pivot was singular the mean of
    those found (NaN where none).  Returns float32 (n,)."""
    elev, valid, rows, cols = inputs["elev"], inputs["valid"], inputs["rows"], inputs["cols"]
    H, W = elev.shape
    dev = elev.device
    dxs_np, dys_np = sorted_window(cfg["max_radius"])
    dxs = torch.as_tensor(dxs_np, device=dev)
    dys = torch.as_tensor(dys_np, device=dev)
    lon_step, lat_step = _steps(cfg, (H, W))
    min_lon, _, min_lat, _ = cfg["extent"]
    vario = _vario(cfg)
    half = 0.5
    ev = elev.to(dtype)
    out = []
    for s in range(0, rows.numel(), block):
        r = rows[s:s + block].long()
        c = cols[s:s + block].long()
        rr = r[:, None] + dys[None, :]
        cc = c[:, None] + dxs[None, :]
        inb = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
        flat = rr.clamp(0, H - 1) * W + cc.clamp(0, W - 1)
        ok = inb & (valid.reshape(-1)[flat] > 0.5)
        cs = torch.cumsum(ok.to(torch.int32), dim=1)
        cnt = torch.clamp(cs[:, -1], max=4).to(dtype)
        vals, cx, cy = [], [], []
        cf = c.to(dtype)
        rf = r.to(dtype)
        for slot in range(4):
            hit = ok & (cs == slot + 1)
            pos = torch.argmax(hit.to(torch.int32), dim=1)
            has = hit.any(dim=1)
            v = ev.reshape(-1)[flat.gather(1, pos[:, None])[:, 0]]
            vals.append(torch.where(has, v, torch.zeros_like(v)))
            dx = dxs[pos].to(dtype)
            dy = dys[pos].to(dtype)
            cx.append(min_lon + ((cf + dx) + half) * lon_step)
            cy.append(min_lat + ((rf + dy) + half) * lat_step)
        qx = min_lon + cf * lon_step
        qy = min_lat + rf * lat_step
        pred, singular = solve(qx, qy, vals, cx, cy, vario, cfg["pivot_tol"])
        fbs = vals[0] + vals[1] + vals[2] + vals[3]
        fb = torch.where(cnt > 0, fbs / torch.clamp(cnt, min=1.0), torch.full_like(fbs, float("nan")))
        out.append(torch.where(singular | (cnt < 4), fb, pred).float())
    return torch.cat(out) if out else torch.empty(0, device=dev)


def _prologue(lons, lats, cfg, shape, dtype):
    """A scattered query's grid coordinates as the configuration's float32
    arithmetic states them: (lon - min_lon) * (1 / lon_step), min_lon and
    the step rounded to float32 first, the step's reciprocal in float32;
    out-of-grid queries (strictly outside the extent) at (0, 0); the centre
    cell by rounding half away from zero, clamped into the grid; and the
    query's offset from the centre."""
    H, W = shape
    min_lon, max_lon, min_lat, max_lat = cfg["extent"]
    lon_step, lat_step = _steps(cfg, shape)
    inv_lon = float(np.float32(1.0) / np.float32(lon_step))
    inv_lat = float(np.float32(1.0) / np.float32(lat_step))
    lo, la = lons.to(dtype), lats.to(dtype)
    oob = (lo < _f32(min_lon)) | (lo > _f32(max_lon)) | (la < _f32(min_lat)) | (la > _f32(max_lat))
    x = torch.where(oob, torch.zeros_like(lo), (lo - _f32(min_lon)) * inv_lon)
    y = torch.where(oob, torch.zeros_like(la), (la - _f32(min_lat)) * inv_lat)
    ci = torch.floor(x + 0.5).nan_to_num(0.0).long().clamp(0, W - 1)
    cj = torch.floor(y + 0.5).nan_to_num(0.0).long().clamp(0, H - 1)
    return oob, ci, cj, x - ci.to(dtype), y - cj.to(dtype)


def _nearest(elev, valid, ci, cj, fx, fy, offs, k: int, half: float):
    """The ``k`` nearest valid in-grid cells of the candidate offsets
    ``offs`` ((dy, dx), in their tie order) by squared distance
    ((d + half) - f)^2 summed over both axes: (found, [value], [dx], [dy],
    [d2]), each slot an (n,) tensor, value 0 and d2 inf at an empty slot."""
    H, W = elev.shape
    dt = fx.dtype
    tdy = torch.tensor([o[0] for o in offs], device=ci.device)
    tdx = torch.tensor([o[1] for o in offs], device=ci.device)
    rr = cj[:, None] + tdy[None, :]
    cc = ci[:, None] + tdx[None, :]
    inb = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
    flat = rr.clamp(0, H - 1) * W + cc.clamp(0, W - 1)
    ok = inb & (valid.reshape(-1)[flat] > 0.5)
    di = (tdx.to(dt) + half)[None, :] - fx[:, None]
    dj = (tdy.to(dt) + half)[None, :] - fy[:, None]
    d2 = torch.where(ok, di * di + dj * dj, torch.full_like(di, INF))
    top, idx = torch.sort(d2, dim=1, stable=True)
    got = torch.isfinite(top[:, :k])
    ev = elev.to(dt).reshape(-1)
    vals = [torch.where(got[:, s], ev[flat.gather(1, idx[:, s:s + 1])[:, 0]], torch.zeros_like(fx)) for s in range(k)]
    return got.sum(dim=1), vals, [tdx[idx[:, s]] for s in range(k)], [tdy[idx[:, s]] for s in range(k)], \
        [top[:, s] for s in range(k)]


def krige_queries(inputs: dict, cfg: dict, dtype=torch.float32, block: int = 1 << 20) -> torch.Tensor:
    """Ordinary kriging at scattered (lon, lat) of a fully valid grid: the
    four nearest cells of the {-2..1}^2 window (ties in collection order),
    the solve at the query's own (lon, lat) with the cells' centres as
    neighbours, the mean of the found ones where fewer than four were found
    or a pivot was singular, NaN outside the grid.  Returns float32 (n,)."""
    elev, valid = inputs["elev"], inputs["valid"]
    shape = tuple(elev.shape)
    min_lon, _, min_lat, _ = cfg["extent"]
    lon_step, lat_step = _steps(cfg, shape)
    vario = _vario(cfg)
    half = 0.5
    out = []
    for s in range(0, inputs["lons"].numel(), block):
        lons, lats = inputs["lons"][s:s + block], inputs["lats"][s:s + block]
        oob, ci, cj, fx, fy = _prologue(lons, lats, cfg, shape, dtype)
        found, vals, dxs, dys, _ = _nearest(elev, valid, ci, cj, fx, fy, valid16_dydx(), 4, half)
        cif, cjf = ci.to(dtype), cj.to(dtype)
        cx = [_f32(min_lon) + (cif + dx.to(dtype) + half) * _f32(lon_step) for dx in dxs]
        cy = [_f32(min_lat) + (cjf + dy.to(dtype) + half) * _f32(lat_step) for dy in dys]
        pred, singular = solve(lons.to(dtype), lats.to(dtype), vals, cx, cy, vario, cfg["pivot_tol"])
        fb = (vals[0] + vals[1] + vals[2] + vals[3]) / torch.clamp(found.to(dtype), min=1.0)
        res = torch.where(singular | (found < 4), fb, pred)
        out.append(torch.where(oob, torch.full_like(res, float("nan")), res).float())
    return torch.cat(out)


def idw_queries(inputs: dict, cfg: dict, dtype=torch.float32, block: int = 1 << 20) -> torch.Tensor:
    """Inverse-distance weighting at scattered (lon, lat): the ``k`` nearest
    valid cells of the radius-R window (ties in collection order), weights
    1 / (d2^(power/2) + eps) summed nearest first, the quotient of the
    weighted sum by max(weights, eps), NaN where none was found or outside
    the grid.  Returns float32 (n,)."""
    elev, valid = inputs["elev"], inputs["valid"]
    shape = tuple(elev.shape)
    idw = cfg["idw"]
    eps = idw["eps"]
    out = []
    for s in range(0, inputs["lons"].numel(), block):
        lons, lats = inputs["lons"][s:s + block], inputs["lats"][s:s + block]
        oob, ci, cj, fx, fy = _prologue(lons, lats, cfg, shape, dtype)
        _, vals, _, _, d2s = _nearest(elev, valid, ci, cj, fx, fy, window_dydx(idw["window_radius"]), idw["k"], 0.5)
        num = torch.zeros_like(fx)
        den = torch.zeros_like(fx)
        for v, d2 in zip(vals, d2s):
            got = torch.isfinite(d2)
            w = torch.where(got, 1.0 / (d2 ** (idw["power"] / 2.0) + eps), torch.zeros_like(d2))
            num = num + w * v
            den = den + w
        res = torch.where(den > 0, num / torch.clamp(den, min=eps), torch.full_like(num, float("nan")))
        out.append(torch.where(oob, torch.full_like(res, float("nan")), res).float())
    return torch.cat(out)
