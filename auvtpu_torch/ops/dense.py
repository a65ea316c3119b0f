"""Dense (cell-aligned) fills (counterpart of :mod:`auvtpu.ops.dense`).

Queries sit exactly on cells, so the distance from a query to a candidate at
offset (dx, dy) is a static function of the offset.  Sorting the window
offsets by (distance^2, collection order) once on the host turns "k nearest
valid neighbours" into "first k valid in static order": a prefix scan with no
sort at all (:mod:`auvtpu_torch.tables`).

Everything here is the plain whole-plane form: each offset shifts the padded
planes and updates every cell's state with mask arithmetic, and the scan
stops after the first chunk of offsets in which no cell still had room.  The
CUDA kernels in :mod:`auvtpu_torch.kernels.window_fill` compute the same
planes; these functions are their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import IDWConfig, KrigingConfig
from ..grid import RegularGrid
from ..tables import CHUNK, padded_tables, sorted_offsets
from .scattered import krige_solve


def resolve_backend(backend: str, elev: torch.Tensor) -> str:
    """``"auto"`` is ``"fused"`` (the CUDA kernels) for a CUDA float32 plane
    and ``"torch"`` (the plain versions) for a CPU or float64 one, the rule
    of ``auvtpu/streaming.py:177-190``; any other name is returned as it is."""
    if backend != "auto":
        return backend
    return "fused" if elev.is_cuda and elev.dtype == torch.float32 else "torch"


def _padded(grid: RegularGrid, radius: int):
    """Edge-pad elev (values irrelevant outside) and zero-pad validity."""
    pe = F.pad(grid.elev[None], (radius,) * 4, mode="replicate")[0]
    pv = F.pad(grid.valid, (radius,) * 4)
    return pe, pv


# ---------------------------------------------------------------------------
# bilinear fill (cell-aligned): corner-mean semantics at every cell
# ---------------------------------------------------------------------------

def fill_bilinear(grid: RegularGrid):
    """Per-cell bilinear prediction at the cell's own coordinates: the value
    if all four corners (c,r), (c+1,r), (c,r+1), (c+1,r+1) are valid, else the
    mean of the valid corners, else NaN (GridH.cpp:170-199 with wx=wy=0).
    The +1 corners clamp at the far edges (edge-replicate padding)."""
    H, W = grid.shape
    ev = F.pad(grid.elev[None], (0, 1, 0, 1), mode="replicate")[0]
    va = F.pad(grid.valid[None], (0, 1, 0, 1), mode="replicate")[0]
    z = [ev[0:H, 0:W], ev[0:H, 1:W + 1], ev[1:H + 1, 0:W], ev[1:H + 1, 1:W + 1]]
    m = [va[0:H, 0:W], va[0:H, 1:W + 1], va[1:H + 1, 0:W], va[1:H + 1, 1:W + 1]]
    cnt = m[0] + m[1] + m[2] + m[3]
    s = z[0] * m[0] + z[1] * m[1] + z[2] * m[2] + z[3] * m[3]
    fb = torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), float("nan"))
    return torch.where(cnt >= 4, z[0], fb)


# ---------------------------------------------------------------------------
# first-k-valid prefix accumulation over statically sorted offsets
# ---------------------------------------------------------------------------

def _offset_loop(grid: RegularGrid, max_radius: int, k: int, state, step, convention: str = "reference"):
    """Early-exit chunked scan of the sorted offset table.

    ``step(state, v, ok, j)`` folds in table row ``j``: ``v`` and ``ok`` are
    the elevation and validity planes shifted by that row's offset.
    ``state[0]`` is the per-cell count; the scan stops after the first chunk
    in which every cell already held ``k`` (one host read per chunk).
    Offsets are visited in table order, so stopping changes nothing.
    """
    tdx, tdy, _, live, n_chunks = padded_tables(max_radius, convention)
    pe, pv = _padded(grid, max_radius)
    H, W = grid.shape
    R = max_radius
    for c in range(n_chunks):
        if c > 0 and not bool(torch.any(state[0] < k)):
            break
        for j in range(c * CHUNK, (c + 1) * CHUNK):
            if live[j] == 0.0:
                continue  # tail padding of the table
            dy, dx = int(tdy[j]), int(tdx[j])
            v = pe[R + dy:R + dy + H, R + dx:R + dx + W]
            ok = pv[R + dy:R + dy + H, R + dx:R + dx + W]
            state = step(state, v, ok, j)
    return state


def _b3_kernel(backend: str, grid: RegularGrid) -> bool:
    """Whether an IDW or mean fill runs the B3 kernel: 'fused' and 'select'
    do (B3's selection and arithmetic are one pass), 'torch' runs the plain
    version below, and 'auto' follows :func:`resolve_backend`."""
    backend = resolve_backend(backend, grid.elev)
    if backend not in ("torch", "select", "fused"):
        raise ValueError(backend)
    return backend != "torch"


def fill_window_mean(grid: RegularGrid, *, k: int = 4, max_radius: int = 10, convention: str = "reference", backend: str = "auto"):
    """Mean of the k nearest valid cells per cell, NaN where none is found:
    the dense Grid B 'cubic' (at a masked centre the reference's bicubic
    always takes its ring-fallback path, kernels.cu:305-371).

    backend: 'torch' (the plain whole-plane scan below), 'fused' or
    'select' (the B3 kernel) or 'auto' ('fused' on a CUDA float32 grid,
    'torch' otherwise)."""
    if _b3_kernel(backend, grid):
        from ..kernels.window_fill import fill_mean_fused

        return fill_mean_fused(grid, k=k, max_radius=max_radius, convention=convention)
    dt = grid.dtype
    zero = torch.zeros_like(grid.elev)

    def step(state, v, ok, _j):
        cnt, s = state
        take = ok * (cnt < k).to(dt)
        return cnt + take, s + take * v

    cnt, s = _offset_loop(grid, max_radius, k, (zero, zero), step, convention)
    return torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), float("nan"))


def idw_denominators(max_radius: int, power: float, convention: str = "reference") -> np.ndarray:
    """``d2^(power/2) + eps`` per row of the padded offset table, in float32
    as the XLA path computes it (``inf`` on the padding rows)."""
    _, _, d2s, _, _ = padded_tables(max_radius, convention)
    return d2s ** np.float32(power / 2.0) + np.float32(IDWConfig().eps)


def fill_idw(grid: RegularGrid, *, k: int = 8, power: float = 2.0, max_radius: int = 10, convention: str = "reference", backend: str = "auto"):
    """k-nearest inverse-distance-weighted fill plane: weights
    1/(d2^(p/2)+eps), Σwv / max(Σw, eps), NaN where no neighbour is found.
    ``backend`` as for :func:`fill_window_mean`."""
    if _b3_kernel(backend, grid):
        from ..kernels.window_fill import fill_idw_fused

        return fill_idw_fused(grid, k=k, power=power, max_radius=max_radius, convention=convention)
    eps = IDWConfig().eps
    dt = grid.dtype
    zero = torch.zeros_like(grid.elev)
    den = idw_denominators(max_radius, power, convention)

    def step(state, v, ok, j):
        cnt, ws, vs = state
        take = ok * (cnt < k).to(dt)
        w = take / float(den[j])
        return cnt + take, ws + w, vs + w * v

    cnt, ws, vs = _offset_loop(grid, max_radius, k, (zero, zero, zero), step, convention)
    return torch.where(cnt > 0, vs / torch.clamp(ws, min=eps), float("nan"))


def window_topk_idx(grid: RegularGrid, *, k: int = 4, max_radius: int = 10, convention: str = "reference"):
    """First-k-valid selection as slot indices: (cnt, [k planes]) where each
    plane holds the sorted-table index of the slot's cell as a float, -1 at
    an empty slot.  Slots are written with selects."""
    zero = torch.zeros_like(grid.elev)

    def step(state, _v, ok, j):
        cnt, idxs = state
        take = ok * (cnt < k).to(grid.dtype)
        hit = take > 0
        idxs = [torch.where(hit & (cnt == s), float(j), idxs[s]) for s in range(k)]
        return cnt + take, idxs

    return _offset_loop(grid, max_radius, k, (zero, [zero - 1.0] * k), step, convention)


def _slots_at(grid: RegularGrid, idxs, flat_cells, max_radius: int):
    """(vals (N, K), dxs (N, K), dys (N, K)) at the cells ``flat_cells`` from
    slot index planes of the reference table.  Empty slots read value 0 (so
    a sum over the slots stays the neighbour sum) and the offset of table
    row 0."""
    dxs_np, dys_np, _ = sorted_offsets(max_radius)
    dev = grid.device
    tdx = torch.from_numpy(dxs_np.astype(np.float32)).to(dev)
    tdy = torch.from_numpy(dys_np.astype(np.float32)).to(dev)
    W = grid.num_lon
    R = max_radius
    pe, _ = _padded(grid, R)
    pe = pe.reshape(-1)
    pw = W + 2 * R
    flat_cells = torch.as_tensor(flat_cells).to(dev).long()
    rows = flat_cells // W
    cols = flat_cells % W
    out_v, out_dx, out_dy = [], [], []
    for plane in idxs:
        oi = plane.reshape(-1)[flat_cells]
        oij = torch.clamp(oi, min=0).long()
        dx = tdx[oij]
        dy = tdy[oij]
        src = (rows + dy.long() + R) * pw + (cols + dx.long() + R)
        out_v.append(torch.where(oi >= 0, pe[src], 0.0))
        out_dx.append(dx.to(grid.dtype))
        out_dy.append(dy.to(grid.dtype))
    return torch.stack(out_v, dim=1), torch.stack(out_dx, dim=1), torch.stack(out_dy, dim=1)


def window_topk_planes(grid: RegularGrid, *, k: int = 4, max_radius: int = 10, convention: str = "reference"):
    """First-k-valid selection as whole-grid planes (cnt, vals, dxs, dys): per
    cell, the k nearest valid neighbours in table order with their offsets.
    Empty slots hold value 0 and offset (0, 0).

    Slots are updated as ``old + hit * (new - old)``: each slot is written at
    most once, from 0, and the zero-filled elevation is finite, so the result
    is exactly the selected value.
    """
    dt = grid.dtype
    tdx, tdy, _, _, _ = padded_tables(max_radius, convention)
    zero = torch.zeros_like(grid.elev)

    def step(state, v, ok, j):
        cnt, vals, dxs, dys = state
        dx, dy = float(tdx[j]), float(tdy[j])
        take = ok * (cnt < k).to(dt)
        nv, ndx, ndy = [], [], []
        for s in range(k):
            hit = take * (cnt == s).to(dt)
            nv.append(vals[s] + hit * (v - vals[s]))
            ndx.append(dxs[s] + hit * (dx - dxs[s]))
            ndy.append(dys[s] + hit * (dy - dys[s]))
        return cnt + take, nv, ndx, ndy

    init = (zero, [zero] * k, [zero] * k, [zero] * k)
    return _offset_loop(grid, max_radius, k, init, step, convention)


def _krige_from_slots(grid, cnt, vals, dxs, dys, cols, rows, *, steps=None, vparams=None, convention="reference", model="exponential", with_variance=False, solver="gj"):
    """Batched kriging solve from selected-slot data.

    cols/rows: (N,) float global cell coordinates; slot inputs are (N, 4).
    Coordinates stay absolute f32 degrees (``min_lon + (col + dx + half) *
    lon_step``) and are differenced afterwards, as the reference does.
    Returns the prediction, falling back to the mean of the found neighbours
    where fewer than 4 were found or a pivot was singular; with
    ``with_variance`` also the variance, NaN at fallback cells.
    """
    half = 0.5 if convention == "reference" else 0.0
    dt = grid.dtype
    lat_step, lon_step = (grid.lat_step, grid.lon_step) if steps is None else steps
    lat_step = torch.as_tensor(lat_step, dtype=dt).to(cols.device)
    lon_step = torch.as_tensor(lon_step, dtype=dt).to(cols.device)
    qlon = grid.min_lon + cols * lon_step
    qlat = grid.min_lat + rows * lat_step
    cx = grid.min_lon + (cols[:, None] + dxs + half) * lon_step
    cy = grid.min_lat + (rows[:, None] + dys + half) * lat_step
    out = krige_solve(
        qlon, qlat, vals, cx, cy, KrigingConfig(), vparams=vparams,
        model=model, with_variance=with_variance, solver=solver,
    )
    pred, singular = out[0], out[1]
    fbs = vals[:, 0] + vals[:, 1] + vals[:, 2] + vals[:, 3]
    fb = torch.where(cnt > 0, fbs / torch.clamp(cnt, min=1.0), torch.full_like(fbs, float("nan")))
    bail = singular | (cnt < 4)
    plane = torch.where(bail, fb, pred)
    if with_variance:
        return plane, torch.where(bail, torch.full_like(fbs, float("nan")), out[2])
    return plane


def krige_planes(grid: RegularGrid, selection, *, row0=0, col0=0, steps=None, vparams=None, convention: str = "reference", model: str = "exponential", with_variance: bool = False, solver: str = "gj"):
    """Kriging fill plane(s) from a whole-plane 4-slot ``selection`` (cnt,
    vals, dxs, dys) as returned by :func:`window_topk_planes` or the B2
    kernel.  row0/col0 are the plane's global origin and steps the global
    (lat_step, lon_step) when the plane is a block of a larger grid."""
    cnt, vals, dxs, dys = selection
    H, W = grid.shape
    dt, dev = grid.dtype, grid.device
    cgrid = (torch.arange(W, dtype=dt, device=dev).expand(H, W) + col0).reshape(-1)
    rgrid = (torch.arange(H, dtype=dt, device=dev)[:, None].expand(H, W) + row0).reshape(-1)
    out = _krige_from_slots(
        grid,
        cnt.reshape(-1),
        torch.stack([v.reshape(-1) for v in vals], dim=1),
        torch.stack([d.reshape(-1) for d in dxs], dim=1),
        torch.stack([d.reshape(-1) for d in dys], dim=1),
        cgrid,
        rgrid,
        steps=steps,
        vparams=vparams,
        convention=convention,
        model=model,
        with_variance=with_variance,
        solver=solver,
    )
    if with_variance:
        plane, var = out
        return plane.reshape(H, W), var.reshape(H, W)
    return out.reshape(H, W)


def fill_kriging(grid: RegularGrid, *, max_radius: int = 10, row0=0, col0=0, steps=None, vparams=None, convention: str = "reference", backend: str = "auto", model: str = "exponential", with_variance: bool = False):
    """Ordinary-kriging fill plane: first-4-valid selection, then a batched
    5x5 solve per cell (kernels.cu:478-546).

    backend: 'torch' (plain whole-plane selection and solve), 'select' (the
    B2 selection kernel + the torch solve), 'fused' (the B1 kernel:
    selection and solve in one pass) or 'auto' (see :func:`resolve_backend`:
    'fused' on a CUDA float32 grid, 'torch' otherwise).  On a CPU grid the
    kernels' wrappers run their plain versions.  with_variance=True also
    returns the prediction-variance plane (NaN at fallback cells).
    """
    opts = dict(
        row0=row0, col0=col0, steps=steps, vparams=vparams,
        convention=convention, model=model, with_variance=with_variance,
    )
    backend = resolve_backend(backend, grid.elev)
    if backend == "fused":
        from ..kernels.window_fill import fill_kriging_fused

        return fill_kriging_fused(grid, max_radius=max_radius, **opts)
    if backend == "select":
        from ..kernels.window_fill import topk_full

        sel = topk_full(grid, k=4, max_radius=max_radius, convention=convention)
    elif backend == "torch":
        sel = window_topk_planes(grid, k=4, max_radius=max_radius, convention=convention)
    else:
        raise ValueError(backend)
    return krige_planes(grid, sel, **opts)


def kriging_at_cells(grid: RegularGrid, rows, cols, *, max_radius: int = 10, vparams=None, convention: str = "reference", backend: str = "auto", model: str = "exponential"):
    """Kriging predictions at an explicit cell list: the dense fill plane,
    then the requested cells."""
    plane = fill_kriging(
        grid, max_radius=max_radius, vparams=vparams, convention=convention,
        backend=backend, model=model,
    )
    rows = torch.as_tensor(rows, dtype=torch.int64).to(plane.device)
    cols = torch.as_tensor(cols, dtype=torch.int64).to(plane.device)
    return plane.reshape(-1)[rows * grid.num_lon + cols]
