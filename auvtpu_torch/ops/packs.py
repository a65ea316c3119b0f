"""Stencil packs: per-cell neighbourhood layouts for scattered queries
(counterpart of :mod:`auvtpu.ops.packs`).

A pack stores, for every cell, its neighbourhood values (4 bilinear corners,
16 bicubic taps, the radius-R window in collection order) in P adjacent
floats, P a power of two; invalid and out-of-grid taps hold the finite
sentinel 1e30.  A query then reads its whole stencil as one contiguous row
``pack.view(-1, P)[cell]``: 16 B for bilinear, 64 B for bicubic and the
valid16 kriging pack, 128 B for the radius-2 window.  Packs are built once
per grid by dense shifts and amortize over every later batch, like the
reference's ctor-time grid upload (GridD.cu:65-83).

The JAX package fetches rows of 128 lanes and picks the sub-block with a
one-hot einsum (the TPU's gather unit wants whole rows); plain indexing
returns the same values.  The ``*_from_stencil`` epilogues finish a
stencil however it was read (:mod:`auvtpu_torch.ops.tiled` reads it from a
tile's slab); ``packed_bilinear`` and ``packed_bicubic`` keep the JAX
package's one weighted sum over the row, as its packed ops do.  The selection kernels B5-B7 and B11
(:mod:`auvtpu_torch.kernels.valid_select`,
:mod:`auvtpu_torch.kernels.scattered_select`) read the same packs.
"""

from __future__ import annotations

import torch

from ..config import IDWConfig, KrigingConfig
from ..grid import RegularGrid
from .scattered import (
    _catmull_rom,
    _nan_like,
    _normalize,
    as_index,
    cell_centres,
    centre_cells,
    krige_solve,
    queries,
)
from .window import masked_mean, ring_tables, topk_stable

MAX_PACK = 128

# invalid taps are a finite sentinel inside packs, as in the JAX package
# (whose one-hot pick would turn a NaN into NaN * 0 = NaN)
SENTINEL = 1e30


def _sentinel_plane(grid: RegularGrid) -> torch.Tensor:
    """The grid's elevations with invalid cells set to the sentinel."""
    return torch.where(grid.valid > 0.5, grid.elev, torch.full_like(grid.elev, SENTINEL))


def pack_width(n_offsets: int) -> int:
    """P: the offset count rounded up to a power of two."""
    P = 1
    while P < n_offsets:
        P *= 2
    return P


def build_pack(grid: RegularGrid, offsets, clamp: bool):
    """(H*W*P,) packed plane for the given (dy, dx) offsets, P the offset
    count padded to a power of two (at most 128).

    clamp=True replicates edges (bilinear/bicubic index clamping); False
    marks out-of-grid taps with the sentinel (window candidates)."""
    H, W = grid.shape
    P = pack_width(len(offsets))
    if P > MAX_PACK:
        raise ValueError(f"{len(offsets)} offsets need P={P} > {MAX_PACK}")
    dev = grid.device
    src = _sentinel_plane(grid)
    out = torch.full((H, W, P), SENTINEL, dtype=grid.dtype, device=dev)
    rows = torch.arange(H, device=dev)
    cols = torch.arange(W, device=dev)
    for t, (dy, dx) in enumerate(offsets):
        jj, ii = rows + dy, cols + dx
        plane = src.index_select(0, jj.clamp(0, H - 1)).index_select(1, ii.clamp(0, W - 1))
        if not clamp:
            inb = ((jj >= 0) & (jj < H))[:, None] & ((ii >= 0) & (ii < W))[None, :]
            plane = torch.where(inb, plane, torch.full_like(plane, SENTINEL))
        out[:, :, t] = plane
    return out.reshape(-1), P


def fetch_pack(pack: torch.Tensor, P: int, cell_idx: torch.Tensor, nan_invalid: bool = True) -> torch.Tensor:
    """cell_idx (N,) -> (N, P) stencil values; NaN at invalid taps, or the
    raw sentinel with ``nan_invalid=False``."""
    st = pack.view(-1, P)[cell_idx.long()]
    if not nan_invalid:
        return st
    return torch.where(st >= 0.5 * SENTINEL, _nan_like(st), st)


# ---------------------------------------------------------------------------
# packed scattered ops
# ---------------------------------------------------------------------------

BILINEAR_OFFSETS = [(0, 0), (0, 1), (1, 0), (1, 1)]
BICUBIC_OFFSETS = [(m, n) for m in range(-1, 3) for n in range(-1, 3)]


def window_offsets(max_radius: int, convention: str = "reference"):
    """Window offsets (dy, dx) in reference COLLECTION order (centre, then
    ring segments, of which any smaller radius is a prefix).  The pack index
    is the collection index, so ties at equal actual d2 break by collection
    order, exactly as :func:`auvtpu_torch.ops.window.window_select` and the
    GoldenV2 oracle break them.  ``convention`` affects only run-time
    distances, never the layout."""
    del convention
    offs, _ = ring_tables(max_radius)  # (M, 2) columns (dx, dy)
    return [(int(o[1]), int(o[0])) for o in offs]


class StencilPack:
    """Prebuilt packs for a grid: bilinear + bicubic + radius-R window."""

    def __init__(self, grid: RegularGrid, *, window_radius: int = 2):
        self.grid = grid
        self.window_radius = window_radius
        self.bilinear, self.p_bilinear = build_pack(grid, BILINEAR_OFFSETS, clamp=True)
        self.bicubic, self.p_bicubic = build_pack(grid, BICUBIC_OFFSETS, clamp=True)
        self.window, self.p_window = build_pack(grid, window_offsets(window_radius), clamp=False)


def bilinear_from_stencil(st, x, y, oob):
    """Bilinear from a (N, 4) corner stencil (NaN = invalid tap), the mean
    of the valid corners where any is invalid; the tile-streaming path's
    epilogue.  The same operations in the same order as
    :func:`~auvtpu_torch.ops.scattered.scattered_bilinear`."""
    x0 = as_index(torch.floor(x))
    y0 = as_index(torch.floor(y))
    wx = x - x0
    wy = y - y0
    z00, z01, z10, z11 = st[:, 0], st[:, 1], st[:, 2], st[:, 3]
    z0 = (1 - wx) * z00 + wx * z01
    z1 = (1 - wx) * z10 + wx * z11
    z = (1 - wy) * z0 + wy * z1
    ok = ~torch.isnan(st)
    zero = torch.where(ok, st, torch.zeros_like(st))
    okf = ok.to(st.dtype)
    cnt = okf[:, 0] + okf[:, 1] + okf[:, 2] + okf[:, 3]
    s = zero[:, 0] + zero[:, 1] + zero[:, 2] + zero[:, 3]
    fb = torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), _nan_like(s))
    out = torch.where(cnt < 4, fb, z)
    return torch.where(oob, _nan_like(out), out)


def packed_bilinear(pack: torch.Tensor, grid: RegularGrid, lons, lats, *, assume_valid: bool = False):
    """Bilinear from the 4-corner pack (the +1 taps are clamped at build
    time, matching min(x0+1, W-1)); the mean of the valid corners where any
    is invalid.  assume_valid=True (fully observed grids, e.g. Grid A) skips
    the fallback."""
    x, y, oob = _normalize(grid, lons, lats)
    x0 = as_index(torch.floor(x))
    y0 = as_index(torch.floor(y))
    wx = x - x0
    wy = y - y0
    st = fetch_pack(pack, 4, y0 * grid.num_lon + x0, nan_invalid=False)
    w = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy], dim=1)
    if assume_valid:
        z = (st * w).sum(dim=1)
        return torch.where(oob, _nan_like(z), z)
    ok = (st < 0.5 * SENTINEL).to(st.dtype)
    z = (st * ok * w).sum(dim=1)
    cnt = ok.sum(dim=1)
    s = (st * ok).sum(dim=1)
    fb = torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), _nan_like(s))
    out = torch.where(cnt >= 4, z, fb)
    return torch.where(oob, _nan_like(out), out)


def _cr_basis(t, i):
    """Catmull-Rom basis weight of tap i in {0..3} at parameter t: the
    tap-linear expansion of :func:`_catmull_rom`."""
    t2 = t * t
    t3 = t2 * t
    if i == 0:
        return 0.5 * (-t + 2.0 * t2 - t3)
    if i == 1:
        return 0.5 * (2.0 - 5.0 * t2 + 3.0 * t3)
    if i == 2:
        return 0.5 * (t + 4.0 * t2 - 3.0 * t3)
    return 0.5 * (-t2 + t3)


def bicubic_from_stencil(st, x, y, oob):
    """Catmull-Rom from a (N, 16) stencil (rows m=-1..2, cols n=-1..2); a
    NaN tap makes the result NaN (no fallback).  The same operations in the
    same order as :func:`~auvtpu_torch.ops.scattered.scattered_bicubic`."""
    xi = as_index(torch.floor(x))
    yi = as_index(torch.floor(y))
    tx = x - xi
    ty = y - yi
    rows = [_catmull_rom(st[:, 4 * m], st[:, 4 * m + 1], st[:, 4 * m + 2], st[:, 4 * m + 3], tx) for m in range(4)]
    out = _catmull_rom(rows[0], rows[1], rows[2], rows[3], ty)
    return torch.where(oob, _nan_like(out), out)


def packed_bicubic(pack: torch.Tensor, grid: RegularGrid, lons, lats, *, assume_valid: bool = False):
    """Clean-stencil bicubic for fully valid grids: a NaN tap makes the
    result NaN (no fallback; masked grids take the window path).
    Catmull-Rom is linear in its 16 taps, so this is one weighted sum with
    separable basis weights; assume_valid skips the invalid-tap check."""
    x, y, oob = _normalize(grid, lons, lats)
    xi = as_index(torch.floor(x))
    yi = as_index(torch.floor(y))
    tx = x - xi
    ty = y - yi
    st = fetch_pack(pack, 16, yi * grid.num_lon + xi, nan_invalid=False)  # rows m, cols n
    wrow = [_cr_basis(ty, i) for i in range(4)]
    wcol = [_cr_basis(tx, i) for i in range(4)]
    w = torch.stack([wrow[m] * wcol[n] for m in range(4) for n in range(4)], dim=1)
    z = (st * w).sum(dim=1)
    if not assume_valid:
        bad = st.max(dim=1).values >= 0.5 * SENTINEL
        z = torch.where(bad, _nan_like(z), z)
    return torch.where(oob, _nan_like(z), z)


def window_select_from_stencil(st, x, y, oob, ci, cj, *, k, window_radius, convention="reference"):
    """v2 top-k selection from a window stencil in collection order (NaN =
    invalid tap); shared by the pack and tile-streaming paths."""
    return select_from_stencil(st, window_offsets(window_radius), x, y, oob, ci, cj, k=k, convention=convention)


def select_from_stencil(st, offs, x, y, oob, ci, cj, *, k, convention="reference"):
    """v2 top-k over a collection-ordered offset table (NaN = invalid tap):
    stable on (d2, table index), so ties go to collection order.  Returns
    the select dict that the kriging and IDW epilogues take."""
    half = 0.5 if convention == "reference" else 0.0
    dt = x.dtype
    dev = x.device
    dyx = torch.tensor(offs, dtype=dt, device=dev)  # (m, 2) (dy, dx)
    di = (ci.to(dt)[:, None] + dyx[None, :, 1] + half) - x[:, None]
    dj = (cj.to(dt)[:, None] + dyx[None, :, 0] + half) - y[:, None]
    d2 = di * di + dj * dj
    m = len(offs)
    sub = st[:, :m]
    ok = ~torch.isnan(sub)
    top, idx = topk_stable(d2, ok, k)
    slot_ok = torch.isfinite(top)
    picked = torch.gather(torch.where(ok, sub, torch.zeros_like(sub)), 1, idx)
    vals = torch.where(slot_ok, picked, torch.zeros_like(picked))
    # one composite position code, (dy+R)*B + (dx+R), decoded as the JAX
    # package decodes it
    R = int(dyx.abs().max())
    B = 2 * R + 2
    code_tab = (dyx[:, 0] + R) * B + (dyx[:, 1] + R)
    code = code_tab[idx]
    sel_dy = torch.floor(code / B) - R
    sel_dx = code - (sel_dy + R) * B - R
    return {
        "x": x, "y": y, "oob": oob, "ci": ci, "cj": cj,
        "val": vals, "d2": top, "slot_ok": slot_ok,
        "found": slot_ok.sum(dim=1).to(torch.int32),
        "dy": sel_dy, "dx": sel_dx,
    }


def packed_window_select(pack, grid: RegularGrid, lons, lats, *, k, window_radius, convention="reference"):
    """Window top-k from a pack: one row read per query + the stable
    selection, v2 semantics."""
    x, y, oob = _normalize(grid, lons, lats)
    ci, cj = centre_cells(grid, x, y)
    st = fetch_pack(pack, pack_width(len(window_offsets(window_radius))), cj * grid.num_lon + ci)
    return window_select_from_stencil(st, x, y, oob, ci, cj, k=k, window_radius=window_radius, convention=convention)


def kriging_from_select(grid: RegularGrid, lons, lats, sel, *, vparams=None, convention: str = "reference", model: str = "exponential", with_variance: bool = False):
    """Kriging solve + fallbacks from a window-select dict (shared by the
    packed paths and the B7 wrappers).  with_variance=True also returns the
    prediction variance (NaN at fallback / out-of-bounds queries)."""
    half = 0.5 if convention == "reference" else 0.0
    cx, cy = cell_centres(grid, sel["ci"], sel["cj"], sel["dx"], sel["dy"], half)
    qlon, qlat = queries(grid, lons, lats)
    out = krige_solve(
        qlon, qlat, sel["val"], cx, cy, KrigingConfig(), vparams=vparams,
        model=model, with_variance=with_variance,
    )
    pred, singular = out[0], out[1]
    fb = masked_mean(torch.where(sel["slot_ok"], sel["val"], _nan_like(sel["val"])), sel["slot_ok"])
    bail = singular | (sel["found"] < 4)
    res = torch.where(sel["oob"], _nan_like(pred), torch.where(bail, fb, pred))
    if not with_variance:
        return res
    var = torch.where(sel["oob"] | bail, _nan_like(pred), out[2])
    return res, var


def idw_from_select(sel, *, power: float = 2.0, eps: float = 1e-12):
    """IDW weights + fallbacks from a window-select dict (shared)."""
    d2 = sel["d2"]
    w = torch.where(sel["slot_ok"], 1.0 / (d2 ** (power / 2.0) + eps), torch.zeros_like(d2))
    ws = w.sum(dim=1)
    out = torch.where(ws > 0, (w * sel["val"]).sum(dim=1) / torch.clamp(ws, min=eps), _nan_like(ws))
    return torch.where(sel["oob"], _nan_like(out), out)


def packed_kriging(pack, grid: RegularGrid, lons, lats, *, window_radius: int = 2, vparams=None, convention: str = "reference", model: str = "exponential", with_variance: bool = False):
    """Ordinary kriging over the radius-R window pack (any grid)."""
    sel = packed_window_select(pack, grid, lons, lats, k=4, window_radius=window_radius, convention=convention)
    return kriging_from_select(grid, lons, lats, sel, vparams=vparams, convention=convention, model=model, with_variance=with_variance)


def packed_idw(pack, grid: RegularGrid, lons, lats, *, k: int = 8, power: float = 2.0, window_radius: int = 2, convention: str = "reference"):
    """k-nearest IDW over the radius-R window pack (any grid)."""
    sel = packed_window_select(pack, grid, lons, lats, k=k, window_radius=window_radius, convention=convention)
    return idw_from_select(sel, power=power, eps=IDWConfig(k=k, power=power).eps)


# ---------------------------------------------------------------------------
# fully valid grids: 16-tap kriging pack
# ---------------------------------------------------------------------------

# {-2..1}^2 in reference COLLECTION order (a filtered subset of the radius-2
# window table, so relative tie order is preserved)
VALID16_OFFSETS = [
    (dy, dx) for (dy, dx) in window_offsets(2) if -2 <= dy <= 1 and -2 <= dx <= 1
]


def build_valid16_pack(grid: RegularGrid):
    """16-tap {-2..1}^2 window pack for :func:`packed_kriging_valid` (16x
    the grid's bytes, half the radius-2 window pack)."""
    pack, P = build_pack(grid, VALID16_OFFSETS, clamp=False)
    assert P == 16
    return pack


def packed_kriging_valid(pack16, grid: RegularGrid, lons, lats, *, vparams=None, convention: str = "reference", model: str = "exponential"):
    """Kriging for FULLY VALID grids (Grid A): the top-4 candidates of the
    radius-2 window provably lie in {-2..1}^2 under the reference (+0.5)
    convention (proof in ``auvtpu.ops.packs.packed_kriging_valid``), so a
    16-tap pack in filtered collection order selects exactly what
    :func:`packed_kriging` selects.  Masked grids must not take this path:
    their 4 nearest VALID cells may lie outside {-2..1}^2."""
    if convention != "reference":
        raise ValueError(
            "packed_kriging_valid's containment proof is for the reference "
            "(+0.5) convention; use packed_kriging for 'centered'"
        )
    x, y, oob = _normalize(grid, lons, lats)
    ci, cj = centre_cells(grid, x, y)
    st = fetch_pack(pack16, 16, cj * grid.num_lon + ci)
    sel = select_from_stencil(st, VALID16_OFFSETS, x, y, oob, ci, cj, k=4, convention=convention)
    return kriging_from_select(grid, lons, lats, sel, vparams=vparams, convention=convention, model=model)

