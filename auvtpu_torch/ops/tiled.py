"""Tile-streaming scattered ops (counterpart of :mod:`auvtpu.ops.tiled`):
queries sorted by grid tile, then each query's stencil read from the grid.

1. :func:`_partition` buckets the queries by the grid tile of their anchor
   cell (a stable sort by tile id) and pads each tile's queries to whole
   blocks of ``qblk``: the static (n_blocks, qblk) layout, a block -> tile
   map and each lane's source index (-1 for pad lanes), equal to the JAX
   package's;
2. the live lanes, in that order (tile by tile, so neighbouring lanes read
   neighbouring cells), gather their stencils in one index of the
   sentinel-encoded plane: indices clamped into the grid for
   bilinear/bicubic, a tap outside it invalid for the window candidates.
   These are the values the JAX package's halo-padded slabs hold
   (edge-replicated, or the sentinel), so no slab is built; pad lanes are
   never computed;
3. the shared epilogues of :mod:`auvtpu_torch.ops.packs`
   (``bilinear_from_stencil``, ``bicubic_from_stencil``,
   ``window_select_from_stencil`` + ``kriging_from_select`` /
   ``idw_from_select``) finish each method, and the results go back to
   query order.

The JAX package extracts the stencils from its slabs with one-hot matmuls
on the MXU, so that a TPU needs no gathers; that is TPU mechanics and is
not ported.  No Pallas kernel is involved in the JAX path, so none is here:
this is plain torch on the grid's device.  The partition is built once and
run many times (:func:`tiled_partition` + the ``*_run`` ops, a fixed query
layout around the vehicle while the map updates); it holds its own tile
and block size, so the ``*_run`` ops take neither.  The one-shot ops
include the partition and keep the JAX signatures.
"""

from __future__ import annotations

import torch

from ..grid import RegularGrid, device_cache
from .packs import (
    SENTINEL,
    _sentinel_plane,
    bicubic_from_stencil,
    bilinear_from_stencil,
    idw_from_select,
    kriging_from_select,
    window_offsets,
    window_select_from_stencil,
)
from .scattered import _nan_like, _normalize, as_index, centre_cells

TILE = (128, 256)
QBLK = 2048


# ---------------------------------------------------------------------------
# partition: bucket queries by tile, pad each bucket to qblk-sized blocks
# ---------------------------------------------------------------------------

def _partition(x, y, H: int, W: int, *, anchor: str, tile, qblk: int):
    """Static-shape tile partition of grid coordinates (x, y).

    Returns (block_tile (nb,) int32, qx (nb, qblk), qy (nb, qblk),
    src (nb, qblk) int32 original index, -1 for pad lanes, n_tx).  nb is
    the static worst case: every tile wastes < qblk pad lanes.
    """
    th, tw = tile
    n_ty = -(-H // th)
    n_tx = -(-W // tw)
    n_tiles = n_ty * n_tx
    n = x.shape[0]
    dev = x.device
    if anchor == "round":
        ax = as_index(torch.floor(x + 0.5)).clamp(0, W - 1)
        ay = as_index(torch.floor(y + 0.5)).clamp(0, H - 1)
    else:
        ax = as_index(torch.floor(x)).clamp(0, W - 1)
        ay = as_index(torch.floor(y)).clamp(0, H - 1)
    tid = (ay // th) * n_tx + (ax // tw)

    order = torch.argsort(tid, stable=True)
    tid_s = tid[order].long()
    counts = torch.bincount(tid.long(), minlength=n_tiles)
    blocks_per_tile = (counts + qblk - 1) // qblk
    cum_blocks = torch.cumsum(blocks_per_tile, 0)
    zero = torch.zeros(1, dtype=cum_blocks.dtype, device=dev)
    pad_start = qblk * torch.cat([zero, cum_blocks[:-1]])
    seg_start = torch.cat([zero, torch.cumsum(counts, 0)[:-1]])
    dst = pad_start[tid_s] + (torch.arange(n, device=dev) - seg_start[tid_s])

    nb = (n + n_tiles * (qblk - 1) + qblk - 1) // qblk  # static worst case
    m = nb * qblk
    qx = torch.zeros(m, dtype=x.dtype, device=dev)
    qy = torch.zeros(m, dtype=y.dtype, device=dev)
    src = torch.full((m,), -1, dtype=torch.int32, device=dev)
    qx[dst] = x[order]
    qy[dst] = y[order]
    src[dst] = order.to(torch.int32)
    block_tile = torch.searchsorted(cum_blocks, torch.arange(nb, device=dev), right=True)
    block_tile = block_tile.clamp(0, n_tiles - 1).to(torch.int32)
    return block_tile, qx.reshape(nb, qblk), qy.reshape(nb, qblk), src.reshape(nb, qblk), n_tx


def tiled_partition(grid: RegularGrid, lons, lats, *, anchor: str = "round", tile=TILE, qblk: int = QBLK):
    """Partition a query batch once, to reuse with the ``*_run`` ops while
    the grid updates (the map mosaic changes every swath, the query layout
    around the vehicle does not).  ``anchor='floor'`` for bilinear/bicubic,
    ``'round'`` for the window ops (kriging/IDW).  Returns a dict for the
    ``tiled_*_run`` ops."""
    x, y, oob = _normalize(grid, lons, lats)
    H, W = grid.shape
    block_tile, qx, qy, src, _ = _partition(x, y, H, W, anchor=anchor, tile=tile, qblk=qblk)
    return {"block_tile": block_tile, "qx": qx, "qy": qy, "src": src, "oob": oob}


# ---------------------------------------------------------------------------
# live lanes and their stencils
# ---------------------------------------------------------------------------

def _live_lanes(tb):
    """Every block's live lanes, flattened in partition order (tile by
    tile): (qx, qy, source index).  Pad lanes (src -1) are dropped here."""
    src = tb["src"].reshape(-1)
    live = src >= 0
    return tb["qx"].reshape(-1)[live], tb["qy"].reshape(-1)[live], src[live].long()


@device_cache(maxsize=32)
def _taps(taps: tuple, device: torch.device) -> torch.Tensor:
    """(2, T) row and column offsets of a stencil's taps, on ``device``."""
    return torch.tensor(taps, dtype=torch.long).T.contiguous().to(device)


def _stencil(grid: RegularGrid, r, c, taps, *, clamp: bool):
    """(N, len(taps)) grid values at rows ``r + dr``, columns ``c + dc``,
    NaN where the cell is invalid.  ``clamp``: indices clamped into the grid
    (bilinear/bicubic); else a tap outside the grid is NaN (a window
    candidate there is no candidate)."""
    H, W = grid.shape
    d = _taps(tuple(taps), r.device)
    rr, cc = r[:, None] + d[0], c[:, None] + d[1]
    st = _sentinel_plane(grid).reshape(-1)[rr.clamp(0, H - 1) * W + cc.clamp(0, W - 1)]
    bad = st >= 0.5 * SENTINEL
    if not clamp:
        bad |= (rr < 0) | (rr >= H) | (cc < 0) | (cc >= W)
    return st.masked_fill(bad, float("nan"))


def _scatter_back(n: int, vals, src, oob):
    out = torch.full((n,), float("nan"), dtype=vals.dtype, device=vals.device)
    out[src] = vals
    return torch.where(oob, _nan_like(out), out)


# ---------------------------------------------------------------------------
# tiled ops
# ---------------------------------------------------------------------------

def tiled_bilinear_run(grid: RegularGrid, tb):
    """Bilinear (kernels.cu:173-234 semantics) over a prebuilt partition."""
    bx, by, src = _live_lanes(tb)
    st = _stencil(grid, as_index(torch.floor(by), torch.long), as_index(torch.floor(bx), torch.long),
                  ((0, 0), (0, 1), (1, 0), (1, 1)), clamp=True)
    vals = bilinear_from_stencil(st, bx, by, torch.zeros_like(bx, dtype=torch.bool))
    return _scatter_back(tb["oob"].shape[0], vals, src, tb["oob"])


def tiled_bilinear(grid: RegularGrid, lons, lats, *, tile=TILE, qblk: int = QBLK):
    return tiled_bilinear_run(grid, tiled_partition(grid, lons, lats, anchor="floor", tile=tile, qblk=qblk))


def tiled_bicubic_run(grid: RegularGrid, tb):
    """Clean-stencil Catmull-Rom (kernels.cu:246-254; NaN taps propagate)."""
    bx, by, src = _live_lanes(tb)
    st = _stencil(grid, as_index(torch.floor(by), torch.long) - 1, as_index(torch.floor(bx), torch.long) - 1,
                  [(m, n) for m in range(4) for n in range(4)], clamp=True)
    vals = bicubic_from_stencil(st, bx, by, torch.zeros_like(bx, dtype=torch.bool))
    return _scatter_back(tb["oob"].shape[0], vals, src, tb["oob"])


def tiled_bicubic(grid: RegularGrid, lons, lats, *, tile=TILE, qblk: int = QBLK):
    return tiled_bicubic_run(grid, tiled_partition(grid, lons, lats, anchor="floor", tile=tile, qblk=qblk))


def _tiled_window_run(grid: RegularGrid, tb, finish, *, k: int, window_radius: int, convention: str):
    bx, by, src = _live_lanes(tb)
    ci, cj = centre_cells(grid, bx, by)
    # the (2R+1)^2 patch around the clipped round anchor, in collection order
    st = _stencil(grid, cj.long(), ci.long(), window_offsets(window_radius), clamp=False)
    sel = window_select_from_stencil(st, bx, by, torch.zeros_like(bx, dtype=torch.bool), ci, cj,
                                     k=k, window_radius=window_radius, convention=convention)
    return _scatter_back(tb["oob"].shape[0], finish(sel, bx, by), src, tb["oob"])


def tiled_kriging_run(grid: RegularGrid, tb, *, window_radius: int = 2, vparams=None, convention: str = "reference"):
    """Window top-4 + 5x5 kriging solve (kernels.cu:403-546, v2 selection)."""

    def finish(sel, bx, by):
        qlon = grid.min_lon + bx * grid.lon_step
        qlat = grid.min_lat + by * grid.lat_step
        return kriging_from_select(grid, qlon, qlat, sel, vparams=vparams, convention=convention)

    return _tiled_window_run(grid, tb, finish, k=4, window_radius=window_radius, convention=convention)


def tiled_kriging(grid: RegularGrid, lons, lats, *, window_radius: int = 2, vparams=None,
                  convention: str = "reference", tile=TILE, qblk: int = QBLK):
    tb = tiled_partition(grid, lons, lats, anchor="round", tile=tile, qblk=qblk)
    return tiled_kriging_run(grid, tb, window_radius=window_radius, vparams=vparams, convention=convention)


def tiled_idw_run(grid: RegularGrid, tb, *, k: int = 8, power: float = 2.0, window_radius: int = 2,
                  convention: str = "reference"):
    """k-nearest IDW over the window, tile-streamed."""
    return _tiled_window_run(grid, tb, lambda sel, bx, by: idw_from_select(sel, power=power), k=k,
                             window_radius=window_radius, convention=convention)


def tiled_idw(grid: RegularGrid, lons, lats, *, k: int = 8, power: float = 2.0, window_radius: int = 2,
              convention: str = "reference", tile=TILE, qblk: int = QBLK):
    tb = tiled_partition(grid, lons, lats, anchor="round", tile=tile, qblk=qblk)
    return tiled_idw_run(grid, tb, k=k, power=power, window_radius=window_radius, convention=convention)
