"""Windowed k-nearest candidate selection for scattered queries
(counterpart of :mod:`auvtpu.ops.window`).

Every query gathers the fixed (2R+1)^2 candidate window around its centre
cell, in the reference's collection order (GridH.cpp:24-118), and keeps the
k nearest valid cells by (squared distance, collection order): a stable
sort of the masked d2 key, so equal distances resolve in collection order
as ``lax.top_k`` resolves them in the JAX package.  Plain indexing into the
NaN-encoded plane takes the place of ``ops/gathers.py``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..grid import RegularGrid
from ..tables import ring_offsets


@lru_cache(maxsize=8)
def ring_tables(max_radius: int = 10):
    """(offsets (M, 2) int32 (dx, dy), seg_id (M,) int32) in reference
    collection order (centre, then ring segments), as numpy."""
    offs, seg = ring_offsets(max_radius)
    return offs.astype(np.int32), seg.astype(np.int32)


def nan_plane(grid: RegularGrid) -> torch.Tensor:
    """Value and validity in one plane: invalid cells are NaN."""
    return torch.where(grid.valid > 0.5, grid.elev, float("nan"))


def fetch_masked(nanp: torch.Tensor, jj: torch.Tensor, ii: torch.Tensor, width: int):
    """(value, valid) at integer cells (indices in range) of a NaN-encoded
    plane; invalid cells read 0."""
    v = nanp.reshape(-1)[(jj * width + ii).long()]
    ok = ~torch.isnan(v)
    return torch.where(ok, v, torch.zeros_like(v)), ok


def topk_stable(d2: torch.Tensor, ok: torch.Tensor, k: int):
    """The k smallest ``d2`` among ``ok`` entries per row, ties to the lowest
    column: (d2 (N, k), column (N, k)), +inf where fewer than k are ok."""
    if not 1 <= k <= d2.shape[1]:
        raise ValueError(f"k={k} outside 1..{d2.shape[1]} (the candidates per query)")
    key = torch.where(ok, d2, torch.full_like(d2, float("inf")))
    vals, idx = torch.sort(key, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def window_select(
    grid: RegularGrid,
    x: torch.Tensor,
    y: torch.Tensor,
    ci: torch.Tensor,
    cj: torch.Tensor,
    *,
    k: int = 4,
    max_radius: int = 10,
    convention: str = "reference",
):
    """Select the k nearest valid cells in the (2R+1)^2 window around (ci, cj).

    x, y are float grid-space query coordinates (N,), ci, cj the integer
    window centre (N,).  Returns a dict of
      val:     (N, k) selected values (not meaningful where slot >= found)
      ii, jj:  (N, k) int32 column / row indices
      d2:      (N, k) squared index-space distances (+inf at empty slots)
      found:   (N,) int32 number of valid candidates, capped at k
      slot_ok: (N, k) bool, the slot holds a real candidate
    """
    offs, _ = ring_tables(max_radius)
    H, W = grid.shape
    dev = grid.device
    odx = torch.from_numpy(offs[:, 0]).to(dev)
    ody = torch.from_numpy(offs[:, 1]).to(dev)
    gi = ci.to(torch.int32)[:, None] + odx[None, :]  # (N, M)
    gj = cj.to(torch.int32)[:, None] + ody[None, :]
    inb = (gi >= 0) & (gi < W) & (gj >= 0) & (gj < H)
    gic = gi.clamp(0, W - 1)
    gjc = gj.clamp(0, H - 1)
    val, vok = fetch_masked(nan_plane(grid), gjc, gic, W)
    ok = inb & vok

    half = 0.5 if convention == "reference" else 0.0
    di = (gi.to(x.dtype) + half) - x[:, None]
    dj = (gj.to(y.dtype) + half) - y[:, None]
    d2 = di * di + dj * dj
    top, idx = topk_stable(d2, ok, k)
    slot_ok = torch.isfinite(top)
    return {
        "val": torch.gather(val, 1, idx),
        "ii": torch.gather(gic, 1, idx).to(torch.int32),
        "jj": torch.gather(gjc, 1, idx).to(torch.int32),
        "d2": top,
        "found": slot_ok.sum(dim=1).to(torch.int32),
        "slot_ok": slot_ok,
    }


def masked_mean(val: torch.Tensor, slot_ok: torch.Tensor):
    """Mean of the selected candidates; NaN when none (fallbackAverage
    semantics generalized to k slots)."""
    cnt = slot_ok.sum(dim=1)
    s = torch.where(slot_ok, val, torch.zeros_like(val)).sum(dim=1)
    return torch.where(cnt > 0, s / cnt.clamp(min=1), torch.full_like(s, float("nan")))
