"""Wrappers of the transposed-row selection kernels B5, B6 and B11
(counterpart of :mod:`auvtpu.pallas.valid_select`).

B5 writes lanes-major rows [cnt, k vals, (k d2), k codes, (resolved)]; B6
folds the power-2 IDW sums and their quotient into the selection and writes
[value, (resolved)], where the JAX package runs an XLA epilogue after its
kernel; B11 is B5's top-4 with the 5x6 ordinary-kriging solve and its
fallbacks fused in, where the JAX package runs the XLA row epilogue after
B5, and writes [prediction, (resolved)].  B6 and B11 compute the query
prologue in the kernel.  All three are kernels of
:mod:`auvtpu_torch.kernels.scattered_select` (``csrc/scattered_select.cu``):

- :func:`valid_select_t` (``valid_select_t``): the select dict over the
  16-tap valid pack, through B5;
- :func:`kriging_valid_t` (``pallas_kriging_valid``): kriging on FULLY VALID
  grids from the 16-tap pack (containment proof in
  :func:`auvtpu_torch.ops.packs.packed_kriging_valid`), through B11;
- :func:`packed_kriging_t` / :func:`packed_idw_t` (``pallas_packed_*_t``):
  kriging (B11) / IDW (B6) over the full radius-R window pack, any grid,
  optionally with the two-tier "resolved" row (``resolve_thresh``).

Each goes through its kernel's custom op (``auvtpu_torch::valid_select``,
``::select_krige``, ``::idw_select``: :mod:`.library`), which on a CPU pack
runs the kernel's plain version.
"""

from __future__ import annotations

import torch

from ..grid import RegularGrid
from ..ops.packs import VALID16_OFFSETS, pack_width
from ..utils.profiling import spanned
from .scattered_select import _window, idw_select, prologue, select, select_krige, table

_VALID16 = tuple(VALID16_OFFSETS)


def _select_rows(pack, P, offs, R, grid, lons, lats, *, emit_d2, k=4, half=0.5, resolve_thresh=None):
    """B5: (1+2k(+k)(+1), N) rows [cnt, k vals, (k d2,) k codes, (resolved)]
    and the query geometry."""
    x, y, oob, ci, cj, cell, fx, fy = prologue(grid, lons, lats)
    out = select(
        pack, P, cell, fx, fy, table(offs, P, R, "dy", grid.device), mode="rows_t", k=k,
        emit_d2=emit_d2, half=half, resolve_thresh=resolve_thresh,
    )
    return out, x, y, oob, ci, cj


def valid_select_t(pack16, grid: RegularGrid, lons, lats):
    """The valid16 top-4 through B5, as the select dict of
    ``ops.packs.select_from_stencil`` over ``VALID16_OFFSETS``."""
    R, B = 2, 6
    out, x, y, oob, ci, cj = _select_rows(pack16, 16, VALID16_OFFSETS, R, grid, lons, lats, emit_d2=True)
    found = out[0].to(torch.int32)
    code = torch.clamp(out[9:13].T, min=0.0)
    sdy = torch.floor(code / B) - R
    sdx = code - (sdy + R) * B - R
    return {
        "x": x, "y": y, "oob": oob, "ci": ci, "cj": cj,
        "val": out[1:5].T, "d2": out[5:9].T,
        "slot_ok": torch.arange(4, device=out.device)[None, :] < found[:, None],
        "found": found, "dy": sdy, "dx": sdx,
    }


@spanned
def kriging_valid_t(pack16, grid: RegularGrid, lons, lats, *, vparams=None, model: str = "exponential"):
    """Kriging on a FULLY VALID grid (reference convention) with the valid16
    selection and the solve in B11 (``pallas_kriging_valid``)."""
    return select_krige(pack16, 16, _VALID16, 2, grid, lons, lats, vparams=vparams, model=model)[0]


def packed_kriging_t(pack, grid: RegularGrid, lons, lats, *, window_radius: int = 2, vparams=None, model: str = "exponential", convention: str = "reference", resolve_thresh=None):
    """Kriging over the full radius-R window pack with the selection and the
    solve in B11: correct on masked grids and at edges
    (``pallas_packed_kriging_t``).  With ``resolve_thresh`` also returns the
    two-tier resolved mask and the number of unresolved queries (a 0-d
    tensor)."""
    offs = _window(window_radius)
    out = select_krige(
        pack, pack_width(len(offs)), offs, window_radius, grid, lons, lats, convention=convention,
        vparams=vparams, model=model, resolve_thresh=resolve_thresh,
    )
    if resolve_thresh is None:
        return out[0]
    # no oob term: an out-of-bounds query resolves through its clipped
    # centre, as the torch path's resolved mask does (both tiers give NaN)
    resolved = out[1] > 0.5
    return out[0], resolved, (~resolved).sum()


@spanned
def packed_idw_t(pack, grid: RegularGrid, lons, lats, *, k: int = 8, window_radius: int = 2, convention: str = "reference", resolve_thresh=None):
    """k-nearest IDW with power 2 (w = 1/(d2+eps)) over the full radius-R
    window pack, the query prologue, the selection, the weighted sums and
    their quotient in B6 (``pallas_packed_idw_t``); other powers take the
    torch packed path.  ``resolve_thresh`` as for :func:`packed_kriging_t`."""
    offs = _window(window_radius)
    out = idw_select(pack, pack_width(len(offs)), offs, window_radius, grid, lons, lats, k=k, convention=convention,
                     resolve_thresh=resolve_thresh)
    if resolve_thresh is None:
        return out[0]
    resolved = out[1] > 0.5
    return out[0], resolved, (~resolved).sum()
