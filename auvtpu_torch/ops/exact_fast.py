"""Two-tier exact mode: a dense whole-plane exact selection, with rare
boundary ties escalated to the strict selection (counterpart of
:mod:`auvtpu.ops.exact_fast`).

:mod:`.exact` reproduces the reference's observable selection
(ring-segment cutoff and swap tie-breaks, GridH.cpp:49-140) with an
(N, 441)-lane gather per query.  This module computes the SAME selection as
one pass over the whole plane, as :mod:`.dense` does for the v2 fills: the
441 candidate offsets in exact reference *collection order* as shifted
views of the padded validity plane, keeping per cell

  - a running top-5 by the exact key (d2_static asc, T desc), the key that
    :mod:`.exact` proves equivalent to the reference's f64 ordering; the
    fifth slot holds the key of the best REJECTED candidate;
  - the eligible-candidate count and a ``stopped`` flag that implements the
    segment cutoff (count >= 4 checked at segment-end lanes,
    GridH.cpp:82,115), which also ends the loop once every cell of the
    plane has stopped (one host read a chunk of 9 lanes);
  - a ``tie`` flag at the end: key(4th) == key(5th) exactly, the only case
    where the reference's swap-mutated position order changes the selected
    SET.  Those cells ESCALATE to the strict selection.

Ties strictly inside the top four do not escalate: the selected set is the
same and the kriging system is symmetric under a permutation of the
neighbours, so slot order moves only the f64 round-off of the solve.

The kriging solve is f64 and takes its variogram values from two small host
f64 tables over the selection lattice (41x41 pairwise, 21x21 query): every
distance of a cell-aligned query is a lattice quantity, so the solve needs
no exp or sqrt.  The table ignores the ~1e-12 coordinate residue inside
gamma (~1e-9 m); the residue still decides the selection through T.

On the card the dense pass, its extraction and the table solve are one
launch of B13 (:mod:`auvtpu_torch.kernels.exact_select`, one thread per
query cell: the planes are only ever read there; where every query is
aligned no residue plane is made), and the escalated cells one launch of
B14 with the same solve.  The queries are prepared on the device by B16
(``ops.exact.query_tensors``: keys, the aligned mask, the clipped cells),
the escalation mask and its indices are device tensors, and the host reads
back three things: B16's counts (an inexact key raises; a query not
aligned sends the launch to the residue planes), the escalated count, and
the (N,) predictions.  The torch
functions here (:func:`_dense_select`, :func:`_extract_q`,
:func:`_solve_table`) are the kernels' plain versions, which the CPU runs.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..config import KrigingConfig
from ..grid import RegularGrid, device_cache
from ..kernels.exact_epilogue import fallback_mean, krige, sum4
from ..kernels.exact_prologue import ALIGNED, FLAT, GEO, GRID, KEYS
from .exact import (
    _F64,
    _cell_keys,
    _checked,
    _device_tables,
    _result,
    _select_cells,
    _where,
    exact_tables,
    query_tensors,
)
from .scattered import gj56

_CHUNK = 9  # lanes between early-exit checks (centre + ring 1)


@lru_cache(maxsize=8)
def _collection_tables(max_radius: int = 10):
    """Per-lane scalars in exact collection order, chunk-padded.

    dx, dy   int32 offsets;
    d2       f32 variant-0 static squared distance ((dx+0.5)^2 + (dy+0.5)^2);
    cfx, cfy f32 variant-0 T-key coefficients (2 dx + 1, 2 dy + 1);
    seg_end  f32 1.0 at the last lane of each segment (cutoff checkpoints);
    live     f32 0.0 on tail padding.
    """
    tb = exact_tables(max_radius)
    dx = tb["dx"]
    dy = tb["dy"]
    m = len(dx)
    prev_end = tb["prev_end"]
    # last lane of segment s = prev_end of the first lane of segment s+1;
    # the final segment ends at the final lane
    seg_end = np.zeros(m, np.float32)
    seg_end[prev_end[prev_end >= 0]] = 1.0
    seg_end[m - 1] = 1.0

    n_chunks = -(-m // _CHUNK)
    pad = n_chunks * _CHUNK - m

    def padi(a, fill=0):
        return np.concatenate([a, np.full(pad, fill, a.dtype)])

    return dict(
        dx=padi(dx),
        dy=padi(dy),
        d2=padi(tb["d2"][0], np.float32(np.inf)),
        cfx=padi(tb["cfx"][0]),
        cfy=padi(tb["cfy"][0]),
        seg_end=padi(seg_end),
        live=padi(np.ones(m, np.float32)),
        n_chunks=n_chunks,
    )


def _dense_select(valid, flat, exq, eyq, *, max_radius: int):
    """Whole-plane exact selection for the kriging round anchor (variant 0,
    which the f64 round-trip never shifts for a cell-aligned query).

    ``flat``/``exq``/``eyq`` are the (P,) aligned query cells and their
    scaled residues, scattered into residue planes (duplicated cells carry
    equal residues).  ``stopped`` covers every cell of the plane.

    Returns planes: count (i32), tie (bool: the 4th and 5th best keys are
    exactly equal), ln (4, H, W) i32 lane index in collection order, -1 on
    an empty slot.  Slot order is the reference's selection-pass order (d2
    asc, T desc); equal-key runs inside the top four sit in collection
    order.
    """
    tb = _collection_tables(max_radius)
    H, W = valid.shape
    R = max_radius
    ex = torch.zeros(H * W, dtype=torch.float32, device=valid.device)
    ey = torch.zeros_like(ex)
    ex[flat] = exq
    ey[flat] = eyq
    ex, ey = ex.view(H, W), ey.view(H, W)
    pv = F.pad(valid, (R,) * 4)

    count = torch.zeros((H, W), dtype=torch.int32, device=valid.device)
    stopped = torch.zeros((H, W), dtype=torch.bool, device=valid.device)
    d2 = torch.full((5, H, W), torch.inf, dtype=torch.float32, device=valid.device)
    T = torch.zeros_like(d2)
    ln = torch.full((5, H, W), -1, dtype=torch.int32, device=valid.device)
    above = torch.zeros((1, H, W), dtype=torch.bool, device=valid.device)
    for c in range(tb["n_chunks"]):
        if c > 0 and bool(stopped.all()):
            break
        for j in range(c * _CHUNK, (c + 1) * _CHUNK):
            if tb["live"][j] == 0.0:
                continue  # tail padding
            dy, dx = int(tb["dy"][j]), int(tb["dx"][j])
            d2_s = float(tb["d2"][j])
            cand = (pv[R + dy:R + dy + H, R + dx:R + dx + W] > 0.5) & ~stopped
            t = ex * float(tb["cfx"][j]) + ey * float(tb["cfy"][j])  # exact in f32
            # lexicographic (d2 asc, T desc) against each slot, monotone in
            # the slot (slots stay sorted); strict, so an equal key files
            # below the earlier candidate (collection order within ties)
            lt = cand & ((d2_s < d2) | ((d2_s == d2) & (t > T)))
            shift = torch.cat([above, lt[:-1]])  # inserted above this slot: take the slot above's entry
            ins = lt & ~shift
            d2 = torch.where(ins, d2_s, torch.where(shift, d2.roll(1, 0), d2))
            T = torch.where(ins, t, torch.where(shift, T.roll(1, 0), T))
            ln = torch.where(ins, j, torch.where(shift, ln.roll(1, 0), ln))
            count = count + cand.int()
            if tb["seg_end"][j] > 0.5:
                stopped = stopped | (count >= 4)
    # boundary tie: the 4th and 5th best keys exactly equal; isfinite guards
    # the <5-candidate case (two INF slots compare equal)
    tie = (d2[3] == d2[4]) & (T[3] == T[4]) & torch.isfinite(d2[4])
    return count, tie, ln[:4]


def _extract_q(count_p, tie_p, ln_p, elev, flat, *, max_radius: int):
    """The dense planes at the (P,) query cells ``flat``, lanes turned into
    neighbour offsets and values: found (P,), tie (P,), vals (4, P) in the
    elevation's dtype, dgi/dgj (4, P) int64 offsets from the query cell
    (zero on unfilled slots)."""
    tb = _device_tables(max_radius, elev.device)
    H, W = elev.shape
    found = count_p.reshape(-1)[flat]
    tie = tie_p.reshape(-1)[flat]
    lnq = ln_p.reshape(4, -1)[:, flat]
    filled = torch.arange(4, device=elev.device)[:, None] < found.clamp(max=4)[None, :]
    lnc = torch.where(filled, lnq, 0).long()
    dgi = torch.where(filled, tb["dx"][lnc], 0)
    dgj = torch.where(filled, tb["dy"][lnc], 0)
    row = flat // W
    col = flat - row * W
    gi = (col[None, :] + dgi).clamp(0, W - 1)
    gj = (row[None, :] + dgj).clamp(0, H - 1)
    vals = torch.where(filled, elev.reshape(-1)[gj * W + gi], 0)
    return found, tie, vals, dgi, dgj


def _aligned(q, rows, cols):
    """Queries the dense pass serves: the round anchor is the query cell
    itself, variant 0, in bounds (anything else means a pathological extent
    and escalates rather than being mis-served).  B16 computes this mask
    (``aligned``); this is its plain form, on tensors or host arrays."""
    return (q.ci == cols) & (q.cj == rows) & (q.variant == 0) & ~q.oob


def _round_queries(grid: RegularGrid, rows, cols, fields: int = 0):
    """The round-anchor queries on the grid's device with what the dense
    pass needs (keys, ``aligned``, the clipped cells) and ``fields`` more,
    checked (one readback: raises where a key is not exact in f32), and the
    dense pass's operands: the aligned queries' cells (P_a,) (None where
    every query is aligned: each cell then holds its own query's keys), the
    residue keys (2, P_a), every query's cell clipped to the plane (P,)."""
    q = query_tensors(grid, rows, cols, anchor="round", fields=KEYS | ALIGNED | FLAT | fields)
    not_aligned = _checked(q)
    keys = torch.stack([q.ex_key, q.ey_key])
    if not not_aligned:
        return q, (None, keys, q.flat)
    idx = _where(q.aligned, q.flat.shape[0] - not_aligned)
    return q, (q.flat[idx], keys[:, idx], q.flat)


def _select_fast(grid: RegularGrid, q, dense_in, max_radius: int, chunk: int):
    """The two-tier selection of round-anchor queries ``q`` with the dense
    pass's operands ``dense_in`` on the grid's device: B13 (:func:`_dense_select`
    and :func:`_extract_q` on the CPU), then the escalated cells (the
    boundary ties, the queries not aligned; none out of the grid) through
    B14.  Returns tensors (found (N,), sel_val (N, 4), sel_gi, sel_gj (N, 4)
    int32, escalated (N,) bool)."""
    from ..kernels.exact_select import dense_select

    found, tie, vals, dgi, dgj = dense_select(grid, *dense_in, max_radius=max_radius)
    filled = torch.arange(4, device=grid.device)[:, None] < found.clamp(max=4)[None, :]
    # unfilled slots read as 0, the strict selection's empty-slot convention
    sel_gi = torch.where(filled, dgi + q.cols, 0).T.to(torch.int32)
    sel_gj = torch.where(filled, dgj + q.rows, 0).T.to(torch.int32)
    sel_val = vals.T.contiguous()
    esc = (tie | ~q.aligned) & ~q.oob
    n_esc = int(esc.sum().cpu())
    if n_esc:
        idx = _where(esc, n_esc)
        found[idx], sel_val[idx], sel_gi[idx], sel_gj[idx] = _select_cells(grid, q, idx, max_radius, chunk)
    return found, sel_val, sel_gi, sel_gj, esc


def exact_select_at_cells_fast(grid: RegularGrid, rows, cols, *, max_radius: int = 10, chunk: int = 16384):
    """Twin of :func:`.exact.exact_select_at_cells` for the kriging (round)
    anchor: the dense pass, boundary-tie cells escalated to the strict
    selection.  Returns numpy (found, sel_val (N,4), sel_gi, sel_gj, q,
    escalated) with the strict selection's selected SET everywhere and its
    slot order except inside exact-key ties."""
    q, dense_in = _round_queries(grid, rows, cols, GEO | GRID)
    out = _select_fast(grid, q, dense_in, max_radius, chunk)
    found, sel_val, sel_gi, sel_gj, esc = (t.cpu().numpy() for t in out)
    return found, sel_val, sel_gi, sel_gj, q.host(), esc


# ---------------------------------------------------------------------------
# lattice-gamma f64 solve (no per-point exp/sqrt)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def _gamma_tables(lon_step: float, lat_step: float, vg: tuple, model: str, max_radius: int = 10):
    """Host f64 variogram tables over the selection lattice.

    gpair[dj + 2R, di + 2R] = gamma(hypot(di*lon_step, dj*lat_step))
      for neighbour-pair offsets (both neighbours carry the +0.5 cell-centre
      shift, which cancels in the difference);
    gq[dy + R, dx + R]      = gamma(hypot((dx+0.5)*lon_step, (dy+0.5)*lat_step))
      for query->neighbour offsets (GridH.cpp:364-367 half-cell convention).
    """
    r = max_radius
    if model == "exponential":
        nugget, sill, rng = vg
        vf = lambda h: nugget + sill * (1.0 - np.exp(-h / rng))
    else:
        from ..variogram import variogram_model

        vf = lambda h: variogram_model(torch.as_tensor(h, dtype=_F64), vg, model).numpy()
    di = np.arange(-2 * r, 2 * r + 1, dtype=np.float64)
    gpair = vf(np.hypot(di[None, :] * lon_step, di[:, None] * lat_step))
    dq = np.arange(-r, r + 1, dtype=np.float64) + 0.5
    gq = vf(np.hypot(dq[None, :] * lon_step, dq[:, None] * lat_step))
    return np.asarray(gpair, np.float64), np.asarray(gq, np.float64)


def _reference_tables(grid: RegularGrid, max_radius: int):
    """:func:`_gamma_tables` of the reference's variogram at the grid's
    steps, on the grid's device (uploaded once a grid geometry)."""
    return _device_reference_tables(grid.lon_step, grid.lat_step, max_radius, grid.device)


@device_cache(maxsize=8)
def _device_reference_tables(lon_step: float, lat_step: float, max_radius: int, device: torch.device):
    v = KrigingConfig().variogram
    tabs = _gamma_tables(lon_step, lat_step, (v.nugget, v.sill, v.range), "exponential", max_radius)
    return tuple(torch.as_tensor(t).to(device) for t in tabs)


def _krige_rows_table(vals, dgi, dgj, gpair, gq, max_radius: int):
    """f64 kriging solve from the lattice-gamma tables (f64 tensors on the
    device), operands transposed: vals/dgi/dgj (4, P) neighbour values and
    offsets from the query cell.  The 5x6 system from 6 pairwise and 4
    query gamma gathers, then the shared unpivoted Gauss-Jordan."""
    r = max_radius
    wp = 4 * r + 1
    wq = 2 * r + 1
    gp = gpair.reshape(-1)
    gqf = gq.reshape(-1)
    one = torch.ones(vals.shape[1], dtype=_F64, device=vals.device)
    zero = torch.zeros_like(one)
    g0 = gpair[2 * r, 2 * r] * one  # gamma(0) diagonal

    M = [[None] * 6 for _ in range(5)]
    for a in range(4):
        for b in range(4):
            if b < a:
                M[a][b] = M[b][a]
            elif b == a:
                M[a][b] = g0
            else:
                M[a][b] = gp[(dgj[a] - dgj[b] + 2 * r) * wp + (dgi[a] - dgi[b] + 2 * r)]
        M[a][4] = one
        M[a][5] = gqf[(dgj[a] + r) * wq + (dgi[a] + r)]
    M[4] = [one, one, one, one, zero, one]

    M, singular = gj56(M, KrigingConfig().pivot_tol)
    pred = sum(M[a][5] * vals[a] for a in range(4))
    return pred, singular


def _solve_table(found, vals, dgi, dgj, gpair, gq, max_radius: int):
    """The table solve of (4, P) selections, the 4-neighbour mean where it
    is singular and the fallback mean where fewer than 4 were found."""
    vals64 = vals.to(_F64)
    pred, singular = _krige_rows_table(vals64, dgi, dgj, gpair, gq, max_radius)
    solved = torch.where(singular, sum4(vals64.T) / 4.0, pred)
    return torch.where(found >= 4, solved, fallback_mean(found, vals.T))


def exact_kriging_at_cells_fast(
    grid: RegularGrid,
    rows,
    cols,
    *,
    max_radius: int = 10,
    chunk: int = 65536,
    solve: str = "table",
):
    """Two-tier exact ordinary kriging at cell-aligned queries, in f64.

    Selection: the dense pass, boundary ties escalated to the strict
    selection (the selected set of :mod:`.exact` everywhere).  Solve:
    ``solve='table'`` (default) the lattice-gamma tables in one pass over
    the device's arrays (value drift against the coordinate-form solve
    ~1e-9 m); ``solve='coords'`` the coordinate-form solve of
    :func:`.exact.exact_kriging_at_cells`.  Returns (N,) numpy f64.
    """
    if solve == "coords":
        return _exact_kriging_coords(grid, rows, cols, max_radius=max_radius, chunk=chunk)
    if solve != "table":
        raise ValueError(solve)
    from ..kernels.exact_select import dense_krige, ring_krige

    q, dense_in = _round_queries(grid, rows, cols)
    gpair, gq = _reference_tables(grid, max_radius)
    out, tie = dense_krige(grid, *dense_in, gpair, gq, max_radius=max_radius)
    esc = (tie | ~q.aligned) & ~q.oob
    n_esc = int(esc.sum().cpu())
    if n_esc:
        idx = _where(esc, n_esc)
        out[idx] = ring_krige(grid, *_cell_keys(grid, q, idx), q.cols[idx].long(), q.rows[idx].long(), gpair, gq,
                              max_radius=max_radius, chunk=chunk)
    return _result(out, q.oob)


def _exact_kriging_coords(grid: RegularGrid, rows, cols, *, max_radius: int, chunk: int):
    """The coordinate-form f64 solve of :func:`.exact.exact_kriging_at_cells`
    on the two-tier selection (parity diagnostics)."""
    q, dense_in = _round_queries(grid, rows, cols, GEO)
    found, sel_val, sel_gi, sel_gj, _ = _select_fast(grid, q, dense_in, max_radius, chunk)
    return _result(krige(grid, found, sel_val, sel_gi, sel_gj, q.qlon, q.qlat), q.oob)
