"""Exact-reference neighbour selection (``--selection exact``): counterpart
of :mod:`auvtpu.ops.exact`.

The v2 ops (:mod:`.dense`, :mod:`.window`) select the true k nearest cells.
The reference's observable selection differs in two ways that the published
Grid B error tables depend on (docs/SEMANTICS.md):

1. **Ring-segment cutoff** (GridH.cpp:49-116): candidates are collected in
   ring order and collection stops at the end of the first *segment* (a
   ring's top/bottom edge pass or its left/right edge pass) where >= 4 valid
   candidates are held.
2. **Selection sort with swaps** (GridH.cpp:123-140): 4 passes of
   first-minimum selection over f64 distances, *swapping* the displaced
   element into the minimum's slot, which reorders equal-distance
   candidates.

Both are reproduced exactly.  For cell-aligned queries (Grid B: the masked
cells themselves) the harness's f64 index -> geo -> grid round-trip leaves a
residue ``eps = x - anchor`` of ~1e-12 that breaks distance ties.  For a
candidate at offset (dx, dy) from an integer anchor the exact squared
distance is ``d2_static - u*T + (eps_x^2 + eps_y^2)`` with

    d2_static = (dx+ax+0.5)^2 + (dy+ay+0.5)^2,
    T = eps_x*(2(dx+ax)+1) + eps_y*(2(dy+ay)+1),

so the keys are (d2_static ascending, T descending, compacted position
ascending): a static f32 table, an f32 T that is exact by construction (eps
scaled by 2^41 keeps every product and sum under 24 significand bits;
:func:`prepare_exact_queries` refuses a residue that is not) and an integer
position plane that the 4 swap passes mutate.  Arbitrary (Grid A) queries
have no such decomposition: their keys are the reference's own f64
``sqrt(di*di + dj*dj)``, computed here op for op as separate tensor ops (no
``hypot``, no fused multiply-add), because the reference resolves f64
rounding merges of distinct distances by position.

Precision: torch has no global x64 switch, and none is needed.  Distances,
the 5x6 kriging solve, the Catmull-Rom and bilinear arithmetic and the
fallback means run in ``torch.float64`` always (the JAX package under
``jax_enable_x64``, which both of its CLIs switch on for exact mode), on the
grid's device, so the JAX package's ``_require_x64`` check has no
counterpart and its f32 variant of exact mode is not ported; an f32 solve
would shift regional MAE by ~2e-3 m, above the published tables' 5e-5.

Query preparation runs on the grid's device: the float64 round-trip, the
anchors, the residue keys and the checks are B16
(:mod:`auvtpu_torch.kernels.exact_prologue`, one thread a query; its plain
torch version on the CPU), bit for bit the JAX package's host numpy.  The
entry points take the queries as numpy (uploaded once) or as tensors on the
grid's device (taken as they are), keep every step between on the device,
and read back the inexact-key count (they raise before any result where a
key is not exact in f32), an escalated or fallback count where the path has
one, and the (N,) float64 result, which they return as numpy as the JAX
functions do.  :func:`prepare_exact_queries` and :func:`_prepare_scattered`
are host views of the device form (one readback a field).

On the card the strict selection (both key families) is one launch of B14
(:mod:`auvtpu_torch.kernels.exact_select`, one thread per query); the
(N, M) torch functions here (:func:`_select_chunk`,
:func:`_select_chunk_scattered`, :func:`_swap_passes`) are its plain
version, which the CPU runs in chunks.  The epilogues are one launch each
(:mod:`auvtpu_torch.kernels.exact_epilogue`, one thread a query; their
plain torch versions on the CPU): the coordinate-form f64 kriging solve
with its fallbacks (B17) and the bilinear and Catmull-Rom patch (B18), so
each entry point is B16, its selection and one epilogue launch (scattered
cubic: B16, B18, the strict selection of the queries whose patch is not
all valid, and B17's fallback mean written into the output).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from ..grid import RegularGrid
from ..kernels.exact_epilogue import krige, krige_mean_into, patch
from ..kernels.exact_prologue import ALIGNED, FLAT, GEO, GRID, KEYS
from ..tables import ring_offsets

# eps scale: a power of two, so scaling is exact; chosen so |eps|*SCALE stays
# in a few-bit f32 range (|eps| <~ 2.5e-12 => scaled <~ 5.5)
EPS_SCALE = float(2**41)
_BIG = 1 << 20  # position of a lane that is not (or no longer) a candidate
_F64 = torch.float64


@lru_cache(maxsize=8)
def exact_tables(max_radius: int = 10):
    """Static per-lane tables in exact reference collection order.

    Returns numpy arrays (M = (2R+1)^2 lanes):
      dx, dy       (M,)  int32 offsets (collection order, ring_offsets);
      prev_end     (M,)  int32 lane index of the last lane of the *previous*
                         segment (-1 for segment 0): the cutoff test
                         ``count >= 4`` happens at segment ends (GridH.cpp:82,115);
      d2           (4,M) f32 static squared distance per anchor variant;
      cfx, cfy     (4,M) f32 first-order tie coefficients per variant.

    Anchor variants encode the f64 floor-anchoring of the query: variant
    v = 2*ex_int + ey_int where ex_int = round(x - anchor_x) in {0, 1}
    (1 when eps < 0 pushed floor(x) one cell left/down).
    """
    offs, seg_id = ring_offsets(max_radius)
    dx = offs[:, 0].astype(np.int64)
    dy = offs[:, 1].astype(np.int64)
    m = len(offs)
    nseg = int(seg_id[-1]) + 1
    seg_end = np.searchsorted(seg_id, np.arange(nseg), side="right") - 1
    prev_end = np.where(seg_id > 0, seg_end[np.maximum(seg_id - 1, 0)], -1)

    d2 = np.empty((4, m), np.float32)
    cfx = np.empty((4, m), np.float32)
    cfy = np.empty((4, m), np.float32)
    for v in range(4):
        ax = -(v >> 1)  # 0 or -1
        ay = -(v & 1)
        ddx = dx + ax + 0.5
        ddy = dy + ay + 0.5
        d2[v] = (ddx * ddx + ddy * ddy).astype(np.float32)  # quarter-integers: f32-exact
        cfx[v] = (2 * (dx + ax) + 1).astype(np.float32)
        cfy[v] = (2 * (dy + ay) + 1).astype(np.float32)
    return dict(
        dx=dx.astype(np.int32),
        dy=dy.astype(np.int32),
        prev_end=prev_end.astype(np.int32),
        d2=d2,
        cfx=cfx,
        cfy=cfy,
    )


@lru_cache(maxsize=16)
def _device_tables(max_radius: int, device: torch.device):
    """:func:`exact_tables` as tensors on ``device`` (offsets and the
    previous segment's last lane, clamped at 0, as int64 indices)."""
    tb = exact_tables(max_radius)
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return dict(
        dx=as_t(tb["dx"], torch.int64),
        dy=as_t(tb["dy"], torch.int64),
        prev_end=as_t(np.maximum(tb["prev_end"], 0), torch.int64),
        first_seg=as_t(tb["prev_end"] < 0, torch.bool),
        d2=as_t(tb["d2"], torch.float32),
        cfx=as_t(tb["cfx"], torch.float32),
        cfy=as_t(tb["cfy"], torch.float32),
    )


@dataclasses.dataclass(frozen=True)
class ExactQueries:
    """Exact cell-aligned query features on the host (all numpy): the host
    view of :class:`QueryTensors` that :func:`prepare_exact_queries`
    returns."""

    ci: np.ndarray  # (N,) int32 anchor column
    cj: np.ndarray  # (N,) int32 anchor row
    variant: np.ndarray  # (N,) int32 in 0..3
    ex_key: np.ndarray  # (N,) f32 eps_x * EPS_SCALE (exact)
    ey_key: np.ndarray  # (N,) f32
    qlon: np.ndarray  # (N,) f64 raw query lon (reference round-trip)
    qlat: np.ndarray  # (N,) f64
    x: np.ndarray  # (N,) f64 grid coords
    y: np.ndarray  # (N,) f64
    oob: np.ndarray  # (N,) bool


@dataclasses.dataclass(frozen=True)
class QueryTensors:
    """Exact-mode query features on the grid's device, as B16 writes them
    (:func:`query_tensors`, :func:`scattered_tensors`): the fields of
    :class:`ExactQueries` that the caller asked for (None for the others),
    the anchors as int64 (the selections' index type), and ``counts``, (2,)
    int32 on the device: the queries whose keys are not exact in f32, and
    with ``aligned`` the queries the dense pass does not serve.  ``cols``
    and ``rows`` (cell form) are the queries themselves on the device;
    ``qlon``/``qlat`` of the scattered form are its coordinates."""

    ci: torch.Tensor
    cj: torch.Tensor
    oob: torch.Tensor
    counts: torch.Tensor
    variant: torch.Tensor | None = None
    ex_key: torch.Tensor | None = None
    ey_key: torch.Tensor | None = None
    qlon: torch.Tensor | None = None
    qlat: torch.Tensor | None = None
    x: torch.Tensor | None = None
    y: torch.Tensor | None = None
    aligned: torch.Tensor | None = None  # the dense pass serves the query (round anchor)
    flat: torch.Tensor | None = None  # row * W + col, clipped to the plane
    cols: torch.Tensor | None = None
    rows: torch.Tensor | None = None

    def host(self) -> ExactQueries:
        """The host view, one readback a field (every field of
        :class:`ExactQueries` must have been asked for)."""
        np_ = lambda t, dt=None: (t if dt is None else t.to(dt)).cpu().numpy()
        return ExactQueries(ci=np_(self.ci, torch.int32), cj=np_(self.cj, torch.int32), variant=np_(self.variant),
                            ex_key=np_(self.ex_key), ey_key=np_(self.ey_key), qlon=np_(self.qlon),
                            qlat=np_(self.qlat), x=np_(self.x), y=np_(self.y), oob=np_(self.oob))


def _index_tensor(grid: RegularGrid, a) -> torch.Tensor:
    """Query rows or columns as an (N,) tensor on the grid's device: an
    int32 or int64 tensor there as it is, anything else as int64."""
    if torch.is_tensor(a):
        a = a.reshape(-1).to(grid.device)
        return a if a.dtype in (torch.int32, torch.int64) else a.long()
    return torch.as_tensor(np.asarray(a, np.int64).reshape(-1)).to(grid.device)


def _coord_tensor(grid: RegularGrid, a) -> torch.Tensor:
    """Query coordinates as an (N,) float64 tensor on the grid's device."""
    if torch.is_tensor(a):
        return a.reshape(-1).to(grid.device, _F64)
    return torch.as_tensor(np.asarray(a, np.float64).reshape(-1)).to(grid.device)


def query_tensors(grid: RegularGrid, rows, cols, *, anchor: str = "round",
                  fields: int = KEYS | GEO | GRID) -> QueryTensors:
    """Reproduce the reference harness's index->geo->grid-coord round-trip in
    f64 (gridIndexToGeo, test_gebco.cpp:72-81 + GridH.cpp:166-167) and split
    each coordinate into (integer anchor, exact scaled residue), on the
    grid's device (B16; its plain version on the CPU).  ``anchor`` 'round'
    is the kriging centre (half away from zero, clamped; GridH.cpp:333-336),
    'floor' the bilinear/bicubic cell (GridH.cpp:170-173, 231-234);
    ``fields`` (``kernels.exact_prologue`` KEYS, GEO, GRID, ALIGNED, FLAT)
    what to compute beyond the anchors and the out-of-grid flag.  The keys'
    check is counted, not raised: :func:`_checked` reads it."""
    from ..kernels.exact_prologue import prologue

    if anchor not in ("round", "floor"):
        raise ValueError(anchor)
    r, c = _index_tensor(grid, rows), _index_tensor(grid, cols)
    if r.dtype != c.dtype:
        r, c = r.long(), c.long()
    anchors, oob, counts, keys, variant, geo, xy, aligned, flat = prologue(
        grid, c, r, round_anchor=anchor == "round", fields=fields, eps_scale=EPS_SCALE)
    opt = lambda flag, t: t if fields & flag else None
    return QueryTensors(ci=anchors[0], cj=anchors[1], oob=oob, counts=counts, variant=opt(KEYS, variant),
                        ex_key=opt(KEYS, keys[0]), ey_key=opt(KEYS, keys[1]), qlon=opt(GEO, geo[0]),
                        qlat=opt(GEO, geo[1]), x=opt(GRID, xy[0]), y=opt(GRID, xy[1]), aligned=opt(ALIGNED, aligned),
                        flat=opt(FLAT, flat), cols=c, rows=r)


def _checked(q: QueryTensors) -> int:
    """Read ``q``'s counts back (one readback); raise where a key is not
    exact in f32 (it would silently mis-order ties); return the count of
    queries not aligned."""
    inexact, not_aligned = q.counts.cpu().tolist()
    if inexact:
        raise ValueError("coordinate residue not exactly representable in f32 keys")
    return not_aligned


def prepare_exact_queries(grid: RegularGrid, rows, cols, *, anchor: str = "round") -> ExactQueries:
    """:func:`query_tensors` with every field, checked, as host numpy: the
    JAX package's function, bit for bit."""
    q = query_tensors(grid, rows, cols, anchor=anchor)
    _checked(q)
    return q.host()


# ---------------------------------------------------------------------------
# the strict (N, M) selection
# ---------------------------------------------------------------------------

def _on(grid: RegularGrid, a, dtype=None):
    """A host array (or tensor) as a tensor on the grid's device."""
    return torch.as_tensor(a, dtype=dtype).to(grid.device)


def _chunked(fn, n: int, chunk: int, *arrays):
    """``fn`` over row chunks of the (N, ...) tensors ``arrays``, each output
    concatenated: the chunk bounds the (chunk, M) temporaries' memory.  No
    rows is one empty chunk."""
    outs = [fn(*(a[s:s + chunk] for a in arrays)) for s in range(0, max(n, 1), chunk)]
    return [torch.cat(parts) for parts in zip(*outs)]


def _candidates(grid: RegularGrid, tb, ci, cj):
    """Lanes of (N,) anchors: (gi, gj, val, eligible, cum) over the (N, M)
    lanes, ``eligible`` the candidates of the segments that started before 4
    were held, ``cum`` the running candidate count."""
    H, W = grid.shape
    gi = ci.long()[:, None] + tb["dx"]
    gj = cj.long()[:, None] + tb["dy"]
    inb = (gi >= 0) & (gi < W) & (gj >= 0) & (gj < H)
    flat = gj.clamp(0, H - 1) * W + gi.clamp(0, W - 1)
    val = grid.elev.reshape(-1)[flat]
    cand = inb & (grid.valid.reshape(-1)[flat] > 0.5)
    cum = torch.cumsum(cand, dim=1, dtype=torch.int32)
    cum_prev = torch.where(tb["first_seg"], 0, cum[:, tb["prev_end"]])
    return gi, gj, val, cand & (cum_prev < 4), cum


def _swap_passes(gi, gj, val, eligible, cum, pick):
    """The reference's 4 selection passes with swaps (GridH.cpp:123-140) over
    compacted positions: ``pick(active)`` gives each row's candidate lanes
    of the pass (the minimum key among ``active``), the lowest position
    among them wins, and the lane at position m moves to the winner's.
    Returns (found (N,) int32, sel_val (N, 4), sel_gi (N, 4) int32,
    sel_gj)."""
    found = eligible.sum(dim=1, dtype=torch.int32)
    pos = torch.where(eligible, cum - 1, _BIG)
    sel_val, sel_gi, sel_gj = [], [], []
    for m in range(4):
        best = pick(eligible & (pos >= m))
        kpos = torch.where(best, pos, _BIG).amin(dim=1, keepdim=True)  # position of the pass-m pick
        sel = eligible & (pos == kpos) & (kpos < _BIG)
        sel_val.append(torch.where(sel, val, 0).sum(dim=1, dtype=val.dtype))
        sel_gi.append(torch.where(sel, gi, 0).sum(dim=1))
        sel_gj.append(torch.where(sel, gj, 0).sum(dim=1))
        # swap: the lane at position m moves to kpos; the picked lane takes m
        pos = torch.where(eligible & (pos == m), kpos, torch.where(sel, m, pos))
    ints = lambda xs: torch.stack(xs, dim=1).to(torch.int32)
    return found, torch.stack(sel_val, dim=1), ints(sel_gi), ints(sel_gj)


def _select_chunk(grid: RegularGrid, tb, ci, cj, variant, ex_key, ey_key):
    """Exact cell-aligned selection for one chunk of (N,) queries: keys
    (static d2 ascending, T descending), then position."""
    gi, gj, val, eligible, cum = _candidates(grid, tb, ci, cj)
    v = variant.long()
    d2 = tb["d2"][v]  # (N, M)
    tkey = ex_key[:, None] * tb["cfx"][v] + ey_key[:, None] * tb["cfy"][v]  # exact in f32

    def pick(active):
        key1 = torch.where(active, d2, torch.inf)
        c1 = active & (key1 == key1.amin(dim=1, keepdim=True))
        t2 = torch.where(c1, tkey, -torch.inf)
        return c1 & (t2 == t2.amax(dim=1, keepdim=True))

    return _swap_passes(gi, gj, val, eligible, cum, pick)


def _select_cells(grid: RegularGrid, q, idx, max_radius: int, chunk: int):
    """The strict selection of queries ``q`` (:class:`QueryTensors` with
    keys, or :class:`ExactQueries`; at indices ``idx``, all if None) on the
    grid's device, through B14 (:func:`_select_chunk` in chunks of
    ``chunk`` on the CPU): (found, sel_val, sel_gi, sel_gj) tensors."""
    from ..kernels.exact_select import ring_select

    ci, cj, variant, ex, ey = _cell_keys(grid, q, idx)
    return ring_select(grid, ci, cj, ex, ey, variant, max_radius=max_radius, chunk=chunk)


def _cell_keys(grid: RegularGrid, q, idx):
    """(ci, cj int64, variant int32, ex_key, ey_key f32) of queries ``q``
    (:class:`QueryTensors` or :class:`ExactQueries`; at indices ``idx``, a
    tensor or host array, all if None) on the grid's device."""
    dts = (torch.int64, torch.int64, torch.int32, torch.float32, torch.float32)
    keys = [_on(grid, a, dt) for a, dt in zip((q.ci, q.cj, q.variant, q.ex_key, q.ey_key), dts)]
    if idx is not None:
        idx = _on(grid, idx)
        keys = [k[idx] for k in keys]
    return tuple(keys)


def _where(mask, n: int):
    """The (n,) int64 indices of ``mask``'s ``n`` true entries, on its
    device, with no synchronisation (``n`` read back before)."""
    return torch.nonzero_static(mask, size=n)[:, 0]


def _result(out, oob) -> np.ndarray:
    """(N,) predictions, NaN out of bounds, to the host as numpy f64."""
    return torch.where(oob, torch.nan, out.to(_F64)).cpu().numpy()


def exact_select_at_cells(grid: RegularGrid, rows, cols, *, max_radius: int = 10, chunk: int = 16384,
                          anchor: str = "round"):
    """Exact-reference selection at cell-aligned queries, on the grid's
    device in chunks of ``chunk`` queries.

    Returns numpy (found (N,), sel_val (N,4), sel_gi (N,4), sel_gj (N,4),
    ExactQueries).  When found < 4 the ``found`` passes selected *all*
    eligible candidates (slots >= found are zero), so the reference's
    partial-fallback mean is sel_val.sum() / found.
    """
    q = query_tensors(grid, rows, cols, anchor=anchor)
    _checked(q)
    out = _select_cells(grid, q, None, max_radius, chunk)
    return (*(t.cpu().numpy() for t in out), q.host())


# ---------------------------------------------------------------------------
# exact method ops (Grid B)
# ---------------------------------------------------------------------------

def exact_kriging_at_cells(grid: RegularGrid, rows, cols, *, max_radius: int = 10, chunk: int = 16384):
    """Ordinary kriging with exact reference selection (GridH.cpp:326-420),
    the solve in f64.  Returns (N,) numpy f64 predictions."""
    q = query_tensors(grid, rows, cols, anchor="round", fields=KEYS | GEO)
    _checked(q)
    found, sel_val, sel_gi, sel_gj = _select_cells(grid, q, None, max_radius, chunk)
    return _result(krige(grid, found, sel_val, sel_gi, sel_gj, q.qlon, q.qlat), q.oob)


def exact_cubic_at_cells(grid: RegularGrid, rows, cols, *, max_radius: int = 10, chunk: int = 16384):
    """Bicubic with exact reference fallback (GridH.cpp:223-319).

    For Grid B queries (the masked cells themselves) the floor-anchored 4x4
    Catmull-Rom patch always contains the (invalid) query cell, so the
    reference always takes the ring-fallback path: the mean of the 4
    exact-selected neighbours around the floor anchor.  Cells whose patch is
    fully valid get the f64 Catmull-Rom value instead.
    """
    q = query_tensors(grid, rows, cols, anchor="floor", fields=KEYS | GRID)
    _checked(q)
    found, sel_val, _, _ = _select_cells(grid, q, None, max_radius, chunk)
    out, _ = patch(grid, "cubic", q.ci, q.cj, q.x, q.y, at_cells=True, found=found, sel_val=sel_val, chunk=chunk)
    return _result(out, q.oob)


def exact_bilinear_at_cells(grid: RegularGrid, rows, cols):
    """Bilinear with the reference's floor anchoring (GridH.cpp:160-210), in
    f64.  The f64 eps sign decides the anchor cell (x0 = c-1 when eps < 0),
    which changes which four corners feed the valid-corner-mean fallback;
    the lerp weights round to 0/1 within ~1e-12."""
    q = query_tensors(grid, rows, cols, anchor="floor", fields=GRID)
    _checked(q)
    out, _ = patch(grid, "bilinear", q.ci, q.cj, q.x, q.y, at_cells=True)
    return _result(out, q.oob)


# ---------------------------------------------------------------------------
# exact selection for arbitrary scattered queries (Grid A)
# ---------------------------------------------------------------------------

def _select_chunk_scattered(grid: RegularGrid, tb, ci, cj, x, y):
    """Exact ring selection for arbitrary (non-cell-aligned) f64 queries,
    the Grid A regime (test_interpolation.cpp:120-160).  The keys are the
    reference's own f64 ``sqrt(di*di + dj*dj)`` (GridH.cpp:95-99), each
    operation a tensor op of its own; equal keys (exact ties, or distinct d2
    that f64 sqrt rounding merges) break by the swap-mutated position, as
    the reference's ``dist < minDist`` scan does."""
    gi, gj, val, eligible, cum = _candidates(grid, tb, ci, cj)
    di = (gi.to(_F64) + 0.5) - x[:, None]
    dj = (gj.to(_F64) + 0.5) - y[:, None]
    dist = torch.sqrt(di * di + dj * dj)  # three rounded ops, as the reference's

    def pick(active):
        key = torch.where(active, dist, torch.inf)
        return active & (key == key.amin(dim=1, keepdim=True))

    return _swap_passes(gi, gj, val, eligible, cum, pick)


def scattered_tensors(grid: RegularGrid, lons, lats, anchor: str) -> QueryTensors:
    """f64 normalization for raw scattered coordinates (golden.engine
    _normalize semantics: oob outside the extent, anchors clamped for
    'round') on the grid's device (B16, as :func:`query_tensors`): the
    anchors, oob, the grid coordinates (x, y) and the coordinates
    themselves (qlon, qlat).  A NaN coordinate's anchor is 0, as the JAX
    package's int32 anchors hold it (auvtpu/ops/exact.py:475: numpy's floor
    anchor of a NaN, -2**63, wraps to 0 there), so a NaN query's ring walk
    starts at cell 0."""
    from ..kernels.exact_prologue import prologue

    if anchor not in ("round", "floor"):
        raise ValueError(anchor)
    lo, la = _coord_tensor(grid, lons), _coord_tensor(grid, lats)
    anchors, oob, counts, _, _, _, xy, _, _ = prologue(grid, lo, la, round_anchor=anchor == "round", fields=GRID,
                                                       eps_scale=EPS_SCALE)
    return QueryTensors(ci=anchors[0], cj=anchors[1], oob=oob, counts=counts, qlon=lo, qlat=la, x=xy[0], y=xy[1])


def _prepare_scattered(grid: RegularGrid, lons, lats, anchor: str):
    """The host view of :func:`scattered_tensors`: numpy (lons, lats, x, y,
    ci int32, cj int32, oob), the JAX package's ``_prepare_scattered``,
    bit for bit."""
    q = scattered_tensors(grid, lons, lats, anchor)
    return (*(t.cpu().numpy() for t in (q.qlon, q.qlat, q.x, q.y, q.ci.int(), q.cj.int())),
            q.oob.cpu().numpy())


def _select_scattered(grid: RegularGrid, ci, cj, x, y, max_radius: int, chunk: int):
    """The strict selection of scattered queries at f64 grid coordinates
    (x, y) with anchors (ci, cj), through B14 (:func:`_select_chunk_scattered`
    in chunks of ``chunk`` on the CPU): (found, sel_val, sel_gi, sel_gj)
    tensors."""
    from ..kernels.exact_select import ring_select

    return ring_select(grid, _on(grid, ci, torch.int64), _on(grid, cj, torch.int64), _on(grid, x, _F64),
                       _on(grid, y, _F64), None, max_radius=max_radius, chunk=chunk)


def exact_kriging_scattered(grid: RegularGrid, lons, lats, *, max_radius: int = 10, chunk: int = 16384):
    """Ordinary kriging at arbitrary coordinates with exact reference
    selection (GridH.cpp:326-420 for continuous queries, the Grid A
    workload), in f64.  Returns (N,) numpy f64."""
    q = scattered_tensors(grid, lons, lats, "round")
    found, sel_val, sel_gi, sel_gj = _select_scattered(grid, q.ci, q.cj, q.x, q.y, max_radius, chunk)
    return _result(krige(grid, found, sel_val, sel_gi, sel_gj, q.qlon, q.qlat), q.oob)


def exact_cubic_scattered(grid: RegularGrid, lons, lats, *, max_radius: int = 10, chunk: int = 16384):
    """Bicubic at arbitrary coordinates: the Catmull-Rom value when the 4x4
    patch is fully valid, else the exact ring-fallback mean at the floor
    anchor (GridH.cpp:223-319).  Returns (N,) numpy f64."""
    q = scattered_tensors(grid, lons, lats, "floor")
    out, need = patch(grid, "cubic", q.ci, q.cj, q.x, q.y, at_cells=False, oob=q.oob, chunk=chunk)
    n_need = int(need.sum().cpu())
    if n_need:
        idx = _where(need, n_need)
        found, sel_val, _, _ = _select_scattered(grid, *(a[idx] for a in (q.ci, q.cj, q.x, q.y)), max_radius,
                                                 chunk)
        krige_mean_into(out, idx, found, sel_val)
    return _result(out, q.oob)


def exact_bilinear_scattered(grid: RegularGrid, lons, lats, *, chunk: int = 16384):
    """Bilinear at arbitrary coordinates in f64 (GridH.cpp:160-210).
    Returns (N,) numpy f64."""
    q = scattered_tensors(grid, lons, lats, "floor")
    out, _ = patch(grid, "bilinear", q.ci, q.cj, q.x, q.y, at_cells=False, chunk=chunk)
    return _result(out, q.oob)
