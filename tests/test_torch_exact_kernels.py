"""Exact mode's kernels B13 (the two-tier dense pass at the query cells,
with its f64 table solve) and B14 (the strict ring selection, with the
table solve of the escalated cells), through their wrappers on CPU tensors,
where each op (``auvtpu_torch::exact_dense``, ``::exact_dense_krige``,
``::exact_ring``, ``::exact_ring_krige``) runs the kernel's plain version:
held exactly to the JAX package's jitted programs (``_dense_select`` with
``_extract_q``, ``_select_chunk``, ``_select_chunk_scattered``: found, tie,
values, offsets and gi/gj equal) and within 1e-9 m of its f64 solves
(``_extract_solve_table``, the escalation's ``_krige_chunk_table``), under
x64, on float32 and float64 grids.  The queries are the held-out cells of
sparse, degenerate and awkward-extent grids, grids 20 and 45 columns wide
(a validity bit plane's rows end inside a word), a grid whose one query
holds 3 candidates before ring 10 and then a full top/bottom segment (the
strict list's 45 entries), a degenerate grid whose swap passes reorder
equal keys, queries on cells no aligned query holds and on cells one does,
duplicated cells, and cells and anchors past the grid's edges (as far as
int32 goes).  Every query aligned, B13 reads each query's own keys: equal
to the residue planes' result.  The kernels' walk and four passes written
out in Python (the bit plane, its spans in collection order, the first
four entries and the best four of the rest) equal the plain versions,
also where NaN and inf keys overflow on some lanes only.  The ops' fake
implementations give the real outputs' shapes and dtypes.  The kernels themselves are held to these plain versions bit for
bit on a card (tests/test_torch_cuda.py)."""

import contextlib
import ctypes
import inspect
import os
import re

import numpy as np
import pytest
import torch

import jax

from auvtpu.config import Extent
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import exact as jexact
from auvtpu.ops import exact_fast as jfast
from auvtpu.synthetic import shelf_seamount

from auvtpu_torch.convert import grid_from_arrays
from auvtpu_torch.kernels import exact_select as es
from auvtpu_torch.kernels import library
from auvtpu_torch.ops import exact as texact
from auvtpu_torch.ops import exact_fast as tfast
from test_torch_cuda import _ODD_KEYS, EXACT_EDGE_CASES, FULL_LIST_QUERY, _edge_plane

torch.set_num_threads(1)

AWKWARD = Extent(74.615, 84.785, -58.2508, -49.6982)  # residues break distance ties
DEGENERATE = Extent(0.0, 79.0, -32.0, 31.0)  # binary-exact steps: every distance tie exact
PRED_TOL = 1e-9  # m
R = 10

GRIDS = {
    "awkward_r0.1": (64, 80, 0.1, 2, AWKWARD),
    "awkward_r0.5": (64, 80, 0.5, 3, AWKWARD),
    "awkward_r0.9": (64, 80, 0.9, 4, AWKWARD),
    "degenerate": (48, 64, 0.3, 1, DEGENERATE),
    # many cells never hold 4 (sparse: the walk reaches ring 10); rows of
    # 20 and 45 cells start and end inside the flat bit plane's words
    # (narrow_w20, odd_w45); the swaps reorder equal keys (swapped_ties,
    # test below); one query's list reaches 45 entries (full_list)
    **EXACT_EDGE_CASES,
}
DTYPES = [np.float32, np.float64]


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


_PAIRS = {}


def pair(name, dtype):
    """(JAX grid, port CPU grid, held-out rows/cols) of one synthetic grid."""
    key = (name, dtype)
    if key not in _PAIRS:
        h, w, removal, seed, ext = GRIDS[name]
        if name in EXACT_EDGE_CASES:
            reduced, rc, _ = _edge_plane(name)
        else:
            reduced, rc, _ = mask_grid(shelf_seamount(h, w), removal, seed=seed)
        jg = JGrid.from_nan_array(reduced, ext, dtype=dtype)
        tg = grid_from_arrays(np.asarray(jg.elev), np.asarray(jg.valid), ext.min_lon, ext.max_lon,
                              ext.min_lat, ext.max_lat, "cpu")
        _PAIRS[key] = (jg, tg, rc)
    return _PAIRS[key]


def queries(tg, rc):
    """Rows and cols: the held-out cells, observed cells, held-out cells
    again, and cells past each edge."""
    H, W = tg.shape
    rows = np.concatenate([rc[:, 0], np.arange(0, H, 5), rc[:30, 0], [-1, 0, H, H + 3, 3]])
    cols = np.concatenate([rc[:, 1], (np.arange(0, H, 5) * 7) % W, rc[:30, 1], [2, -1, 5, W + 2, W]])
    return rows.astype(np.int64), cols.astype(np.int64)


def dense_operands(tg, rc):
    """B13's operands: only the first len(rc) queries (the held-out cells)
    scatter their residues, so the rest read the planes at cells no aligned
    query holds (0) or at cells one does; every query's cell is clipped to
    the plane."""
    H, W = tg.shape
    rows, cols = queries(tg, rc)
    q = texact.prepare_exact_queries(tg, rows, cols)
    aligned = tfast._aligned(q, rows, cols)
    aligned[len(rc):] = False
    flat = rows * W + cols
    keys = np.stack([q.ex_key[aligned], q.ey_key[aligned]])
    return torch.as_tensor(flat[aligned]), torch.as_tensor(keys), torch.as_tensor(np.clip(flat, 0, H * W - 1))


def jax_dense_planes(jg, flat_a, keys):
    H, W = jg.shape
    fa = jfast._pad_bucket(flat_a.numpy().astype(np.int32), H * W)
    ex = jfast._pad_bucket(keys[0].numpy(), np.float32(0.0))
    ey = jfast._pad_bucket(keys[1].numpy(), np.float32(0.0))
    return jfast._dense_select(jg.elev, jg.valid, fa, ex, ey, max_radius=R)


def jax_tables(jg):
    v = jexact.KrigingConfig().variogram
    lon_step = (jg.max_lon - jg.min_lon) / (jg.num_lon - 1)
    lat_step = (jg.max_lat - jg.min_lat) / (jg.num_lat - 1)
    return jfast._gamma_tables(lon_step, lat_step, (v.nugget, v.sill, v.range), "exponential", R)


def equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def close(got, want, tol=PRED_TOL):
    got, want = got.numpy(), np.asarray(want, np.float64)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert ok.any()
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# B13
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(GRIDS))
def test_dense_select_equals_the_jax_dense_pass(name, dtype):
    jg, tg, rc = pair(name, dtype)
    flat_a, keys, flat_q = dense_operands(tg, rc)
    got = es.dense_select(tg, flat_a, keys, flat_q)
    want = jfast._extract_q(*jax_dense_planes(jg, flat_a, keys), jg.elev, flat_q.numpy().astype(np.int32),
                            max_radius=R)
    equal(got, want)
    found, tie, vals, dgi, dgj = got
    assert found.dtype == torch.int32 and tie.dtype == torch.bool and vals.dtype == tg.elev.dtype
    assert dgi.dtype == dgj.dtype == torch.int64 and vals.shape == (4, len(flat_q))
    assert (found >= 4).any() and (name != "sparse" or (found < 4).any())
    assert name != "degenerate" or tie.any()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(GRIDS))
def test_dense_krige_within_1e9_of_the_jax_table_solve(name, dtype):
    jg, tg, rc = pair(name, dtype)
    flat_a, keys, flat_q = dense_operands(tg, rc)
    gpair, gq = tfast._reference_tables(tg, R)
    np.testing.assert_array_equal(gpair.numpy(), jax_tables(jg)[0])
    pred, tie = es.dense_krige(tg, flat_a, keys, flat_q, gpair, gq)
    jp, jq = (np.asarray(t) for t in jax_tables(jg))
    want, want_tie, _ = jfast._extract_solve_table(*jax_dense_planes(jg, flat_a, keys), jg.elev,
                                                   flat_q.numpy().astype(np.int32), jp, jq, max_radius=R)
    equal([tie], [want_tie])
    close(pred, want)


# ---------------------------------------------------------------------------
# B14
# ---------------------------------------------------------------------------

def _far_anchors(tg):
    """Anchors past each edge, with variant 0 and zero keys, then some near
    the ends of int32 (a lane's int32 add wraps in the JAX package); the
    last is farther than the radius from every cell."""
    H, W = tg.shape
    ci = np.array([-3, W + 2, 5, -12, W - 1, 2**31 - 4, 3, -2**31 + 2, -30], np.int64)
    cj = np.array([4, 2, -12, H + 9, H + 1, 5, 2**31 - 3, -2**31 + 5, H + 40], np.int64)
    return ci, cj


@pytest.mark.parametrize("anchor", ["round", "floor"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(GRIDS))
def test_ring_select_equals_the_jax_strict_selection(name, dtype, anchor):
    jg, tg, rc = pair(name, dtype)
    rows, cols = queries(tg, rc)
    q = texact.prepare_exact_queries(tg, rows, cols, anchor=anchor)
    fci, fcj = _far_anchors(tg)
    z = np.zeros(len(fci))
    ci, cj = np.concatenate([q.ci, fci]), np.concatenate([q.cj, fcj])
    variant = np.concatenate([q.variant, z]).astype(np.int32)
    ex, ey = (np.concatenate([k, z]).astype(np.float32) for k in (q.ex_key, q.ey_key))
    got = es.ring_select(tg, *(torch.as_tensor(a) for a in (ci, cj, ex, ey, variant)), chunk=700)
    want = jexact._select_chunk(jg.elev, jg.valid, ci.astype(np.int32), cj.astype(np.int32), variant, ex, ey,
                                max_radius=R)
    equal(got, want)
    found, sel_val, gi, gj = got
    assert sel_val.dtype == tg.elev.dtype and gi.dtype == gj.dtype == torch.int32 and sel_val.shape == (len(ci), 4)
    assert found[-1] == 0 and (found >= 4).any()


def _scattered_queries(ext, n=1500, seed=0):
    """Uniform points over the extent and 5 % past it, and cell centres and
    half lines (exact distance ties)."""
    rng = np.random.default_rng(seed)
    w, h = ext.max_lon - ext.min_lon, ext.max_lat - ext.min_lat
    u = np.arange(0, 40, 0.25) / 40
    return (np.concatenate([rng.uniform(ext.min_lon - 0.05 * w, ext.max_lon + 0.05 * w, n), ext.min_lon + u * w]),
            np.concatenate([rng.uniform(ext.min_lat - 0.05 * h, ext.max_lat + 0.05 * h, n), ext.min_lat + u * h]))


@pytest.mark.parametrize("anchor", ["round", "floor"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["awkward_r0.5", "degenerate", "sparse"])
def test_ring_select_scattered_equals_the_jax_selection(name, dtype, anchor):
    jg, tg, _ = pair(name, dtype)
    lons, lats = _scattered_queries(GRIDS[name][4])
    _, _, x, y, ci, cj, _ = texact._prepare_scattered(tg, lons, lats, anchor)
    got = es.ring_select(tg, *(torch.as_tensor(a) for a in (ci, cj, x, y)), chunk=600)
    equal(got, jexact._select_chunk_scattered(jg.elev, jg.valid, ci, cj, x, y, max_radius=R))
    assert (got[0] >= 4).any()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(GRIDS))
def test_ring_krige_within_1e9_of_the_jax_escalation_solve(name, dtype):
    jg, tg, rc = pair(name, dtype)
    rows, cols = queries(tg, rc)
    q = texact.prepare_exact_queries(tg, rows, cols)
    idx = np.nonzero(~q.oob)[0]  # the two-tier path escalates no query outside the grid
    gpair, gq = tfast._reference_tables(tg, R)
    got = es.ring_krige(tg, *texact._cell_keys(tg, q, idx), torch.as_tensor(cols[idx]),
                        torch.as_tensor(rows[idx]), gpair, gq, chunk=500)
    # the JAX package's escalation (exact_fast.py:486-505): the strict
    # selection, the fallback mean where fewer than 4, the table solve else
    f2, v2, gi2, gj2 = (np.asarray(a) for a in jexact._select_chunk(
        jg.elev, jg.valid, q.ci[idx], q.cj[idx], q.variant[idx], q.ex_key[idx], q.ey_key[idx], max_radius=R))
    want = jexact._fallback_mean_np(f2, v2)
    okm = f2 >= 4
    jp, jq = (np.asarray(t) for t in jax_tables(jg))
    vals = v2[okm].astype(np.float64)
    pred, singular = (np.asarray(a) for a in jfast._krige_chunk_table(
        vals, (gi2[okm] - cols[idx][okm, None]).astype(np.int32), (gj2[okm] - rows[idx][okm, None]).astype(np.int32),
        jp, jq, max_radius=R))
    want[okm] = np.where(singular.astype(bool), vals.mean(axis=1), pred)
    close(got, want)


# ---------------------------------------------------------------------------
# what the cases are for, and B13's aligned path
# ---------------------------------------------------------------------------

def test_the_full_list_case_holds_45_candidates():
    _, tg, _ = pair("full_list", np.float64)
    r0, c0 = FULL_LIST_QUERY
    q = texact.prepare_exact_queries(tg, np.array([r0]), np.array([c0]))
    assert (q.ci[0], q.cj[0], q.variant[0]) == (c0, r0, 0)
    found = es.ring_select(tg, *texact._cell_keys(tg, q, None)[:2], *texact._cell_keys(tg, q, None)[3:],
                           texact._cell_keys(tg, q, None)[2])[0]
    flat = torch.tensor([r0 * tg.shape[1] + c0])
    assert int(found[0]) == 45 and int(es.dense_select(tg, None, texact._on(tg, np.stack([q.ex_key, q.ey_key])),
                                                       flat)[0][0]) == 45


def test_the_swap_passes_reorder_equal_keys_in_the_swapped_ties_case():
    """Some query's selection differs from a stable top-4 of its list by
    (d2, -T), original position: the swaps moved an entry past an equal one
    (in the order, or in the set where the tie is at the 4th)."""
    _, tg, rc = pair("swapped_ties", np.float64)
    q = texact.prepare_exact_queries(tg, rc[:, 0], rc[:, 1])
    ci, cj, variant, ex, ey = texact._cell_keys(tg, q, None)
    tb = texact._device_tables(R, torch.device("cpu"))
    gi, gj, _, eligible, _ = texact._candidates(tg, tb, ci, cj)
    d2 = tb["d2"][variant.long()]
    t = ex[:, None] * tb["cfx"][variant.long()] + ey[:, None] * tb["cfy"][variant.long()]
    _, _, sel_gi, sel_gj = es.ring_select(tg, ci, cj, ex, ey, variant)
    reordered = 0
    for i in range(len(ci)):
        lanes = np.nonzero(eligible[i].numpy())[0]
        order = sorted(lanes, key=lambda j: (float(d2[i, j]), -float(t[i, j])))[:4]
        stable = [(int(gi[i, j]), int(gj[i, j])) for j in order]
        got = list(zip(sel_gi[i, :len(order)].tolist(), sel_gj[i, :len(order)].tolist()))
        reordered += stable != got
    assert reordered > 0


def _aligned_operands(tg, rc):
    """Every held-out cell twice (duplicated cells), all aligned: B13's
    operands for the residue planes (flat_a) and for the aligned path."""
    H, W = tg.shape
    rows, cols = np.tile(rc[:, 0], 2).astype(np.int64), np.tile(rc[:, 1], 2).astype(np.int64)
    q, (flat_a, keys, flat_q) = tfast._round_queries(tg, rows, cols)
    assert q.aligned.all() and flat_a is None and torch.equal(flat_q, torch.as_tensor(rows * W + cols))
    return keys, flat_q


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(GRIDS))
def test_dense_aligned_path_equals_the_residue_planes_and_jax(name, dtype):
    jg, tg, rc = pair(name, dtype)
    keys, flat_q = _aligned_operands(tg, rc)
    got = es.dense_select(tg, None, keys, flat_q)
    equal(got, es.dense_select(tg, flat_q, keys, flat_q))
    want = jfast._extract_q(*jax_dense_planes(jg, flat_q, keys), jg.elev, flat_q.numpy().astype(np.int32),
                            max_radius=R)
    equal(got, want)
    gpair, gq = tfast._reference_tables(tg, R)
    equal(es.dense_krige(tg, None, keys, flat_q, gpair, gq), es.dense_krige(tg, flat_q, keys, flat_q, gpair, gq))


def test_dense_inputs_keep_the_planes_where_any_query_is_not_aligned():
    _, tg, rc = pair("awkward_r0.5", np.float64)
    rows, cols = queries(tg, rc)
    q, (flat_a, keys, flat_q) = tfast._round_queries(tg, rows, cols)
    aligned = q.aligned.numpy()
    assert not aligned.all() and aligned.any()
    np.testing.assert_array_equal(flat_a.numpy(), (rows * tg.shape[1] + cols)[aligned])
    host = texact.prepare_exact_queries(tg, rows, cols)
    np.testing.assert_array_equal(aligned, tfast._aligned(host, rows, cols))
    np.testing.assert_array_equal(keys.numpy(), np.stack([host.ex_key[aligned], host.ey_key[aligned]]))
    assert keys.shape == (2, int(aligned.sum())) and flat_q.shape == (len(rows),)


# ---------------------------------------------------------------------------
# the kernels' walk and B14's passes written out, against the plain version
# ---------------------------------------------------------------------------

def _bit_plane(valid):
    """(words, H, W): the bit plane as csrc/exact_select.cu's bits_kernel
    lays it out, flat: bit c % 32 of word c // 32 is cell c's (row * W +
    col), set where valid > 0.5; a row ends inside a word unless 32
    divides W."""
    H, W = valid.shape
    flat = np.concatenate([(valid.reshape(-1) > 0.5), np.zeros(-(H * W) % 32, bool)])
    return (flat.reshape(-1, 32).astype(np.int64) << np.arange(32)).sum(axis=1), H, W


def _span(plane, gj, c0, n):
    """BitPlane::span: cells c0 .. c0 + n - 1 (n <= 32) of row gj as bits
    0 .. n - 1."""
    assert n <= 32
    words, H, W = plane
    if not 0 <= gj < H:
        return 0
    lo, hi = max(c0, 0), min(c0 + n, W)
    if lo >= hi:
        return 0
    f0, f1 = gj * W + lo, gj * W + hi - 1
    v = int(words[f0 >> 5]) | (int(words[f1 >> 5]) << 32 if f1 >> 5 != f0 >> 5 else 0)
    return ((v >> (f0 & 31)) & ((1 << (hi - lo)) - 1)) << (lo - c0)


def _ends(plane, gj, c0, n):
    """BitPlane::ends: cells c0 and c0 + n - 1 of row gj as bits 0 and 1,
    from the words of the row's first and last cell in the grid."""
    words, H, W = plane
    c1 = c0 + n - 1
    lo, hi = max(c0, 0), min(c1, W - 1)
    if not 0 <= gj < H or lo > hi:
        return 0
    f0, f1 = gj * W + lo, gj * W + hi
    first = (int(words[f0 >> 5]) >> (f0 & 31)) & 1 if lo == c0 else 0
    last = (int(words[f1 >> 5]) >> (f1 & 31)) & 1 if hi == c1 else 0
    return first | last << 1


def _interleaved(first, second):
    """The set bits of interleave(first, second), lowest first, as (bit k,
    from the second mask)."""
    for b in range(64):
        if ((second if b & 1 else first) >> (b >> 1)) & 1:
            yield b >> 1, bool(b & 1)


PIECE = 32  # kPiece: a pass is read in pieces of at most 32 cells


def _walk(plane, ci, cj, R=R):
    """ring_walk over the bit plane at radius R: the candidate lanes (dx,
    dy) of anchor (ci, cj) in the kernel's order, each pass in pieces of
    32 cells (the top and bottom rows by dx, the columns by dy), rings up to
    the last that holds a lane of the grid, to the first segment end
    holding 4."""
    _, H, W = plane
    out = []
    if not (-R <= ci < W + R and -R <= cj < H + R):
        return out
    rmax = min(R, max(ci, W - 1 - ci, cj, H - 1 - cj))
    up, mid, dn = (_span(plane, cj + d, ci - 1, 3) for d in (-1, 0, 1))
    segments = [[(0, 0)] if mid & 2 else [],
                [(k - 1, 1 if b else -1) for k, b in _interleaved(up, dn)],
                [(d, 0) for d, bit in ((-1, 1), (1, 4)) if mid & bit]]
    for r in range(2, rmax + 1):
        n = 2 * r + 1
        rows, cols = [], []
        for p0 in range(0, n, PIECE):
            w = min(PIECE, n - p0)
            top, bot = _span(plane, cj - r, ci - r + p0, w), _span(plane, cj + r, ci - r + p0, w)
            rows += [(p0 + k - r, r if b else -r) for k, b in _interleaved(top, bot)]
        for p0 in range(0, n - 2, PIECE):
            side = [_ends(plane, cj - r + 1 + p0 + k, ci - r, n) for k in range(min(PIECE, n - 2 - p0))]
            left = sum((e & 1) << k for k, e in enumerate(side))
            right = sum((e >> 1) << k for k, e in enumerate(side))
            cols += [(r if b else -r, p0 + k - r + 1) for k, b in _interleaved(left, right)]
        segments += [rows, cols]
    for seg in segments:
        out += seg
        if len(out) >= 4:
            break
    return out


def _eight_entry_passes(keys, before, is_nan, nan_stops):
    """ring_kernel's passes: the list's first four entries and the best four
    of the rest by (key, position), each with its current position; returns
    the list positions picked (None where a pass takes nothing)."""
    best4 = []
    for p in (p for p in range(4, len(keys)) if not is_nan(keys[p])):  # B13's insert, in collection order
        s = next((s for s, e in enumerate(best4) if before(keys[p], keys[e])), len(best4))
        best4.insert(s, p)
        del best4[4:]
    entries = [p for p in range(min(len(keys), 4))] + best4
    pos = {p: p for p in entries}
    picks, stop = [], False
    for m in range(4):
        live = [p for p in entries if pos[p] >= m and not is_nan(keys[p])]
        best = None
        for p in live:
            if best is None or before(keys[p], keys[best]) or (
                    not before(keys[best], keys[p]) and pos[p] < pos[best]):
                best = p
        stop = stop or best is None or nan_stops(keys, best)
        if stop:
            picks.append(None)
            continue
        at_m = next((p for p in entries if pos[p] == m and p != best), None)
        if at_m is not None:
            pos[at_m] = pos[best]
        pos[best] = m
        picks.append(best)
    return picks


def _model_select(elev, plane, ci, cj, key, k0, k1, variant, R=R):
    """B14 for one query through _walk and _eight_entry_passes at radius R:
    (found, values, gi, gj, the walk's last ring with a candidate)."""
    lanes = _walk(plane, ci, cj, R)
    with np.errstate(all="ignore"):
        if key == 0:
            ax, ay = -(variant >> 1), -(variant & 1)
            keys = []
            for dx, dy in lanes:
                fx, fy = np.float32(dx + ax) + np.float32(0.5), np.float32(dy + ay) + np.float32(0.5)
                keys.append((fx * fx + fy * fy, k0 * np.float32(2 * (dx + ax) + 1) + k1 * np.float32(2 * (dy + ay) + 1)))
            nan_d2 = min((k[0] for k in keys if k[1] != k[1]), default=np.inf)
            picks = _eight_entry_passes(keys, lambda a, b: a[0] < b[0] or (a[0] == b[0] and a[1] > b[1]),
                                        lambda k: k[1] != k[1], lambda ks, b: nan_d2 <= ks[b][0])
        else:
            keys = [float(np.sqrt(((ci + dx + 0.5) - k0) ** 2 + ((cj + dy + 0.5) - k1) ** 2)) for dx, dy in lanes]
            any_nan = any(k != k for k in keys)
            picks = _eight_entry_passes(keys, lambda a, b: a < b, lambda k: k != k, lambda ks, b: any_nan)
    gi = [ci + lanes[p][0] if p is not None else 0 for p in picks]
    gj = [cj + lanes[p][1] if p is not None else 0 for p in picks]
    vals = [elev[gj[m], gi[m]] + elev.dtype.type(0) if p is not None else 0 for m, p in enumerate(picks)]
    return len(lanes), vals, gi, gj, max((max(abs(dx), abs(dy)) for dx, dy in lanes), default=0)


# the walk's cases: the grids at the default radius, and "grid@R" at radius
# R (1 and 3: one piece a pass; 16: the top and bottom passes in two pieces
# from ring 16 on; 40: in three from ring 32 on, the columns in two, and the
# walk cut at the grid's last ring)
WALK_CASES = ["awkward_r0.5", "swapped_ties", "sparse", "narrow_w20", "odd_w45", "full_list",
              "sparse@1", "awkward_r0.5@3", "sparse@16", "odd_w45@16", "sparse@40", "narrow_w20@40"]


@pytest.mark.parametrize("key", [0, 1], ids=["cell_aligned", "scattered"])
@pytest.mark.parametrize("name", WALK_CASES)
def test_the_kernels_walk_and_passes_written_out_equal_the_plain_selection(name, key):
    """Random anchors on and past the grid, with the tests' keys and with
    keys that overflow to inf or NaN on some lanes only (a NaN pass takes
    nothing, and every later one)."""
    name, _, radius = name.partition("@")
    radius = int(radius) if radius else R
    _, tg, _ = pair(name, np.float32)
    H, W = tg.shape
    rng = np.random.default_rng(len(name) + radius)
    n = 700 if radius == R else 300
    margin = 3 if radius == R else radius + 2
    ci, cj = rng.integers(-margin, W + margin, n), rng.integers(-margin, H + margin, n)
    if key == 0:
        variant = rng.integers(0, 4, n).astype(np.int32)
        k0, k1 = (_ODD_KEYS[rng.integers(0, len(_ODD_KEYS), n)] for _ in range(2))
        args = (ci, cj, k0, k1, variant)
    else:
        variant = np.zeros(n, np.int32)
        k0, k1 = ci + rng.uniform(-0.5, 0.5, n), cj + rng.uniform(-0.5, 0.5, n)
        k0[::13], k1[::17], k0[::29] = np.nan, np.inf, -1e308
        args = (ci, cj, k0, k1, None)
    want = es.ring_select(tg, *(torch.as_tensor(a) if a is not None else None for a in args), max_radius=radius)
    plane = _bit_plane(tg.valid.numpy())
    elev = tg.elev.numpy()
    reach = 0
    for i in range(n):
        f, v, gi, gj, ring = _model_select(elev, plane, int(ci[i]), int(cj[i]), key, k0[i], k1[i],
                                           int(variant[i]), radius)
        assert f == int(want[0][i]), i
        np.testing.assert_array_equal(np.array(v, elev.dtype), want[1][i].numpy(), err_msg=str(i))
        assert gi == want[2][i].tolist() and gj == want[3][i].tolist(), i
        reach = max(reach, ring)
    # some walk takes a candidate in a pass of more than one piece
    assert radius < 16 or reach >= 16, reach


# ---------------------------------------------------------------------------
# the public entry points on float32 grids (float64: tests/test_torch_exact.py)
# ---------------------------------------------------------------------------

ENTRIES = {
    "two_tier_kriging": (tfast.exact_kriging_at_cells_fast, jfast.exact_kriging_at_cells_fast),
    "strict_kriging": (texact.exact_kriging_at_cells, jexact.exact_kriging_at_cells),
    "cubic": (texact.exact_cubic_at_cells, jexact.exact_cubic_at_cells),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
@pytest.mark.parametrize("name", ["awkward_r0.5", "degenerate", "sparse"])
def test_entries_on_float32_grids_within_1e9(name, entry):
    jg, tg, rc = pair(name, np.float32)
    rows, cols = queries(tg, rc)
    tfn, jfn = ENTRIES[entry]
    close(torch.as_tensor(tfn(tg, rows, cols)), jfn(jg, rows, cols))
    if entry == "two_tier_kriging":
        got, want = tfast.exact_select_at_cells_fast(tg, rows, cols), jfast.exact_select_at_cells_fast(jg, rows, cols)
        for a, b in zip(got[:4] + (got[5],), want[:4] + (want[5],)):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the ops: opcheck, and the fake implementations' shapes and dtypes
# ---------------------------------------------------------------------------

def _op_args(op_name, dtype=np.float64):
    _, tg, rc = pair("awkward_r0.1", dtype)
    rows, cols = queries(tg, rc)
    inside = (rows >= 0) & (rows < tg.num_lat) & (cols >= 0) & (cols < tg.num_lon)
    rows, cols = rows[inside], cols[inside]  # no NaN prediction (opcheck holds NaN unequal to NaN)
    gpair, gq = tfast._reference_tables(tg, R)
    if op_name == "exact_dense_aligned":
        return (tg.elev, tg.valid, None, *_aligned_operands(tg, rc), R)
    if op_name.startswith("exact_dense"):
        flat_a, keys, flat_q = dense_operands(tg, np.stack([rows, cols], axis=1))
        tabs = (gpair, gq) if op_name == "exact_dense_krige" else ()
        return (tg.elev, tg.valid, flat_a, keys, flat_q, *tabs, R)
    q = texact.prepare_exact_queries(tg, rows, cols)
    ci, cj, variant, ex, ey = texact._cell_keys(tg, q, None)
    if op_name == "exact_ring":
        return (tg.elev, tg.valid, ci, cj, ex, ey, variant, R, 300)
    if op_name == "exact_ring_scattered":
        x, y = (torch.as_tensor(a) for a in (q.x + 0.3, q.y - 0.2))
        return (tg.elev, tg.valid, ci, cj, x, y, None, R, 300)
    return (tg.elev, tg.valid, ci, cj, variant, ex, ey, torch.as_tensor(cols), torch.as_tensor(rows), gpair, gq, R, 300)


OPS = ["exact_dense", "exact_dense_aligned", "exact_dense_krige", "exact_ring", "exact_ring_scattered",
       "exact_ring_krige"]


def _op(op_name):
    return getattr(library, {"exact_ring_scattered": "exact_ring", "exact_dense_aligned": "exact_dense"}.get(
        op_name, op_name))


@pytest.mark.parametrize("op_name", OPS)
def test_opcheck(op_name):
    torch.library.opcheck(_op(op_name), _op_args(op_name))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("op_name", OPS)
def test_fake_implementations_give_the_outputs_shapes_and_dtypes(op_name, dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = _op_args(op_name, dtype)
    real = _op(op_name)(*args)
    with FakeTensorMode() as mode:
        fake = _op(op_name)(*(mode.from_tensor(a) if torch.is_tensor(a) else a for a in args))
    real, fake = (t if isinstance(t, tuple) else (t,) for t in (real, fake))
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        assert (tuple(f.shape), f.dtype, f.device) == (tuple(r.shape), r.dtype, r.device)


def test_the_wrappers_count_no_launch_on_the_cpu():
    _, tg, rc = pair("awkward_r0.1", np.float64)
    es.reset_launches()
    rows, cols = queries(tg, rc)
    tfast.exact_kriging_at_cells_fast(tg, rows, cols)
    texact.exact_kriging_at_cells(tg, rows, cols)
    assert es.LAUNCHES == {"exact_dense": 0, "exact_ring": 0}


# ---------------------------------------------------------------------------
# the C entries' signatures, and the radius handed to them
# ---------------------------------------------------------------------------

_CTYPES = {"int": ctypes.c_int, "double": ctypes.c_double, "void*": ctypes.c_void_p}
_ARGTYPES = {"dense": "[I, P, P, I, I, I, P, I, P, I, P, P, D, P, P, P, P, P, P, P, P]",
             "ring": "[I, P, P, I, I, I, P, P, I, I, P, P, P, P, P, P, P, D, P, P, P, P, P, P, P]"}


@pytest.mark.parametrize("kind", ["dense", "ring"])
def test_ctypes_arguments_follow_the_c_signature_and_carry_the_radius(kind):
    """The wrapper's argtypes follow ``auvtpu_exact_<kind>``'s parameters in
    ``csrc/exact_select.cu``, and a launch hands the caller's radius (and
    the grid's H, W, the query count) to the parameters of those names."""
    src = open(os.path.join(os.path.dirname(library.__file__), "..", "csrc", "exact_select.cu")).read()
    sig = re.search(rf"int auvtpu_exact_{kind}\(([^)]*)\)", src).group(1)
    params = [re.sub(r"\s+", " ", p.strip()).replace("const ", "").replace(" *", "* ").rsplit(" ", 1)
              for p in sig.split(",")]
    names = [name for _, name in params]
    letter = {ctypes.c_int: "I", ctypes.c_double: "D", ctypes.c_void_p: "P"}
    want = "[" + ", ".join(letter[_CTYPES[t]] for t, _ in params) + "]"
    assert want == _ARGTYPES[kind], names
    assert f"auvtpu_exact_{kind}.argtypes = {_ARGTYPES[kind]}" in inspect.getsource(es._lib.__wrapped__)

    calls = []

    class Fake:
        def __getattr__(self, attr):
            return self

        def __call__(self, *args):
            calls.append(args)
            return 0

    _, tg, rc = pair("awkward_r0.1", np.float64)
    radius = 17
    gpair, gq = tfast._reference_tables(tg, radius)
    orig = (es._lib, es._stream, torch.cuda.device)
    try:
        es._lib, es._stream = (lambda: Fake()), (lambda dev: None)
        torch.cuda.device = lambda dev: contextlib.nullcontext()
        if kind == "dense":
            flat_a, keys, flat_q = dense_operands(tg, rc)
            es.dense_launch(tg.elev, tg.valid, flat_a, keys, flat_q, gpair, gq, radius)
            n = len(flat_q)
        else:
            q = texact.prepare_exact_queries(tg, rc[:, 0], rc[:, 1])
            ci, cj, variant, ex, ey = texact._cell_keys(tg, q, None)
            es.ring_launch(tg.elev, tg.valid, ci, cj, ex, ey, variant, None, None, None, None, radius)
            n = len(ci)
    finally:
        es._lib, es._stream, torch.cuda.device = orig
    (args,) = calls
    got = dict(zip(names, args))
    assert (got["f64"], got["H"], got["W"], got["R"], got["n"]) == (1, *tg.shape, radius, n)
    es.reset_launches()
    with pytest.raises(ValueError, match="max_radius=0"):
        es.dense_launch(tg.elev, tg.valid, None, keys if kind == "dense" else torch.zeros((2, 1)),
                        torch.zeros(1, dtype=torch.int64), None, None, 0)
