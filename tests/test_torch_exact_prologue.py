"""Exact mode's query preparation B16 (``auvtpu_torch::exact_prologue``,
``kernels/exact_prologue.py``) through its wrapper on CPU tensors, where the
op runs the kernel's plain version (torch float64 ops), against the JAX
package's host numpy (``auvtpu.ops.exact.prepare_exact_queries`` and
``_prepare_scattered``) bit for bit, every field and dtype: both anchors,
int32 and int64 queries, on awkward, degenerate and non-dyadic extents,
with rows and columns past every edge; scattered coordinates at NaN, ±inf,
out of the grid and on grid lines (a NaN query's anchors 0 in both
anchors).  The inexact-residue refusal raises the same ValueError through
every cell entry point of both packages with ``EPS_SCALE`` monkeypatched
in both.  Every exact entry point, with numpy and with tensor queries,
equals the JAX package's within 1e-9 m with NaN in the same places and
never calls the host views (``prepare_exact_queries``,
``_prepare_scattered``).  The op passes opcheck; the wrapper's ctypes
argument list follows the C entry's signature in ``csrc/exact_prologue.cu``.
The kernel itself is held to this plain version bit for bit on a card
(``tests/test_torch_cuda.py -k prologue``)."""

import contextlib
import ctypes
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import jax

from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import exact as jexact
from auvtpu.ops import exact_fast as jfast
from auvtpu.synthetic import shelf_seamount

from auvtpu_torch.convert import grid_from_arrays
from auvtpu_torch.kernels import exact_prologue as ep
from auvtpu_torch.kernels import library
from auvtpu_torch.ops import exact as texact
from auvtpu_torch.ops import exact_fast as tfast
from test_torch_cuda import (
    EXACT_EXTENT,
    FAT_EPS_SCALE,
    PROLOGUE_GRIDS,
    prologue_cell_queries,
    prologue_scattered_queries,
)

torch.set_num_threads(1)

AWKWARD = EXACT_EXTENT  # Kerguelen-style decimals: residues
PRED_TOL = 1e-9  # m
GRIDS = PROLOGUE_GRIDS  # awkward, degenerate (binary-exact steps: no residue) and non-dyadic extents
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "auvtpu_torch", "csrc",
                    "exact_prologue.cu")


@pytest.fixture(scope="module", autouse=True)
def x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


_PAIRS = {}


def pair(name, dtype=np.float64):
    """(JAX grid, port CPU grid, held-out rows/cols) of one synthetic grid."""
    key = (name, dtype)
    if key not in _PAIRS:
        h, w, removal, seed, ext = GRIDS[name]
        reduced, rc, _ = mask_grid(shelf_seamount(h, w), removal, seed=seed)
        jg = JGrid.from_nan_array(reduced, ext, dtype=dtype)
        tg = grid_from_arrays(np.asarray(jg.elev), np.asarray(jg.valid), ext.min_lon, ext.max_lon,
                              ext.min_lat, ext.max_lat, "cpu")
        _PAIRS[key] = (jg, tg, rc)
    return _PAIRS[key]


def cell_queries(tg, rc):
    return prologue_cell_queries(*tg.shape, rc)


def _fields_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


# ---------------------------------------------------------------------------
# the plain version against the JAX package's host numpy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index", ["numpy", "int64", "int32"])
@pytest.mark.parametrize("anchor", ["round", "floor"])
@pytest.mark.parametrize("name", list(GRIDS))
def test_prepare_equals_the_jax_host_numpy(name, anchor, index):
    jg, tg, rc = pair(name)
    rows, cols = cell_queries(tg, rc)
    want = jexact.prepare_exact_queries(jg, rows, cols, anchor=anchor)
    if index != "numpy":
        dt = getattr(torch, index)
        keep = (np.abs(cols) < 2**31) & (np.abs(rows) < 2**31) if index == "int32" else slice(None)
        rows, cols, want = rows[keep], cols[keep], jexact.prepare_exact_queries(jg, rows[keep], cols[keep],
                                                                               anchor=anchor)
        rows, cols = torch.as_tensor(rows, dtype=dt), torch.as_tensor(cols, dtype=dt)
    _fields_equal(texact.prepare_exact_queries(tg, rows, cols, anchor=anchor), want)
    if name not in ("degenerate_48x64",):
        assert (want.ex_key != 0).any() and (want.ey_key != 0).any()
    assert want.oob.any() and not want.oob.all()


@pytest.mark.parametrize("name", list(GRIDS))
def test_aligned_mask_and_cells_equal_the_jax_two_tier_operands(name):
    # B16's aligned mask, its count, and the clipped query cells against
    # what the JAX package's exact_kriging_at_cells_fast builds on the host
    jg, tg, rc = pair(name)
    rows, cols = cell_queries(tg, rc)
    H, W = tg.shape
    want = jexact.prepare_exact_queries(jg, rows, cols, anchor="round")
    aligned = (want.ci == cols) & (want.cj == rows) & (want.variant == 0) & ~want.oob
    q = texact.query_tensors(tg, rows, cols, anchor="round", fields=ep.CELL_FIELDS)
    np.testing.assert_array_equal(q.aligned.numpy(), aligned)
    np.testing.assert_array_equal(q.flat.numpy(), np.clip(rows * W + cols, 0, H * W - 1))
    assert q.counts.tolist() == [0, int((~aligned).sum())] and (~aligned).any() and aligned.any()
    np.testing.assert_array_equal(q.cols.numpy(), cols)


@pytest.mark.parametrize("anchor", ["round", "floor"])
@pytest.mark.parametrize("name", ["64x80_r0.1", "nondyadic_57x73"])
def test_scattered_prepare_equals_the_jax_host_numpy(name, anchor):
    jg, tg, _ = pair(name)
    lons, lats = prologue_scattered_queries(GRIDS[name][4])
    with np.errstate(invalid="ignore"):
        want = jexact._prepare_scattered(jg, lons, lats, anchor)
    for src in (lons, torch.as_tensor(lons)):
        got = texact._prepare_scattered(tg, src, torch.as_tensor(lats) if torch.is_tensor(src) else lats, anchor)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # a NaN coordinate's anchor is 0 in both anchors, int64 on the device
    q = texact.scattered_tensors(tg, lons, lats, anchor)
    assert np.isnan(lons).sum() == 3 and (q.ci.numpy()[np.isnan(lons)] == 0).all()
    assert np.isnan(lats).sum() == 3 and (q.cj.numpy()[np.isnan(lats)] == 0).all()
    assert q.ci.dtype == torch.int64 and q.counts.tolist() == [0, 0]
    assert np.isinf(lons).any() and want[6][np.isinf(lons) | np.isinf(lats)].all()


@pytest.mark.parametrize("anchor", [True, False], ids=["round", "floor"])
@pytest.mark.parametrize("fields", [0, ep.KEYS, ep.GEO, ep.GRID, ep.ALIGNED, ep.FLAT, ep.KEYS | ep.ALIGNED | ep.FLAT,
                                    ep.CELL_FIELDS])
def test_fields_choose_the_outputs(fields, anchor):
    # an output fields leaves out is empty; the others equal the call with
    # every field; the anchors, oob and counts come always
    _, tg, rc = pair("101x97_r0.3")
    rows, cols = (torch.as_tensor(a) for a in cell_queries(tg, rc))
    full = ep.prologue(tg, cols, rows, round_anchor=anchor, fields=ep.CELL_FIELDS, eps_scale=texact.EPS_SCALE)
    got = ep.prologue(tg, cols, rows, round_anchor=anchor, fields=fields, eps_scale=texact.EPS_SCALE)
    flags = [None, None, None, ep.KEYS, ep.KEYS, ep.GEO, ep.GRID, ep.ALIGNED, ep.FLAT]
    for i, (a, b, flag) in enumerate(zip(got, full, flags)):
        assert a.dtype == b.dtype, i
        if i == 2:  # the queries not aligned are counted with the aligned mask
            assert int(a[0]) == int(b[0]) and int(a[1]) == (int(b[1]) if fields & ep.ALIGNED else 0)
        elif flag is None or fields & flag:
            assert torch.equal(a, b), i
        else:
            assert a.numel() == 0 and a.dim() == b.dim(), i
    assert int(full[2][1]) > 0


def test_the_op_refuses_what_the_kernel_does_not_take():
    _, tg, _ = pair("64x80_r0.1")
    i64, f64 = torch.zeros(3, dtype=torch.int64), torch.zeros(3, dtype=torch.float64)
    kw = dict(round_anchor=True, eps_scale=texact.EPS_SCALE)
    with pytest.raises(ValueError, match="outside"):
        ep.prologue(tg, f64, f64, fields=ep.KEYS, **kw)  # scattered queries have no keys
    with pytest.raises(TypeError, match="int32 or int64"):
        ep.prologue(tg, f64.float(), f64.float(), fields=ep.GRID, **kw)
    with pytest.raises(TypeError, match="both of one dtype"):
        ep.prologue(tg, i64, i64.int(), fields=0, **kw)
    with pytest.raises(ValueError, match=r"two \(N,\) tensors"):
        ep.prologue(tg, i64, i64[:2], fields=0, **kw)
    with pytest.raises(ValueError, match="outside"):
        ep.prologue(tg, i64, i64, fields=32, **kw)
    with pytest.raises(ValueError, match="nearest"):
        texact.query_tensors(tg, i64, i64, anchor="nearest")


# ---------------------------------------------------------------------------
# the refusal and the entry points
# ---------------------------------------------------------------------------

CELL_ENTRIES = {
    "select": (lambda g, r, c: texact.exact_select_at_cells(g, r, c)[:4],
               lambda g, r, c: jexact.exact_select_at_cells(g, r, c)[:4]),
    "select_fast": (lambda g, r, c: tfast.exact_select_at_cells_fast(g, r, c)[:4],
                    lambda g, r, c: jfast.exact_select_at_cells_fast(g, r, c)[:4]),
    "strict": (texact.exact_kriging_at_cells, jexact.exact_kriging_at_cells),
    "two_tier_table": (tfast.exact_kriging_at_cells_fast, jfast.exact_kriging_at_cells_fast),
    "two_tier_coords": (lambda g, r, c: tfast.exact_kriging_at_cells_fast(g, r, c, solve="coords"),
                        lambda g, r, c: jfast.exact_kriging_at_cells_fast(g, r, c, solve="coords")),
    "cubic": (texact.exact_cubic_at_cells, jexact.exact_cubic_at_cells),
    "bilinear": (texact.exact_bilinear_at_cells, jexact.exact_bilinear_at_cells),
}


@pytest.mark.parametrize("entry", ["prepare", *CELL_ENTRIES])
def test_an_inexact_residue_raises_through_every_entry_point(entry, monkeypatch):
    jg, tg, rc = pair("64x80_r0.1")
    monkeypatch.setattr(jexact, "EPS_SCALE", FAT_EPS_SCALE)
    monkeypatch.setattr(texact, "EPS_SCALE", FAT_EPS_SCALE)
    if entry == "prepare":
        calls = [(lambda g, r, c: texact.prepare_exact_queries(g, r, c), tg),
                 (lambda g, r, c: jexact.prepare_exact_queries(g, r, c), jg)]
    else:
        calls = [(CELL_ENTRIES[entry][0], tg), (CELL_ENTRIES[entry][1], jg)]
    for fn, g in calls:
        with pytest.raises(ValueError, match="coordinate residue not exactly representable in f32 keys"):
            fn(g, rc[:, 0], rc[:, 1])
    with pytest.raises(ValueError, match="f32 keys"):  # tensor queries too
        CELL_ENTRIES.get(entry, calls[0])[0](tg, torch.as_tensor(rc[:, 0]), torch.as_tensor(rc[:, 1]))
    # the counts say how many queries hold an inexact key
    q = texact.query_tensors(tg, rc[:, 0], rc[:, 1])
    assert 0 < int(q.counts[0]) <= len(rc)


def _close(got, want, tol=PRED_TOL):
    want = np.asarray(want, np.float64)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=tol)


def _no_host_prepare(monkeypatch):
    """Make the host views raise: an entry point must not call them."""
    def refuse(*args, **kwargs):
        raise AssertionError("an exact entry point called a host view of the query preparation")

    monkeypatch.setattr(texact, "prepare_exact_queries", refuse)
    monkeypatch.setattr(texact, "_prepare_scattered", refuse)


@pytest.mark.parametrize("index", ["numpy", "int64", "int32"])
@pytest.mark.parametrize("entry", [e for e in CELL_ENTRIES if e not in ("select", "select_fast")])
def test_cell_entry_points_take_numpy_or_tensors(entry, index, monkeypatch):
    jg, tg, rc = pair("101x97_r0.3")
    H, W = tg.shape
    rows = np.concatenate([rc[:300, 0], [-1, H, 2]])
    cols = np.concatenate([rc[:300, 1], [3, 4, W + 1]])
    want = CELL_ENTRIES[entry][1](jg, rows, cols)
    _no_host_prepare(monkeypatch)
    r, c = (rows, cols) if index == "numpy" else (torch.as_tensor(a, dtype=getattr(torch, index)) for a in (rows, cols))
    got = CELL_ENTRIES[entry][0](tg, r, c)
    _close(got, want)
    assert np.isnan(got[-3:]).all()


@pytest.mark.parametrize("form", ["numpy", "float64", "float32"])
@pytest.mark.parametrize("method", ["kriging", "cubic", "bilinear"])
def test_scattered_entry_points_take_numpy_or_tensors(method, form, monkeypatch):
    jg, tg, _ = pair("64x80_r0.1")
    lons, lats = prologue_scattered_queries(AWKWARD, seed=4)
    if form == "float32":
        lons, lats = lons.astype(np.float32).astype(np.float64), lats.astype(np.float32).astype(np.float64)
    want = getattr(jexact, f"exact_{method}_scattered")(jg, lons, lats)
    _no_host_prepare(monkeypatch)
    lo, la = (lons, lats) if form == "numpy" else (torch.as_tensor(a, dtype=getattr(torch, form)) for a in
                                                   (lons.astype(np.float32) if form == "float32" else lons,
                                                    lats.astype(np.float32) if form == "float32" else lats))
    _close(getattr(texact, f"exact_{method}_scattered")(tg, lo, la), want)


def test_selections_never_call_the_host_prepare(monkeypatch):
    # the selections return the host view of the device form, not the
    # host prepare's
    _, tg, rc = pair("64x80_r0.1")
    want = texact.prepare_exact_queries(tg, rc[:, 0], rc[:, 1])
    _no_host_prepare(monkeypatch)
    _fields_equal(texact.exact_select_at_cells(tg, rc[:, 0], rc[:, 1])[4], want)
    _fields_equal(tfast.exact_select_at_cells_fast(tg, rc[:, 0], rc[:, 1])[4], want)


def test_empty_queries():
    _, tg, _ = pair("64x80_r0.1")
    e = torch.zeros(0, dtype=torch.int64)
    q = texact.query_tensors(tg, e, e, fields=ep.CELL_FIELDS)
    assert q.ci.shape == (0,) and q.counts.tolist() == [0, 0] and q.ex_key.shape == (0,)
    assert texact.prepare_exact_queries(tg, e, e).ci.dtype == np.int32
    assert tfast.exact_kriging_at_cells_fast(tg, e, e).shape == (0,)


# ---------------------------------------------------------------------------
# the op and the launch's arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["cell_round", "cell_floor_int32", "scattered"])
def test_opcheck(case):
    _, tg, rc = pair("64x80_r0.1")
    if case == "scattered":
        lons, lats = prologue_scattered_queries(AWKWARD)
        ok = np.isfinite(lons) & np.isfinite(lats)  # opcheck holds NaN unequal to NaN
        a, b, fields, rnd = torch.as_tensor(lons[ok]), torch.as_tensor(lats[ok]), ep.GRID, True
    else:
        dt = torch.int32 if case.endswith("int32") else torch.int64
        a, b = torch.as_tensor(rc[:, 1], dtype=dt), torch.as_tensor(rc[:, 0], dtype=dt)
        fields, rnd = ep.CELL_FIELDS, case == "cell_round"
    torch.library.opcheck(library.exact_prologue,
                          (a, b, ep.geo_of(tg), tg.num_lon, tg.num_lat, rnd, fields, texact.EPS_SCALE))


_CTYPES = {"int": ctypes.c_int, "double": ctypes.c_double, "void*": ctypes.c_void_p, "const void*": ctypes.c_void_p}


def test_ctypes_arguments_follow_the_c_signature():
    src = open(CSRC).read()
    sig = re.search(r"int auvtpu_exact_prologue\(([^)]*)\)", src).group(1)
    params = [re.sub(r"\s+", " ", p.strip()).rsplit(" ", 1) for p in sig.split(",")]
    want = [_CTYPES[t.replace(" *", "*")] if not name.startswith("*") else _CTYPES[t + "*"] for t, name in params]
    names = [name.lstrip("*") for _, name in params]

    class Fake:
        def __init__(self):
            self.calls = []

        def __getattr__(self, attr):
            return self

        def __call__(self, *args):
            self.calls.append(args)
            return 0

    fake = Fake()
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    real_types = [I, I, P, P, I, I, I, D, D, D, D, D, D, D, I, P, P, P, P, P, P, P, P, P, P]
    assert want == real_types, names
    # the wrapper's argtypes are these (read from _lib's source, which needs
    # the built library to run)
    import inspect

    body = inspect.getsource(ep._lib.__wrapped__)
    argtypes = "[I, I, P, P, I, I, I, D, D, D, D, D, D, D, I, P, P, P, P, P, P, P, P, P, P]"
    assert f"auvtpu_exact_prologue.argtypes = {argtypes}" in body
    # and a launch hands each pointer to the parameter of its name
    _, tg, rc = pair("64x80_r0.1")
    a, b = torch.as_tensor(rc[:, 1].copy()), torch.as_tensor(rc[:, 0].copy())
    orig = (ep._lib, ep._stream, torch.cuda.device)
    try:
        ep._lib, ep._stream = (lambda: fake), (lambda dev: None)
        torch.cuda.device = lambda dev: contextlib.nullcontext()
        out = ep.prologue_launch(a, b, ep.geo_of(tg), tg.num_lon, tg.num_lat, False, ep.KEYS | ep.GRID | ep.FLAT,
                                 123.0)
    finally:
        ep._lib, ep._stream, torch.cuda.device = orig
    (args,) = fake.calls
    got = dict(zip(names, args))
    H, W = tg.shape
    assert (got["in_type"], got["round_anchor"], got["n"], got["H"], got["W"], got["fields"]) == (
        1, 0, len(rc), H, W, ep.KEYS | ep.GRID | ep.FLAT)
    assert [got[k] for k in ("min_lon", "max_lon", "min_lat", "max_lat", "lon_step", "lat_step")] == ep.geo_of(tg)
    assert got["eps_scale"] == 123.0 and got["a"] == a.data_ptr() and got["b"] == b.data_ptr()
    for i, k in enumerate(("anchors", "oob", "counts", "keys", "variant")):
        assert got[k] == out[i].data_ptr(), k
    assert got["geo"] is None and got["aligned"] is None
    assert got["xy"] == out[6].data_ptr() and got["flat"] == out[8].data_ptr()
    assert ep.LAUNCHES["exact_prologue"] >= 1
    ep.reset_launches()
