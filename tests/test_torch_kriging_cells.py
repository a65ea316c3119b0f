"""B19, kriging at a list of cells (``auvtpu_torch::kriging_cells``), on the
CPU.

The op's CPU implementation is B1's plain version's whole plane and then
the cells, NaN at a cell outside the grid; it passes ``opcheck`` and its
fake gives the cells' shape.  B19's scan (validity alone, table rows in
batches with an in-grid test in place of B1's halo; the found elevations
after, the scan again where one is NaN) written out in Python takes the
plain selection's table rows at every cell, and B1's where valid cells hold
NaN.
The wrapper's ctypes argument list follows the C signature, B1 and B19
take their parameters from one helper, the launch refuses a CPU grid, and
``kriging_at_cells`` keeps its plain plane-then-gather path on the CPU,
NaN at a cell outside the grid on every backend as B19 answers there.
The kernel itself is held to B1 bit for bit by ``tests/test_torch_cuda.py``
on a card."""

import ctypes
import inspect
import os
import re

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from auvtpu_torch.config import Extent
from auvtpu_torch.grid import RegularGrid
from auvtpu_torch.kernels import library
from auvtpu_torch.kernels import window_fill as wf
from auvtpu_torch.masking import mask_grid
from auvtpu_torch.ops import dense
from auvtpu_torch.synthetic import shelf_seamount
from auvtpu_torch.tables import sorted_offsets
from auvtpu_torch.utils import profiling

torch.set_num_threads(1)

SHAPES = [(48, 64), (37, 50)]  # an odd row count
MODELS = {
    "exponential": (1.0, 100.0, 10.0),
    "linear": (1.0, 5.0, 10.0),
    "spherical": (0.5, 80.0, 12.0),
    "gaussian": (2.0, 150.0, 6.0),
}


def _grid(h: int, w: int, removal: float = 0.2, seed: int = 9) -> RegularGrid:
    elev = mask_grid(shelf_seamount(h, w), removal, seed=seed)[0]
    return RegularGrid.from_nan_array(elev, Extent(0.0, w - 1.0, 0.0, h - 1.0), device="cpu")


def _cells(h: int, w: int, share: float, seed: int = 4):
    """A share of the grid's cells in random order, with duplicates and the
    four corners and an edge cell added."""
    g = torch.Generator().manual_seed(seed)
    flat = torch.randperm(h * w, generator=g)[: max(1, int(share * h * w))]
    flat = torch.cat([flat, flat[:3], torch.tensor([0, w - 1, (h - 1) * w, h * w - 1, w * (h // 2)])])
    return flat // w, flat % w


def _same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))


@pytest.mark.parametrize("share", [0.02, 0.5, 1.0])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_op_on_the_cpu_is_the_plain_plane_then_the_cells(shape, share):
    h, w = shape
    g = _grid(h, w)
    rows, cols = _cells(h, w, share)
    for radius, convention in ((3, "reference"), (10, "centered")):
        for model, vp in MODELS.items():
            for solver in ("gj", "lu"):
                kw = dict(max_radius=radius, convention=convention, vparams=vp, model=model, solver=solver)
                plane = wf.fill_kriging_fused_ref(g, **kw)
                got = wf.kriging_at_cells_fused(g, rows, cols, **kw)
                _same(got, plane[rows, cols])
                _same(got, wf.kriging_at_cells_fused_ref(g, rows, cols, **kw))


def test_cells_outside_the_grid_get_nan_and_an_empty_list_an_empty_answer():
    g = _grid(24, 20)
    rows = torch.tensor([-1, 0, 24, 3, 5, 2**40, -(2**40)])
    cols = torch.tensor([0, -1, 3, 20, 7, 1, 1])
    got = wf.kriging_at_cells_fused(g, rows, cols)
    want = torch.full((7,), float("nan"))
    want[4] = wf.fill_kriging_fused_ref(g)[5, 7]
    _same(got, want)
    empty = torch.zeros(0, dtype=torch.int64)
    assert wf.kriging_at_cells_fused(g, empty, empty).shape == (0,)
    # the cells' shape is the answer's; numpy and int32 cells are converted
    r2, c2 = torch.tensor([[1, 2], [3, 4]]), torch.tensor([[5, 6], [7, 8]])
    _same(wf.kriging_at_cells_fused(g, r2, c2), wf.fill_kriging_fused_ref(g)[r2, c2])
    _same(wf.kriging_at_cells_fused(g, r2.numpy().astype(np.int32), c2.int()),
          wf.fill_kriging_fused_ref(g)[r2, c2])


def _b19_scan(elev, valid, r, c, tab, batch=4):
    """B19's scan of one cell, as the kernel runs it: table rows in batches
    of ``batch``, each row's cell read with an in-grid test, valid where
    valid > 0.5; the first four valid rows, then their elevations, and where
    one is NaN the scan again with a cell valid only where its elevation is
    not NaN as well (B1's halo tile)."""
    H, W = elev.shape

    def scan(ok):
        found = []
        for t0 in range(0, len(tab), batch):
            if len(found) >= 4:
                break
            hits = []
            for t in range(t0, min(t0 + batch, len(tab))):
                gr, gc = r + tab[t][1], c + tab[t][0]
                hits.append(0 <= gr < H and 0 <= gc < W and ok(gr, gc))
            for b, hit in enumerate(hits):
                if len(found) < 4 and hit:
                    found.append(t0 + b)
        return found

    found = scan(lambda gr, gc: valid[gr, gc] > 0.5)
    if any(np.isnan(elev[r + tab[t][1], c + tab[t][0]]) for t in found):
        found = scan(lambda gr, gc: valid[gr, gc] > 0.5 and not np.isnan(elev[gr, gc]))
    return found


def _b1_first4(elev, valid, r, c, tab):
    """B1's selection at one cell: the first four table rows whose cell is
    in the grid, valid > 0.5 and not NaN (its halo tile holds the rest as
    NaN)."""
    H, W = elev.shape
    found = []
    for t, (dx, dy) in enumerate(tab):
        gr, gc = r + dy, c + dx
        if 0 <= gr < H and 0 <= gc < W and valid[gr, gc] > 0.5 and not np.isnan(elev[gr, gc]) and len(found) < 4:
            found.append(t)
    return found


@pytest.mark.parametrize("convention", ["reference", "centered"])
def test_the_kernels_scan_written_out_takes_the_plain_selection(convention):
    # B19's scan against window_topk_idx, the whole-plane selection B1's
    # plain version makes, at every cell of a 30 % masked grid at radius 3
    # (cells near the edges find fewer than four); then with every fifth
    # valid cell's elevation NaN, against B1's own rule
    g = _grid(21, 17, removal=0.3)
    elev, valid = g.elev.numpy(), g.valid.numpy()
    dxs, dys, _ = sorted_offsets(3, convention)
    tab = list(zip(dxs.tolist(), dys.tolist()))
    cnt, idx = dense.window_topk_idx(g, k=4, max_radius=3, convention=convention)
    nan_elev = elev.copy()
    nan_elev.reshape(-1)[::5] = np.nan
    for r in range(21):
        for c in range(17):
            want = [int(p[r, c]) for p in idx[: int(cnt[r, c])]]
            assert _b19_scan(elev, valid, r, c, tab) == want == _b1_first4(elev, valid, r, c, tab), (r, c)
            assert _b19_scan(nan_elev, valid, r, c, tab) == _b1_first4(nan_elev, valid, r, c, tab), (r, c)


def test_opcheck_and_the_fake():
    g = _grid(24, 20)
    rows, cols = _cells(24, 20, 0.3)
    vario = library.variogram_tensor(None, g.elev)
    geo = [g.min_lon, g.max_lon, g.min_lat, g.max_lat, g.lat_step, g.lon_step, 0.0, 0.0]
    args = (g.elev, g.valid, rows, cols, vario, geo, 5, "reference", "exponential", "gj")
    torch.library.opcheck(library.kriging_cells, args)
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) if torch.is_tensor(t) else t for t in args]
        out = library.kriging_cells(*fake)
    assert out.shape == rows.shape and out.dtype == torch.float32


def test_ctypes_arguments_follow_the_c_signature():
    src = open(os.path.join(os.path.dirname(library.__file__), "..", "csrc", "window_fill.cu")).read()
    sig = re.search(r"int auvtpu_kriging_cells\(([^)]*)\)", src).group(1)
    letter = {"void*": "P", "int": "I", "float*": "FP", "long long": "L"}
    params = [re.sub(r"\s+", " ", p.strip()).replace("const ", "").replace(" *", "* ").rsplit(" ", 1)
              for p in sig.split(",")]
    want = "[" + ", ".join(letter[t] for t, _ in params) + "]"
    body = inspect.getsource(wf._lib.__wrapped__)
    assert f"auvtpu_kriging_cells.argtypes = {want}" in body
    assert "L = ctypes.c_longlong" in body and "FP = ctypes.POINTER(ctypes.c_float)" in body
    assert [n for _, n in params][16:19] == ["rows", "cols", "n"]
    assert ctypes.sizeof(ctypes.c_longlong) == 8


def test_the_launch_refuses_a_cpu_grid():
    g = _grid(24, 20)
    rows, cols = _cells(24, 20, 0.1)
    with pytest.raises(ValueError, match="CUDA grid"):
        wf.kriging_cells_launch(g, rows, cols, None, max_radius=5, convention="reference", model="exponential",
                                solver="gj")
    assert wf.LAUNCHES["kriging_at_cells_fused"] == 0


@pytest.mark.parametrize("share", [0.05, 0.99])
def test_kriging_at_cells_on_the_cpu_keeps_the_plane_and_the_gather(share):
    # the CPU path solves the whole plane whatever the share (the fused
    # backend's wrapper runs its plain version there)
    g = _grid(48, 64)
    rows, cols = _cells(48, 64, share)
    profiling.reset("fill")
    wf.reset_launches()
    out = dense.kriging_at_cells(g, rows, cols, backend="fused")
    assert dict(dense.FILL) == {"cells_solved": 48 * 64, "cells_returned": rows.numel()}
    _same(out, wf.fill_kriging_fused_ref(g)[rows, cols])
    assert wf.LAUNCHES["kriging_at_cells_fused"] == 0


@pytest.mark.parametrize("backend", ["fused", "select", "torch"])
def test_cells_outside_the_grid_read_nan_on_every_backend(backend):
    # the plane-then-gather path answers a cell outside the grid as B19
    # does: NaN, never a wrapped read of another row, never an error
    g = _grid(24, 20)
    rows = torch.tensor([-1, 0, 24, 3, 5, 2**40, 23, 0])
    cols = torch.tensor([0, -1, 3, 20, 7, 1, 19, 0])
    got = dense.kriging_at_cells(g, rows, cols, backend=backend)
    plane = dense.fill_kriging(g, backend=backend)
    want = torch.full((8,), float("nan"), dtype=plane.dtype)
    want[4], want[6], want[7] = plane[5, 7], plane[23, 19], plane[0, 0]
    _same(got, want)
    _same(dense.plane_at_cells(plane, rows.numpy(), cols.int()), want)
    assert dense.plane_at_cells(plane[:0], rows, cols).isnan().all()


def test_b1_and_b19_take_their_parameters_from_one_helper():
    # the ops hand the variogram over as one (3,) tensor: read where it
    # lies, by address, a copy where it is not float32; the fixed
    # parameters are made once per geometry
    g = _grid(24, 20)
    vario = torch.tensor([0.5, 80.0, 12.0])
    geo, host, ptrs, keep = wf._kriging_params(g, vario, "reference", 0, 0, None, torch.device("cpu"))
    p = vario.data_ptr()
    assert ptrs == [p, p + 4, p + 8] and keep[0] is vario and list(host) == [0.0, 0.0, 0.0]
    again, *_ = wf._kriging_params(g, vario, "reference", 0, 0, None, torch.device("cpu"))
    assert again is geo
    _, _, ptrs, keep = wf._kriging_params(g, vario.double(), "reference", 0, 0, None, torch.device("cpu"))
    assert keep[0].dtype == torch.float32 and ptrs[0] == keep[0].data_ptr()
    assert [ctypes.c_float.from_address(q).value for q in ptrs] == [0.5, 80.0, 12.0]
    with pytest.raises(ValueError, match=r"\(3,\) tensor"):
        wf._kriging_params(g, torch.ones(4), "reference", 0, 0, None, torch.device("cpu"))
    src = inspect.getsource(wf.kriging_cells_launch) + inspect.getsource(wf.kriging_launch)
    assert src.count("_kriging_params(grid, vparams, convention, row0, col0, steps, dev)") == 2
