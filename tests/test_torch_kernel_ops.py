"""B2, B4, B5, B6, B11, B12 and B15 as ``torch.library`` custom ops, on the
CPU.

Each op (``auvtpu_torch::topk_full``, ``::topk_idx``, ``::valid_select``,
``::idw_select``, ``::select_krige``, ``::window_krige``, ``::window_idw``)
passes
``torch.library.opcheck``
(schema, fake tensor, AOT dispatch) on small inputs; every public entry
that launches one of these kernels on a card goes through its op (a
logging dispatch mode sees it once) and returns, bit for bit and NaN where
NaN, what the kernel's plain version gives called directly, with no launch
counted; ``utils.debug_mode`` names the op that makes a NaN from no NaN;
``torch.export`` traces a module calling two of them into a graph holding
both ops that equals the live call; and no ctypes launch in
``auvtpu_torch/kernels/`` lies outside an op's CUDA implementation.

The JAX package under its own ``utils.debug.debug_mode`` (Pallas in
interpret mode, as its tests run it) makes B11's NaN and raises at it."""

import ast
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from auvtpu_torch.config import Extent, IDWConfig
from auvtpu_torch.grid import RegularGrid
from auvtpu_torch.kernels import library
from auvtpu_torch.kernels import scattered_select as ss
from auvtpu_torch.kernels import valid_select as vs
from auvtpu_torch.kernels import window_fill as wf
from auvtpu_torch.masking import mask_grid
from auvtpu_torch.ops import fill_kriging, krige_planes
from auvtpu_torch.ops import packs as tp
from auvtpu_torch.synthetic import shelf_seamount
from auvtpu_torch.utils import debug_mode

torch.set_num_threads(1)

H, W = 24, 20
EXT = Extent(0.0, W - 1.0, 0.0, H - 1.0)
KERNELS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "auvtpu_torch", "kernels")
OPS = ("topk_full", "topk_idx", "valid_select", "idw_select", "select_krige")
CHECKED = OPS + ("window_krige", "window_idw")


def _grid(kind: str = "masked") -> RegularGrid:
    elev = shelf_seamount(H, W)
    if kind == "masked":
        elev = mask_grid(elev, 0.3, seed=5)[0]
    return RegularGrid.from_nan_array(elev, EXT, device="cpu")


def _queries(n: int = 200, seed: int = 3):
    rng = np.random.default_rng(seed)
    lons = rng.uniform(-1.0, W, n).astype(np.float32)
    lats = rng.uniform(-1.0, H, n).astype(np.float32)
    # nodes, half-nodes, a NaN and an out-of-grid query
    lons[:6] = [3.0, 4.5, float("nan"), W + 2.0, 0.0, W - 1.0]
    lats[:6] = [5.0, 6.5, 4.0, 3.0, 0.0, H - 1.0]
    return torch.from_numpy(lons), torch.from_numpy(lats)


def _same(got, want) -> None:
    """Bit-equal, NaN where NaN, shape and dtype equal."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


class _Log(TorchDispatchMode):
    """Records every ``auvtpu_torch::`` op a call runs, with its inputs and
    output."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == library.NAMESPACE:
            self.calls.append((func.__name__.split(".")[0], args, out))
        return out


def _launches() -> list:
    return [*wf.LAUNCHES.values(), *ss.LAUNCHES.values()]


def _op_args(name: str):
    """Small CPU inputs of each op, as its wrapper builds them."""
    g = _grid()
    lons, lats = _queries(40)
    if name in ("topk_full", "topk_idx"):
        return (g.elev, g.valid, 4, 3, "reference")
    _, _, _, _, _, cell, fx, fy = ss.prologue(g, lons, lats)
    if name == "valid_select":
        pack = tp.build_valid16_pack(_grid("valid"))
        return (pack, cell, fx, fy, ss.table(tp.VALID16_OFFSETS, 16, 2, "dy", "cpu"), 16, 4, True, 0.5, 4.0)
    offs = tp.window_offsets(2)
    pack = tp.StencilPack(g).window
    tab = ss.table(offs, 32, 2, "dy", "cpu")
    # queries inside the grid: opcheck holds NaN unequal to NaN, and B6,
    # B11, B12 and B15 write NaN outside it (B6, B12 and B15 also where no
    # tap is found: the grid's fill keeps a tap in every window of these
    # queries)
    qlon, qlat = lons[6:].clamp(0.0, W - 1.0).contiguous(), lats[6:].clamp(0.0, H - 1.0).contiguous()
    geo = ss._krige_geo(g, "reference")
    if name == "idw_select":
        return (pack, tab, qlon, qlat, ss._NO_TAPS, geo, 32, W, H, 8, 4.0, IDWConfig().eps)
    if name == "window_idw":
        return (pack, ss.table(offs, 32, 2, "dx", "cpu"), qlon, qlat, ss._NO_TAPS, geo, 32, 2, W, H, 8, 3.0,
                IDWConfig(k=8, power=3.0).eps)
    vario = [library.variogram_tensor((0.5, 80.0, 12.0), qlon)]
    if name == "window_krige":
        return (pack, ss.table(offs, 32, 2, "dx", "cpu"), qlon, qlat, vario, ss._NO_TAPS, geo, 32, 2, W, H,
                "spherical")
    return (pack, tab, qlon, qlat, vario, ss._NO_TAPS, geo, 32, 2, W, H, "spherical", 4.0)


@pytest.mark.parametrize("name", CHECKED)
def test_opcheck(name):
    args = _op_args(name)
    if name in ("idw_select", "window_krige", "window_idw"):
        assert not bool(torch.isnan(getattr(library, name)(*args)).any())
    torch.library.opcheck(getattr(library, name), args)


def _entries():
    """(entry name, op it must run, call, the plain version called
    directly): each public entry of the seven kernels on one CPU grid."""
    g, gv = _grid(), _grid("valid")
    lons, lats = _queries()
    p16 = tp.build_valid16_pack(gv)
    win = tp.StencilPack(g).window
    offs, thresh = tp.window_offsets(2), 4.0
    vp = tuple(torch.tensor(v) for v in (0.5, 80.0, 12.0))  # fitted parameters, three 0-d tensors

    return [
        ("kriging_valid_t", "select_krige", lambda: vs.kriging_valid_t(p16, gv, lons, lats),
         lambda: ss.select_krige_ref(p16, 16, tp.VALID16_OFFSETS, 2, gv, lons, lats)[0]),
        ("kriging_valid_t fitted spherical", "select_krige",
         lambda: vs.kriging_valid_t(p16, gv, lons, lats, vparams=vp, model="spherical"),
         lambda: ss.select_krige_ref(p16, 16, tp.VALID16_OFFSETS, 2, gv, lons, lats, vparams=vp,
                                     model="spherical")[0]),
        ("packed_kriging_t", "select_krige", lambda: vs.packed_kriging_t(win, g, lons, lats),
         lambda: ss.select_krige_ref(win, 32, offs, 2, g, lons, lats)[0]),
        ("packed_kriging_t gaussian numbers", "select_krige",  # parameters not exact in float32
         lambda: vs.packed_kriging_t(win, g, lons, lats, vparams=(0.1, 150.3, 6.7), model="gaussian"),
         lambda: ss.select_krige_ref(win, 32, offs, 2, g, lons, lats, vparams=(0.1, 150.3, 6.7),
                                     model="gaussian")[0]),
        ("packed_kriging_t resolve centered", "select_krige",
         lambda: vs.packed_kriging_t(win, g, lons, lats, convention="centered", resolve_thresh=thresh)[:2],
         lambda: (lambda o: (o[0], o[1] > 0.5))(
             ss.select_krige_ref(win, 32, offs, 2, g, lons, lats, convention="centered", resolve_thresh=thresh))),
        ("packed_idw_t resolve", "idw_select",
         lambda: vs.packed_idw_t(win, g, lons, lats, k=8, resolve_thresh=thresh)[:2],
         lambda: (lambda o: (o[0], o[1] > 0.5))(ss.idw_select_ref(win, 32, offs, 2, g, lons, lats, k=8,
                                                                  resolve_thresh=thresh))),
        ("packed_idw_t centered k=3", "idw_select",
         lambda: vs.packed_idw_t(win, g, lons, lats, k=3, convention="centered"),
         lambda: ss.idw_select_ref(win, 32, offs, 2, g, lons, lats, k=3, convention="centered")[0]),
        ("packed_idw_fused power 3 centered", "window_idw",
         lambda: ss.packed_idw_fused(win, g, lons, lats, k=8, power=3.0, convention="centered"),
         lambda: ss.window_idw_ref(win, 32, offs, 2, g, lons, lats, k=8, power=3.0, convention="centered")),
        ("packed_kriging_fused fitted gaussian", "window_krige",
         lambda: ss.packed_kriging_fused(win, g, lons, lats, vparams=vp, model="gaussian"),
         lambda: ss.window_krige_ref(win, 32, offs, 2, g, lons, lats, vparams=vp, model="gaussian")),
        ("valid_select_t", "valid_select", lambda: vs.valid_select_t(p16, gv, lons, lats),
         lambda cell, fx, fy, tab, P, k, emit_d2, half, resolve: ss.select_ref(
             p16, P, cell, fx, fy, tab, mode="rows_t", k=k, emit_d2=emit_d2, half=half, resolve_thresh=resolve)),
        ("topk_full", "topk_full", lambda: wf.topk_full(g, k=4, max_radius=3),
         lambda: wf.topk_full_ref(g, k=4, max_radius=3)),
        ("topk_idx", "topk_idx", lambda: wf.topk_idx(g, k=5, max_radius=3, convention="centered"),
         lambda: wf.topk_idx_ref(g, k=5, max_radius=3, convention="centered")),
        ("fill_kriging select", "topk_full", lambda: fill_kriging(g, max_radius=3, backend="select"),
         lambda: krige_planes(g, wf.topk_full_ref(g, k=4, max_radius=3))),
    ]


def _flat(x) -> list:
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _flat(v)]
    return [t for v in x for t in _flat(v)]


@pytest.mark.parametrize("entry", range(13), ids=[e[0] for e in _entries()])
def test_entry_runs_its_op_and_equals_the_plain_version(entry):
    label, op, call, plain = _entries()[entry]
    wf.reset_launches()
    ss.reset_launches()
    with _Log() as log:
        got = call()
    assert [c[0] for c in log.calls] == [op], (label, log.calls)
    if op == "valid_select":
        # the op's rows against the kernel's plain version on the same inputs
        _, args, out = log.calls[0]
        got, want = out, plain(*args[1:])
    else:
        want = plain()
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same(a, b)
    assert not any(_launches())


def test_valid_select_t_dict_is_built_from_the_ops_rows():
    # the select dict over the op's rows equals the one over the plain rows
    gv = _grid("valid")
    lons, lats = _queries()
    p16 = tp.build_valid16_pack(gv)
    got = vs.valid_select_t(p16, gv, lons, lats)
    _, _, _, _, _, cell, fx, fy = ss.prologue(gv, lons, lats)
    rows = ss.select_ref(p16, 16, cell, fx, fy, ss.table(tp.VALID16_OFFSETS, 16, 2, "dy", "cpu"), mode="rows_t",
                         k=4, emit_d2=True)
    _same(got["val"], rows[1:5].T)
    _same(got["d2"], rows[5:9].T)
    assert torch.equal(got["found"], rows[0].to(torch.int32))


def _covered(dtype=torch.float32) -> RegularGrid:
    e = np.sin(np.arange(H * W, dtype=np.float64).reshape(H, W) / 7.0) * 100.0 - 1000.0
    return RegularGrid.dense(e, EXT, dtype=dtype, device="cpu")


def test_debug_mode_passes_the_five_ops_on_a_covered_grid():
    g = _covered()
    lons, lats = (q.clamp(0.0, float(n - 1)) for q, n in zip(_queries(300, 9), (W, H)))
    lons, lats = torch.nan_to_num(lons, nan=1.0), torch.nan_to_num(lats, nan=1.0)
    p16 = tp.build_valid16_pack(g)
    win = tp.StencilPack(g).window
    with debug_mode(disable_jit=True), _Log() as log:
        outs = [vs.kriging_valid_t(p16, g, lons, lats), vs.packed_idw_t(win, g, lons, lats),
                vs.valid_select_t(p16, g, lons, lats)["val"], fill_kriging(g, max_radius=3, backend="select"),
                wf.topk_idx(g, k=4, max_radius=3)[1][3]]
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    assert sorted(c[0] for c in log.calls) == sorted(OPS)


def _inf_grid(g: RegularGrid) -> RegularGrid:
    """``g`` with 1e27 at cell (5, 6) and -inf beside it at (5, 7)."""
    e = g.elev.clone()
    e[5, 6], e[5, 7] = 1e27, -float("inf")
    return RegularGrid(e, g.valid, g.min_lon, g.max_lon, g.min_lat, g.max_lat)


# the query at the centre of cell (5, 6) and one in the open
INF_LONS, INF_LATS = [6.5, 3.25], [5.5, 9.75]


def _nan_cases():
    """The NaNs a kernel makes from no NaN: B11 and B12 at a query outside
    the grid (they write NaN as 'no data'), and B6 at a query on the centre of a
    tap holding 1e27 beside a tap holding -inf: w = 1/(0 + eps) = 1e12, so
    w*v overflows to +inf, and +inf - inf is NaN.  (A +inf in the pack
    itself reads as the sentinel, no tap, so +inf enters the sums only as
    such a product.)"""
    g = _covered()
    gi = _inf_grid(g)
    return [
        ("select_krige", lambda: vs.kriging_valid_t(tp.build_valid16_pack(g), g, torch.tensor([3.25, W + 5.0]),
                                                     torch.tensor([4.5, 2.0]))),
        ("idw_select", lambda: vs.packed_idw_t(tp.StencilPack(gi).window, gi, torch.tensor(INF_LONS),
                                               torch.tensor(INF_LATS), k=8)),
        ("window_krige", lambda: ss.packed_kriging_fused(tp.StencilPack(g).window, g, torch.tensor([3.25, W + 5.0]),
                                                         torch.tensor([4.5, 2.0]))),
    ]


@pytest.mark.parametrize("case", [0, 1, 2], ids=["select_krige", "idw_select", "window_krige"])
def test_debug_mode_names_the_op_that_made_a_nan(case):
    op, call = _nan_cases()[case]
    out = call()
    assert bool(torch.isnan(out).any())  # without the mode: the NaN, no raise
    with debug_mode(), pytest.raises(FloatingPointError, match=f"auvtpu_torch.{op}"):
        call()


def test_jax_package_raises_at_the_oob_kriging_nan():
    # the JAX package's debug_mode (jax_debug_nans), pallas_kriging_valid in
    # interpret mode: the out-of-grid query's NaN where the port's is, and a
    # raise.  (On B6's input the JAX package on XLA:CPU returns -inf at the
    # query, no NaN: there is no JAX NaN to hold that one to.)
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from auvtpu.grid import RegularGrid as JGrid
    from auvtpu.ops import packs as jp
    from auvtpu.pallas import pallas_kriging_valid
    from auvtpu.utils.debug import debug_mode as jax_debug_mode

    g = _covered()
    jg = JGrid(jnp.asarray(g.elev.numpy()), jnp.asarray(g.valid.numpy()), EXT.min_lon, EXT.max_lon, EXT.min_lat,
               EXT.max_lat)
    p16 = jp.build_valid16_pack(jg)
    want = _nan_cases()[0][1]()
    with pltpu.force_tpu_interpret_mode():
        call = lambda: pallas_kriging_valid(p16, jg, np.float32([3.25, W + 5.0]), np.float32([4.5, 2.0]), tile_n=128)
        np.testing.assert_array_equal(np.isnan(np.asarray(call())), torch.isnan(want).numpy())
        with jax_debug_mode(), pytest.raises(FloatingPointError):
            call()


class _Served(torch.nn.Module):
    def __init__(self, gv, g):
        super().__init__()
        self.gv, self.g = gv, g
        self.register_buffer("p16", tp.build_valid16_pack(gv))
        self.register_buffer("win", tp.StencilPack(g).window)

    def forward(self, lons, lats):
        return (vs.kriging_valid_t(self.p16, self.gv, lons, lats),
                vs.packed_idw_t(self.win, self.g, lons, lats, k=8))


def test_export_holds_both_ops_and_equals_the_live_call():
    from auvtpu_torch import serve

    m = _Served(_grid("valid"), _grid())
    lons, lats = _queries(64)
    program = torch.export.export(m, (lons, lats), strict=False)
    assert serve.ops_in(program) == ["auvtpu_torch::idw_select", "auvtpu_torch::select_krige"]
    a, b = _queries(64, seed=11)
    for got, want in zip(program.module()(a, b), m(a, b)):
        _same(got, want)


def _launch_sites():
    """(file, function, kernel entry) of every ``_lib().auvtpu_<x>(`` call
    in the kernels' modules, but for the build, error-string and attribute
    helpers."""
    out = []
    for fname in sorted(os.listdir(KERNELS)):
        if not fname.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(KERNELS, fname)).read())
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Call) and getattr(node.func.value.func, "id", "") == "_lib"
                        and node.func.attr.startswith("auvtpu_")
                        and not node.func.attr.endswith(("error_string", "_attributes"))):
                    out.append((fname, fn.name, node.func.attr))
    return out


def test_every_launch_lies_in_an_ops_cuda_implementation():
    # each launching function is called from one place: the CUDA
    # implementation (a function registered with _op) in library.py
    sites = _launch_sites()
    assert len({s[2] for s in sites}) == 20, sites  # B1-B19, one C entry each, B10 a second for its binned form
    lib_tree = ast.parse(open(os.path.join(KERNELS, "library.py")).read())
    cuda_impls = {kw.value.id for node in ast.walk(lib_tree)
                  if isinstance(node, ast.Call) and getattr(node.func, "id", "") == "_op"
                  for kw in node.keywords if kw.arg == "cuda"}
    callers = {}
    for fname in sorted(os.listdir(KERNELS)):
        if fname.endswith(".py"):
            for fn in ast.walk(ast.parse(open(os.path.join(KERNELS, fname)).read())):
                if isinstance(fn, ast.FunctionDef):
                    for node in ast.walk(fn):
                        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                            callers.setdefault(node.func.id, set()).add((fname, fn.name))
    for fname, fn, entry in sites:
        assert callers.get(fn), f"{fname}:{fn} ({entry}) is called from nowhere"
        assert all(f == "library.py" and c in cuda_impls for f, c in callers[fn]), (fn, entry, callers[fn])
