"""The port's serving artifacts (auvtpu_torch.serve) on the CPU: each of the
five exports, loaded fresh, equals the port's live call exactly (NaN in the
same places), and the live call holds to the JAX package's at the bar its
own test sets (fills rtol 1e-5/atol 1e-3, kriging 1e-4/0.05; packed kriging
1e-4/0.1 and IDW 1e-5/1e-2; the learned fill 1e-5 x max |elev| at f32,
0.01 x the tile's std at bf16).  The mission pair reproduces
``BandRouter.prepare`` and its resampler bit for bit, as tests/test_serve.py
holds the JAX pair.  The programs hold the ``auvtpu_torch::`` ops, an
artifact refuses an input on another device, and tracing leaves the caches
that live calls read holding real tensors.  The artifacts on the card are
tests/test_torch_cuda.py's (that machine has no JAX)."""

import pathlib

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import is_fake

from auvtpu.config import Extent as JExtent
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import fill_idw as j_fill_idw
from auvtpu.ops import fill_kriging as j_fill_kriging
from auvtpu.ops import fill_window_mean as j_fill_window_mean
from auvtpu.ops import packs as jp
from auvtpu.synthetic import shelf_seamount

from auvtpu_torch import learned as tl
from auvtpu_torch import serve
from auvtpu_torch.convert import grid_from_arrays
from auvtpu_torch.kernels import band_resample as kb
from auvtpu_torch.kernels import library
from auvtpu_torch.kernels import scattered_select as ss
from auvtpu_torch.kernels import window_fill as wf
from auvtpu_torch.ops import band as tb
from auvtpu_torch.ops import fill_idw, fill_kriging, fill_window_mean
from auvtpu_torch.ops.packs import StencilPack

torch.set_num_threads(1)

H, W = 48, 64
EXT = (0.0, W - 1.0, 0.0, H - 1.0)
CHECKPOINT = str(pathlib.Path(__file__).resolve().parent.parent / "results" / "learned_mid_atlantic_w16d2.npz")


def _grids(shape=(H, W), seed=6, removal=0.12, device="cpu"):
    h, w = shape
    elev, _, _ = mask_grid(shelf_seamount(h, w), removal, seed=seed)
    jg = JGrid.from_nan_array(elev, JExtent(0.0, w - 1.0, 0.0, h - 1.0))
    g = grid_from_arrays(np.asarray(jg.elev), np.asarray(jg.valid), jg.min_lon, jg.max_lon, jg.min_lat, jg.max_lat,
                         device)
    return jg, g


@pytest.fixture(scope="module")
def grids():
    return _grids()


def _nan_equal(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(a[~torch.isnan(a)], b[~torch.isnan(b)])


def _close(got, want, rtol, atol):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


@pytest.mark.parametrize("method,op,bar", [
    ("kriging", "kriging_fill", (1e-4, 0.05)),
    ("idw", "window_fill", (1e-5, 1e-3)),
    ("window_mean", "window_fill", (1e-5, 1e-3)),
])
def test_export_fill_equals_live(grids, tmp_path, method, op, bar):
    jg, g = grids
    path = str(tmp_path / f"{method}.pt2")
    assert serve.export_fill(path, (H, W), extent=EXT, method=method, max_radius=5, device="cpu") > 0
    meta = serve.read_meta(path)
    assert meta["ops"] == [f"auvtpu_torch::{op}"] and meta["device"] == "cpu" and meta["backend"] == "fused"
    got = serve.load_exported(path)(g.elev, g.valid)
    live, jfn = {"kriging": (fill_kriging, j_fill_kriging), "idw": (fill_idw, j_fill_idw),
                 "window_mean": (fill_window_mean, j_fill_window_mean)}[method]
    want = live(g, max_radius=5)
    assert _nan_equal(got, want)
    _close(want, jfn(jg, max_radius=5), *bar)


def test_export_fill_with_fitted_parameters_and_centred(grids, tmp_path):
    jg, g = grids
    vp = (0.5, 80.0, 12.0)
    path = str(tmp_path / "k.pt2")
    serve.export_fill(path, (H, W), extent=EXT, vparams=vp, convention="centered", max_radius=6, device="cpu")
    got = serve.load_exported(path)(g.elev.numpy(), g.valid.numpy())  # numpy inputs are CPU inputs
    want = fill_kriging(g, vparams=vp, convention="centered", max_radius=6)
    assert _nan_equal(got, want)
    _close(want, j_fill_kriging(jg, vparams=vp, convention="centered", max_radius=6), 1e-4, 0.05)


@pytest.mark.parametrize("method", ["kriging", "idw"])
def test_export_scattered_equals_live(tmp_path, method):
    jg, g = _grids((40, 48), seed=8, removal=0.1)
    sp, jsp = StencilPack(g, window_radius=2), jp.StencilPack(jg, window_radius=2)
    rng = np.random.RandomState(3)
    lons = rng.uniform(-1.0, 48.0, 500).astype(np.float32)
    lats = rng.uniform(-1.0, 40.0, 500).astype(np.float32)
    ext = (0.0, 47.0, 0.0, 39.0)
    # kriging: B12, B7's selection and the solve in one op; idw: B15, B7's
    # selection, the weights and the quotient in one op, at power 2 and 3
    for power in (2.0,) if method == "kriging" else (2.0, 3.0):
        path = str(tmp_path / f"s{power:g}.pt2")
        assert serve.export_scattered(path, (40, 48), 500, extent=ext, method=method, power=power,
                                      device="cpu") > 0
        op = "window_krige" if method == "kriging" else "window_idw"
        assert serve.read_meta(path)["ops"] == [f"auvtpu_torch::{op}"]
        graph = torch.export.load(path).graph
        assert sum(n.op == "call_function" and str(n.target) == f"auvtpu_torch.{op}.default"
                   for n in graph.nodes) == 1
        got = serve.load_exported_scattered(path)(sp.window, g.elev, g.valid, lons, lats)
        if method == "kriging":
            want = ss.packed_kriging_fused(sp.window, g, lons, lats)
            _close(want, jp.packed_kriging(jsp.window, jg, lons, lats), 1e-4, 0.1)
        else:
            want = ss.packed_idw_fused(sp.window, g, lons, lats, k=8, power=power)
            _close(want, jp.packed_idw(jsp.window, jg, lons, lats, k=8, power=power), 1e-5, 1e-2)
        assert _nan_equal(got, want)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_export_learned_equals_live(tmp_path, compute):
    from auvtpu import learned as jl

    jg, g = _grids((40, 48), seed=8, removal=0.1)
    params, width, depth = tl.load_params(CHECKPOINT, device="cpu")
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[compute]
    path = str(tmp_path / "l.pt2")
    serve.export_learned(path, (40, 48), params, extent=(0.0, 47.0, 0.0, 39.0), width=width, depth=depth,
                         compute_dtype=dt, device="cpu")
    assert serve.read_meta(path)["ops"] == ["auvtpu_torch::window_fill"]
    got = serve.load_exported(path)(g.elev, g.valid)
    want = tl.fill_learned(g, params, width=width, depth=depth, compute_dtype=dt)
    assert _nan_equal(got, want)
    if compute == "bf16":  # the JAX package's fill is bf16: tests/test_torch_learned.py's bar
        ref = np.asarray(jl.fill_learned(jg, jl.load_params(CHECKPOINT)[0], width=width, depth=depth))
        std = float(tl._normalize(g.elev[None], g.valid[None])[2].max())
        _close(want, ref, 0.0, 0.01 * std)


def _mission(max_bands):
    _, g = _grids((192, 256), seed=9, removal=0.1)
    t = np.linspace(0, 1, 1024)
    rng = np.random.default_rng(0)
    lons = np.clip(1.0 + t * 253 + rng.normal(0, 0.05, t.size), 0.5, 254.5).astype(np.float32)
    lats = np.clip(1.0 + t * 189 + 2 * np.sin(t * 20 * np.pi) + rng.normal(0, 0.05, t.size), 0.5, 190.5).astype(
        np.float32)
    router = tb.BandRouter(g, chunk=128, win_rows=32, win_cols=128, max_bands=max_bands)
    return g, lons, lats, router, router.prepare(lons, lats)


@pytest.mark.parametrize("max_bands", [3, 1], ids=["atlas", "band"])
def test_export_mission_pair_reproduces_the_router(tmp_path, max_bands):
    g, lons, lats, router, out = _mission(max_bands)
    ext = (0.0, 255.0, 0.0, 191.0)
    if max_bands > 1:
        assert isinstance(out, tb.BandAtlas) and out.shape[0] > 1
        placed, (_, pr, pc), planes_w, vmasks_w = out.placed, out.shape, out.planes, out.vmasks
    else:
        assert isinstance(out, tb.Band)
        placed, (pr, pc), planes_w, vmasks_w = ((out.row0, out.col0),), out.shape, out.plane[None], out.vmask[None]
    fpath, rpath = str(tmp_path / "mission_fill.pt2"), str(tmp_path / "mission_resample.pt2")
    rs = router._resampler
    assert serve.export_mission_fill(fpath, (192, 256), placed, pr, pc, extent=ext,
                                     fill_backend=router.fill_backend, device="cpu") > 0
    assert serve.export_mission_resample(rpath, (192, 256), placed, pr, pc, len(lons), extent=ext, chunk=128,
                                         win_rows=rs.wr, win_cols=rs.wc, masked=out.masked, device="cpu") > 0
    assert serve.read_meta(fpath)["ops"] == ["auvtpu_torch::kriging_fill"]
    assert serve.read_meta(rpath)["ops"] == ["auvtpu_torch::band_resample"]
    fill, run = serve.load_exported_mission(fpath, rpath)
    planes, vmasks = fill(g.elev, g.valid)
    assert torch.equal(planes, planes_w) and torch.equal(vmasks, vmasks_w)
    z, ok = run(planes, vmasks, lons, lats)
    zl, okl = rs.resample(lons, lats)
    assert torch.equal(ok, okl) and _nan_equal(z, zl)
    assert float(ok.float().mean()) > 0.9


def test_an_artifact_refuses_an_input_on_another_device(grids, tmp_path):
    _, g = grids
    path = str(tmp_path / "i.pt2")
    serve.export_fill(path, (H, W), extent=EXT, method="idw", max_radius=5, device="cpu")
    srv = serve.load_exported(path)
    meta = torch.empty((H, W), device="meta")
    with pytest.raises(ValueError, match="exported for cpu"):
        srv(meta, g.valid)
    with pytest.raises(ValueError, match="exported for cpu"):
        srv(g.elev, meta)


def test_exports_refuse_a_path_without_the_kernels(tmp_path):
    # on the card a plain path would hide the kernel; B2's selection is no op
    with pytest.raises(ValueError, match="cannot be exported"):
        serve._backend("torch", torch.device("cuda", 0))
    with pytest.raises(ValueError, match="cannot be exported"):
        serve.export_fill(str(tmp_path / "x.pt2"), (8, 8), backend="select", device="cpu")
    assert serve._backend("torch", torch.device("cpu")) == "fused"  # its CPU implementation is the plain version


def test_tracing_leaves_the_caches_real(grids, tmp_path):
    # constants made while torch.export traces are fake tensors: the caches
    # that live calls read must not keep them
    _, g = grids
    ss._table.cache_clear()
    library._constant.cache_clear()
    tl._skeleton.cache_clear()
    serve.export_scattered(str(tmp_path / "s.pt2"), (H, W), 64, extent=EXT, device="cpu")
    serve.export_learned(str(tmp_path / "l.pt2"), (H, W), tl.init_params(torch.Generator().manual_seed(0), width=4,
                         depth=1, device="cpu"), extent=EXT, width=4, depth=1, device="cpu")
    assert ss._table.cache_info().currsize == 0 and tl._skeleton.cache_info().currsize == 0
    # a live call afterwards makes and caches real tensors
    sp = StencilPack(g)
    ss.packed_kriging_fused(sp.window, g, torch.tensor([3.5]), torch.tensor([4.5]))
    fill_kriging(g, backend="fused", max_radius=3)
    assert not any(is_fake(t) for t in (ss.table([(0, 0)], 1, 0, "dx", "cpu"),
                                        library.variogram_tensor(None, g.elev)))


def test_ops_take_the_plain_version_on_the_cpu(grids):
    _, g = grids
    wf.reset_launches()
    ss.reset_launches()
    kb.reset_launches()
    plane, var = wf.fill_kriging_fused(g, max_radius=5, with_variance=True)
    want = wf.fill_kriging_fused_ref(g, max_radius=5, with_variance=True)
    assert _nan_equal(plane, want[0]) and _nan_equal(var, want[1])
    # fitted parameters as views of one tensor are that tensor, no copy
    p = torch.tensor([0.5, 80.0, 12.0])
    assert library.variogram_tensor((p[0], p[1], p[2]), g.elev) is p
    assert torch.equal(library.variogram_tensor((p[0], 80.0, p[2]), g.elev), p)
    assert all(n == 0 for n in (*wf.LAUNCHES.values(), *ss.LAUNCHES.values(), *kb.LAUNCHES.values()))
