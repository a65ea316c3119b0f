"""The CPU wrappers of the scattered select kernels (their plain versions)
against the JAX package's Pallas kernels in interpret mode: B5
(``valid_select_t``, ``pallas_kriging_valid``, ``pallas_packed_kriging_t``),
B6 (``pallas_packed_idw_t``), B7 (``pallas_window_select``), B12
(``pallas_packed_kriging``) and B15 (``pallas_packed_idw``), on masked and
fully valid grids, window radius 2 and 3, both conventions, fitted
variogram parameters and the two-tier resolved row.  B6's, B12's and B15's
plain versions, which the kernels with the query prologue inside follow op
for op, are also held to the compositions they replace (the torch
prologue, the selection, the torch epilogue or solve): bit for bit, but
where torch's CPU sum over 16 or more IDW slots adds them out of slot
order (B15 at k = P: rtol 1e-6).

Selection decisions (counts, values, codes, offsets, the resolved mask)
are exactly equal.  d2 and the IDW sums agree at rtol 1e-6: XLA:CPU may
contract d2's multiply-add, which the port (and its CUDA kernel, built with
-fmad=false) never does.  Predictions hold at tests/test_pallas.py's bars
(rtol 1e-5, atol 1e-4)."""

import numpy as np
import pytest
import torch

from auvtpu.config import Extent as JExtent
from auvtpu.grid import RegularGrid as JGrid
from auvtpu.masking import mask_grid
from auvtpu.ops import packs as jp
from auvtpu.pallas import pallas_kriging_valid, pallas_packed_idw, pallas_packed_idw_t, pallas_packed_kriging, pallas_packed_kriging_t, pallas_window_select, valid_select_t as j_valid_select_t
from auvtpu.pallas.valid_select import _select_rows as j_select_rows
from auvtpu.synthetic import shelf_seamount
from jax.experimental.pallas import tpu as pltpu

from auvtpu_torch.config import IDWConfig
from auvtpu_torch.convert import grid_from_arrays
from auvtpu_torch.kernels import scattered_select as ss
from auvtpu_torch.kernels import valid_select as vs
from auvtpu_torch.ops import packs as tp

torch.set_num_threads(1)

H, W = 96, 80
TILE = 256
RTOL, ATOL = 1e-5, 1e-4


def _grids(masked):
    elev = shelf_seamount(H, W)
    if masked:
        elev = mask_grid(elev, 0.2, seed=9)[0]
    jg = JGrid.from_nan_array(elev, JExtent(0.0, W - 1.0, 0.0, H - 1.0))
    g = grid_from_arrays(np.asarray(jg.elev), np.asarray(jg.valid), jg.min_lon, jg.max_lon, jg.min_lat, jg.max_lat, "cpu")
    return jg, g


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(11)
    lons = rng.uniform(-1.0, W, 700).astype(np.float32)
    lats = rng.uniform(-1.0, H, 700).astype(np.float32)
    extra_lo = np.array([3.0, 4.5, 10.0, 77.5, 0.0, 0.5, W - 1.0], np.float32)
    extra_la = np.array([5.0, 6.5, 90.5, 2.0, 0.0, 1.5, H - 1.0], np.float32)
    return np.concatenate([lons, extra_lo]), np.concatenate([lats, extra_la])


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


def _interp():
    return pltpu.force_tpu_interpret_mode()


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "valid"])
@pytest.mark.parametrize("radius,convention", [(2, "reference"), (2, "centered"), (3, "reference")])
def test_b5_b6_rows_and_predictions(queries, masked, radius, convention):
    jg, g = _grids(masked)
    lons, lats = queries
    n = len(lons)
    offs = tp.window_offsets(radius)
    P = tp.pack_width(len(offs))
    pack = tp.build_pack(g, offs, clamp=False)[0]
    jpack = jp.build_pack(jg, offs, clamp=False)[0]
    half = 0.5 if convention == "reference" else 0.0
    thresh = 4.0 if convention == "reference" else 6.25
    # B5's raw rows [cnt, 4 vals, 4 d2, 4 codes, resolved]
    got, *_ = vs._select_rows(pack, P, offs, radius, g, lons, lats, emit_d2=True, half=half, resolve_thresh=thresh)
    with _interp():
        want = np.asarray(j_select_rows(jpack, P, offs, radius, jg, lons, lats, TILE, True, half=half, resolve_thresh=thresh)[0])[:, :n]
    got = got.numpy()
    exact = [0, 1, 2, 3, 4, 9, 10, 11, 12, 13]
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_allclose(got[5:9], want[5:9], rtol=1e-6)
    # B5 kriging and B6 IDW with the resolved row, fitted parameters
    vp = (0.5, 80.0, 12.0)
    kw = dict(window_radius=radius, convention=convention, resolve_thresh=thresh)
    k_res, k_mask, k_bad = vs.packed_kriging_t(pack, g, lons, lats, vparams=vp, model="spherical", **kw)
    i_res, i_mask, i_bad = vs.packed_idw_t(pack, g, lons, lats, k=8, **kw)
    with _interp():
        jk = pallas_packed_kriging_t(jpack, jg, lons, lats, vparams=vp, model="spherical", tile_n=TILE, **kw)
        ji = pallas_packed_idw_t(jpack, jg, lons, lats, k=8, tile_n=TILE, **kw)
    np.testing.assert_array_equal(k_mask.numpy(), np.asarray(jk[1]))
    np.testing.assert_array_equal(i_mask.numpy(), np.asarray(ji[1]))
    assert int(k_bad) == int(jk[2]) and int(i_bad) == int(ji[2])
    _close(k_res, jk[0])
    _close(i_res, ji[0])
    # the resolved row changes nothing else
    plain = vs.packed_kriging_t(pack, g, lons, lats, vparams=vp, model="spherical", window_radius=radius, convention=convention)
    assert torch.equal(torch.nan_to_num(plain, nan=-1.0), torch.nan_to_num(k_res, nan=-1.0))


def _nan_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(torch.nan_to_num(got, nan=-7.0), torch.nan_to_num(want, nan=-7.0))


def _idw_composition(pack, P, offs, R, g, lons, lats, *, k, half, resolve_thresh):
    """B6 as the port ran it before the kernel took the prologue and the
    epilogue: the torch prologue, the (cell, fx, fy) selection's plain sums,
    the torch quotient and NaNs."""
    _, _, oob, _, _, cell, fx, fy = ss.prologue(g, lons, lats)
    eps = 1e-12
    rows = ss.select_ref(pack, P, cell, fx, fy, ss.table(offs, P, R, "dy", "cpu"), mode="idw", k=k, half=half,
                         resolve_thresh=resolve_thresh, eps=eps)
    res = torch.where(rows[1] > 0, rows[0] / torch.clamp(rows[1], min=eps), float("nan"))
    res = torch.where(oob, float("nan"), res)
    return torch.stack([res] + ([rows[2]] if resolve_thresh is not None else []))


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "valid"])
def test_b6_sums_match_pallas(queries, masked):
    # B6's op (the kernel's plain version on the CPU) at k 1, 8 and 32:
    # bit-equal to the composition it replaces, within the bars of
    # pallas_packed_idw_t
    jg, g = _grids(masked)
    lons, lats = queries
    offs = tp.window_offsets(2)
    pack = tp.build_pack(g, offs, clamp=False)[0]
    for k in (1, 8, 32):
        got = ss.idw_select(pack, 32, offs, 2, g, lons, lats, k=k)
        _nan_equal(got, _idw_composition(pack, 32, offs, 2, g, lons, lats, k=k, half=0.5, resolve_thresh=None))
        with _interp():
            want = pallas_packed_idw_t(jp.build_pack(jg, offs, clamp=False)[0], jg, lons, lats, k=k, tile_n=TILE)
        _close(got[0], want)


@pytest.fixture(scope="module")
def odd_queries(queries):
    """The module's queries after NaN, +-inf and out-of-grid ones."""
    nan, inf = float("nan"), float("inf")
    lo = np.array([nan, 4.0, nan, inf, -inf, 4.0, 4.0, -5.0, W + 5.0, -0.6, W - 0.4], np.float32)
    la = np.array([4.0, nan, nan, 4.0, 4.0, inf, -inf, 7.0, 9.0, -0.6, H - 0.4], np.float32)
    return np.concatenate([lo, queries[0]]), np.concatenate([la, queries[1]])


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "valid"])
@pytest.mark.parametrize("radius,convention", [(2, "reference"), (2, "centered"), (3, "reference")])
@pytest.mark.parametrize("thresh", [None, 4.0], ids=["plain", "resolve"])
def test_b6_idw_select_matches_its_composition_and_pallas(odd_queries, masked, radius, convention, thresh):
    # idw_select (the op's plain version, in the kernel's op order) on
    # grid-line, NaN, +-inf and out-of-grid queries, k 1, 8 and 32: bit-equal
    # to the torch composition before it; against pallas_packed_idw_t the
    # resolved masks, the unresolved counts and the NaN patterns exactly
    # equal, values within the bars
    jg, g = _grids(masked)
    lons, lats = odd_queries
    offs = tp.window_offsets(radius)
    P = tp.pack_width(len(offs))
    pack, jpack = tp.build_pack(g, offs, clamp=False)[0], jp.build_pack(jg, offs, clamp=False)[0]
    half = 0.5 if convention == "reference" else 0.0
    for k in (1, 8, 32):
        got = ss.idw_select(pack, P, offs, radius, g, lons, lats, k=k, convention=convention, resolve_thresh=thresh)
        assert got.shape == (1 + int(thresh is not None), len(lons))
        _nan_equal(got, _idw_composition(pack, P, offs, radius, g, lons, lats, k=k, half=half, resolve_thresh=thresh))
        _nan_equal(got, ss.idw_select_ref(pack, P, offs, radius, g, lons, lats, k=k, convention=convention,
                                          resolve_thresh=thresh))
        assert bool(torch.isnan(got[0, :7]).all())  # NaN and +-inf queries: no slot, or out of the grid
        kw = dict(k=k, window_radius=radius, convention=convention, resolve_thresh=thresh)
        wrapped = vs.packed_idw_t(pack, g, lons, lats, **kw)
        with _interp():
            want = pallas_packed_idw_t(jpack, jg, lons, lats, tile_n=TILE, **kw)
        if thresh is None:
            _nan_equal(wrapped, got[0])
            _close(wrapped, want)
        else:
            _nan_equal(wrapped[0], got[0])
            np.testing.assert_array_equal(wrapped[1].numpy(), np.asarray(want[1]))
            assert int(wrapped[2]) == int(want[2])
            _close(wrapped[0], want[0])


B12_MODELS = [("exponential", (1.0, 100.0, 10.0)), ("linear", (1.0, 5.0, 10.0)),
              ("spherical", (0.5, 80.0, 12.0)), ("gaussian", (2.0, 150.0, 6.0))]


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "valid"])
@pytest.mark.parametrize("radius,convention", [(2, "reference"), (2, "centered"), (3, "reference")])
def test_b12_window_krige_matches_its_composition_and_pallas(odd_queries, masked, radius, convention):
    # window_krige (B12's op, its plain version on the CPU) for the four
    # models with fitted parameters (0-d tensors, as a fit returns them):
    # bit-equal to kriging_from_select over window_select_fused, the torch
    # path it replaces; against pallas_packed_kriging the NaN pattern
    # exactly equal (a NaN query answers NaN: no tap found), values within
    # the bars
    jg, g = _grids(masked)
    lons, lats = odd_queries
    offs = tp.window_offsets(radius)
    P = tp.pack_width(len(offs))
    sp, jsp = tp.StencilPack(g, window_radius=radius), jp.StencilPack(jg, window_radius=radius)
    sel = ss.window_select_fused(sp.window, g, lons, lats, k=4, window_radius=radius, convention=convention)
    with _interp():
        jsel = pallas_window_select(jsp.window, jg, lons, lats, k=4, window_radius=radius, convention=convention,
                                    tile_n=TILE)
    np.testing.assert_array_equal(sel["found"].numpy(), np.asarray(jsel["found"]))
    for model, vp in B12_MODELS:
        vpt = tuple(torch.tensor(v) for v in vp)
        got = ss.window_krige(sp.window, P, offs, radius, g, lons, lats, convention=convention, vparams=vpt,
                              model=model)
        _nan_equal(got, tp.kriging_from_select(g, lons, lats, sel, vparams=vpt, convention=convention, model=model))
        _nan_equal(got, ss.window_krige_ref(sp.window, P, offs, radius, g, lons, lats, convention=convention,
                                            vparams=vp, model=model))
        _nan_equal(ss.packed_kriging_fused(sp.window, g, lons, lats, window_radius=radius, vparams=vpt,
                                           convention=convention, model=model), got)
        assert bool(torch.isnan(got[:7]).all())  # NaN and +-inf queries
        with _interp():
            want = pallas_packed_kriging(jsp.window, jg, lons, lats, window_radius=radius, vparams=vp,
                                         convention=convention, model=model, tile_n=TILE)
        _close(got, want)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "valid"])
@pytest.mark.parametrize("radius,convention", [(2, "reference"), (2, "centered"), (3, "reference")])
def test_b15_window_idw_matches_its_composition_and_pallas(odd_queries, masked, radius, convention):
    # window_idw (B15's op, its plain version on the CPU) for k 1, 8 and P
    # and powers 2, 1 and 3.  Against idw_from_select over
    # window_select_fused, the torch path it replaces: the weights are the
    # same torch ops on the same select rows, and the two sums run slot by
    # slot (bit-equal to a float32 numpy loop over those weights in slot
    # order); torch's CPU sum over k adds slot by slot up to 8 slots, so
    # k 1 and 8 are bit-equal to the composition, while over k = P (32, 64)
    # it adds vector lanes apart: rtol 1e-6 there, NaN pattern exactly
    # equal.  Against pallas_packed_idw the NaN pattern exactly equal (NaN
    # and +-inf queries answer NaN), values within the bars; packed_idw_fused
    # equals the op
    jg, g = _grids(masked)
    lons, lats = odd_queries
    offs = tp.window_offsets(radius)
    P = tp.pack_width(len(offs))
    sp, jsp = tp.StencilPack(g, window_radius=radius), jp.StencilPack(jg, window_radius=radius)
    for k in (1, 8, P):
        sel = ss.window_select_fused(sp.window, g, lons, lats, k=k, window_radius=radius, convention=convention)
        for power in (2.0, 1.0, 3.0):
            eps = IDWConfig(k=k, power=power).eps
            got = ss.window_idw(sp.window, P, offs, radius, g, lons, lats, k=k, power=power, convention=convention)
            assert got.shape == (len(lons),) and got.dtype == torch.float32
            comp = tp.idw_from_select(sel, power=power, eps=eps)
            if k <= 8:
                _nan_equal(got, comp)
            else:
                _close(got, comp, rtol=1e-6, atol=0.0)
            # the sums in slot order, over the composition's weights
            w = torch.where(sel["slot_ok"], 1.0 / (sel["d2"] ** (power / 2.0) + eps),
                            torch.zeros_like(sel["d2"])).numpy()
            val = sel["val"].numpy()
            num = den = np.zeros(len(lons), np.float32)
            for s in range(k):
                num = num + w[:, s] * val[:, s]
                den = den + w[:, s]
            with np.errstate(divide="ignore", invalid="ignore"):
                loop = np.where(den > 0, num / np.maximum(den, np.float32(eps)), np.nan).astype(np.float32)
            loop[sel["oob"].numpy()] = np.nan
            _nan_equal(got, torch.from_numpy(loop))
            _nan_equal(got, ss.window_idw_ref(sp.window, P, offs, radius, g, lons, lats, k=k, power=power,
                                              convention=convention))
            _nan_equal(ss.packed_idw_fused(sp.window, g, lons, lats, k=k, power=power, window_radius=radius,
                                           convention=convention), got)
            assert bool(torch.isnan(got[:7]).all())  # NaN and +-inf queries
            with _interp():
                want = pallas_packed_idw(jsp.window, jg, lons, lats, k=k, power=power, window_radius=radius,
                                         convention=convention, tile_n=TILE)
            _close(got, want)


def test_b5_valid16(queries):
    jg, g = _grids(False)
    lons, lats = queries
    p16, jp16 = tp.build_valid16_pack(g), jp.build_valid16_pack(jg)
    got = vs.valid_select_t(p16, g, lons, lats)
    vp = tuple(torch.tensor(v) for v in (0.8, 120.0, 9.0))  # fitted parameters arrive as 0-d tensors
    with _interp():
        want = j_valid_select_t(jp16, jg, lons, lats, tile_n=TILE)
        jk = pallas_kriging_valid(jp16, jg, lons, lats, tile_n=TILE)
        jk_fit = pallas_kriging_valid(jp16, jg, lons, lats, tile_n=TILE, vparams=(0.8, 120.0, 9.0))
    for key in ("found", "slot_ok", "val", "dx", "dy", "ci", "cj", "oob"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_allclose(got["d2"].numpy(), np.asarray(want["d2"]), rtol=1e-6)
    _close(vs.kriging_valid_t(p16, g, lons, lats), jk)
    _close(vs.kriging_valid_t(p16, g, lons, lats, vparams=vp), jk_fit)
    # the same selection as the torch valid16 path
    _close(vs.kriging_valid_t(p16, g, lons, lats), tp.packed_kriging_valid(p16, g, lons, lats), 1e-6, 1e-4)


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "valid"])
@pytest.mark.parametrize("radius,k,convention", [(2, 4, "reference"), (2, 8, "centered"), (3, 4, "reference")])
def test_b7_window_select(queries, masked, radius, k, convention):
    jg, g = _grids(masked)
    lons, lats = queries
    sp, jsp = tp.StencilPack(g, window_radius=radius), jp.StencilPack(jg, window_radius=radius)
    got = ss.window_select_fused(sp.window, g, lons, lats, k=k, window_radius=radius, convention=convention)
    with _interp():
        want = pallas_window_select(jsp.window, jg, lons, lats, k=k, window_radius=radius, convention=convention, tile_n=TILE)
    for key in ("found", "slot_ok", "val", "dx", "dy"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    np.testing.assert_allclose(got["d2"].numpy(), np.asarray(want["d2"]), rtol=1e-6)
    # the same selection as the torch packed path at every live slot
    tsel = tp.packed_window_select(sp.window, g, lons, lats, k=k, window_radius=radius, convention=convention)
    ok = tsel["slot_ok"]
    assert torch.equal(got["found"], tsel["found"])
    for key in ("val", "dx", "dy"):
        assert torch.equal(got[key][ok], tsel[key][ok])
    if radius == 2:
        _close(ss.packed_kriging_fused(sp.window, g, lons, lats, convention=convention),
               tp.packed_kriging(sp.window, g, lons, lats, convention=convention))
        _close(ss.packed_idw_fused(sp.window, g, lons, lats, k=k, convention=convention),
               tp.packed_idw(sp.window, g, lons, lats, k=k, convention=convention))


def test_float64_grids_are_refused(queries):
    jg, g = _grids(True)
    g64 = grid_from_arrays(g.elev.double().numpy(), g.valid.double().numpy(), 0.0, W - 1.0, 0.0, H - 1.0, "cpu")
    pack = tp.StencilPack(g64).window
    for fn in (vs.packed_kriging_t, vs.packed_idw_t):
        with pytest.raises(TypeError):
            fn(pack, g64, *queries)
    with pytest.raises(TypeError):
        ss.window_select_fused(pack, g64, *queries, k=4)
