"""What the B1, B2, B6 and B7 wrappers hand their kernels, checked on the
CPU: B6's and B7's tap tables by value (the real taps of the window, their
offsets plus the half-cell shift and B7's codes, against the JAX package's
lane tables), B1's parameters by value or by device address, B2's checks
and row pitches, and the divisor rule that keeps the plain kriging solve's
division a division on a card."""

import ctypes

import numpy as np
import pytest
import torch

from auvtpu.pallas.scattered_select import _lane_tables
from auvtpu_torch.config import Extent, KrigingConfig
from auvtpu_torch.grid import RegularGrid, divisor
from auvtpu_torch.kernels import scattered_select as ss
from auvtpu_torch.kernels import window_fill as wf
from auvtpu_torch.ops.packs import VALID16_OFFSETS, pack_width, window_offsets

torch.set_num_threads(1)


@pytest.mark.parametrize("offs,R,want_m", [
    (window_offsets(1), 1, 9), (window_offsets(2), 2, 25), (window_offsets(3), 3, 49), (VALID16_OFFSETS, 2, 16),
])
@pytest.mark.parametrize("half", [0.5, 0.0])
@pytest.mark.parametrize("copied", [False, True], ids=["table", "copy"])
def test_idw_taps_are_the_windows_real_taps(offs, R, want_m, half, copied):
    # from the host copy table() attaches, or, for a copy of the table
    # (which has none), read back
    P = pack_width(len(offs))
    tab = ss.table(offs, P, R, "dy", "cpu")
    if copied:
        tab = tab.clone()
        assert not hasattr(tab, "host")
    M, taps = ss._idw_taps(tab, P, half)
    assert M == want_m and taps.dtype == np.float32 and taps.shape == (2 * M,)
    dx = np.array([o[1] for o in offs], np.float32)
    dy = np.array([o[0] for o in offs], np.float32)
    np.testing.assert_array_equal(taps[:len(offs)], dx + np.float32(half))
    np.testing.assert_array_equal(taps[M:M + len(offs)], dy + np.float32(half))
    assert np.array_equal(taps[:M] - np.float32(half), np.round(taps[:M] - np.float32(half)))  # exact sums


def test_idw_taps_refuse_a_row_too_wide_for_a_build():
    tab = ss.table(window_offsets(2), 32, 2, "dy", "cpu").clone()
    tab[0, 31] = 1.0  # a 32nd real tap: rows of 32 are built for 25
    with pytest.raises(ValueError, match="no build"):
        ss._idw_taps(tab, 32, 0.5)


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("convention,half", [("reference", 0.5), ("centered", 0.0)])
@pytest.mark.parametrize("copied", [False, True], ids=["table", "copy"])
def test_window_taps_match_the_lane_tables(radius, convention, half, copied):
    # B7's by-value operands: (dx + half, dy + half, code) of each real tap,
    # as pallas_window_select's lane tables hold them (the TPU kernel adds
    # its half-cell shift in the kernel)
    offs = window_offsets(radius, convention)
    P = pack_width(len(offs))
    tab = ss.table(offs, P, radius, "dx", "cpu")
    if copied:
        tab = tab.clone()
    M, taps = ss._window_taps(tab, P, half)
    assert M == len(offs) == (2 * radius + 1) ** 2 and taps.dtype == np.float32 and taps.shape == (3 * M,)
    dy, dx, code, _ = _lane_tables(radius, P)
    h = np.float32(half)
    np.testing.assert_array_equal(taps[:M], dx[0, :M] + h)
    np.testing.assert_array_equal(taps[M:2 * M], dy[0, :M] + h)
    np.testing.assert_array_equal(taps[2 * M:], code[0, :M])
    assert (code[0, M:P] == -1).all()  # the padding lanes B7 no longer reads


@pytest.mark.parametrize("offs,R,P,layout", [
    (window_offsets(2), 2, 32, "dy"),  # B6's layout: every code is a real one
    (VALID16_OFFSETS, 2, 16, "dx"),  # 16 taps: no build
    (window_offsets(2), 2, 64, "dx"),  # rows of 64 are built for 49 taps
])
def test_window_taps_refuse_a_table_without_a_build(offs, R, P, layout):
    with pytest.raises(ValueError, match="no build"):
        ss._window_taps(ss.table(offs, P, R, layout, "cpu"), P, 0.5)


def _planes(h=6, w=8, dtype=torch.float32):
    elev = torch.arange(float(h * w), dtype=dtype).reshape(h, w)
    return elev, torch.ones_like(elev)


@pytest.mark.parametrize("k", [1, 4, 16])
def test_topk_full_args_take_the_planes_pitches(k):
    elev, valid = _planes()
    g = RegularGrid(elev, valid, 0.0, 7.0, 0.0, 5.0)
    assert wf._topk_full_args(g.elev, g.valid, k) == (8, 8)
    # a window view of a larger mosaic is read in place, with its own pitch
    big_e, big_v = torch.zeros(20, 30), torch.zeros(20, 24)
    view = RegularGrid(big_e[3:9, 5:13], big_v[2:8, 1:9], 0.0, 7.0, 0.0, 5.0)
    assert wf._topk_full_args(view.elev, view.valid, k) == (30, 24)


@pytest.mark.parametrize("k", [0, 17, -1])
def test_topk_full_args_refuse_k_outside_the_slots(k):
    g = RegularGrid(*_planes(), 0.0, 7.0, 0.0, 5.0)
    with pytest.raises(ValueError, match="outside 1..16"):
        wf._topk_full_args(g.elev, g.valid, k)


@pytest.mark.parametrize("which", ["elev", "valid", "both"])
def test_topk_full_args_refuse_planes_not_float32(which):
    e32, v32 = _planes()
    e64, v64 = _planes(dtype=torch.float64)
    elev, valid = {"elev": (e64, v32), "valid": (e32, v64), "both": (e64, v64)}[which]
    with pytest.raises(TypeError, match="float32"):
        wf._topk_full_args(elev, valid, 4)


def test_topk_full_args_refuse_a_column_stride():
    elev, valid = _planes()
    g = RegularGrid(elev.t().contiguous().t(), valid, 0.0, 7.0, 0.0, 5.0)
    with pytest.raises(ValueError, match="unit column stride"):
        wf._topk_full_args(g.elev, g.valid, 4)


def _grid():
    elev = np.arange(48.0, dtype=np.float32).reshape(6, 8)
    return RegularGrid.from_nan_array(elev, Extent(10.0, 17.0, -3.0, 2.0), device="cpu")


def test_kriging_params_fixed_values():
    g = _grid()
    geo, vario, ptrs, keep = wf._kriging_params(g, None, "reference", 3, 5, None, torch.device("cpu"))
    cfg = KrigingConfig()
    want_geo = np.array([g.min_lon, g.min_lat, g.lon_step, g.lat_step, 0.5, cfg.pivot_tol, 3, 5], np.float32)
    np.testing.assert_array_equal(np.ctypeslib.as_array(geo), want_geo)
    np.testing.assert_array_equal(np.ctypeslib.as_array(vario),
                                  np.array([cfg.variogram.nugget, cfg.variogram.sill, cfg.variogram.range], np.float32))
    assert ptrs == [None, None, None] and keep == []
    geo, *_ = wf._kriging_params(g, (1.0, 2.0, 3.0), "centered", 0, 0, (0.25, 0.5), torch.device("cpu"))
    assert list(np.ctypeslib.as_array(geo)[2:5]) == [0.5, 0.25, 0.0]


def test_kriging_params_pass_tensors_by_address():
    g = _grid()
    fitted = torch.tensor([0.5, 80.0, 12.0])
    vp = (fitted[0], fitted[1], 7.0)  # views of one tensor, and a number
    _, vario, ptrs, keep = wf._kriging_params(g, vp, "reference", 0, 0, None, torch.device("cpu"))
    assert ptrs[0] == fitted.data_ptr() and ptrs[1] == fitted.data_ptr() + 4 and ptrs[2] is None
    assert vario[2] == 7.0 and len(keep) == 2
    # a float64 tensor is converted (a copy), and the copy kept alive for the launch
    _, _, ptrs, keep = wf._kriging_params(g, (torch.tensor(0.5, dtype=torch.float64), 1.0, 2.0), "reference", 0, 0,
                                          None, torch.device("cpu"))
    assert keep[0].dtype == torch.float32 and ptrs[0] == keep[0].data_ptr()
    assert ctypes.c_float.from_address(ptrs[0]).value == 0.5
    with pytest.raises(ValueError, match="one"):
        wf._kriging_params(g, (torch.ones(2), 1.0, 2.0), "reference", 0, 0, None, torch.device("cpu"))


def test_divisor_leaves_the_cpu_alone():
    h = torch.ones(4)
    assert divisor(10.0, h) == 10.0 and isinstance(divisor(10.0, h), float)
    t = torch.tensor(3.0)
    assert divisor(t, h) is t
    # the division it feeds is the same on the CPU either way
    x = torch.tensor([1.0, 2.0, 3.0, 7.0]) * 0.1
    assert torch.equal(x / divisor(0.3, x), x / torch.tensor(0.3))
