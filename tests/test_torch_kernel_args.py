"""What the B1 and B6 wrappers hand their kernels, checked on the CPU: B6's
tap table by value (the real taps of the window and their offsets plus the
half-cell shift) and B1's parameters by value or by device address, and the
divisor rule that keeps the plain kriging solve's division a division on a
card."""

import ctypes

import numpy as np
import pytest
import torch

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
