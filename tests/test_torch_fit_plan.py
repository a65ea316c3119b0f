"""The fit-then-fill's variogram fit as it runs now: B9's float64 sums handed
to B10 as they are (``fit_model(..., binned=True)``, the op
``auvtpu_torch::fit_model.binned``), with the offset table and the lags
made once per grid geometry (``variogram._fit_plan``).

Held bit for bit against the composition it replaced, written out here:
``empirical_variogram`` (the semivariance in the grid's dtype from the
sums), ``fit_exponential`` on ``lags * step``, ``fill_kriging`` and the
observed cells kept; the semivariance and counts of the binned form against
the float32 (float64) arithmetic the kernel states, counts above 2**24
included; on the card the same, with the kernel's own gamma and counts read
back.  CPU tests run the op's plain version; the ``cuda`` ones need a
card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from auvtpu_torch import variogram as tv
from auvtpu_torch.entry import fit_fill
from auvtpu_torch.grid import RegularGrid
from auvtpu_torch.kernels import variogram as kv
from auvtpu_torch.ops.dense import fill_kriging
from auvtpu_torch.synthetic import shelf_seamount
from auvtpu_torch.utils.profiling import COUNTERS, reset

MODELS = ["exponential", "linear", "spherical", "gaussian"]
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(device: str) -> str:
    if device == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
        kv.build()
    return device


def _tile(h: int, w: int, removal: float, seed: int, device: str, dtype=torch.float32) -> RegularGrid:
    """A shelf-and-seamount tile with roughness, a fraction ``removal`` of
    its cells masked at random, on a Kerguelen-like extent (steps that
    differ by axis)."""
    g = torch.Generator().manual_seed(seed)
    elev = torch.from_numpy(shelf_seamount(h, w)).to(dtype) + torch.randn(h, w, generator=g, dtype=dtype) * 7.0
    valid = torch.ones(h * w, dtype=dtype)
    valid[torch.randperm(h * w, generator=g)[: int(h * w * removal)]] = 0.0
    valid = valid.reshape(h, w)
    return RegularGrid(elev=(elev * valid).to(device), valid=valid.to(device), min_lon=74.6,
                       max_lon=74.6 + 0.004 * (w - 1), min_lat=-58.2, max_lat=-58.2 + 0.0042 * (h - 1))


def _sparse(device: str) -> RegularGrid:
    """A tile with three observed cells, so that most lag bins have no
    observed pair."""
    valid = torch.zeros(40, 44)
    for r, c in ((5, 5), (5, 8), (9, 8)):
        valid[r, c] = 1.0
    elev = torch.from_numpy(shelf_seamount(40, 44)).float() * valid
    return RegularGrid(elev=elev.to(device), valid=valid.to(device), min_lon=0.0, max_lon=43.0, min_lat=0.0,
                       max_lat=39.0)


def _composition(grid: RegularGrid):
    """fit_fill as it ran before the binned fit: (plane, parameters)."""
    lags, gamma, counts = tv.empirical_variogram(grid)
    step = 0.5 * (abs(grid.lat_step) + abs(grid.lon_step))
    p = tv.fit_exponential(lags * step, gamma, counts, iters=25)
    plane = fill_kriging(grid, vparams=p, backend="fused")
    return torch.where(grid.valid > 0.5, grid.elev, plane), p


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape and a.device == b.device
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.equal(torch.nan_to_num(a, nan=0.0).view(torch.int32 if a.dtype == torch.float32 else torch.int64),
                       torch.nan_to_num(b, nan=0.0).view(torch.int32 if b.dtype == torch.float32 else torch.int64))


CASES = [(h, w, r) for h, w in ((48, 64), (96, 64)) for r in (0.1, 0.3, 0.6)]


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("h,w,removal", CASES + [(0, 0, 0.0)], ids=[f"{h}x{w}-{r}" for h, w, r in CASES] + ["sparse"])
def test_fit_fill_is_the_composition_bit_for_bit(device, h, w, removal):
    dev = _device(device)
    for seed in (11, 12):
        grid = _sparse(dev) if h == 0 else _tile(h, w, removal, seed + h + int(100 * removal), dev)
        want_plane, want_p = _composition(grid)
        plane, p = fit_fill(grid)
        _bits_equal(torch.stack(p), torch.stack(want_p))
        _bits_equal(plane, want_plane)
        _bits_equal(torch.stack(tv.fit_variogram(grid)), torch.stack(want_p))


@pytest.mark.parametrize("device", DEVICES)
def test_the_plan_is_made_once_per_geometry(device):
    dev = _device(device)
    tv._fit_plan.cache_clear()
    a, b = _tile(48, 64, 0.1, 3, dev), _tile(48, 64, 0.3, 4, dev)
    tv.fit_variogram(a)
    tv.fit_variogram(b)
    assert tv._fit_plan.cache_info().misses == 1 and tv._fit_plan.cache_info().hits == 1
    dys, dxs, bin_of, table, lags = tv._fit_plan(10, 10, a.lon_step, a.lat_step, a.dtype, a.device)
    assert torch.equal(table.cpu(), torch.from_numpy(kv.grouped_table(dys, dxs, bin_of, 10)))
    step = 0.5 * (abs(a.lat_step) + abs(a.lon_step))
    _bits_equal(lags, tv.empirical_variogram(a)[0] * step)
    tv.fit_variogram(_tile(96, 64, 0.1, 5, dev))  # another extent a step: another plan
    assert tv._fit_plan.cache_info().misses == 2


def test_each_fit_fill_counts_one_fit():
    grid = _tile(48, 64, 0.1, 7, "cpu")
    reset("fit")
    fit_fill(grid)
    assert COUNTERS["fit"] == {"fits": 1} and tv.FIT is COUNTERS["fit"]
    fit_fill(grid)
    tv.fit_variogram(grid)
    assert COUNTERS["fit"]["fits"] == 3


def _sums(n: int, seed: int, big: bool):
    """Float64 (sums, counts) as B9 leaves them: integer counts, some bins
    empty, counts above 2**24 where ``big`` (float32 rounds them)."""
    rng = np.random.default_rng(seed)
    top = 2.0 ** 31 if big else 5e4
    c = np.floor(rng.uniform(0.0, top, n))
    c[rng.random(n) < 0.2] = 0.0
    if big:
        c[:3] = [2.0 ** 24 + 1.0, 2.0 ** 24 + 3.0, 123456789.0]
    s = c * rng.uniform(1.0, 4e4, n) * (1.0 + rng.uniform(-0.5, 0.5, n))
    s[c == 0] = 0.0
    return torch.from_numpy(s), torch.from_numpy(c)


def _kernel_gamma(s: np.ndarray, c: np.ndarray, dt):
    """The binned form's arithmetic as the kernel states it, in numpy: s and
    c rounded to dt, gamma = s / (2 max(c, 1)) where c > 0, else 0."""
    s, c = s.astype(dt), c.astype(dt)
    lo = np.where(c < dt(1), dt(1), c)
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.where(c > dt(0), s / (dt(2) * lo), dt(0))
    return g.astype(dt), c


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("big", [False, True], ids=["counts below 2**24", "counts above 2**24"])
def test_binned_gamma_is_the_kernels_arithmetic(dtype, big):
    s, c = _sums(300, 5, big)
    g, n = kv.binned_gamma(s, c, dtype)
    want_g, want_n = _kernel_gamma(s.numpy(), c.numpy(), np.float32 if dtype == torch.float32 else np.float64)
    assert g.dtype == dtype and n.dtype == dtype
    assert np.array_equal(g.numpy(), want_g) and np.array_equal(n.numpy(), want_n)
    if big and dtype == torch.float32:
        assert float(n[0]) != float(c[0])  # the rounding of a count is kept
    # what empirical_variogram computes from the same sums
    sf, cf = s.to(dtype), c.to(dtype)
    _bits_equal(g, torch.where(cf > 0, sf / (2.0 * torch.clamp(cf, min=1.0)), torch.zeros_like(sf)))


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("device", DEVICES)
def test_the_binned_fit_is_binned_gamma_then_the_fit(device, model):
    dev = _device(device)
    kv.reset_launches()
    runs = 0
    for big in (False, True):
        s, c = (t.to(dev) for t in _sums(10, 9, big))
        for dt in (torch.float32, torch.float64):
            lags = (torch.arange(10, dtype=dt) * 0.0041 + 0.002).to(dev)
            for init in (None, (2.0, 150.0, 0.01)):
                got = kv.fit_model(lags, s, c, model=model, iters=25, init=init, stop=tv.STOP_DGAMMA, binned=True)
                want = kv.fit_model(lags, *kv.binned_gamma(s, c, dt), model=model, iters=25, init=init,
                                    stop=tv.STOP_DGAMMA)
                _bits_equal(torch.stack(got), torch.stack(want))
                assert got[0].dtype == dt and got[0]._base is not None and got[0]._base.shape == (3,)
                runs += 1
    assert kv.LAUNCHES["fit_model"] == (2 * runs if dev == "cuda" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_the_kernels_gamma_and_counts_are_binned_gamma_on_the_card(dtype):
    _device("cuda")
    for big in (False, True):
        s, c = (t.cuda() for t in _sums(300, 6, big))
        lags = torch.linspace(0.5, 9.5, 300, dtype=dtype, device="cuda")
        formed = torch.empty((2, 300), dtype=dtype, device="cuda")
        p = kv.fit_binned_launch(lags, s, c, None, "exponential", 25, tv.STOP_DGAMMA, formed=formed)
        g, n = kv.binned_gamma(s, c, dtype)
        _bits_equal(formed[0], g)
        _bits_equal(formed[1], n)
        _bits_equal(p, torch.stack(kv.fit_model(lags, g, n, iters=25, stop=tv.STOP_DGAMMA)))


@pytest.mark.cuda
def test_the_binned_fit_makes_the_host_wait_for_nothing():
    _device("cuda")
    grid = _tile(96, 64, 0.1, 8, "cuda")
    want = fit_fill(grid)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fit_fill(grid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _bits_equal(got[0], want[0])
    _bits_equal(torch.stack(got[1]), torch.stack(want[1]))


def test_the_binned_launch_refuses_what_it_cannot_take():
    kv.reset_launches()
    x = torch.ones(4)
    with pytest.raises(ValueError, match="one card"):
        kv.fit_binned_launch(x, x.double(), x.double(), None, "exponential", 3, 1e-4)
    with pytest.raises(ValueError, match="unknown"):
        kv.fit_model(x, x.double(), x.double(), model="unknown", binned=True)
    assert kv.LAUNCHES == {"pair_sums": 0, "fit_model": 0}
