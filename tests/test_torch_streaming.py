"""The port's StreamingInterpolator against the JAX package's, case by case
as tests/test_streaming.py runs the JAX class, on mosaics of at most
160x192 cells on the CPU.

The mosaic must be bit-equal; windows within the bars of their kernels:
idw/mean rtol=1e-5, atol=1e-3 (B3, tests/test_pallas.py:44), kriging and
its variance rtol=1e-4, atol=0.05 (B1, tests/test_pallas.py:110), with equal
NaN placement.
"""

import numpy as np
import pytest
import torch

from auvtpu.config import Extent as JExtent
from auvtpu.streaming import StreamingInterpolator as JStream
from auvtpu.synthetic import shelf_seamount

from auvtpu_torch.config import Extent
from auvtpu_torch.kernels import window_fill as wf
from auvtpu_torch.streaming import StreamingInterpolator, _ingest_batch

torch.set_num_threads(1)

H, W = 160, 192
BARS = {"idw": (1e-5, 1e-3), "mean": (1e-5, 1e-3), "kriging": (1e-4, 0.05)}


def _pair(method="idw", **kw):
    opts = dict(swath_cap=256, window=(64, 64), method=method, k=4, max_radius=5)
    opts.update(kw)
    j = JStream((H, W), JExtent(0.0, W - 1.0, 0.0, H - 1.0), **opts)
    t = StreamingInterpolator((H, W), Extent(0.0, W - 1.0, 0.0, H - 1.0), device="cpu", **opts)
    return j, t


def _ingest_both(pair, rows, cols, vals):
    for si in pair:
        assert si.ingest(rows, cols, vals) == len(rows)


def _assert_close(got, want, rtol, atol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=atol)


def _survey(seed, n, lo=(0, 0), hi=(H, W)):
    truth = shelf_seamount(H, W)
    r = np.random.RandomState(seed)
    rows = r.randint(lo[0], hi[0], n)
    cols = r.randint(lo[1], hi[1], n)
    return rows, cols, (truth[rows, cols] + r.normal(0, 0.5, n)).astype(np.float32)


def test_ingest_and_snapshot():
    j, t = _pair()
    rows, cols, vals = _survey(0, 1000)
    _ingest_both((j, t), rows, cols, vals)
    snap = t.snapshot()
    np.testing.assert_array_equal(snap, j.snapshot())
    assert (~np.isnan(snap)).sum() == len(np.unique(rows * W + cols))
    assert t.backend == "torch"  # auto on a CPU mosaic


def test_ingest_ragged_chunks():
    j, t = _pair()
    rows, cols, vals = _survey(1, 300)  # one full stage slot and a ragged one
    _ingest_both((j, t), rows, cols, vals)
    np.testing.assert_array_equal(t.snapshot(), j.snapshot())


def test_ragged_chunk_observation_at_cell_zero_survives():
    j, t = _pair()
    _ingest_both((j, t), np.array([0, 5]), np.array([0, 7]), np.array([-123.5, -77.0], np.float32))
    snap = t.snapshot()
    np.testing.assert_array_equal(snap, j.snapshot())
    assert snap[0, 0] == pytest.approx(-123.5) and snap[5, 7] == pytest.approx(-77.0)
    assert (~np.isnan(snap)).sum() == 2


def test_observations_outside_the_mosaic_are_dropped():
    j, t = _pair()
    rows, cols = np.array([H, 3, H + 7, 4]), np.array([0, 3, 5, 4])
    _ingest_both((j, t), rows, cols, np.array([-1.0, -2.0, -3.0, -4.0], np.float32))
    snap = t.snapshot()
    np.testing.assert_array_equal(snap, j.snapshot())
    assert (~np.isnan(snap)).sum() == 2


def test_negative_rows_and_cols_land_where_jax_puts_them():
    # a negative flat index counts from the end of the mosaic once (JAX's
    # .at[] normalisation); below -H*W it is dropped; a negative column
    # with a positive row reaches back into the previous row
    j, t = _pair()
    rows = np.array([-1, 2, -H, -H - 1, 0, 7])
    cols = np.array([3, -1, 0, 0, W + 2, -W - 5])
    _ingest_both((j, t), rows, cols, np.arange(1, 7, dtype=np.float32) * -1.0)
    snap = t.snapshot()
    np.testing.assert_array_equal(snap, j.snapshot())
    assert snap[H - 1, 3] == -1.0 and snap[1, W - 1] == -2.0 and snap[0, 0] == -3.0
    assert snap[1, 2] == -5.0 and snap[5, W - 5] == -6.0
    assert (~np.isnan(snap)).sum() == 5


def test_duplicate_cells_last_write_wins():
    j, t = _pair()
    rows, cols = np.array([9, 9, 9, 10]), np.array([4, 4, 4, 4])
    _ingest_both((j, t), rows, cols, np.array([-1.0, -2.0, -3.0, -8.0], np.float32))
    assert t.snapshot()[9, 4] == pytest.approx(-3.0)
    assert t.snapshot()[10, 4] == pytest.approx(-8.0)
    _ingest_both((j, t), [9], [4], [-5.0])  # a later flush overwrites again
    np.testing.assert_array_equal(t.snapshot(), j.snapshot())
    assert t.snapshot()[9, 4] == pytest.approx(-5.0)


def test_ingest_batch_matches_a_sequential_replay():
    # many duplicates in random order: the scatter must equal writing the
    # observations one by one in arrival order
    rng = np.random.RandomState(11)
    m = 5000
    obs = np.stack([rng.randint(0, 8, m), rng.randint(0, 9, m), rng.normal(0, 1, m)], 1).astype(np.float32)
    ebuf = torch.zeros(8 * 9 + 1)
    vbuf = torch.zeros(8 * 9 + 1)
    _ingest_batch(ebuf, vbuf, torch.from_numpy(obs), 9)
    want_e = np.zeros(8 * 9, np.float32)
    want_v = np.zeros(8 * 9, np.float32)
    for r, c, v in obs:
        want_e[int(r) * 9 + int(c)] = v
        want_v[int(r) * 9 + int(c)] = 1.0
    np.testing.assert_array_equal(ebuf[:-1].numpy(), want_e)
    np.testing.assert_array_equal(vbuf[:-1].numpy(), want_v)


def test_stage_overflow_flushes():
    j, t = _pair()
    rows, cols, vals = _survey(7, 5000)  # > stage capacity 256 * 16
    _ingest_both((j, t), rows, cols, vals)
    assert t._staged == j._staged < t.stage_cap
    np.testing.assert_array_equal(t.snapshot(), j.snapshot())


def test_flush_is_lazy_idempotent_and_copies_the_stage():
    _, t = _pair()
    t.ingest([1], [2], [-4.0])
    assert t._staged == 1
    assert t.flush() == 1
    assert t.flush() == 0
    t._stage[:] = 99.0  # the flushed rows were copied, not aliased
    assert t.snapshot()[1, 2] == pytest.approx(-4.0)


def test_window_clamps_at_edges():
    j, t = _pair()
    for centre in ((0, 0), (H - 1, W - 1), (5, W // 2)):
        _, origin = t.window_fill(*centre)
        _, j_origin = j.window_fill(*centre)
        assert origin == j_origin
    assert t.window_fill(0, 0)[1] == (0, 0)
    assert t.window_fill(H - 1, W - 1)[1] == (H - 64, W - 64)


@pytest.mark.parametrize("method", ["idw", "mean", "kriging"])
def test_window_fill_matches_jax(method):
    j, t = _pair(method, k=8)
    rows, cols, vals = _survey(2, 6000, lo=(40, 50), hi=(120, 150))
    _ingest_both((j, t), rows, cols, vals)
    got, origin = t.window_fill(80, 96)
    want, j_origin = j.window_fill(80, 96)
    assert origin == j_origin
    _assert_close(got, want, *BARS[method])
    # observed cells keep their values
    obs = t.valid[origin[0]:origin[0] + 64, origin[1]:origin[1] + 64] > 0.5
    np.testing.assert_array_equal(got[obs].numpy(), t.elev[origin[0]:origin[0] + 64, origin[1]:origin[1] + 64][obs].numpy())


@pytest.mark.parametrize("method", ["idw", "mean"])
def test_keep_observed_matches_jax_window_planes(method):
    # B3's keep_observed on the mosaic's window views is the JAX package's
    # window rule: its fill, then where(valid > 0.5, elev, fill)
    import jax.numpy as jnp
    from auvtpu.streaming import _fill_window_planes as j_window_planes

    from auvtpu_torch.grid import RegularGrid

    j, t = _pair(method, k=8)
    rows, cols, vals = _survey(3, 5000, lo=(30, 40), hi=(130, 150))
    _ingest_both((j, t), rows, cols, vals)
    t.flush()
    r0, c0 = 48, 70
    we, wv = t.elev[r0:r0 + 64, c0:c0 + 64], t.valid[r0:r0 + 64, c0:c0 + 64]
    want = j_window_planes(jnp.asarray(we.numpy()), jnp.asarray(wv.numpy()), j._meta, r0, c0, None, method=method,
                           k=8, max_radius=5, steps=j._steps)
    fill = wf.fill_idw_fused if method == "idw" else wf.fill_mean_fused
    got = fill(RegularGrid(we, wv, *t._meta), k=8, max_radius=5, keep_observed=True)
    _assert_close(got, want, *BARS[method])
    obs = wv > 0.5
    assert obs.any() and torch.equal(got[obs], we[obs])


def test_window_uncertainty_matches_jax():
    j, t = _pair()
    rows, cols, vals = _survey(6, 3000, lo=(64, 80), hi=(96, 112))
    _ingest_both((j, t), rows, cols, vals)
    got, origin = t.window_uncertainty(80, 96)
    want, j_origin = j.window_uncertainty(80, 96)
    assert origin == j_origin
    _assert_close(got, want, *BARS["kriging"])
    g = got.numpy()
    w_obs = t.valid[origin[0]:origin[0] + 64, origin[1]:origin[1] + 64].numpy() > 0.5
    assert (g[w_obs] == 0).all()
    gaps = ~w_obs & np.isfinite(g)
    assert gaps.any() and (g[gaps] > 0).all()
    with pytest.raises(ValueError):
        t._window(80, 96, method="idw", variance=True)


def test_fit_variogram_self_tunes_kriging_fill():
    _, t = _pair("kriging")
    rows, cols, vals = _survey(4, 3000, lo=(48, 64), hi=(112, 128))
    t.ingest(rows, cols, vals)
    t_default, _ = t.window_fill(80, 96)
    vp = t.fit_variogram(max_lag=5, n_bins=5)
    assert all(torch.is_tensor(v) and v.ndim == 0 and float(v) > 0 for v in vp)
    t_fitted, _ = t.window_fill(80, 96)
    assert not torch.equal(t_default, t_fitted)
    assert torch.isfinite(t_fitted).any()


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    j, _ = _pair("kriging")
    rows, cols, vals = _survey(8, 4000, lo=(30, 40), hi=(130, 150))
    j.ingest(rows, cols, vals)
    path = str(tmp_path / "mosaic.npz")
    j.save(path)
    t = StreamingInterpolator.load(path, device="cpu")
    assert t.shape == tuple(j.shape) and t.window == j.window and t.method == j.method
    assert (t.k, t.max_radius, t._vparams) == (j.k, j.max_radius, None)
    np.testing.assert_array_equal(t.snapshot(), j.snapshot())
    for method in ("kriging", "idw"):
        t.method = j.method = method
        _assert_close(t.window_fill(80, 96)[0], j.window_fill(80, 96)[0], *BARS[method])
    # fitted parameters travel in the checkpoint, exactly
    j.fit_variogram(max_lag=5, n_bins=5)
    j.save(path)
    t = StreamingInterpolator.load(path, device="cpu")
    assert [float(v) for v in t._vparams] == [float(v) for v in j._vparams]
    # and the resumed port keeps working
    t.ingest([3], [4], [-42.0])
    assert t.snapshot()[3, 4] == pytest.approx(-42.0)


def test_port_checkpoint_loads_into_jax(tmp_path):
    _, t = _pair()
    rows, cols, vals = _survey(9, 800)
    t.ingest(rows, cols, vals)
    path = str(tmp_path / "mosaic.npz")
    t.save(path)
    j = JStream.load(path)
    np.testing.assert_array_equal(j.snapshot(), t.snapshot())
    assert j.window == t.window and j.method == t.method and j.k == t.k


def test_cpu_mosaic_never_launches():
    _, t = _pair("kriging")
    rows, cols, vals = _survey(5, 2000)
    t.ingest(rows, cols, vals)
    wf.reset_launches()
    for method in ("idw", "mean", "kriging"):
        t.method = method
        t.window_fill(80, 96)
    t.window_uncertainty(80, 96)
    assert all(n == 0 for n in wf.LAUNCHES.values())
