"""The port's main entry point: fit the variogram from the observed cells,
krige-fill the masked grid, keep the observed values (counterpart of
``__graft_entry__.entry``)."""

from __future__ import annotations

import torch

from .config import Extent
from .grid import RegularGrid
from .masking import mask_grid
from .ops.dense import fill_kriging
from .synthetic import shelf_seamount
from .utils.profiling import spanned
from .variogram import fit_variogram


def tiny_masked_grid(h: int = 96, w: int = 64, removal: float = 0.2, *, device="cuda") -> RegularGrid:
    """The small masked shelf-and-seamount grid of ``__graft_entry__``: unit
    steps, 20% of cells removed with seed 3."""
    elev = shelf_seamount(h, w)
    elev, _, _ = mask_grid(elev, removal, seed=3)
    return RegularGrid.from_nan_array(
        elev, Extent(0.0, float(w - 1), 0.0, float(h - 1)), device=device
    )


@spanned
def fit_fill(grid: RegularGrid, *, backend: str = "fused"):
    """Fit an exponential variogram to ``grid``, krige-fill every cell with
    it, and keep the observed values.  Returns (filled plane, (nugget, sill,
    range)), the parameters as 0-d tensors on the grid's device."""
    vparams = fit_variogram(grid)
    plane = fill_kriging(grid, vparams=vparams, backend=backend)
    return torch.where(grid.valid > 0.5, grid.elev, plane), vparams


def dryrun_multichip(n_ranks: int, *, device="cuda") -> dict:
    """Spawn ``n_ranks`` ranks on this machine and run the distributed
    steps of ``__graft_entry__.dryrun_multichip`` on tiny shapes: the
    sharded fit+fill, the 2-D fill, query data parallelism, the 1-D and 2-D
    streaming cycles (bit-equal to one device) and the sharded atlas served
    through the resampler.  ``device`` is each rank's (the card by default;
    on a machine with one card every rank shares it over gloo).  Any failed
    check raises; returns rank 0's summary."""
    from .parallel.launch import spawn

    return spawn(_dryrun_rank, n_ranks, n_ranks, device, device=device, timeout=300.0)[0]


def _dryrun_rank(n: int, device) -> dict:
    import numpy as np

    from .config import Extent
    from .ops import scattered_idw
    from .ops.band import AtlasResampler, build_atlas, plan_segments
    from .parallel import (ShardedStreamingInterpolator, ShardedStreamingInterpolator2D, build_atlas_sharded,
                           gather_queries, make_mesh, make_mesh2d, shard_queries, sharded_fill2d, sharded_fit_fill)
    from .parallel.mesh import rank_device
    from .streaming import StreamingInterpolator

    dev = rank_device(device)
    mesh = make_mesh(n, device=dev)
    g = tiny_masked_grid(h=16 * n, w=64, device=dev)
    sharded, vparams = sharded_fit_fill(mesh, g, max_radius=10, max_lag=10)
    assert sharded.shape == g.shape and sharded.to_local().shape[0] == -(-g.shape[0] // n)
    plane = sharded.full_tensor()
    assert all(bool(torch.isfinite(v)) for v in vparams)
    # the fill must predict something finite for the vast majority of gaps
    gaps = g.valid < 0.5
    assert float(torch.isfinite(plane[gaps]).float().mean()) > 0.99

    # 2-D blocks: rows and columns, multi-hop halos (blocks may be narrower
    # than the radius-10 window in either axis)
    mesh2 = make_mesh2d(device=dev)
    assert mesh2.size == n
    plane2 = sharded_fill2d(mesh2, g, "kriging", max_radius=10).full_tensor()
    assert plane2.shape == g.shape
    assert float(torch.isfinite(plane2[gaps]).float().mean()) > 0.99

    # query data parallelism: the grid replicated, the batch split
    rng = np.random.RandomState(0)
    lons = rng.uniform(1.0, 62.0, 1000).astype(np.float32)
    lats = rng.uniform(1.0, 16.0 * n - 2.0, 1000).astype(np.float32)
    (slon, slat), n_valid = shard_queries(mesh, lons, lats)
    out = gather_queries(mesh, scattered_idw(g, slon, slat), n_valid)
    assert out.shape == (1000,)
    assert float(torch.isfinite(out).float().mean()) > 0.99
    # each query's arithmetic is its own: the shards' answers are the whole
    # batch's (tests/test_torch_parallel.py holds them bit for bit on the CPU)
    whole = scattered_idw(g, torch.from_numpy(lons).to(dev), torch.from_numpy(lats).to(dev))
    assert torch.allclose(out, whole, rtol=1e-6, atol=0.0, equal_nan=True)

    # streaming x sharding: one ingest -> window-fill cycle on row bands and
    # on 2-D blocks, each against the one-device mosaic bit for bit
    Hs, Ws = 12 * n + 5, 48  # not divisible: pad rows
    ext = Extent(0.0, float(Ws - 1), 0.0, float(Hs - 1))
    kw = dict(swath_cap=64, stage_slots=2, window=(16, 16), method="idw", k=4, max_radius=5)
    single = StreamingInterpolator((Hs, Ws), ext, device=dev, **kw)
    sharded = ShardedStreamingInterpolator((Hs, Ws), ext, mesh, **kw)
    sharded2 = ShardedStreamingInterpolator2D((Hs, Ws), ext, mesh2, **kw)
    rows = rng.randint(0, Hs, 300)
    cols = rng.randint(0, Ws, 300)
    vals = rng.normal(-2000.0, 50.0, 300).astype(np.float32)
    tile_a, origin_a = None, None
    for si in (single, sharded, sharded2):
        si.ingest(rows, cols, vals)
        tile, origin = si.window_fill(Hs // 2, Ws // 2)
        if tile_a is None:
            tile_a, origin_a = tile, origin
        assert origin == origin_a
        assert torch.equal(torch.isnan(tile), torch.isnan(tile_a))
        assert torch.equal(torch.nan_to_num(tile), torch.nan_to_num(tile_a)), \
            f"{type(si).__name__} diverged from the one-device mosaic"

    # the mission atlas, pages one per rank, bit-equal to the one-device
    # atlas, served through the page-routed resampler
    Hd, Wd = 16 * n, 256
    gd = tiny_masked_grid(h=Hd, w=Wd, removal=0.1, device=dev)
    td = np.linspace(0, 1, 1024)
    xq = 1.0 + td * (Wd - 3)
    yq = np.clip(1.0 + td * (Hd - 3) + 2 * np.sin(td * 20 * np.pi), 0.5, Hd - 1.5)
    segs = plan_segments(xq, yq, chunk=128, max_bands=n, grid_shape=gd.shape)
    atlas_s = build_atlas_sharded(gd, segs, mesh)
    atlas_1 = build_atlas(gd, segs)
    assert torch.equal(atlas_s.planes, atlas_1.planes) and torch.equal(atlas_s.vmasks, atlas_1.vmasks)
    lonq = gd.min_lon + xq * gd.lon_step
    latq = gd.min_lat + yq * gd.lat_step
    zq, okq = AtlasResampler(gd, atlas_s, chunk=128).resample(lonq, latq)
    assert float(okq.float().mean()) > 0.5 and bool(torch.isfinite(zq[okq]).all())
    return {"ranks": n, "device": str(dev), "transport": mesh.transport, "vparams": [float(v) for v in vparams],
            "pages": len(atlas_s.placed), "resolved": float(okq.float().mean())}
