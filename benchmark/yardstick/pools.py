"""The inputs of a cell's requests, made from ``--seed`` on the device: a
pool of masked tiles (Grid B) or of query batches (Grid A) over the
configuration's terrain.

A traffic mix names its pool maker by dotted path (``inputs``); a maker
takes (configuration, traffic, seed, device, grid_class=None) and returns
one dict a pool entry.  ``ref`` holds the raw inputs the plain reference
reads; with ``grid_class`` (the program's grid type, named by the
configuration) the entry also holds what the program is handed: ``grid``
and the entry's cells or queries.  Called again with the
same seed and no ``grid_class``, a maker gives the reference the same
inputs without the program's objects.
"""

from __future__ import annotations

import torch

from .draws import generator, mask_cells, query_batch
from .names import resolve


def _terrain(cfg: dict, device) -> torch.Tensor:
    t = cfg["terrain"]
    return resolve(t["generator"])(tuple(cfg["shape"]), t["seed"], device).to(torch.float32)


def _extent(cfg: dict) -> dict:
    min_lon, max_lon, min_lat, max_lat = cfg["extent"]
    return dict(min_lon=min_lon, max_lon=max_lon, min_lat=min_lat, max_lat=max_lat)


def masked_tiles(cfg: dict, traffic: dict, seed: int, device, grid_class=None) -> list[dict]:
    """``traffic["pool"]`` copies of the tile, each with its own mask of
    ``traffic["removal"]``: observed planes zero-filled at the masked
    cells, the masked cells as (rows, cols) in draw order and as flat
    indices."""
    elev = _terrain(cfg, device)
    H, W = elev.shape
    gen = generator(seed, device)
    pool = []
    for _ in range(traffic["pool"]):
        flat = mask_cells(gen, (H, W), traffic["removal"])
        valid = torch.ones(H * W, dtype=torch.float32, device=device)
        valid[flat] = 0.0
        valid = valid.reshape(H, W)
        planes = dict(elev=elev * valid, valid=valid, rows=flat // W, cols=flat % W)
        entry = dict(planes, flat=flat, ref=planes, n=flat.numel())
        if grid_class is not None:
            entry["grid"] = grid_class(elev=planes["elev"], valid=valid, **_extent(cfg))
        pool.append(entry)
    return pool


def query_batches(cfg: dict, traffic: dict, seed: int, device, grid_class=None) -> list[dict]:
    """One fully valid grid and ``traffic["pool"]`` batches of
    ``traffic["batch"]`` uniform queries over it."""
    elev = _terrain(cfg, device)
    valid = torch.ones_like(elev)
    gen = generator(seed, device)
    grid = None if grid_class is None else grid_class(elev=elev, valid=valid, **_extent(cfg))
    pool = []
    for _ in range(traffic["pool"]):
        lons, lats = query_batch(gen, traffic["batch"], cfg["extent"], traffic["eps"])
        entry = dict(lons=lons, lats=lats, ref=dict(elev=elev, valid=valid, lons=lons, lats=lats), n=lons.numel())
        if grid is not None:
            entry["grid"] = grid
        pool.append(entry)
    return pool

