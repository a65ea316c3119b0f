"""Seeded draws of the traffic: masks of a Grid B tile and query batches
of Grid A, made on the device from one ``torch.Generator``.

A mask removes exactly ``int(H * W * removal)`` cells, as the reference
study's masking does (subset_bathymetry.py:32-44): the first cells of a
random permutation.  A query batch is uniform in the extent shrunk by
``eps`` on every side (test_interpolation.cpp), drawn in float64 and
rounded to float32.  One seed gives one pool; the same sizes for every
seed.
"""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    """The pool's generator on ``device``; any whole number up to 2**63 - 1
    is a seed."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def mask_cells(gen: torch.Generator, shape, removal: float) -> torch.Tensor:
    """The flat indices (int64, in draw order) of the ``int(H*W*removal)``
    cells one mask removes."""
    n = shape[0] * shape[1]
    return torch.randperm(n, generator=gen, device=gen.device)[: int(n * removal)]


def query_batch(gen: torch.Generator, n: int, extent, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(lons, lats) float32: ``n`` points uniform in the extent (min_lon,
    max_lon, min_lat, max_lat) shrunk by ``eps``."""
    min_lon, max_lon, min_lat, max_lat = extent
    u = torch.rand((2, n), generator=gen, device=gen.device, dtype=torch.float64)
    lons = (min_lon + eps) + ((max_lon - eps) - (min_lon + eps)) * u[0]
    lats = (min_lat + eps) + ((max_lat - eps) - (min_lat + eps)) * u[1]
    return lons.float(), lats.float()
