"""Batch chunking for scattered ops (counterpart of :mod:`auvtpu.ops.batch`).

The windowed scattered ops materialize (N, (2R+1)^2) candidate tensors; at
radius 10 that is 1.7 KB a query, so multi-million-point batches run in
chunks.  PyTorch compiles nothing per shape, so the last chunk is simply
shorter (the JAX version pads it to one compiled shape).
"""

from __future__ import annotations

import torch


def apply_chunked(fn, grid, lons, lats, *, chunk: int = 1 << 20, **kw):
    """``fn(grid, lons_chunk, lats_chunk, **kw)`` over chunks of at most
    ``chunk`` queries, concatenated into one (N,) tensor."""
    lons = torch.as_tensor(lons)
    lats = torch.as_tensor(lats)
    n = lons.shape[0]
    if n <= chunk:
        return fn(grid, lons, lats, **kw)
    return torch.cat([fn(grid, lons[s:s + chunk], lats[s:s + chunk], **kw) for s in range(0, n, chunk)])
