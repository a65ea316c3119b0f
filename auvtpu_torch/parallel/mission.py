"""Sharded mission-atlas fills: band pages dealt over the ranks of a mesh
(counterpart of :mod:`auvtpu.parallel.mission`).

The pages of ``plan_segments`` are independent fills of one snapped
shape, so a K-page atlas fills in ceil(K / D) page fills on D ranks
instead of K.  :func:`build_atlas_sharded` deals the pages to the ranks
(the list padded by repeating the last page), each rank fills its own with
:func:`fill_page_dynamic` (B1 a page on a CUDA float32 grid), and the
stacks are gathered, so every rank returns the :class:`BandAtlas` that
:func:`auvtpu_torch.ops.band.build_atlas` gives, bit for bit, and it serves
through :class:`~auvtpu_torch.ops.band.AtlasResampler` and B8.

Why bit-equal: ``fill_page_dynamic`` fills a FIXED (pr+2m, pc+2m) window
shifted inside the grid, a superset of ``fill_band``'s edge-clipped crop;
each cell reads only its radius-10 window, whose content is the same in
both crops when m >= 10, and the fills take the window's global (row0,
col0), so each cell's arithmetic is the same.
"""

from __future__ import annotations

import torch

from ..grid import RegularGrid
from ..ops.band import BandAtlas, place_segments
from .mesh import Mesh, _check_member, all_gather


def fill_page_dynamic(grid: RegularGrid, origin, pr: int, pc: int, *, method: str = "kriging", margin: int = 10,
                      fill_backend: str = "auto", convention: str = "reference", vparams=None,
                      model: str = "exponential"):
    """One (pr, pc) page fill at ``origin`` (row0, col0): a fixed-size
    margin-expanded window, shifted inside the grid at its edges, filled
    with global variogram geometry, then the page cropped back.  Returns
    (plane, vmask) with observed cells kept and undefined cells zeroed, as
    :func:`~auvtpu_torch.ops.band.fill_band` does."""
    from ..ops.dense import fill_idw, fill_kriging

    H, W = grid.shape
    o0, o1 = (int(v) for v in origin)
    eh, ew = min(pr + 2 * margin, H), min(pc + 2 * margin, W)
    r0 = min(max(o0 - margin, 0), H - eh)
    c0 = min(max(o1 - margin, 0), W - ew)
    sub = RegularGrid(elev=grid.elev[r0:r0 + eh, c0:c0 + ew], valid=grid.valid[r0:r0 + eh, c0:c0 + ew],
                      min_lon=grid.min_lon, max_lon=grid.max_lon, min_lat=grid.min_lat, max_lat=grid.max_lat)
    if method == "kriging":
        filled = fill_kriging(sub, row0=r0, col0=c0, steps=(grid.lat_step, grid.lon_step), vparams=vparams,
                              convention=convention, backend=fill_backend, model=model)
    elif method == "idw":
        filled = fill_idw(sub, convention=convention, backend=fill_backend)
    else:
        raise ValueError(method)
    filled = filled[o0 - r0:o0 - r0 + pr, o1 - c0:o1 - c0 + pc]
    ev = grid.elev[o0:o0 + pr, o1:o1 + pc]
    va = grid.valid[o0:o0 + pr, o1:o1 + pc]
    plane = torch.where(va > 0.5, ev, filled)
    undefined = torch.isnan(plane)
    return torch.where(undefined, torch.zeros_like(plane), plane), (~undefined).to(grid.dtype)


def build_atlas_sharded(grid: RegularGrid, segments, mesh: Mesh, *, method: str = "kriging", margin: int = 10,
                        fill_backend: str = "auto", convention: str = "reference", vparams=None,
                        model: str = "exponential", assume_masked: bool | None = None) -> BandAtlas:
    """Mesh twin of :func:`~auvtpu_torch.ops.band.build_atlas`: the pages
    fill one per rank, on every rank's copy of ``grid`` (the grid is
    replicated; the atlas is small by construction), and every rank returns
    the whole atlas on the grid's device.  Any page count works on any 1-D
    mesh: the page list is padded to a multiple of the mesh size by
    repeating its last page, and the duplicates are dropped."""
    _check_member(mesh, "build_atlas_sharded")
    if len(mesh.shape) != 1:
        raise ValueError(f"build_atlas_sharded needs a 1-D mesh (got axes {mesh.axis_names}); a second axis "
                         "would duplicate every page fill")
    if margin < 10:
        # the fills select to radius 10 whatever the margin: fill_band's
        # clipped crop and this shifted window would then show different
        # neighbours at the grid's edge pages, and the atlases would differ
        raise ValueError("build_atlas_sharded requires margin >= 10 (the fills' selection radius)")
    placed, pr, pc = place_segments(segments, grid.shape)
    K, D = len(placed), mesh.size
    per = -(-K // D)
    padded = list(placed) + [placed[-1]] * (per * D - K)
    mine = [fill_page_dynamic(grid, o, pr, pc, method=method, margin=margin, fill_backend=fill_backend,
                              convention=convention, vparams=vparams, model=model)
            for o in padded[mesh.index * per:(mesh.index + 1) * per]]
    stack = torch.stack([torch.stack([p, m]) for p, m in mine])  # (per, 2, pr, pc)
    pages = torch.cat(all_gather(mesh, stack))[:K]
    planes, vmasks = pages[:, 0].contiguous(), pages[:, 1].contiguous()
    masked = bool(vmasks.min() < 0.5) if assume_masked is None else bool(assume_masked)
    return BandAtlas(planes=planes, vmasks=vmasks, origins=torch.tensor(placed, dtype=grid.dtype, device=grid.device),
                     masked=masked, placed=tuple(placed))
