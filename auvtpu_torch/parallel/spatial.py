"""Spatially sharded dense fills: 1-D row bands and 2-D blocks with
multi-hop halo exchange (counterpart of :mod:`auvtpu.parallel.spatial`).

The dense fills (:mod:`auvtpu_torch.ops.dense`) look at most
``max_radius`` rows and columns away, so a block needs only a
``max_radius``-deep halo from its neighbours.  Each rank takes its block of
the grid, receives the halo strips from its neighbours by point-to-point
exchange (a rank with no neighbour at a hop receives zeros: invalid cells,
the global edge's convention, as ``ppermute`` gives), runs the unchanged
one-device fill on the halo-extended block (B1 for kriging, B3 for idw and
mean on a CUDA float32 block) and crops the halo off.  The result stays
sharded, as the JAX function's global array does (``out_specs`` ``P("dp",
None)`` or ``P("dy", "dx")``): a :class:`ShardedPlane` holding this rank's
band or block, whose ``full_tensor()`` gathers the plane where a caller
needs all of it (JAX's ``process_allgather``).  So no rank holds more than
its share of a grid bigger than one device.

- **Multi-hop halos**: a halo deeper than a block is assembled from the
  blocks up to ceil(R / blk) hops away, so blocks may be shorter than R.
- **2-D meshes**: row halos first, then column halos of the row-extended
  block, which carry the corner cells without a diagonal exchange.
- **Bit-equality**: a cell's fill reads only its radius-R window, whose
  content is the same in the halo-extended block as in the whole grid, and
  B1 and the plain kriging build each cell's coordinates from its global
  index (``row0 = rank * blk - R``), so a sharded fill equals the
  one-device fill on the same device bit for bit.  The fit of
  :func:`sharded_fit_fill` adds its blocks' pair sums in float64 and rounds
  them once, as the one-device sums are taken, so its parameters are the
  one-device fit's too.
"""

from __future__ import annotations

import torch

from ..grid import RegularGrid
from ..ops import dense as dense_ops
from .mesh import Mesh, _check_member, all_gather, exchange, psum


def _collect_halo(x: torch.Tensor, R: int, mesh: Mesh, axis_name: str, dim: int, sides=("before", "after")):
    """The R-deep halos of ``x`` along ``dim`` from the blocks up to
    ceil(R / blk) hops away along mesh axis ``axis_name``, one exchange for
    every hop and side.  Returns {side: halo}: 'before' the R rows (or
    columns) just before this block, 'after' those just after; blocks past
    the mesh's edge give zeros.

    Hop h takes min(blk, R - (h-1) blk) rows of the block h away: its
    trailing rows for 'before', its leading rows for 'after'."""
    blk = x.shape[dim]
    if blk == 0:
        raise ValueError("_collect_halo: empty block")
    hops = -(-R // blk)
    sends, recvs, slots = [], [], []
    parts = {side: [] for side in sides}
    for h in range(1, hops + 1):
        take = min(blk, R - (h - 1) * blk)
        strips = {"before": x.narrow(dim, blk - take, take), "after": x.narrow(dim, 0, take)}
        for side in sides:
            # 'before': my trailing rows go to the block h after me, and the
            # block h before me sends me its own; 'after' the other way
            to, frm = (h, -h) if side == "before" else (-h, h)
            dst, src = mesh.peer(axis_name, to), mesh.peer(axis_name, frm)
            if dst is not None:
                sends.append((dst, strips[side]))
            if src is None:
                parts[side].append(torch.zeros_like(strips[side]))
            else:
                recvs.append((src, strips[side]))
                slots.append((side, len(parts[side])))
                parts[side].append(None)
    for (side, j), got in zip(slots, exchange(mesh, sends, recvs)):
        parts[side][j] = got
    return {side: torch.cat(p[::-1] if side == "before" else p, dim=dim) for side, p in parts.items()}


def _halo_extend(e, v, R: int, mesh: Mesh, axis_name: str, dim: int = 0):
    """The block (elev, valid) extended by R-deep halos on both sides
    along ``dim``; elevation and validity travel as one stacked strip."""
    x = torch.stack([e, v])
    h = _collect_halo(x, R, mesh, axis_name, dim + 1)
    big = torch.cat([h["before"], x, h["after"]], dim=dim + 1)
    return big[0], big[1]


def _fill_block(g: RegularGrid, method: str, *, k: int, power: float, R: int, row0=0, col0=0, steps, vparams=None,
                backend: str = "auto"):
    """One block's dense fill: the one-device fills with their backends
    ('auto': B1 or B3 on a CUDA float32 block, the plain versions
    otherwise); idw and mean are geometry-free, kriging takes the block's
    global origin and the global steps."""
    if method == "idw":
        return dense_ops.fill_idw(g, k=k, power=power, max_radius=R, backend=backend)
    if method == "window_mean":
        return dense_ops.fill_window_mean(g, k=k, max_radius=R, backend=backend)
    if method == "kriging":
        return dense_ops.fill_kriging(g, max_radius=R, row0=row0, col0=col0, steps=steps, vparams=vparams,
                                      backend=backend)
    # 'bilinear' is not offered: its far-edge semantics duplicate the edge
    # (GridH.cpp:170-173), which a zero-validity halo cannot represent
    raise ValueError(method)


def _block(t: torch.Tensor, r0: int, nr: int, c0: int, nc: int, device) -> torch.Tensor:
    """t[r0:r0+nr, c0:c0+nc] on ``device``, zero-padded where it runs past
    the plane (pad rows and columns are invalid cells)."""
    H, W = t.shape
    part = t[min(r0, H):min(r0 + nr, H), min(c0, W):min(c0 + nc, W)].to(device)
    if part.shape != (nr, nc):
        part = torch.nn.functional.pad(part, (0, nc - part.shape[1], 0, nr - part.shape[0]))
    return part


def _like(grid: RegularGrid, e, v) -> RegularGrid:
    """A block with the global grid's bounds (the block's geometry comes
    from its origin and the global steps)."""
    return RegularGrid(elev=e, valid=v, min_lon=grid.min_lon, max_lon=grid.max_lon, min_lat=grid.min_lat,
                       max_lat=grid.max_lat)


def _axis_1d(mesh: Mesh, what: str) -> str:
    _check_member(mesh, what)
    if len(mesh.shape) != 1:
        raise ValueError(f"{what} needs a 1-D mesh, got axes {mesh.axis_names}")
    return mesh.axis_names[0]


def _gather_blocks(mesh: Mesh, block: torch.Tensor, n_rows: int, n_cols: int) -> torch.Tensor:
    """The global plane from every rank's block (row bands on a 1-D mesh),
    laid out in mesh order, pad cells dropped."""
    ny, nx = mesh.shape if len(mesh.shape) == 2 else (mesh.size, 1)
    parts = all_gather(mesh, block)
    rows = [torch.cat(parts[iy * nx:(iy + 1) * nx], dim=1) for iy in range(ny)]
    return torch.cat(rows)[:n_rows, :n_cols]


class ShardedPlane:
    """An (H, W) plane split over a mesh, each rank holding its own part:
    the row band ``[i*blk, (i+1)*blk)`` on a 1-D mesh, the block of its
    (row, col) coordinates on a 2-D mesh, with ``blk = ceil(H / n)`` (and
    ``ceil(W / nx)``), torch's chunk sizes; the parts past the plane's edge
    are cropped, so the last band may be shorter, or empty.

    torch's ``DTensor`` with ``Shard`` placements is the closest
    counterpart, but its gather of CUDA local tensors over gloo (the
    transport of ranks that share a card) crashes the process; this class
    gathers through :func:`.mesh.all_gather`, which stages CUDA tensors
    through the host under gloo."""

    def __init__(self, mesh: Mesh, local: torch.Tensor, shape: tuple[int, int], block: tuple[int, int]):
        self._mesh = mesh
        self._local = local
        self._block = block
        self.shape = torch.Size(shape)

    def to_local(self) -> torch.Tensor:
        """This rank's band or block, on its device."""
        return self._local

    def full_tensor(self) -> torch.Tensor:
        """The whole plane on this rank's device.  A collective: every rank
        of the mesh calls it."""
        (br, bc), (h, w) = self._block, self._local.shape
        part = torch.nn.functional.pad(self._local, (0, bc - w, 0, br - h))
        return _gather_blocks(self._mesh, part, *self.shape)


def _own(mesh: Mesh, block: torch.Tensor, shape: tuple[int, int]) -> ShardedPlane:
    """The ShardedPlane of this rank's filled ``block`` (its halo cropped),
    the rows and columns past the plane dropped."""
    H, W = shape
    br, bc = block.shape
    iy, ix = mesh.coords if len(mesh.shape) == 2 else (mesh.index, 0)
    rows, cols = max(0, min(br, H - iy * br)), max(0, min(bc, W - ix * bc))
    return ShardedPlane(mesh, block[:rows, :cols].contiguous(), shape, (br, bc))


def _fit_1d(mesh: Mesh, axis: str, e, v, blk: int, steps, max_lag: int, n_bins: int):
    """The distributed exponential fit on row bands: each band's pair sums
    with its 'after' halo of max_lag rows (pairs count once by the
    half-plane convention; the block owning a pair's first point counts
    it), summed over the mesh in rank order, then the fit on every rank.
    Returns (nugget, sill, range) as 0-d tensors."""
    from ..variogram import pair_sums

    x = torch.stack([e, v])
    bot = _collect_halo(x, max_lag, mesh, axis, 1, sides=("after",))["after"]
    s, c = pair_sums(torch.cat([e, bot[0]]), torch.cat([v, bot[1]]), blk, max_lag=max_lag, n_bins=n_bins)
    return _fit_from_sums(mesh, s, c, e.dtype, steps, max_lag, n_bins)


def _fit_from_sums(mesh: Mesh, s, c, dtype, steps, max_lag: int, n_bins: int):
    """The fit from every block's float64 pair sums: summed over the mesh,
    then rounded to ``dtype`` once, so the sums (and the fit) are the
    one-device ones."""
    from ..grid import as_dtype
    from ..variogram import _bin_table, fit_exponential

    s, c = psum(mesh, torch.stack([s, c])).to(dtype)
    gamma = torch.where(c > 0, s / (2.0 * torch.clamp(c, min=1.0)), torch.zeros_like(s))
    _, _, _, centers = _bin_table(max_lag, n_bins)
    step = as_dtype(0.5 * (abs(steps[0]) + abs(steps[1])), s.dtype)
    lags = torch.as_tensor(centers, dtype=s.dtype).to(s.device) * step
    return fit_exponential(lags, gamma, c)


def sharded_fit_fill(mesh: Mesh, grid: RegularGrid, *, max_radius: int = 10, max_lag: int = 10, n_bins: int = 10,
                     backend: str = "auto"):
    """The distributed fit-then-fill: fit the exponential variogram from the
    observed cells (pair sums over row bands, summed over the mesh) and
    krige-fill the grid with the fitted parameters.  Returns (the
    :class:`ShardedPlane` of the (H, W) raw fill (observed cells not kept),
    (nugget, sill, range) on every rank), as
    ``auvtpu.parallel.sharded_fit_fill``."""
    axis = _axis_1d(mesh, "sharded_fit_fill")
    n, i = mesh.size, mesh.index
    H, W = grid.shape
    blk = -(-H // n)
    R = max(max_radius, max_lag)
    e = _block(grid.elev, i * blk, blk, 0, W, mesh.device)
    v = _block(grid.valid, i * blk, blk, 0, W, mesh.device)
    steps = (grid.lat_step, grid.lon_step)
    vparams = _fit_1d(mesh, axis, e, v, blk, steps, max_lag, n_bins)
    be, bv = _halo_extend(e, v, R, mesh, axis)
    out = _fill_block(_like(grid, be, bv), "kriging", k=4, power=2.0, R=max_radius, row0=i * blk - R, steps=steps,
                      vparams=vparams, backend=backend)
    return _own(mesh, out[R:R + blk], (H, W)), vparams


def sharded_fill(mesh: Mesh, grid: RegularGrid, method: str = "idw", *, k: int = 8, power: float = 2.0,
                 max_radius: int = 10, backend: str = "auto"):
    """Dense fill over row bands of a 1-D mesh; returns the
    :class:`ShardedPlane` of the (H, W) plane, this rank's band on its
    device.  The grid is padded with invalid rows to a multiple of the mesh
    size; bands may be shorter than ``max_radius`` (multi-hop halos).
    ``grid`` may lie on any device: each rank copies only its band to its
    own."""
    axis = _axis_1d(mesh, "sharded_fill")
    n, i = mesh.size, mesh.index
    H, W = grid.shape
    blk = -(-H // n)
    R = max_radius
    e = _block(grid.elev, i * blk, blk, 0, W, mesh.device)
    v = _block(grid.valid, i * blk, blk, 0, W, mesh.device)
    be, bv = _halo_extend(e, v, R, mesh, axis)
    out = _fill_block(_like(grid, be, bv), method, k=k, power=power, R=R, row0=i * blk - R,
                      steps=(grid.lat_step, grid.lon_step), backend=backend)
    return _own(mesh, out[R:R + blk], (H, W))


def sharded_fill2d(mesh: Mesh, grid: RegularGrid, method: str = "idw", *, k: int = 8, power: float = 2.0,
                   max_radius: int = 10, backend: str = "auto"):
    """Dense fill over the blocks of a 2-D (rows, cols) mesh; returns the
    :class:`ShardedPlane` of the (H, W) plane, this rank's block on its
    device.  Row halos first, then column halos of the
    row-extended block (the corners ride along); blocks smaller than
    ``max_radius`` in either axis take multi-hop halos.  The layout for a
    grid too wide for row bands: a block's halo grows with its perimeter."""
    _check_member(mesh, "sharded_fill2d")
    if len(mesh.shape) != 2:
        raise ValueError(f"sharded_fill2d needs a 2-D mesh, got axes {mesh.axis_names}")
    ay, ax = mesh.axis_names
    ny, nx = mesh.shape
    iy, ix = mesh.coords
    H, W = grid.shape
    blk_r, blk_c = -(-H // ny), -(-W // nx)
    R = max_radius
    e = _block(grid.elev, iy * blk_r, blk_r, ix * blk_c, blk_c, mesh.device)
    v = _block(grid.valid, iy * blk_r, blk_r, ix * blk_c, blk_c, mesh.device)
    e2, v2 = _halo_extend(e, v, R, mesh, ay, dim=0)
    be, bv = _halo_extend(e2, v2, R, mesh, ax, dim=1)
    out = _fill_block(_like(grid, be, bv), method, k=k, power=power, R=R, row0=iy * blk_r - R,
                      col0=ix * blk_c - R, steps=(grid.lat_step, grid.lon_step), backend=backend)
    return _own(mesh, out[R:R + blk_r, R:R + blk_c], (H, W))
