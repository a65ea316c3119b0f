"""Trajectory-band router: a dense band fill, then a chunked windowed
bilinear resample (counterpart of :mod:`auvtpu.ops.band`).

An AUV survey track is ordered and spatially coherent: consecutive pings are
a fraction of a cell apart.  Instead of serving every ping through the
scattered kriging path, the band of the grid around the track (or, for a
diagonal or L-shaped mission, a K-page atlas of thin bands along it) is
filled once, densely, by the cell-aligned fills of :mod:`.dense`, and the
pings are served by resampling that fill bilinearly:

- queries are taken in chunks of ``chunk`` consecutive pings; each chunk
  shares one (wr, wc) window of the band, based at its minimum cell (for an
  atlas, of the page that holds the chunk's bbox centre);
- a ping whose cell leaves the window or the band (or touches a cell the
  fill left undefined) is unresolved and escalates to the exact two-tier
  path (:class:`~auvtpu_torch.ops.two_tier.TwoTierInterpolator`), as
  :class:`BandRouter` does;
- the resample is the B8 kernel (:mod:`auvtpu_torch.kernels.band_resample`)
  on a CUDA float32 band, its plain version otherwise.

Semantics: in-band pings receive the bilinear resample of the cell-aligned
kriging (or IDW) fill, not per-query kriging; observed cells keep their
observed value.  ``BandRouter.route`` picks between this path and the packed
two-tier path from a measured cost model (:data:`COST_NS`).
"""

from __future__ import annotations

import dataclasses
import weakref

import numpy as np
import torch

from ..grid import RegularGrid
from .scattered import as_dtype, queries

_LANES = 128
LERP_MODES = ("onehot", "hat", "hat2", "hat_t")
# The lerp-weight family of the resample.  The four names of the JAX package
# are builds of two weight families: 'onehot' (1-f, f) and the hat function
# ('hat', 'hat2', 'hat_t': (1-f, 1-(1-f))).  B8 computes either family
# directly; the builds themselves (one-hot matmuls, slab picks, transposed
# layouts) were TPU mechanics and are not ported.
LERP_MODE_DEFAULT = "hat"
RESAMPLE_BACKENDS = ("torch", "fused", "aligned")


def _effective_chunk(n: int, chunk: int) -> int:
    """Clamp the chunk to the batch: a small batch otherwise pads into one
    full default-size chunk (a 512-ping tick at the serving default of 2048
    would resample four times its queries).  Smaller chunks have smaller
    bounding boxes, so resolution can only improve; power-of-two buckets
    (>= 256) keep the chunk sizes few."""
    if n >= chunk:
        return chunk
    c = 256
    while c < n:
        c <<= 1
    return min(c, chunk)


def _ceil_to(v: int, m: int) -> int:
    return -(-int(v) // m) * m


def _hat(lerp_mode: str) -> bool:
    """True for the hat weight family, False for one-hot."""
    if lerp_mode not in LERP_MODES:
        raise ValueError(f"lerp_mode {lerp_mode!r} is not one of {LERP_MODES}")
    return lerp_mode != "onehot"


def resolve_resample_backend(backend: str, plane: torch.Tensor) -> str:
    """``"auto"`` is ``"fused"`` (B8 with the default window geometry) for a
    CUDA float32 plane and ``"torch"`` (the plain version) otherwise;
    ``"aligned"`` is B8 with the 8/128-aligned, widened windows of
    ``pallas_band_resample`` (the JAX package's ``backend="pallas"``)."""
    if backend == "auto":
        return "fused" if plane.is_cuda and plane.dtype == torch.float32 else "torch"
    if backend not in RESAMPLE_BACKENDS:
        raise ValueError(f"resample backend {backend!r} is not one of {('auto',) + RESAMPLE_BACKENDS}")
    return backend


def _xy(grid: RegularGrid, lons, lats):
    """Grid-frame (x, y) of lon/lat queries in the grid's dtype on its
    device: ``(lon - min_lon) / lon_step`` with both scalars rounded to the
    dtype, as JAX computes it.  The steps divide as the grid's 0-d tensors
    (:meth:`RegularGrid.step_tensors`): a python-scalar divisor of a CUDA
    tensor is a multiply by its reciprocal, which can differ from the
    division by an ulp."""
    lons, lats = queries(grid, lons, lats)
    dt = grid.dtype
    lon_step, lat_step = grid.step_tensors()
    return (lons - as_dtype(grid.min_lon, dt)) / lon_step, (lats - as_dtype(grid.min_lat, dt)) / lat_step


def _affine(grid: RegularGrid, col0: int = 0, row0: int = 0):
    """The resample's coordinate prologue for lon/lat queries of ``grid``,
    (u0, du, su, v0, dv, sv) with x = (lon - u0) / du - su and y = (lat -
    v0) / dv - sv in the grid's dtype: :func:`_xy` and the shift into a band
    at (row0, col0), bit for bit (the B8 kernel and its plain version both
    compute it)."""
    dt = grid.dtype
    return tuple(as_dtype(v, dt) for v in (grid.min_lon, grid.lon_step, col0, grid.min_lat, grid.lat_step, row0))


def _pad_to_chunk(x, y, chunk: int):
    """Pad with the LAST query (a ragged last chunk stays coherent: repeating
    the last query changes neither the chunk's min nor its max)."""
    pad = (-x.shape[0]) % chunk
    if pad:
        x = torch.cat([x, x[-1:].expand(pad)])
        y = torch.cat([y, y[-1:].expand(pad)])
    return x, y


def _atlas_resample(planes, vmasks, origins, x, y, *, chunk: int, wr: int, wc: int, masked: bool, pick: bool = True, lerp_mode: str = "onehot", aligned: bool = False, plain: bool = False, affine=None):
    """Chunked windowed bilinear over a K-page atlas (``_atlas_resample``).

    planes (K, R, C) NaN-free pages (0 at undefined cells); vmasks their
    definedness, read when ``masked``; origins (K, 2) page (row0, col0) in
    the planes' dtype (None: every page at (0, 0)); x, y (N,) grid-frame
    coordinates, or lon/lat with ``affine`` (:func:`_affine`), any N (a
    ragged last chunk is reduced over its real queries).  ``pick`` False
    serves page 0 (the single band).  ``aligned`` takes the Pallas kernel's
    windows; ``plain`` runs the plain version whatever the device.  Returns
    (z, ok), z NaN where a query is unresolved."""
    from ..kernels.band_resample import IDENTITY, band_resample, band_resample_ref

    fn = band_resample_ref if plain else band_resample
    return fn(planes, vmasks if masked else None, origins, x, y, chunk=chunk, wr=wr, wc=wc,
              pick=pick, aligned=aligned, hat=_hat(lerp_mode), affine=affine or IDENTITY)


def _band_resample(plane, vmask, x, y, *, chunk: int, wr: int, wc: int, masked: bool, lerp_mode: str = "onehot", aligned: bool = False, plain: bool = False, affine=None):
    """Chunked windowed bilinear over one band plane (``_band_resample``):
    x, y are band-frame coordinates (or lon/lat with ``affine``); the band
    is a one-page atlas at origin (0, 0)."""
    return _atlas_resample(plane[None], vmask[None], None, x, y, chunk=chunk, wr=wr, wc=wc, masked=masked,
                           pick=False, lerp_mode=lerp_mode, aligned=aligned, plain=plain, affine=affine)


@dataclasses.dataclass(frozen=True)
class Band:
    """A filled rectangular sub-band of a grid (device-resident)."""

    plane: torch.Tensor   # (R, C) NaN-free values (0 at undefined cells)
    vmask: torch.Tensor   # (R, C) 1.0 where defined
    masked: bool          # any undefined cell in the band?
    row0: int
    col0: int

    @property
    def shape(self):
        return tuple(self.plane.shape)

    @property
    def cells(self) -> int:
        return int(self.plane.shape[0] * self.plane.shape[1])


def fill_band(grid: RegularGrid, row0: int, nrows: int, col0: int, ncols: int, *, method: str = "kriging", margin: int = 10, fill_backend: str = "auto", convention: str = "reference", vparams=None, model: str = "exponential", assume_masked: bool | None = None) -> Band:
    """Dense-fill the [row0:row0+nrows, col0:col0+ncols] band of ``grid``.

    The fill runs on a margin-expanded block (default margin = the fill's
    max_radius), so band-edge cells see the candidate window they would in
    a whole-grid fill, then crops back; ``row0/col0/steps`` keep the
    variogram geometry global.  Observed cells keep their observed value;
    cells the fill cannot resolve stay undefined (vmask 0, plane 0).
    ``fill_backend`` as for :func:`~auvtpu_torch.ops.dense.fill_kriging`
    (``"auto"``: the B1/B3 kernels on a CUDA float32 grid)."""
    from .dense import fill_idw, fill_kriging

    H, W = grid.shape
    row0, col0 = int(row0), int(col0)
    nrows, ncols = int(nrows), int(ncols)
    if not (0 <= row0 and row0 + nrows <= H and 0 <= col0 and col0 + ncols <= W):
        raise ValueError(f"band [{row0}:{row0 + nrows}, {col0}:{col0 + ncols}] outside grid {grid.shape}")
    r0 = max(0, row0 - margin)
    r1 = min(H, row0 + nrows + margin)
    c0 = max(0, col0 - margin)
    c1 = min(W, col0 + ncols + margin)
    sub = RegularGrid(
        elev=grid.elev[r0:r1, c0:c1], valid=grid.valid[r0:r1, c0:c1],
        # bounds only shift the variogram's absolute coords; row0/col0 and
        # the global steps place the block
        min_lon=grid.min_lon, max_lon=grid.max_lon, min_lat=grid.min_lat, max_lat=grid.max_lat,
    )
    if method == "kriging":
        filled = fill_kriging(sub, row0=r0, col0=c0, steps=(grid.lat_step, grid.lon_step), vparams=vparams,
                              convention=convention, backend=fill_backend, model=model)
    elif method == "idw":
        filled = fill_idw(sub, convention=convention, backend=fill_backend)
    else:
        raise ValueError(method)
    fr, fc = row0 - r0, col0 - c0
    filled = filled[fr:fr + nrows, fc:fc + ncols]
    ev = grid.elev[row0:row0 + nrows, col0:col0 + ncols]
    va = grid.valid[row0:row0 + nrows, col0:col0 + ncols]
    plane = torch.where(va > 0.5, ev, filled)
    undefined = torch.isnan(plane)
    vmask = (~undefined).to(grid.dtype)
    plane = torch.where(undefined, torch.zeros_like(plane), plane)
    if assume_masked is None:
        masked = bool(vmask.min() < 0.5)  # the resample's fast-path pick; 1 sync
    else:
        # caller-pinned (refresh path, no sync): True is always correct (the
        # vmask rides along); False asserts the fill covers every cell
        masked = bool(assume_masked)
    return Band(plane=plane, vmask=vmask, masked=masked, row0=row0, col0=col0)


class BandResampler:
    """Serve scattered queries from a filled band by the chunked resample.

    chunk consecutive queries share one (wr, wc) window; a chunk whose
    bounding box exceeds the window resolves only the queries that fit and
    reports the rest unresolved.  backend: ``"auto"`` (B8 on a CUDA float32
    band, the plain version otherwise), ``"fused"``, ``"aligned"`` (the
    Pallas kernel's wider 8/128-aligned windows and one-hot weights; a
    masked band takes the ``"fused"`` geometry) or ``"torch"``."""

    def __init__(self, grid: RegularGrid, band: Band, *, chunk: int = 512, win_rows: int = 48, win_cols: int = 128, backend: str = "auto", lerp_mode: str = LERP_MODE_DEFAULT):
        R, C = band.shape
        self.grid = grid
        self.band = band
        self.chunk = int(chunk)
        self.wr = min(int(win_rows), R)
        self.wc = min(int(win_cols), C)
        self.dtype = band.plane.dtype
        self.backend = resolve_resample_backend(backend, band.plane)
        _hat(lerp_mode)
        self.lerp_mode = lerp_mode

    def coords(self, lons, lats):
        """(n, x, y, chunk): the band-frame coordinates the resample's
        prologue computes, padded to a whole number of chunks, for tools
        that look at them; the resample itself takes lon/lat."""
        x, y = _xy(self.grid, lons, lats)
        n = x.shape[0]
        chunk = _effective_chunk(n, self.chunk)
        x, y = _pad_to_chunk(x - self.band.col0, y - self.band.row0, chunk)
        return n, x, y, chunk

    def resample(self, lons, lats):
        """Returns (values, resolved_mask); unresolved entries are NaN.  On
        a CUDA band this is one B8 launch: the lon/lat to band-frame
        prologue and the ragged last chunk are the kernel's."""
        lons, lats = queries(self.grid, lons, lats)
        b = self.band
        aligned = self.backend == "aligned" and not b.masked
        return _band_resample(
            b.plane, b.vmask, lons, lats, chunk=_effective_chunk(lons.shape[0], self.chunk), wr=self.wr,
            wc=self.wc, masked=b.masked, lerp_mode="onehot" if aligned else self.lerp_mode,
            aligned=aligned, plain=self.backend == "torch", affine=_affine(self.grid, b.col0, b.row0),
        )


def _chunk_boxes_device(x, y, *, chunk: int):
    """Per-chunk bbox reduction on the device: (nch, 4) [xmin, xmax, ymin,
    ymax] of the whole chunks."""
    nch = x.shape[0] // chunk
    xc = x[:nch * chunk].reshape(nch, chunk)
    yc = y[:nch * chunk].reshape(nch, chunk)
    return torch.stack([xc.amin(dim=1), xc.amax(dim=1), yc.amin(dim=1), yc.amax(dim=1)], dim=1)


def _trajectory_boxes(x, y, chunk: int) -> np.ndarray:
    """Integer chunk bboxes [x0, x1, y0, y1] with the +1 bilinear-support
    cell, from tensors (a device reduction and one small copy to the host)
    or host arrays (numpy).  The tail partial chunk gets its own box."""
    n = x.shape[0]
    if n == 0:
        raise ValueError("empty trajectory")
    if torch.is_tensor(x):
        nch = n // chunk
        parts = []
        if nch:
            parts.append(_chunk_boxes_device(x, y, chunk=chunk))
        if n % chunk:
            xt, yt = x[nch * chunk:], y[nch * chunk:]
            parts.append(torch.stack([xt.amin(), xt.amax(), yt.amin(), yt.amax()])[None, :])
        raw = torch.cat(parts).cpu().numpy().astype(np.float64)
    else:
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        pad = (-n) % chunk
        if pad:
            x = np.concatenate([x, np.broadcast_to(x[-1], (pad,))])
            y = np.concatenate([y, np.broadcast_to(y[-1], (pad,))])
        xc = x.reshape(-1, chunk)
        yc = y.reshape(-1, chunk)
        raw = np.stack([xc.min(1), xc.max(1), yc.min(1), yc.max(1)], axis=1)
    return np.stack([
        np.floor(raw[:, 0]), np.floor(raw[:, 1]) + 1,
        np.floor(raw[:, 2]), np.floor(raw[:, 3]) + 1,
    ], axis=1).astype(np.int64)


def plan_segments(x, y, *, chunk: int = 512, max_bands: int = 8, page_overhead_cells: int = 8192, grid_shape=None, boxes=None):
    """Greedy segmentation of an ORDERED trajectory into tile-snapped bands.

    One bbox band pays for the whole query hull: a diagonal or L-shaped
    mission with a thin corridor fills bbox_area >> corridor_area cells.
    Greedy rule: extend the current segment while the snapped-area increase
    of absorbing the next chunk is no larger than opening a fresh band for
    it (its own snapped area + ``page_overhead_cells``); then cut.  Adjacent
    segments are re-merged cheapest-first down to ``max_bands``.

    x, y are grid-frame coordinates (tensors or host arrays).  Returns a
    list of (r0, c0, nrows, ncols) snapped like :meth:`BandRouter.band_bbox`
    (rows x8, cols x128, +1-cell bilinear support), clipped to
    ``grid_shape`` when given.  A band-confined trajectory yields one
    segment."""
    if boxes is None:
        boxes = _trajectory_boxes(x, y, chunk)

    def snapped_area(b):
        nr = _ceil_to(max(int(b[3] - b[2]) + 1, 8), 8)
        nc = _ceil_to(max(int(b[1] - b[0]) + 1, 128), _LANES)
        return nr * nc

    def union(a, b):
        return (min(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]), max(a[3], b[3]))

    segs = []
    cur = tuple(boxes[0])
    for b in boxes[1:]:
        b = tuple(b)
        merged = union(cur, b)
        if snapped_area(merged) - snapped_area(cur) <= snapped_area(b) + page_overhead_cells:
            cur = merged
        else:
            segs.append(cur)
            cur = b
    segs.append(cur)

    # cap the page count: merge the adjacent pair with the smallest area cost
    while len(segs) > max_bands:
        costs = [
            snapped_area(union(segs[i], segs[i + 1])) - snapped_area(segs[i]) - snapped_area(segs[i + 1])
            for i in range(len(segs) - 1)
        ]
        i = int(np.argmin(costs))
        segs[i:i + 2] = [union(segs[i], segs[i + 1])]

    out = []
    for (x0, x1, y0, y1) in segs:
        nr = _ceil_to(max(int(y1 - y0) + 1, 8), 8)
        nc = _ceil_to(max(int(x1 - x0) + 1, 128), _LANES)
        r0, c0 = int(y0), int(x0)
        if grid_shape is not None:
            H, W = grid_shape
            nr, nc = min(nr, H), min(nc, W)
            r0 = max(0, min(r0, H - nr))
            c0 = max(0, min(c0, W - nc))
        out.append((r0, c0, nr, nc))
    return out


@dataclasses.dataclass(frozen=True)
class BandAtlas:
    """K same-shape filled band pages stacked for one-pass resampling."""

    planes: torch.Tensor   # (K, R, C) NaN-free page values
    vmasks: torch.Tensor   # (K, R, C) 1.0 where defined
    origins: torch.Tensor  # (K, 2) page (row0, col0), planes' dtype
    masked: bool           # any undefined cell in any page?
    placed: tuple = ()     # host copy of the (row0, col0) origins: refresh()
                           # refills with no copy from the device

    @property
    def shape(self):
        return tuple(self.planes.shape)

    @property
    def cells(self) -> int:
        k, r, c = self.planes.shape
        return int(k * r * c)


def _fill_pages(grid: RegularGrid, vparams, *, placed, pr: int, pc: int, method: str, margin: int, fill_backend: str, convention: str, model: str):
    """The K page fills, stacked: (planes, vmasks).  Each page is one
    ``fill_band`` (with the masked flag pinned, so no page syncs)."""
    bands = [
        fill_band(grid, rp, pr, cp, pc, method=method, margin=margin, fill_backend=fill_backend,
                  convention=convention, vparams=vparams, model=model, assume_masked=True)
        for (rp, cp) in placed
    ]
    return torch.stack([b.plane for b in bands]), torch.stack([b.vmask for b in bands])


def place_segments(segments, shape):
    """Re-place planned segments to a common snapped page shape (the max
    over segments, centred on each segment, shifted inside the grid).
    Returns (placed (row0, col0) tuples, pr, pc)."""
    H, W = shape
    pr = max(nr for (_, _, nr, _) in segments)
    pc = max(nc for (_, _, _, nc) in segments)
    pr, pc = min(pr, H), min(pc, W)
    placed = []
    for (r0, c0, nr, nc) in segments:
        rp = max(0, min(r0 - (pr - nr) // 2, H - pr))
        cp = max(0, min(c0 - (pc - nc) // 2, W - pc))
        placed.append((rp, cp))
    return tuple(placed), pr, pc


def build_atlas(grid: RegularGrid, segments, *, method: str = "kriging", margin: int = 10, fill_backend: str = "auto", convention: str = "reference", vparams=None, model: str = "exponential", assume_masked: bool | None = None) -> BandAtlas:
    """Fill one page per planned segment, all re-placed to a common snapped
    shape (:func:`place_segments`)."""
    placed, pr, pc = place_segments(segments, grid.shape)
    planes, vmasks = _fill_pages(grid, vparams, placed=placed, pr=pr, pc=pc, method=method, margin=margin,
                                 fill_backend=fill_backend, convention=convention, model=model)
    masked = bool(vmasks.min() < 0.5) if assume_masked is None else bool(assume_masked)
    return BandAtlas(
        planes=planes, vmasks=vmasks,
        origins=torch.tensor(placed, dtype=grid.dtype, device=grid.device),
        masked=masked, placed=tuple(placed),
    )


class AtlasResampler:
    """Serve scattered queries from a band atlas (same API as
    :class:`BandResampler`; one pass whatever the page count).  Each chunk
    is served by the page holding its bbox centre; a query whose cell
    leaves that page reports unresolved."""

    def __init__(self, grid: RegularGrid, atlas: BandAtlas, *, chunk: int = 512, win_rows: int = 48, win_cols: int = 128, backend: str = "auto", lerp_mode: str = LERP_MODE_DEFAULT):
        _, R, C = atlas.shape
        self.grid = grid
        self.atlas = atlas
        self.chunk = int(chunk)
        self.wr = min(int(win_rows), R)
        self.wc = min(int(win_cols), C)
        self.dtype = atlas.planes.dtype
        self.backend = resolve_resample_backend(backend, atlas.planes)
        _hat(lerp_mode)
        self.lerp_mode = lerp_mode

    def coords(self, lons, lats):
        """(n, x, y, chunk): the grid-frame coordinates the resample's
        prologue computes, padded to a whole number of chunks, for tools
        that look at them; the resample itself takes lon/lat."""
        x, y = _xy(self.grid, lons, lats)
        n = x.shape[0]
        chunk = _effective_chunk(n, self.chunk)
        x, y = _pad_to_chunk(x, y, chunk)
        return n, x, y, chunk

    def resample(self, lons, lats):
        """Returns (values, resolved_mask); unresolved entries are NaN.  On
        a CUDA atlas this is one B8 launch (the prologue and the ragged last
        chunk are the kernel's)."""
        lons, lats = queries(self.grid, lons, lats)
        a = self.atlas
        aligned = self.backend == "aligned" and not a.masked
        return _atlas_resample(
            a.planes, a.vmasks, a.origins, lons, lats, chunk=_effective_chunk(lons.shape[0], self.chunk),
            wr=self.wr, wc=self.wc, masked=a.masked, pick=a.planes.shape[0] > 1,
            lerp_mode="onehot" if aligned else self.lerp_mode, aligned=aligned,
            plain=self.backend == "torch", affine=_affine(self.grid),
        )


# Routing costs in ns per unit, measured on one NVIDIA H100 80GB HBM3 at a
# 700.00 W power limit by chip_smoke.py's phase 18 (PERF.md, section 6, the
# band router's findings); used only to route.  The fill model is dispatch
# + fill_per_cell * cells: fill_per_cell is the slope of the fills' device
# time over four band shapes (0.16M-5M cells), dispatch the host time on top
# of it (every fill up to 5M cells is host-bound on this card).  packed is
# the two-tier kriging call on 5M uniform random queries of the masked
# Kerguelen stand-in (its best case, so the router over-credits packed);
# resample is a 5M-ping BandResampler call on the band weave, lon/lat in,
# one B8 launch with the coordinate prologue inside (a later run than the
# other three: the prologue moved into the kernel after they were taken).
COST_NS = {
    "packed_per_query": 2.949,
    "dispatch": 3.367e5,
    "fill_per_cell": 0.03544,
    "resample_per_query": 0.02496,
}


def _chunk_fit_frac(x, y, origins, *, chunk: int, wr: int, wc: int, pr: int, pc: int) -> torch.Tensor:
    """Fraction of query chunks whose bbox fits a (wr, wc) resample window
    and, when ``origins`` ((K, 2) page corners of (pr, pc) pages) is given,
    lies inside at least one page.  A 0-d float32 tensor."""
    x, y = _pad_to_chunk(x, y, chunk)
    xc = x.reshape(-1, chunk)
    yc = y.reshape(-1, chunk)
    xmin, xmax = xc.amin(dim=1), xc.amax(dim=1)
    ymin, ymax = yc.amin(dim=1), yc.amax(dim=1)
    fit = (xmax - xmin < wc - 2) & (ymax - ymin < wr - 2)
    if origins is not None:
        orow = origins[:, 0].to(x.dtype)[:, None]
        ocol = origins[:, 1].to(x.dtype)[:, None]
        # bilinear support: floor(x)+1 must stay inside the page
        inside = (
            (xmin[None, :] >= ocol) & (xmax[None, :] < ocol + (pc - 1))
            & (ymin[None, :] >= orow) & (ymax[None, :] < orow + (pr - 1))
        )
        fit &= inside.any(dim=0)
    return fit.to(torch.float32).mean()


class BandRouter:
    """Crossover router: band fill + resample vs the packed two-tier path.

    ``route(lons, lats)`` picks the cheaper algorithm from the cost model
    and a coherence statistic computed on the device; ``kriging()`` executes
    the choice, escalating band-unresolved queries to exact two-tier
    kriging."""

    def __init__(self, grid: RegularGrid, *, convention: str = "reference", chunk: int = 2048, win_rows: int = 112, win_cols: int = 128, margin: int = 10, fill_backend: str = "auto", two_tier=None, cost_ns=None, max_bands: int = 1, auto_window: bool = True, lerp_mode: str = "hat_t"):
        from .dense import resolve_backend
        from .two_tier import TwoTierInterpolator

        self.grid = grid
        self.convention = convention
        self.chunk = int(chunk)
        self.win_rows = int(win_rows)
        self.win_cols = int(win_cols)
        self.margin = int(margin)
        _hat(lerp_mode)
        self.lerp_mode = lerp_mode
        # auto_window shrinks the resample window to the measured max chunk
        # span at prepare() time (win_rows/win_cols become upper bounds, the
        # coherence threshold routing still uses).  Never affects
        # correctness: chunks that exceed the window escalate.
        self.auto_window = bool(auto_window)
        # max_bands > 1 enables trajectory segmentation (plan_segments)
        self.max_bands = int(max_bands)
        self.fill_backend = resolve_backend(fill_backend, grid.elev)
        self.two_tier = two_tier or TwoTierInterpolator(grid, convention=convention)
        self.cost_ns = dict(COST_NS, **(cost_ns or {}))
        self._band = None
        self._atlas = None
        self._resampler = None
        self._plan_cache = None
        self.last_coherence = None   # set by route()
        self.last_unresolved = None  # set by the band serve path
        self._band_method = None     # fill method the band/atlas holds

    # -- band management ---------------------------------------------------
    def _plan(self, lons, lats, mb: int):
        """Chunk boxes + (mb > 1) segment plan, cached on the query arrays so
        route() and the prepare() that usually follows share ONE device
        reduction and host plan.  The cache holds weakrefs: a hit needs the
        SAME live objects (ids alone can be recycled after gc).  Inputs that
        take no weakref (lists) skip the cache.  prepare() consumes it."""
        key = (int(np.shape(lons)[0]), int(mb))
        if self._plan_cache is not None:
            ckey, rlons, rlats, boxes, segs = self._plan_cache
            if ckey == key and rlons() is lons and rlats() is lats:
                return boxes, segs
        x, y = _xy(self.grid, lons, lats)
        boxes = _trajectory_boxes(x, y, self.chunk)
        segs = (
            plan_segments(x, y, chunk=self.chunk, max_bands=mb, grid_shape=self.grid.shape, boxes=boxes)
            if mb > 1 else None
        )
        try:
            self._plan_cache = (key, weakref.ref(lons), weakref.ref(lats), boxes, segs)
        except TypeError:
            self._plan_cache = None
        return boxes, segs

    def band_bbox(self, lons, lats, *, boxes=None):
        """Snap the query bbox (+1 cell bilinear support) to a band shape:
        rows to multiples of 8, cols to multiples of 128, clipped to the
        grid.  ``boxes`` (per-chunk int bboxes from _trajectory_boxes) skips
        the device reduction when already known."""
        H, W = self.grid.shape
        if boxes is not None:
            x0, x1 = int(boxes[:, 0].min()), int(boxes[:, 1].max())
            y0, y1 = int(boxes[:, 2].min()), int(boxes[:, 3].max())
        else:
            x, y = _xy(self.grid, lons, lats)
            # one copy to the host for all 4 scalars
            ext = torch.stack([x.amin(), x.amax(), y.amin(), y.amax()]).floor().cpu().numpy()
            x0, x1 = int(ext[0]), int(ext[1]) + 1
            y0, y1 = int(ext[2]), int(ext[3]) + 1
        r0 = max(0, min(y0, H - 2))
        c0 = max(0, min(x0, W - 2))
        nrows = min(_ceil_to(max(y1 - r0 + 1, 8), 8), H)
        ncols = min(_ceil_to(max(x1 - c0 + 1, 128), 128), W)
        # keep the snapped size by shifting the origin at the grid edge
        r0 = min(r0, H - nrows)
        c0 = min(c0, W - ncols)
        return r0, nrows, c0, ncols

    def prepare(self, lons, lats, *, max_bands: int | None = None, **fill_kw):
        """Fill the band (or, with max_bands > 1 and a spread-out
        trajectory, the segmented atlas) covering these queries.  With
        auto_window, also size the resample window from the measured chunk
        spans (one small copy to the host on this cold path)."""
        mb = self.max_bands if max_bands is None else int(max_bands)
        self._band_method = fill_kw.get("method", "kriging")
        segs = None
        boxes = None
        wr, wc = self.win_rows, self.win_cols
        if mb > 1 or self.auto_window:
            boxes, segs = self._plan(lons, lats, mb)
            self._plan_cache = None  # consumed; see _plan
        if self.auto_window:
            # the window must hold the chunk's [floor(min), floor(max)+1]
            # support: boxes carry the +1 cell, so (b[3]-b[2])+1 rows, +1
            # slack for refresh-time drift; 'hat_t' sizes wc to the quantum
            # of 8 where the other builds keep 128 (the JAX package's rule,
            # kept so both packages serve with the same windows)
            wr = min(wr, max(8, _ceil_to(int((boxes[:, 3] - boxes[:, 2]).max()) + 2, 8)))
            wcq = 8 if self.lerp_mode == "hat_t" else _LANES
            wc = min(wc, max(wcq, _ceil_to(int((boxes[:, 1] - boxes[:, 0]).max()) + 2, wcq)))
        if segs is not None and len(segs) > 1:
            self._atlas = build_atlas(self.grid, segs, margin=self.margin, fill_backend=self.fill_backend,
                                      convention=self.convention, **fill_kw)
            self._band = None
            self._resampler = AtlasResampler(self.grid, self._atlas, chunk=self.chunk, win_rows=wr,
                                             win_cols=wc, lerp_mode=self.lerp_mode)
            return self._atlas
        r0, nr, c0, nc = self.band_bbox(lons, lats, boxes=boxes)
        self._band = self._fill_one(r0, nr, c0, nc, None, **fill_kw)
        self._atlas = None
        self._resampler = BandResampler(self.grid, self._band, chunk=self.chunk, win_rows=wr, win_cols=wc,
                                        lerp_mode=self.lerp_mode)
        return self._band

    def _fill_one(self, row0, nrows, col0, ncols, masked, **fill_kw):
        """Single-band fill (a one-page ``_fill_pages``).  masked=None syncs
        once to pick the resample fast path (callers may pin it through
        assume_masked, as for fill_band)."""
        vparams = fill_kw.pop("vparams", None)
        method = fill_kw.pop("method", "kriging")
        model = fill_kw.pop("model", "exponential")
        if masked is None:
            masked = fill_kw.pop("assume_masked", None)
        else:
            fill_kw.pop("assume_masked", None)
        if fill_kw:
            raise TypeError(f"unsupported fill kwargs: {sorted(fill_kw)}")
        planes, vmasks = _fill_pages(
            self.grid, vparams, placed=((int(row0), int(col0)),), pr=int(nrows), pc=int(ncols),
            method=method, margin=self.margin, fill_backend=self.fill_backend,
            convention=self.convention, model=model,
        )
        if masked is None:
            masked = bool(vmasks.min() < 0.5)  # 1 sync (prepare only)
        return Band(plane=planes[0], vmask=vmasks[0], masked=bool(masked), row0=int(row0), col0=int(col0))

    def refresh(self, grid: RegularGrid | None = None, **fill_kw):
        """Refill the CURRENT band/atlas geometry (serving mode: new
        observations arrived, queries stay band-confined), with no planning.
        The masked flag stays pinned from the synced build, EXCEPT when a
        new ``grid`` is given and the flag is False: a replacement grid may
        have lost observations, and the masked=False resample (which skips
        the vmask) would serve zero-filled cells as depths.  That case pays
        one sync to recompute the flag; ``assume_masked=False`` asserts the
        new grid covers the old one (accumulate-only streaming) and keeps
        the sync-free path."""
        if self._band is None and self._atlas is None:
            raise RuntimeError("refresh() before prepare()")
        if grid is not None:
            # escalation must answer from the grid the band is filled from
            self.grid = grid
            # type() keeps a caller's TwoTier subclass; engines with richer
            # state must be refreshed by the caller and set on .two_tier
            self.two_tier = type(self.two_tier)(
                grid, convention=self.convention, escalate_cap=self.two_tier.escalate_cap,
                backend=self.two_tier.backend,
            )
            if self._resampler is not None:
                self._resampler.grid = grid
        if self._atlas is not None:
            _, pr, pc = self._atlas.shape
            placed = self._atlas.placed or tuple(
                (int(r), int(c)) for r, c in self._atlas.origins.cpu().numpy().astype(np.int64)
            )
            vparams = fill_kw.pop("vparams", None)
            method = fill_kw.pop("method", "kriging")
            model = fill_kw.pop("model", "exponential")
            am = fill_kw.pop("assume_masked", None)
            if fill_kw:
                raise TypeError(f"unsupported refresh kwargs: {sorted(fill_kw)}")
            planes, vmasks = _fill_pages(
                self.grid, vparams, placed=placed, pr=pr, pc=pc, method=method, margin=self.margin,
                fill_backend=self.fill_backend, convention=self.convention, model=model,
            )
            if am is not None:
                masked = bool(am)
            elif grid is not None and not self._atlas.masked:
                masked = bool(vmasks.min() < 0.5)  # 1 sync; see the docstring
            else:
                masked = self._atlas.masked
            self._atlas = dataclasses.replace(self._atlas, planes=planes, vmasks=vmasks, placed=placed, masked=masked)
            self._resampler.atlas = self._atlas
            return self._atlas
        b = self._band
        pinned = None if (grid is not None and not b.masked) else b.masked
        self._band = self._fill_one(b.row0, b.shape[0], b.col0, b.shape[1], pinned, **fill_kw)
        self._resampler.band = self._band
        return self._band

    # -- routing -----------------------------------------------------------
    def _footprint(self):
        """(origins (K, 2) int32 tensor, page rows, page cols) of the live
        band/atlas, or None.  A band is a one-page atlas here."""
        if self._band is not None:
            b = self._band
            return (torch.tensor([[b.row0, b.col0]], dtype=torch.int32, device=self.grid.device),
                    int(b.shape[0]), int(b.shape[1]))
        if self._atlas is not None:
            _, pr, pc = self._atlas.shape
            return self._atlas.origins.to(torch.int32), int(pr), int(pc)
        return None

    def coherence(self, lons, lats, *, within_footprint: bool = False) -> float:
        """Fraction of chunks whose bounding box fits the resample window
        (one scalar copied to the host).  Uses the live resampler's window
        when there is one (auto_window may have shrunk it).
        within_footprint=True also requires each chunk box to lie inside a
        live band/atlas page (serving mode: a coherent batch OUTSIDE the
        prepared band would resample, then escalate nearly all of it)."""
        if self._resampler is not None:
            wr, wc = self._resampler.wr, self._resampler.wc
        else:
            wr, wc = self.win_rows, self.win_cols
        x, y = _xy(self.grid, lons, lats)
        fp = self._footprint() if within_footprint else None
        if fp is not None:
            frac = _chunk_fit_frac(x, y, fp[0], chunk=self.chunk, wr=wr, wc=wc, pr=fp[1], pc=fp[2])
        else:
            frac = _chunk_fit_frac(x, y, None, chunk=self.chunk, wr=wr, wc=wc, pr=0, pc=0)
        return float(frac)

    def route(self, lons, lats, *, band_ready: bool = False) -> str:
        """'band' or 'packed' from the cost model.  band_ready=True amortizes
        the fill (serving mode: many batches per band) and gates coherence
        on the live band/atlas footprint."""
        n = int(np.shape(lons)[0])
        live = self._band is not None or self._atlas is not None
        frac = self.coherence(lons, lats, within_footprint=band_ready and live)
        self.last_coherence = frac
        c = self.cost_ns
        packed = c["packed_per_query"] * n
        if band_ready and live:
            fill = 0.0
        else:
            boxes, segs = self._plan(lons, lats, self.max_bands)
            if segs is not None and len(segs) > 1:
                # pages share the max segment shape (build_atlas)
                pr = max(nr for (_, _, nr, _) in segs)
                pc = max(nc for (_, _, _, nc) in segs)
                cells = len(segs) * pr * pc
            else:
                _, nr, _, nc = self.band_bbox(lons, lats, boxes=boxes)
                cells = nr * nc
            fill = c["dispatch"] + c["fill_per_cell"] * cells
        band = fill + c["resample_per_query"] * n + c["packed_per_query"] * n * (1.0 - frac)
        return "band" if band < packed else "packed"

    # -- execution ---------------------------------------------------------
    def kriging(self, lons, lats, *, force: str | None = None):
        """Serve a batch: band resample with exact-kriging escalation, or the
        packed two-tier path, whichever routes cheaper (or ``force``d)."""
        return self._serve("kriging", lons, lats, force=force)

    def idw(self, lons, lats, *, force: str | None = None):
        """IDW twin of :meth:`kriging`: the band/atlas must hold an IDW fill
        (``prepare(..., method="idw")``); escalation uses two-tier IDW."""
        return self._serve("idw", lons, lats, force=force)

    def _serve(self, method: str, lons, lats, *, force: str | None = None):
        choice = force or self.route(lons, lats, band_ready=self._resampler is not None)
        escalate = getattr(self.two_tier, method)
        if choice == "packed":
            return escalate(lons, lats)
        if self._resampler is None:
            self.prepare(lons, lats, method=method)
        elif self._band_method != method:
            raise ValueError(
                f"band/atlas holds a {self._band_method!r} fill; re-prepare "
                f"with method={method!r} before serving {method}")
        z, ok = self._resampler.resample(lons, lats)
        bad = ~ok
        n_bad = int(bad.sum())
        self.last_unresolved = n_bad
        if n_bad == 0:
            return z
        # the unresolved queries, through the exact two-tier path (which
        # chunks its own escalation), written back in place
        idx = torch.nonzero(bad).reshape(-1)
        qlon, qlat = queries(self.grid, lons, lats)
        z[idx] = escalate(qlon[idx], qlat[idx])
        return z
