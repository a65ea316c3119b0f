"""Sharded streaming mosaics: streaming and spatial sharding composed
(counterpart of :mod:`auvtpu.parallel.streaming`).

The survey mosaic is too big for one device while observations stream in.
The classes keep :class:`auvtpu_torch.streaming.StreamingInterpolator`'s
API and results, bit for bit, with each rank holding one row band (or one
2-D block) of the planes:

- **ingest**: every rank stages the same observations (the host ring is
  unchanged); at a flush each rank scatters only the observations whose
  cells it owns, with the one-device class's stable-sort last-write-wins.
  A cell is owned by exactly one rank, so the winners are the one-device
  ones.  An observation outside every block is dropped, a negative row
  included, as ``auvtpu.parallel.streaming`` drops a lane outside its band
  (the one-device class counts a negative flat index from the end);
- **window_fill / window_uncertainty**: the (win_h, win_w) crop is sent by
  the ranks that own its rows (broadcasts of their strips: no arithmetic,
  so a -0.0 stays -0.0), then every rank runs the one-device fill program
  (:func:`auvtpu_torch.streaming._fill_window_planes`) on it unchanged;
- **fit_variogram**: the float64 pair sums of every block, with its
  neighbours' halos, summed over the mesh and rounded once (the one-device
  sums), then the fit on every rank, as :func:`.spatial.sharded_fit_fill`
  fits.

Rows (and columns) pad to a multiple of the mesh's; pad cells are invalid
and invisible: ``shape``, ``snapshot`` and ``save`` report the logical
mosaic, and a checkpoint is interchangeable with the one-device class's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Extent
from ..grid import RegularGrid
from ..ops.scattered import as_index
from ..streaming import StreamingInterpolator, _fill_window_planes, _scatter_last_wins
from ..variogram import pair_sums_2d
from .mesh import Mesh, _check_member, barrier, broadcast
from .spatial import _block, _collect_halo, _fit_1d, _fit_from_sums, _gather_blocks


class _BlockMosaic(StreamingInterpolator):
    """A mosaic whose planes are split into (blk_r, blk_c) blocks over a
    (ny, nx) layout of the mesh's ranks (nx = 1 for row bands)."""

    _layout: tuple[int, int]  # (ny, nx)
    _origin: tuple[int, int]  # this rank's block's (row, col) in the mosaic

    def __init__(self, shape, extent, mesh: Mesh, **kw):
        _check_member(mesh, type(self).__name__)
        H, W = (int(v) for v in shape)
        self.mesh = mesh
        self._n_rows, self._n_cols = H, W
        ny, nx = self._layout
        self._blk = (-(-H // ny), -(-W // nx))
        kw["device"] = mesh.device
        super().__init__((H, W), extent, **kw)
        if self.window[0] > H or self.window[1] > W:
            raise ValueError(f"window {self.window} larger than mosaic {(H, W)}")

    def _allocate(self, H: int, W: int, dtype, device) -> None:
        super()._allocate(*self._blk, dtype, device)

    @property
    def shape(self):
        return (self._n_rows, self._n_cols)

    def _local_flat(self, obs: torch.Tensor) -> torch.Tensor:
        """Each observation's flat index in this rank's block, the scrap
        index for those it does not own."""
        raise NotImplementedError

    def flush(self) -> int:
        m = self._staged
        if m == 0:
            return 0
        # torch.tensor copies: see StreamingInterpolator.flush
        obs = torch.tensor(self._stage[:m], device=self.device)
        _scatter_last_wins(self._ebuf, self._vbuf, self._local_flat(obs), obs[:, 2])
        self._staged = 0
        return m

    def _crop(self, r0: int, c0: int):
        """The (win_h, win_w) window at (r0, c0) on every rank: each block
        that holds part of it broadcasts that part, elevation and validity
        as one strip."""
        wh, ww = self.window
        (br, bc), (ny, nx) = self._blk, self._layout
        out = torch.empty((2, wh, ww), dtype=self.elev.dtype, device=self.device)
        for iy in range(r0 // br, (r0 + wh - 1) // br + 1):
            for ix in range(c0 // bc, (c0 + ww - 1) // bc + 1):
                ra, rb = max(r0, iy * br), min(r0 + wh, (iy + 1) * br)
                ca, cb = max(c0, ix * bc), min(c0 + ww, (ix + 1) * bc)
                owner = iy * nx + ix
                if owner == self.mesh.index:
                    oy, ox = self._origin
                    part = torch.stack([self.elev[ra - oy:rb - oy, ca - ox:cb - ox],
                                        self.valid[ra - oy:rb - oy, ca - ox:cb - ox]])
                else:
                    part = out[:, ra - r0:rb - r0, ca - c0:cb - c0]
                out[:, ra - r0:rb - r0, ca - c0:cb - c0] = broadcast(self.mesh, part.contiguous(), owner)
        return out[0], out[1]

    def _window(self, center_row: int, center_col: int, *, method: str, variance: bool):
        self.flush()
        wh, ww = self.window
        H, W = self.shape
        r0 = int(np.clip(center_row - wh // 2, 0, H - wh))
        c0 = int(np.clip(center_col - ww // 2, 0, W - ww))
        we, wv = self._crop(r0, c0)
        return _fill_window_planes(
            we, wv, self._meta, r0, c0, self._vparams,
            method=method, k=self.k, max_radius=self.max_radius, steps=self._steps, variance=variance,
            backend=self.backend,
        ), (r0, c0)

    def _planes(self):
        """The logical (elev, valid) planes, gathered on every rank."""
        H, W = self.shape
        return _gather_blocks(self.mesh, self.elev, H, W), _gather_blocks(self.mesh, self.valid, H, W)

    def grid(self) -> RegularGrid:
        """A RegularGrid of the whole logical mosaic, gathered onto this
        rank's device (a copy: the planes stay sharded)."""
        self.flush()
        e, v = self._planes()
        return RegularGrid(elev=e, valid=v, min_lon=self._meta[0], max_lon=self._meta[1], min_lat=self._meta[2],
                           max_lat=self._meta[3])

    def snapshot(self) -> np.ndarray:
        self.flush()
        e, v = self._planes()
        return np.where(v.cpu().numpy() > 0.5, e.cpu().numpy().astype(np.float64), np.nan)

    def save(self, path: str) -> None:
        """Checkpoint the logical mosaic (the mesh's first rank writes it;
        every rank returns once it is written), in the one-device class's
        format."""
        self.flush()
        e, v = self._planes()
        if self.mesh.index == 0:
            vp = (np.asarray([float(x) for x in self._vparams], np.float64) if self._vparams is not None
                  else np.zeros((0,), np.float64))
            np.savez_compressed(
                path, elev=e.cpu().numpy(), valid=v.cpu().numpy(), extent=np.asarray(self._meta, np.float64),
                window=np.asarray(self.window, np.int64), method=np.asarray(self.method), k=np.asarray(self.k),
                max_radius=np.asarray(self.max_radius), vparams=vp,
            )
        barrier(self.mesh)

    @classmethod
    def load(cls, path: str, mesh: Mesh, *, swath_cap: int = 4096, stage_slots: int = 16):
        """Resume a checkpoint (written by any streaming class of either
        package) onto ``mesh``: each rank keeps its own block."""
        d = np.load(path)
        elev = torch.from_numpy(np.ascontiguousarray(d["elev"]))
        min_lon, max_lon, min_lat, max_lat = (float(x) for x in d["extent"])
        si = cls(
            elev.shape, Extent(min_lon, max_lon, min_lat, max_lat), mesh, swath_cap=swath_cap,
            stage_slots=stage_slots, window=tuple(int(x) for x in d["window"]), method=str(d["method"]),
            k=int(d["k"]), max_radius=int(d["max_radius"]), dtype=elev.dtype,
        )
        (oy, ox), (br, bc) = si._origin, si._blk
        si.elev.copy_(_block(elev, oy, br, ox, bc, si.device))
        si.valid.copy_(_block(torch.from_numpy(np.ascontiguousarray(d["valid"])), oy, br, ox, bc, si.device))
        vp = d["vparams"] if "vparams" in d.files else np.zeros((0,))
        if len(vp) == 3:
            si._vparams = tuple(torch.tensor(float(x), dtype=si.elev.dtype, device=si.device) for x in vp)
        return si


class ShardedStreamingInterpolator(_BlockMosaic):
    """StreamingInterpolator whose planes are row bands over a 1-D mesh:
    the scale-out path for survey mosaics larger than one device."""

    def __init__(self, shape, extent, mesh: Mesh, **kw):
        if len(mesh.shape) != 1:
            raise ValueError(f"ShardedStreamingInterpolator needs a 1-D mesh, got axes {mesh.axis_names}")
        self._layout = (mesh.size, 1)
        super().__init__(shape, extent, mesh, **kw)
        self._origin = (mesh.index * self._blk[0], 0)

    def _local_flat(self, obs):
        # rows outside the band are dropped; the column is not checked, as
        # in the JAX package (a negative flat index counts from the band's
        # end, as its scatter normalises it)
        br, W = self._blk
        n = br * W
        rows = as_index(obs[:, 0], torch.long) - self._origin[0]
        flat = rows * W + as_index(obs[:, 1], torch.long)
        flat = torch.where(flat < 0, flat + n, flat)
        return torch.where((rows >= 0) & (rows < br), flat, n)

    def fit_variogram(self, *, max_lag: int = 10, n_bins: int = 10):
        self.flush()
        self._vparams = _fit_1d(self.mesh, self.mesh.axis_names[0], self.elev, self.valid, self._blk[0],
                                self._steps, max_lag, n_bins)
        return self._vparams


class ShardedStreamingInterpolator2D(_BlockMosaic):
    """StreamingInterpolator whose planes are 2-D blocks over a (rows, cols)
    mesh: the scale-out when the mosaic is too wide for row bands alone."""

    def __init__(self, shape, extent, mesh: Mesh, **kw):
        if len(mesh.shape) != 2:
            raise ValueError(f"ShardedStreamingInterpolator2D needs a 2-D mesh, got axes {mesh.axis_names}")
        self._layout = tuple(mesh.shape)
        super().__init__(shape, extent, mesh, **kw)
        iy, ix = mesh.coords
        self._origin = (iy * self._blk[0], ix * self._blk[1])

    def _local_flat(self, obs):
        br, bc = self._blk
        rows = as_index(obs[:, 0], torch.long) - self._origin[0]
        cols = as_index(obs[:, 1], torch.long) - self._origin[1]
        own = (rows >= 0) & (rows < br) & (cols >= 0) & (cols < bc)
        return torch.where(own, rows * bc + cols, br * bc)

    def fit_variogram(self, *, max_lag: int = 10, n_bins: int = 10):
        """Column halos on both sides (the half-plane offsets reach dx in
        [-L, L]), then the 'after' row halo of the column-extended block
        (carrying the corners), then :func:`pair_sums_2d`."""
        self.flush()
        ay, ax = self.mesh.axis_names
        L = max_lag
        x = torch.stack([self.elev, self.valid])
        h = _collect_halo(x, L, self.mesh, ax, 2)
        x = torch.cat([h["before"], x, h["after"]], dim=2)
        x = torch.cat([x, _collect_halo(x, L, self.mesh, ay, 1, sides=("after",))["after"]], dim=1)
        s, c = pair_sums_2d(x[0], x[1], *self._blk, max_lag=max_lag, n_bins=n_bins)
        self._vparams = _fit_from_sums(self.mesh, s, c, self.elev.dtype, self._steps, max_lag, n_bins)
        return self._vparams
