"""Streaming real-time AUV swath interpolation (counterpart of
:mod:`auvtpu.streaming`).

Sonar observations arrive as swaths while the vehicle moves, and the map
around the vehicle must stay interpolated:

- the mosaic lives on the device as (elev, valid) planes, updated in place;
- ``ingest`` stages (row, col, depth) observations in a host buffer;
  ``flush`` copies the staged rows to the device in one transfer and
  scatters them in one deterministic (last-write-wins) pass;
- ``window_fill`` crops a fixed-size window around the vehicle and runs the
  dense fills on it: the B3 kernel for idw/mean and the B1 kernel for
  kriging and its variance on a CUDA float32 mosaic.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Extent
from .grid import RegularGrid
from .ops import fill_idw, fill_kriging, fill_window_mean, resolve_backend
from .ops.scattered import as_index
from .variogram import fit_variogram


def _ingest_batch(ebuf: torch.Tensor, vbuf: torch.Tensor, obs: torch.Tensor, width: int) -> None:
    """Scatter one staged batch of observations into the flat mosaic
    buffers, in place, deterministically.

    ``ebuf``/``vbuf`` are the (H*W + 1,) elevation and validity buffers whose
    last element is a scrap slot; ``obs`` is the (m, 3) [row, col, value]
    batch on their device.  A negative flat index counts from the end of
    the mosaic once, as the JAX package's ``.at[f]`` scatter normalises it,
    and a NaN row or column is 0, as XLA casts it;
    see :func:`_scatter_last_wins` for the rest.  No value is read back to
    the host.
    """
    n = ebuf.shape[0] - 1
    flat = as_index(obs[:, 0], torch.long) * width + as_index(obs[:, 1], torch.long)
    _scatter_last_wins(ebuf, vbuf, torch.where(flat < 0, flat + n, flat), obs[:, 2])


def _scatter_last_wins(ebuf: torch.Tensor, vbuf: torch.Tensor, flat: torch.Tensor, vals: torch.Tensor) -> None:
    """Write ``vals`` at the flat indices ``flat`` of the buffers, in place.
    Duplicate cells resolve to the LAST value in arrival order, whatever the
    device's scatter order: a stable sort by cell keeps arrival order within
    each cell, only each group's last lane writes its cell, and every other
    lane writes the scrap slot, as does an index outside [0, H*W)."""
    n = ebuf.shape[0] - 1
    sf, order = torch.sort(flat, stable=True)
    sv = vals[order].to(ebuf.dtype)
    nxt = torch.cat([sf[1:], sf.new_full((1,), -1)])
    winner = (sf != nxt) & (sf >= 0) & (sf < n)  # last lane of each cell group
    f = torch.where(winner, sf, n)
    ebuf.index_put_((f,), sv)
    # valid only rises: every winner's cell becomes observed
    vbuf.index_put_((f,), torch.ones_like(sv))


def _fill_window_planes(we, wv, meta, r0, c0, vparams, *, method, k, max_radius, steps, variance=False, backend="torch"):
    """Fill math over an already-cropped (win_h, win_w) window.

    ``backend`` 'fused' runs the CUDA kernels (B3 for idw/mean, B1 for
    kriging and the variance); 'torch' their plain versions.  The window is a
    sub-plane of the mosaic, so kriging gets the mosaic's cell ``steps`` and
    the window's origin (r0, c0) and its variogram geometry stays in mosaic
    coordinates.  Observed cells keep their values (variance: read 0); B3
    keeps them in its own pass, so an idw or mean refresh of a CUDA mosaic
    is one launch on the window's views.
    """
    min_lon, max_lon, min_lat, max_lat = meta
    g = RegularGrid(elev=we, valid=wv, min_lon=min_lon, max_lon=max_lon, min_lat=min_lat, max_lat=max_lat)
    if variance:
        if method != "kriging":
            raise ValueError("variance surfaces are kriging-only")
        _, var = fill_kriging(
            g, max_radius=max_radius, vparams=vparams, row0=r0, col0=c0, steps=steps,
            with_variance=True, backend=backend,
        )
        return torch.where(wv > 0.5, 0.0, var)
    if method == "idw":
        return fill_idw(g, k=k, max_radius=max_radius, backend=backend, keep_observed=True)
    if method == "mean":
        return fill_window_mean(g, k=k, max_radius=max_radius, backend=backend, keep_observed=True)
    if method != "kriging":
        raise ValueError(method)
    plane = fill_kriging(
        g, max_radius=max_radius, vparams=vparams, row0=r0, col0=c0, steps=steps, backend=backend,
    )
    return torch.where(wv > 0.5, we, plane)


def _window_fill(elev, valid, meta, r0, c0, vparams, *, win, method, k, max_radius, steps, variance=False, backend="torch"):
    """Window fill (or, with variance=True, the kriging prediction-variance
    surface with observed cells at 0) of the (win_h, win_w) window at
    (r0, c0)."""
    wh, ww = win
    we = elev[r0:r0 + wh, c0:c0 + ww]
    wv = valid[r0:r0 + wh, c0:c0 + ww]
    return _fill_window_planes(
        we, wv, meta, r0, c0, vparams,
        method=method, k=k, max_radius=max_radius, steps=steps, variance=variance, backend=backend,
    )


class StreamingInterpolator:
    """Incremental mosaic with staged ingest and window queries.

    Observations accumulate in a host staging buffer (``swath_cap *
    stage_slots`` rows) and flush to the device as one copy and one
    in-place scatter, either when the stage fills or lazily before the next
    read (window_fill, snapshot, ...).  A swath ping therefore costs a host
    memcpy, not a device round trip.

    >>> si = StreamingInterpolator((4096, 4096), extent, swath_cap=4096)
    >>> si.ingest(rows, cols, depths)          # per ping/swath (host-side)
    >>> tile, (r0, c0) = si.window_fill(r_auv, c_auv)
    """

    def __init__(
        self,
        shape: tuple[int, int],
        extent,
        *,
        swath_cap: int = 4096,
        stage_slots: int = 16,
        window: tuple[int, int] = (256, 256),
        method: str = "idw",
        k: int = 8,
        max_radius: int = 10,
        dtype=torch.float32,
        backend: str = "auto",
        device="cuda",
    ):
        H, W = (int(v) for v in shape)
        self._allocate(H, W, dtype, device)
        self.extent = extent
        self.swath_cap = int(swath_cap)
        self.stage_cap = int(swath_cap) * int(stage_slots)
        # row/col staged as f32 (exact for grid dims < 2**24)
        self._stage = np.empty((self.stage_cap, 3), np.float32)
        self._staged = 0
        self.window = tuple(window)
        self.method = method
        self.k = k
        self.max_radius = max_radius
        # the kernels on a CUDA float32 mosaic, the plain versions otherwise
        self.backend = resolve_backend(backend, self.elev)
        self._vparams = None  # fitted (nugget, sill, range); None = defaults
        self._meta = (
            float(extent.min_lon), float(extent.max_lon),
            float(extent.min_lat), float(extent.max_lat),
        )
        self._steps = (
            (self._meta[3] - self._meta[2]) / max(H - 1, 1),
            (self._meta[1] - self._meta[0]) / max(W - 1, 1),
        )

    def _allocate(self, H: int, W: int, dtype, device) -> None:
        """The mosaic planes: flat (H*W + 1,) buffers whose first H*W
        elements are the planes and whose last one is the scatter's scrap
        slot (a sharded mosaic allocates only its own block)."""
        n = H * W
        self._ebuf = torch.zeros(n + 1, dtype=dtype, device=device)
        self._vbuf = torch.zeros(n + 1, dtype=dtype, device=device)
        self.elev = self._ebuf[:n].view(H, W)
        self.valid = self._vbuf[:n].view(H, W)

    @property
    def shape(self):
        return tuple(self.elev.shape)

    @property
    def device(self) -> torch.device:
        return self.elev.device

    def ingest(self, rows, cols, vals) -> int:
        """Stage observations (host memcpy); returns how many were staged.
        Flushes to the device whenever the stage buffer fills."""
        rows = np.asarray(rows, np.float32)
        cols = np.asarray(cols, np.float32)
        vals = np.asarray(vals, np.float32)
        n = rows.shape[0]
        s = 0
        while s < n:
            m = min(n - s, self.stage_cap - self._staged)
            st = self._stage[self._staged : self._staged + m]
            st[:, 0] = rows[s : s + m]
            st[:, 1] = cols[s : s + m]
            st[:, 2] = vals[s : s + m]
            self._staged += m
            s += m
            if self._staged == self.stage_cap:
                self.flush()
        return n

    def flush(self) -> int:
        """Push staged observations to the device: one copy of the live rows
        + one in-place scatter.  Returns how many observations were flushed."""
        m = self._staged
        if m == 0:
            return 0
        # torch.tensor copies: the copy is complete when it returns, so the
        # next ingest() may overwrite the stage while the scatter is queued
        obs = torch.tensor(self._stage[:m], device=self.device)
        _ingest_batch(self._ebuf, self._vbuf, obs, self.shape[1])
        self._staged = 0
        return m

    def grid(self) -> RegularGrid:
        """RegularGrid view of the mosaic on its device (flushes staged
        observations first).  No copies; the planes are shared."""
        self.flush()
        return RegularGrid(
            elev=self.elev, valid=self.valid,
            min_lon=self._meta[0], max_lon=self._meta[1],
            min_lat=self._meta[2], max_lat=self._meta[3],
        )

    def fit_variogram(self, *, max_lag: int = 10, n_bins: int = 10):
        """Fit the exponential variogram from the accumulated observations
        and use it for subsequent kriging window fills and uncertainty
        surfaces.  Returns (nugget, sill, range) as 0-d tensors on the
        mosaic's device."""
        self._vparams = fit_variogram(self.grid(), max_lag=max_lag, n_bins=n_bins)
        return self._vparams

    def _window(self, center_row: int, center_col: int, *, method: str, variance: bool):
        self.flush()
        wh, ww = self.window
        H, W = self.shape
        r0 = int(np.clip(center_row - wh // 2, 0, H - wh))
        c0 = int(np.clip(center_col - ww // 2, 0, W - ww))
        return _window_fill(
            self.elev, self.valid, self._meta, r0, c0, self._vparams,
            win=self.window, method=method, k=self.k, max_radius=self.max_radius,
            steps=self._steps, variance=variance, backend=self.backend,
        ), (r0, c0)

    def window_fill(self, center_row: int, center_col: int):
        """Interpolated (win_h, win_w) map around the vehicle and its origin
        (r0, c0); observed cells keep their measured values, gaps are filled
        by the chosen method."""
        return self._window(center_row, center_col, method=self.method, variance=False)

    def window_uncertainty(self, center_row: int, center_col: int):
        """Ordinary-kriging prediction-variance map around the vehicle and its
        origin.  Observed cells read 0; cells with no resolvable
        neighbourhood read NaN.  Uses the fitted variogram when
        fit_variogram() has run."""
        return self._window(center_row, center_col, method="kriging", variance=True)

    def snapshot(self) -> np.ndarray:
        """Host copy of the mosaic with NaN gaps (reference representation)."""
        self.flush()
        elev = self.elev.cpu().numpy().astype(np.float64)
        valid = self.valid.cpu().numpy() > 0.5
        return np.where(valid, elev, np.nan)

    def save(self, path: str) -> None:
        """Checkpoint the mosaic: flushes staged observations, then writes the
        JAX package's npz keys (elev, valid, extent, window, method, k,
        max_radius, vparams), so either package can load it."""
        self.flush()
        vp = (
            np.asarray([float(v) for v in self._vparams], np.float64)
            if self._vparams is not None
            else np.zeros((0,), np.float64)
        )
        np.savez_compressed(
            path,
            elev=self.elev.cpu().numpy(),
            valid=self.valid.cpu().numpy(),
            extent=np.asarray(self._meta, np.float64),
            window=np.asarray(self.window, np.int64),
            method=np.asarray(self.method),
            k=np.asarray(self.k),
            max_radius=np.asarray(self.max_radius),
            vparams=vp,
        )

    @classmethod
    def load(cls, path: str, *, swath_cap: int = 4096, stage_slots: int = 16, device="cuda"):
        """Resume a checkpointed survey (written by this class or by
        ``auvtpu.streaming.StreamingInterpolator.save``) on ``device``:
        restores the mosaic planes and fill configuration; staging starts
        empty."""
        d = np.load(path)
        elev = torch.from_numpy(np.ascontiguousarray(d["elev"]))
        min_lon, max_lon, min_lat, max_lat = (float(v) for v in d["extent"])
        si = cls(
            elev.shape,
            Extent(min_lon, max_lon, min_lat, max_lat),
            swath_cap=swath_cap,
            stage_slots=stage_slots,
            window=tuple(int(v) for v in d["window"]),
            method=str(d["method"]),
            k=int(d["k"]),
            max_radius=int(d["max_radius"]),
            dtype=elev.dtype,
            device=device,
        )
        si.elev.copy_(elev)
        si.valid.copy_(torch.from_numpy(np.ascontiguousarray(d["valid"])))
        vp = d["vparams"] if "vparams" in d.files else np.zeros((0,))
        if len(vp) == 3:
            si._vparams = tuple(torch.tensor(float(v), dtype=si.elev.dtype, device=si.device) for v in vp)
        return si
