"""Core data model: a regular lat/lon grid held as two tensors on one device.

Counterpart of :mod:`auvtpu.grid`.  Missing cells are carried as a separate
validity plane (f32 0/1) over a NaN-free, zero-filled elevation plane; NaN
appears only at the I/O boundary (:meth:`RegularGrid.to_nan_array`).

Geometry (GridH.cpp:156-157): ``lon_step = (max_lon - min_lon) / (W - 1)``,
row 0 is ``min_lat``, column 0 is ``min_lon``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import Extent


@dataclasses.dataclass(frozen=True)
class RegularGrid:
    """A regular geographic grid.

    elev:  (H, W) elevations, masked cells zero-filled (never NaN).
    valid: (H, W) validity mask, same dtype and device as elev (1.0 = observed).
    Bounds are python floats.
    """

    elev: torch.Tensor
    valid: torch.Tensor
    min_lon: float
    max_lon: float
    min_lat: float
    max_lat: float

    def __post_init__(self):
        if self.elev.is_cuda:
            # every path onto the card starts from a grid: keep f32 matmuls
            # (the variogram fit's normal equations) and convolutions at full
            # precision; TF32 keeps ~3 digits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    # -- geometry ----------------------------------------------------------
    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.elev.shape)

    @property
    def num_lat(self) -> int:
        return self.elev.shape[0]

    @property
    def num_lon(self) -> int:
        return self.elev.shape[1]

    @property
    def lon_step(self) -> float:
        return (self.max_lon - self.min_lon) / (self.num_lon - 1)

    @property
    def lat_step(self) -> float:
        return (self.max_lat - self.min_lat) / (self.num_lat - 1)

    @property
    def extent(self) -> Extent:
        return Extent(self.min_lon, self.max_lon, self.min_lat, self.max_lat)

    @property
    def dtype(self) -> torch.dtype:
        return self.elev.dtype

    @property
    def device(self) -> torch.device:
        return self.elev.device

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_nan_array(cls, elev, extent: Extent, dtype=torch.float32, device="cuda") -> "RegularGrid":
        """Build from a (H, W) array where missing cells are NaN: split it into
        (values, mask) and copy both to ``device`` once.  The default device
        is the card: a CPU grid (``device="cpu"``) runs the plain versions."""
        elev = np.asarray(elev, dtype=np.float64)
        valid = np.isfinite(elev)
        filled = np.where(valid, elev, 0.0)
        return cls(
            elev=torch.as_tensor(filled, dtype=dtype).to(device),
            valid=torch.as_tensor(valid, dtype=dtype).to(device),
            min_lon=float(extent.min_lon),
            max_lon=float(extent.max_lon),
            min_lat=float(extent.min_lat),
            max_lat=float(extent.max_lat),
        )

    @classmethod
    def dense(cls, elev, extent: Extent, dtype=torch.float32, device="cuda") -> "RegularGrid":
        """Build from a fully observed (H, W) array (on the card unless
        ``device`` says otherwise)."""
        ev = torch.as_tensor(np.asarray(elev), dtype=dtype).to(device)
        return cls(
            elev=ev,
            valid=torch.ones_like(ev),
            min_lon=float(extent.min_lon),
            max_lon=float(extent.max_lon),
            min_lat=float(extent.min_lat),
            max_lat=float(extent.max_lat),
        )

    # -- converters ---------------------------------------------------------
    def to_nan_array(self) -> np.ndarray:
        """Back to the in-band-NaN representation (host, f64)."""
        elev = self.elev.detach().cpu().numpy().astype(np.float64)
        valid = self.valid.detach().cpu().numpy() > 0.5
        return np.where(valid, elev, np.nan)

    def index_to_lonlat(self, rows, cols):
        """Grid indices -> geographic coords (host, f64; test_gebco.cpp:72-81)."""
        lat = self.min_lat + np.asarray(rows, dtype=np.float64) * self.lat_step
        lon = self.min_lon + np.asarray(cols, dtype=np.float64) * self.lon_step
        return lon, lat

    def lonlat_to_xy(self, lons, lats):
        """Geographic coords -> continuous grid coords (x = col, y = row)."""
        x = (torch.as_tensor(lons) - self.min_lon) / self.lon_step
        y = (torch.as_tensor(lats) - self.min_lat) / self.lat_step
        return x, y
