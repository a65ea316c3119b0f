"""Core data model: a regular lat/lon grid held as two tensors on one device.

Counterpart of :mod:`auvtpu.grid`.  Missing cells are carried as a separate
validity plane (f32 0/1) over a NaN-free, zero-filled elevation plane; NaN
appears only at the I/O boundary (:meth:`RegularGrid.to_nan_array`).

Geometry (GridH.cpp:156-157): ``lon_step = (max_lon - min_lon) / (W - 1)``,
row 0 is ``min_lat``, column 0 is ``min_lon``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .config import Extent
from .utils.profiling import span


def as_dtype(v: float, dtype: torch.dtype) -> float:
    """The python float ``v`` rounded to ``dtype``, so that torch's scalar
    arithmetic on a ``dtype`` tensor sees the value JAX's weak-typed scalar
    becomes."""
    return float(np.float32(v)) if dtype == torch.float32 else float(v)


def device_cache(maxsize: int):
    """``functools.lru_cache`` for a function that makes tensors (or a
    module) from hashable arguments, bypassed while ``torch.export`` (or
    ``torch.compile``) traces the caller: a tensor made then is a constant
    of the traced program, a fake tensor while the trace runs, and must not
    enter a cache that live calls read.  Every such cache of the package is
    one of these.  A miss runs ``fn`` inside the span
    ``<module>.<function>:miss``, so a constant made again under a profiler
    shows by name; a hit never opens it."""

    def wrap(fn):
        name = f"{fn.__module__}.{fn.__qualname__}:miss"

        @functools.wraps(fn)
        def miss(*args):
            with span(name):
                return fn(*args)

        cached = functools.lru_cache(maxsize=maxsize)(miss)

        @functools.wraps(fn)
        def call(*args):
            if torch.compiler.is_compiling() or torch.compiler.is_exporting():
                return fn(*args)
            return cached(*args)

        call.cache_clear, call.cache_info = cached.cache_clear, cached.cache_info
        return call

    return wrap


def divisor(v, like: torch.Tensor):
    """``v`` (a python number or a tensor) as a divisor of the tensor
    ``like``.  A python scalar dividing a CUDA tensor is a multiply by its
    rounded reciprocal, which can move a quotient by an ulp from the
    division JAX computes (and the kernels do); on the card a number becomes
    a 0-d tensor of ``like``'s dtype, made once per value."""
    if torch.is_tensor(v) or like.device.type == "cpu":
        return v
    return _scalar_tensor(float(v), like.dtype, like.device)


@device_cache(maxsize=64)
def _scalar_tensor(v: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(v, dtype=dtype, device=device)


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

    def inv_steps(self, dtype: torch.dtype | None = None) -> tuple[float, float]:
        """(1 / lon_step, 1 / lat_step) as the compiled JAX ops use them:
        each step rounded to ``dtype`` (the grid's by default), then one
        divided by it in ``dtype``, as python floats exact in ``dtype``.
        The JAX ops are jitted with the extent as static metadata, so XLA
        folds ``(lon - min_lon) / lon_step`` into a multiply by the
        reciprocal of the constant step; the scattered queries' coordinates
        are that product (:func:`auvtpu_torch.ops.scattered._normalize`).
        A python scalar factor is exact on the CPU and the card alike."""
        dtype = self.dtype if dtype is None else dtype
        if dtype == torch.float32:
            return tuple(float(np.float32(1.0) / np.float32(s)) for s in (self.lon_step, self.lat_step))
        return 1.0 / self.lon_step, 1.0 / self.lat_step

    def step_tensors(self, dtype: torch.dtype | None = None, device=None):
        """(lon_step, lat_step) rounded to ``dtype`` as 0-d tensors on
        ``device`` (the grid's by default), made once per grid.  The mission
        path's coordinates divide by these (:meth:`lonlat_to_xy`,
        ``ops.band._xy``): its JAX callers compute them outside any jit, as a
        division.  A python-scalar divisor of a CUDA tensor is a multiply by
        its reciprocal, which can move a quotient by an ulp from that
        division."""
        dtype = self.dtype if dtype is None else dtype
        device = self.device if device is None else torch.device(device)
        cache = self.__dict__.setdefault("_step_tensors", {})  # frozen: no setattr
        steps = cache.get((dtype, device))
        if steps is None:
            steps = tuple(torch.tensor(s, dtype=dtype, device=device) for s in (self.lon_step, self.lat_step))
            cache[(dtype, device)] = steps
        return steps

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
        """Geographic coords -> continuous grid coords (x = col, y = row), in
        the queries' floating dtype: ``(lon - min_lon) / lon_step`` with both
        scalars rounded to it, the step divided as a 0-d tensor (exact
        division on a card too).  This is the JAX package's
        ``lonlat_to_xy`` as its callers (the mission resamplers and
        router, ``auvtpu/ops/band.py``) run it: eagerly, a division."""
        out = []
        for i, (q, lo) in enumerate(((lons, self.min_lon), (lats, self.min_lat))):
            q = torch.as_tensor(q)
            dt = q.dtype if q.is_floating_point() else torch.get_default_dtype()
            out.append((q.to(dt) - as_dtype(lo, dt)) / self.step_tensors(dt, q.device)[i])
        return tuple(out)
