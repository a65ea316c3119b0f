"""I/O: GEBCO netCDF3 tiles, grid/point CSVs, and the results CSV (copy of
:mod:`auvtpu.io`, host-side numpy; the grid CSVs go through pandas).

All CSV schemas are kept byte-compatible with the reference so the analysis
notebooks can diff outputs:

- grid CSV: bare matrix, one row per latitude, ``nan`` for missing cells
  (writeCSVGrid generate_csv_grids.cpp:73-88, readGridCSV test_gebco.cpp:19-40);
- points CSV: header ``lon,lat,interpolated_value`` (test_gebco.cpp:86-96);
- reference_missing.csv: headerless ``row,col,elevation`` (subset_bathymetry.py:49-57);
- results CSV: ``Machine,InterpolationType,GridType,BatchSize,Time,
  RemovalFraction,MAE,RMSE,Max Error`` appended per run
  (results/TestingResults1.csv:1, test_gebco.cpp:277-301).
"""

from __future__ import annotations

import os

import numpy as np

from .config import RESULTS_SCHEMA


# --------------------------------------------------------------------------
# GEBCO netCDF
# --------------------------------------------------------------------------

def load_gebco(path: str):
    """Read a GEBCO netCDF3 tile -> (lat, lon, elev) float64 arrays.

    elev rows follow the file order (GEBCO: lat ascending, row 0 = south).
    """
    from scipy.io import netcdf_file

    f = netcdf_file(path, mmap=False)
    try:
        lat = np.array(f.variables["lat"][:], dtype=np.float64)
        lon = np.array(f.variables["lon"][:], dtype=np.float64)
        elev = np.array(f.variables["elevation"][:], dtype=np.float64)
    finally:
        f.close()
    return lat, lon, elev


def load_gebco_flipped(path: str):
    """GEBCO tile with rows flipped (subset_bathymetry.py:17): the reference
    reverses row order before masking/harness use.  Because GEBCO rows ascend
    in latitude, the flipped grid actually has row 0 = max_lat while the
    harness labels it min_lat, a self-consistent relabeling kept verbatim for
    parity (interpolation is purely index-space)."""
    lat, lon, elev = load_gebco(path)
    return lat, lon, elev[::-1].copy()


# --------------------------------------------------------------------------
# Grid CSV (matrix format)
# --------------------------------------------------------------------------

def read_grid_csv(path: str) -> np.ndarray:
    """Matrix CSV -> (H, W) float64 with NaN for 'nan' cells."""
    import pandas as pd

    df = pd.read_csv(path, header=None, dtype=np.float64, na_values=["nan"])
    return df.to_numpy()


def write_grid_csv(path: str, grid: np.ndarray) -> None:
    """(H, W) -> matrix CSV, NaN rendered as 'nan' (na_rep in the reference)."""
    import pandas as pd

    pd.DataFrame(np.asarray(grid)).to_csv(path, header=False, index=False, na_rep="nan")


# --------------------------------------------------------------------------
# Point CSVs
# --------------------------------------------------------------------------

def write_points_csv(path: str, lons, lats, vals) -> None:
    """lon,lat,interpolated_value with header (test_gebco.cpp:86-96)."""
    with open(path, "w") as f:
        f.write("lon,lat,interpolated_value\n")
        for lo, la, v in zip(np.asarray(lons), np.asarray(lats), np.asarray(vals)):
            f.write(f"{lo:.10g},{la:.10g},{v:.10g}\n")


def write_reference_missing(path: str, rows_cols: np.ndarray, vals: np.ndarray) -> None:
    """Headerless row,col,elevation (subset_bathymetry.py:49-57)."""
    with open(path, "w") as f:
        for (r, c), v in zip(np.asarray(rows_cols), np.asarray(vals)):
            f.write(f"{int(r)},{int(c)},{v:.10g}\n")


def read_reference_missing(path: str):
    """-> (rows_cols (N,2) int, vals (N,) f64); mirrors readSpecificPointIndices
    (test_gebco.cpp:47-66)."""
    data = np.loadtxt(path, delimiter=",", dtype=np.float64, ndmin=2)
    rc = data[:, :2].astype(np.int64)
    return rc, data[:, 2]


# --------------------------------------------------------------------------
# Results CSV (append-only, reference schema)
# --------------------------------------------------------------------------

class ResultsWriter:
    """Append-only results log, schema-identical to TestingResults1.csv plus
    optional extra columns appended after the reference 9:

    - Region: the analysis notebooks wished they had it;
    - EndToEndTime: the reference's Time column is one batch call on an
      already-built engine, including per-batch H2D/D2H staging and the
      device sync (GridD.cu:107-147 inside the timed region), and never
      compilation.  Here ``Time`` records steady-state device throughput
      (queued calls, one synchronise) and ``EndToEndTime`` one WARM
      end-to-end call with full result readback
      (:func:`auvtpu_torch.utils.timing.warm_e2e_ms`), the
      reference-comparable number.  First-call time (kernel build, caches)
      is logged to stdout only, never recorded here.
    """

    def __init__(self, path: str, with_region: bool = False, with_cold: bool = False):
        self.path = path
        self.with_region = with_region
        self.with_cold = with_cold
        header = ",".join(
            RESULTS_SCHEMA
            + (("Region",) if with_region else ())
            + (("EndToEndTime",) if with_cold else ())
        )
        if not os.path.exists(path) or os.path.getsize(path) == 0:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                f.write(header + "\n")

    def append(
        self,
        machine: str,
        method: str,
        grid_type: str,
        batch_size: int,
        time_ms: float,
        removal_fraction,
        mae,
        rmse,
        max_error,
        region: str = "",
        cold_ms=None,
    ) -> None:
        def fmt(v):
            if v is None:
                return "nan"
            if isinstance(v, str):
                return v
            return f"{v:g}"

        row = [
            machine,
            method,
            grid_type,
            str(batch_size),
            fmt(time_ms),
            fmt(removal_fraction),
            fmt(mae),
            fmt(rmse),
            fmt(max_error),
        ]
        if self.with_region:
            row.append(region)
        if self.with_cold:
            row.append(fmt(cold_ms))
        with open(self.path, "a") as f:
            f.write(",".join(row) + "\n")
