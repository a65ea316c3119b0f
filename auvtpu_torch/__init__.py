"""auvtpu_torch: the dense (Grid B) fills and the streaming mosaic of
:mod:`auvtpu` in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(sm_90a).

Imports torch, numpy and the standard library only (scipy and pandas for
file I/O), never jax or auvtpu.

- :mod:`auvtpu_torch.grid`       RegularGrid: (elev, valid) tensors on one device
- :mod:`auvtpu_torch.config`     the reference's constants
- :mod:`auvtpu_torch.tables`     static distance-sorted offset tables
- :mod:`auvtpu_torch.masking`    seeded masking, as the reference pipeline
- :mod:`auvtpu_torch.synthetic`  synthetic bathymetry (Kerguelen stand-in)
- :mod:`auvtpu_torch.variogram`  empirical variogram + Gauss-Newton fit
- :mod:`auvtpu_torch.ops`        kriging solve; bilinear, mean, IDW, kriging fills
- :mod:`auvtpu_torch.kernels`    CUDA kernels, their wrappers, the nvcc build
- :mod:`auvtpu_torch.streaming`  StreamingInterpolator: staged ingest, window fills
- :mod:`auvtpu_torch.metrics`    the reference's error metrics
- :mod:`auvtpu_torch.io`         GEBCO tiles, grid/point CSVs, the results CSV
- :mod:`auvtpu_torch.utils`      end-to-end and steady-state timing
- :mod:`auvtpu_torch.cli`        bench_grid_b, stream_demo
- :mod:`auvtpu_torch.convert`    state from the JAX package, numpy in
- :mod:`auvtpu_torch.entry`      fit_fill: fit, fill, keep observed cells
"""

__version__ = "0.1.0"

from .config import Extent, FallbackConfig, IDWConfig, KERGUELEN_EXTENT, KrigingConfig, VariogramConfig
from .grid import RegularGrid

__all__ = [
    "Extent",
    "FallbackConfig",
    "IDWConfig",
    "KERGUELEN_EXTENT",
    "KrigingConfig",
    "VariogramConfig",
    "RegularGrid",
    "__version__",
]
