"""auvtpu_torch: the dense (Grid B) fills, the streaming mosaic, the
scattered (Grid A) serving, mission serving, exact mode, the learned
baseline, the serving artifacts, the scattered prototype and the parallel
layer of :mod:`auvtpu` in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(sm_90a).

Imports torch, numpy and the standard library only (scipy and pandas for
file I/O), never jax or auvtpu.

- :mod:`auvtpu_torch.grid`       RegularGrid: (elev, valid) tensors on one device
- :mod:`auvtpu_torch.config`     the reference's constants
- :mod:`auvtpu_torch.tables`     static distance-sorted offset tables
- :mod:`auvtpu_torch.masking`    seeded masking, as the reference pipeline
- :mod:`auvtpu_torch.synthetic`  synthetic bathymetry (Kerguelen stand-in)
- :mod:`auvtpu_torch.variogram`  empirical variogram + Gauss-Newton fit; the
                                 directional variogram + anisotropic fit
- :mod:`auvtpu_torch.ops`        kriging solve; bilinear, mean, IDW, kriging fills;
                                 scattered ops, stencil packs, TwoTierInterpolator;
                                 the band router; exact mode (f64); tile-streaming
                                 scattered ops
- :mod:`auvtpu_torch.learned`    the masked-convolution inpainting baseline
- :mod:`auvtpu_torch.golden`     f64 numpy oracles (GoldenGrid, GoldenV2)
- :mod:`auvtpu_torch.kernels`    CUDA kernels, their wrappers, the nvcc build, and
                                 B1/B3/B7/B8 as torch.library custom ops (``library``)
- :mod:`auvtpu_torch.serve`      torch.export serving artifacts (fills, the packed
                                 engine, the learned fill, the mission pair)
- :mod:`auvtpu_torch.scattered`  the prototype: kNN search, IDW/AIDW/plane/kriging
                                 over the k nearest samples, sample_and_reconstruct
- :mod:`auvtpu_torch.streaming`  StreamingInterpolator: staged ingest, window fills
- :mod:`auvtpu_torch.parallel`   the parallel layer over torch.distributed: meshes,
                                 sharded fills and fit+fill, sharded streaming
                                 mosaics, sharded atlases, torchrun bootstrap
- :mod:`auvtpu_torch.metrics`    the reference's error metrics
- :mod:`auvtpu_torch.io`         GEBCO tiles, grid/point CSVs, the results CSV
- :mod:`auvtpu_torch.utils`      end-to-end and steady-state timing; debug_mode
                                 (raise at the op that makes a NaN); trace
- :mod:`auvtpu_torch.cli`        bench_grid_a, bench_grid_b, stream_demo, mission,
                                 learned_eval, prototype, demo, gen_grid, subset,
                                 analyze, plots, figures
- :mod:`auvtpu_torch.convert`    state from the JAX package, numpy in
- :mod:`auvtpu_torch.entry`      fit_fill: fit, fill, keep observed cells;
                                 dryrun_multichip: the distributed steps on n ranks
"""

__version__ = "0.1.0"

from .config import (EngineConfig, Extent, FallbackConfig, IDWConfig, KERGUELEN_EXTENT, KrigingConfig,
                     VariogramConfig)
from .grid import RegularGrid

__all__ = [
    "EngineConfig",
    "Extent",
    "FallbackConfig",
    "IDWConfig",
    "KERGUELEN_EXTENT",
    "KrigingConfig",
    "VariogramConfig",
    "RegularGrid",
    "__version__",
]
