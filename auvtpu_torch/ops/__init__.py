"""Torch interpolation ops: the dense (cell-aligned) fills of Grid B and the
2x upsampling of Grid A, the scattered-query ops (plain windowed and packed)
of Grid A and the two-tier scattered engine, the kriging solve core, and
the trajectory-band router of mission serving, exact mode (the
reference's ring-segment selection with swap tie-breaks, in f64), and the
tile-streaming scattered ops (queries sorted by grid tile)."""

from .band import (
    COST_NS,
    LERP_MODE_DEFAULT,
    AtlasResampler,
    Band,
    BandAtlas,
    BandResampler,
    BandRouter,
    build_atlas,
    fill_band,
    place_segments,
    plan_segments,
)
from .batch import apply_chunked
from .dense import (
    fill_bilinear,
    fill_idw,
    fill_kriging,
    fill_window_mean,
    krige_planes,
    kriging_at_cells,
    resolve_backend,
    upsample2x_bicubic,
    upsample2x_bilinear,
    window_topk_idx,
    window_topk_planes,
)
from .exact import (
    exact_bilinear_at_cells,
    exact_cubic_at_cells,
    exact_kriging_at_cells,
    exact_select_at_cells,
    prepare_exact_queries,
)
from .packs import (
    StencilPack,
    build_valid16_pack,
    packed_bicubic,
    packed_bilinear,
    packed_idw,
    packed_kriging,
    packed_kriging_valid,
    packed_window_select,
)
from .scattered import (
    gj56,
    krige_solve,
    krige_solve_cols,
    lu56,
    scattered_bicubic,
    scattered_bilinear,
    scattered_idw,
    scattered_kriging,
    variogram,
)
from .tiled import tiled_bicubic, tiled_bilinear, tiled_idw, tiled_kriging
from .two_tier import TwoTierInterpolator
from .window import ring_tables, window_select

__all__ = [
    "COST_NS",
    "LERP_MODE_DEFAULT",
    "AtlasResampler",
    "Band",
    "BandAtlas",
    "BandResampler",
    "BandRouter",
    "build_atlas",
    "fill_band",
    "place_segments",
    "plan_segments",
    "apply_chunked",
    "fill_bilinear",
    "fill_idw",
    "fill_kriging",
    "fill_window_mean",
    "krige_planes",
    "kriging_at_cells",
    "resolve_backend",
    "upsample2x_bicubic",
    "upsample2x_bilinear",
    "window_topk_idx",
    "window_topk_planes",
    "exact_bilinear_at_cells",
    "exact_cubic_at_cells",
    "exact_kriging_at_cells",
    "exact_select_at_cells",
    "prepare_exact_queries",
    "StencilPack",
    "build_valid16_pack",
    "packed_bicubic",
    "packed_bilinear",
    "packed_idw",
    "packed_kriging",
    "packed_kriging_valid",
    "packed_window_select",
    "gj56",
    "krige_solve",
    "krige_solve_cols",
    "lu56",
    "scattered_bicubic",
    "scattered_bilinear",
    "scattered_idw",
    "scattered_kriging",
    "variogram",
    "tiled_bicubic",
    "tiled_bilinear",
    "tiled_idw",
    "tiled_kriging",
    "TwoTierInterpolator",
    "ring_tables",
    "window_select",
]
