"""Float64 host-side golden models (numpy copies of :mod:`auvtpu.golden`):
the parity oracle that ``cli.bench_grid_a`` validates the port against."""

from ..tables import ring_offsets
from .engine import GoldenGrid
from .v2 import GoldenV2

__all__ = ["GoldenGrid", "GoldenV2", "ring_offsets"]
