"""Hand-written CUDA kernels for Hopper, built from ``csrc/`` with nvcc at
first use and bound with ctypes; every kernel (B1-B19) is registered as a
``torch.library`` custom op (:mod:`.library`), through which its wrappers
launch it.  Importing this package builds nothing."""

from .scattered_select import packed_idw_fused, packed_kriging_fused, window_select_fused
from .valid_select import kriging_valid_t, packed_idw_t, packed_kriging_t, valid_select_t
from .window_fill import (
    LAUNCHES,
    fill_kriging_fused,
    fill_kriging_fused_ref,
    reset_launches,
    topk_full,
    topk_full_ref,
)

__all__ = [
    "LAUNCHES",
    "fill_kriging_fused",
    "fill_kriging_fused_ref",
    "reset_launches",
    "topk_full",
    "topk_full_ref",
    "kriging_valid_t",
    "packed_idw_fused",
    "packed_idw_t",
    "packed_kriging_fused",
    "packed_kriging_t",
    "valid_select_t",
    "window_select_fused",
]
