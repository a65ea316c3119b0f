"""Seeded random masking.

Reproduces subset_bathymetry.py:32-44 (legacy ``RandomState``,
``choice(total, n, replace=False)``, seed 42) exactly as
``auvtpu.masking`` does, so both packages score the same held-out cells;
:func:`random_mask_device` draws a mask on a device from a torch generator.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import DEFAULT_MASK_SEED


def select_random_points(
    shape: tuple[int, int], removal_fraction: float, seed: int = DEFAULT_MASK_SEED
) -> np.ndarray:
    """Flat indices of the cells to remove, in the reference's order.

    Returns an int64 array of length int(H*W*removal_fraction).
    """
    rows, cols = shape
    total = rows * cols
    n_remove = int(total * removal_fraction)
    rng = np.random.RandomState(seed)
    return rng.choice(total, size=n_remove, replace=False)


def mask_grid(elev: np.ndarray, removal_fraction: float, seed: int = DEFAULT_MASK_SEED):
    """Apply the reference masking pipeline to a dense (H, W) array.

    Returns (reduced, removed_rc, removed_vals):
      reduced      (H, W) float64 with removed cells = NaN,
      removed_rc   (N, 2) int (row, col) in selection order,
      removed_vals (N,) float64 held-out truth.
    """
    elev = np.asarray(elev, dtype=np.float64)
    flat_idx = select_random_points(elev.shape, removal_fraction, seed)
    rows, cols = np.divmod(flat_idx, elev.shape[1])
    vals = elev[rows, cols].copy()
    reduced = elev.copy()
    reduced[rows, cols] = np.nan
    return reduced, np.stack([rows, cols], axis=1), vals


def random_mask_device(generator: torch.Generator, shape: tuple[int, int], removal_fraction: float) -> torch.Tensor:
    """Boolean (H, W) removal mask drawn on the generator's device: the first
    ``int(H*W*removal_fraction)`` cells of a ``torch.randperm`` drawn from
    ``generator``, so one seed gives one mask.

    The counterpart of ``auvtpu.masking.random_mask_device``, which draws
    through ``jax.random.permutation``: torch's generators are other
    generators, so the cells drawn differ from the JAX package's for any
    seed.  Reproducing the reference's cells is :func:`mask_grid`'s job."""
    n = shape[0] * shape[1]
    n_remove = int(n * removal_fraction)
    perm = torch.randperm(n, generator=generator, device=generator.device)
    mask = torch.zeros(n, dtype=torch.bool, device=generator.device)
    mask[perm[:n_remove]] = True
    return mask.reshape(shape)
