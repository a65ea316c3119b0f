"""Two-tier scattered interpolation: packed fast path + rare escalation
(counterpart of :mod:`auvtpu.ops.two_tier`).

A radius-2 stencil pack resolves the k nearest valid neighbours of nearly
every query with one row read; the rare queries whose 5x5 window cannot
prove its answer (probability ~f^20 at removal f) are recomputed by the
radius-10 window op in chunks.  A query is 'resolved' when its k-th selected
neighbour is strictly closer than the nearest conceivable cell outside the
5x5 window (:meth:`TwoTierInterpolator._outside_min_d2`): then the radius-2
and radius-10 selections provably coincide.  Everything else escalates.
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import RegularGrid
from ..tables import sorted_offsets
from .packs import StencilPack, packed_idw, packed_kriging, packed_window_select
from .scattered import queries, scattered_idw, scattered_kriging

BACKENDS = ("torch", "fused", "transposed")


class TwoTierInterpolator:
    """Reusable scattered-query engine over a (possibly masked) grid."""

    def __init__(self, grid: RegularGrid, *, convention: str = "reference", escalate_cap: int = 1 << 14, backend: str = "auto"):
        """backend: 'transposed' runs the fast path's selection through the
        B11 (kriging) and B6 (IDW) kernels with the resolution test folded
        into the selection; 'fused' through B12 (kriging) and B15 (IDW),
        B7's window selection with its epilogue; 'torch' is the packed stable
        sort; 'auto' (default) is 'transposed' on a CUDA float32 grid and
        'torch' otherwise.  Escalation and the resolved mask are the same
        for every backend."""
        self.grid = grid
        self.convention = convention
        self.pack = StencilPack(grid, window_radius=2)
        self.escalate_cap = escalate_cap
        if backend == "auto":
            backend = "transposed" if grid.elev.is_cuda and grid.dtype == torch.float32 else "torch"
        if backend not in BACKENDS:
            raise ValueError(backend)
        self.backend = backend

    def _outside_min_d2(self) -> float:
        """Infimum of the squared distance from ANY query position inside the
        centre cell (fractional offset f in [-0.5, 0.5]^2) to any cell OUTSIDE
        the radius-2 window.  Per-axis lower bound for candidate offset d:
        reference convention |d + 0.5 - f| >= max(0, |d + 0.5| - 0.5);
        centered |d - f| >= max(0, |d| - 0.5).  A radius-3 edge cell can come
        as close as d^2 = 4.0 (reference) / 6.25 (centered)."""
        dxs, dys, _ = sorted_offsets(10, self.convention)
        outside = (np.abs(dxs) > 2) | (np.abs(dys) > 2)
        half = 0.5 if self.convention == "reference" else 0.0

        def lb(d):
            return np.maximum(0.0, np.abs(d + half) - 0.5)

        lo2 = lb(dxs[outside].astype(np.float64)) ** 2 + lb(dys[outside].astype(np.float64)) ** 2
        return float(lo2.min())

    def _resolved_mask(self, lons, lats, k):
        sel = packed_window_select(
            self.pack.window, self.grid, lons, lats, k=k, window_radius=2, convention=self.convention
        )
        # resolved iff k candidates were found AND the k-th beats the nearest
        # conceivable outside-window cell (ties resolve to the inside cell:
        # collection order sorts smaller rings first)
        m = (sel["found"] >= k) & (sel["d2"][:, k - 1] < self._outside_min_d2())
        return m, (~m).sum()

    def _run(self, fast_fn, slow_fn, lons, lats, k, combined=False):
        """combined=True: fast_fn returns (fast, resolved_mask, bad_count)
        from one kernel call (the transposed backend folds the resolution
        test into the selection's last slot)."""
        lons, lats = queries(self.grid, lons, lats)
        if combined:
            fast, mask, bad_count = fast_fn(lons, lats)
        else:
            fast = fast_fn(lons, lats)
            mask, bad_count = self._resolved_mask(lons, lats, k)
        n_bad = int(bad_count)  # the only host sync (a scalar)
        if n_bad == 0:
            return fast
        # the unresolved queries, recomputed by the radius-10 path in chunks
        # of at most ``escalate_cap`` (which bounds its (chunk, 441)
        # candidate tensors whatever the batch size), merged in place
        cap = max(64, int(self.escalate_cap))
        idx = torch.nonzero(~mask).reshape(-1)
        out = fast
        for s in range(0, n_bad, cap):
            sl = idx[s:s + cap]
            slow = slow_fn(lons[sl], lats[sl])
            if isinstance(out, tuple):
                for o, v in zip(out, slow):
                    o[sl] = v
            else:
                out[sl] = slow
        return out

    def kriging(self, lons, lats, *, return_variance: bool = False):
        """Ordinary kriging at scattered points.  return_variance=True also
        returns the prediction variance (the variance of whichever tier
        produced the prediction; NaN at fallback queries), through the torch
        packed fast path: the select kernels emit no variance."""
        slow = lambda lo, la: scattered_kriging(
            self.grid, lo, la, max_radius=10, convention=self.convention, with_variance=return_variance
        )
        if return_variance:
            fast = lambda lo, la: packed_kriging(
                self.pack.window, self.grid, lo, la,
                window_radius=2, convention=self.convention, with_variance=True,
            )
            return self._run(fast, slow, lons, lats, k=4)
        if self.backend == "transposed":
            from ..kernels.valid_select import packed_kriging_t

            fast = lambda lo, la: packed_kriging_t(
                self.pack.window, self.grid, lo, la, window_radius=2,
                convention=self.convention, resolve_thresh=self._outside_min_d2(),
            )
            return self._run(fast, slow, lons, lats, k=4, combined=True)
        if self.backend == "fused":
            from ..kernels.scattered_select import packed_kriging_fused as fast_op
        else:
            fast_op = packed_kriging
        fast = lambda lo, la: fast_op(self.pack.window, self.grid, lo, la, window_radius=2, convention=self.convention)
        return self._run(fast, slow, lons, lats, k=4)

    def idw(self, lons, lats, k: int = 8):
        """k-nearest IDW (power 2) at scattered points."""
        slow = lambda lo, la: scattered_idw(self.grid, lo, la, k=k, max_radius=10, convention=self.convention)
        if self.backend == "transposed":
            from ..kernels.valid_select import packed_idw_t

            fast = lambda lo, la: packed_idw_t(
                self.pack.window, self.grid, lo, la, k=k, window_radius=2,
                convention=self.convention, resolve_thresh=self._outside_min_d2(),
            )
            return self._run(fast, slow, lons, lats, k=k, combined=True)
        if self.backend == "fused":
            from ..kernels.scattered_select import packed_idw_fused as fast_op
        else:
            fast_op = packed_idw
        fast = lambda lo, la: fast_op(self.pack.window, self.grid, lo, la, k=k, window_radius=2, convention=self.convention)
        return self._run(fast, slow, lons, lats, k=k)
