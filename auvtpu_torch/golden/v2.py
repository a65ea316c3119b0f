"""Numpy float64 twin of the ops' "v2" semantics (a numpy-only copy of
:mod:`auvtpu.golden.v2`).

v2 differs from the bit-exact reference model (engine.py) only in the NaN
fallback neighbor selection: the full (2R+1)^2 window is eligible (no ring
cutoff) and the k nearest valid cells are chosen by a *stable*
(squared-distance, collection-order) key.  Main interpolation paths
(bilinear, bicubic stencil, kriging system, variogram) are identical to the
reference.

This is the oracle the scattered ops and ``cli.bench_grid_a`` are validated
against at f32 tolerance.
"""

from __future__ import annotations

import numpy as np

from ..config import IDWConfig
from ..tables import ring_offsets
from .engine import GoldenGrid


class GoldenV2(GoldenGrid):
    """convention='reference' measures candidate distances to cell centers
    (+0.5) and offsets kriging neighbor coords by half a cell, like the
    reference; 'centered' uses the symmetric metric.
    """

    def __init__(self, *args, convention: str = "reference", **kw):
        super().__init__(*args, **kw)
        self.convention = convention
        self._half = 0.5 if convention == "reference" else 0.0

    def _window_topk(self, x, y, ci, cj, k):
        cfg = self.kriging_cfg.fallback
        offs, _ = ring_offsets(cfg.max_radius)
        gi = ci[:, None] + offs[None, :, 0]
        gj = cj[:, None] + offs[None, :, 1]
        inb = (gi >= 0) & (gi < self.num_lon) & (gj >= 0) & (gj < self.num_lat)
        gic = np.clip(gi, 0, self.num_lon - 1)
        gjc = np.clip(gj, 0, self.num_lat - 1)
        val = self.elev[gjc, gic]
        ok = inb & np.isfinite(val)

        di = (gi + self._half) - x[:, None]
        dj = (gj + self._half) - y[:, None]
        d2 = di * di + dj * dj
        d2 = np.where(ok, d2, np.inf)
        idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
        rows = np.arange(x.shape[0])[:, None]
        found = ok.sum(axis=1)
        return (
            val[rows, idx],
            gic[rows, idx],
            gjc[rows, idx],
            d2[rows, idx],
            np.minimum(found, k),
        )

    def _ring_select(self, x, y, ci, cj):
        """Override: v2 selection (k=4), same return contract as the exact
        engine so cubic/kriging fallback paths reuse it unchanged."""
        val, gi, gj, _, found = self._window_topk(x, y, ci, cj, 4)
        return val, gi, gj, found

    # ------------------------------------------------------------------
    def idw(self, lons, lats, k: int = 8, power: float = 2.0) -> np.ndarray:
        cfg = IDWConfig(k=k, power=power)
        return self._chunked(lambda lo, la: self._idw(lo, la, cfg), lons, lats)

    def _idw(self, lons, lats, cfg: IDWConfig):
        x, y, oob = self._normalize(lons, lats)
        xs = np.where(oob, 0.0, x)
        ys = np.where(oob, 0.0, y)
        ci = np.clip(np.floor(xs + 0.5).astype(np.int64), 0, self.num_lon - 1)
        cj = np.clip(np.floor(ys + 0.5).astype(np.int64), 0, self.num_lat - 1)
        val, _, _, d2, found = self._window_topk(xs, ys, ci, cj, cfg.k)
        slot = np.arange(cfg.k)[None, :] < found[:, None]
        w = np.where(slot, 1.0 / (d2 ** (cfg.power / 2.0) + cfg.eps), 0.0)
        ws = w.sum(axis=1)
        out = np.where(ws > 0, (w * np.where(slot, val, 0.0)).sum(axis=1) / np.maximum(ws, cfg.eps), np.nan)
        return np.where(oob, np.nan, out)
