"""Golden model: float64 numpy engine with exact GridH semantics.

A numpy-only copy of :mod:`auvtpu.golden.engine` (the port may not import
the JAX package), pinned equal to it by ``tests/test_torch_golden.py``.  It
re-implements the reference CPU engine (src/GridH.cpp) as vectorized numpy,
preserving every observable quirk so outputs match bit-for-bit (same IEEE-754
double operations in the same order per value):

- bounds test is strict ``lon < min || lon > max`` -> NaN (GridH.cpp:162-164);
- bilinear clamps only the +1 indices (GridH.cpp:170-173) and falls back to the
  mean of valid corners when any corner is NaN (GridH.cpp:186-199);
- bicubic uses floor()-anchored 4x4 Catmull-Rom with clamped indices
  (GridH.cpp:231-271) and, if *any* of the 16 cells is NaN, the ring fallback
  (GridH.cpp:274-318);
- the ring search (GridH.cpp:24-118) visits center, then per ring r: top/bottom
  edges interleaved per dx, a break check, then left/right edges per dy, and a
  second break check once >= 4 candidates are held;
- the "4 nearest" selection is a 4-pass selection sort **with swaps**
  (GridH.cpp:123-140), emulated exactly: the swaps can reorder
  equal-distance candidates;
- kriging centers at round(x) (half away from zero, GridH.cpp:333-336), places
  neighbors at cell centers ``(i+0.5)*step`` but the query at its raw
  coordinate (GridH.cpp:364-367, 393-396), uses the exponential variogram with
  nugget 1 / sill 100 / range 10 in degrees (GridH.cpp:371-376), and solves the
  5x6 system by unpivoted Gauss-Jordan with a 1e-12 singular bailout to the
  4-neighbor average (GridH.cpp:400-414).
"""

from __future__ import annotations

import numpy as np

from ..config import KrigingConfig
from ..tables import ring_offsets


def _catmull_rom(p0, p1, p2, p3, t):
    """0.5*(2 p1 + (-p0+p2) t + (2p0-5p1+4p2-p3) t^2 + (-p0+3p1-3p2+p3) t^3)
    evaluated with the same association as GridH.cpp:215-217."""
    return 0.5 * (
        2 * p1
        + (-p0 + p2) * t
        + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t * t
        + (-p0 + 3 * p1 - 3 * p2 + p3) * t * t * t
    )


class GoldenGrid:
    """Float64 reference engine over an in-band-NaN grid."""

    def __init__(
        self,
        elev_nan: np.ndarray,
        min_lon: float,
        max_lon: float,
        min_lat: float,
        max_lat: float,
        kriging: KrigingConfig = KrigingConfig(),
        chunk: int = 32_768,
    ):
        self.elev = np.ascontiguousarray(elev_nan, dtype=np.float64)
        self.num_lat, self.num_lon = self.elev.shape
        self.min_lon = float(min_lon)
        self.max_lon = float(max_lon)
        self.min_lat = float(min_lat)
        self.max_lat = float(max_lat)
        self.lon_step = (self.max_lon - self.min_lon) / (self.num_lon - 1)
        self.lat_step = (self.max_lat - self.min_lat) / (self.num_lat - 1)
        self.kriging_cfg = kriging
        self.chunk = chunk

    # ------------------------------------------------------------------
    def _chunked(self, fn, lons, lats):
        lons = np.asarray(lons, dtype=np.float64).ravel()
        lats = np.asarray(lats, dtype=np.float64).ravel()
        if lons.size <= self.chunk:
            return fn(lons, lats)
        out = np.empty(lons.shape, dtype=np.float64)
        for s in range(0, lons.size, self.chunk):
            e = min(s + self.chunk, lons.size)
            out[s:e] = fn(lons[s:e], lats[s:e])
        return out

    def _normalize(self, lons, lats):
        oob = (
            (lons < self.min_lon)
            | (lons > self.max_lon)
            | (lats < self.min_lat)
            | (lats > self.max_lat)
        )
        x = (lons - self.min_lon) / self.lon_step
        y = (lats - self.min_lat) / self.lat_step
        return x, y, oob

    # ------------------------------------------------------------------
    def bilinear(self, lons, lats) -> np.ndarray:
        return self._chunked(self._bilinear, lons, lats)

    def _bilinear(self, lons, lats):
        x, y, oob = self._normalize(lons, lats)
        x = np.where(oob, 0.0, x)
        y = np.where(oob, 0.0, y)
        x0 = np.floor(x).astype(np.int64)
        y0 = np.floor(y).astype(np.int64)
        x1 = np.minimum(x0 + 1, self.num_lon - 1)
        y1 = np.minimum(y0 + 1, self.num_lat - 1)
        wx = x - x0
        wy = y - y0
        z00 = self.elev[y0, x0]
        z01 = self.elev[y0, x1]
        z10 = self.elev[y1, x0]
        z11 = self.elev[y1, x1]
        corners = np.stack([z00, z01, z10, z11])
        finite = np.isfinite(corners)
        any_nan = ~finite.all(axis=0)
        cnt = finite.sum(axis=0)
        fb = np.where(
            cnt > 0,
            np.where(finite, corners, 0.0).sum(axis=0) / np.maximum(cnt, 1),
            np.nan,
        )
        z0 = (1 - wx) * z00 + wx * z01
        z1 = (1 - wx) * z10 + wx * z11
        z = (1 - wy) * z0 + wy * z1
        out = np.where(any_nan, fb, z)
        return np.where(oob, np.nan, out)

    # ------------------------------------------------------------------
    def cubic(self, lons, lats) -> np.ndarray:
        return self._chunked(self._cubic, lons, lats)

    def _cubic(self, lons, lats):
        x, y, oob = self._normalize(lons, lats)
        x = np.where(oob, 0.0, x)
        y = np.where(oob, 0.0, y)
        xi = np.floor(x).astype(np.int64)
        yi = np.floor(y).astype(np.int64)
        tx = x - xi
        ty = y - yi

        # 4x4 clamped neighborhood: (N, 4, 4)
        jj = np.clip(yi[:, None] + np.arange(-1, 3)[None, :], 0, self.num_lat - 1)
        ii = np.clip(xi[:, None] + np.arange(-1, 3)[None, :], 0, self.num_lon - 1)
        patch = self.elev[jj[:, :, None], ii[:, None, :]]
        any_nan = ~np.isfinite(patch).all(axis=(1, 2))

        col = _catmull_rom(
            patch[:, :, 0], patch[:, :, 1], patch[:, :, 2], patch[:, :, 3], tx[:, None]
        )
        smooth = _catmull_rom(col[:, 0], col[:, 1], col[:, 2], col[:, 3], ty)

        out = smooth.copy()
        need = any_nan & ~oob
        if np.any(need):
            sel_val, _, _, found = self._ring_select(x[need], y[need], xi[need], yi[need])
            out[need] = self._fallback_mean(sel_val, found)
        return np.where(oob, np.nan, out)

    # ------------------------------------------------------------------
    def kriging(self, lons, lats) -> np.ndarray:
        return self._chunked(self._kriging, lons, lats)

    def _kriging(self, lons, lats):
        x, y, oob = self._normalize(lons, lats)
        xs = np.where(oob, 0.0, x)
        ys = np.where(oob, 0.0, y)
        # center = round half away from zero, clamped (GridH.cpp:333-336)
        ci = np.clip(np.floor(xs + 0.5).astype(np.int64), 0, self.num_lon - 1)
        cj = np.clip(np.floor(ys + 0.5).astype(np.int64), 0, self.num_lat - 1)

        sel_val, sel_i, sel_j, found = self._ring_select(xs, ys, ci, cj)
        out = np.full(xs.shape, np.nan)

        few = found < 4
        if np.any(few):
            out[few] = self._fallback_mean(sel_val[few], found[few])

        ok = ~few & ~oob
        if np.any(ok):
            out[ok] = self._krige_solve(
                lons[ok], lats[ok], sel_val[ok, :4], sel_i[ok, :4], sel_j[ok, :4]
            )
        return np.where(oob, np.nan, out)

    def _krige_solve(self, qlon, qlat, vals, ii, jj):
        """Build and solve the 5x6 ordinary-kriging system exactly as
        GridH.cpp:361-419 (neighbors at cell centers, query at raw coords,
        unpivoted Gauss-Jordan, singular -> 4-neighbor mean)."""
        vg = self.kriging_cfg.variogram

        def variogram(h):
            return vg.nugget + vg.sill * (1.0 - np.exp(-h / vg.range))

        n = vals.shape[0]
        half = getattr(self, "_half", 0.5)
        cx = self.min_lon + (ii + half) * self.lon_step  # (n,4)
        cy = self.min_lat + (jj + half) * self.lat_step

        M = np.zeros((n, 5, 6), dtype=np.float64)
        dx = cx[:, :, None] - cx[:, None, :]
        dy = cy[:, :, None] - cy[:, None, :]
        M[:, :4, :4] = variogram(np.sqrt(dx * dx + dy * dy))
        M[:, :4, 4] = 1.0
        M[:, 4, :4] = 1.0
        M[:, 4, 4] = 0.0
        ddx = cx - qlon[:, None]
        ddy = cy - qlat[:, None]
        M[:, :4, 5] = variogram(np.sqrt(ddx * ddx + ddy * ddy))
        M[:, 4, 5] = 1.0

        singular = np.zeros(n, dtype=bool)
        tol = self.kriging_cfg.pivot_tol
        for i in range(5):
            pivot = M[:, i, i].copy()
            singular |= np.abs(pivot) < tol
            safe = np.where(singular, 1.0, pivot)
            M[:, i, i:] /= safe[:, None]
            for k in range(5):
                if k == i:
                    continue
                factor = M[:, k, i].copy()
                M[:, k, i:] -= factor[:, None] * M[:, i, i:]

        pred = np.einsum("ni,ni->n", M[:, :4, 5], vals)
        fb = vals.mean(axis=1)
        return np.where(singular, fb, pred)

    # ------------------------------------------------------------------
    @staticmethod
    def _fallback_mean(sel_val, found):
        """Mean over min(found, 4) nearest candidates; NaN when none.

        When found >= 4 the reference averages the 4 selected (fallbackAverage,
        GridH.cpp:10-18); when 0 < found < 4 it averages all found
        (GridH.cpp:291-298); when found == 0 it returns NaN.
        """
        k = np.minimum(found, 4)
        take = np.arange(4)[None, :] < k[:, None]
        s = np.where(take & np.isfinite(sel_val), sel_val, 0.0).sum(axis=1)
        return np.where(k > 0, s / np.maximum(k, 1), np.nan)

    def _ring_select(self, x, y, ci, cj):
        """Exact ring search + 4-pass selection sort with swaps.

        Args are per-query float grid coords (x, y) and integer centers.
        Returns (sel_val (N,4), sel_i (N,4), sel_j (N,4), found (N,)).
        When found < 4, sel_val[:, :found] holds *all* candidates' mean inputs:
        callers must use :meth:`_fallback_mean` with ``found``.
        """
        cfg = self.kriging_cfg.fallback
        offs, seg_id = ring_offsets(cfg.max_radius)
        n = x.shape[0]
        gi = ci[:, None] + offs[None, :, 0]  # (N, M) column index
        gj = cj[:, None] + offs[None, :, 1]  # (N, M) row index
        inb = (gi >= 0) & (gi < self.num_lon) & (gj >= 0) & (gj < self.num_lat)
        gic = np.clip(gi, 0, self.num_lon - 1)
        gjc = np.clip(gj, 0, self.num_lat - 1)
        val = self.elev[gjc, gic]
        cand = inb & np.isfinite(val)

        # cumulative candidate count at the end of each segment (seg_id is
        # non-decreasing by construction, so reduceat over segment starts works)
        nseg = int(seg_id[-1]) + 1
        seg_starts = np.searchsorted(seg_id, np.arange(nseg))
        seg_counts = np.add.reduceat(cand.astype(np.int64), seg_starts, axis=1)
        cum = np.cumsum(seg_counts, axis=1)
        # cutoff segment: first segment with cum >= 4 (else all segments)
        reached = cum >= 4
        first = np.where(reached.any(axis=1), reached.argmax(axis=1), nseg - 1)
        eligible = cand & (seg_id[None, :] <= first[:, None])
        found = eligible.sum(axis=1)

        di = (gi + 0.5) - x[:, None]
        dj = (gj + 0.5) - y[:, None]
        dist = np.sqrt(di * di + dj * dj)
        dist = np.where(eligible, dist, np.inf)
        val_e = np.where(eligible, val, np.nan)

        # 4-pass selection sort with swaps over the *compacted* candidate
        # list: a stable sort that puts eligible entries first, in
        # collection order, realizes the compaction
        order = np.argsort(~eligible, axis=1, kind="stable")
        rowsel = np.arange(n)[:, None]
        dist_c = dist[rowsel, order]
        val_c = val_e[rowsel, order]
        gi_c = gi[rowsel, order]
        gj_c = gj[rowsel, order]

        rows = np.arange(n)
        for m in range(4):
            k = np.argmin(dist_c[:, m:], axis=1) + m  # first-min tie-break
            for arr in (dist_c, val_c, gi_c, gj_c):
                tmp = arr[rows, m].copy()
                arr[rows, m] = arr[rows, k]
                arr[rows, k] = tmp
        return val_c[:, :4], gi_c[:, :4], gj_c[:, :4], found
