"""The plain references against hand-computed answers, on the CPU: the 5x6
ordinary-kriging solve against numpy's solver, the masked-cell fill and the
scattered kriging and IDW against loops written out here (computed in
float64 and returned in float32, so the comparisons hold to float32's
rounding of the answer), and the fit against the exponential it is fed."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference import fitfill, kriging
from benchmark.yardstick.tables import sorted_window, valid16_dydx, window_dydx

VARIO = (1.0, 100.0, 10.0)
F64 = torch.float64


def _gamma(h):
    n, s, r = VARIO
    return n + s * (1.0 - np.exp(-h / r))


def _krige_np(q, pts, vals):
    """Ordinary kriging by numpy's solver: [Γ 1; 1 0] [w; μ] = [γ0; 1]."""
    A = np.ones((5, 5))
    A[4, 4] = 0.0
    for a in range(4):
        for b in range(4):
            A[a, b] = _gamma(np.hypot(*(pts[a] - pts[b])))
    rhs = np.ones(5)
    rhs[:4] = [_gamma(np.hypot(*(pts[a] - q))) for a in range(4)]
    w = np.linalg.solve(A, rhs)
    return float(w[:4] @ vals)


def test_solve_against_numpy():
    rng = np.random.RandomState(0)
    pts = rng.uniform(0.0, 3.0, (4, 2))
    q = rng.uniform(0.5, 2.5, 2)
    vals = rng.uniform(-100.0, 100.0, 4)
    t = lambda v: torch.tensor([v], dtype=F64)
    pred, singular = kriging.solve(t(q[0]), t(q[1]), [t(v) for v in vals], [t(p[0]) for p in pts],
                                   [t(p[1]) for p in pts], VARIO, 1e-12)
    assert not bool(singular[0])
    assert float(pred[0]) == pytest.approx(_krige_np(q, pts, vals), rel=1e-10)


def test_solve_flags_a_repeated_neighbour():
    t = lambda v: torch.tensor([v], dtype=F64)
    _, singular = kriging.solve(t(0.5), t(0.5), [t(1.0)] * 4, [t(0.0)] * 4, [t(0.0)] * 4, VARIO, 1e-12)
    assert bool(singular[0])


CFG = {"extent": [0.0, 7.0, 0.0, 5.0], "variogram": dict(zip(("nugget", "sill", "range"), VARIO)),
       "max_radius": 3, "pivot_tol": 1e-12, "idw": {"k": 8, "power": 2.0, "window_radius": 2, "eps": 1e-12}}


def _tile():
    rng = np.random.RandomState(3)
    elev = rng.uniform(-50.0, -10.0, (6, 8))
    valid = np.ones((6, 8))
    valid[[0, 2, 2, 3, 5, 1], [0, 3, 4, 3, 7, 6]] = 0.0
    valid[:, 1] = 0.0  # a whole column masked: cells reach past their ring 1
    return elev * valid, valid


def test_masked_cells_against_a_loop():
    elev, valid = _tile()
    H, W = elev.shape
    rows, cols = np.nonzero(valid == 0)
    dxs, dys = sorted_window(3)
    got = kriging.krige_cells({"elev": torch.tensor(elev), "valid": torch.tensor(valid),
                               "rows": torch.tensor(rows), "cols": torch.tensor(cols)}, CFG, F64).double()
    for n, (r, c) in enumerate(zip(rows, cols)):
        found = [(dx, dy) for dx, dy in zip(dxs, dys)
                 if 0 <= r + dy < H and 0 <= c + dx < W and valid[r + dy, c + dx] > 0][:4]
        assert len(found) == 4
        pts = np.array([[c + dx + 0.5, r + dy + 0.5] for dx, dy in found])  # unit steps: degrees = cells
        vals = np.array([elev[r + dy, c + dx] for dx, dy in found])
        assert float(got[n]) == pytest.approx(_krige_np(np.array([c, r], float), pts, vals), rel=1e-7)


def test_masked_cell_with_no_neighbour_is_nan():
    elev, valid = np.zeros((3, 3)), np.zeros((3, 3))
    valid[0, 0] = 1.0
    got = kriging.krige_cells({"elev": torch.tensor(elev), "valid": torch.tensor(valid),
                               "rows": torch.tensor([2, 1]), "cols": torch.tensor([2, 1])},
                              dict(CFG, extent=[0.0, 2.0, 0.0, 2.0]), F64)
    assert float(got[0]) == 0.0 and float(got[1]) == 0.0  # one neighbour found: its mean
    valid[0, 0] = 0.0
    got = kriging.krige_cells({"elev": torch.tensor(elev), "valid": torch.tensor(valid),
                               "rows": torch.tensor([2]), "cols": torch.tensor([2])},
                              dict(CFG, extent=[0.0, 2.0, 0.0, 2.0]), F64)
    assert bool(torch.isnan(got[0]))


def _nearest_np(elev, valid, x, y, offs, k):
    H, W = elev.shape
    ci = int(np.clip(np.floor(x + 0.5), 0, W - 1))
    cj = int(np.clip(np.floor(y + 0.5), 0, H - 1))
    cand = []
    for t, (dy, dx) in enumerate(offs):
        r, c = cj + dy, ci + dx
        if 0 <= r < H and 0 <= c < W and valid[r, c] > 0:
            cand.append(((dx + 0.5 - (x - ci)) ** 2 + (dy + 0.5 - (y - cj)) ** 2, t, c, r))
    return sorted(cand)[:k]


def test_scattered_kriging_and_idw_against_loops():
    rng = np.random.RandomState(5)
    elev = rng.uniform(-200.0, -10.0, (6, 8))
    valid = np.ones((6, 8))
    lons = rng.uniform(0.0, 7.0, 40)
    lats = rng.uniform(0.0, 5.0, 40)
    lons[0], lats[0] = 8.0, 1.0  # outside the extent
    inputs = {"elev": torch.tensor(elev), "valid": torch.tensor(valid), "lons": torch.tensor(lons),
              "lats": torch.tensor(lats)}
    kr = kriging.krige_queries(inputs, CFG, F64).double()
    idw = kriging.idw_queries(inputs, CFG, F64).double()
    assert bool(torch.isnan(kr[0])) and bool(torch.isnan(idw[0]))
    for n in range(1, 40):
        near = _nearest_np(elev, valid, lons[n], lats[n], valid16_dydx(), 4)
        pts = np.array([[c + 0.5, r + 0.5] for _, _, c, r in near])
        vals = np.array([elev[r, c] for _, _, c, r in near])
        assert float(kr[n]) == pytest.approx(_krige_np(np.array([lons[n], lats[n]]), pts, vals), rel=1e-7)
        near = _nearest_np(elev, valid, lons[n], lats[n], window_dydx(2), 8)
        w = np.array([1.0 / (d2 + 1e-12) for d2, _, _, _ in near])
        v = np.array([elev[r, c] for _, _, c, r in near])
        assert float(idw[n]) == pytest.approx(float(w @ v / w.sum()), rel=1e-7)


def test_fit_recovers_an_exponential():
    lags = torch.linspace(0.5, 9.5, 10, dtype=F64)
    gamma = 2.0 + 50.0 * (1.0 - torch.exp(-lags / 4.0))
    got = fitfill.fit_exponential(lags, gamma, torch.full_like(lags, 100.0), iters=60, stop=1e-12)
    np.testing.assert_allclose(got.numpy(), [2.0, 50.0, 4.0], rtol=1e-6)


def test_pair_sums_against_a_loop():
    elev, valid = _tile()
    s, c = fitfill.pair_sums(torch.tensor(elev), torch.tensor(valid), 2, 2)
    H, W = elev.shape
    want_s, want_c = np.zeros(2), np.zeros(2)
    for dy in range(3):
        for dx in range(-2, 3):
            h = np.hypot(dx, dy)
            if (dy == 0 and dx <= 0) or h > 2:
                continue
            b = min(int(np.floor(h)), 1)  # np.digitize over the edges 0, 1, 2
            for r in range(H - dy):
                for col in range(max(0, -dx), W - max(0, dx)):
                    both = valid[r, col] * valid[r + dy, col + dx]
                    want_s[b] += both * (elev[r, col] - elev[r + dy, col + dx]) ** 2
                    want_c[b] += both
    np.testing.assert_allclose(s.numpy(), want_s, rtol=1e-12)
    np.testing.assert_array_equal(c.numpy(), want_c)
