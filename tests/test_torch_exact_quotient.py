"""B17's shared-reciprocal quotient (``quotient64`` and ``divisor_of`` of
``auvtpu_torch/csrc/exact_epilogue.cu``), modelled exactly on the host and
held to IEEE float64 division.

The kernel divides each dividend ``a`` of a divisor ``d`` (the variogram's
range, a pivot) by way of r = RN(1/d), one IEEE division a divisor:
q0 = RN(a r), e = RN(a - d q0) (an FMA), q = RN(q0 + e r) (an FMA).  Here
every step is an exact rational (``fractions.Fraction``) rounded once by
``float()`` (round to nearest, ties to even), so the test checks the recipe
itself, not a machine's FMA.

The guard the kernel uses, and this model: the fast path where the
divisor's biased exponent lies in 923..1123 (|d| in [2^-100, 2^101)) and
the dividend's in 123..1923 (|a| in [2^-900, 2^901)); a = ±0 with such a
divisor takes q0 (a r, the sign included); every other pair (subnormal,
huge, ±inf, NaN, a divisor outside its range) the IEEE division (the
kernel then solves the query again with IEEE divisions throughout).
Wherever the guard admits the fast path, it must equal IEEE division bit
for bit:
on the variogram's own operands (lags h in [0, 30] cells of several steps
over range 10), on every dividend and pivot of the solves of the 64x80 test
grids' strict selections, on random operands across the guard's range, on
quotients next to powers of two and next to rounding midpoints, at the
guard's limits and with significands of all ones: more than 10^5 pairs in
all.
"""

import math
import pathlib
import re
import struct
from fractions import Fraction

import numpy as np
import pytest
import torch

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "auvtpu_torch" / "csrc" / "exact_epilogue.cu"
# the guard: biased exponent ranges (lo, hi) of the divisor and the dividend
DIVISOR_EXPONENTS = (923, 1123)
DIVIDEND_EXPONENTS = (123, 1923)


def exponent(x: float) -> int:
    return (struct.unpack("<Q", struct.pack("<d", x))[0] >> 52) & 0x7FF


def is_zero(x: float) -> bool:
    return (struct.unpack("<Q", struct.pack("<d", x))[0] << 1) & (2**64 - 1) == 0


def bits(x: float) -> int:
    return struct.unpack("<Q", struct.pack("<d", x))[0]


def rn(x: Fraction) -> float:
    """x rounded once to float64 (Python's int / int is correctly rounded)."""
    return float(x)


def ieee(a: float, d: float) -> float:
    with np.errstate(all="ignore"):
        return float(np.float64(a) / np.float64(d))


def divisor_of(d: float):
    """(d, RN(1/d) by IEEE division, whether the fast path may divide by d)."""
    return d, ieee(1.0, d), DIVISOR_EXPONENTS[0] <= exponent(d) <= DIVISOR_EXPONENTS[1]


def quotient64(a: float, div) -> tuple[float, str]:
    """(the kernel's quotient, the path it took: 'fast', 'zero' or 'ieee')."""
    d, r, ok = div
    if ok and DIVIDEND_EXPONENTS[0] <= exponent(a) <= DIVIDEND_EXPONENTS[1]:
        q0 = rn(Fraction(a) * Fraction(r))
        e = rn(Fraction(-d) * Fraction(q0) + Fraction(a))
        return rn(Fraction(e) * Fraction(r) + Fraction(q0)), "fast"
    if ok and is_zero(a):
        with np.errstate(all="ignore"):
            return float(np.float64(a) * np.float64(r)), "zero"
    return ieee(a, d), "ieee"


def test_source_holds_the_modelled_recipe():
    src = SOURCE.read_text()
    body = src[src.index("__device__ __forceinline__ double quotient64(double a, const Divisor& d, bool& exact) {"):]
    body = body[:body.index("\n}\n")]
    assert "if constexpr (!FAST) {\n    return a / d.d;\n  } else {" in body
    steps = re.findall(r"^\s*const double (\w+) = (.*);$", body, re.M)
    assert steps == [("q0", "a * d.r"), ("e", "fma(-d.d, q0, a)"), ("q", "fma(e, d.r, q0)")]
    lo, hi = DIVIDEND_EXPONENTS
    assert "const bool zero = ((unsigned long long)__double_as_longlong(a) << 1) == 0;" in body
    assert f"exact = exact && d.ok && (exponent_of(a) - {lo}u <= {hi - lo}u || zero);" in body
    assert "return zero ? q0 : q;" in body
    lo, hi = DIVISOR_EXPONENTS
    assert f"return {{d, 1.0 / d, exponent_of(d) - {lo}u <= {hi - lo}u}};" in src
    assert "return ((unsigned)__double2hiint(x) >> 20) & 0x7ffu;" in src
    # every division of the solve goes through it, the range's and the
    # pivots'; a solve with any quotient outside the guard is done again
    # with IEEE divisions
    assert "exp(quotient64<FAST>(-h, range, exact))" in src and "quotient64<FAST>(M[i][q], piv, exact)" in src
    assert "divisor_of(singular ? 1.0 : pivot)" in src and "divisor_of(s.range)" in src
    assert ("res = krige_one<true>(p, m, v, exact);\n    if (!exact) res = krige_one<false>(p, m, v, exact);"
            in src)


# ---------------------------------------------------------------------------
# the operand pairs
# ---------------------------------------------------------------------------

def _floats(rng, n, lo_exp, hi_exp, ones=False):
    """n floats with exponents in [lo_exp, hi_exp], random signs and
    significands (all ones where ``ones``)."""
    mant = np.full(n, 2.0 - 2.0**-52) if ones else 1.0 + rng.integers(0, 2**52, n).astype(np.float64) * 2.0**-52
    # the integer draw above rounds in float64 only below 2**53: exact
    return (rng.choice([-1.0, 1.0], n) * np.ldexp(mant, rng.integers(lo_exp, hi_exp + 1, n))).tolist()


def _variogram_pairs(rng, n):
    """(-h, range) of the variogram's own lags: h in [0, 30] cells of the
    steps of the test extents and of a 15 arc-second grid, range 10, and
    the diagonal's h = 0."""
    steps = np.array([10.17 / 79, 8.5526 / 63, 1.0, 1 / 240, 0.129])
    h = rng.uniform(0.0, 30.0, n) * steps[rng.integers(0, len(steps), n)]
    h[::97] = 0.0
    return [(-x, 10.0) for x in h.tolist()]


def _solve_pairs(name):
    """Every (dividend, divisor) of B17's solves on one of the 64x80 test
    grids: the strict selection of its masked cells, the 14 variogram lags
    over the range and the 15 live dividends of the five pivot rows, as the
    kernel forms them (numpy float64, each operation rounded once)."""
    from auvtpu_torch.config import Extent
    from auvtpu_torch.grid import RegularGrid
    from auvtpu_torch.kernels import exact_epilogue as ee
    from auvtpu_torch.kernels.exact_prologue import GEO, KEYS
    from auvtpu_torch.masking import mask_grid
    from auvtpu_torch.ops import exact as texact
    from auvtpu_torch.synthetic import shelf_seamount

    removal, seed = {"64x80_r0.3": (0.3, 2), "64x80_r0.9": (0.9, 3), "64x80_r0.05": (0.05, 6)}[name]
    reduced, rc, _ = mask_grid(shelf_seamount(64, 80), removal, seed=seed)
    g = RegularGrid.from_nan_array(reduced, Extent(74.615, 84.785, -58.2508, -49.6982), dtype=torch.float64,
                                   device="cpu")
    q = texact.query_tensors(g, rc[:, 0].astype(np.int64), rc[:, 1].astype(np.int64), anchor="round",
                             fields=KEYS | GEO)
    found, _, gi, gj = (t.numpy() for t in texact._select_cells(g, q, None, 10, 1000))
    keep = found >= 4
    min_lon, min_lat, lon_step, lat_step, nugget, sill, rng_, tol = ee.scalars_of(g)
    cx = min_lon + (gi[keep].astype(np.float64) + 0.5) * lon_step
    cy = min_lat + (gj[keep].astype(np.float64) + 0.5) * lat_step
    qx, qy = q.qlon.numpy()[keep], q.qlat.numpy()[keep]
    n = len(cx)
    pairs = []
    M = np.zeros((n, 5, 6))

    def lag(ax, ay, bx, by):
        h = np.sqrt((ax - bx) * (ax - bx) + (ay - by) * (ay - by))
        pairs.extend((-x, rng_) for x in h.tolist())
        return nugget + sill * (1.0 - np.exp(-h / rng_))

    for a in range(4):
        for b in range(a, 4):
            M[:, a, b] = M[:, b, a] = lag(cx[:, a], cy[:, a], cx[:, b], cy[:, b])
        M[:, a, 4] = 1.0
        M[:, a, 5] = lag(cx[:, a], cy[:, a], qx, qy)
    M[:, 4, :4], M[:, 4, 4], M[:, 4, 5] = 1.0, 0.0, 1.0
    singular = np.zeros(n, bool)
    for i in range(5):
        singular |= np.abs(M[:, i, i]) < tol
        safe = np.where(singular, 1.0, M[:, i, i])
        for col in range(i + 1, 6):
            pairs.extend(zip(M[:, i, col].tolist(), safe.tolist()))
            M[:, i, col] = M[:, i, col] / safe
        for r in range(5):
            if r != i:
                M[:, r, i + 1:] = M[:, r, i + 1:] - M[:, r, i:i + 1] * M[:, i, i + 1:]
    assert n >= 40 and len(pairs) == 29 * n
    return pairs


def _hard_pairs(rng, n):
    """Quotients next to a rounding midpoint: a / d within 2^-54 ulp or so
    of (2k + 1) 2^-53 (or 2^-54 below 1), d odd, scaled across the
    exponents."""
    out = []
    t = 0
    while len(out) < n:
        t += 1
        B = int(rng.integers(2**52, 2**53)) | 1
        if t % 3 == 0:
            B = 2**53 - 1 - 2 * int(rng.integers(0, 2**20))  # significands of (nearly) all ones
        shift = 53 if t % 2 else 54
        m = pow(2**shift, -1, B)
        N = int(rng.choice([1, -1, 2, -3]))
        A = (N * m) % B
        # Q in [1, 2): A in [B, 2^53); Q in [1/2, 1): A in [2^52, B)
        A += B if shift == 53 else 0
        if (B <= A < 2**53) if shift == 53 else (2**52 <= A < B):
            s = int(rng.integers(-40, 41))
            out.append((math.ldexp(A, -52 + s), math.ldexp(B, -52 + int(rng.integers(-20, 21)))))
    return out


def _near_powers_of_two(rng, n):
    """a within a few ulps of d 2^k: quotients next to a power of two, from
    either side."""
    out = []
    while len(out) < n:
        d = float(rng.choice([2.0 - 2.0**-52, 1.0 + 2.0**-52, float(rng.uniform(1.0, 2.0))]))
        d = math.ldexp(d, int(rng.integers(-90, 91)))
        a = math.ldexp(d, int(rng.integers(-3, 4)))
        for _ in range(int(rng.integers(0, 6))):
            a = math.nextafter(a, math.inf if rng.integers(2) else -math.inf)
        out.append((a * float(rng.choice([1.0, -1.0])), d))
    return out


def _guard_limits():
    """The guard's four limits, each at, just inside and just outside it,
    against divisors and dividends at their own limits, significands of
    1 and of all ones."""
    def around(e):
        x = math.ldexp(1.0, e)
        return [x, math.nextafter(x, 0.0), math.nextafter(x, math.inf), math.ldexp(2.0 - 2.0**-52, e)]

    a_lims = around(-900) + around(900) + around(901) + around(-901) + [1.0, 3.0, -7.5]
    d_lims = around(-100) + around(100) + around(101) + around(-101) + [1.0, -3.0, 10.0]
    return [(s * a, t * d) for a in a_lims for d in d_lims for s in (1.0, -1.0) for t in (1.0, -1.0)]


CASES = {
    "wide": lambda rng: list(zip(_floats(rng, 20000, -900, 900), _floats(rng, 20000, -100, 100))),
    "all ones": lambda rng: list(zip(_floats(rng, 5000, -900, 900, ones=True), _floats(rng, 5000, -100, 100,
                                                                                        ones=True)))
    + list(zip(_floats(rng, 5000, -60, 60), _floats(rng, 5000, -30, 30, ones=True))),
    "variogram": lambda rng: _variogram_pairs(rng, 20000),
    "pivots 64x80_r0.3": lambda rng: _solve_pairs("64x80_r0.3"),
    "pivots 64x80_r0.9": lambda rng: _solve_pairs("64x80_r0.9"),
    "pivots 64x80_r0.05": lambda rng: _solve_pairs("64x80_r0.05"),
    "near rounding midpoints": lambda rng: _hard_pairs(rng, 15000),
    "near powers of two": lambda rng: _near_powers_of_two(rng, 10000),
    "guard limits": lambda rng: _guard_limits(),
}
SEEDS = {name: 100 + i for i, name in enumerate(CASES)}
# each case's least number of pairs: more than 10^5 together
MIN_PAIRS = {"wide": 20000, "all ones": 10000, "variogram": 20000, "pivots 64x80_r0.3": 20000,
             "pivots 64x80_r0.9": 3000, "pivots 64x80_r0.05": 5000, "near rounding midpoints": 15000,
             "near powers of two": 10000, "guard limits": 1000}
assert sum(MIN_PAIRS.values()) > 100_000


@pytest.mark.parametrize("name", list(CASES))
def test_quotient_equals_ieee_division(name):
    pairs = CASES[name](np.random.default_rng(SEEDS[name]))
    paths = {"fast": 0, "zero": 0, "ieee": 0}
    divisors = {}
    for a, d in pairs:
        div = divisors.get(d)
        if div is None:
            div = divisors[d] = divisor_of(d)
        q, path = quotient64(a, div)
        paths[path] += 1
        want = ieee(a, d)
        assert bits(q) == bits(want), (a.hex(), d.hex(), q.hex(), want.hex(), path)
    if name == "guard limits":
        assert paths["fast"] and paths["ieee"] and not paths["zero"], paths
    else:
        # every pair takes the fast path but the zero lags (the diagonal's
        # and any h = 0: -0 / range), which take q0
        assert paths["ieee"] == 0 and paths["fast"] >= 0.8 * len(pairs), paths
    assert len(pairs) >= MIN_PAIRS[name], (name, len(pairs))


@pytest.mark.parametrize("a,d,path", [
    (0.0, 10.0, "zero"), (-0.0, 10.0, "zero"), (-0.0, -3.0, "zero"), (0.0, 2.0**-101, "ieee"),
    (5e-324, 10.0, "ieee"), (-2.2250738585072014e-308, 10.0, "ieee"), (2.0**-901, 1.0, "ieee"),
    (2.0**901, 1.0, "ieee"), (1.7976931348623157e308, 0.5, "ieee"),
    (math.inf, 10.0, "ieee"), (-math.inf, 10.0, "ieee"), (math.nan, 10.0, "ieee"),
    (1.0, 0.0, "ieee"), (-1.0, -0.0, "ieee"), (0.0, 0.0, "ieee"), (1.0, math.inf, "ieee"), (1.0, math.nan, "ieee"),
    (1.0, 5e-324, "ieee"), (1.0, 2.0**101, "ieee"), (1.0, 2.0**-100, "fast"), (1.0, 2.0**101 - 2.0**49, "fast"),
    (2.0**-900, 2.0**100, "fast"), (2.0**901 - 2.0**849, 2.0**-100, "fast"),
])
def test_the_guard_sends_edge_operands_to_ieee_division(a, d, path):
    q, took = quotient64(a, divisor_of(d))
    assert took == path
    want = ieee(a, d)
    assert bits(q) == bits(want) or (math.isnan(q) and math.isnan(want)), (q, want)


def test_the_correction_outside_the_guard_would_differ():
    # why the guard: an infinite dividend gives NaN through the correction
    # (inf - inf) where IEEE division gives inf
    d, r, _ = divisor_of(10.0)
    with np.errstate(all="ignore"):
        q0 = np.float64(math.inf) * np.float64(r)
        e = np.float64(-d) * q0 + np.float64(math.inf)
    assert math.isnan(float(e)) and ieee(math.inf, d) == math.inf
