"""The reciprocal quotient of ``auvtpu_torch/csrc/exact_div.cuh`` (B8
divides by it), emulated exactly on the host.

``quotient(a, d, r)`` with r = RN(1/d) forms q = RN(a r) and corrects it
twice, e = RN(a - q d) and q = RN(q + e r), each an FMA rounded once to
float32.  Here every step is an exact rational (``fractions.Fraction``)
rounded once to float32 (round to nearest, ties to even, with subnormals and
overflow), so the test checks the recipe itself, not a machine's FMA.
Inside its range (|a| in [2^-90, 2^90], |d| in [2^-30, 2^30]) it must equal
IEEE float32 division bit for bit; outside it, ``exact`` must come back
false, which sends the kernel to the IEEE division.
"""

import math
import pathlib
import re
from fractions import Fraction

import numpy as np
import pytest

HEADER = pathlib.Path(__file__).resolve().parent.parent / "auvtpu_torch" / "csrc" / "exact_div.cuh"
F32 = np.float32


def rn32(x: Fraction) -> F32:
    """x rounded once to float32: to nearest, ties to even, gradual
    underflow, overflow to inf."""
    if x == 0:
        return F32(0.0)
    sign = -1 if x < 0 else 1
    ax = abs(x)
    e = ax.numerator.bit_length() - ax.denominator.bit_length()
    if Fraction(2) ** e > ax:
        e -= 1
    quantum = Fraction(2) ** (max(e, -126) - 23)  # ulp of the binade; 2^-149 below 2^-126
    q, rem = divmod(ax, quantum)
    half = Fraction(1, 2)
    frac = rem / quantum
    n = int(q) + (1 if frac > half or (frac == half and int(q) % 2) else 0)
    val = n * quantum
    if val >= Fraction(2) ** 128:
        return F32(sign * math.inf)
    return F32(sign * float(val))


def fma(a, b, c) -> F32:
    if not all(np.isfinite(float(v)) for v in (a, b, c)):
        with np.errstate(all="ignore"):
            return F32(float(a) * float(b) + float(c))  # inf and NaN as IEEE arithmetic gives them
    return rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def divisor_ok(d) -> bool:
    m = abs(float(d))
    return 2.0**-30 <= m <= 2.0**30


def quotient(a, d):
    """(q, exact) as exact_div.cuh computes them, r = RN(1/d) by an IEEE
    float32 division."""
    a, d = F32(a), F32(d)
    with np.errstate(all="ignore"):
        r = F32(1.0) / d
    q = fma(a, r, F32(0.0))  # RN(a r)
    e = fma(-q, d, a)
    q = fma(e, r, q)
    e = fma(-q, d, a)
    q = fma(e, r, q)
    m = abs(float(a))
    exact = divisor_ok(d) and 2.0**-90 <= m <= 2.0**90
    return q, exact


def bits(x) -> int:
    return int(np.asarray(x, F32).view(np.uint32))


def test_header_holds_the_emulated_recipe():
    # the five steps above, in this order, are the header's quotient()
    body = HEADER.read_text()
    body = body[body.index("quotient(float a, float d, float r, bool& exact)"):]
    steps = re.findall(r"^\s*(?:float )?([qe]) = (.*);$", body[:body.index("return q;")], re.M)
    assert steps == [("q", "a * r"), ("e", "fmaf(-q, d, a)"), ("q", "fmaf(e, r, q)"),
                     ("e", "fmaf(-q, d, a)"), ("q", "fmaf(e, r, q)")]
    assert "m >= 0x1p-90f && m <= 0x1p90f" in body and "m >= 0x1p-30f && m <= 0x1p30f" in body


def _random_pairs(rng, n, a_exp, d_exp):
    def draw(lo, hi):
        mant = rng.integers(1 << 23, 1 << 24, n).astype(np.float64) / (1 << 23)  # [1, 2)
        exp = rng.integers(lo, hi + 1, n)
        sign = rng.choice([-1.0, 1.0], n)
        return (sign * np.ldexp(mant, exp)).astype(F32)

    return draw(*a_exp), draw(*d_exp)


def _edge_pairs():
    ups = lambda x: [x, np.nextafter(F32(x), F32(np.inf)), np.nextafter(F32(x), F32(0.0))]  # noqa: E731
    a_edges = [v for e in (-90, 90) for v in ups(F32(2.0**e))]
    a_edges += [F32(2.0**90) * F32(0.99999994), F32(1.0), F32(3.0), F32(-(2.0**-90))]
    # every tenth binade between, at mantissa 1 and at mantissa all ones
    a_edges += [F32(s * 2.0**e * m) for e in range(-80, 90, 10) for m in (1.0, 2.0 - 2.0**-23) for s in (1, -1)]
    d_edges = [v for e in (-30, 30) for v in ups(F32(2.0**e))]
    d_edges += [F32(1.0), F32(-3.0), F32(0.1), F32(1e-12) * F32(1e3)]
    pairs = [(a, d) for a in a_edges for d in d_edges]
    # the largest and smallest quotients: 2^90 / 2^-30 and 2^-90 / 2^30, mantissas all ones
    big, small = F32(np.nextafter(F32(2.0**90), F32(0))), F32(np.nextafter(F32(2.0**-29), F32(0)))
    pairs += [(big, F32(2.0**-30)), (F32(2.0**-90), F32(2.0**30)), (F32(2.0**-90), small)]
    return [(a, d) for a, d in pairs if divisor_ok(d) and 2.0**-90 <= abs(float(a)) <= 2.0**90]


@pytest.mark.parametrize("case", ["wide", "near one", "kriging", "edges"])
def test_quotient_equals_ieee_division_inside_its_range(case):
    rng = np.random.default_rng({"wide": 1, "near one": 2, "kriging": 3, "edges": 4}[case])
    if case == "wide":
        a, d = _random_pairs(rng, 6000, (-90, 89), (-30, 29))
        pairs = list(zip(a, d))
    elif case == "near one":
        a, d = _random_pairs(rng, 3000, (-3, 3), (-3, 3))
        pairs = list(zip(a, d))
    elif case == "kriging":
        # the magnitudes of a kriging solve's entries and pivots: gammas of a
        # sill ~1e6 with a nugget ~0.1 (the fit-then-fill case), lags / range
        # ~1e-4..1e2
        a, d = _random_pairs(rng, 1500, (-14, 21), (-4, 21))
        pairs = list(zip(a, d))
    else:
        pairs = _edge_pairs()
        assert len(pairs) >= 100
    n = 0
    for a, d in pairs:
        q, exact = quotient(a, d)
        assert exact, (a, d)
        want = F32(a) / F32(d)
        assert bits(q) == bits(want), (float(a), float(d), float(q), float(want))
        n += 1
    if case != "edges":
        assert n >= 1500
    # the four cases together hold the recipe on more than 10^4 pairs


@pytest.mark.parametrize("a,d", [
    (0.0, 3.0), (-0.0, 3.0), (math.inf, 3.0), (math.nan, 3.0), (2.0**91, 3.0), (2.0**-91, 3.0),
    (1e-40, 3.0),  # subnormal
    (1.0, 2.0**31), (1.0, 2.0**-31), (1.0, 1e-12), (1.0, math.inf), (1.0, 0.0),
])
def test_quotient_reports_not_exact_outside_its_range(a, d):
    _, exact = quotient(a, d)
    assert not exact


@pytest.mark.parametrize("a,d", [(2.0**100, 2.0**-30), (2.0**127, 0.25)])
def test_the_range_is_needed(a, d):
    # just outside the range the recipe goes wrong: where a/d overflows,
    # q = RN(a r) is inf and the corrections turn it into NaN
    q, exact = quotient(a, d)
    with np.errstate(over="ignore"):
        want = F32(a) / F32(d)
    assert not exact and np.isinf(want) and np.isnan(q)
