// Correctly rounded f32 division from a reciprocal that serves several
// divisions, for Hopper (sm_90a).  Included by band_resample.cu (B8: every
// query of a call divides by the same step).  B1's kriging solve took it
// for its pivots and range (one reciprocal a pivot row) and was 5-11 %
// slower than with IEEE divisions (scripts/kernel_ab.py, PERF.md): the
// range checks and registers cost more than the MUFU work they saved.
//
// Built without fast-math, an IEEE '/' is a reciprocal on the MUFU pipe,
// four FMAs, a range check and a branch to a slow path.  quotient() takes
// r = RN(1 / d), computed once (by an IEEE '/'), and gives RN(a / d) with a
// multiply and four FMAs, no MUFU: q = RN(a r) lies within 2 ulp of a/d, one
// FMA correction makes it faithful, and a second gives RN(a / d)
// (Markstein: a faithful q and r within half an ulp of 1/d; the residual
// a - q d is exact in an FMA).  That holds while nothing over- or
// underflows: `exact` turns false for an a outside [2^-90, 2^90] (0, inf and
// NaN included), and divisor_ok(d) must hold.  Where either fails the
// caller takes the IEEE division.  tests/test_torch_exact_div.py pins the
// recipe against f32 division, each FMA rounded once on the host.

#pragma once

#include <math.h>

__device__ __forceinline__ float quotient(float a, float d, float r, bool& exact) {
  float q = a * r;
  float e = fmaf(-q, d, a);
  q = fmaf(e, r, q);
  e = fmaf(-q, d, a);
  q = fmaf(e, r, q);
  const float m = fabsf(a);
  exact = exact && m >= 0x1p-90f && m <= 0x1p90f;
  return q;
}

// Whether quotient() may divide by d: |d| in [2^-30, 2^30] keeps every
// quotient of an a in [2^-90, 2^90] and its residuals normal.
__device__ __forceinline__ bool divisor_ok(float d) {
  const float m = fabsf(d);
  return m >= 0x1p-30f && m <= 0x1p30f;
}
