// The ordinary-kriging solve of one query or cell in registers, for Hopper
// (sm_90a): the variogram models and the 5x6 system of four neighbours and
// the query point, solved unpivoted with IEEE divisions in the order of
// ops/scattered.py (gj56, lu56).  Included by window_fill.cu (B1,
// kriging_fill_kernel) and scattered_select.cu (B11, select_krige_kernel,
// and B12, window_krige_kernel, which follow B11's plain version), so that
// the solve exists once.
//
// The two kernels' plain versions differ in two places, and the callers
// say which they follow:
//   - the variogram: B1's is the Pallas kernel's (gamma_fn: no clamp on the
//     range, spherical's 0.5 m^3 as ((0.5 m) m) m); B11's is the column-form
//     solve's (gamma_cols: exponential through ops.scattered.variogram, no
//     clamp; the others through variogram.variogram_model, p2 clamped at
//     1e-6 and spherical's m**3 as m m m, as torch's pow by 3 computes it);
//   - the diagonal: B1 writes the nugget, B11 gamma(0) as the plain
//     version computes it (the two differ only at a nugget of -0, a range
//     of 0 or a non-finite sill).

#pragma once

#include <math.h>

enum Model { kExponential = 0, kLinear = 1, kSpherical = 2, kGaussian = 3 };
enum Solver { kGJ = 0, kLU = 1 };

// The Pallas kernel's gamma (window_fill.py:746-759): no clamp on the range.
template <int MODEL>
__device__ __forceinline__ float gamma_fn(float h, float nugget, float sill, float vrange) {
  if (MODEL == kExponential) return nugget + sill * (1.f - expf(-h / vrange));
  if (MODEL == kLinear) return nugget + sill * h;
  if (MODEL == kSpherical) {
    float m = h / vrange;
    m = m > 1.f ? 1.f : m;  // jnp.minimum: a NaN stays NaN
    return nugget + sill * (1.5f * m - 0.5f * m * m * m);
  }
  const float hr = h / vrange;
  return nugget + sill * (1.f - expf(-(hr * hr)));
}

// The column-form solve's gamma (ops/scattered.py krige_solve_cols):
// exponential is gamma_fn's; the others clamp p2 at 1e-6 first (a NaN stays
// NaN, as torch.clamp keeps it).
template <int MODEL>
__device__ __forceinline__ float gamma_cols(float h, float nugget, float p1, float p2) {
  if (MODEL == kExponential) return gamma_fn<MODEL>(h, nugget, p1, p2);
  p2 = p2 < 1e-6f ? 1e-6f : p2;
  if (MODEL == kSpherical) {
    float m = h / p2;
    m = m > 1.f ? 1.f : m;
    return nugget + p1 * (1.5f * m - 0.5f * (m * m * m));
  }
  return gamma_fn<MODEL>(h, nugget, p1, p2);
}

// The 5x6 system of neighbours at (cx, cy) and the query at (qlon, qlat),
// gamma(a, b) off the diagonal and `diag` on it, solved unpivoted: lam[0..3]
// are the weights, lam[4] the Lagrange multiplier; gamma0[a] is gamma(h_a0)
// before elimination (for the variance).  Returns whether a pivot fell
// below pivot_tol (after which every pivot divides by 1).
template <int SOLVER, class Gamma>
__device__ __forceinline__ bool krige_solve(const float (&cx)[4], const float (&cy)[4], float qlon, float qlat,
                                            float diag, const Gamma& gamma, float pivot_tol, float (&lam)[5],
                                            float (&gamma0)[4]) {
  float M[5][6];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b < a) {
        M[a][b] = M[b][a];
      } else if (b == a) {
        M[a][b] = diag;
      } else {
        const float ddx = cx[a] - cx[b];
        const float ddy = cy[a] - cy[b];
        M[a][b] = gamma(sqrtf(ddx * ddx + ddy * ddy));
      }
    }
    M[a][4] = 1.f;
    const float ddx = cx[a] - qlon;
    const float ddy = cy[a] - qlat;
    M[a][5] = gamma(sqrtf(ddx * ddx + ddy * ddy));
  }
  M[4][0] = 1.f;
  M[4][1] = 1.f;
  M[4][2] = 1.f;
  M[4][3] = 1.f;
  M[4][4] = 0.f;
  M[4][5] = 1.f;
#pragma unroll
  for (int a = 0; a < 4; ++a) gamma0[a] = M[a][5];

  bool singular = false;
  if (SOLVER == kGJ) {
    // unpivoted Gauss-Jordan in the order of ops/scattered.py::gj56
#pragma unroll
    for (int p = 0; p < 5; ++p) {
      const float pivot = M[p][p];
      singular = singular || (fabsf(pivot) < pivot_tol);
      const float safe = singular ? 1.f : pivot;
#pragma unroll
      for (int q = p; q < 6; ++q) M[p][q] = M[p][q] / safe;
#pragma unroll
      for (int rr = 0; rr < 5; ++rr) {
        if (rr == p) continue;
        const float f = M[rr][p];
#pragma unroll
        for (int q = p; q < 6; ++q) M[rr][q] = M[rr][q] - f * M[p][q];
      }
    }
#pragma unroll
    for (int a = 0; a < 5; ++a) lam[a] = M[a][5];
  } else {
    // forward elimination + back substitution, same unpivoted pivots
    float rp[5];
#pragma unroll
    for (int p = 0; p < 5; ++p) {
      const float pivot = M[p][p];
      singular = singular || (fabsf(pivot) < pivot_tol);
      rp[p] = 1.f / (singular ? 1.f : pivot);
#pragma unroll
      for (int rr = p + 1; rr < 5; ++rr) {
        const float f = M[rr][p] * rp[p];
#pragma unroll
        for (int q = p + 1; q < 6; ++q) M[rr][q] = M[rr][q] - f * M[p][q];
      }
    }
#pragma unroll
    for (int p = 4; p >= 0; --p) {
      float acc = M[p][5];
#pragma unroll
      for (int q = p + 1; q < 5; ++q) acc = acc - M[p][q] * lam[q];
      lam[p] = acc * rp[p];
    }
  }
  return singular;
}
