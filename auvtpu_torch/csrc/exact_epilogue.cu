// Exact mode's epilogues for Hopper (sm_90a): the coordinate-form f64
// kriging solve (B17) and the bilinear and Catmull-Rom patch (B18).  Plain
// C interface, loaded with ctypes by auvtpu_torch/kernels/exact_epilogue.py.
//
// Replace no Pallas kernel: the JAX package runs these as jitted XLA
// programs or as host numpy, and the port ran them as strings of torch ops:
//   krige_kernel<T, Idx, MEAN>  <- auvtpu/ops/exact.py:303 _krige_chunk (the
//                                  5x6 solve of ops/scattered.py:210
//                                  krige_solve_cols and :188 gj56) with the
//                                  fallbacks of exact_kriging_at_cells :309
//                                  and exact_kriging_scattered :487; MEAN:
//                                  the fallback mean alone (exact cubic's
//                                  ring fallback, :541); the plain version
//                                  is kernels/exact_epilogue.py krige_ref
//   patch_kernel<T, KIND, CELLS> <- :570 _bilinear_chunk and the host numpy
//                                  of exact_bilinear_at_cells :610 (KIND
//                                  bilinear), :522 _cubic_smooth_chunk and
//                                  the host numpy of exact_cubic_at_cells
//                                  :344 (KIND cubic); CELLS the cell-aligned
//                                  form, else the scattered one; the plain
//                                  version is patch_ref
//
// What they compute, one thread a query, op for op as the plain version's
// torch ops do on the card: each operation of T or double rounded once
// (the build's -fmad=false keeps a*b+c two roundings), IEEE division and
// sqrt, and CUDA's double exp, the function torch's f64 exp calls.
//
// B17, from a query's selection (found, the four slot values in T, the
// slots' cells (gi, gj) as int32 or int64, zero beyond found) and its raw
// f64 coordinate (qlon, qlat):
//   - the fallback mean: s = ((v0 + v1) + v2) + v3 in f64, k = min(found,
//     4), s / k where k > 0, else NaN;
//   - where found >= 4 (and not MEAN): the neighbours at cell centres cx =
//     min_lon + (gi + 0.5) * lon_step (cy likewise), the exponential
//     gamma(h) = nugget + sill * (1 - exp(-h / range)) of h = sqrt(dx * dx +
//     dy * dy), each symmetric entry computed once (b >= a), the 5x6 system
//     [gamma_ab 1 | gamma_a0; 1 1 1 1 0 | 1], unpivoted Gauss-Jordan in
//     gj56's order (row i divided by its pivot, then every other row less
//     its column-i entry times row i); a pivot with |pivot| < pivot_tol
//     makes the system singular and every later pivot divides by 1; pred =
//     ((l0 v0 + l1 v1) + l2 v2) + l3 v3, each product rounded; s / 4 where
//     singular;
//   - written to out[m], or to out[idx[m]] where idx is given (exact cubic's
//     scattered form: the ring fallback of the queries whose patch is not
//     all valid, into the whole output).
// B18, from a query's anchor (ci, cj) (int64, B16's floor anchor) and grid
// coordinates (x, y) (f64):
//   - bilinear: corners (x0c, y0c), (x1, y0c), (x0c, y1), (x1, y1) with x0c
//     the anchor clamped into the grid and x1 = min(x0 + 1, W - 1) from the
//     unclamped anchor (CELLS: the JAX package's host numpy) or from the
//     clamped one (scattered); cnt the valid corners (valid > 0.5); where
//     cnt < 4 the mean of the valid ones, s / cnt (NaN where none) with s
//     summed in order in f64 (CELLS) or in T (scattered: on a float grid
//     the sum and quotient are float operations); else the lerp with wx =
//     x - x0 in f64: ((1 - wx) z0 + wx z1) and ((1 - wy) ...);
//   - cubic: the 4x4 patch at rows clamp(cj - 1 .. cj + 2) and columns
//     clamp(ci - 1 .. ci + 2), whether all 16 are valid, and two
//     Catmull-Rom passes 0.5 (2 p1 + (-p0 + p2) t + (2 p0 - 5 p1 + 4 p2 -
//     p3) t t + (-p0 + 3 p1 - 3 p2 + p3) t t t), summed left to right, with
//     t = x - ci, then y - cj; the first pass's coefficients in f64
//     (CELLS: the patch converted first) or in T (scattered: only the
//     products with t promote); CELLS writes the smooth value where the
//     patch is all valid and else B17's fallback mean of the query's
//     selection; scattered writes the smooth value and need = !all_valid &&
//     !oob (the queries the caller sends to the ring selection).
// Flat indices are row * W + col in int64.
//
// The designs (scripts/epilogue_variant_probe.py times them against each
// other and against another version's build, each held bit-equal to the
// plain version):
//   - B17 divides by two kinds of divisor, the variogram's range (14
//     dividends a query) and each pivot row's pivot (15 live dividends,
//     five pivots).  Each divisor's reciprocal is taken once by an IEEE
//     division, and each quotient comes from it by one Markstein
//     correction (quotient64: a multiply and two FMAs, against the
//     reciprocal's MUFU, Newton FMAs, range check and slow path an IEEE
//     division costs); a query any of whose operands leaves the guard is
//     solved again with IEEE divisions: the same bits either way (a check
//     a quotient and one branch a solve, not one a quotient).  The
//     elimination skips column i of step i (dead once the step is done).
//     The (n, 4) operands are read as 16-byte vectors where their base is
//     16-byte aligned.
//   - B18's cubic at cells reads only what its output needs: the validity
//     of the centre cell nearest the query's coordinate first (the query
//     cell), then the patch's rows, none after the first row that holds an
//     invalid cell, and the values only of a whole patch; a query whose
//     patch is not whole reads its selection instead.  The scattered cubic
//     writes the smooth value everywhere, so it reads every value, but no
//     validity row after the first invalid one.  A patch row is read as
//     two 16-byte (f64) or 8-byte (f32) pairs, or a scalar, a pair and a
//     scalar, where it is not clamped and the plane is aligned.  The
//     bilinear reads the values of its valid corners alone, and x and y
//     only where all four are valid.
//
// What bounds them on the H100.  B17: its f64 instruction issue more than
// its ~92 bytes a query (the 14 exps and sqrts, the quotients and the
// elimination's ~180 products: ~900 FP64-pipe instructions a solve at 64
// lanes a clock an SM; chip_smoke.py prints the static count of its SASS).
// B18: bytes: at the stand-in's masked cells 76 bytes of operands a query
// and one validity cell; scattered, the 16 (or 4) value and validity cells
// a query (gathers, mostly in L2 for neighbouring queries) and 32-40 bytes
// of operands.  One thread a query in blocks of 256.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kKrigeThreads = 256;
constexpr int kPatchThreads = 256;
constexpr int kBilinear = 0;
constexpr int kCubic = 1;

__device__ __forceinline__ double nan64() { return __longlong_as_double(0x7ff8000000000000LL); }
__device__ __forceinline__ float nan32() { return __int_as_float(0x7fc00000); }
template <typename T>
__device__ __forceinline__ T nan_of();
template <>
__device__ __forceinline__ float nan_of<float>() { return nan32(); }
template <>
__device__ __forceinline__ double nan_of<double>() { return nan64(); }

// torch's int64 adds wrap: so do these (no signed overflow)
__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
__device__ __forceinline__ long long clamp_ll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// the four entries of row m of an (n, 4) operand, as f64: one or two
// 16-byte loads where the base is 16-byte aligned (so is every row), else
// four scalar loads
template <typename T>
__device__ __forceinline__ void load4(const T* p, long long m, double (&v)[4]) {
  const T* row = p + 4 * m;
  if constexpr (sizeof(T) == 8) {
    if (aligned16(p)) {
      if constexpr (std::is_same<T, double>::value) {
        const double2 a = __ldg(reinterpret_cast<const double2*>(row));
        const double2 b = __ldg(reinterpret_cast<const double2*>(row) + 1);
        v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
      } else {
        const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(row));
        const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(row) + 1);
        v[0] = (double)a.x, v[1] = (double)a.y, v[2] = (double)b.x, v[3] = (double)b.y;
      }
      return;
    }
  } else {
    if (aligned16(p)) {
      if constexpr (std::is_same<T, float>::value) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(row));
        v[0] = (double)a.x, v[1] = (double)a.y, v[2] = (double)a.z, v[3] = (double)a.w;
      } else {
        const int4 a = __ldg(reinterpret_cast<const int4*>(row));
        v[0] = (double)a.x, v[1] = (double)a.y, v[2] = (double)a.z, v[3] = (double)a.w;
      }
      return;
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) v[a] = (double)__ldg(row + a);
}

// ---------------------------------------------------------------------------
// RN(a / d) from a reciprocal that serves every dividend of d
// ---------------------------------------------------------------------------

// The biased exponent field of a double.
__device__ __forceinline__ unsigned exponent_of(double x) { return ((unsigned)__double2hiint(x) >> 20) & 0x7ffu; }

// A divisor, RN(1 / d) by an IEEE division, and whether quotient64 may
// divide by it: |d| in [2^-100, 2^101) (biased exponent 923..1123).
struct Divisor {
  double d, r;
  bool ok;
};

__device__ __forceinline__ Divisor divisor_of(double d) { return {d, 1.0 / d, exponent_of(d) - 923u <= 200u}; }

// RN(a / d.d), bit for bit IEEE division.  FAST: q0 = RN(a r) lies within
// 1.5 ulp of a / d, and one Markstein correction, e = RN(a - d q0) and q =
// RN(q0 + e r) (each an FMA), rounds it correctly while nothing under- or
// overflows.  The guard: d.ok and |a| in [2^-900, 2^901) (biased exponent
// 123..1923), where every quotient is normal and finite and e's bits lie
// above 2^-1074, or a = ±0 (then q0 = a r is a / d, its sign included).
// Where it fails (a subnormal, huge, inf or NaN dividend, a divisor
// outside its range) `exact` turns false and the caller solves again with
// FAST false: IEEE divisions.  tests/test_torch_exact_quotient.py holds
// this recipe and guard against IEEE division, every step rounded once on
// the host.
template <bool FAST>
__device__ __forceinline__ double quotient64(double a, const Divisor& d, bool& exact) {
  if constexpr (!FAST) {
    return a / d.d;
  } else {
    const double q0 = a * d.r;
    const double e = fma(-d.d, q0, a);
    const double q = fma(e, d.r, q0);
    const bool zero = ((unsigned long long)__double_as_longlong(a) << 1) == 0;
    exact = exact && d.ok && (exponent_of(a) - 123u <= 1800u || zero);
    return zero ? q0 : q;
  }
}

// ---------------------------------------------------------------------------
// B17: the coordinate-form solve
// ---------------------------------------------------------------------------

struct KrigeScalars {
  double min_lon, min_lat, lon_step, lat_step;
  double nugget, sill, range, pivot_tol;
};

template <typename T, typename Idx>
struct KrigeArgs {
  int n;
  const int32_t* found;  // (n,)
  const T* sel_val;      // (n, 4)
  const Idx* sel_gi;     // (n, 4), not read by MEAN
  const Idx* sel_gj;     // (n, 4), not read by MEAN
  const double* qlon;    // (n,), not read by MEAN
  const double* qlat;    // (n,)
  KrigeScalars s;
  const int64_t* idx;  // (n,) destinations in out, or null: out[m]
  double* out;
};

// gamma(h) = nugget + sill * (1 - exp(-h / range)), the range's reciprocal
// taken once a thread
template <bool FAST>
__device__ __forceinline__ double gamma_of(double h, const KrigeScalars& s, const Divisor& range, bool& exact) {
  return s.nugget + s.sill * (1.0 - exp(quotient64<FAST>(-h, range, exact)));
}

__device__ __forceinline__ double dist(double ax, double ay, double bx, double by) {
  const double dx = ax - bx;
  const double dy = ay - by;
  return sqrt(dx * dx + dy * dy);
}

__device__ __forceinline__ double sum4(const double (&v)[4]) { return ((v[0] + v[1]) + v[2]) + v[3]; }

// _fallback_mean: the mean of the min(found, 4) selected values, NaN where
// none (slots beyond found are zero)
__device__ __forceinline__ double fallback_mean(int found, const double (&v)[4]) {
  const int k = found < 4 ? found : 4;
  return k > 0 ? sum4(v) / (double)k : nan64();
}

// the solve; FAST: by the shared reciprocals, `exact` false where a
// quotient left the guard (the result is then not used)
template <bool FAST, typename T, typename Idx>
__device__ double krige_one(const KrigeArgs<T, Idx>& p, long long m, const double (&v)[4], bool& exact) {
  const KrigeScalars& s = p.s;
  const Divisor range = divisor_of(s.range);
  double gi[4], gj[4], cx[4], cy[4];
  load4(p.sel_gi, m, gi);
  load4(p.sel_gj, m, gj);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    cx[a] = s.min_lon + (gi[a] + 0.5) * s.lon_step;
    cy[a] = s.min_lat + (gj[a] + 0.5) * s.lat_step;
  }
  const double qx = p.qlon[m], qy = p.qlat[m];
  double M[5][6];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b < a)
        M[a][b] = M[b][a];  // symmetric: computed once
      else
        M[a][b] = gamma_of<FAST>(dist(cx[a], cy[a], cx[b], cy[b]), s, range, exact);
    }
    M[a][4] = 1.0;
    M[a][5] = gamma_of<FAST>(dist(cx[a], cy[a], qx, qy), s, range, exact);
  }
  M[4][0] = 1.0;
  M[4][1] = 1.0;
  M[4][2] = 1.0;
  M[4][3] = 1.0;
  M[4][4] = 0.0;
  M[4][5] = 1.0;
  // gj56's order; column i of step i is not formed (no later step or the
  // result reads it)
  bool singular = false;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const double pivot = M[i][i];
    singular = singular || (fabs(pivot) < s.pivot_tol);
    const Divisor piv = divisor_of(singular ? 1.0 : pivot);
#pragma unroll
    for (int q = i + 1; q < 6; ++q) M[i][q] = quotient64<FAST>(M[i][q], piv, exact);
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      if (r == i) continue;
      const double f = M[r][i];
#pragma unroll
      for (int q = i + 1; q < 6; ++q) M[r][q] = M[r][q] - f * M[i][q];
    }
  }
  if (singular) return sum4(v) / 4.0;
  return ((M[0][5] * v[0] + M[1][5] * v[1]) + M[2][5] * v[2]) + M[3][5] * v[3];
}

template <typename T, typename Idx, bool MEAN>
__global__ void __launch_bounds__(kKrigeThreads) krige_kernel(const KrigeArgs<T, Idx> p) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= p.n) return;
  const int found = p.found[m];
  double v[4];
  load4(p.sel_val, m, v);
  double res;
  if (MEAN || found < 4) {
    res = fallback_mean(found, v);
  } else {
    bool exact = true;
    res = krige_one<true>(p, m, v, exact);
    if (!exact) res = krige_one<false>(p, m, v, exact);
  }
  p.out[p.idx != nullptr ? p.idx[m] : m] = res;
}

// ---------------------------------------------------------------------------
// B18: the bilinear and Catmull-Rom patch
// ---------------------------------------------------------------------------

template <typename T>
struct PatchArgs {
  int n;
  int H, W;
  const T* elev;          // (H, W)
  const T* valid;         // (H, W)
  const int64_t* ci;      // (n,) floor anchors
  const int64_t* cj;
  const double* x;        // (n,) grid coordinates
  const double* y;
  const int32_t* found;   // cubic, cells: (n,) the selection's count
  const T* sel_val;       // cubic, cells: (n, 4)
  const uint8_t* oob;     // cubic, scattered: (n,)
  double* out;            // (n,)
  uint8_t* need;          // cubic, scattered: (n,)
};

// a flat index into the plane
using Flat = long long;

// a gather's flat index as torch's indexing takes it: a negative one
// counts from the end; held inside the plane for memory safety (B16's
// anchors never leave it)
__device__ __forceinline__ long long cell_index(long long idx, long long size) {
  if (idx < 0) idx += size;
  return clamp_ll(idx, 0, size - 1);
}

__device__ __forceinline__ bool is_valid(float v) { return v > 0.5f; }
__device__ __forceinline__ bool is_valid(double v) { return v > 0.5; }

// _catmull_rom with the coefficients in Z and t in f64: 2 p1, (-p0 + p2),
// (2 p0 - 5 p1 + 4 p2 - p3) and (-p0 + 3 p1 - 3 p2 + p3) are Z operations;
// each product with t promotes to f64
template <typename Z>
__device__ __forceinline__ double catmull_rom(Z p0, Z p1, Z p2, Z p3, double t) {
  const Z a = (Z)2 * p1;
  const Z b = -p0 + p2;
  const Z c = (((Z)2 * p0 - (Z)5 * p1) + (Z)4 * p2) - p3;
  const Z d = ((-p0 + (Z)3 * p1) - (Z)3 * p2) + p3;
  const double bt = (double)b * t;
  const double ct = ((double)c * t) * t;
  const double dt = (((double)d * t) * t) * t;
  return 0.5 * ((((double)a + bt) + ct) + dt);
}

// two adjacent cells of a plane as one 16-byte (f64) or 8-byte (f32) load
template <typename T>
using Pair = typename std::conditional<sizeof(T) == 8, double2, float2>::type;

template <typename T>
__device__ __forceinline__ bool pair_aligned(const T* p) {
  return ((uintptr_t)p & (2 * sizeof(T) - 1)) == 0;
}

template <typename T, bool CELLS>
__device__ double bilinear_one(const PatchArgs<T>& p, long long n) {
  using Z = typename std::conditional<CELLS, double, T>::type;
  const long long H = p.H, W = p.W, HW = H * W;
  const long long x0 = p.ci[n], y0 = p.cj[n];
  const long long x0c = clamp_ll(x0, 0, W - 1), y0c = clamp_ll(y0, 0, H - 1);
  long long x1 = wrap_add(CELLS ? x0 : x0c, 1), y1 = wrap_add(CELLS ? y0 : y0c, 1);
  x1 = x1 > W - 1 ? W - 1 : x1;
  y1 = y1 > H - 1 ? H - 1 : y1;
  const long long idx[4] = {cell_index(y0c * W + x0c, HW), cell_index(y0c * W + x1, HW),
                            cell_index(y1 * W + x0c, HW), cell_index(y1 * W + x1, HW)};
  // validity first; the values of the valid corners alone
  bool m[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) m[a] = is_valid(__ldg(p.valid + idx[a]));
  Z z[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) z[a] = m[a] ? (Z)__ldg(p.elev + idx[a]) : (Z)0;
  const int cnt = (((int)m[0] + (int)m[1]) + (int)m[2]) + (int)m[3];
  if (cnt < 4) {
    const Z s = ((z[0] + z[1]) + z[2]) + z[3];
    return cnt > 0 ? (double)(s / (Z)cnt) : nan64();
  }
  const double wx = p.x[n] - (double)x0;
  const double wy = p.y[n] - (double)y0;
  const double l0 = (1.0 - wx) * (double)z[0] + wx * (double)z[1];
  const double l1 = (1.0 - wx) * (double)z[2] + wx * (double)z[3];
  return (1.0 - wy) * l0 + wy * l1;
}

// The cells of a patch row: columns ii[0..3] of the row that starts at
// flat index `row`; where the four are adjacent (the row is not clamped)
// and the plane's base is aligned to a pair, as two pairs (16 bytes each on
// an f64 plane) or a scalar, a pair and a scalar, else as four scalars.
template <typename T>
__device__ __forceinline__ void row4(const T* p, Flat row, const Flat (&ii)[4], T (&q)[4]) {
  const Flat f0 = row + ii[0];
  if (ii[3] == ii[0] + 3 && pair_aligned(p)) {
    if ((f0 & 1) == 0) {
      const Pair<T> a = __ldg(reinterpret_cast<const Pair<T>*>(p + f0));
      const Pair<T> b = __ldg(reinterpret_cast<const Pair<T>*>(p + f0 + 2));
      q[0] = a.x, q[1] = a.y, q[2] = b.x, q[3] = b.y;
    } else {
      const Pair<T> a = __ldg(reinterpret_cast<const Pair<T>*>(p + f0 + 1));
      q[0] = __ldg(p + f0), q[1] = a.x, q[2] = a.y, q[3] = __ldg(p + f0 + 3);
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) q[c] = __ldg(p + (row + ii[c]));
}

// the clamped patch's rows (their first cells' flat indices) and columns
template <typename T>
__device__ __forceinline__ void patch_lines(const PatchArgs<T>& p, long long xi, long long yi, Flat (&rows)[4],
                                            Flat (&ii)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    rows[r] = (Flat)clamp_ll(wrap_add(yi, r - 1), 0, p.H - 1) * (Flat)p.W;
    ii[r] = (Flat)clamp_ll(wrap_add(xi, r - 1), 0, p.W - 1);
  }
}

// whether the patch's sixteen cells are valid, row by row, reading no row
// after the first that holds an invalid cell
template <typename T>
__device__ __forceinline__ bool patch_whole(const T* valid, const Flat (&rows)[4], const Flat (&ii)[4]) {
  bool whole = true;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (whole) {
      T v[4];
      row4(valid, rows[r], ii, v);
      whole = is_valid(v[0]) && is_valid(v[1]) && is_valid(v[2]) && is_valid(v[3]);
    }
  }
  return whole;
}

// the two Catmull-Rom passes over the patch's values, gathered here
template <typename T, typename Z>
__device__ __forceinline__ double smooth_of(const PatchArgs<T>& p, long long n, const Flat (&rows)[4],
                                            const Flat (&ii)[4], double tx) {
  double col[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    T q[4];
    row4(p.elev, rows[r], ii, q);
    col[r] = catmull_rom<Z>((Z)q[0], (Z)q[1], (Z)q[2], (Z)q[3], tx);
  }
  return catmull_rom<double>(col[0], col[1], col[2], col[3], p.y[n] - (double)p.cj[n]);
}

// the cubic at a cell: the centre cell nearest (x, y) first (the query
// cell: its grid coordinate may round to the anchor on either side of it),
// then the sixteen, and the values only where the patch is whole; else the
// selection's fallback mean
template <typename T>
__device__ double cubic_cells_one(const PatchArgs<T>& p, long long n) {
  const long long xi = p.ci[n], yi = p.cj[n];
  Flat rows[4], ii[4];
  patch_lines(p, xi, yi, rows, ii);
  const double tx = p.x[n] - (double)xi;
  const bool right = tx >= 0.5, up = p.y[n] - (double)yi >= 0.5;
  const bool whole = is_valid(__ldg(p.valid + ((up ? rows[2] : rows[1]) + (right ? ii[2] : ii[1])))) &&
                     patch_whole(p.valid, rows, ii);
  if (!whole) {
    double v[4];
    load4(p.sel_val, n, v);
    return fallback_mean(p.found[n], v);
  }
  return smooth_of<T, double>(p, n, rows, ii, tx);
}

// the scattered cubic: the smooth value always; whether the patch is whole
template <typename T>
__device__ double cubic_scattered_one(const PatchArgs<T>& p, long long n, bool& whole) {
  const long long xi = p.ci[n], yi = p.cj[n];
  Flat rows[4], ii[4];
  patch_lines(p, xi, yi, rows, ii);
  whole = patch_whole(p.valid, rows, ii);
  return smooth_of<T, T>(p, n, rows, ii, p.x[n] - (double)xi);
}

template <typename T, int KIND, bool CELLS>
__global__ void __launch_bounds__(kPatchThreads) patch_kernel(const PatchArgs<T> p) {
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.n) return;
  if constexpr (KIND == kBilinear) {
    p.out[n] = bilinear_one<T, CELLS>(p, n);
  } else if constexpr (CELLS) {
    p.out[n] = cubic_cells_one<T>(p, n);
  } else {
    bool whole;
    p.out[n] = cubic_scattered_one<T>(p, n, whole);
    p.need[n] = !whole && !p.oob[n];
  }
}

unsigned blocks_for(long long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

template <typename T, typename Idx>
int launch_krige(bool mean, const KrigeArgs<T, Idx>& p, cudaStream_t st) {
  const unsigned b = blocks_for(p.n, kKrigeThreads);
  if (mean)
    krige_kernel<T, Idx, true><<<b, kKrigeThreads, 0, st>>>(p);
  else
    krige_kernel<T, Idx, false><<<b, kKrigeThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, typename Idx>
int krige_in(bool mean, int n, const void* found, const void* sel_val, const void* sel_gi, const void* sel_gj,
             const void* qlon, const void* qlat, const KrigeScalars& s, const void* idx, void* out, cudaStream_t st) {
  KrigeArgs<T, Idx> p;
  p.n = n;
  p.found = (const int32_t*)found;
  p.sel_val = (const T*)sel_val;
  p.sel_gi = (const Idx*)sel_gi;
  p.sel_gj = (const Idx*)sel_gj;
  p.qlon = (const double*)qlon;
  p.qlat = (const double*)qlat;
  p.s = s;
  p.idx = (const int64_t*)idx;
  p.out = (double*)out;
  return launch_krige<T, Idx>(mean, p, st);
}

template <typename T>
int patch_in(int kind, bool cells, int H, int W, int n, const void* elev, const void* valid, const void* ci,
             const void* cj, const void* x, const void* y, const void* found, const void* sel_val, const void* oob,
             void* out, void* need, cudaStream_t st) {
  PatchArgs<T> p;
  p.n = n;
  p.H = H;
  p.W = W;
  p.elev = (const T*)elev;
  p.valid = (const T*)valid;
  p.ci = (const int64_t*)ci;
  p.cj = (const int64_t*)cj;
  p.x = (const double*)x;
  p.y = (const double*)y;
  p.found = (const int32_t*)found;
  p.sel_val = (const T*)sel_val;
  p.oob = (const uint8_t*)oob;
  p.out = (double*)out;
  p.need = (uint8_t*)need;
  const unsigned b = blocks_for(n, kPatchThreads);
  if (kind == kBilinear && cells)
    patch_kernel<T, kBilinear, true><<<b, kPatchThreads, 0, st>>>(p);
  else if (kind == kBilinear)
    patch_kernel<T, kBilinear, false><<<b, kPatchThreads, 0, st>>>(p);
  else if (cells)
    patch_kernel<T, kCubic, true><<<b, kPatchThreads, 0, st>>>(p);
  else
    patch_kernel<T, kCubic, false><<<b, kPatchThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// every build the wrapper launches, with its block size, in
// auvtpu_exact_epilogue_attributes' order (kernels/exact_epilogue.py BUILDS)
struct Build {
  const void* fn;
  int threads;
};
const Build kBuilds[] = {
    {(const void*)krige_kernel<float, int32_t, false>, kKrigeThreads},
    {(const void*)krige_kernel<float, int64_t, false>, kKrigeThreads},
    {(const void*)krige_kernel<double, int32_t, false>, kKrigeThreads},
    {(const void*)krige_kernel<double, int64_t, false>, kKrigeThreads},
    {(const void*)krige_kernel<float, int32_t, true>, kKrigeThreads},
    {(const void*)krige_kernel<double, int32_t, true>, kKrigeThreads},
    {(const void*)patch_kernel<float, kBilinear, true>, kPatchThreads},
    {(const void*)patch_kernel<float, kBilinear, false>, kPatchThreads},
    {(const void*)patch_kernel<float, kCubic, true>, kPatchThreads},
    {(const void*)patch_kernel<float, kCubic, false>, kPatchThreads},
    {(const void*)patch_kernel<double, kBilinear, true>, kPatchThreads},
    {(const void*)patch_kernel<double, kBilinear, false>, kPatchThreads},
    {(const void*)patch_kernel<double, kCubic, true>, kPatchThreads},
    {(const void*)patch_kernel<double, kCubic, false>, kPatchThreads},
};

}  // namespace

extern "C" {

// B17.  dtype 0: sel_val float, 1: double; idx_type 0: sel_gi, sel_gj
// int32, 1: int64; mean_only 1: the fallback mean alone (sel_gi, sel_gj,
// qlon, qlat may be null).  found (n,) int32, sel_val (n, 4), sel_gi,
// sel_gj (n, 4), qlon, qlat (n,) f64; the grid's min_lon, min_lat,
// lon_step, lat_step and the variogram's nugget, sill, range and the pivot
// tolerance by value; idx (n,) int64 destinations in out, or null (out[m]);
// out f64.  Returns the launch's cudaError_t.
int auvtpu_exact_krige(int dtype, int idx_type, int mean_only, int n, const void* found, const void* sel_val,
                       const void* sel_gi, const void* sel_gj, const void* qlon, const void* qlat, double min_lon,
                       double min_lat, double lon_step, double lat_step, double nugget, double sill, double range,
                       double pivot_tol, const void* idx, void* out, void* stream) {
  if (n < 0 || dtype < 0 || dtype > 1 || idx_type < 0 || idx_type > 1 || found == nullptr || sel_val == nullptr ||
      out == nullptr || (!mean_only && (sel_gi == nullptr || sel_gj == nullptr || qlon == nullptr || qlat == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const KrigeScalars s{min_lon, min_lat, lon_step, lat_step, nugget, sill, range, pivot_tol};
  const bool mean = mean_only != 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return idx_type == 0 || mean
               ? krige_in<float, int32_t>(mean, n, found, sel_val, sel_gi, sel_gj, qlon, qlat, s, idx, out, st)
               : krige_in<float, int64_t>(mean, n, found, sel_val, sel_gi, sel_gj, qlon, qlat, s, idx, out, st);
  return idx_type == 0 || mean
             ? krige_in<double, int32_t>(mean, n, found, sel_val, sel_gi, sel_gj, qlon, qlat, s, idx, out, st)
             : krige_in<double, int64_t>(mean, n, found, sel_val, sel_gi, sel_gj, qlon, qlat, s, idx, out, st);
}

// B18.  dtype 0: float grid, 1: double; kind 0: bilinear, 1: cubic;
// at_cells 1: the cell-aligned form, 0: scattered.  elev, valid (H, W); ci,
// cj (n,) int64 floor anchors; x, y (n,) f64 grid coordinates; found (n,)
// int32 and sel_val (n, 4) for the cubic cell form, oob (n,) uint8 and
// need (n,) uint8 for the cubic scattered form, null otherwise; out (n,)
// f64.  Returns the launch's cudaError_t.
int auvtpu_exact_patch(int dtype, int kind, int at_cells, int H, int W, int n, const void* elev, const void* valid,
                       const void* ci, const void* cj, const void* x, const void* y, const void* found,
                       const void* sel_val, const void* oob, void* out, void* need, void* stream) {
  const bool cells = at_cells != 0;
  if (H < 1 || W < 1 || n < 0 || dtype < 0 || dtype > 1 || kind < 0 || kind > 1 || elev == nullptr ||
      valid == nullptr || ci == nullptr || cj == nullptr || x == nullptr || y == nullptr || out == nullptr ||
      (kind == kCubic && cells && (found == nullptr || sel_val == nullptr)) ||
      (kind == kCubic && !cells && (oob == nullptr || need == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return patch_in<float>(kind, cells, H, W, n, elev, valid, ci, cj, x, y, found, sel_val, oob, out, need, st);
  return patch_in<double>(kind, cells, H, W, n, elev, valid, ci, cj, x, y, found, sel_val, oob, out, need, st);
}

// The resources of build `which` (kBuilds' order) on the current card:
// registers a thread, local bytes a thread, resident blocks an SM at the
// build's block size, the block size.  For the resource report of
// chip_smoke.py.
int auvtpu_exact_epilogue_attributes(int which, int* out) {
  if (which < 0 || which >= (int)(sizeof(kBuilds) / sizeof(kBuilds[0]))) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const Build& b = kBuilds[which];
  cudaError_t err = cudaFuncGetAttributes(&attr, b.fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, b.fn, b.threads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = b.threads;
  return 0;
}

const char* auvtpu_exact_epilogue_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
