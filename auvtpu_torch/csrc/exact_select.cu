// Exact mode's selections for Hopper (sm_90a): the two-tier dense pass at
// the query cells with its f64 table solve (B13) and the strict ring
// selection (B14).  Plain C interface, loaded with ctypes by
// auvtpu_torch/kernels/exact_select.py.
//
// Replaces no Pallas kernel: the JAX package runs exact mode as jitted XLA
// programs, and the port ran them as eager torch loops:
//   dense_kernel<T, SOLVE>     <- auvtpu/ops/exact_fast.py::_dense_select
//                                 (the lax.while_loop over the (2R+1)^2 lanes of
//                                 the whole plane), ::_extract_q and, with
//                                 SOLVE, ::_extract_solve_table (B13; the
//                                 port's plain versions are
//                                 ops/exact_fast.py _dense_select,
//                                 _extract_q and _solve_table)
//   ring_kernel<T, KEY, SOLVE> <- auvtpu/ops/exact.py::_select_chunk (KEY 0,
//                                 cell-aligned) and ::_select_chunk_scattered
//                                 (KEY 1), the (N, (2R+1)^2) lane gathers with
//                                 the cumsum cutoff and four amin/amax swap
//                                 passes; SOLVE adds the table solve of the
//                                 two-tier path's escalated cells (B14; the
//                                 plain versions are ops/exact.py
//                                 _select_chunk, _select_chunk_scattered
//                                 and _swap_passes, then _solve_table)
//   bits_kernel<T>             the validity plane as one bit a cell, built
//                                 before a B13 or B14 launch with many
//                                 queries (part of both; no plain
//                                 counterpart: the plain versions test
//                                 valid > 0.5 lane by lane)
//
// What they compute.  Both walk the candidate lanes of one anchor cell in
// the reference's collection order (tables.ring_offsets, GridH.cpp:24-118):
// the centre, then per ring r the top/bottom pass (dx = -r..r, (dx, -r)
// before (dx, r)) and the left/right pass (dy = -r+1..r-1, (-r, dy) before
// (r, dy)); each pass is a segment.  A lane is a candidate where it lies in
// the grid and valid > 0.5; the walk ends at the first segment end where 4
// or more candidates are held (GridH.cpp:82,115), so a candidate is taken
// exactly while its segment started with fewer than 4 held (the plain
// versions' `cum_prev < 4`, the dense pass's `stopped`).  A thread reads a
// segment's validity as two bit masks (the top and bottom rows' spans, or
// the left and right columns' bits), interleaves them into collection order
// and visits only the set bits, lowest first.  The radius R is the
// caller's, taken at run time (the rings 0 .. R, the tables' sides 4R+1
// and 2R+1): from R = 16 on a pass holds more than 32 cells, and it is
// read in pieces of 32, in collection order (ring_walk).  A walk stops at
// the last ring that holds a lane of the grid.
//
// B13, per query cell (the query's row * W + col, clipped to the plane, as
// the plain version reads its planes): the residues (ex, ey) of the cell:
// where every query of the call is aligned (each cell holds its own
// query's keys; duplicated cells carry equal ones) read with the query from
// the (2, n) keys, else from the two f32 planes that the wrapper scatters
// the aligned queries' keys into (zero elsewhere: a query on a cell no
// aligned query holds reads 0, as in the plain version); per candidate the
// variant-0 key d2 = (dx + 0.5)^2 + (dy + 0.5)^2 (exact in f32) and T = ex
// (2 dx + 1) + ey (2 dy + 1) (two products and a sum, each rounded once:
// -fmad=false); a top-5 list in registers kept sorted by (d2 ascending, T
// descending) with the plain version's insert: a candidate strictly better
// than slot s takes the first such slot, the ones below shift down, the
// fifth falls out; an equal key files below the earlier one.  The count is
// every candidate taken.  Then tie = key(4th) == key(5th) with a finite
// 5th, and the first min(count, 4) slots as offsets (dgi, dgj) from the
// cell and values (zero on unfilled slots), as _extract_q gives them; with
// SOLVE instead the f64 prediction of _solve_table (below).
//
// B14, per query: its anchor (ci, cj) (int64; no lane of an anchor more
// than R cells off the grid lies in it, also where torch's int64 adds
// wrap) and the candidates in collection order, the list of the plain
// version.  Keys: KEY 0 the variant's d2 and T (the anchor variant v
// shifts the lane by (-(v >> 1), -(v & 1)); d2 and T as in B13); KEY 1 the
// f64 distance sqrt(di*di + dj*dj) with di = (gi + 0.5) - x, three rounded
// operations and IEEE sqrt, as the reference computes it.  GridH.cpp:123-
// 140's four passes: pass m takes the least key among positions >= m
// (KEY 0: the least d2, then the largest T among those), the lowest
// position on a tie, and swaps positions m and that one.  The list itself
// is not kept.  An entry at position 4 or later moves only when a pass
// takes it, and a pass that takes one from there takes the least of them
// by (key, position); so the four passes need the list's first four
// entries and, of the rest, the four least by (key, position): a top-4
// kept with B13's insert.  The passes run on these eight in registers,
// each entry with its current position.  A NaN: the plain version's pass
// finds its amin/amax NaN where a NaN key is among those it compares, takes
// nothing and moves the entry at position m past every other, so the same
// keys are compared again and every later pass takes nothing too.  KEY 1:
// a NaN distance is never taken, so any NaN in the list empties every
// slot.  KEY 0 (d2 is never NaN): a pass compares T only among the entries
// of the least d2, so the kernel keeps the least d2 of an entry with a NaN
// T, and the passes stop at the first whose least d2 reaches it.  Slot m
// holds the pick's value + 0 (the plain version's one-hot sum, which turns
// -0 into +0) and its (gi, gj) as int32, zeros where nothing was picked;
// found is the list's length.  With SOLVE (KEY 0 only) the slots become
// offsets from the query's own cell (qcol, qrow) and go through the table
// solve.
//
// The table solve (_krige_rows_table + _solve_table, f64): the 5x6 system
// from the lattice tables gpair ((4R+1)^2, neighbour pairs) and gq
// ((2R+1)^2, query to neighbour), gamma(0) on the diagonal, solved by the
// unpivoted Gauss-Jordan of ops/scattered.py gj56 (a pivot below pivot_tol
// makes the row singular, and every later pivot divides by 1; a NaN pivot
// is not below it); the prediction ((((0 + l0 v0) + l1 v1) + l2 v2) + l3
// v3) as Python's sum builds it (from 0, so -0 becomes +0); the four-value
// mean where singular; where fewer than 4 were found the fallback mean
// (sum / min(found, 4), NaN where none).  Table indices are the plain
// version's flat ones; they lie in the table for every query whose anchor
// is its cell, and are wrapped and clamped into it for any other.
//
// What bounds them on the H100.  Per query B13 reads its cell index (8 B),
// its two residues (8 B), the validity of the lanes it walks (9-25 at the
// stand-in's 10 % removal at R = 10, (2R+1)^2 where a cell never holds 4) and 4 values,
// and writes 45 B (select) or 9 B (solve): bytes, not operations.  The
// queries come in random order, so each lane read is a sector of its own:
// as an f64 plane the validity (40 MB at the stand-in) and the elevation
// do not stay in the 50 MB L2 together.  Where the queries number at least 1/32 of
// the grid's cells the launch first builds the bit plane (one bit a cell,
// flat, 627 KB at the stand-in: bits_kernel, one coalesced pass over the
// validity plane, its launch counted in the kernels' time), which stays in
// the L2, and a span of a segment is one or two words; fewer queries read
// the validity plane itself, a span's cells loaded together (the pass
// over the whole plane would cost more than it saves).  Either way the
// 3x3 block's three rows are fetched together before the first test.  A
// 45-entry list would take 456 B of local memory a thread; B14's eight
// entries live in registers.  The tables of the solve go through the
// read-only cache (__ldg, 17 KB at R = 10).  One thread per query in blocks
// of 256.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kPiece = 32;  // the cells of a pass that one 32-bit mask holds
// The largest radius taken: the walk's int coordinates (an anchor within R
// of the grid, plus R) stay far from overflow.  The plain versions' and the
// JAX package's (2R+1)^2-lane tables could not be held at such a radius.
constexpr int kMaxRadius = 1 << 20;
// The callers' default radius, which has builds of its own (the template
// argument RC of dense_kernel and ring_kernel; RC 0 takes the radius at run
// time): at radius 10 the runtime radius cost B14 17 % (its registers) and
// B13 7 % where it reads the residue planes (its spills; PERF.md).
constexpr int kBuiltRadius = 10;

// ---------------------------------------------------------------------------
// the validity bit plane and the walk over it
// ---------------------------------------------------------------------------

// Four cells a thread, a warp's 128 cells as 4 words: bit c % 32 of word
// c / 32 is flat cell c's, set where valid > 0.5 (a NaN is 0); the bits
// past the last cell are 0.  vec: valid lies on 16 bytes, so a thread's
// four cells are one (f32) or two (f64) 16-byte loads.
template <typename T>
__global__ void __launch_bounds__(kThreads) bits_kernel(const T* __restrict__ valid, long long cells, bool vec,
                                                        uint32_t* __restrict__ bits) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if ((t & ~31LL) * 4 >= cells) return;  // whole warps: the warp's first cell lies past the plane
  const long long c = t * 4;
  T v[4];
  if (vec && c + 3 < cells) {
    if constexpr (sizeof(T) == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(valid + c));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
      const double2 q0 = __ldg(reinterpret_cast<const double2*>(valid + c));
      const double2 q1 = __ldg(reinterpret_cast<const double2*>(valid + c) + 1);
      v[0] = q0.x, v[1] = q0.y, v[2] = q1.x, v[3] = q1.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = c + k < cells ? valid[c + k] : (T)0;
  }
  uint32_t w = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) w |= (uint32_t)(v[k] > (T)0.5) << k;
  w <<= 4 * (threadIdx.x & 7);
  w |= __shfl_xor_sync(0xffffffffu, w, 1);
  w |= __shfl_xor_sync(0xffffffffu, w, 2);
  w |= __shfl_xor_sync(0xffffffffu, w, 4);
  if ((threadIdx.x & 7) == 0 && c < cells) bits[c >> 5] = w;
}

// The validity as the walk reads it.  span(gj, c0, n): cells c0 .. c0 +
// n - 1 (n <= kPiece) of row gj as bits 0 .. n - 1, set where the cell lies
// in the grid and is valid; ends(gj, c0, n): cells c0 and c0 + n - 1 of row
// gj (a left/right segment's two cells in that row, any n >= 2) as bits 0
// and 1.
struct BitPlane {
  const uint32_t* __restrict__ p;  // the flat bit plane of bits_kernel
  int H, W;

  // the one or two words a span touches, both loaded before either is used
  __device__ __forceinline__ uint32_t span(int gj, int c0, int n) const {
    if ((unsigned)gj >= (unsigned)H) return 0u;
    const int lo = max(c0, 0), hi = min(c0 + n, W);
    if (lo >= hi) return 0u;
    const long long f0 = (long long)gj * W + lo, f1 = (long long)gj * W + hi - 1;
    const uint32_t a = __ldg(p + (f0 >> 5)), b = __ldg(p + (f1 >> 5));
    const uint64_t v = (uint64_t)a | ((f1 >> 5) != (f0 >> 5) ? (uint64_t)b << 32 : 0ull);
    return (uint32_t)(((v >> (f0 & 31)) & ((1ull << (hi - lo)) - 1ull)) << (lo - c0));
  }
  // the words of the row's first and last cell in the grid, as span loads
  // them, both loaded before either is used
  __device__ __forceinline__ uint32_t ends(int gj, int c0, int n) const {
    if ((unsigned)gj >= (unsigned)H) return 0u;
    const int c1 = c0 + n - 1;
    const int lo = max(c0, 0), hi = min(c1, W - 1);
    if (lo > hi) return 0u;
    const long long f0 = (long long)gj * W + lo, f1 = (long long)gj * W + hi;
    const uint32_t a = __ldg(p + (f0 >> 5)), b = __ldg(p + (f1 >> 5));
    const uint32_t first = lo == c0 ? (a >> (f0 & 31)) & 1u : 0u;
    const uint32_t last = hi == c1 ? (b >> (f1 & 31)) & 1u : 0u;
    return first | (last << 1);
  }
};

template <typename T>
struct ValuePlane {
  const T* __restrict__ p;  // the (H, W) validity plane
  int H, W;

  // a span's cells, loaded together
  __device__ __forceinline__ uint32_t span(int gj, int c0, int n) const {
    if ((unsigned)gj >= (unsigned)H) return 0u;
    const int lo = max(c0, 0), hi = min(c0 + n, W);
    const T* r = p + (long long)gj * W;
    uint32_t m = 0u;
#pragma unroll 3
    for (int c = lo; c < hi; ++c) m |= (uint32_t)(__ldg(r + c) > (T)0.5) << (c - c0);
    return m;
  }
  __device__ __forceinline__ uint32_t ends(int gj, int c0, int n) const {
    if ((unsigned)gj >= (unsigned)H) return 0u;
    const T* r = p + (long long)gj * W;
    const int c1 = c0 + n - 1;
    const bool a = c0 >= 0 && c0 < W && __ldg(r + c0) > (T)0.5;
    const bool b = c1 >= 0 && c1 < W && __ldg(r + c1) > (T)0.5;
    return (uint32_t)a | ((uint32_t)b << 1);
  }
};

// bit k of x to bit 2k
__device__ __forceinline__ uint64_t spread(uint32_t x) {
  uint64_t v = x;
  v = (v | (v << 16)) & 0x0000FFFF0000FFFFull;
  v = (v | (v << 8)) & 0x00FF00FF00FF00FFull;
  v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0Full;
  v = (v | (v << 2)) & 0x3333333333333333ull;
  v = (v | (v << 1)) & 0x5555555555555555ull;
  return v;
}

// A segment's two masks in collection order: bit 2k the first's bit k,
// bit 2k + 1 the second's.
__device__ __forceinline__ uint64_t interleave(uint32_t first, uint32_t second) {
  return spread(first) | (spread(second) << 1);
}

// The rings of anchor (ci, cj) that hold a lane of the grid lie within
// max(ci, W - 1 - ci, cj, H - 1 - cj) of it: a farther ring's lanes are all
// off the grid, and its walk would take nothing.
__device__ __forceinline__ int last_ring(long long ci, long long cj, int H, int W, int R) {
  const long long reach = max(max(ci, (long long)W - 1 - ci), max(cj, (long long)H - 1 - cj));
  return (int)min((long long)R, reach);
}

// The candidates of anchor (ci, cj) in collection order, rings 0 .. rmax:
// take(dx, dy) for each valid lane in the grid, held() after each segment;
// the walk ends where held() is true.  A ring's top/bottom pass (2r + 1
// cells) and its left/right pass (2r - 1 rows) are read in pieces of at
// most kPiece cells, in collection order (the top and bottom rows by dx
// ascending, (dx, -r) before (dx, r); the columns by dy ascending, (-r, dy)
// before (r, dy)); held() is asked only at a segment's end, so the pieces
// do not change what is taken.  RC > 0: a build whose rings end at RC,
// whose passes take at most kPieces pieces (one up to radius 15, where
// the piece loops fold away).
template <int RC, class Plane, class Take, class Held>
__device__ __forceinline__ void ring_walk(const Plane& bp, int ci, int cj, int rmax, Take& take, Held& held) {
  constexpr int kPieces = RC > 0 ? (2 * RC + 1 + kPiece - 1) / kPiece : 1 << 30;
  // ring 0 and ring 1 from the 3x3 block's rows, fetched together
  const uint32_t up = bp.span(cj - 1, ci - 1, 3), mid = bp.span(cj, ci - 1, 3), dn = bp.span(cj + 1, ci - 1, 3);
  if (mid & 2u) take(0, 0);
  if (held()) return;
  for (uint64_t m = interleave(up, dn); m != 0ull; m &= m - 1ull) {
    const int b = __ffsll((long long)m) - 1;
    take((b >> 1) - 1, (b & 1) ? 1 : -1);
  }
  if (held()) return;
  if (mid & 1u) take(-1, 0);
  if (mid & 4u) take(1, 0);
  if (held()) return;
#pragma unroll 1
  for (int r = 2; r <= rmax; ++r) {
    const int n = 2 * r + 1;
    for (int pc = 0; pc < kPieces && pc * kPiece < n; ++pc) {
      const int p0 = pc * kPiece;
      const int w = min(kPiece, n - p0);
      const uint32_t top = bp.span(cj - r, ci - r + p0, w), bot = bp.span(cj + r, ci - r + p0, w);
      for (uint64_t m = interleave(top, bot); m != 0ull; m &= m - 1ull) {
        const int b = __ffsll((long long)m) - 1;
        take(p0 + (b >> 1) - r, (b & 1) ? r : -r);
      }
    }
    if (held()) return;
    for (int pc = 0; pc < kPieces && pc * kPiece < n - 2; ++pc) {
      const int p0 = pc * kPiece;
      const int h = min(kPiece, n - 2 - p0);
      uint32_t left = 0u, right = 0u;
#pragma unroll 4
      for (int k = 0; k < h; ++k) {
        const uint32_t e = bp.ends(cj - r + 1 + p0 + k, ci - r, n);
        left |= (e & 1u) << k;
        right |= (e >> 1) << k;
      }
      for (uint64_t m = interleave(left, right); m != 0ull; m &= m - 1ull) {
        const int b = __ffsll((long long)m) - 1;
        take((b & 1) ? r : -r, p0 + (b >> 1) - r + 1);
      }
    }
    if (held()) return;
  }
}

// ---------------------------------------------------------------------------
// the table solve
// ---------------------------------------------------------------------------

// A flat index of a lattice table as the plain version's gather takes it:
// a negative index counts from the end (torch indexing); clamped into the
// table for memory safety.
__device__ __forceinline__ long long table_index(long long idx, long long size) {
  if (idx < 0) idx += size;
  return idx < 0 ? 0 : (idx >= size ? size - 1 : idx);
}

__device__ __forceinline__ double sum4(const double (&v)[4]) { return ((v[0] + v[1]) + v[2]) + v[3]; }

// _solve_table for one query: found candidates, slot values v (f64) and
// offsets (dgi, dgj) from the query cell, zero on unfilled slots; the
// tables of radius R (RC where the build is for one radius), gpair
// (4R+1)^2 and gq (2R+1)^2.
template <int RC>
__device__ double table_solve(int found, const double (&v)[4], const long long (&dgi)[4],
                              const long long (&dgj)[4], const double* __restrict__ gpair,
                              const double* __restrict__ gq, int R_run, double pivot_tol) {
  const int R = RC > 0 ? RC : R_run;
  if (found < 4) {
    const int k = found;  // min(found, 4)
    return k > 0 ? sum4(v) / (double)k : __longlong_as_double(0x7ff8000000000000LL);
  }
  double M[5][6];
  const long long Wp = 4LL * R + 1, Wq = 2LL * R + 1;  // gpair's and gq's sides
  const double g0 = __ldg(gpair + 2 * R * Wp + 2 * R) * 1.0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b < a) {
        M[a][b] = M[b][a];
      } else if (b == a) {
        M[a][b] = g0;
      } else {
        const long long idx = (dgj[a] - dgj[b] + 2 * R) * Wp + (dgi[a] - dgi[b] + 2 * R);
        M[a][b] = __ldg(gpair + table_index(idx, Wp * Wp));
      }
    }
    M[a][4] = 1.0;
    const long long idx = (dgj[a] + R) * Wq + (dgi[a] + R);
    M[a][5] = __ldg(gq + table_index(idx, Wq * Wq));
  }
  M[4][0] = 1.0;
  M[4][1] = 1.0;
  M[4][2] = 1.0;
  M[4][3] = 1.0;
  M[4][4] = 0.0;
  M[4][5] = 1.0;
  bool singular = false;
#pragma unroll
  for (int p = 0; p < 5; ++p) {
    const double pivot = M[p][p];
    singular = singular || (fabs(pivot) < pivot_tol);
    const double safe = singular ? 1.0 : pivot;
#pragma unroll
    for (int q = p; q < 6; ++q) M[p][q] = M[p][q] / safe;
#pragma unroll
    for (int rr = 0; rr < 5; ++rr) {
      if (rr == p) continue;
      const double f = M[rr][p];
#pragma unroll
      for (int q = p; q < 6; ++q) M[rr][q] = M[rr][q] - f * M[p][q];
    }
  }
  if (singular) return sum4(v) / 4.0;
  double pred = 0.0;
#pragma unroll
  for (int a = 0; a < 4; ++a) pred = pred + M[a][5] * v[a];
  return pred;
}

// ---------------------------------------------------------------------------
// B13: the dense pass at the query cells
// ---------------------------------------------------------------------------

template <typename T>
struct DenseArgs {
  const T* elev;
  const T* valid;         // !BITS: the walk reads it
  const uint32_t* bits;   // BITS: the walk reads bits_kernel's plane
  int H, W;
  int R;                  // the radius: rings 0 .. R, the tables' side
  const float* res;       // aligned: (2, n) keys, ex then ey; else (2, H*W) planes
  bool aligned;
  const int64_t* flat;    // (n,) query cells, in the plane
  int n;
  const double* gpair;    // SOLVE
  const double* gq;
  double pivot_tol;
  int32_t* found;         // select: (n,)
  uint8_t* tie;           // (n,)
  T* vals;                // select: (4, n)
  int64_t* dgi;           // select: (4, n)
  int64_t* dgj;
  double* pred;           // SOLVE: (n,)
};

template <typename T, bool SOLVE, bool BITS, int RC>
__global__ void __launch_bounds__(kThreads) dense_kernel(const DenseArgs<T> a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int W = a.W;
  const long long hw = (long long)a.H * W;
  // the callers pass cells in the plane; the clamp only keeps reads in it
  const long long cell = min(max((long long)a.flat[i], 0LL), hw - 1);
  const int row = (int)(cell / W);
  const int col = (int)(cell - (long long)row * W);
  const long long at = a.aligned ? i : cell;
  const float ex = a.res[at];
  const float ey = a.res[(a.aligned ? (long long)a.n : hw) + at];

  float d2[5], tk[5];
  int sx[5], sy[5];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    d2[s] = __int_as_float(0x7f800000);  // +inf
    tk[s] = 0.f;
    sx[s] = 0;
    sy[s] = 0;
  }
  int count = 0;
  auto take = [&](int dx, int dy) {
    const float fx = (float)dx + 0.5f;
    const float fy = (float)dy + 0.5f;
    const float kd = fx * fx + fy * fy;
    const float t = ex * (float)(2 * dx + 1) + ey * (float)(2 * dy + 1);
    bool lt[5];
#pragma unroll
    for (int s = 0; s < 5; ++s) lt[s] = (kd < d2[s]) || ((kd == d2[s]) && (t > tk[s]));
    // slot s takes slot s-1's entry where the insert lies above it, the
    // candidate where the insert is at s (from the bottom up: each read
    // sees the old slot above)
#pragma unroll
    for (int s = 4; s >= 1; --s) {
      if (lt[s - 1]) {
        d2[s] = d2[s - 1];
        tk[s] = tk[s - 1];
        sx[s] = sx[s - 1];
        sy[s] = sy[s - 1];
      } else if (lt[s]) {
        d2[s] = kd;
        tk[s] = t;
        sx[s] = dx;
        sy[s] = dy;
      }
    }
    if (lt[0]) {
      d2[0] = kd;
      tk[0] = t;
      sx[0] = dx;
      sy[0] = dy;
    }
    ++count;
  };
  auto held = [&]() { return count >= 4; };
  const int rmax = RC > 0 ? RC : last_ring(col, row, a.H, W, a.R);
  if constexpr (BITS)
    ring_walk<RC>(BitPlane{a.bits, a.H, W}, col, row, rmax, take, held);
  else
    ring_walk<RC>(ValuePlane<T>{a.valid, a.H, W}, col, row, rmax, take, held);

  a.tie[i] = (d2[3] == d2[4]) && (tk[3] == tk[4]) && isfinite(d2[4]);
  const int k = count < 4 ? count : 4;
  T v[4];
  long long dgi[4], dgj[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const bool filled = s < k;
    dgi[s] = filled ? sx[s] : 0;
    dgj[s] = filled ? sy[s] : 0;
    // a filled slot lies in the grid: the plain version's clamp is a no-op
    v[s] = filled ? a.elev[(long long)(row + sy[s]) * W + (col + sx[s])] : (T)0;
  }
  if constexpr (SOLVE) {
    double v64[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) v64[s] = (double)v[s];
    a.pred[i] = table_solve<RC>(count, v64, dgi, dgj, a.gpair, a.gq, a.R, a.pivot_tol);
  } else {
    a.found[i] = count;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      a.vals[s * (long long)a.n + i] = v[s];
      a.dgi[s * (long long)a.n + i] = dgi[s];
      a.dgj[s * (long long)a.n + i] = dgj[s];
    }
  }
}

// ---------------------------------------------------------------------------
// B14: the strict ring selection
// ---------------------------------------------------------------------------

template <typename T>
struct RingArgs {
  const T* elev;
  const T* valid;         // !BITS: the walk reads it
  const uint32_t* bits;   // BITS: the walk reads bits_kernel's plane
  int H, W;
  int R;                  // the radius: rings 0 .. R, the tables' side
  const int64_t* ci;      // (n,) anchors
  const int64_t* cj;
  int n;
  const int32_t* variant; // KEY 0: (n,) variants, f32 keys (ex, ey)
  const void* k0;         // KEY 0: f32 ex; KEY 1: f64 x
  const void* k1;
  const int64_t* qcol;    // SOLVE: (n,) the query cells
  const int64_t* qrow;
  const double* gpair;
  const double* gq;
  double pivot_tol;
  int32_t* found;         // select: (n,), (n, 4) slots
  T* sel_val;
  int32_t* sel_gi;
  int32_t* sel_gj;
  double* pred;           // SOLVE: (n,)
};

// An entry's key: KEY 0 (d2, T), KEY 1 the f64 distance in q.
template <int KEY>
struct Key {
  float d, t;
};
template <>
struct Key<1> {
  double q;
};

// a strictly before b in the passes' order (KEY 0: d2 ascending, then T
// descending; KEY 1: the distance ascending); neither a NaN
__device__ __forceinline__ bool before(const Key<0>& a, const Key<0>& b) {
  return a.d < b.d || (a.d == b.d && a.t > b.t);
}
__device__ __forceinline__ bool before(const Key<1>& a, const Key<1>& b) { return a.q < b.q; }
__device__ __forceinline__ bool same(const Key<0>& a, const Key<0>& b) { return a.d == b.d && a.t == b.t; }
__device__ __forceinline__ bool same(const Key<1>& a, const Key<1>& b) { return a.q == b.q; }

// A lane offset as B14 keeps it: a byte in a build for a radius below 128.
template <int RC>
using Offset = typename std::conditional<(RC > 0 && RC < 128), int8_t, int>::type;

template <typename T, int KEY, bool SOLVE, bool BITS, int RC>
__global__ void __launch_bounds__(kThreads) ring_kernel(const RingArgs<T> a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const long long ci = a.ci[i];
  const long long cj = a.cj[i];
  int ax = 0, ay = 0;
  float ex = 0.f, ey = 0.f;
  double x = 0.0, y = 0.0;
  if constexpr (KEY == 0) {
    const int v = a.variant[i];
    ax = -(v >> 1);
    ay = -(v & 1);
    ex = ((const float*)a.k0)[i];
    ey = ((const float*)a.k1)[i];
  } else {
    x = ((const double*)a.k0)[i];
    y = ((const double*)a.k1)[i];
  }

  // Entries 0-3: the list's positions 0-3.  Entries 4-7: of the positions
  // from 4 on, the non-NaN ones least by (key, position), sorted, nrest of
  // them.  pos: an entry's current position (the swaps move them).
  Key<KEY> key[8];
  Offset<RC> lx[8], ly[8];  // lane offsets, |dx|, |dy| <= R
  int pos[8];
  bool nan0[4];             // a front entry whose key is NaN (never picked)
  int len = 0, nrest = 0;
  bool any_nan = false;     // KEY 1: a NaN distance in the list
  float nan_d2 = __int_as_float(0x7f800000);  // KEY 0: the least d2 of an entry with a NaN T
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    lx[e] = 0;
    ly[e] = 0;
    pos[e] = e;
    if constexpr (KEY == 0) {
      key[e].d = 0.f;
      key[e].t = 0.f;
    } else {
      key[e].q = 0.0;
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) nan0[e] = false;

  auto take = [&](int dx, int dy) {
    Key<KEY> k;
    bool is_nan;
    if constexpr (KEY == 0) {
      const float fx = (float)(dx + ax) + 0.5f;
      const float fy = (float)(dy + ay) + 0.5f;
      k.d = fx * fx + fy * fy;  // quarter-integers: never NaN
      k.t = ex * (float)(2 * (dx + ax) + 1) + ey * (float)(2 * (dy + ay) + 1);
      is_nan = k.t != k.t;
      if (is_nan) nan_d2 = fminf(nan_d2, k.d);
    } else {
      const double di = ((double)(ci + dx) + 0.5) - x;
      const double dj = ((double)(cj + dy) + 0.5) - y;
      k.q = sqrt(di * di + dj * dj);
      is_nan = k.q != k.q;
      any_nan = any_nan || is_nan;
    }
    if (len < 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (len == e) {
          key[e] = k;
          lx[e] = (Offset<RC>)dx;
          ly[e] = (Offset<RC>)dy;
          nan0[e] = is_nan;
        }
      }
    } else if (!is_nan) {
      // B13's insert over entries 4-7: an empty slot takes anything, an
      // equal key files below the earlier one
      bool lt[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) lt[s] = s >= nrest || before(k, key[4 + s]);
#pragma unroll
      for (int s = 3; s >= 0; --s) {
        if (s > 0 && lt[s - 1]) {
          key[4 + s] = key[3 + s];
          lx[4 + s] = lx[3 + s];
          ly[4 + s] = ly[3 + s];
          pos[4 + s] = pos[3 + s];
        } else if (lt[s]) {
          key[4 + s] = k;
          lx[4 + s] = (Offset<RC>)dx;
          ly[4 + s] = (Offset<RC>)dy;
          pos[4 + s] = len;
        }
      }
      nrest = nrest < 4 ? nrest + 1 : 4;
    }
    ++len;
  };
  auto held = [&]() { return len >= 4; };
  // a lane (ci + dx, cj + dy), |dx|, |dy| <= R, lies in the grid only for
  // an anchor within R of it, where the int64 adds cannot wrap (and, R <=
  // 2^20, neither can the walk's int ones)
  const long long R = RC > 0 ? RC : a.R;
  if (ci >= -R && ci <= (long long)a.W - 1 + R && cj >= -R && cj <= (long long)a.H - 1 + R) {
    const int rmax = RC > 0 ? RC : last_ring(ci, cj, a.H, a.W, a.R);
    if constexpr (BITS)
      ring_walk<RC>(BitPlane{a.bits, a.H, a.W}, (int)ci, (int)cj, rmax, take, held);
    else
      ring_walk<RC>(ValuePlane<T>{a.valid, a.H, a.W}, (int)ci, (int)cj, rmax, take, held);
  }

  T v[4];
  long long gi[4], gj[4];
  bool stop = KEY == 1 && any_nan;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    // the least entry by (key, current position) among positions >= m
    int best = -1, bpos = 0, bx = 0, by = 0;
    Key<KEY> bk = key[0];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const bool live = e < 4 ? (e < len && !nan0[e]) : (e - 4 < nrest);
      if (live && pos[e] >= m &&
          (best < 0 || before(key[e], bk) || (same(key[e], bk) && pos[e] < bpos))) {
        best = e;
        bk = key[e];
        bpos = pos[e];
        bx = lx[e];
        by = ly[e];
      }
    }
    if constexpr (KEY == 0) {
      // an entry with a NaN T among the least d2 compared: no pick
      stop = stop || best < 0 || nan_d2 <= bk.d;
    } else {
      stop = stop || best < 0;
    }
    if (!stop) {
      gi[m] = ci + bx;
      gj[m] = cj + by;
      v[m] = a.elev[gj[m] * a.W + gi[m]] + (T)0;
      // swap positions m and bpos
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e == best)
          pos[e] = m;
        else if (pos[e] == m)
          pos[e] = bpos;
      }
    } else {
      gi[m] = 0;
      gj[m] = 0;
      v[m] = (T)0;
    }
  }

  if constexpr (SOLVE) {
    const int k = len < 4 ? len : 4;
    const long long qc = a.qcol[i], qr = a.qrow[i];
    double v64[4];
    long long dgi[4], dgj[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      v64[s] = (double)v[s];
      // the slot's gi as the plain version's int32 selection holds it
      dgi[s] = s < k ? (long long)(int32_t)gi[s] - qc : 0;
      dgj[s] = s < k ? (long long)(int32_t)gj[s] - qr : 0;
    }
    a.pred[i] = table_solve<RC>(len, v64, dgi, dgj, a.gpair, a.gq, a.R, a.pivot_tol);
  } else {
    a.found[i] = len;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      a.sel_val[4 * i + s] = v[s];
      a.sel_gi[4 * i + s] = (int32_t)gi[s];
      a.sel_gj[4 * i + s] = (int32_t)gj[s];
    }
  }
}

unsigned blocks_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

// bits null: the walk reads valid; else bits_kernel's plane of valid into
// bits (ceil(H * W / 32) words) first
template <typename T>
void launch_bits(const void* valid, int H, int W, void* bits, cudaStream_t st) {
  if (bits == nullptr) return;
  const long long cells = (long long)H * W;
  const bool vec = reinterpret_cast<uintptr_t>(valid) % 16 == 0;
  bits_kernel<T><<<blocks_for((cells + 3) / 4), kThreads, 0, st>>>((const T*)valid, cells, vec, (uint32_t*)bits);
}

template <typename T, bool SOLVE, int RC>
void dense_at(const DenseArgs<T>& a, cudaStream_t st) {
  if (a.bits != nullptr)
    dense_kernel<T, SOLVE, true, RC><<<blocks_for(a.n), kThreads, 0, st>>>(a);
  else
    dense_kernel<T, SOLVE, false, RC><<<blocks_for(a.n), kThreads, 0, st>>>(a);
}

template <typename T, bool SOLVE>
void dense_on(const DenseArgs<T>& a, cudaStream_t st) {
  if (a.R == kBuiltRadius)
    dense_at<T, SOLVE, kBuiltRadius>(a, st);
  else
    dense_at<T, SOLVE, 0>(a, st);
}

template <typename T>
int launch_dense(const void* elev, const void* valid, int H, int W, int R, const void* res, int aligned,
                 const void* flat, int n, const void* gpair, const void* gq, double pivot_tol, void* found, void* tie,
                 void* vals, void* dgi, void* dgj, void* pred, void* bits, cudaStream_t st) {
  launch_bits<T>(valid, H, W, bits, st);
  DenseArgs<T> a;
  a.elev = (const T*)elev;
  a.valid = (const T*)valid;
  a.bits = (const uint32_t*)bits;
  a.H = H;
  a.W = W;
  a.R = R;
  a.res = (const float*)res;
  a.aligned = aligned != 0;
  a.flat = (const int64_t*)flat;
  a.n = n;
  a.gpair = (const double*)gpair;
  a.gq = (const double*)gq;
  a.pivot_tol = pivot_tol;
  a.found = (int32_t*)found;
  a.tie = (uint8_t*)tie;
  a.vals = (T*)vals;
  a.dgi = (int64_t*)dgi;
  a.dgj = (int64_t*)dgj;
  a.pred = (double*)pred;
  if (pred != nullptr)
    dense_on<T, true>(a, st);
  else
    dense_on<T, false>(a, st);
  return (int)cudaGetLastError();
}

template <typename T, int KEY, bool SOLVE, int RC>
void ring_at(const RingArgs<T>& a, cudaStream_t st) {
  if (a.bits != nullptr)
    ring_kernel<T, KEY, SOLVE, true, RC><<<blocks_for(a.n), kThreads, 0, st>>>(a);
  else
    ring_kernel<T, KEY, SOLVE, false, RC><<<blocks_for(a.n), kThreads, 0, st>>>(a);
}

template <typename T, int KEY, bool SOLVE>
void ring_on(const RingArgs<T>& a, cudaStream_t st) {
  if (a.R == kBuiltRadius)
    ring_at<T, KEY, SOLVE, kBuiltRadius>(a, st);
  else
    ring_at<T, KEY, SOLVE, 0>(a, st);
}

template <typename T>
int launch_ring(const void* elev, const void* valid, int H, int W, int R, const void* ci, const void* cj, int n,
                int key, const void* variant, const void* k0, const void* k1, const void* qcol, const void* qrow,
                const void* gpair, const void* gq, double pivot_tol, void* found, void* sel_val, void* sel_gi,
                void* sel_gj, void* pred, void* bits, cudaStream_t st) {
  launch_bits<T>(valid, H, W, bits, st);
  RingArgs<T> a;
  a.elev = (const T*)elev;
  a.valid = (const T*)valid;
  a.bits = (const uint32_t*)bits;
  a.H = H;
  a.W = W;
  a.R = R;
  a.ci = (const int64_t*)ci;
  a.cj = (const int64_t*)cj;
  a.n = n;
  a.variant = (const int32_t*)variant;
  a.k0 = k0;
  a.k1 = k1;
  a.qcol = (const int64_t*)qcol;
  a.qrow = (const int64_t*)qrow;
  a.gpair = (const double*)gpair;
  a.gq = (const double*)gq;
  a.pivot_tol = pivot_tol;
  a.found = (int32_t*)found;
  a.sel_val = (T*)sel_val;
  a.sel_gi = (int32_t*)sel_gi;
  a.sel_gj = (int32_t*)sel_gj;
  a.pred = (double*)pred;
  if (key == 1)
    ring_on<T, 1, false>(a, st);
  else if (pred != nullptr)
    ring_on<T, 0, true>(a, st);
  else
    ring_on<T, 0, false>(a, st);
  return (int)cudaGetLastError();
}

// every build the wrappers launch, in auvtpu_exact_attributes' order
#define AUVTPU_EXACT_BUILDS(RC)                                  \
  (const void*)dense_kernel<float, false, true, RC>,             \
  (const void*)dense_kernel<float, true, true, RC>,              \
  (const void*)ring_kernel<float, 0, false, true, RC>,           \
  (const void*)ring_kernel<float, 0, true, true, RC>,            \
  (const void*)ring_kernel<float, 1, false, true, RC>,           \
  (const void*)dense_kernel<double, false, true, RC>,            \
  (const void*)dense_kernel<double, true, true, RC>,             \
  (const void*)ring_kernel<double, 0, false, true, RC>,          \
  (const void*)ring_kernel<double, 0, true, true, RC>,           \
  (const void*)ring_kernel<double, 1, false, true, RC>,          \
  (const void*)dense_kernel<float, false, false, RC>,            \
  (const void*)dense_kernel<float, true, false, RC>,             \
  (const void*)ring_kernel<float, 0, false, false, RC>,          \
  (const void*)ring_kernel<float, 0, true, false, RC>,           \
  (const void*)ring_kernel<float, 1, false, false, RC>,          \
  (const void*)dense_kernel<double, false, false, RC>,           \
  (const void*)dense_kernel<double, true, false, RC>,            \
  (const void*)ring_kernel<double, 0, false, false, RC>,         \
  (const void*)ring_kernel<double, 0, true, false, RC>,          \
  (const void*)ring_kernel<double, 1, false, false, RC>
const void* const kBuilds[] = {
    (const void*)bits_kernel<float>,
    (const void*)bits_kernel<double>,
    // per radius build (kBuiltRadius, then the runtime radius), per walk
    // (the bit plane, then valid) and per grid dtype: B13 (select, solve)
    // and B14 (KEY 0, KEY 0 with the solve, KEY 1)
    AUVTPU_EXACT_BUILDS(kBuiltRadius),
    AUVTPU_EXACT_BUILDS(0),
};
#undef AUVTPU_EXACT_BUILDS

}  // namespace

extern "C" {

// B13.  elev, valid: (H, W) f32 (f64 = 0) or f64 (f64 = 1), contiguous;
// R: the radius, 1 <= R <= kMaxRadius; res: aligned 1, the (2, n) f32 keys of the queries, every query aligned
// on its own cell; aligned 0, the (2, H*W) f32 residue planes; flat: (n,)
// int64 query cells in [0, H*W); bits: null (the walk reads valid) or
// ceil(H * W / 32) int32 scratch for the bit plane (built first).  pred
// null: the selection, found (n,) int32, tie (n,) uint8, vals (4, n) in
// the grid's dtype, dgi and dgj (4, n) int64.  pred (n,) f64: the table
// solve with gpair ((4R+1)^2 f64) and gq ((2R+1)^2 f64), and tie; found,
// vals, dgi and dgj unused.  Returns the launches' cudaError_t.
int auvtpu_exact_dense(int f64, const void* elev, const void* valid, int H, int W, int R, const void* res,
                       int aligned, const void* flat, int n, const void* gpair, const void* gq, double pivot_tol,
                       void* found, void* tie, void* vals, void* dgi, void* dgj, void* pred, void* bits,
                       void* stream) {
  if (H < 1 || W < 1 || R < 1 || R > kMaxRadius || n < 0 || (pred != nullptr && (gpair == nullptr || gq == nullptr)) ||
      (pred == nullptr && (found == nullptr || vals == nullptr || dgi == nullptr || dgj == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return f64 ? launch_dense<double>(elev, valid, H, W, R, res, aligned, flat, n, gpair, gq, pivot_tol, found, tie,
                                    vals, dgi, dgj, pred, bits, st)
             : launch_dense<float>(elev, valid, H, W, R, res, aligned, flat, n, gpair, gq, pivot_tol, found, tie,
                                   vals, dgi, dgj, pred, bits, st);
}

// B14.  elev, valid, R, bits as for B13; ci, cj: (n,) int64 anchors.  key 0:
// variant (n,) int32 and k0, k1 the f32 keys (ex, ey); key 1: k0, k1 the
// f64 grid coordinates (x, y).  pred null: found (n,) int32, sel_val
// (n, 4) in the grid's dtype, sel_gi and sel_gj (n, 4) int32.  pred (n,)
// f64 (key 0 only): the table solve with offsets from the query cells
// (qcol, qrow) (n,) int64.  Returns the launches' cudaError_t.
int auvtpu_exact_ring(int f64, const void* elev, const void* valid, int H, int W, int R, const void* ci,
                      const void* cj, int n, int key, const void* variant, const void* k0, const void* k1,
                      const void* qcol, const void* qrow, const void* gpair, const void* gq, double pivot_tol,
                      void* found, void* sel_val, void* sel_gi, void* sel_gj, void* pred, void* bits,
                      void* stream) {
  if (H < 1 || W < 1 || R < 1 || R > kMaxRadius || n < 0 || (key != 0 && key != 1) ||
      (key == 0 && variant == nullptr) ||
      (pred != nullptr && (key != 0 || qcol == nullptr || qrow == nullptr || gpair == nullptr || gq == nullptr)) ||
      (pred == nullptr && (found == nullptr || sel_val == nullptr || sel_gi == nullptr || sel_gj == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return f64 ? launch_ring<double>(elev, valid, H, W, R, ci, cj, n, key, variant, k0, k1, qcol, qrow, gpair, gq,
                                   pivot_tol, found, sel_val, sel_gi, sel_gj, pred, bits, st)
             : launch_ring<float>(elev, valid, H, W, R, ci, cj, n, key, variant, k0, k1, qcol, qrow, gpair, gq,
                                  pivot_tol, found, sel_val, sel_gi, sel_gj, pred, bits, st);
}

// The resources of build `which` (kBuilds' order) on the current card:
// registers a thread, local bytes a thread, resident blocks an SM at
// kThreads a block.  For the resource report of chip_smoke.py.
int auvtpu_exact_attributes(int which, int* out) {
  if (which < 0 || which >= (int)(sizeof(kBuilds) / sizeof(kBuilds[0]))) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kBuilds[which]);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kBuilds[which], kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  return 0;
}

const char* auvtpu_exact_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
