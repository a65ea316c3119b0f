// Exact mode's selections for Hopper (sm_90a): the two-tier dense pass at
// the query cells with its f64 table solve (B13) and the strict ring
// selection (B14).  Plain C interface, loaded with ctypes by
// auvtpu_torch/kernels/exact_select.py.
//
// Replaces no Pallas kernel: the JAX package runs exact mode as jitted XLA
// programs, and the port ran them as eager torch loops:
//   dense_kernel<T, SOLVE>     <- auvtpu/ops/exact_fast.py::_dense_select
//                                 (the lax.while_loop over the 441 lanes of
//                                 the whole plane), ::_extract_q and, with
//                                 SOLVE, ::_extract_solve_table (B13; the
//                                 port's plain versions are
//                                 ops/exact_fast.py _dense_select,
//                                 _extract_q and _solve_table)
//   ring_kernel<T, KEY, SOLVE> <- auvtpu/ops/exact.py::_select_chunk (KEY 0,
//                                 cell-aligned) and ::_select_chunk_scattered
//                                 (KEY 1), the (N, 441) lane gathers with
//                                 the cumsum cutoff and four amin/amax swap
//                                 passes; SOLVE adds the table solve of the
//                                 two-tier path's escalated cells (B14; the
//                                 plain versions are ops/exact.py
//                                 _select_chunk, _select_chunk_scattered
//                                 and _swap_passes, then _solve_table)
//
// What they compute.  Both walk the candidate lanes of one anchor cell in
// the reference's collection order (tables.ring_offsets, GridH.cpp:24-118):
// the centre, then per ring r the top/bottom pass (dx = -r..r, (dx, -r)
// before (dx, r)) and the left/right pass (dy = -r+1..r-1, (-r, dy) before
// (r, dy)); each pass is a segment.  A lane is a candidate where it lies in
// the grid and valid > 0.5; the walk ends at the first segment end where 4
// or more candidates are held (GridH.cpp:82,115), so a candidate is taken
// exactly while its segment started with fewer than 4 held (the plain
// versions' `cum_prev < 4`, the dense pass's `stopped`).  The lanes are
// generated by the walk itself, not read from a table: the order is three
// nested loops, and no thread reads memory for it.
//
// B13, per query cell (the query's row * W + col, clipped to the plane, as
// the plain version reads its planes): the residues (ex, ey) of the cell
// from the two f32 planes that the wrapper scatters the aligned queries'
// keys into (zero elsewhere: a query on a cell no aligned query holds reads
// 0, as in the plain version); per candidate the variant-0 key d2 = (dx +
// 0.5)^2 + (dy + 0.5)^2 (exact in f32) and T = ex (2 dx + 1) + ey (2 dy + 1)
// (two products and a sum, each rounded once: -fmad=false); a top-5 list in
// registers kept sorted by (d2 ascending, T descending) with the plain
// version's insert: a candidate strictly better than slot s takes the first
// such slot, the ones below shift down, the fifth falls out; an equal key
// files below the earlier one.  The count is every candidate taken.  Then
// tie = key(4th) == key(5th) with a finite 5th, and the first min(count,
// 4) slots as offsets (dgi, dgj) from the cell and values (zero on unfilled
// slots), as _extract_q gives them; with SOLVE instead the f64 prediction of
// _solve_table (below).
//
// B14, per query: its anchor (ci, cj) (int64, the plain version's
// arithmetic: an anchor far outside the grid wraps as torch's int64 adds
// do) and the candidates in collection order into a thread-local list: at
// most 3 held before the last segment and that segment's lanes, 2 (2R + 1)
// = 42 at R = 10, so 45 entries.  Keys: KEY 0 the variant's d2 and T (the
// anchor variant v shifts the lane by (-(v >> 1), -(v & 1)); d2 and T as in
// B13); KEY 1 the f64 distance sqrt(di*di + dj*dj) with di = (gi + 0.5) - x,
// three rounded operations and IEEE sqrt, as the reference computes it.
// Then GridH.cpp:123-140's four passes over the list: pass m takes the
// minimum key among positions >= m (KEY 0: the least d2, then the largest
// T among those), the lowest position on a tie, and swaps positions m and
// that one (the plain version's swap of the position plane).  A NaN among
// the keys a pass compares makes its minimum NaN in the plain version's
// amin/amax, so that pass takes nothing; so does the kernel.  Slot m holds
// the pick's value + 0 (the plain version's one-hot sum, which turns -0
// into +0) and its (gi, gj) as int32, zeros where nothing was picked;
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
// What bounds them on the H100.  B13 reads per query its cell index (8 B),
// its two residues (8 B), the validity of the lanes it walks (9-25 at the
// stand-in's 10 % removal, 441 where a cell never holds 4) and 4 values,
// and writes 45 B (select) or 9 B (solve): bytes, not operations (~10 f32
// operations a lane; ~200 f64 ones for the solve).  Against the plain
// version's ~20 whole-plane torch ops a lane on (5, H, W) slot planes, it
// reads the planes only at the query cells (501,137 threads, not 5M
// cells), keeps the top-5 in registers and ends each thread at its own
// stop.  B14 reads the same lanes per query and no (N, 441) temporaries;
// the 45-entry list is in local memory (L1), and its 4 passes compare at
// most 4 x 45 keys.  The tables of the solve go through the read-only
// cache (__ldg, 17 KB).  One thread per query in blocks of 256; threads of
// a warp walk the same lane together until they stop.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kR = 10;            // the callers' radius; the wrapper refuses any other
constexpr int kMaxList = 45;      // 3 held + the longest segment, 2 (2 kR + 1)
constexpr int kWp = 4 * kR + 1;   // gpair's side
constexpr int kWq = 2 * kR + 1;   // gq's side
constexpr int kThreads = 256;

// The lanes of one anchor in collection order: lane(dx, dy) for each,
// seg_end() after the last lane of each segment; the walk ends where
// seg_end() returns true.
template <class Lane, class SegEnd>
__device__ __forceinline__ void ring_walk(Lane& lane, SegEnd& seg_end) {
  lane(0, 0);
  if (seg_end()) return;
#pragma unroll 1
  for (int r = 1; r <= kR; ++r) {
#pragma unroll 1
    for (int dx = -r; dx <= r; ++dx) {
      lane(dx, -r);
      lane(dx, r);
    }
    if (seg_end()) return;
#pragma unroll 1
    for (int dy = -r + 1; dy < r; ++dy) {
      lane(-r, dy);
      lane(r, dy);
    }
    if (seg_end()) return;
  }
}

// A flat index of a lattice table as the plain version's gather takes it:
// a negative index counts from the end (torch indexing); clamped into the
// table for memory safety.
__device__ __forceinline__ long long table_index(long long idx, long long size) {
  if (idx < 0) idx += size;
  return idx < 0 ? 0 : (idx >= size ? size - 1 : idx);
}

__device__ __forceinline__ double sum4(const double (&v)[4]) { return ((v[0] + v[1]) + v[2]) + v[3]; }

// _solve_table for one query: found candidates, slot values v (f64) and
// offsets (dgi, dgj) from the query cell, zero on unfilled slots.
__device__ double table_solve(int found, const double (&v)[4], const long long (&dgi)[4],
                              const long long (&dgj)[4], const double* __restrict__ gpair,
                              const double* __restrict__ gq, double pivot_tol) {
  if (found < 4) {
    const int k = found;  // min(found, 4)
    return k > 0 ? sum4(v) / (double)k : __longlong_as_double(0x7ff8000000000000LL);
  }
  double M[5][6];
  const double g0 = __ldg(gpair + 2 * kR * kWp + 2 * kR) * 1.0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b < a) {
        M[a][b] = M[b][a];
      } else if (b == a) {
        M[a][b] = g0;
      } else {
        const long long idx = (dgj[a] - dgj[b] + 2 * kR) * kWp + (dgi[a] - dgi[b] + 2 * kR);
        M[a][b] = __ldg(gpair + table_index(idx, (long long)kWp * kWp));
      }
    }
    M[a][4] = 1.0;
    const long long idx = (dgj[a] + kR) * kWq + (dgi[a] + kR);
    M[a][5] = __ldg(gq + table_index(idx, (long long)kWq * kWq));
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
  const T* valid;
  int H, W;
  const float* res;       // (2, H*W): the ex plane, then the ey plane
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

template <typename T, bool SOLVE>
__global__ void __launch_bounds__(kThreads) dense_kernel(const DenseArgs<T> a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const long long hw = (long long)a.H * a.W;
  // the callers pass cells in the plane; the clamp only keeps reads in it
  const long long cell = min(max((long long)a.flat[i], 0LL), hw - 1);
  const int row = (int)(cell / a.W);
  const int col = (int)(cell - (long long)row * a.W);
  const float ex = a.res[cell];
  const float ey = a.res[hw + cell];

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
  auto lane = [&](int dx, int dy) {
    const int gi = col + dx;
    const int gj = row + dy;
    if (gi < 0 || gi >= a.W || gj < 0 || gj >= a.H) return;
    if (!(a.valid[(long long)gj * a.W + gi] > (T)0.5)) return;
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
  auto seg_end = [&]() { return count >= 4; };
  ring_walk(lane, seg_end);

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
    v[s] = filled ? a.elev[(long long)(row + sy[s]) * a.W + (col + sx[s])] : (T)0;
  }
  if constexpr (SOLVE) {
    double v64[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) v64[s] = (double)v[s];
    a.pred[i] = table_solve(count, v64, dgi, dgj, a.gpair, a.gq, a.pivot_tol);
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
  const T* valid;
  int H, W;
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

template <typename T, int KEY, bool SOLVE>
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

  // the list, in position order: KEY 0 keys (kd, kt), KEY 1 key kq
  float kd[KEY == 0 ? kMaxList : 1], kt[KEY == 0 ? kMaxList : 1];
  double kq[KEY == 1 ? kMaxList : 1];
  int8_t lx[kMaxList], ly[kMaxList];
  int len = 0;
  auto lane = [&](int dx, int dy) {
    // int64 as the plain version adds (two's complement wrap)
    const long long gi = (long long)((unsigned long long)ci + (unsigned long long)(long long)dx);
    const long long gj = (long long)((unsigned long long)cj + (unsigned long long)(long long)dy);
    if (gi < 0 || gi >= a.W || gj < 0 || gj >= a.H) return;
    if (!(a.valid[gj * a.W + gi] > (T)0.5)) return;
    if (len >= kMaxList) return;  // unreachable: the cutoff bounds the list
    if constexpr (KEY == 0) {
      const float fx = (float)(dx + ax) + 0.5f;
      const float fy = (float)(dy + ay) + 0.5f;
      kd[len] = fx * fx + fy * fy;
      kt[len] = ex * (float)(2 * (dx + ax) + 1) + ey * (float)(2 * (dy + ay) + 1);
    } else {
      const double di = ((double)gi + 0.5) - x;
      const double dj = ((double)gj + 0.5) - y;
      kq[len] = sqrt(di * di + dj * dj);
    }
    lx[len] = (int8_t)dx;
    ly[len] = (int8_t)dy;
    ++len;
  };
  auto seg_end = [&]() { return len >= 4; };
  ring_walk(lane, seg_end);

  T v[4];
  long long gi[4], gj[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    int kpos = -1;
    if constexpr (KEY == 0) {
      // the least d2 among positions >= m (a NaN makes it NaN: no pick)
      float mn = 0.f;
      bool any = false, nan = false;
      for (int p = m; p < len; ++p) {
        const float d = kd[p];
        if (d != d) {
          nan = true;
        } else if (!any || d < mn) {
          mn = d;
          any = true;
        }
      }
      // then the largest T among those, the lowest position on a tie
      float mx = 0.f;
      bool nan2 = false;
      if (!nan) {
        for (int p = m; p < len; ++p) {
          if (!(kd[p] == mn)) continue;
          const float t = kt[p];
          if (t != t) {
            nan2 = true;
          } else if (kpos < 0 || t > mx) {
            mx = t;
            kpos = p;
          }
        }
      }
      if (nan || nan2) kpos = -1;
    } else {
      double mn = 0.0;
      bool nan = false;
      for (int p = m; p < len; ++p) {
        const double d = kq[p];
        if (d != d) {
          nan = true;
        } else if (kpos < 0 || d < mn) {
          mn = d;
          kpos = p;
        }
      }
      if (nan) kpos = -1;
    }
    if (kpos >= 0) {
      gi[m] = ci + lx[kpos];
      gj[m] = cj + ly[kpos];
      v[m] = a.elev[gj[m] * a.W + gi[m]] + (T)0;
      // swap positions m and kpos
      if constexpr (KEY == 0) {
        const float td = kd[m], tt = kt[m];
        kd[m] = kd[kpos];
        kt[m] = kt[kpos];
        kd[kpos] = td;
        kt[kpos] = tt;
      } else {
        const double tq = kq[m];
        kq[m] = kq[kpos];
        kq[kpos] = tq;
      }
      const int8_t tx = lx[m], ty = ly[m];
      lx[m] = lx[kpos];
      ly[m] = ly[kpos];
      lx[kpos] = tx;
      ly[kpos] = ty;
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
    a.pred[i] = table_solve(len, v64, dgi, dgj, a.gpair, a.gq, a.pivot_tol);
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

unsigned blocks_for(int n) { return (unsigned)((n + kThreads - 1) / kThreads); }

template <typename T>
int launch_dense(const void* elev, const void* valid, int H, int W, const void* res, const void* flat, int n,
                 const void* gpair, const void* gq, double pivot_tol, void* found, void* tie, void* vals,
                 void* dgi, void* dgj, void* pred, cudaStream_t st) {
  DenseArgs<T> a;
  a.elev = (const T*)elev;
  a.valid = (const T*)valid;
  a.H = H;
  a.W = W;
  a.res = (const float*)res;
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
    dense_kernel<T, true><<<blocks_for(n), kThreads, 0, st>>>(a);
  else
    dense_kernel<T, false><<<blocks_for(n), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ring(const void* elev, const void* valid, int H, int W, const void* ci, const void* cj, int n, int key,
                const void* variant, const void* k0, const void* k1, const void* qcol, const void* qrow,
                const void* gpair, const void* gq, double pivot_tol, void* found, void* sel_val, void* sel_gi,
                void* sel_gj, void* pred, cudaStream_t st) {
  RingArgs<T> a;
  a.elev = (const T*)elev;
  a.valid = (const T*)valid;
  a.H = H;
  a.W = W;
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
    ring_kernel<T, 1, false><<<blocks_for(n), kThreads, 0, st>>>(a);
  else if (pred != nullptr)
    ring_kernel<T, 0, true><<<blocks_for(n), kThreads, 0, st>>>(a);
  else
    ring_kernel<T, 0, false><<<blocks_for(n), kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B13.  elev, valid: (H, W) f32 (f64 = 0) or f64 (f64 = 1), contiguous;
// res: (2, H*W) f32 residue planes; flat: (n,) int64 query cells in
// [0, H*W).  pred null: the selection, found (n,) int32, tie (n,) uint8,
// vals (4, n) in the grid's dtype, dgi and dgj (4, n) int64.  pred (n,)
// f64: the table solve with gpair ((4R+1)^2 f64) and gq ((2R+1)^2 f64),
// and tie; found, vals, dgi and dgj unused.  Returns the launch's
// cudaError_t.
int auvtpu_exact_dense(int f64, const void* elev, const void* valid, int H, int W, const void* res,
                       const void* flat, int n, const void* gpair, const void* gq, double pivot_tol, void* found,
                       void* tie, void* vals, void* dgi, void* dgj, void* pred, void* stream) {
  if (H < 1 || W < 1 || n < 0 || (pred != nullptr && (gpair == nullptr || gq == nullptr)) ||
      (pred == nullptr && (found == nullptr || vals == nullptr || dgi == nullptr || dgj == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return f64 ? launch_dense<double>(elev, valid, H, W, res, flat, n, gpair, gq, pivot_tol, found, tie, vals, dgi,
                                    dgj, pred, st)
             : launch_dense<float>(elev, valid, H, W, res, flat, n, gpair, gq, pivot_tol, found, tie, vals, dgi,
                                   dgj, pred, st);
}

// B14.  elev, valid as for B13; ci, cj: (n,) int64 anchors.  key 0:
// variant (n,) int32 and k0, k1 the f32 keys (ex, ey); key 1: k0, k1 the
// f64 grid coordinates (x, y).  pred null: found (n,) int32, sel_val
// (n, 4) in the grid's dtype, sel_gi and sel_gj (n, 4) int32.  pred (n,)
// f64 (key 0 only): the table solve with offsets from the query cells
// (qcol, qrow) (n,) int64.  Returns the launch's cudaError_t.
int auvtpu_exact_ring(int f64, const void* elev, const void* valid, int H, int W, const void* ci, const void* cj,
                      int n, int key, const void* variant, const void* k0, const void* k1, const void* qcol,
                      const void* qrow, const void* gpair, const void* gq, double pivot_tol, void* found,
                      void* sel_val, void* sel_gi, void* sel_gj, void* pred, void* stream) {
  if (H < 1 || W < 1 || n < 0 || (key != 0 && key != 1) || (key == 0 && variant == nullptr) ||
      (pred != nullptr && (key != 0 || qcol == nullptr || qrow == nullptr || gpair == nullptr || gq == nullptr)) ||
      (pred == nullptr && (found == nullptr || sel_val == nullptr || sel_gi == nullptr || sel_gj == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  return f64 ? launch_ring<double>(elev, valid, H, W, ci, cj, n, key, variant, k0, k1, qcol, qrow, gpair, gq,
                                   pivot_tol, found, sel_val, sel_gi, sel_gj, pred, st)
             : launch_ring<float>(elev, valid, H, W, ci, cj, n, key, variant, k0, k1, qcol, qrow, gpair, gq,
                                  pivot_tol, found, sel_val, sel_gi, sel_gj, pred, st);
}

const char* auvtpu_exact_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
