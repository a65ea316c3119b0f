// k-nearest selection for scattered queries over stencil packs, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// auvtpu_torch/kernels/scattered_select.py.
//
// Replaces three TPU kernels, two of them with the XLA epilogues after them,
// with six kernels:
//   select_kernel<P>                 <- pallas/valid_select.py::_sel_kernel
//                                       (B5: valid_select_t)
//   select_krige_kernel<M, P, MODEL> <- _sel_kernel + the XLA row epilogue
//                                       valid_select.py::_kriging_rows_epilogue
//                                       (B11: pallas_kriging_valid,
//                                       pallas_packed_kriging_t)
//   idw_select_kernel<M, P, VEC>     <- pallas/valid_select.py::_idw_kernel
//                                       with _prologue and the epilogue of
//                                       _idw_launch (B6: pallas_packed_idw_t)
//   window_select_kernel<M, K, VEC>  <- pallas/scattered_select.py::_make_select_kernel
//                                       (B7: pallas_window_select)
//   window_krige_kernel<M, P, MODEL> <- _make_select_kernel + the XLA solve
//                                       ops/packs.py::kriging_from_select
//                                       (B12: pallas_packed_kriging)
//   window_idw_kernel<M, P, K>       <- _make_select_kernel + the XLA IDW
//                                       ops/packs.py::idw_from_select
//                                       (B15: pallas_packed_idw)
// The TPU kernels differ in layout only: (P, N) transposed stencils and
// (N, 128) pack rows with a one-hot sub-block pick are the TPU's ways around
// its gather unit.  On Hopper each query is one thread that reads its own
// contiguous pack floats.
//
// What they compute.  Per query: the taps of its centre cell's pack row (a
// sentinel >= 0.5e30 marks an invalid or out-of-grid tap); the squared
// distance d2 = ((dx+half)-fx)^2 + ((dy+half)-fy)^2 to each valid tap, in
// exactly that op order (valid_select.py:84-87, scattered_select.py:83-85),
// 3e30 at invalid taps; then k passes of min-extract, each taking the lowest
// table index (collection order) on a tie, as the lowest sublane or lane
// does on the TPU.  A pass whose minimum is not below 1.5e30 takes no slot
// and knocks nothing out (a NaN query: its d2 are NaN, no minimum of them is
// below 1.5e30).  An empty slot carries value 0 and code 0 (the TPU
// kernels' all-zero one-hot); the kriging epilogue relies on it
// (fb = sum(vals)/max(found,1)).
//   B5: rows (1+2k[+k][+1], N) = cnt, k values, (k d2), k codes,
//       (resolved).  The code table is dy-major (valid_select.py:74).
//   B6: rows (1[+1], N) = sum w*v / max(sum w, eps) with w = 1/(d2+eps) per
//       found slot (power 2, valid_select.py:126-138; NaN where none was
//       found or out of the grid), (resolved).
//   B7: rows (N, 1+3k) = cnt, k values, k d2, k codes, the code dx-major
//       (scattered_select.py:66); the d2 of a slot is the pass's minimum
//       over all P lanes as jnp.min gives it: 3e30 at an empty slot, NaN on a
//       NaN query.
//   B11: rows (1[+1], N) = the kriging prediction, (resolved): B5's
//       first four slots and the 5x6 solve of krige_solve.cuh (below).
//   B12: (N,) the kriging prediction: B7's first four slots and the same
//       solve, NaN where no tap was found.
//   B15: (N,) sum w*v / max(sum w, eps) over B7's k slots, w = 1/(d2 **
//       (power/2) + eps) (any power, as torch computes it), NaN where none
//       was found and out of the grid.
//   B6, B11, B12 and B15 take the queries' (lon, lat) and compute the query
//   prologue themselves (query_prologue.cuh); B5 and B7 take the torch
//   prologue's cell index and (fx, fy).
// "resolved" (two-tier) is written at slot k-1 only: found & (d2 <
// resolve_thresh).
//
// What bounds them on the H100.  Per query a kernel reads its pack row
// (64 B valid16, 128 B radius 2), 12 bytes of cell index and fractional
// offsets (B6, B11, B12: 8 bytes of lon and lat), and writes rows*4 bytes
// (4-52 B); it does ~7 operations a tap for
// the distances and a few compare-selects a tap and slot.  The pack rows are
// random reads (one 64-128 B segment each), not streams.  select_kernel
// (B5) does the simple thing: one thread per query in 1-D blocks of 256; the
// row read as P/4 16-byte loads through the read-only cache; d2 fully
// unrolled in P registers (template on P); the offset table (dx, dy, code)
// read at one address by the whole warp (a broadcast), the chosen value and
// code reloaded per slot, each slot's minimum found by a strict-< scan P
// deep; outputs written lanes-major (coalesced).  P is 16, 32 or 64 (radius
// <= 3); radius 4 (P=128) would need 128 d2 registers and is refused by the
// wrapper.  idw_select_kernel (B6) and window_select_kernel (B7) are that
// kernel redesigned for the card: they take the M real taps, not the P of
// the pitch (25 of 32 at radius 2), take the taps as constant-bank operands
// instead of 2P-3P table loads a query, keep the values in registers instead
// of reloading one per slot, find each slot's minimum by a tournament (a
// dependency chain log2(M) deep, where the scan's is M deep), skip the last
// pass's knock-out and run 128-thread blocks.  B7 also stages its block's
// (N, 1+3k) rows in shared memory and writes them as one contiguous span of
// 16-byte stores: a thread's own 1+3k stores, 4(1+3k) bytes apart from the
// next thread's, would touch a line each.  B12 copies each warp's 32 rows
// into shared memory by cp.async, the next chunk's while this one is solved
// (below).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "krige_solve.cuh"
#include "query_prologue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kInf = 3e30f;           // d2 of an invalid tap (valid_select.py:62)
constexpr float kHalfInf = 1.5e30f;     // 0.5 * kInf: "found"
constexpr float kHalfSentinel = 0.5e30f;  // 0.5 * pack sentinel: valid tap

// B5.  pack: (cells, P) f32; cell: (n,) int32; fxy: (2, n) f32 (fx row, then
// fy); tab: (3, P) f32 = dx, dy, code per tap.  Each slot is written as soon
// as it is found, so no slot array is indexed.
template <int P>
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ pack, const int* __restrict__ cell,
              const float* __restrict__ fxy, const float* __restrict__ tab, int n, int k,
              int emit_d2, float half, int has_resolve, float resolve_thresh,
              float* __restrict__ out) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= n) return;
  const float* row = pack + (size_t)__ldg(cell + q) * P;
  const float fx = __ldg(fxy + q);
  const float fy = __ldg(fxy + n + q);

  float d2[P];
#pragma unroll
  for (int t4 = 0; t4 < P / 4; ++t4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row) + t4);
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = 4 * t4 + j;
      const float di = (__ldg(tab + t) + half) - fx;
      const float dj = (__ldg(tab + P + t) + half) - fy;
      d2[t] = vv[j] < kHalfSentinel ? di * di + dj * dj : kInf;
    }
  }

  const size_t N = (size_t)n;
  const int code_row = 1 + (emit_d2 ? 2 : 1) * k;
  float cnt = 0.f;
  float resolved = 0.f;
  for (int s = 0; s < k; ++s) {
    float m = d2[0];
    int idx = 0;
#pragma unroll
    for (int t = 1; t < P; ++t) {
      if (d2[t] < m) {
        m = d2[t];
        idx = t;
      }
    }
    const bool got = m < kHalfInf;
    // a pass that takes no slot knocks nothing out (the TPU kernels' hit is
    // got & the lowest index of the min)
    const int hit = got ? idx : -1;
#pragma unroll
    for (int t = 0; t < P; ++t) d2[t] = (t == hit) ? kInf : d2[t];
    const float val = got ? __ldg(row + idx) : 0.f;
    const float code = got ? __ldg(tab + 2 * P + idx) : 0.f;
    out[(1 + s) * N + q] = val;
    if (emit_d2) out[(1 + k + s) * N + q] = got ? m : kInf;
    out[(code_row + s) * N + q] = code;
    cnt = cnt + (got ? 1.f : 0.f);
    if (s == k - 1) resolved = (got && m < resolve_thresh) ? 1.f : 0.f;
  }

  out[q] = cnt;
  if (has_resolve) out[(code_row + k) * N + q] = resolved;
}

// The real taps of a window row, passed by value: the kernels read them as
// constant-bank operands, with no load.  x, y: dx + half and dy + half of
// each tap (dx an integer and half 0 or 0.5, so the host's sum is exact and
// the op order (dx + half) - fx is the plain version's); code: B7's code of
// the tap, (dx + R) * B + (dy + R), an integer exact in f32.
template <int M>
struct Taps {
  float x[M];
  float y[M];
};

template <int M>
struct CodedTaps {
  float x[M];
  float y[M];
  float code[M];
};

// A row's M values from ceil(M/4) 16-byte loads (VEC) or M scalar loads.
template <int M, bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ row, float (&val)[M]) {
  if (VEC) {
#pragma unroll
    for (int t4 = 0; t4 < (M + 3) / 4; ++t4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row) + t4);
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * t4 + j < M) val[4 * t4 + j] = vv[j];
    }
  } else {
#pragma unroll
    for (int t = 0; t < M; ++t) val[t] = __ldg(row + t);
  }
}

// The lowest-index minimum of d2[LO, LO + N) with its value and the tag of
// its tap, tag(t): the tap's index (B6) or its code (B7).
template <int LO, int N, int M, class Tag, class T>
__device__ __forceinline__ void tree_min(const float (&d2)[M], const float (&val)[M], const Tag& tag, float& m,
                                         T& id, float& v) {
  if constexpr (N == 1) {
    m = d2[LO];
    id = tag(LO);
    v = val[LO];
  } else {
    constexpr int L = N / 2;
    float ml, mr, vl, vr;
    T il, ir;
    tree_min<LO, L, M>(d2, val, tag, ml, il, vl);
    tree_min<LO + L, N - L, M>(d2, val, tag, mr, ir, vr);
    // min of the d2 bits as ints (d2 >= 0, so their order is the floats'),
    // with left = (ml <= mr): a tie keeps the left, lower-index side.  One
    // DPX instruction where a float compare and a select were two
    bool left;
    m = __int_as_float(__vibmin_s32(__float_as_int(ml), __float_as_int(mr), &left));
    id = left ? il : ir;
    v = left ? vl : vr;
  }
}

// B6: k-nearest IDW over the M real taps of a pack row (the pack's row pitch
// is P >= M; its P - M padding taps are never read), with the query
// prologue and the IDW epilogue in the kernel, so that a call is one launch.
// One thread a query, kSelThreads a block.
//   - the prologue of query_prologue.cuh from the query's (lon, lat): oob,
//     the centre (ci, cj) and (fx, fy), as the torch prologue computes them
//     op for op; the row at cj * W + ci;
//   - the row's M values and each tap's d2 (3e30 at an invalid tap) in
//     registers;
//   - per slot, the lowest-index minimum and its value by a tournament over
//     the taps (tree_min: each match keeps the left, lower-index side on a
//     tie, so it is the strict-< scan's answer), log2(M) matches deep where
//     a scan is M deep, each match a DPX integer min of the d2 bits; then the
//     winner knocked out, except after the last slot.  Passes stop at the
//     first that finds no tap below 1.5e30 (no valid tap left, or a NaN or
//     out-of-range query: every later pass would find none either; on a NaN
//     query every valid tap's d2 is NaN, and no min of them is below 1.5e30);
//   - w = 1/(m + eps) as an IEEE divide, num += w*v and den += w in slot
//     order, each op rounded once (-fmad=false);
//   - the epilogue of the plain version: num / max(den, eps) where den > 0,
//     NaN where not and out of the grid;
//   - resolved (two-tier) at slot k - 1: found and m < resolve_thresh, out
//     of the grid too (through the clipped centre, as the plain version has
//     it).
// Bit-equal to idw_select_ref.
constexpr int kSelThreads = 128;

template <int M, int P, bool VEC>
__global__ void __launch_bounds__(kSelThreads)
idw_select_kernel(const float* __restrict__ pack, const float* __restrict__ lons,
                  const float* __restrict__ lats, const Taps<M> taps, const QueryGeom geo, int n, int k,
                  int has_resolve, float resolve_thresh, float eps, float* __restrict__ out) {
  static_assert(M <= P, "a pack row holds its taps");
  const int q = blockIdx.x * kSelThreads + threadIdx.x;
  if (q >= n) return;
  const QueryCell qc = query_cell(__ldg(lons + q), __ldg(lats + q), geo);

  float val[M];
  load_row<M, VEC>(pack + (size_t)(qc.cj * geo.W + qc.ci) * P, val);
  float d2[M];
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const float di = taps.x[t] - qc.fx;
    const float dj = taps.y[t] - qc.fy;
    d2[t] = val[t] < kHalfSentinel ? di * di + dj * dj : kInf;
  }

  float num = 0.f;
  float den = 0.f;
  float resolved = 0.f;
  for (int s = 0; s < k; ++s) {
    float m, v;
    int idx;
    tree_min<0, M, M>(d2, val, [](int t) { return t; }, m, idx, v);
    if (!(m < kHalfInf)) break;
    const float w = 1.f / (m + eps);
    num = num + w * v;
    den = den + w;
    if (s == k - 1) {
      resolved = m < resolve_thresh ? 1.f : 0.f;
      break;
    }
#pragma unroll
    for (int t = 0; t < M; ++t) d2[t] = t == idx ? kInf : d2[t];
  }
  // The quotient only under den > 0, which a NaN den fails: fmaxf(NaN, eps)
  // is eps, where torch.clamp and jnp.maximum keep the NaN, so a NaN den
  // must not reach it.  (den is a sum of positive weights, never NaN; this
  // keeps the plain version's answer whatever it holds.)
  const float res = den > 0.f ? num / fmaxf(den, eps) : NAN;
  out[q] = qc.oob ? NAN : res;
  if (has_resolve) out[(size_t)n + q] = resolved;
}

template <int M, int P>
int launch_idw(bool vec, dim3 g, cudaStream_t st, const float* pack, const float* lons, const float* lats,
               const float* taps, const QueryGeom& geo, int n, int k, int has_resolve, float thresh, float eps,
               float* out) {
  Taps<M> tv;
  for (int t = 0; t < M; ++t) {
    tv.x[t] = taps[t];
    tv.y[t] = taps[M + t];
  }
  if (vec)
    idw_select_kernel<M, P, true><<<g, kSelThreads, 0, st>>>(pack, lons, lats, tv, geo, n, k, has_resolve, thresh,
                                                            eps, out);
  else
    idw_select_kernel<M, P, false><<<g, kSelThreads, 0, st>>>(pack, lons, lats, tv, geo, n, k, has_resolve,
                                                             thresh, eps, out);
  return (int)cudaGetLastError();
}

// B11: B5's first four slots and the ordinary-kriging solve per query, with
// the query prologue, in one kernel (redesigned; the first B11 took the
// torch prologue's cell, fx, fy, query and oob planes, ~28 torch kernels
// before it, and the XLA row epilogue's ~300 came down to it).  On B6's
// design: a thread a query, kSelThreads a block; the M real taps of the
// row by value (dx + half, dy + half, and the tap's offsets packed as the
// tag (dx + 8) | (dy + 8) << 4).
// Per query:
//   - the prologue of query_prologue.cuh from its (lon, lat) and the grid's
//     scalars: oob, the centre (ci, cj) and (fx, fy), as the torch prologue
//     computes them op for op;
//   - its row's M values and d2 in registers; four tournaments (tree_min),
//     each winner knocked out by its tag; passes stop at the first that
//     finds no tap below 1.5e30;
//   - fb = (v0 + v1 + v2 + v3) / max(found, 1), empty slots holding 0 (so
//     0 where nothing was found, on a NaN query too);
//   - where four were found and the query lies in the grid, the centres
//     min + ((c + d) + half) * step of the four slots (d from the slot's
//     tag, exact) and the 5x6 system with gamma(0) on its diagonal, solved
//     by krige_solve.cuh's Gauss-Jordan with the column-form gamma of each
//     model (gamma_cols): the prediction sum lam_a v_a, or fb where a pivot
//     fell below pivot_tol.  Elsewhere the plain version discards the
//     solve, so it is not run;
//   - NaN out of the grid; the resolved row (two-tier) at slot 4: found
//     and d2 < resolve_thresh, out of the grid too (through the clipped
//     centre, as the plain version has it).
// The fitted variogram's parameters are read through device pointers where
// they are set (KrigeParams.p_vario), so nothing travels to the host.
// What bounds it on the H100: per query 8 bytes of (lon, lat) and a random
// 64-196 byte pack row (M taps) read, 4 or 8 bytes written: 76 bytes at
// valid16, 0.0227 ms at 1M queries; random 64-byte rows reach no more than
// ~58 % of the HBM rate (scripts/row_gather_probe.py: 0.039 ms).  The
// valid16 build has ~1,700 SASS instructions (static count, code a query
// may not run included; the solve's IEEE divisions, square roots and expf
// without FMA, as the plain version rounds).  The builds of at most 16
// taps ask for 8 resident blocks of 128 threads: that takes the valid16
// build from 78 to 57 registers, 6 to 8 blocks an SM, and 6-7 % off its
// time; two queries a thread (both rows loaded before either tournament)
// were 25 % slower (scripts/b11_variant_probe.py, PERF.md).

template <int M>
struct KrigeTaps {
  float x[M];
  float y[M];
  int tag[M];
};

// The fixed parameters of a B11 launch, by value; the variogram's (nugget,
// p1, p2) read through p_vario where it is not null, else from vario.
struct KrigeParams {
  QueryGeom geo;
  float lon_step, lat_step, half, pivot_tol, resolve_thresh;
  int has_resolve;
  float vario[3];
  const float* p_vario[3];
};

// The fallback where fewer than four were found or a pivot fell below
// pivot_tol: the mean of the found slots, with empty slots holding 0; where
// none was found, 0 (B11: valid_select.py's row epilogue) or NaN (B12:
// ops/window.py masked_mean, under kriging_from_select).
enum Fallback { kMeanOrZero = 0, kMeanOrNaN = 1 };

// One query after its row is loaded: the top-4, the solve, the stores.
template <int M, int MODEL, int FB = kMeanOrZero>
__device__ __forceinline__ void krige_query(const float (&val)[M], const QueryCell& qc, float lon, float lat,
                                            const KrigeTaps<M>& taps, const KrigeParams& par, int n, int q,
                                            float* __restrict__ out) {
  float d2[M];
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const float di = taps.x[t] - qc.fx;
    const float dj = taps.y[t] - qc.fy;
    d2[t] = val[t] < kHalfSentinel ? di * di + dj * dj : kInf;
  }

  float vz[4] = {0.f, 0.f, 0.f, 0.f};
  int tag[4] = {0, 0, 0, 0};
  int cnt = 0;
  float resolved = 0.f;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    float m, v;
    int id;
    tree_min<0, M, M>(d2, val, [&](int t) { return taps.tag[t]; }, m, id, v);
    if (!(m < kHalfInf)) break;
    vz[s] = v;
    tag[s] = id;
    cnt = s + 1;
    if (s == 3) {
      resolved = m < par.resolve_thresh ? 1.f : 0.f;
      break;
    }
#pragma unroll
    for (int t = 0; t < M; ++t) d2[t] = id == taps.tag[t] ? kInf : d2[t];
  }

  float res;
  if (FB == kMeanOrZero)
    res = (((vz[0] + vz[1]) + vz[2]) + vz[3]) / fmaxf((float)cnt, 1.f);
  else
    res = cnt > 0 ? (((vz[0] + vz[1]) + vz[2]) + vz[3]) / (float)cnt : NAN;
  if (cnt == 4 && !qc.oob) {
    const float cif = (float)qc.ci;
    const float cjf = (float)qc.cj;
    float cx[4], cy[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      cx[s] = par.geo.min_lon + ((cif + (float)((tag[s] & 15) - 8)) + par.half) * par.lon_step;
      cy[s] = par.geo.min_lat + ((cjf + (float)((tag[s] >> 4) - 8)) + par.half) * par.lat_step;
    }
    const float nugget = par.p_vario[0] ? __ldg(par.p_vario[0]) : par.vario[0];
    const float p1 = par.p_vario[1] ? __ldg(par.p_vario[1]) : par.vario[1];
    const float p2 = par.p_vario[2] ? __ldg(par.p_vario[2]) : par.vario[2];
    const auto gamma = [&](float h) { return gamma_cols<MODEL>(h, nugget, p1, p2); };
    float lam[5], gamma0[4];
    const bool singular = krige_solve<kGJ>(cx, cy, lon, lat, gamma(0.f), gamma, par.pivot_tol, lam, gamma0);
    if (!singular) res = lam[0] * vz[0] + lam[1] * vz[1] + lam[2] * vz[2] + lam[3] * vz[3];
  }
  out[q] = qc.oob ? NAN : res;
  if (par.has_resolve) out[(size_t)n + q] = resolved;
}

// lons, lats: (n,) f32 queries; pack: (cells, P) f32, 16-byte aligned.
template <int M, int P, int MODEL>
__global__ void __launch_bounds__(kSelThreads, M <= 16 ? 8 : 1)
select_krige_kernel(const float* __restrict__ pack, const float* __restrict__ lons,
                    const float* __restrict__ lats, const __grid_constant__ KrigeTaps<M> taps,
                    const KrigeParams par, int n, float* __restrict__ out) {
  static_assert(M <= P, "a pack row holds its taps");
  const int q = blockIdx.x * kSelThreads + threadIdx.x;
  if (q >= n) return;
  const float lon = __ldg(lons + q);
  const float lat = __ldg(lats + q);
  const QueryCell qc = query_cell(lon, lat, par.geo);
  float val[M];
  load_row<M, true>(pack + (size_t)(qc.cj * par.geo.W + qc.ci) * P, val);
  krige_query<M, MODEL>(val, qc, lon, lat, taps, par, n, q, out);
}

// The build a launch of M taps and this model runs.
template <int M, int P>
const void* krige_kernel(int model) {
  switch (model) {
    case kExponential: return (const void*)select_krige_kernel<M, P, kExponential>;
    case kLinear: return (const void*)select_krige_kernel<M, P, kLinear>;
    case kSpherical: return (const void*)select_krige_kernel<M, P, kSpherical>;
    default: return (const void*)select_krige_kernel<M, P, kGaussian>;
  }
}

// The by-value taps of B11 and B12 from the offsets (dx of each tap, then
// dy; integers, |dx|, |dy| <= 7): false where one is out of that range.
template <int M>
bool krige_taps(const float* offs, float half, KrigeTaps<M>& tv) {
  for (int t = 0; t < M; ++t) {
    const float dx = offs[t], dy = offs[M + t];
    if (!(fabsf(dx) <= 7.f && fabsf(dy) <= 7.f)) return false;
    tv.x[t] = dx + half;
    tv.y[t] = dy + half;
    tv.tag[t] = ((int)dx + 8) | (((int)dy + 8) << 4);
  }
  return true;
}

template <int M, int P>
int launch_krige(cudaStream_t st, const float* pack, const float* lons, const float* lats, const float* offs,
                 KrigeParams par, int model, int n, float* out) {
  KrigeTaps<M> tv;
  if (!krige_taps(offs, par.half, tv)) return (int)cudaErrorInvalidValue;
  const dim3 g((unsigned)((n + kSelThreads - 1) / kSelThreads));
  void* args[] = {&pack, &lons, &lats, &tv, &par, &n, &out};
  return (int)cudaLaunchKernel(krige_kernel<M, P>(model), g, dim3(kSelThreads), args, 0, st);
}

// B12: B7's top-4 over the radius-R window pack and the kriging solve of
// ops/packs.py kriging_from_select after it, with the query prologue, in
// one kernel (pallas_packed_kriging: pallas_window_select's selection, then
// the solve in XLA).  B11's query function but for the fallback: B7's
// selection is B5's over the same taps in the same collection order (the
// tie to the lowest table index; only the code each writes differs, and
// B12 keeps the taps' offsets as B11 does), and kriging_from_select's solve
// is B11's (the column-form gamma, gamma(0) on the diagonal, Gauss-Jordan,
// the centres min + ((c + d) + half) * step).  Where nothing was found (a
// NaN query, a row of sentinels) the fallback is masked_mean's NaN, where
// B11's is 0.  No resolved row.
//
// Redesigned for Hopper at radius 2, the fused path's (the first design
// read each row straight into registers, 7 16-byte loads a thread, so each
// warp-wide load touched 32 random lines): a warp serves 32 queries at a
// time, and their pack rows reach shared memory by asynchronous copies
// (cp.async, LDGSTS) before the register-heavy selection and solve:
//   - each lane computes its query's prologue (query_prologue.cuh) and the
//     warp shares the row indices by __shfl_sync; each lane then copies 16
//     bytes a row piece, RowCopy<M>::kPieces pieces a row (the taps' 32-byte
//     sectors: 8 at radius 2, so 4 whole rows a warp instruction), into the
//     warp's stage of shared memory, bypassing L1 (.cg: a row is read once);
//   - a row lands at a stride of kStride 16-byte units, an odd number, so
//     the 8 threads of each phase of a warp's 16-byte shared loads (tap t of
//     their own rows) meet no bank conflict; the thread copies its row into
//     its val[M] registers and runs krige_query<M, MODEL, kMeanOrNaN>, the
//     function B11 instantiates, unchanged, so the arithmetic is the plain
//     version's op for op and B11's SASS does not move;
//   - the grid is persistent (as many blocks as fit), each warp walking
//     chunks of 32 queries, w, w + warps, ...; the rows of the next chunk
//     are copied into the other stage while this chunk is selected and
//     solved;
//   - the radius-2 builds ask for 4 resident blocks (no spill; 3 blocks
//     without); 2 stages x 4 warps x 32 rows x kStride x 16 B of shared
//     memory, 36 KB a block.
// Radius 1, radius 3 and a pack that is not 16-byte aligned keep the first
// design, one query a thread, a grid of all the queries: staged, radius 1
// was 17 % slower (64-byte rows, 8 blocks an SM), radius 3 within 2 %
// either way for 60 KB of shared memory a block, and an unaligned pack by
// 4-byte copies 10-20 % slower than its scalar loads.
// What bounds it (scripts/b12_variant_probe.py, which also builds the
// rejected designs from scripts/b12_variants.cu; PERF.md): the random
// 128-byte rows, whose reads alone (scripts/row_gather_probe.py) take 87 %
// of the first design's time at 1M Grid A queries; the second stage hides
// part of the solve behind them.
constexpr int kWarpsPerBlock = kSelThreads / 32;

template <int M>
constexpr bool kStagedBuild = M > 16 && M <= 32;

// The 16-byte pieces of a row that B12 copies (ceil(M / 4), rounded up to
// whole 32-byte sectors) and its stride in shared memory (odd, in 16-byte
// units).
template <int M>
struct RowCopy {
  static constexpr int kPieces = ((M + 3) / 4 + 1) & ~1;
  static constexpr int kStride = kPieces + 1;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// The warp's 32 rows into `stage` by 16-byte cp.async: lane l's row index
// `cell` (-1 past n: not copied) reaches the lanes that copy its pieces by
// __shfl_sync; piece i of the warp's 32 * kPieces is row i / kPieces, piece
// i % kPieces.
template <int M, int P>
__device__ __forceinline__ void stage_rows(const float* __restrict__ pack, int cell, float4* stage, int lane) {
  constexpr int C = RowCopy<M>::kPieces, S = RowCopy<M>::kStride;
  static_assert(4 * C <= P, "the copied pieces lie inside the pack row");
#pragma unroll
  for (int it = 0; it < C; ++it) {
    const int i = it * 32 + lane;
    const int r = i / C, c = i % C;
    const int rc = __shfl_sync(0xffffffffu, cell, r);
    if (rc >= 0) cp_async16(stage + r * S + c, pack + (size_t)rc * P + 4 * c);
  }
}

// A staged row's M values into registers, ceil(M / 4) 16-byte shared loads.
template <int M>
__device__ __forceinline__ void unstage_row(const float4* row, float (&val)[M]) {
#pragma unroll
  for (int t4 = 0; t4 < (M + 3) / 4; ++t4) {
    const float4 v = row[t4];
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * t4 + j < M) val[4 * t4 + j] = vv[j];
  }
}

__device__ __forceinline__ int row_of(const QueryCell& qc, int W) { return qc.cj * W + qc.ci; }

// The row loop of B12 and B15 (window_idw_kernel, below), with the
// per-query epilogue `query(val, qc, lon, lat, q)` a template parameter:
// each query's prologue, its pack row's M values into registers, then the
// epilogue.  STAGED (B12's radius-2 builds; B15 never) with an aligned
// pack (vec) takes the staged rows (the persistent grid of warps, the next
// chunk's rows copied by cp.async while this one is served); otherwise one
// query a thread, a grid of all the queries, its row straight into
// registers (16-byte loads where vec, else scalar).
template <int M, int P, bool STAGED, class Query>
__device__ __forceinline__ void window_rows(const float* __restrict__ pack, const float* __restrict__ lons,
                                            const float* __restrict__ lats, const QueryGeom& geo, int n, int vec,
                                            const Query& query) {
  static_assert(M <= P, "a pack row holds its taps");
  if (!STAGED || !vec) {  // the rows straight into registers, one query a thread
    const int q = blockIdx.x * kSelThreads + threadIdx.x;
    if (q >= n) return;
    const float lon = __ldg(lons + q);
    const float lat = __ldg(lats + q);
    const QueryCell qc = query_cell(lon, lat, geo);
    const float* row = pack + (size_t)row_of(qc, geo.W) * P;
    float val[M];
    if (vec)
      load_row<M, true>(row, val);
    else
      load_row<M, false>(row, val);
    query(val, qc, lon, lat, q);
    return;
  }
  constexpr int S = RowCopy<M>::kStride;
  extern __shared__ float4 row_stages[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4* stages = row_stages + warp * (2 * 32 * S);
  const long long chunks = ((long long)n + 31) / 32;
  const long long step = (long long)gridDim.x * kWarpsPerBlock;
  long long w = (long long)blockIdx.x * kWarpsPerBlock + warp;
  // this lane's query of chunk c: its (lon, lat) (0 past n), and its row's
  // copy into stage st issued
  const auto issue = [&](long long c, int st, float& lon, float& lat) {
    const int q = (int)(c * 32) + lane;
    lon = q < n ? __ldg(lons + q) : 0.f;
    lat = q < n ? __ldg(lats + q) : 0.f;
    const int cell = q < n ? row_of(query_cell(lon, lat, geo), geo.W) : -1;
    stage_rows<M, P>(pack, cell, stages + st * 32 * S, lane);
    cp_async_commit();
  };
  // chunk c's rows have been issued into stage st (and, if `pending`, the
  // next chunk's after them): wait for them, then serve c's queries
  const auto serve = [&](long long c, int st, float lon, float lat, bool pending) {
    if (pending)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncwarp();
    float val[M];
    unstage_row<M>(stages + st * 32 * S + lane * S, val);
    __syncwarp();  // every lane holds its row before the stage is copied into again
    const int q = (int)(c * 32) + lane;
    if (q < n) {
      // the prologue again from (lon, lat): the same bits, and no registers
      // held across the copy
      query(val, query_cell(lon, lat, geo), lon, lat, q);
    }
  };
  float lon = 0.f, lat = 0.f;
  if (w < chunks) issue(w, 0, lon, lat);
  for (int st = 0; w < chunks; w += step, st ^= 1) {
    float lon_n = 0.f, lat_n = 0.f;
    const bool more = w + step < chunks;
    if (more) issue(w + step, st ^ 1, lon_n, lat_n);  // the next chunk's rows, while this one is served
    serve(w, st, lon, lat, more);
    lon = lon_n;
    lat = lat_n;
  }
}

template <int M, int P, int MODEL>
__global__ void __launch_bounds__(kSelThreads, M <= 16 ? 8 : (M <= 32 ? 4 : 1))
window_krige_kernel(const float* __restrict__ pack, const float* __restrict__ lons,
                    const float* __restrict__ lats, const __grid_constant__ KrigeTaps<M> taps,
                    const KrigeParams par, int n, int vec, float* __restrict__ out) {
  window_rows<M, P, kStagedBuild<M>>(
      pack, lons, lats, par.geo, n, vec, [&](const float(&val)[M], const QueryCell& qc, float lon, float lat, int q) {
        krige_query<M, MODEL, kMeanOrNaN>(val, qc, lon, lat, taps, par, n, q, out);
      });
}

template <int M, int P>
const void* window_krige_fn(int model) {
  switch (model) {
    case kExponential: return (const void*)window_krige_kernel<M, P, kExponential>;
    case kLinear: return (const void*)window_krige_kernel<M, P, kLinear>;
    case kSpherical: return (const void*)window_krige_kernel<M, P, kSpherical>;
    default: return (const void*)window_krige_kernel<M, P, kGaussian>;
  }
}

// A B12 build's dynamic shared memory: the staged build's two stages.
template <int M>
constexpr int window_krige_smem() {
  return kStagedBuild<M> ? 2 * kSelThreads * RowCopy<M>::kStride * 16 : 0;
}

// The blocks an SM holds of a kernel at `smem` bytes of dynamic shared
// memory, and the device's SMs, for the current device.  Above the 48 KB
// default the kernel is granted `smem` first; with `max_shared` it also
// asks for the largest shared-memory carveout, so that the occupancy
// answered is the one the launches get.  Grants and answers are a
// device's, so each (kernel, device) is set up and asked once and cached (a
// device past kMaxDevices every call).
constexpr int kMaxDevices = 16;

struct Residency {
  std::atomic<int> per_sm{0};  // written last: nonzero once sms holds
  std::atomic<int> sms{0};
};

inline int residency(const void* fn, int smem, Residency* cache, int* per_sm, int* sms, bool max_shared = false) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  Residency* c = dev < kMaxDevices ? cache + dev : nullptr;
  if (c && c->per_sm.load() > 0) {
    *sms = c->sms.load();
    *per_sm = c->per_sm.load();
    return 0;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && max_shared)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kSelThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (c) {
    c->sms.store(*sms);
    c->per_sm.store(*per_sm);
  }
  return 0;
}

template <int M, int P>
int window_krige_resident(int model, int* per_sm, int* sms) {
  static Residency cache[4][kMaxDevices];
  return residency(window_krige_fn<M, P>(model), window_krige_smem<M>(), cache[model], per_sm, sms);
}

template <int M, int P>
int launch_window_krige(cudaStream_t st, const float* pack, const float* lons, const float* lats,
                        const float* offs, KrigeParams par, int model, int n, float* out) {
  KrigeTaps<M> tv;
  if (!krige_taps(offs, par.half, tv)) return (int)cudaErrorInvalidValue;
  int vec = ((uintptr_t)pack & 15) == 0;
  const bool staged = kStagedBuild<M> && vec;
  long long blocks = ((long long)n + kSelThreads - 1) / kSelThreads;
  if (staged) {  // persistent: as many blocks as fit, at most one a block of queries
    int per_sm = 0, sms = 0;
    const int err = window_krige_resident<M, P>(model, &per_sm, &sms);
    if (err) return err;
    const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
    blocks = blocks < resident ? blocks : resident;
  }
  void* args[] = {&pack, &lons, &lats, &tv, &par, &n, &vec, &out};
  return (int)cudaLaunchKernel(window_krige_fn<M, P>(model), dim3((unsigned)blocks), dim3(kSelThreads), args,
                               staged ? (size_t)window_krige_smem<M>() : 0, st);
}

// B15: B7's window top-k and the IDW of ops/packs.py idw_from_select after
// it, with the query prologue, in one kernel (pallas_packed_idw:
// pallas_window_select's selection, then the weights and the quotient in
// XLA).  B12's row loop (window_rows) with the IDW epilogue in place of the
// solve; per query:
//   - the prologue of query_prologue.cuh and the centre cell's row;
//   - d2 per live tap as B7 computes it, 3e30 at a sentinel;
//   - k min-extract passes (tree_min: the lowest-index minimum, B7's tie,
//     the winner knocked out by its index); passes stop at the first whose
//     minimum is not below 1.5e30, so a NaN query takes no slot;
//   - per found slot w = 1 / (d2 ** (power / 2) + eps), the power as
//     torch's pow(Tensor, Scalar) computes it on the card (IdwPow below),
//     then num += w * v and den += w in slot order, each op rounded once
//     (-fmad=false);
//   - num / max(den, eps) where den > 0, NaN where not and out of the grid.
// K is k where the main paths' k (4, 8) is built, 0 for the build that
// takes any k (1 <= k <= P); the passes stay a loop, as B7's.
// Bit-equal to window_idw_ref, whose weights are torch's and whose two sums
// run in the same slot order.
//
// Redesigned for Hopper at radius 2, the fused path's, and at radius 3
// (the first design read each row straight into val[M] registers, one
// query a thread, a warp-wide load touching 32 random lines): a persistent
// grid of warps, each warp's 32 rows copied into shared memory by cp.async
// (B12's stage_rows), the next chunk's while this one is served; the row
// stays in shared memory (16-byte loads at B12's odd stride for d2, the
// validity test on the shared copy, each winner's value one shared load);
// the prologue runs once a query, its (fx, fy, oob) kept in the row's
// spare 16 bytes.  What bounds it: staged, the rows arrive faster than the
// first design's registers take them (k 4), and at k 8 the passes'
// instruction issue bounds it: the exact tournament is ~120 SASS
// instructions a pass (a DPX min, a compare and a select a match, a
// compare and a select a tap to knock the winner out).  So the k 4 and 8
// builds take their passes on 32-bit keys (keyed_topk: one fused
// add-and-min, VIADDMNMX, a tap a pass, no knock-out), the exact
// tournament only where the keys cannot vouch for the order, and the
// weights after the passes.  Radius 1 (64-byte rows, as fast either way)
// and a pack that is not 16-byte aligned keep the first design's rows in
// registers (kIdwStaged; scripts/b15_path_probe.py times every design in
// one process; PERF.md).

// How torch's CUDA pow(Tensor, Scalar) computes d2 ** e (e = power / 2):
// e 0 fills 1 and e 1 copies the input (its structured kernel, before the
// stub); 0.5, -0.5 and -1 go to sqrt, rsqrt and reciprocal; 2, 3 and -2 to
// x*x, x*x*x and 1.0 / (x*x) (a double quotient); any other e to powf.
// The wrapper picks the mode from e (scattered_select._pow_mode).
enum IdwPow {
  kPowOne = 0,
  kPowCopy = 1,
  kPowSqrt = 2,
  kPowRsqrt = 3,
  kPowRecip = 4,
  kPowSquare = 5,
  kPowCube = 6,
  kPowRecipSquare = 7,
  kPowGeneral = 8,
};

__device__ __forceinline__ float idw_pow(float d2, int mode, float e) {
  switch (mode) {
    case kPowOne: return 1.f;
    case kPowCopy: return d2;
    case kPowSqrt: return sqrtf(d2);
    case kPowRsqrt: return rsqrtf(d2);
    case kPowRecip: return 1.f / d2;
    case kPowSquare: return d2 * d2;
    case kPowCube: return d2 * d2 * d2;
    case kPowRecipSquare: return (float)(1.0 / (double)(d2 * d2));
    default: return powf(d2, e);
  }
}

// The fixed parameters of a B15 launch, by value.
struct IdwParams {
  QueryGeom geo;
  int k, pow_mode;
  float pow_e, eps;
};

// One query after its row is loaded: the top-k, the weights, the quotient.
template <int M, int K>
__device__ __forceinline__ void idw_query(const float (&val)[M], const QueryCell& qc, const Taps<M>& taps,
                                          const IdwParams& par, int q, float* __restrict__ out) {
  float d2[M];
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const float di = taps.x[t] - qc.fx;
    const float dj = taps.y[t] - qc.fy;
    d2[t] = val[t] < kHalfSentinel ? di * di + dj * dj : kInf;
  }
  const int kk = K > 0 ? K : par.k;
  float num = 0.f;
  float den = 0.f;
#pragma unroll 1
  for (int s = 0; s < kk; ++s) {
    float m, v;
    int idx;
    tree_min<0, M, M>(d2, val, [](int t) { return t; }, m, idx, v);
    if (!(m < kHalfInf)) break;
    const float w = 1.f / (idw_pow(m, par.pow_mode, par.pow_e) + par.eps);
    num = num + w * v;
    den = den + w;
    if (s == kk - 1) break;
#pragma unroll
    for (int t = 0; t < M; ++t) d2[t] = t == idx ? kInf : d2[t];
  }
  // the quotient only under den > 0 (fmaxf(NaN, eps) is eps, where
  // torch.clamp keeps the NaN; see idw_select_kernel)
  const float res = den > 0.f ? num / fmaxf(den, par.eps) : NAN;
  out[q] = qc.oob ? NAN : res;
}

// The lowest-index minimum of d2[LO, LO + N) and its tap's index: tree_min's
// tournament, each match a DPX integer min of the d2 bits and one select of
// the index, no value carried.
template <int LO, int N, int M>
__device__ __forceinline__ void tree_argmin(const float (&d2)[M], int& m, int& id) {
  if constexpr (N == 1) {
    m = __float_as_int(d2[LO]);
    id = LO;
  } else {
    constexpr int L = N / 2;
    int ml, mr, il, ir;
    tree_argmin<LO, L, M>(d2, ml, il);
    tree_argmin<LO + L, N - L, M>(d2, mr, ir);
    bool left;
    m = __vibmin_s32(ml, mr, &left);
    id = left ? il : ir;
  }
}

// The B15 builds that stage their rows (on an aligned pack): radius 2 and
// 3, where staged was faster (radius 1 was not), each warp holding two
// chunks of rows in shared memory (three cost the radius-2 build its
// sixth block; PERF.md).
constexpr int kIdwStages = 2;
template <int M>
constexpr bool kIdwStaged = M > 16;

// The resident blocks a B15 build asks for: the staged radius-2 build 6
// (at most 80 registers, 6 x 37 KB of its stages in an SM's 228 KB); the
// others as B12's (the radius-3 build: 3, by its 136 registers and 61 KB
// of stages).
template <int M>
constexpr int kIdwMinBlocks = M <= 16 ? 8 : (M <= 32 ? (kIdwStaged<M> ? 6 : 4) : 1);

// The unsigned minimum of key[LO, LO + N) - thr: a key below thr wraps past
// every other, so the minimum is the least key not below thr, less thr.
template <int LO, int N, int M>
__device__ __forceinline__ uint32_t tree_umin(const uint32_t (&key)[M], uint32_t thr) {
  if constexpr (N == 1) {
    return key[LO] - thr;
  } else {
    constexpr int L = N / 2;
    return min(tree_umin<LO, L, M>(key, thr), tree_umin<LO + L, N - L, M>(key, thr));
  }
}

// A staged query's d2 of tap t from the row's value: 3e30 at a sentinel.
template <int M>
__device__ __forceinline__ float tap_d2(float v, const Taps<M>& taps, int t, float fx, float fy) {
  const float di = taps.x[t] - fx;
  const float dj = taps.y[t] - fy;
  return v < kHalfSentinel ? di * di + dj * dj : kInf;
}

// The first K passes of idw_query's selection, exactly: the tournament on
// (d2 bits, tap index), each winner knocked out, unrolled; mk, ik the
// winners' d2 and taps.  Returns how many passes took a slot.
template <int M, int K>
__device__ __forceinline__ int exact_topk(const float4* row, const Taps<M>& taps, float fx, float fy,
                                          float (&mk)[K], int (&ik)[K]) {
  float d2[M];
#pragma unroll
  for (int t4 = 0; t4 < (M + 3) / 4; ++t4) {
    const float4 v = row[t4];
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * t4 + j < M) d2[4 * t4 + j] = tap_d2(vv[j], taps, 4 * t4 + j, fx, fy);
  }
  int found = K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    int mb;
    tree_argmin<0, M, M>(d2, mb, ik[s]);
    mk[s] = __int_as_float(mb);
    if (!(mk[s] < kHalfInf)) {
      found = s;
      break;
    }
    if (s < K - 1) {
#pragma unroll
      for (int t = 0; t < M; ++t) d2[t] = t == ik[s] ? kInf : d2[t];
    }
  }
  return found;
}

// The same K passes on 32-bit keys, ((d2 bits >> (B - 1)) << B) | t with B
// the bits of a tap index (5 up to 32 taps, 6 up to 64), unique by their
// tap: the selection by (d2 bits >> (B - 1), t), each pass one unsigned
// tournament of key - thr (one subtract a tap, one min a match), thr the
// last winner's key + 1, so no knock-out.  For a query that is not NaN,
// the first K + 1 winners by (d2 bits >> (B - 1), t) are the exact
// selection's first K wherever no two consecutive winners among the slots
// share d2 bits >> (B - 1) but not d2, and the K-th and the (K + 1)-th do
// not share them: the order then differs from (d2 bits, t) nowhere among
// the slots, and no tap outside them can come before one
// (tests/test_torch_window_idw_keys.py writes this out).  Returns the slots
// taken (mk, ik as exact_topk's; d2 recomputed for each winner), or -1
// where that does not hold.  A valid tap's d2 (finite, below 64) keys below
// every sentinel's, so the taps taken are the valid ones, as in idw_query.
// The caller takes exact_topk for a NaN query, whose d2 bits key nothing.
template <int M, int K>
__device__ __forceinline__ int keyed_topk(const float4* row, const Taps<M>& taps, float fx, float fy,
                                          float (&mk)[K], int (&ik)[K]) {
  static_assert(M <= 64, "a tap index in 6 bits");
  constexpr int B = M <= 32 ? 5 : 6;
  constexpr uint32_t kTap = (1u << B) - 1u;
  uint32_t key[M];
#pragma unroll
  for (int t4 = 0; t4 < (M + 3) / 4; ++t4) {
    const float4 v = row[t4];
    const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = 4 * t4 + j;
      if (t < M) key[t] = ((__float_as_uint(tap_d2(vv[j], taps, t, fx, fy)) >> (B - 1)) << B) | (uint32_t)t;
    }
  }
  uint32_t wk[K + 1];
  uint32_t thr = 0u;
#pragma unroll
  for (int s = 0; s <= K; ++s) {
    wk[s] = tree_umin<0, M, M>(key, thr) + thr;
    thr = wk[s] + 1u;
  }
  const float* vals = reinterpret_cast<const float*>(row);
  int found = 0;
  bool exact = true;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    ik[s] = (int)(wk[s] & kTap);
    mk[s] = tap_d2(vals[ik[s]], taps, ik[s], fx, fy);
    found += (found == s) && (mk[s] < kHalfInf);
    // two slots (both taken) that share d2 bits >> (B - 1) but not d2
    if (s > 0 && s < found)
      exact = exact && ((wk[s - 1] >> B) != (wk[s] >> B) || __float_as_uint(mk[s - 1]) == __float_as_uint(mk[s]));
  }
  // the last slot and the next winner sharing d2 bits >> (B - 1)
  exact = exact && (found < K || (wk[K - 1] >> B) != (wk[K] >> B));
  return exact ? found : -1;
}

// One query of a staged build: its row and its prologue stay in the warp's
// stage, d2 from the row's 16-byte shared loads, each winner's value one
// shared load by its tap.  The k 4 and 8 builds take keyed_topk's slots,
// exact_topk's where keyed_topk cannot vouch for them (and on a NaN
// query), then the weights and sums in slot order, power 2's mode (the
// main paths') as a constant; the general build runs idw_query's loop on
// the shared row.  The same arithmetic in the same order as
// idw_query, so the same bits.
template <int M, int K>
__device__ __forceinline__ void idw_staged_query(const float4* row, const Taps<M>& taps, const IdwParams& par,
                                                 int q, float* __restrict__ out) {
  const float4 pro = row[RowCopy<M>::kPieces];  // fx, fy, oob
  const float fx = pro.x, fy = pro.y;
  const float* vals = reinterpret_cast<const float*>(row);
  float num = 0.f;
  float den = 0.f;
  if constexpr (K > 0) {
    float mk[K];
    int ik[K];
    int found = -1;
    if (fx == fx && fy == fy) found = keyed_topk<M, K>(row, taps, fx, fy, mk, ik);
    if (found < 0) found = exact_topk<M, K>(row, taps, fx, fy, mk, ik);
    const auto sums = [&](int mode) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (s < found) {
          const float w = 1.f / (idw_pow(mk[s], mode, par.pow_e) + par.eps);
          num = num + w * vals[ik[s]];
          den = den + w;
        }
      }
    };
    if (par.pow_mode == kPowCopy)
      sums(kPowCopy);
    else
      sums(par.pow_mode);
  } else {
    float d2[M];
#pragma unroll
    for (int t4 = 0; t4 < (M + 3) / 4; ++t4) {
      const float4 v = row[t4];
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * t4 + j < M) d2[4 * t4 + j] = tap_d2(vv[j], taps, 4 * t4 + j, fx, fy);
    }
    const int kk = K > 0 ? K : par.k;
#pragma unroll 1
    for (int s = 0; s < kk; ++s) {
      int mb, idx;
      tree_argmin<0, M, M>(d2, mb, idx);
      const float m = __int_as_float(mb);
      if (!(m < kHalfInf)) break;
      const float w = 1.f / (idw_pow(m, par.pow_mode, par.pow_e) + par.eps);
      num = num + w * vals[idx];
      den = den + w;
      if (s == kk - 1) break;
#pragma unroll
      for (int t = 0; t < M; ++t) d2[t] = t == idx ? kInf : d2[t];
    }
  }
  const float res = den > 0.f ? num / fmaxf(den, par.eps) : NAN;
  out[q] = pro.z != 0.f ? NAN : res;
}

// The staged builds' row loop.  A persistent grid of warps; a warp serves
// chunks of 32 queries, w, w + warps, ... .  When it issues a chunk, each
// lane computes its query's prologue once, writes (fx, fy, oob) into the
// spare 16 bytes after its row's pieces (the stride's odd unit), and the
// warp copies the 32 rows into a stage by cp.async (stage_rows, B12's
// copy); the chunks of the next kIdwStages - 1 stages are in flight while
// this one is served.  A thread's row stays in shared memory: no row in
// registers, no second prologue.
template <int M, int P, int K>
__device__ __forceinline__ void idw_staged_rows(const float* __restrict__ pack, const float* __restrict__ lons,
                                                const float* __restrict__ lats, const Taps<M>& taps,
                                                const IdwParams& par, int n, float* __restrict__ out) {
  constexpr int C = RowCopy<M>::kPieces, S = RowCopy<M>::kStride, NS = kIdwStages;
  extern __shared__ float4 row_stages[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4* stages = row_stages + warp * (NS * 32 * S);
  const long long chunks = ((long long)n + 31) / 32;
  const long long step = (long long)gridDim.x * kWarpsPerBlock;
  long long w = (long long)blockIdx.x * kWarpsPerBlock + warp;
  // chunk c's rows and prologues into stage st (nothing past the last
  // chunk), then one commit group either way, so that the groups count the
  // stages
  const auto issue = [&](long long c, int st) {
    float4* stage = stages + st * 32 * S;
    if (c < chunks) {
      const int q = (int)(c * 32) + lane;
      int cell = -1;
      if (q < n) {
        const QueryCell qc = query_cell(__ldg(lons + q), __ldg(lats + q), par.geo);
        cell = row_of(qc, par.geo.W);
        stage[lane * S + C] = make_float4(qc.fx, qc.fy, qc.oob ? 1.f : 0.f, 0.f);
      }
      stage_rows<M, P>(pack, cell, stage, lane);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue(w + i * step, i);
  for (int st = 0; w < chunks; w += step) {
    issue(w + (NS - 1) * step, st == 0 ? NS - 1 : st - 1);  // the stage served last
    cp_async_wait<NS - 1>();  // this chunk's group is complete
    __syncwarp();
    const int q = (int)(w * 32) + lane;
    if (q < n) idw_staged_query<M, K>(stages + st * 32 * S + lane * S, taps, par, q, out);
    __syncwarp();  // every lane is done with stage st before it is copied into again
    st = st + 1 == NS ? 0 : st + 1;
  }
}

// A staged build on an aligned pack runs idw_staged_rows; any other build,
// or any pack 4 bytes off, takes B12's loop with rows straight into
// registers, one query a thread (window_rows<M, P, false>, idw_query).
template <int M, int P, int K>
__global__ void __launch_bounds__(kSelThreads, kIdwMinBlocks<M>)
window_idw_kernel(const float* __restrict__ pack, const float* __restrict__ lons, const float* __restrict__ lats,
                  const __grid_constant__ Taps<M> taps, const IdwParams par, int n, int vec,
                  float* __restrict__ out) {
  if constexpr (kIdwStaged<M>) {
    if (vec) {
      idw_staged_rows<M, P, K>(pack, lons, lats, taps, par, n, out);
      return;
    }
  }
  window_rows<M, P, false>(pack, lons, lats, par.geo, n, vec,
                           [&](const float(&val)[M], const QueryCell& qc, float, float, int q) {
                             idw_query<M, K>(val, qc, taps, par, q, out);
                           });
}

// A B15 build's dynamic shared memory on an aligned pack: the staged
// builds' stages, kIdwStages x 32 rows x kStride x 16 bytes a warp.
template <int M>
constexpr int window_idw_smem() {
  return kIdwStaged<M> ? kIdwStages * kSelThreads * RowCopy<M>::kStride * 16 : 0;
}

template <int M, int P, int K>
int window_idw_resident(int* per_sm, int* sms) {
  static Residency cache[kMaxDevices];
  return residency((const void*)window_idw_kernel<M, P, K>, window_idw_smem<M>(), cache, per_sm, sms,
                   window_idw_smem<M>() > 0);
}

template <int M, int P, int K>
int launch_window_idw_k(cudaStream_t st, const float* pack, const float* lons, const float* lats,
                        const Taps<M>& tv, const IdwParams& par, int n, float* out) {
  int vec = ((uintptr_t)pack & 15) == 0;
  const bool staged = kIdwStaged<M> && vec;
  long long blocks = ((long long)n + kSelThreads - 1) / kSelThreads;
  if (staged) {  // persistent: as many blocks as fit, at most one a block of queries
    int per_sm = 0, sms = 0;
    const int err = window_idw_resident<M, P, K>(&per_sm, &sms);
    if (err) return err;
    const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
    blocks = blocks < resident ? blocks : resident;
  }
  void* args[] = {(void*)&pack, (void*)&lons, (void*)&lats, (void*)&tv, (void*)&par, &n, &vec, &out};
  return (int)cudaLaunchKernel((const void*)window_idw_kernel<M, P, K>, dim3((unsigned)blocks), dim3(kSelThreads),
                               args, staged ? (size_t)window_idw_smem<M>() : 0, st);
}

template <int M, int P>
int launch_window_idw(cudaStream_t st, const float* pack, const float* lons, const float* lats, const float* offs,
                      const IdwParams& par, float half, int n, float* out) {
  Taps<M> tv;
  for (int t = 0; t < M; ++t) {
    tv.x[t] = offs[t] + half;
    tv.y[t] = offs[M + t] + half;
  }
  switch (par.k) {
    case 4:
      return launch_window_idw_k<M, P, 4>(st, pack, lons, lats, tv, par, n, out);
    case 8:
      return launch_window_idw_k<M, P, 8>(st, pack, lons, lats, tv, par, n, out);
    default:
      return launch_window_idw_k<M, P, 0>(st, pack, lons, lats, tv, par, n, out);
  }
}

// B7: window top-k over the M real taps of a pack row, as B6 selects them,
// with (N, 1+3k) rows out.  One thread a query, kSelThreads a block; K is k
// where the main paths' k (4, 8) is built, so a row's length and each slot's
// place in it are known at compile time, and 0 for the build that takes any
// k.  The passes stay a loop: unrolled, they were even at k=4 and 3 % slower
// at k=8 (PERF.md).
//   - the tournament carries each tap's code in place of its index, and the
//     winner is knocked out by its code (codes are distinct);
//   - the d2 of a slot no tap fills is what the plain version's minimum over
//     all P lanes gives: the padding lanes are sentinels (3e30), so the
//     tournament's minimum over the real taps clamped at 3e30 (a real tap's
//     d2 may be inf on an inf or 1e30 query, or lie anywhere above 1.5e30);
//     NaN in every slot of a NaN query with a valid tap (jnp.min's NaN).  A
//     NaN query stops at its first pass: a DPX min of NaN bits is never
//     below 1.5e30;
//   - each thread writes its row into the block's rows in shared memory,
//     placed so that the block's span of the output and its copy there
//     share their offset within 16 bytes; then the block writes the span
//     with 16-byte stores, a scalar head and tail where the span does not
//     start or end on 16 bytes (a tail block, an output at any 4-byte
//     alignment).
template <int M, int K, bool VEC>
__global__ void __launch_bounds__(kSelThreads)
window_select_kernel(const float* __restrict__ pack, const int* __restrict__ cell,
                     const float* __restrict__ fxy, const __grid_constant__ CodedTaps<M> taps, int n, int k,
                     float* __restrict__ out) {
  constexpr int P = M <= 16 ? 16 : (M <= 32 ? 32 : 64);
  extern __shared__ float4 stage4[];
  const int kk = K > 0 ? K : k;
  const int len = 1 + 3 * kk;
  const int q0 = blockIdx.x * kSelThreads;
  const int q = q0 + threadIdx.x;
  float* const span = out + (size_t)q0 * len;
  const int a = (int)(((uintptr_t)span >> 2) & 3);
  float* const rows = reinterpret_cast<float*>(stage4) + a;
  if (q < n) {
    float* const mine = rows + threadIdx.x * len;
    const float* row = pack + (size_t)__ldg(cell + q) * P;
    const float fx = __ldg(fxy + q);
    const float fy = __ldg(fxy + n + q);
    float val[M];
    load_row<M, VEC>(row, val);
    float d2[M];
#pragma unroll
    for (int t = 0; t < M; ++t) {
      const float di = taps.x[t] - fx;
      const float dj = taps.y[t] - fy;
      d2[t] = val[t] < kHalfSentinel ? di * di + dj * dj : kInf;
    }

    int cnt = 0;
    float rest = kInf;  // the d2 of the slots no tap fills
#pragma unroll 1
    for (int s = 0; s < kk; ++s) {
      float m, v, c;
      tree_min<0, M, M>(d2, val, [&](int t) { return taps.code[t]; }, m, c, v);
      if (!(m < kHalfInf)) {
        rest = m;
        break;
      }
      mine[1 + s] = v;
      mine[1 + kk + s] = m;
      mine[1 + 2 * kk + s] = c;
      ++cnt;
      if (s == kk - 1) break;
#pragma unroll
      for (int t = 0; t < M; ++t) d2[t] = c == taps.code[t] ? kInf : d2[t];
    }
    bool nan_row = false;
    if (isnan(fx) || isnan(fy)) {
#pragma unroll
      for (int t = 0; t < M; ++t) nan_row = nan_row || val[t] < kHalfSentinel;
    }
    rest = nan_row ? NAN : fminf(rest, kInf);
    for (int s = cnt; s < kk; ++s) {
      mine[1 + s] = 0.f;
      mine[1 + kk + s] = rest;
      mine[1 + 2 * kk + s] = 0.f;
    }
    mine[0] = (float)cnt;
  }
  __syncthreads();

  const int count = min(kSelThreads, n - q0) * len;
  const int head = min((4 - a) & 3, count);
  const int body = (count - head) >> 2;
  for (int i = threadIdx.x; i < head; i += kSelThreads) span[i] = rows[i];
  float4* const span4 = reinterpret_cast<float4*>(span + head);
  const float4* const rows4 = reinterpret_cast<const float4*>(rows + head);  // a + head is 0 or 4
  for (int i = threadIdx.x; i < body; i += kSelThreads) span4[i] = rows4[i];
  for (int i = head + 4 * body + threadIdx.x; i < count; i += kSelThreads) span[i] = rows[i];
}

template <int M, int K, bool VEC>
int launch_window_kernel(dim3 g, cudaStream_t st, const float* pack, const int* cell, const float* fxy,
                         const CodedTaps<M>& tv, int n, int k, float* out) {
  const size_t smem = sizeof(float) * ((size_t)kSelThreads * (1 + 3 * k) + 4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(window_select_kernel<M, K, VEC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  window_select_kernel<M, K, VEC><<<g, kSelThreads, smem, st>>>(pack, cell, fxy, tv, n, k, out);
  return (int)cudaGetLastError();
}

template <int M, bool VEC>
int launch_window_k(dim3 g, cudaStream_t st, const float* pack, const int* cell, const float* fxy,
                    const CodedTaps<M>& tv, int n, int k, float* out) {
  switch (k) {
    case 4:
      return launch_window_kernel<M, 4, VEC>(g, st, pack, cell, fxy, tv, n, k, out);
    case 8:
      return launch_window_kernel<M, 8, VEC>(g, st, pack, cell, fxy, tv, n, k, out);
    default:
      return launch_window_kernel<M, 0, VEC>(g, st, pack, cell, fxy, tv, n, k, out);
  }
}

template <int M>
int launch_window(bool vec, dim3 g, cudaStream_t st, const float* pack, const int* cell, const float* fxy,
                  const float* taps, int n, int k, float* out) {
  CodedTaps<M> tv;
  for (int t = 0; t < M; ++t) {
    tv.x[t] = taps[t];
    tv.y[t] = taps[M + t];
    tv.code[t] = taps[2 * M + t];
  }
  return vec ? launch_window_k<M, true>(g, st, pack, cell, fxy, tv, n, k, out)
             : launch_window_k<M, false>(g, st, pack, cell, fxy, tv, n, k, out);
}

int pitch_for(int M) { return M <= 16 ? 16 : (M <= 32 ? 32 : 64); }

// B11's and B12's launch parameters: the grid's scalars (geo, as for
// auvtpu_select_krige), the variogram's by value (vario) or through device
// addresses where they are not null, the resolved row's threshold.
KrigeParams krige_params(int W, int H, const float* geo, const float* vario, const void* p_nugget,
                         const void* p_sill, const void* p_range, int has_resolve, float resolve_thresh) {
  KrigeParams par;
  par.geo = QueryGeom{geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], W, H};
  par.lon_step = geo[6];
  par.lat_step = geo[7];
  par.half = geo[8];
  par.pivot_tol = geo[9];
  par.resolve_thresh = resolve_thresh;
  par.has_resolve = has_resolve != 0;
  const void* ptrs[3] = {p_nugget, p_sill, p_range};
  for (int i = 0; i < 3; ++i) {
    par.vario[i] = vario[i];
    par.p_vario[i] = (const float*)ptrs[i];
  }
  return par;
}

// B15's resources, for auvtpu_window_idw_attributes.
template <int M, int P, int K>
int window_idw_attributes(int* out) {
  int per_sm = 0, sms = 0;
  const int err = window_idw_resident<M, P, K>(&per_sm, &sms);
  if (err) return err;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, (const void*)window_idw_kernel<M, P, K>);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = per_sm;
  out[3] = window_idw_smem<M>();
  out[4] = kIdwStaged<M> ? kIdwStages : 0;
  return 0;
}

}  // namespace

extern "C" {

// B5.  pack: (cells, P) f32, 16-byte aligned, P in {16, 32, 64}; cell: (n,)
// int32; fxy: (2, n) f32; tab: (3, P) f32 (dx, dy, code); 1 <= k <= P;
// out: (1+2k[+k][+1], n) f32 rows.
int auvtpu_scattered_select(const void* pack, int P, const void* cell, const void* fxy, const void* tab, int n,
                            int k, int emit_d2, float half, int has_resolve, float resolve_thresh, void* out,
                            void* stream) {
  if (k < 1 || k > P || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const dim3 g((unsigned)((n + kThreads - 1) / kThreads));
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)pack;
  const int* c = (const int*)cell;
  const float* f = (const float*)fxy;
  const float* t = (const float*)tab;
  float* o = (float*)out;
  switch (P) {
    case 16:
      select_kernel<16><<<g, kThreads, 0, st>>>(p, c, f, t, n, k, emit_d2, half, has_resolve, resolve_thresh, o);
      break;
    case 32:
      select_kernel<32><<<g, kThreads, 0, st>>>(p, c, f, t, n, k, emit_d2, half, has_resolve, resolve_thresh, o);
      break;
    case 64:
      select_kernel<64><<<g, kThreads, 0, st>>>(p, c, f, t, n, k, emit_d2, half, has_resolve, resolve_thresh, o);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// B6.  pack: (cells, P) f32 with P the smallest of 16, 32, 64 that holds M;
// M, the real taps a row, in {9, 16, 25, 49} (windows of radius 1-3, the
// valid16 stencil); lons, lats: (n,) f32 queries; taps: 2*M f32 on the
// host, dx + half of each tap then dy + half; W, H the grid's columns and
// rows; geo: min_lon, max_lon, min_lat, max_lat, inv_lon, inv_lat (f32 on
// the host, passed by value, as for auvtpu_select_krige); 1 <= k <= P;
// out: (1[+1], n) f32 = the IDW value (, resolved).  A pack that is not
// 16-byte aligned takes scalar loads.  One kernel launch, nothing else on
// the stream.
int auvtpu_idw_select(const void* pack, int P, int M, const void* lons, const void* lats, const float* taps,
                      int n, int W, int H, const float* geo, int k, int has_resolve, float resolve_thresh,
                      float eps, void* out, void* stream) {
  if (P != pitch_for(M) || k < 1 || k > P || n < 0 || W < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const dim3 g((unsigned)((n + kSelThreads - 1) / kSelThreads));
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)pack;
  const float *lo = (const float*)lons, *la = (const float*)lats;
  const QueryGeom gm{geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], W, H};
  float* o = (float*)out;
  const bool vec = ((uintptr_t)pack & 15) == 0;
  switch (M) {
    case 9:
      return launch_idw<9, 16>(vec, g, st, p, lo, la, taps, gm, n, k, has_resolve, resolve_thresh, eps, o);
    case 16:
      return launch_idw<16, 16>(vec, g, st, p, lo, la, taps, gm, n, k, has_resolve, resolve_thresh, eps, o);
    case 25:
      return launch_idw<25, 32>(vec, g, st, p, lo, la, taps, gm, n, k, has_resolve, resolve_thresh, eps, o);
    case 49:
      return launch_idw<49, 64>(vec, g, st, p, lo, la, taps, gm, n, k, has_resolve, resolve_thresh, eps, o);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// B11.  pack: (cells, P) f32, 16-byte aligned, P the smallest of 16, 32,
// 64 that holds M; M, the real taps a row, in {9, 16, 25, 49} (windows of
// radius 1-3, the valid16 stencil); lons, lats: (n,) f32 queries; offs: 2*M
// f32 on the host, dx of each tap, then dy (integers, |dx|, |dy| <= 7);
// geo: min_lon, max_lon, min_lat, max_lat, inv_lon, inv_lat, lon_step,
// lat_step, half, pivot_tol (f32 on the host, passed by value; inv_* the
// reciprocals of grid.py's inv_steps); W, H the grid's columns and rows;
// vario, p_nugget, p_sill, p_range as for auvtpu_kriging_fill; model 0..3
// (exponential, linear, spherical, gaussian); out: (1[+1], n) f32 =
// prediction (, resolved).  One kernel launch, nothing else on the stream.
int auvtpu_select_krige(const void* pack, int P, int M, const void* lons, const void* lats, const float* offs,
                        int n, int W, int H, const float* geo, const float* vario, const void* p_nugget,
                        const void* p_sill, const void* p_range, int model, int has_resolve, float resolve_thresh,
                        void* out, void* stream) {
  if (P != pitch_for(M) || model < 0 || model > 3 || n < 0 || W < 1 || H < 1 || ((uintptr_t)pack & 15))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const KrigeParams par = krige_params(W, H, geo, vario, p_nugget, p_sill, p_range, has_resolve, resolve_thresh);
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)pack;
  const float *lo = (const float*)lons, *la = (const float*)lats;
  float* o = (float*)out;
  switch (M) {
    case 9:
      return launch_krige<9, 16>(st, p, lo, la, offs, par, model, n, o);
    case 16:
      return launch_krige<16, 16>(st, p, lo, la, offs, par, model, n, o);
    case 25:
      return launch_krige<25, 32>(st, p, lo, la, offs, par, model, n, o);
    case 49:
      return launch_krige<49, 64>(st, p, lo, la, offs, par, model, n, o);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// B12.  pack: (cells, P) f32, P the smallest of 16, 32, 64 that holds M;
// M, the real taps a row, in {9, 25, 49} (windows of radius 1-3); lons,
// lats, offs, W, H, geo, vario, p_nugget, p_sill, p_range and model as for
// auvtpu_select_krige; out: (n,) f32 = the prediction.  A pack that is not
// 16-byte aligned takes scalar loads.  One kernel launch, nothing else on
// the stream.
int auvtpu_window_krige(const void* pack, int P, int M, const void* lons, const void* lats, const float* offs,
                        int n, int W, int H, const float* geo, const float* vario, const void* p_nugget,
                        const void* p_sill, const void* p_range, int model, void* out, void* stream) {
  if (P != pitch_for(M) || model < 0 || model > 3 || n < 0 || W < 1 || H < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const KrigeParams par = krige_params(W, H, geo, vario, p_nugget, p_sill, p_range, 0, 0.f);
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)pack;
  const float *lo = (const float*)lons, *la = (const float*)lats;
  float* o = (float*)out;
  switch (M) {
    case 9:
      return launch_window_krige<9, 16>(st, p, lo, la, offs, par, model, n, o);
    case 25:
      return launch_window_krige<25, 32>(st, p, lo, la, offs, par, model, n, o);
    case 49:
      return launch_window_krige<49, 64>(st, p, lo, la, offs, par, model, n, o);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// B11's build for M taps and a model: out[0..3] = registers a thread, local
// (spill) bytes a thread, resident blocks an SM (the occupancy calculator's,
// at kSelThreads a block).  For the resource report of chip_smoke.py.
int auvtpu_select_krige_attributes(int M, int model, int* out) {
  if (model < 0 || model > 3) return (int)cudaErrorInvalidValue;
  const void* fn;
  switch (M) {
    case 9: fn = krige_kernel<9, 16>(model); break;
    case 16: fn = krige_kernel<16, 16>(model); break;
    case 25: fn = krige_kernel<25, 32>(model); break;
    case 49: fn = krige_kernel<49, 64>(model); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kSelThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  return 0;
}

// B12's build for M taps and a model: out[0..3] = registers a thread, local
// (spill) bytes a thread, resident blocks an SM at its shared memory,
// dynamic shared memory bytes a block.  For the resource report of
// chip_smoke.py and scripts/b12_variant_probe.py.
int auvtpu_window_krige_attributes(int M, int model, int* out) {
  if (model < 0 || model > 3) return (int)cudaErrorInvalidValue;
  const void* fn;
  int per_sm = 0, sms = 0, err, smem;
  switch (M) {
    case 9: fn = window_krige_fn<9, 16>(model); err = window_krige_resident<9, 16>(model, &per_sm, &sms);
      smem = window_krige_smem<9>(); break;
    case 25: fn = window_krige_fn<25, 32>(model); err = window_krige_resident<25, 32>(model, &per_sm, &sms);
      smem = window_krige_smem<25>(); break;
    case 49: fn = window_krige_fn<49, 64>(model); err = window_krige_resident<49, 64>(model, &per_sm, &sms);
      smem = window_krige_smem<49>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = per_sm;
  out[3] = smem;
  return 0;
}

// B15.  pack, P, M, lons, lats, offs, n, W, H and geo as for
// auvtpu_window_krige (geo[8] the half of the convention); 1 <= k <= P;
// pow_mode (IdwPow) and pow_e = power / 2 the weights' power; eps
// IDWConfig(k, power).eps; out: (n,) f32 = the IDW value.  A pack that is
// not 16-byte aligned takes scalar loads.  One kernel launch, nothing else
// on the stream.
int auvtpu_window_idw(const void* pack, int P, int M, const void* lons, const void* lats, const float* offs, int n,
                      int W, int H, const float* geo, int k, int pow_mode, float pow_e, float eps, void* out,
                      void* stream) {
  if (P != pitch_for(M) || k < 1 || k > P || pow_mode < kPowOne || pow_mode > kPowGeneral || n < 0 || W < 1 ||
      H < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  IdwParams par;
  par.geo = QueryGeom{geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], W, H};
  par.k = k;
  par.pow_mode = pow_mode;
  par.pow_e = pow_e;
  par.eps = eps;
  const float half = geo[8];
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)pack;
  const float *lo = (const float*)lons, *la = (const float*)lats;
  float* o = (float*)out;
  switch (M) {
    case 9:
      return launch_window_idw<9, 16>(st, p, lo, la, offs, par, half, n, o);
    case 25:
      return launch_window_idw<25, 32>(st, p, lo, la, offs, par, half, n, o);
    case 49:
      return launch_window_idw<49, 64>(st, p, lo, la, offs, par, half, n, o);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// B15's build for M taps and k (4, 8, or any other for the general build):
// out[0..3] as for auvtpu_window_krige_attributes (the blocks an SM at the
// build's shared memory on an aligned pack), out[4] its stages (0: rows in
// registers).
int auvtpu_window_idw_attributes(int M, int k, int* out) {
  switch (M * 100 + (k == 4 || k == 8 ? k : 0)) {
    case 904: return window_idw_attributes<9, 16, 4>(out);
    case 908: return window_idw_attributes<9, 16, 8>(out);
    case 900: return window_idw_attributes<9, 16, 0>(out);
    case 2504: return window_idw_attributes<25, 32, 4>(out);
    case 2508: return window_idw_attributes<25, 32, 8>(out);
    case 2500: return window_idw_attributes<25, 32, 0>(out);
    case 4904: return window_idw_attributes<49, 64, 4>(out);
    case 4908: return window_idw_attributes<49, 64, 8>(out);
    case 4900: return window_idw_attributes<49, 64, 0>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// B7.  pack: (cells, P) f32 with P the smallest of 16, 32, 64 that holds M;
// M, the real taps a row, in {9, 25, 49} (windows of radius 1-3); taps: 3*M
// f32 on the host, dx + half of each tap, then dy + half, then its code
// (dx + R) * B + (dy + R); cell: (n,) int32; fxy: (2, n) f32; 1 <= k <= P;
// out: (n, 1+3k) f32 = cnt, k values, k d2, k codes, at any 4-byte
// alignment.  A pack that is not 16-byte aligned takes scalar loads.
int auvtpu_window_select(const void* pack, int P, int M, const void* cell, const void* fxy, const float* taps,
                         int n, int k, void* out, void* stream) {
  if (P != pitch_for(M) || k < 1 || k > P || n < 0 || ((uintptr_t)out & 3)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const dim3 g((unsigned)((n + kSelThreads - 1) / kSelThreads));
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)pack;
  const int* c = (const int*)cell;
  const float* f = (const float*)fxy;
  float* o = (float*)out;
  const bool vec = ((uintptr_t)pack & 15) == 0;
  switch (M) {
    case 9:
      return launch_window<9>(vec, g, st, p, c, f, taps, n, k, o);
    case 25:
      return launch_window<25>(vec, g, st, p, c, f, taps, n, k, o);
    case 49:
      return launch_window<49>(vec, g, st, p, c, f, taps, n, k, o);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* auvtpu_scattered_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
