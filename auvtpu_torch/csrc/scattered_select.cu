// k-nearest selection for scattered queries over stencil packs, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// auvtpu_torch/kernels/scattered_select.py.
//
// Replaces three TPU kernels with two kernels:
//   select_kernel<P, kRowsT>      <- pallas/valid_select.py::_sel_kernel
//                                    (B5: valid_select_t, pallas_kriging_valid,
//                                    pallas_packed_kriging_t)
//   select_kernel<P, kRowsN>      <- pallas/scattered_select.py::_make_select_kernel
//                                    (B7: pallas_window_select)
//   idw_select_kernel<M, P, VEC>  <- pallas/valid_select.py::_idw_kernel
//                                    (B6: pallas_packed_idw_t)
// The TPU kernels differ in layout only: (P, N) transposed stencils and
// (N, 128) pack rows with a one-hot sub-block pick are the TPU's ways around
// its gather unit.  On Hopper each query is one thread that reads its own
// contiguous pack floats.
//
// What they compute.  Per query: the taps of its centre cell's pack row (a
// sentinel >= 0.5e30 marks an invalid or out-of-grid tap); the squared
// distance d2 = ((dx+half)-fx)^2 + ((dy+half)-fy)^2 to each valid tap, in
// exactly that op order (valid_select.py:84-87, scattered_select.py:83-85),
// 3e30 at invalid taps; then k passes of min-extract, each a strict `<` scan
// in table order, so the lowest table index (collection order) wins a tie,
// as the lowest sublane or lane does on the TPU.  A pass whose minimum is
// not below 1.5e30 takes no slot and knocks nothing out (a NaN query: its
// d2 are NaN, no `<` sees them).  Each slot is written as soon as it is
// found, so no slot array is indexed.  An empty slot carries value 0 and
// code 0 (the TPU kernels' all-zero one-hot); the kriging epilogue relies
// on it (fb = sum(vals)/max(found,1)).
//   kRowsT (B5): rows (1+2k[+k][+1], N) = cnt, k values, (k d2), k codes,
//                (resolved).  The code table is dy-major (valid_select.py:74).
//   kRowsN (B7): rows (N, 1+3k) = cnt, k values, k d2, k codes, the code
//                table dx-major (scattered_select.py:66); the d2 of a slot
//                is the pass's minimum as it is: 3e30 at an empty slot, NaN
//                on a NaN query, as jnp.min gives it.
//   B6:          rows (2[+1], N) = sum w*v, sum w with w = 1/(d2+eps) per
//                found slot (power 2, valid_select.py:126-138), (resolved).
// "resolved" (two-tier) is written at slot k-1 only: found & (d2 <
// resolve_thresh).  The wrapper passes the code table, so select_kernel
// does not know either code layout.
//
// What bounds them on the H100.  Per query a kernel reads its pack row
// (64 B valid16, 128 B radius 2), 12 bytes of cell index and fractional
// offsets, and writes rows*4 bytes (8-52 B); it does ~7 operations a tap for
// the distances and a few compare-selects a tap and slot.  The pack rows are
// random reads (one 64-128 B segment each), not streams.  select_kernel
// (B5, B7) does the simple thing: one thread per query in 1-D blocks of
// 256; the row read as P/4 16-byte loads through the read-only cache; d2
// fully unrolled in P registers (template on P); the offset tables read at
// one address by the whole warp (a broadcast), the chosen value and code
// reloaded per slot; outputs written lanes-major (B5: coalesced) or
// row-major (B7: 1+3k floats a query, as the JAX layout is).  P is 16, 32
// or 64 (radius <= 3); radius 4 (P=128) would need 128 d2 registers and is
// refused by the wrapper.  idw_select_kernel (B6) is that kernel redesigned
// for the card: it takes the M real taps, not the P of the pitch (25 of 32
// at radius 2), takes the tap offsets as constant-bank operands instead of
// 2P loads a query, keeps the values in registers instead of reloading one
// per slot, finds each slot's minimum by a tournament (a dependency chain
// log2(M) deep, where the scan's is M deep), skips the last pass's
// knock-out and runs 128-thread blocks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInf = 3e30f;           // d2 of an invalid tap (valid_select.py:62)
constexpr float kHalfInf = 1.5e30f;     // 0.5 * kInf: "found"
constexpr float kHalfSentinel = 0.5e30f;  // 0.5 * pack sentinel: valid tap

enum Mode { kRowsT = 0, kRowsN = 2 };  // auvtpu_scattered_select's mode codes

// pack: (cells, P) f32; cell: (n,) int32; fxy: (2, n) f32 (fx row, then fy);
// tab: (3, P) f32 = dx, dy, code per tap.
template <int P, int MODE>
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
  const int code_row = 1 + (emit_d2 ? 2 : 1) * k;  // kRowsT
  float* orow = out + (size_t)q * (1 + 3 * k);     // kRowsN
  // kRowsN writes each pass's minimum as it is: jnp.min is NaN where a tap's
  // d2 is (a NaN query), and the strict-< scan would not see that NaN
  bool nan_row = false;
  if (MODE == kRowsN) {
#pragma unroll
    for (int t = 0; t < P; ++t) nan_row = nan_row || isnan(d2[t]);
  }
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
    if (MODE == kRowsT) {
      out[(1 + s) * N + q] = val;
      if (emit_d2) out[(1 + k + s) * N + q] = got ? m : kInf;
      out[(code_row + s) * N + q] = code;
    } else {
      orow[1 + s] = val;
      orow[1 + k + s] = nan_row ? NAN : m;
      orow[1 + 2 * k + s] = code;
    }
    cnt = cnt + (got ? 1.f : 0.f);
    if (s == k - 1) resolved = (got && m < resolve_thresh) ? 1.f : 0.f;
  }

  if (MODE == kRowsT) {
    out[q] = cnt;
    if (has_resolve) out[(code_row + k) * N + q] = resolved;
  } else {
    orow[0] = cnt;
  }
}

template <int P>
void launch(int mode, dim3 g, cudaStream_t st, const float* pack, const int* cell,
            const float* fxy, const float* tab, int n, int k, int emit_d2, float half,
            int has_resolve, float thresh, float* out) {
  if (mode == kRowsT)
    select_kernel<P, kRowsT><<<g, kThreads, 0, st>>>(pack, cell, fxy, tab, n, k, emit_d2, half,
                                                     has_resolve, thresh, out);
  else
    select_kernel<P, kRowsN><<<g, kThreads, 0, st>>>(pack, cell, fxy, tab, n, k, emit_d2, half,
                                                     has_resolve, thresh, out);
}

// B6: k-nearest IDW over the M real taps of a pack row (the pack's row pitch
// is P >= M; its P - M padding taps are never read).  One thread a query,
// kIdwThreads a block.
//   - taps: (dx + half, dy + half) of each tap, passed by value: the kernel
//     reads them as constant-bank operands, with no load.  dx is an integer
//     and half 0 or 0.5, so the host's sum is exact and the op order
//     (dx + half) - fx is the plain version's;
//   - the row: M values from ceil(M/4) 16-byte loads (VEC) or M scalar loads,
//     kept in registers with each tap's d2 (3e30 at an invalid tap);
//   - per slot, the lowest-index minimum and its value by a tournament over
//     the taps (tree_min: each match keeps the left, lower-index side on a
//     tie, so it is the strict-< scan's answer), log2(M) matches deep where
//     a scan is M deep, each match a DPX integer min of the d2 bits; then the
//     winner knocked out, except after the last slot.  Passes stop at the
//     first that finds no tap below 1.5e30 (no valid tap left, or a NaN or
//     out-of-range query: every later pass would find none either; on a NaN
//     query every valid tap's d2 is NaN, and no min of them is below 1.5e30);
//   - w = 1/(m + eps) as an IEEE divide, num += w*v and den += w in slot
//     order, each op rounded once (-fmad=false): bit-equal to select_ref;
//   - resolved (two-tier) at slot k - 1: found and m < resolve_thresh.
constexpr int kIdwThreads = 128;

template <int M>
struct Taps {
  float x[M];
  float y[M];
};

// The lowest-index minimum of d2[LO, LO + N) with its index and value.
template <int LO, int N, int M>
__device__ __forceinline__ void tree_min(const float (&d2)[M], const float (&val)[M], float& m, int& idx,
                                         float& v) {
  if constexpr (N == 1) {
    m = d2[LO];
    idx = LO;
    v = val[LO];
  } else {
    constexpr int L = N / 2;
    float ml, mr, vl, vr;
    int il, ir;
    tree_min<LO, L, M>(d2, val, ml, il, vl);
    tree_min<LO + L, N - L, M>(d2, val, mr, ir, vr);
    // min of the d2 bits as ints (d2 >= 0, so their order is the floats'),
    // with left = (ml <= mr): a tie keeps the left, lower-index side.  One
    // DPX instruction where a float compare and a select were two
    bool left;
    m = __int_as_float(__vibmin_s32(__float_as_int(ml), __float_as_int(mr), &left));
    idx = left ? il : ir;
    v = left ? vl : vr;
  }
}

template <int M, int P, bool VEC>
__global__ void __launch_bounds__(kIdwThreads)
idw_select_kernel(const float* __restrict__ pack, const int* __restrict__ cell,
                  const float* __restrict__ fxy, const Taps<M> taps, int n, int k, int has_resolve,
                  float resolve_thresh, float eps, float* __restrict__ out) {
  static_assert(M <= P, "a pack row holds its taps");
  const int q = blockIdx.x * kIdwThreads + threadIdx.x;
  if (q >= n) return;
  const float* row = pack + (size_t)__ldg(cell + q) * P;
  const float fx = __ldg(fxy + q);
  const float fy = __ldg(fxy + n + q);

  float val[M];
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
  float d2[M];
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const float di = taps.x[t] - fx;
    const float dj = taps.y[t] - fy;
    d2[t] = val[t] < kHalfSentinel ? di * di + dj * dj : kInf;
  }

  float num = 0.f;
  float den = 0.f;
  float resolved = 0.f;
  for (int s = 0; s < k; ++s) {
    float m, v;
    int idx;
    tree_min<0, M, M>(d2, val, m, idx, v);
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
  const size_t N = (size_t)n;
  out[q] = num;
  out[N + q] = den;
  if (has_resolve) out[2 * N + q] = resolved;
}

template <int M, int P>
int launch_idw(bool vec, dim3 g, cudaStream_t st, const float* pack, const int* cell, const float* fxy,
               const float* taps, int n, int k, int has_resolve, float thresh, float eps, float* out) {
  Taps<M> tv;
  for (int t = 0; t < M; ++t) {
    tv.x[t] = taps[t];
    tv.y[t] = taps[M + t];
  }
  if (vec)
    idw_select_kernel<M, P, true><<<g, kIdwThreads, 0, st>>>(pack, cell, fxy, tv, n, k, has_resolve, thresh,
                                                            eps, out);
  else
    idw_select_kernel<M, P, false><<<g, kIdwThreads, 0, st>>>(pack, cell, fxy, tv, n, k, has_resolve, thresh,
                                                             eps, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// pack: (cells, P) f32, 16-byte aligned, P in {16, 32, 64}; cell: (n,)
// int32; fxy: (2, n) f32; tab: (3, P) f32 (dx, dy, code); mode 0 = B5 rows,
// 2 = B7 (n, 1+3k) rows; 1 <= k <= P; out as the mode says.
int auvtpu_scattered_select(const void* pack, int P, const void* cell, const void* fxy,
                            const void* tab, int n, int k, int mode, int emit_d2, float half,
                            int has_resolve, float resolve_thresh, void* out, void* stream) {
  if ((mode != kRowsT && mode != kRowsN) || k < 1 || k > P || n < 0) return (int)cudaErrorInvalidValue;
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
      launch<16>(mode, g, st, p, c, f, t, n, k, emit_d2, half, has_resolve, resolve_thresh, o);
      break;
    case 32:
      launch<32>(mode, g, st, p, c, f, t, n, k, emit_d2, half, has_resolve, resolve_thresh, o);
      break;
    case 64:
      launch<64>(mode, g, st, p, c, f, t, n, k, emit_d2, half, has_resolve, resolve_thresh, o);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// B6.  pack: (cells, P) f32 with P the smallest of 16, 32, 64 that holds M;
// M, the real taps a row, in {9, 16, 25, 49} (windows of radius 1-3, the
// valid16 stencil); taps: 2*M f32 on the
// host, dx + half of each tap then dy + half; cell: (n,) int32; fxy: (2, n)
// f32; 1 <= k <= P; out: (2[+1], n) f32 = sum w*v, sum w (, resolved).
// A pack that is not 16-byte aligned takes scalar loads.
int auvtpu_idw_select(const void* pack, int P, int M, const void* cell, const void* fxy, const float* taps,
                      int n, int k, int has_resolve, float resolve_thresh, float eps, void* out,
                      void* stream) {
  const int want_p = M <= 16 ? 16 : (M <= 32 ? 32 : 64);
  if (P != want_p || k < 1 || k > P || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const dim3 g((unsigned)((n + kIdwThreads - 1) / kIdwThreads));
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)pack;
  const int* c = (const int*)cell;
  const float* f = (const float*)fxy;
  float* o = (float*)out;
  const bool vec = ((uintptr_t)pack & 15) == 0;
  switch (M) {
    case 9:
      return launch_idw<9, 16>(vec, g, st, p, c, f, taps, n, k, has_resolve, resolve_thresh, eps, o);
    case 16:
      return launch_idw<16, 16>(vec, g, st, p, c, f, taps, n, k, has_resolve, resolve_thresh, eps, o);
    case 25:
      return launch_idw<25, 32>(vec, g, st, p, c, f, taps, n, k, has_resolve, resolve_thresh, eps, o);
    case 49:
      return launch_idw<49, 64>(vec, g, st, p, c, f, taps, n, k, has_resolve, resolve_thresh, eps, o);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* auvtpu_scattered_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
