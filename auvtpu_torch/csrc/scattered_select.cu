// k-nearest selection for scattered queries over stencil packs, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// auvtpu_torch/kernels/scattered_select.py.
//
// Replaces three TPU kernels with one templated kernel:
//   select_kernel<P, kRowsT> <- pallas/valid_select.py::_sel_kernel
//                               (B5: valid_select_t, pallas_kriging_valid,
//                               pallas_packed_kriging_t)
//   select_kernel<P, kIdw>   <- pallas/valid_select.py::_idw_kernel
//                               (B6: pallas_packed_idw_t)
//   select_kernel<P, kRowsN> <- pallas/scattered_select.py::_make_select_kernel
//                               (B7: pallas_window_select)
// The three TPU kernels differ in layout only: (P, N) transposed stencils
// and (N, 128) pack rows with a one-hot sub-block pick are the TPU's ways
// around its gather unit.  On Hopper each query is one thread that reads
// its own P contiguous pack floats.
//
// What it computes.  Per query: the P taps of its centre cell's pack row
// (a sentinel >= 0.5e30 marks an invalid or out-of-grid tap); the squared
// distance d2 = ((dx+half)-fx)^2 + ((dy+half)-fy)^2 to each valid tap, in
// exactly that op order (valid_select.py:84-87, scattered_select.py:83-85),
// 3e30 at invalid taps; then k passes of min-extract, each a strict `<` scan
// in table order, so the lowest table index (collection order) wins a tie,
// as the lowest sublane or lane does on the TPU.  Each slot is written as
// soon as it is found, so no slot array is indexed.  An empty slot carries
// value 0 and code 0 (the TPU kernels' all-zero one-hot); the kriging
// epilogue relies on it (fb = sum(vals)/max(found,1)).
//   kRowsT (B5): rows (1+2k[+k][+1], N) = cnt, k values, (k d2), k codes,
//                (resolved).  The code table is dy-major (valid_select.py:74).
//   kIdw   (B6): rows (2[+1], N) = sum w*v, sum w with w = 1/(d2+eps) per
//                found slot (power 2, valid_select.py:126-138), (resolved).
//   kRowsN (B7): rows (N, 1+3k) = cnt, k values, k d2, k codes, the code
//                table dx-major (scattered_select.py:66); an empty slot's
//                d2 is 3e30.
// "resolved" (two-tier) is written at slot k-1 only: found & (d2 <
// resolve_thresh).  The wrapper passes the code table, so the kernel does
// not know either code layout.
//
// What bounds it on the H100.  Per query the kernel reads P*4 bytes of pack
// (64 B valid16, 128 B radius 2), 12 bytes of cell index and fractional
// offsets, and writes rows*4 bytes (20-52 B); it does ~7*P operations for
// the distances and k*P compare-selects.  At 256-byte reads per 8 queries'
// worth of arithmetic it is bound by the bytes, and the pack rows are
// random reads (one 64-128 B segment each), not streams.  The design does
// the simple thing: one thread per query in 1-D blocks of 256; the row read
// as P/4 16-byte loads through the read-only cache; d2 fully unrolled in P
// registers (template on P); the offset tables read at one address by the
// whole warp (a broadcast); outputs written lanes-major (B5, B6: coalesced)
// or row-major (B7: 1+3k floats a query, as the JAX layout is).  P is 16,
// 32 or 64 (radius <= 3); radius 4 (P=128) would need 128 d2 registers and
// is refused by the wrapper.  A solve fused into B5 and reads of the grid
// through L2 instead of the 16-32x pack are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInf = 3e30f;           // d2 of an invalid tap (valid_select.py:62)
constexpr float kHalfInf = 1.5e30f;     // 0.5 * kInf: "found"
constexpr float kHalfSentinel = 0.5e30f;  // 0.5 * pack sentinel: valid tap

enum Mode { kRowsT = 0, kIdw = 1, kRowsN = 2 };

// pack: (cells, P) f32; cell: (n,) int32; fxy: (2, n) f32 (fx row, then fy);
// tab: (3, P) f32 = dx, dy, code per tap.
template <int P, int MODE>
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ pack, const int* __restrict__ cell,
              const float* __restrict__ fxy, const float* __restrict__ tab, int n, int k,
              int emit_d2, float half, int has_resolve, float resolve_thresh, float eps,
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
  float cnt = 0.f;
  float num = 0.f;
  float den = 0.f;
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
#pragma unroll
    for (int t = 0; t < P; ++t) d2[t] = (t == idx) ? kInf : d2[t];
    const float val = got ? __ldg(row + idx) : 0.f;
    if (MODE == kIdw) {
      const float w = got ? 1.f / (m + eps) : 0.f;
      num = num + w * val;
      den = den + w;
    } else {
      const float code = got ? __ldg(tab + 2 * P + idx) : 0.f;
      if (MODE == kRowsT) {
        out[(1 + s) * N + q] = val;
        if (emit_d2) out[(1 + k + s) * N + q] = got ? m : kInf;
        out[(code_row + s) * N + q] = code;
      } else {
        orow[1 + s] = val;
        orow[1 + k + s] = m;
        orow[1 + 2 * k + s] = code;
      }
    }
    cnt = cnt + (got ? 1.f : 0.f);
    if (s == k - 1) resolved = (got && m < resolve_thresh) ? 1.f : 0.f;
  }

  if (MODE == kIdw) {
    out[q] = num;
    out[N + q] = den;
    if (has_resolve) out[2 * N + q] = resolved;
  } else if (MODE == kRowsT) {
    out[q] = cnt;
    if (has_resolve) out[(code_row + k) * N + q] = resolved;
  } else {
    orow[0] = cnt;
  }
}

template <int P>
void launch(int mode, dim3 g, cudaStream_t st, const float* pack, const int* cell,
            const float* fxy, const float* tab, int n, int k, int emit_d2, float half,
            int has_resolve, float thresh, float eps, float* out) {
  if (mode == kRowsT)
    select_kernel<P, kRowsT><<<g, kThreads, 0, st>>>(pack, cell, fxy, tab, n, k, emit_d2, half,
                                                     has_resolve, thresh, eps, out);
  else if (mode == kIdw)
    select_kernel<P, kIdw><<<g, kThreads, 0, st>>>(pack, cell, fxy, tab, n, k, emit_d2, half,
                                                   has_resolve, thresh, eps, out);
  else
    select_kernel<P, kRowsN><<<g, kThreads, 0, st>>>(pack, cell, fxy, tab, n, k, emit_d2, half,
                                                     has_resolve, thresh, eps, out);
}

}  // namespace

extern "C" {

// pack: (cells, P) f32, 16-byte aligned, P in {16, 32, 64}; cell: (n,)
// int32; fxy: (2, n) f32; tab: (3, P) f32 (dx, dy, code); mode 0 = B5 rows,
// 1 = B6 IDW sums, 2 = B7 (n, 1+3k) rows; 1 <= k <= P; out as the mode says.
int auvtpu_scattered_select(const void* pack, int P, const void* cell, const void* fxy,
                            const void* tab, int n, int k, int mode, int emit_d2, float half,
                            int has_resolve, float resolve_thresh, float eps, void* out,
                            void* stream) {
  if (mode < 0 || mode > 2 || k < 1 || k > P || n < 0) return (int)cudaErrorInvalidValue;
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
      launch<16>(mode, g, st, p, c, f, t, n, k, emit_d2, half, has_resolve, resolve_thresh, eps, o);
      break;
    case 32:
      launch<32>(mode, g, st, p, c, f, t, n, k, emit_d2, half, has_resolve, resolve_thresh, eps, o);
      break;
    case 64:
      launch<64>(mode, g, st, p, c, f, t, n, k, emit_d2, half, has_resolve, resolve_thresh, eps, o);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* auvtpu_scattered_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
