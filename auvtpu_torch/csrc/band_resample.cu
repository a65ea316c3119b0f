// Chunked windowed bilinear resample over K filled band pages, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// auvtpu_torch/kernels/band_resample.py.
//
// Replaces pallas/band_resample.py::_make_kernel (B8, entered through _run by
// pallas_band_resample and pallas_atlas_resample), and with it the XLA
// default of ops/band.py (_band_resample, _atlas_resample with the
// _lerp_window* builds).  On the TPU the row lerp is a one-hot row-weight
// matrix contracted on the MXU and the column pick a one-hot weighted
// reduce: ways to put a gather on the matrix unit.  On Hopper a bilinear
// sample is four loads, so this kernel reads the four corners and does the
// two lerps in registers.
//
// What it computes.  Queries come in chunks of `chunk` consecutive samples
// (an ordered survey track); one thread block serves one chunk:
//   1. block-wide min/max of the chunk's x and y (grid-frame for an atlas,
//      band-frame for a band);
//   2. with `pick`, the bbox centre c = 0.5*(min+max) and the FIRST page k
//      whose [c0, c0+C-1] x [r0, r0+R-1] holds it (argmax of `fits`,
//      ops/band.py:450-460); a chunk no page holds resolves nothing.
//      Without `pick` the page is 0;
//   3. the page origin subtracted in f32 (xb = x - c0, band.py:465-466), and
//      the window base from floor(min xb): clamp(floordiv(m, a)*a, 0, lim),
//      with a = 1 for the default geometry and a = 8 (rows) / 128 (cols)
//      for the aligned one of pallas_band_resample (_window_bases,
//      band_resample.py:153-171).  floordiv floors, as Python's // does:
//      a chunk whose min lies left of the page gets the same base as in
//      JAX (C++ '/' would truncate toward zero);
//   4. per query: x0 = floor(xb), wx = xb - x0, and the `ok` test of
//      band.py:110-113 against the window (ww, wh) and the page (C, R).
//      A query that is not ok reads no corner and gets z = NaN.  Otherwise
//      the row lerp for the two columns, then the column lerp, each a
//      two-term sum in the order of the TPU contraction.  The weights of the
//      two families are transcribed literally:
//        onehot (the Pallas kernel, lerp_mode "onehot"): (1 - f, f);
//        hat ("hat", "hat2", "hat_t"): (1 - f, 1 - (1 - f)), the hat
//        function relu(1 - |d|) at lanes i0 and i0+1 (band.py:143-151).
//      They differ for some f in [0, 0.5), where 1 - f is inexact.
//      With `masked`, the same weights on the vmask page give wsum, and
//      ok &= wsum > 1 - 1e-3 (band.py:245-246).  Planes hold 0 at undefined
//      cells, never NaN, and the NaN of an unresolved query is a select:
//      nothing multiplies a NaN.
// Built with -fmad=false, so each product and sum rounds once, as the plain
// torch version (band_resample_ref) computes them: the two are bit-equal.
//
// What bounds it on the H100.  Per query it reads x and y (8 B) and writes
// z and ok (5 B); per chunk it touches one (wh, ww) window of the page (the
// corners are read from global memory, through L1/L2, not staged in shared
// memory), and does ~25 f32 operations a query.  At 13 B and ~25
// operations a query it is bound by the bytes.  The design: one block of 256
// threads per chunk, several queries a thread (8 at chunk 2048), two passes
// over the chunk's coordinates (reduction, then the lerps; the second reads
// hit L1/L2), warp-shuffle reductions, the page pick by one thread.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// planes, vmasks: (K, R, C) f32; origins: (K, 2) f32 (row0, col0);
// x, y: (n,) f32, n a multiple of chunk; z: (n,) f32; ok: (n,) uint8.
// Window (wh, ww) with alignment (ar, ac) and base limits (lim_r, lim_c);
// thresh is 1 - 1e-3 rounded to f32 by the caller.
__global__ void __launch_bounds__(kThreads)
band_resample_kernel(const float* __restrict__ planes, const float* __restrict__ vmasks,
                     const float* __restrict__ origins, int K, int R, int C,
                     const float* __restrict__ x, const float* __restrict__ y, int chunk,
                     int wh, int ww, int ar, int ac, int lim_r, int lim_c, int masked,
                     int pick, int hat, float thresh, float* __restrict__ z,
                     uint8_t* __restrict__ ok) {
  __shared__ float red[4][kWarps];
  __shared__ float s_org[2];
  __shared__ int s_geo[4];  // page, any_fit, bx, by
  const size_t base = (size_t)blockIdx.x * chunk;
  const float* xc = x + base;
  const float* yc = y + base;

  // 1. min/max of the chunk's coordinates
  float xmin = INFINITY, xmax = -INFINITY, ymin = INFINITY, ymax = -INFINITY;
  for (int i = threadIdx.x; i < chunk; i += kThreads) {
    const float xi = __ldg(xc + i);
    const float yi = __ldg(yc + i);
    xmin = fminf(xmin, xi);
    xmax = fmaxf(xmax, xi);
    ymin = fminf(ymin, yi);
    ymax = fmaxf(ymax, yi);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    xmin = fminf(xmin, __shfl_xor_sync(0xffffffffu, xmin, o));
    xmax = fmaxf(xmax, __shfl_xor_sync(0xffffffffu, xmax, o));
    ymin = fminf(ymin, __shfl_xor_sync(0xffffffffu, ymin, o));
    ymax = fmaxf(ymax, __shfl_xor_sync(0xffffffffu, ymax, o));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = xmin;
    red[1][warp] = xmax;
    red[2][warp] = ymin;
    red[3][warp] = ymax;
  }
  __syncthreads();

  // 2-3. page pick, origin, window base (one thread)
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      xmin = fminf(xmin, red[0][w]);
      xmax = fmaxf(xmax, red[1][w]);
      ymin = fminf(ymin, red[2][w]);
      ymax = fmaxf(ymax, red[3][w]);
    }
    int page = 0;
    int any_fit = 1;
    if (pick) {
      const float cx = 0.5f * (xmin + xmax);
      const float cy = 0.5f * (ymin + ymax);
      any_fit = 0;
      for (int k = 0; k < K; ++k) {
        const float r0 = origins[2 * k];
        const float c0 = origins[2 * k + 1];
        if (cx >= c0 && cx <= c0 + (float)(C - 1) && cy >= r0 && cy <= r0 + (float)(R - 1)) {
          page = k;
          any_fit = 1;
          break;
        }
      }
    }
    const float org_r = origins[2 * page];
    const float org_c = origins[2 * page + 1];
    // min over floor(x - c0) == floor(min(x) - c0): the f32 subtraction and
    // floor are both monotone
    const int mx0 = (int)floorf(xmin - org_c);
    const int my0 = (int)floorf(ymin - org_r);
    s_geo[0] = page;
    s_geo[1] = any_fit;
    s_geo[2] = clampi(floordiv(mx0, ac) * ac, 0, lim_c);
    s_geo[3] = clampi(floordiv(my0, ar) * ar, 0, lim_r);
    s_org[0] = org_r;
    s_org[1] = org_c;
  }
  __syncthreads();
  const int page = s_geo[0];
  const bool any_fit = s_geo[1] != 0;
  const int bx = s_geo[2];
  const int by = s_geo[3];
  const float org_r = s_org[0];
  const float org_c = s_org[1];
  const size_t plane_off = (size_t)page * R * C;
  const float* p = planes + plane_off;
  const float* m = masked ? vmasks + plane_off : nullptr;

  // 4. per query
  for (int i = threadIdx.x; i < chunk; i += kThreads) {
    const float xb = __ldg(xc + i) - org_c;
    const float yb = __ldg(yc + i) - org_r;
    const float fx0 = floorf(xb);
    const float fy0 = floorf(yb);
    const int x0 = (int)fx0;
    const int y0 = (int)fy0;
    const int lx0 = x0 - bx;
    const int ly0 = y0 - by;
    bool good = any_fit && lx0 >= 0 && lx0 <= ww - 2 && ly0 >= 0 && ly0 <= wh - 2 && x0 >= 0 &&
                x0 <= C - 2 && y0 >= 0 && y0 <= R - 2;
    float out = NAN;
    if (good) {
      const float wx = xb - fx0;
      const float wy = yb - fy0;
      const float ax0 = 1.f - wx;
      const float ax1 = hat ? 1.f - (1.f - wx) : wx;
      const float ay0 = 1.f - wy;
      const float ay1 = hat ? 1.f - (1.f - wy) : wy;
      const size_t i00 = (size_t)y0 * C + x0;
      const size_t i10 = i00 + C;
      const float ra = ay0 * __ldg(p + i00) + ay1 * __ldg(p + i10);
      const float rb = ay0 * __ldg(p + i00 + 1) + ay1 * __ldg(p + i10 + 1);
      const float zz = ax0 * ra + ax1 * rb;
      if (masked) {
        const float ma = ay0 * __ldg(m + i00) + ay1 * __ldg(m + i10);
        const float mb = ay0 * __ldg(m + i00 + 1) + ay1 * __ldg(m + i10 + 1);
        good = ax0 * ma + ax1 * mb > thresh;
      }
      if (good) out = zz;
    }
    z[base + i] = out;
    ok[base + i] = good ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// planes, vmasks: (K, R, C) f32 (vmasks may be null when !masked); origins:
// (K, 2) f32; x, y: (n,) f32 with n % chunk == 0; z: (n,) f32; ok: (n,)
// uint8.  Returns the launch's cudaError_t.
int auvtpu_band_resample(const void* planes, const void* vmasks, const void* origins, int K,
                         int R, int C, const void* x, const void* y, int n, int chunk, int wh,
                         int ww, int ar, int ac, int lim_r, int lim_c, int masked, int pick,
                         int hat, float thresh, void* z, void* ok, void* stream) {
  if (K < 1 || R < 1 || C < 1 || chunk < 1 || n < 0 || n % chunk || wh < 1 || ww < 1 ||
      ar < 1 || ac < 1 || lim_r < 0 || lim_c < 0 || (masked && vmasks == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  band_resample_kernel<<<(unsigned)(n / chunk), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)planes, (const float*)vmasks, (const float*)origins, K, R, C,
      (const float*)x, (const float*)y, chunk, wh, ww, ar, ac, lim_r, lim_c, masked, pick, hat,
      thresh, (float*)z, (uint8_t*)ok);
  return (int)cudaGetLastError();
}

const char* auvtpu_band_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
