// Chunked windowed bilinear resample over K filled band pages, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// auvtpu_torch/kernels/band_resample.py.
//
// Replaces pallas/band_resample.py::_make_kernel (B8, entered through _run by
// pallas_band_resample and pallas_atlas_resample), and with it the XLA
// default of ops/band.py (_band_resample, _atlas_resample with the
// _lerp_window* builds) and the coordinate prologue in front of them
// (lonlat_to_xy, the band shift, the pad to whole chunks).  On the TPU the
// row lerp is a one-hot row-weight matrix contracted on the MXU and the
// column pick a one-hot weighted reduce: ways to put a gather on the matrix
// unit.  On Hopper a bilinear sample is four loads, so this kernel reads the
// four corners and does the two lerps in registers.
//
// What it computes.  Queries come in chunks of `chunk` consecutive samples
// (an ordered survey track); one thread block serves one chunk:
//   0. the prologue: x = (u - u0) / du - su and y = (v - v0) / dv - sv, each
//      operation rounded once (IEEE '/', -fmad=false): with the grid's
//      origin and step and a band's (col0, row0) this is ops/band.py's _xy
//      and band shift bit for bit, with (0, 1, 0) it is the identity.  It
//      divides, where the scattered ops' prologue multiplies by the
//      reciprocal step: its JAX callers (the resamplers and the router of
//      auvtpu/ops/band.py) run lonlat_to_xy outside any jit, so no constant
//      step is folded there;
//   1. block-wide min/max of the chunk's x and y over its real queries (the
//      last chunk may be ragged: the JAX package pads it with its last
//      query, which changes neither the min nor the max).  The min carries
//      a NaN (min.NaN, as jnp.min; fminf would drop it), the max need not:
//      a NaN min makes the bbox centre NaN, which fits no page (step 2),
//      and the window base 0 (step 3);
//   2. with `pick`, the bbox centre c = 0.5*(min+max) and the FIRST page k
//      whose [c0, c0+C-1] x [r0, r0+R-1] holds it (argmax of `fits`,
//      ops/band.py:450-460); a chunk no page holds resolves nothing, nor
//      does a chunk with a NaN coordinate (jnp.min/jnp.max carry it).
//      Without `pick` the page is 0; without origins every page is at (0, 0);
//   3. the page origin subtracted in f32 (xb = x - c0, band.py:465-466), and
//      the window base from m, the min of the chunk's int32 casts of
//      floor(xb) as XLA casts (band.py:100-101, :468-469: NaN to 0, ±inf
//      saturated): clamp(floordiv(m, a)*a, 0, lim),
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
// What bounds it on the H100.  Per query it reads u and v (8 B) and writes
// z and ok (5 B); per chunk it touches one (wh, ww) window of a page, and it
// does ~30 f32 operations a query.  At 13 B and ~30 operations a query it is
// bound by the bytes: 5M queries move 65 MB, 0.019 ms at 3.35 TB/s.  What
// the design does about it:
//   - the coordinate prologue is fused in, so u and v are read once and
//     nothing else runs before the kernel (the torch prologue it replaces
//     cost 7x the kernel);
//   - chunk = PPT * 256 with PPT in {1, 2, 4, 8} (every chunk the serving
//     paths use) takes a template: each thread holds PPT queries in
//     registers, loaded with 16-byte (8-byte at PPT 2) loads where u, v and
//     z are aligned (an unaligned slice of u, v takes the same kernel with
//     scalar loads), reduced by warp shuffles and one __syncthreads over the
//     warp partials; every thread then picks the page and the window itself
//     (K is a few pages), so there is no single-thread step and no second
//     barrier; all four-corner gathers of a thread's queries are issued
//     before any lerp; z is stored as float4 and ok four bytes a store;
//   - the grid is persistent (as many blocks as fit, each walking chunks b,
//     b + grid, ...), and a block loads its next chunk's coordinates before
//     it resolves the current one, so that load is in flight behind the
//     gathers and no ragged last wave is left;
//   - the division by the step, per query an IEEE divide (a subroutine with
//     a range check and a branch), is a multiply and four FMAs from the
//     step's reciprocal, exact (quotient());
//   - the 2048-query chunk is held to 128 registers, two blocks an SM.
// The window is not staged in shared memory: a default 48x128 window is
// 24 KB against 4 KB of coordinates for a 512-ping chunk, and the corners of
// consecutive pings hit L1/L2.  Any other chunk size (a caller's chunk=7)
// takes the generic kernel: a block of min(256, ceil32(chunk)) threads a
// chunk, looping over it, reading its coordinates twice, with the same
// quotient().  At chunks 512 and 2048 that loop is 1.2x and 1.7x slower
// than the tiled kernel on the band weave (scripts/kernel_ab.py, PERF.md),
// which is why the two are kept.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "exact_div.cuh"

namespace {

constexpr int kThreads = 256;  // the generic kernel's most threads a block
constexpr int kMaxWarps = 32;

struct Params {
  const float* planes;
  const float* vmasks;   // null when !masked
  const float* origins;  // (K, 2) (row0, col0); null: every page at (0, 0)
  const float* u;
  const float* v;
  float* z;
  uint8_t* ok;
  long long n;
  int K, R, C, chunk, wh, ww, ar, ac, lim_r, lim_c, masked, pick, hat;
  float thresh, u0, du, su, v0, dv, sv;
};

// The chunk's page and window, the same in every thread of the block.
struct Geo {
  const float* p;
  const float* m;
  float org_r, org_c;
  int bx, by;
  bool any_fit;
};

// The cell a query falls in and its weights.
struct Cell {
  int i00;
  float ax0, ax1, ay0, ay1;
  bool good;
};

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// The min of a and b, NaN if either is NaN, as jnp.min (fminf returns the
// other operand).
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Step 0 for one coordinate: (u - u0) / du - su, the division by quotient()
// (r = RN(1 / du), dok = divisor_ok(du)) where that is exact, by IEEE '/'
// elsewhere.
__device__ __forceinline__ float to_frame(float u, float u0, float du, float r, bool dok, float su) {
  const float a = u - u0;
  bool exact = dok;
  const float q = quotient(a, du, r, exact);
  return (exact ? q : a / du) - su;
}

// Steps 1-3: reduce the thread's partial min/max over the block (every
// thread of the block must call it), then pick the page and the window.
// buf alternates between consecutive chunks of a block: a warp may write the
// next chunk's partials while another still reads this chunk's.
__device__ __forceinline__ Geo chunk_geometry(const Params& P, float xmin, float xmax, float ymin,
                                              float ymax, int buf) {
  __shared__ float red_bufs[2][4][kMaxWarps];
  float(&red)[4][kMaxWarps] = red_bufs[buf];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    xmin = min_nan(xmin, __shfl_xor_sync(0xffffffffu, xmin, o));
    xmax = fmaxf(xmax, __shfl_xor_sync(0xffffffffu, xmax, o));
    ymin = min_nan(ymin, __shfl_xor_sync(0xffffffffu, ymin, o));
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
  const int nw = blockDim.x >> 5;
  xmin = red[0][0];
  xmax = red[1][0];
  ymin = red[2][0];
  ymax = red[3][0];
  for (int w = 1; w < nw; ++w) {
    xmin = min_nan(xmin, red[0][w]);
    xmax = fmaxf(xmax, red[1][w]);
    ymin = min_nan(ymin, red[2][w]);
    ymax = fmaxf(ymax, red[3][w]);
  }
  Geo g;
  int page = 0;
  g.any_fit = true;
  if (P.pick) {
    const float cx = 0.5f * (xmin + xmax);
    const float cy = 0.5f * (ymin + ymax);
    g.any_fit = false;
    for (int k = 0; k < P.K; ++k) {
      const float r0 = P.origins ? __ldg(P.origins + 2 * k) : 0.f;
      const float c0 = P.origins ? __ldg(P.origins + 2 * k + 1) : 0.f;
      if (cx >= c0 && cx <= c0 + (float)(P.C - 1) && cy >= r0 && cy <= r0 + (float)(P.R - 1)) {
        page = k;
        g.any_fit = true;
        break;
      }
    }
  }
  g.org_r = P.origins ? __ldg(P.origins + 2 * page) : 0.f;
  g.org_c = P.origins ? __ldg(P.origins + 2 * page + 1) : 0.f;
  // min over floor(x - c0) == floor(min(x) - c0): the f32 subtraction and
  // floor are both monotone, and so is the cast, which saturates ±inf as
  // XLA's does.  A NaN min casts to 0, and a NaN ping's cast is 0 in the
  // reference's min over the casts: the clamp at 0 makes either base 0.
  const int mx0 = (int)floorf(xmin - g.org_c);
  const int my0 = (int)floorf(ymin - g.org_r);
  g.bx = clampi(floordiv(mx0, P.ac) * P.ac, 0, P.lim_c);
  g.by = clampi(floordiv(my0, P.ar) * P.ar, 0, P.lim_r);
  const size_t plane_off = (size_t)page * P.R * P.C;
  g.p = P.planes + plane_off;
  g.m = P.masked ? P.vmasks + plane_off : nullptr;
  return g;
}

// Step 4, before the gathers: the query's cell, its weights and the ok test.
__device__ __forceinline__ Cell locate(const Params& P, const Geo& g, float x, float y, bool live) {
  Cell c;
  const float xb = x - g.org_c;
  const float yb = y - g.org_r;
  const float fx0 = floorf(xb);
  const float fy0 = floorf(yb);
  const int x0 = (int)fx0;
  const int y0 = (int)fy0;
  const int lx0 = x0 - g.bx;
  const int ly0 = y0 - g.by;
  c.good = live && g.any_fit && lx0 >= 0 && lx0 <= P.ww - 2 && ly0 >= 0 && ly0 <= P.wh - 2 &&
           x0 >= 0 && x0 <= P.C - 2 && y0 >= 0 && y0 <= P.R - 2;
  const float wx = xb - fx0;
  const float wy = yb - fy0;
  c.ax0 = 1.f - wx;
  c.ax1 = P.hat ? 1.f - (1.f - wx) : wx;
  c.ay0 = 1.f - wy;
  c.ay1 = P.hat ? 1.f - (1.f - wy) : wy;
  c.i00 = c.good ? y0 * P.C + x0 : 0;
  return c;
}

struct Corners {
  float a, b, c, d;  // (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1)
};

__device__ __forceinline__ Corners gather(const float* __restrict__ p, const Cell& c, int C) {
  Corners k = {0.f, 0.f, 0.f, 0.f};
  if (c.good) {
    k.a = __ldg(p + c.i00);
    k.b = __ldg(p + c.i00 + 1);
    k.c = __ldg(p + c.i00 + C);
    k.d = __ldg(p + c.i00 + C + 1);
  }
  return k;
}

__device__ __forceinline__ float lerp(const Cell& c, const Corners& k) {
  const float ra = c.ay0 * k.a + c.ay1 * k.c;
  const float rb = c.ay0 * k.b + c.ay1 * k.d;
  return c.ax0 * ra + c.ax1 * rb;
}

// One chunk's raw coordinates into registers, chunk == PPT * NT.  Query j of
// a thread sits at chunk offset (j / G) * NT * G + threadIdx.x * G + j % G:
// groups of G consecutive queries, so a group is one 16-byte (G = 4) or
// 8-byte (G = 2) load where u and v are 16-byte aligned (vec) and the chunk
// is whole.  Nothing waits here: the registers are first read where the
// chunk is processed.
template <int PPT, int NT>
__device__ __forceinline__ void load_chunk(const Params& P, long long c, int vec, float (&u)[PPT],
                                           float (&v)[PPT]) {
  constexpr int G = PPT >= 4 ? 4 : PPT;
  const long long base = c * P.chunk;
  const long long rem = P.n - base;
  const int cnt = rem < P.chunk ? (int)rem : P.chunk;
  const bool vload = vec && cnt == P.chunk;
  const float* uc = P.u + base;
  const float* vc = P.v + base;
#pragma unroll
  for (int g = 0; g < PPT / G; ++g) {
    const int i0 = g * NT * G + threadIdx.x * G;
    bool loaded = false;
    if constexpr (G == 4) {
      if (vload) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(uc + i0));
        const float4 b = __ldg(reinterpret_cast<const float4*>(vc + i0));
        u[g * G + 0] = a.x; u[g * G + 1] = a.y; u[g * G + 2] = a.z; u[g * G + 3] = a.w;
        v[g * G + 0] = b.x; v[g * G + 1] = b.y; v[g * G + 2] = b.z; v[g * G + 3] = b.w;
        loaded = true;
      }
    } else if constexpr (G == 2) {
      if (vload) {
        const float2 a = __ldg(reinterpret_cast<const float2*>(uc + i0));
        const float2 b = __ldg(reinterpret_cast<const float2*>(vc + i0));
        u[g * G + 0] = a.x; u[g * G + 1] = a.y;
        v[g * G + 0] = b.x; v[g * G + 1] = b.y;
        loaded = true;
      }
    }
    if (!loaded) {
#pragma unroll
      for (int e = 0; e < G; ++e) {
        const bool in = i0 + e < cnt;
        u[g * G + e] = in ? __ldg(uc + i0 + e) : 0.f;
        v[g * G + e] = in ? __ldg(vc + i0 + e) : 0.f;
      }
    }
  }
}

// chunk == PPT * NT, a persistent grid: block b serves chunks b, b + grid,
// b + 2 grid, ..., and loads the next one's coordinates before it resolves
// the current one, so that load is in flight behind this chunk's gathers.
template <int PPT, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB) band_resample_tiled(Params P, int vec, long long nchunks) {
  constexpr int G = PPT >= 4 ? 4 : PPT;
  constexpr int NG = PPT / G;
  float un[PPT], vn[PPT];
  const float ru = 1.f / P.du, rv = 1.f / P.dv;
  const bool divisors_ok = divisor_ok(P.du) && divisor_ok(P.dv);
  long long c = blockIdx.x;
  if (c < nchunks) load_chunk<PPT, NT>(P, c, vec, un, vn);
  for (int it = 0; c < nchunks; c += gridDim.x, ++it) {
    float x[PPT], y[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      x[j] = un[j];
      y[j] = vn[j];
    }
    if (c + gridDim.x < nchunks) load_chunk<PPT, NT>(P, c + gridDim.x, vec, un, vn);
    const long long base = c * P.chunk;
    const long long rem = P.n - base;
    const int cnt = rem < P.chunk ? (int)rem : P.chunk;
    const bool vstore = vec && cnt == P.chunk;

    bool live[PPT];
    bool exact = divisors_ok;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      live[j] = (j / G) * NT * G + threadIdx.x * G + j % G < cnt;
      x[j] = quotient(x[j] - P.u0, P.du, ru, exact) - P.su;
      y[j] = quotient(y[j] - P.v0, P.dv, rv, exact) - P.sv;
    }
    if (!exact) {  // rare: this thread's queries take the IEEE division
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int i = (j / G) * NT * G + threadIdx.x * G + j % G;
        x[j] = live[j] ? (__ldg(P.u + base + i) - P.u0) / P.du - P.su : 0.f;
        y[j] = live[j] ? (__ldg(P.v + base + i) - P.v0) / P.dv - P.sv : 0.f;
      }
    }
    float xmin = INFINITY, xmax = -INFINITY, ymin = INFINITY, ymax = -INFINITY;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      if (live[j]) {
        xmin = min_nan(xmin, x[j]);
        xmax = fmaxf(xmax, x[j]);
        ymin = min_nan(ymin, y[j]);
        ymax = fmaxf(ymax, y[j]);
      }
    }
    const Geo geo = chunk_geometry(P, xmin, xmax, ymin, ymax, it & 1);

    Cell cell[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) cell[j] = locate(P, geo, x[j], y[j], live[j]);
    Corners zc[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) zc[j] = gather(geo.p, cell[j], P.C);
    bool good[PPT];
    if (P.masked) {
      Corners mc[PPT];
#pragma unroll
      for (int j = 0; j < PPT; ++j) mc[j] = gather(geo.m, cell[j], P.C);
#pragma unroll
      for (int j = 0; j < PPT; ++j) good[j] = cell[j].good && lerp(cell[j], mc[j]) > P.thresh;
    } else {
#pragma unroll
      for (int j = 0; j < PPT; ++j) good[j] = cell[j].good;
    }
    float out[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) out[j] = good[j] ? lerp(cell[j], zc[j]) : NAN;

    float* zo = P.z + base;
    uint8_t* oko = P.ok + base;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int i0 = g * NT * G + threadIdx.x * G;
      bool stored = false;
      if constexpr (G == 4) {
        if (vstore) {
          *reinterpret_cast<float4*>(zo + i0) = make_float4(out[g * G], out[g * G + 1], out[g * G + 2], out[g * G + 3]);
          *reinterpret_cast<uint32_t*>(oko + i0) = (uint32_t)good[g * G] | ((uint32_t)good[g * G + 1] << 8) |
                                                    ((uint32_t)good[g * G + 2] << 16) | ((uint32_t)good[g * G + 3] << 24);
          stored = true;
        }
      } else if constexpr (G == 2) {
        if (vstore) {
          *reinterpret_cast<float2*>(zo + i0) = make_float2(out[g * G], out[g * G + 1]);
          *reinterpret_cast<uint16_t*>(oko + i0) = (uint16_t)((uint32_t)good[g * G] | ((uint32_t)good[g * G + 1] << 8));
          stored = true;
        }
      }
      if (!stored) {
#pragma unroll
        for (int e = 0; e < G; ++e) {
          if (live[g * G + e]) {
            zo[i0 + e] = out[g * G + e];
            oko[i0 + e] = good[g * G + e] ? 1 : 0;
          }
        }
      }
    }
  }
}

// Any chunk: blockDim.x = min(256, ceil32(chunk)) threads loop over the
// chunk, reading its coordinates once for the bbox and again for the lerps;
// the division as in the tiled kernel, by quotient() where it is exact.
__global__ void __launch_bounds__(kThreads) band_resample_generic(Params P) {
  const long long base = (long long)blockIdx.x * P.chunk;
  const long long rem = P.n - base;
  const int cnt = rem < P.chunk ? (int)rem : P.chunk;
  const float* uc = P.u + base;
  const float* vc = P.v + base;
  const float ru = 1.f / P.du, rv = 1.f / P.dv;
  const bool uok = divisor_ok(P.du), vok = divisor_ok(P.dv);
  float xmin = INFINITY, xmax = -INFINITY, ymin = INFINITY, ymax = -INFINITY;
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    const float xi = to_frame(__ldg(uc + i), P.u0, P.du, ru, uok, P.su);
    const float yi = to_frame(__ldg(vc + i), P.v0, P.dv, rv, vok, P.sv);
    xmin = min_nan(xmin, xi);
    xmax = fmaxf(xmax, xi);
    ymin = min_nan(ymin, yi);
    ymax = fmaxf(ymax, yi);
  }
  const Geo geo = chunk_geometry(P, xmin, xmax, ymin, ymax, 0);
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    const float xi = to_frame(__ldg(uc + i), P.u0, P.du, ru, uok, P.su);
    const float yi = to_frame(__ldg(vc + i), P.v0, P.dv, rv, vok, P.sv);
    const Cell c = locate(P, geo, xi, yi, true);
    const Corners zc = gather(geo.p, c, P.C);
    bool good = c.good;
    if (P.masked) good = good && lerp(c, gather(geo.m, c, P.C)) > P.thresh;
    P.z[base + i] = good ? lerp(c, zc) : NAN;
    P.ok[base + i] = good ? 1 : 0;
  }
}

// A persistent grid: as many blocks as fit on the card at once (the
// occupancy, asked once per instantiation), at most one a chunk.
template <int PPT, int NT, int MINB>
void launch_tiled(long long nchunks, const Params& P, int vec, cudaStream_t st) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, band_resample_tiled<PPT, NT, MINB>, NT, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const unsigned blocks = (unsigned)(nchunks < resident ? nchunks : resident);
  band_resample_tiled<PPT, NT, MINB><<<blocks, NT, 0, st>>>(P, vec, nchunks);
}

}  // namespace

extern "C" {

// planes, vmasks: (K, R, C) f32 (vmasks may be null when !masked); origins:
// (K, 2) f32 or null (every page at (0, 0)); u, v: (n,) f32 query
// coordinates, any n; (u0, du, su, v0, dv, sv): the prologue, x = (u - u0) /
// du - su, y = (v - v0) / dv - sv; z: (n,) f32; ok: (n,) uint8.  Window
// (wh, ww) with alignment (ar, ac) and base limits (lim_r, lim_c); thresh is
// 1 - 1e-3 rounded to f32 by the caller.  Returns the launch's cudaError_t.
int auvtpu_band_resample(const void* planes, const void* vmasks, const void* origins, int K,
                         int R, int C, const void* u, const void* v, int n, int chunk, int wh,
                         int ww, int ar, int ac, int lim_r, int lim_c, int masked, int pick,
                         int hat, float thresh, float u0, float du, float su, float v0, float dv,
                         float sv, void* z, void* ok, void* stream) {
  if (K < 1 || R < 1 || C < 1 || chunk < 1 || n < 0 || wh < 1 || ww < 1 || ar < 1 || ac < 1 ||
      lim_r < 0 || lim_c < 0 || (masked && vmasks == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  Params P;
  P.planes = (const float*)planes;
  P.vmasks = (const float*)vmasks;
  P.origins = (const float*)origins;
  P.u = (const float*)u;
  P.v = (const float*)v;
  P.z = (float*)z;
  P.ok = (uint8_t*)ok;
  P.n = n;
  P.K = K; P.R = R; P.C = C; P.chunk = chunk; P.wh = wh; P.ww = ww; P.ar = ar; P.ac = ac;
  P.lim_r = lim_r; P.lim_c = lim_c; P.masked = masked; P.pick = pick; P.hat = hat;
  P.thresh = thresh; P.u0 = u0; P.du = du; P.su = su; P.v0 = v0; P.dv = dv; P.sv = sv;
  const long long nchunks = (n + (long long)chunk - 1) / chunk;
  const unsigned blocks = (unsigned)nchunks;
  cudaStream_t st = (cudaStream_t)stream;
  const int vec = (((uintptr_t)u | (uintptr_t)v | (uintptr_t)z) % 16 == 0) && ((uintptr_t)ok % 4 == 0);
  switch (chunk) {
    case 256:
      launch_tiled<1, 256, 1>(nchunks, P, vec, st);
      break;
    case 512:
      launch_tiled<2, 256, 1>(nchunks, P, vec, st);
      break;
    case 1024:
      launch_tiled<4, 256, 1>(nchunks, P, vec, st);
      break;
    case 2048:
      launch_tiled<8, 256, 2>(nchunks, P, vec, st);  // two blocks an SM: 128 registers at most
      break;
    default: {
      const int threads = chunk >= kThreads ? kThreads : ((chunk + 31) / 32) * 32;
      band_resample_generic<<<blocks, threads, 0, st>>>(P);
    }
  }
  return (int)cudaGetLastError();
}

const char* auvtpu_band_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
