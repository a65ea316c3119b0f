// The variogram layer's two kernels for Hopper (sm_90a): the binned pair sums
// (B9) and the Gauss-Newton variogram fit (B10).  Plain C interface, loaded
// with ctypes by auvtpu_torch/kernels/variogram.py.
//
// Neither has a Pallas counterpart: the JAX package computes both as XLA
// scans inside the program it compiles for the fit-then-fill:
//   pair_sums_tile_kernel<T> + pair_sums_finish_kernel
//       <- auvtpu/variogram.py:60 _pair_sums_binned (a scan over the
//          half-plane lag offsets)                                      (B9)
//   fit_model_kernel
//       <- auvtpu/variogram.py:337 fit_model (a scan of iters damped
//          Gauss-Newton steps)                                          (B10)
//
// B9 computes, for every base cell (i, j) of an n_rows x n_cols block whose
// cell (0, 0) is the source plane's (0, col0), and every (dy, dx, bin) of an
// offset table,
//     both = v(i, j) * v(i+dy, col0+j+dx);  d = (e(i, j) - e(i+dy, col0+j+dx)) * both
//     s[bin] += (double)(d * d);  c[bin] += (double)both
// where a partner outside the source plane reads as elevation 0, validity 0
// (what the plain version's zero padding gives).  The f32 (or f64) ops are
// the plain version's, op for op, in the planes' dtype (-fmad=false keeps
// them single roundings); the sums are float64, so counts are exact and the
// sums, rounded once to f32 by the caller, do not depend on the order.  One
// layout serves the whole grid (col0 = 0, every column), a row band with the
// next band's rows below it, and a 2-D block inside its halo-extended block
// (col0 = max_lag); the planes are read in place with their row pitches.
//
// B9's shape.  A block of 32 x 8 threads takes a 32 x 32 tile of base cells
// (four rows a thread, its lanes on adjacent columns) and stages the tile's
// partner halo, (32 + R) x (32 + 2R) cells of (elevation, validity) pairs,
// in shared memory; the offset table, grouped by bin (a stable sort: within
// a bin the table's own order), sits beside it.  A thread keeps one f64 sum
// and one f64 count, runs over one bin's offsets, and at the bin's end the
// block sums them in a fixed order (warp shuffles, then the warps in order)
// into its (bin) partial, written to an (n_blocks, n_out, 2) buffer.  A
// second kernel sums each bin's partials over the blocks, again in a fixed
// order.  No atomics: a call gives the same bits every time, which the
// fit's one landing needs (ROADMAP section C1).
//
// What bounds B9 on the H100.  Per pair 4 f32 operations and 2 f64 adds, two
// f32 -> f64 conversions and one 8-byte shared load: at the Kerguelen
// stand-in's 5.01 M cells x 158 offsets (792 M pairs) the f32 and f64 pipes'
// bound is ~0.05 ms, the two 20 MB planes' read 0.012 ms; the conversions
// (16 a clock an SM) and the shared loads are what this simple kernel waits
// on.
//
// B10 is fit_model's loop (auvtpu_torch/variogram.py) in one launch of one
// warp, all in float64: the data-driven start (or the given one), log
// parameters, count weights, residuals times sqrt(w), the Jacobian taken
// analytically per model (the clamp p2 >= 1e-6 of variogram_model gives a
// zero derivative where it binds, as autograd's clamp does), A = J^T J,
// damp = 1e-4 max(trace(A) / 3, 1e-12), a 3x3 LU solve with partial
// pivoting, the +-2 clip, the keep test on the two weighted SSEs and the
// freeze after the first kept step that moves gamma by less than ``stop``
// at the bins with pairs.  A lane takes bins lane, lane + 32, ...; the sums
// are warp butterflies (every lane holds the same bits), so every lane takes
// the same decisions.  It is latency-bound serial work (~100 f64 operations
// a bin a step): its bound is far under a microsecond; the gain is the
// host loop it replaces.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// ---------------------------------------------------------------------------
// B9: binned pair sums
// ---------------------------------------------------------------------------

constexpr int kTW = 32;          // tile columns: a warp's lanes
constexpr int kTY = 8;           // warps a block
constexpr int kCPT = 4;          // base rows a thread
constexpr int kTH = kTY * kCPT;  // tile rows
constexpr int kThreads = kTW * kTY;
constexpr int kMaxLag = 16;
constexpr int kMaxOut = 1024;

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Sums (s, c) over the block's kThreads threads in a fixed order; thread 0
// holds the result.  Every thread of the block calls it.
__device__ __forceinline__ void block_sum2(double& s, double& c, double* red) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, m);
    c += __shfl_down_sync(0xffffffffu, c, m);
  }
  if (lane == 0) {
    red[warp] = s;
    red[kTY + warp] = c;
  }
  __syncthreads();
  if (tid == 0) {
    double S = 0.0, C = 0.0;
#pragma unroll
    for (int w = 0; w < kTY; ++w) {
      S += red[w];
      C += red[kTY + w];
    }
    s = S;
    c = C;
  }
  __syncthreads();
}

// tab: n_off (dy, dx) int pairs grouped by bin, then n_out + 1 bin starts.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    pair_sums_tile_kernel(const T* __restrict__ elev, int pe, const T* __restrict__ valid, int pv, int Hs, int Ws,
                          int H, int Wb, int c0, int R, const int* __restrict__ tab, int n_off, int n_out,
                          double* __restrict__ partials) {
  using V = typename Vec2<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  int2* offs = reinterpret_cast<int2*>(smem);
  int* starts = reinterpret_cast<int*>(smem + align16(sizeof(int2) * n_off));
  double* red = reinterpret_cast<double*>(smem + align16(sizeof(int2) * n_off) + align16(sizeof(int) * (n_out + 1)));
  V* tile = reinterpret_cast<V*>(red + 2 * kTY);

  const int tid = threadIdx.y * kTW + threadIdx.x;
  const int2* toffs = reinterpret_cast<const int2*>(tab);
  for (int i = tid; i < n_off; i += kThreads) offs[i] = toffs[i];
  for (int i = tid; i <= n_out; i += kThreads) starts[i] = tab[2 * n_off + i];

  // the partner halo: source rows r0 .. r0 + kTH + R - 1, columns
  // c0 + bc0 - R .. c0 + bc0 + kTW + R - 1; (0, 0) outside the plane
  const int r0 = blockIdx.y * kTH;
  const int bc0 = blockIdx.x * kTW;
  const int th = kTH + R, tw = kTW + 2 * R;
  for (int i = tid; i < th * tw; i += kThreads) {
    const int tr = i / tw, tc = i - tr * tw;
    const int gr = r0 + tr, gc = c0 + bc0 - R + tc;
    V p;
    if (gr < Hs && gc >= 0 && gc < Ws) {
      p.x = __ldg(elev + (size_t)gr * pe + gc);
      p.y = __ldg(valid + (size_t)gr * pv + gc);
    } else {
      p.x = T(0);
      p.y = T(0);
    }
    tile[i] = p;
  }
  __syncthreads();

  T e0[kCPT], v0[kCPT];
  bool in[kCPT];
  const bool col_in = bc0 + (int)threadIdx.x < Wb;
#pragma unroll
  for (int q = 0; q < kCPT; ++q) {
    const int tr = threadIdx.y + q * kTY;
    in[q] = col_in && r0 + tr < H;
    const V p = tile[tr * tw + threadIdx.x + R];
    e0[q] = p.x;
    v0[q] = p.y;
  }
  const V* base = tile + threadIdx.y * tw + threadIdx.x + R;
  const size_t cta = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  for (int b = 0; b < n_out; ++b) {
    double s = 0.0, c = 0.0;
    const int k1 = starts[b + 1];
    for (int k = starts[b]; k < k1; ++k) {
      const int2 o = offs[k];  // (dy, dx)
      const V* row = base + o.x * tw + o.y;
#pragma unroll
      for (int q = 0; q < kCPT; ++q) {
        if (in[q]) {
          const V p = row[q * kTY * tw];
          const T both = v0[q] * p.y;
          const T d = (e0[q] - p.x) * both;
          const T dd = d * d;
          s += (double)dd;
          c += (double)both;
        }
      }
    }
    block_sum2(s, c, red);
    if (tid == 0) {
      partials[(cta * n_out + b) * 2] = s;
      partials[(cta * n_out + b) * 2 + 1] = c;
    }
  }
}

// Block b sums bin b's partials over the n_cta tile blocks in a fixed order:
// out[b] = s, out[n_out + b] = c.
__global__ void __launch_bounds__(kThreads)
    pair_sums_finish_kernel(const double* __restrict__ partials, int n_cta, int n_out, double* __restrict__ out) {
  __shared__ double red[2 * kTY];
  const int b = blockIdx.x;
  double s = 0.0, c = 0.0;
  for (int k = threadIdx.y * kTW + threadIdx.x; k < n_cta; k += kThreads) {
    s += partials[((size_t)k * n_out + b) * 2];
    c += partials[((size_t)k * n_out + b) * 2 + 1];
  }
  block_sum2(s, c, red);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    out[b] = s;
    out[n_out + b] = c;
  }
}

size_t pair_sums_smem(int n_off, int n_out, int R, size_t vec_bytes) {
  return align16(sizeof(int2) * n_off) + align16(sizeof(int) * (n_out + 1)) + 2 * kTY * sizeof(double) +
         (size_t)(kTH + R) * (kTW + 2 * R) * vec_bytes;
}

template <typename T>
int launch_pair_sums(const T* e, int pe, const T* v, int pv, int Hs, int Ws, int H, int Wb, int c0, int R,
                     const int* tab, int n_off, int n_out, double* partials, double* out, cudaStream_t st) {
  const dim3 grid((unsigned)((Wb + kTW - 1) / kTW), (unsigned)((H + kTH - 1) / kTH));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int n_cta = (H > 0 && Wb > 0) ? (int)(grid.x * grid.y) : 0;
  if (n_cta > 0) {
    const size_t smem = pair_sums_smem(n_off, n_out, R, sizeof(typename Vec2<T>::type));
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(pair_sums_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    pair_sums_tile_kernel<T><<<grid, dim3(kTW, kTY), smem, st>>>(e, pe, v, pv, Hs, Ws, H, Wb, c0, R, tab, n_off,
                                                                 n_out, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  pair_sums_finish_kernel<<<n_out, dim3(kTW, kTY), 0, st>>>(partials, n_cta, n_out, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B10: the Gauss-Newton variogram fit
// ---------------------------------------------------------------------------

constexpr int kFitMaxBins = 512;
enum Model { kExponential = 0, kLinear = 1, kSpherical = 2, kGaussian = 3 };

__device__ __forceinline__ double load_as_f64(const void* p, int f64, int i) {
  return f64 ? static_cast<const double*>(p)[i] : (double)static_cast<const float*>(p)[i];
}

// torch.max / torch.clamp semantics: a NaN wins (clamp_min passes it on)
__device__ __forceinline__ double nan_max(double a, double b) { return (isnan(a) || isnan(b)) ? NAN : fmax(a, b); }
__device__ __forceinline__ double clamp_min(double x, double lo) { return x < lo ? lo : x; }
__device__ __forceinline__ double clamp_pm(double x, double lim) { return x < -lim ? -lim : (x > lim ? lim : x); }

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__device__ __forceinline__ double warp_nan_max(double x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

// variogram_model(h, (p0, p1, p2r), model) and, where ``jac``, its
// derivatives in the log parameters: dc[k] = d curve / d log p_k.
template <bool kJac>
__device__ __forceinline__ double curve(int model, double h, double p0, double p1, double p2r, double* dc) {
  const bool live = p2r >= 1e-6;  // the clamp passes the derivative where it does not bind
  const double p2 = p2r < 1e-6 ? 1e-6 : p2r;
  if (kJac) dc[0] = p0;
  if (model == kLinear) {
    if (kJac) {
      dc[1] = p1 * h;
      dc[2] = 0.0;
    }
    return p0 + p1 * h;
  }
  if (model == kSpherical) {
    const double u = h / p2;
    const double m = u > 1.0 ? 1.0 : u;
    const double f = 1.5 * m - 0.5 * (m * m * m);
    if (kJac) {
      dc[1] = p1 * f;
      dc[2] = (live && u <= 1.0) ? -(p1 * ((1.5 - 1.5 * (m * m)) * m)) : 0.0;
    }
    return p0 + p1 * f;
  }
  if (model == kGaussian) {
    const double u = h / p2;
    const double E = exp(-(u * u));
    const double f = 1.0 - E;
    if (kJac) {
      dc[1] = p1 * f;
      dc[2] = live ? -(p1 * (E * (2.0 * (u * u)))) : 0.0;
    }
    return p0 + p1 * f;
  }
  // exponential
  const double u = h / p2;
  const double E = exp(-u);
  const double f = 1.0 - E;
  if (kJac) {
    dc[1] = p1 * f;
    dc[2] = live ? -(p1 * (E * u)) : 0.0;
  }
  return p0 + p1 * f;
}

// Solves a x = b (3x3) by LU with partial pivoting (the first largest pivot).
__device__ __forceinline__ void solve3(double a[3][3], double b[3], double x[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int p = k;
#pragma unroll
    for (int i = k + 1; i < 3; ++i)
      if (fabs(a[i][k]) > fabs(a[p][k])) p = i;
    if (p != k) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const double t = a[k][j];
        a[k][j] = a[p][j];
        a[p][j] = t;
      }
      const double t = b[k];
      b[k] = b[p];
      b[p] = t;
    }
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      const double l = a[i][k] / a[k][k];
#pragma unroll
      for (int j = k + 1; j < 3; ++j) a[i][j] = a[i][j] - l * a[k][j];
      b[i] = b[i] - l * b[k];
    }
  }
  x[2] = b[2] / a[2][2];
  x[1] = (b[1] - a[1][2] * x[2]) / a[1][1];
  x[0] = (b[0] - a[0][1] * x[1] - a[0][2] * x[2]) / a[0][0];
}

// lags, gamma, counts: (n,) f32 or f64 (f64 flags); init: three f64 on the
// device, or null for the data-driven start; out: (3,) (nugget, p1, p2) in
// f32 or f64 (out_f64); flags: (iters, 2) int8 (kept, frozen after the
// step), or null.
__global__ void __launch_bounds__(32)
    fit_model_kernel(const void* lags, int lags_f64, const void* gamma, int gamma_f64, const void* counts,
                     int counts_f64, int n, const double* init, int model, int iters, double stop, void* out,
                     int out_f64, signed char* flags) {
  __shared__ double sh_h[kFitMaxBins], sh_g[kFitMaxBins], sh_c[kFitMaxBins], sh_sw[kFitMaxBins];
  const int lane = threadIdx.x;
  double csum = 0.0, gmax = -INFINITY, hmax = -INFINITY;
  for (int i = lane; i < n; i += 32) {
    const double h = load_as_f64(lags, lags_f64, i);
    const double g = load_as_f64(gamma, gamma_f64, i);
    const double c = load_as_f64(counts, counts_f64, i);
    sh_h[i] = h;
    sh_g[i] = g;
    sh_c[i] = c;
    csum += c;
    gmax = nan_max(gmax, g);
    hmax = nan_max(hmax, h);
  }
  csum = warp_sum(csum);
  gmax = warp_nan_max(gmax);
  hmax = warp_nan_max(hmax);
  const double tot = clamp_min(csum, 1.0);
  for (int i = lane; i < n; i += 32) sh_sw[i] = sqrt(sh_c[i] / tot);
  __syncwarp();

  double th[3];
  if (init != nullptr) {
#pragma unroll
    for (int k = 0; k < 3; ++k) th[k] = log(init[k]);
  } else {
    const double sill0 = clamp_min(gmax, 1e-3);
    const double maxlag = clamp_min(hmax, 1e-9);
    th[0] = log(0.01 * sill0);
    th[1] = log(model == kLinear ? sill0 / maxlag : sill0);
    th[2] = log(maxlag / 3.0);
  }

  bool frozen = false;
  for (int it = 0; it < iters; ++it) {
    const double p0 = exp(th[0]), p1 = exp(th[1]), p2 = exp(th[2]);
    // the normal equations: A (6), g (3) and the SSE, lane-strided bins
    double acc[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (int i = lane; i < n; i += 32) {
      double dc[3];
      const double sw = sh_sw[i];
      const double r = (curve<true>(model, sh_h[i], p0, p1, p2, dc) - sh_g[i]) * sw;
      const double j0 = dc[0] * sw, j1 = dc[1] * sw, j2 = dc[2] * sw;
      acc[0] += j0 * j0;
      acc[1] += j0 * j1;
      acc[2] += j0 * j2;
      acc[3] += j1 * j1;
      acc[4] += j1 * j2;
      acc[5] += j2 * j2;
      acc[6] += j0 * r;
      acc[7] += j1 * r;
      acc[8] += j2 * r;
      acc[9] += r * r;
    }
#pragma unroll
    for (int k = 0; k < 10; ++k) acc[k] = warp_sum(acc[k]);
    const double tr3 = (acc[0] + acc[3] + acc[5]) / 3.0;
    const double damp = 1e-4 * clamp_min(tr3, 1e-12);
    double a[3][3] = {{acc[0] + damp, acc[1], acc[2]}, {acc[1], acc[3] + damp, acc[4]}, {acc[2], acc[4], acc[5] + damp}};
    double g[3] = {acc[6], acc[7], acc[8]};
    double delta[3];
    solve3(a, g, delta);
    double nw[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) nw[k] = th[k] - clamp_pm(delta[k], 2.0);
    // the candidate: its weighted SSE and how far it moves gamma where
    // there are pairs
    const double q0 = exp(nw[0]), q1 = exp(nw[1]), q2 = exp(nw[2]);
    double ssn = 0.0, moved = 0.0;
    for (int i = lane; i < n; i += 32) {
      const double now = curve<false>(model, sh_h[i], p0, p1, p2, nullptr);
      const double nxt = curve<false>(model, sh_h[i], q0, q1, q2, nullptr);
      const double rn = (nxt - sh_g[i]) * sh_sw[i];
      ssn += rn * rn;
      if (sh_c[i] > 0.0) moved = nan_max(moved, fabs(nxt - now) / fabs(now));
    }
    ssn = warp_sum(ssn);
    moved = warp_nan_max(moved);
    const bool keep = !frozen && ssn <= acc[9];
    if (keep) {
#pragma unroll
      for (int k = 0; k < 3; ++k) th[k] = nw[k];
    }
    frozen = frozen || (keep && moved < stop);
    if (flags != nullptr && lane == 0) {
      flags[2 * it] = keep ? 1 : 0;
      flags[2 * it + 1] = frozen ? 1 : 0;
    }
  }
  if (lane < 3) {
    const double p = exp(th[lane]);
    if (out_f64)
      static_cast<double*>(out)[lane] = p;
    else
      static_cast<float*>(out)[lane] = (float)p;
  }
}

}  // namespace

extern "C" {

// B9.  elev, valid: (Hs, Ws) planes of one dtype (f64 != 0: double, else
// float) with unit column stride and row pitches pe, pv (elements); base
// cells (i, j) for i < H, j < Wb at the plane's (i, c0 + j), H <= Hs,
// c0 + Wb <= Ws; 0 <= R <= 16 with every |dy|, |dx| <= R, dy >= 0; tab: as
// pair_sums_tile_kernel's, on the device; 1 <= n_out <= 1024; partials:
// (ceil(H/32) * ceil(Wb/32), n_out, 2) f64 scratch; out: (2, n_out) f64
// (sums, counts).  Two kernel launches, nothing else on the stream.
int auvtpu_pair_sums(const void* elev, int pe, const void* valid, int pv, int f64, int Hs, int Ws, int H, int Wb,
                     int c0, int R, const void* tab, int n_off, int n_out, void* partials, void* out,
                     void* stream) {
  if (R < 0 || R > kMaxLag || n_out < 1 || n_out > kMaxOut || n_off < 0 || H < 0 || Wb < 0 || H > Hs || c0 < 0 ||
      c0 + Wb > Ws)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* t = (const int*)tab;
  double* p = (double*)partials;
  double* o = (double*)out;
  if (f64)
    return launch_pair_sums<double>((const double*)elev, pe, (const double*)valid, pv, Hs, Ws, H, Wb, c0, R, t,
                                    n_off, n_out, p, o, st);
  return launch_pair_sums<float>((const float*)elev, pe, (const float*)valid, pv, Hs, Ws, H, Wb, c0, R, t, n_off,
                                 n_out, p, o, st);
}

// B10.  See fit_model_kernel; 1 <= n <= 512, model 0..3 (exponential,
// linear, spherical, gaussian), iters >= 0.  One kernel launch.
int auvtpu_fit_model(const void* lags, int lags_f64, const void* gamma, int gamma_f64, const void* counts,
                     int counts_f64, int n, const void* init, int model, int iters, double stop, void* out,
                     int out_f64, void* flags, void* stream) {
  if (n < 1 || n > kFitMaxBins || model < 0 || model > 3 || iters < 0) return (int)cudaErrorInvalidValue;
  fit_model_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(lags, lags_f64, gamma, gamma_f64, counts, counts_f64, n,
                                                      (const double*)init, model, iters, stop, out, out_f64,
                                                      (signed char*)flags);
  return (int)cudaGetLastError();
}

const char* auvtpu_variogram_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
