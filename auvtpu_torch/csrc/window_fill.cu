// Windowed first-k-valid selection and the fills built on it, for Hopper
// (sm_90a).  Plain C interface, loaded with ctypes by
// auvtpu_torch/kernels/window_fill.py.
//
// Replaces four TPU kernels of auvtpu/pallas/window_fill.py:
//   topk_full_kernel<.., false> <- _make_topk_full_kernel    (B2, pallas_topk_full)
//   topk_full_kernel<.., true>  <- _make_topk_kernel         (B4, pallas_topk_idx)
//   kriging_fill_kernel         <- _make_kriging_fill_kernel (B1, pallas_fill_kriging)
//   fill_kernel<KIND>           <- _make_fill_kernel         (B3, pallas_fill_idw /
//                                                             pallas_fill_mean)
//
// What they compute.  Per output cell, scan a static window-offset table
// sorted by (distance^2, collection order) and keep the first k cells that
// are valid.  B2 writes (cnt, values, offsets); B4 writes (cnt, table
// indices), the slim form of the same selection; B1 goes on to build and
// solve the 5x6 ordinary-kriging system in registers and writes the
// prediction (and optionally the kriging variance); B3 folds each found cell
// into an inverse-distance-weighted sum (weights from a host table) or a
// plain mean, keeping no slots at all.  First-k-valid in a static order is a
// per-cell rule, so each thread stops as soon as its own cell is full and the
// answer is the same as the TPU's per-tile early exit.
//
// Input is one NaN-encoded plane (invalid and out-of-grid cells are NaN),
// padded by R on every side so no read needs a bounds check.  Slots are
// written with selects, and B3 adds only the values it takes, never
// hit * (v - old) or 0 * v arithmetic: 0 * NaN is NaN.
//
// What bounds them on the H100.  With 10-20% of cells masked a scan for 4
// neighbours reads 4.4-5.0 table rows per cell, one for 8 about 10 (measured
// at the Kerguelen stand-in), nearly all of them L1/L2 hits shared with the
// neighbouring threads.  B2 writes 1+3k planes and B4 1+k: both are bound by
// the output writes to HBM.  B3 writes one plane and does a few operations
// per candidate: it is bound by memory (one read of the padded plane, one
// write of the output).  B1 writes one plane (two with the variance) and does
// ~100 multiply-adds, 21 divides (gj), 10 square roots and 10 exps per cell,
// so it is bound by the throughput of the IEEE divides and transcendentals
// rather than by memory.  The design does the simple thing for all of them:
// one thread per cell in 32x8 blocks, reads through the read-only data cache
// (__ldg) so a warp's 32 neighbouring loads of one offset coalesce, the
// offset table (and B3's weight table) read by all threads of a warp at the
// same index (a broadcast), and all state kept in registers.  Faster variants
// (shared-memory halo tiles, fewer divides, no padded plane) are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

// First-k-valid scan.  `base` points at the cell's own position in the padded
// plane; tab[t] = (dx, dy).  Fills slots 0..cnt-1 with the value and the table
// index of each selected cell and returns cnt.  The unrolled compare keeps the
// slots in registers (a dynamically indexed array would go to local memory).
template <int KCAP>
__device__ __forceinline__ int select_first_k(const float* __restrict__ base, int pitch,
                                              const int2* __restrict__ tab, int m, int k,
                                              float (&vals)[KCAP], int (&tix)[KCAP]) {
  int cnt = 0;
  for (int t = 0; t < m && cnt < k; ++t) {
    const int2 o = __ldg(tab + t);
    const float v = __ldg(base + o.y * pitch + o.x);
    if (!isnan(v)) {
#pragma unroll
      for (int s = 0; s < KCAP; ++s) {
        if (s == cnt) {
          vals[s] = v;
          tix[s] = t;
        }
      }
      ++cnt;
    }
  }
  return cnt;
}

// IDX = false (B2): out is (1+3k, H, W) = cnt, vals[k], dxs[k], dys[k].
// IDX = true  (B4): out is (1+k, H, W)  = cnt, table index of each slot as a
//                   float, -1 at an empty slot (pallas_topk_idx's planes).
template <int KCAP, bool IDX>
__global__ void __launch_bounds__(BX * BY)
topk_full_kernel(const float* __restrict__ nanp, const int2* __restrict__ tab, int m,
                 int H, int W, int R, int k, float* __restrict__ out) {
  const int c = blockIdx.x * BX + threadIdx.x;
  const int r = blockIdx.y * BY + threadIdx.y;
  if (r >= H || c >= W) return;
  const int pitch = W + 2 * R;
  const float* base = nanp + (size_t)(r + R) * pitch + (c + R);
  float vals[KCAP];
  int tix[KCAP];
#pragma unroll
  for (int s = 0; s < KCAP; ++s) {
    vals[s] = 0.f;
    tix[s] = 0;
  }
  const int cnt = select_first_k<KCAP>(base, pitch, tab, m, k, vals, tix);

  const size_t plane = (size_t)H * W;
  const size_t cell = (size_t)r * W + c;
  out[cell] = (float)cnt;
#pragma unroll
  for (int s = 0; s < KCAP; ++s) {
    if (s < k) {
      const bool live = s < cnt;
      if (IDX) {
        out[(1 + s) * plane + cell] = live ? (float)tix[s] : -1.f;
      } else {
        // an empty slot decodes to offset (-R, -R), as pallas_topk_full's
        // code -1 does; every consumer masks slots >= cnt
        const int2 o = live ? __ldg(tab + tix[s]) : make_int2(-R, -R);
        out[(1 + s) * plane + cell] = live ? vals[s] : 0.f;
        out[(1 + k + s) * plane + cell] = (float)o.x;
        out[(1 + 2 * k + s) * plane + cell] = (float)o.y;
      }
    }
  }
}

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

// par: nugget, sill, range, min_lon, min_lat, lon_step, lat_step, half,
//      pivot_tol, row0, col0 (window_fill.py:884-891), read on the device so
//      fitted parameters never travel to the host.
template <int MODEL, int SOLVER, bool VAR>
__global__ void __launch_bounds__(BX * BY)
kriging_fill_kernel(const float* __restrict__ nanp, const int2* __restrict__ tab, int m,
                    int H, int W, int R, const float* __restrict__ par,
                    float* __restrict__ out) {
  const int c = blockIdx.x * BX + threadIdx.x;
  const int r = blockIdx.y * BY + threadIdx.y;
  if (r >= H || c >= W) return;
  const int pitch = W + 2 * R;
  const float* base = nanp + (size_t)(r + R) * pitch + (c + R);
  float vals[4] = {0.f, 0.f, 0.f, 0.f};
  int tix[4] = {0, 0, 0, 0};
  const int cnt = select_first_k<4>(base, pitch, tab, m, 4, vals, tix);

  const float nugget = __ldg(par + 0);
  const float sill = __ldg(par + 1);
  const float vrange = __ldg(par + 2);
  const float min_lon = __ldg(par + 3);
  const float min_lat = __ldg(par + 4);
  const float lon_step = __ldg(par + 5);
  const float lat_step = __ldg(par + 6);
  const float half = __ldg(par + 7);
  const float pivot_tol = __ldg(par + 8);
  const float row0 = __ldg(par + 9);
  const float col0 = __ldg(par + 10);

  // Absolute f32 degrees first, differences after: the cancellation is part
  // of the reference answer (integers < 2^24 make col + col0 exact).
  const float colf = (float)c + col0;
  const float rowf = (float)r + row0;
  const float qlon = min_lon + colf * lon_step;
  const float qlat = min_lat + rowf * lat_step;
  float cx[4], cy[4], vz[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const bool live = s < cnt;
    const int2 o = live ? __ldg(tab + tix[s]) : make_int2(-R, -R);
    cx[s] = min_lon + ((colf + (float)o.x) + half) * lon_step;
    cy[s] = min_lat + ((rowf + (float)o.y) + half) * lat_step;
    vz[s] = live ? vals[s] : 0.f;
  }

  float M[5][6];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b < a) {
        M[a][b] = M[b][a];
      } else if (b == a) {
        M[a][b] = nugget;  // gamma(0) is exactly the nugget for every model
      } else {
        const float ddx = cx[a] - cx[b];
        const float ddy = cy[a] - cy[b];
        M[a][b] = gamma_fn<MODEL>(sqrtf(ddx * ddx + ddy * ddy), nugget, sill, vrange);
      }
    }
    M[a][4] = 1.f;
    const float ddx = cx[a] - qlon;
    const float ddy = cy[a] - qlat;
    M[a][5] = gamma_fn<MODEL>(sqrtf(ddx * ddx + ddy * ddy), nugget, sill, vrange);
  }
  M[4][0] = 1.f;
  M[4][1] = 1.f;
  M[4][2] = 1.f;
  M[4][3] = 1.f;
  M[4][4] = 0.f;
  M[4][5] = 1.f;
  float gamma0[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) gamma0[a] = M[a][5];

  bool singular = false;
  float lam[5];
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

  const float pred = lam[0] * vz[0] + lam[1] * vz[1] + lam[2] * vz[2] + lam[3] * vz[3];
  const float fbs = vz[0] + vz[1] + vz[2] + vz[3];
  const float fb = cnt > 0 ? fbs / fmaxf((float)cnt, 1.f) : NAN;
  const bool bail = singular || cnt < 4;
  const size_t cell = (size_t)r * W + c;
  out[cell] = bail ? fb : pred;
  if (VAR) {
    // sigma^2 = sum_i w_i gamma_i0 + mu, clamped at 0 (a NaN stays NaN);
    // fallback cells have no defined variance
    float var = lam[0] * gamma0[0];
    var = var + lam[1] * gamma0[1];
    var = var + lam[2] * gamma0[2];
    var = var + lam[3] * gamma0[3];
    var = var + lam[4];
    var = var < 0.f ? 0.f : var;
    out[(size_t)H * W + cell] = bail ? NAN : var;
  }
}

enum FillKind { kIDW = 0, kMean = 1 };

// B3: first-k-valid IDW or mean.  wtab[t] is the IDW weight of table row t,
// 1/(d2^(p/2)+eps) rounded to float32 on the host (window_fill.py:331-335);
// the mean ignores it.  Sums run in table order, the order of the plain
// version, and add only the cells taken.
template <int KIND>
__global__ void __launch_bounds__(BX * BY)
fill_kernel(const float* __restrict__ nanp, const int2* __restrict__ tab,
            const float* __restrict__ wtab, int m, int H, int W, int R, int k, float eps,
            float* __restrict__ out) {
  const int c = blockIdx.x * BX + threadIdx.x;
  const int r = blockIdx.y * BY + threadIdx.y;
  if (r >= H || c >= W) return;
  const int pitch = W + 2 * R;
  const float* base = nanp + (size_t)(r + R) * pitch + (c + R);
  int cnt = 0;
  float ws = 0.f;
  float vs = 0.f;
  for (int t = 0; t < m && cnt < k; ++t) {
    const int2 o = __ldg(tab + t);
    const float v = __ldg(base + o.y * pitch + o.x);
    if (!isnan(v)) {
      if (KIND == kIDW) {
        const float w = __ldg(wtab + t);
        ws = ws + w;
        vs = vs + w * v;
      } else {
        vs = vs + v;
      }
      ++cnt;
    }
  }
  float res;
  if (KIND == kIDW)
    res = cnt > 0 ? vs / fmaxf(ws, eps) : NAN;
  else
    res = cnt > 0 ? vs / fmaxf((float)cnt, 1.f) : NAN;
  out[(size_t)r * W + c] = res;
}

dim3 grid_for(int H, int W) { return dim3((W + BX - 1) / BX, (H + BY - 1) / BY); }

template <int MODEL, int SOLVER>
void launch_kriging(bool var, dim3 g, dim3 b, cudaStream_t st, const float* nanp,
                    const int2* tab, int m, int H, int W, int R, const float* par,
                    float* out) {
  if (var)
    kriging_fill_kernel<MODEL, SOLVER, true><<<g, b, 0, st>>>(nanp, tab, m, H, W, R, par, out);
  else
    kriging_fill_kernel<MODEL, SOLVER, false><<<g, b, 0, st>>>(nanp, tab, m, H, W, R, par, out);
}

template <int MODEL>
void launch_kriging_solver(int solver, bool var, dim3 g, dim3 b, cudaStream_t st,
                           const float* nanp, const int2* tab, int m, int H, int W, int R,
                           const float* par, float* out) {
  if (solver == kGJ)
    launch_kriging<MODEL, kGJ>(var, g, b, st, nanp, tab, m, H, W, R, par, out);
  else
    launch_kriging<MODEL, kLU>(var, g, b, st, nanp, tab, m, H, W, R, par, out);
}

}  // namespace

extern "C" {

// nanp: (H+2R, W+2R) f32, NaN = invalid; tab: (m, 2) int32 (dx, dy);
// out: (1+3k, H, W) f32 = cnt, vals[k], dxs[k], dys[k].  1 <= k <= 16.
int auvtpu_topk_full(const void* nanp, const void* tab, int m, int H, int W, int R, int k,
                     void* out, void* stream) {
  if (k < 1 || k > 16) return (int)cudaErrorInvalidValue;
  const dim3 b(BX, BY);
  const dim3 g = grid_for(H, W);
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)nanp;
  const int2* t = (const int2*)tab;
  float* o = (float*)out;
  if (k <= 4)
    topk_full_kernel<4, false><<<g, b, 0, st>>>(p, t, m, H, W, R, k, o);
  else
    topk_full_kernel<16, false><<<g, b, 0, st>>>(p, t, m, H, W, R, k, o);
  return (int)cudaGetLastError();
}

// nanp, tab as above; out: (1+k, H, W) f32 = cnt, slot table indices (-1 =
// empty).  1 <= k <= 16.
int auvtpu_topk_idx(const void* nanp, const void* tab, int m, int H, int W, int R, int k,
                    void* out, void* stream) {
  if (k < 1 || k > 16) return (int)cudaErrorInvalidValue;
  const dim3 b(BX, BY);
  const dim3 g = grid_for(H, W);
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)nanp;
  const int2* t = (const int2*)tab;
  float* o = (float*)out;
  if (k <= 4)
    topk_full_kernel<4, true><<<g, b, 0, st>>>(p, t, m, H, W, R, k, o);
  else
    topk_full_kernel<16, true><<<g, b, 0, st>>>(p, t, m, H, W, R, k, o);
  return (int)cudaGetLastError();
}

// nanp, tab as above; wtab: (m,) f32 IDW weights on the device (read only
// for kind 0); kind 0 = IDW, 1 = mean; eps: IDW's floor on the weight sum;
// out: (H, W) f32.  Any k >= 0 (no slots are kept).
int auvtpu_fill(const void* nanp, const void* tab, const void* wtab, int m, int H, int W,
                int R, int kind, int k, float eps, void* out, void* stream) {
  if (kind < 0 || kind > 1) return (int)cudaErrorInvalidValue;
  const dim3 b(BX, BY);
  const dim3 g = grid_for(H, W);
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)nanp;
  const int2* t = (const int2*)tab;
  const float* w = (const float*)wtab;
  float* o = (float*)out;
  if (kind == kIDW)
    fill_kernel<kIDW><<<g, b, 0, st>>>(p, t, w, m, H, W, R, k, eps, o);
  else
    fill_kernel<kMean><<<g, b, 0, st>>>(p, t, w, m, H, W, R, k, eps, o);
  return (int)cudaGetLastError();
}

// nanp, tab as above; par: 11 f32 on the device; model 0..3 (exponential,
// linear, spherical, gaussian); solver 0 = gj, 1 = lu; out: (H, W) f32, or
// (2, H, W) with the variance plane second.
int auvtpu_kriging_fill(const void* nanp, const void* tab, int m, int H, int W, int R,
                        const void* par, int model, int solver, int with_variance, void* out,
                        void* stream) {
  if (model < 0 || model > 3 || solver < 0 || solver > 1) return (int)cudaErrorInvalidValue;
  const dim3 b(BX, BY);
  const dim3 g = grid_for(H, W);
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)nanp;
  const int2* t = (const int2*)tab;
  const float* pr = (const float*)par;
  float* o = (float*)out;
  const bool var = with_variance != 0;
  switch (model) {
    case kExponential:
      launch_kriging_solver<kExponential>(solver, var, g, b, st, p, t, m, H, W, R, pr, o);
      break;
    case kLinear:
      launch_kriging_solver<kLinear>(solver, var, g, b, st, p, t, m, H, W, R, pr, o);
      break;
    case kSpherical:
      launch_kriging_solver<kSpherical>(solver, var, g, b, st, p, t, m, H, W, R, pr, o);
      break;
    default:
      launch_kriging_solver<kGaussian>(solver, var, g, b, st, p, t, m, H, W, R, pr, o);
      break;
  }
  return (int)cudaGetLastError();
}

const char* auvtpu_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
